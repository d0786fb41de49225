"""Build and load the port's CUDA kernels.

Every ``ops/csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together), linked into one shared library
with a plain C interface, and loaded through ``ctypes``. Nothing is built
when this module is imported: :func:`load` builds at first use.

The library lands in ``build/deepspeed_tpu_torch/<key>/`` under the repo
root, where ``<key>`` hashes the sources, the ``*.cuh`` headers they
include and the flags, so a source edit
rebuilds and an unchanged tree reuses the previous build. Only the sources
in this package go into it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_ROOT = REPO_ROOT / "build" / "deepspeed_tpu_torch"
LIB_NAME = "libdstt_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_VP, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# a flash kernel's bias: pointer (null: none), strides (b, h, q, kv), is-fp32
_BIAS = [_VP, _LL, _LL, _LL, _LL, _I]
# C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    # x, w, y, n_rows, d, eps, dtype (0 bf16, 1 f32, 2 f16), stream
    "dstt_rms_norm": [_VP, _VP, _VP, _I, _I, _F, _I, _VP],
    # planted fault of the RMSNorm kernels' next launches (tests): 0 none
    "dstt_rms_norm_plant": [_I],
    # x, w, b (may be null), y, n_rows, d, eps, dtype (2: f16 too), stream
    "dstt_layer_norm": [_VP, _VP, _VP, _VP, _I, _I, _F, _I, _VP],
    # planted fault of the LayerNorm kernel's next launches (tests): 0 none
    "dstt_layer_norm_plant": [_I],
    # x, q, scales, n_groups, group_size, dtype of x (0 bf16, 1 f32, 2 f16),
    # stream
    "dstt_quantize_int8": [_VP, _VP, _VP, _I, _I, _I, _VP],
    # q, scales, out, n_groups, group_size, dtype of out, stream
    "dstt_dequantize_int8": [_VP, _VP, _VP, _I, _I, _I, _VP],
    # planted fault of the quantize and dequantize kernels' next launches
    # (tests): 0 none
    "dstt_quantize_plant": [_I],
    # paged_sm90.cu: q, k_pool, v_pool, k_scale, v_scale, tables, ctx,
    # window_ptr, window, out, counters, partials, B, t, nh, nkv, hd, bs,
    # num_blocks, max_blocks, ng (0: 16-bit pools), nsplit, dtype (0 bf16, 2
    # f16), scale, stream
    "dstt_paged_attention": [_VP] * 8 + [_I] + [_VP] * 3 + [_I] * 11 + [_F, _VP],
    # planted fault of the paged kernel's next launches (tests): 0 none
    "dstt_paged_sm90_plant": [_I],
    # q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, q_offset, causal, window,
    # scale, dtype (0 bf16, 1 f32, 2 f16), bias, stream
    "dstt_flash_fwd": [_VP] * 5 + [_I] * 9 + [_F, _I] + _BIAS + [_VP],
    # planted fault of the 16-bit forward's next launches (tests): 0 none
    "dstt_flash_fwd_sm90_plant": [_I],
    # q, k, v, dout, lse, delta, dq, (B .. window as above), scale, dtype,
    # bias, dbias, stream
    "dstt_flash_bwd_dq": [_VP] * 7 + [_I] * 9 + [_F, _I] + _BIAS + [_VP, _VP],
    # q, k, v, dout, lse, delta, dk, dv, (B .. window), scale, dtype, bias, stream
    "dstt_flash_bwd_dkv": [_VP] * 8 + [_I] * 9 + [_F, _I] + _BIAS + [_VP],
    # bf16 and f16 without a bias (flash_bwd_sm90.cu): q, k, v, dout, lse,
    # delta, dq, (B .. window), scale, dtype (0 bf16, 2 f16), stream
    "dstt_flash_bwd_dq_sm90": [_VP] * 7 + [_I] * 9 + [_F, _I, _VP],
    # q, k, v, dout, lse, delta, dk, dv, (B .. window), scale, dtype, stream
    "dstt_flash_bwd_dkv_sm90": [_VP] * 8 + [_I] * 9 + [_F, _I, _VP],
    # their bias mode (flash_bwd_sm90.cu): the same, then bias, dbias (dQ), stream
    "dstt_flash_bwd_dq_bias_sm90": [_VP] * 7 + [_I] * 9 + [_F, _I] + _BIAS + [_VP, _VP],
    "dstt_flash_bwd_dkv_bias_sm90": [_VP] * 8 + [_I] * 9 + [_F, _I] + _BIAS + [_VP],
    # planted fault of both 16-bit backward kernels' next launches (tests): 0 none
    "dstt_flash_bwd_sm90_plant": [_I],
    # q, k, v, o, lse, idx, cnt, items, max_a, n_items, heads_per_item, B,
    # H, Hkv, S, D, block, causal, scale, dtype, stream
    "dstt_sparse_fwd": [_VP] * 8 + [_I] * 10 + [_F, _I, _VP],
    # q, k, v, dout, lse, delta, dq, idx, cnt, items, (max_a .. causal),
    # scale, dtype, stream
    "dstt_sparse_bwd_dq": [_VP] * 10 + [_I] * 10 + [_F, _I, _VP],
    # q, k, v, dout, lse, delta, dk, dv, idx_t, cnt_t, plan, counters,
    # partials, max_t, n_plan, B, H, Hkv, S, D, block, causal, scale, dtype,
    # stream
    "dstt_sparse_bwd_dkv": [_VP] * 13 + [_I] * 9 + [_F, _I, _VP],
    # planted fault of sparse_attention.cu's dK/dV next launches (tests): 0 none
    "dstt_sparse_attention_plant": [_I],
    # bf16 at block 128 (sparse_sm90.cu): q, k, v, dout, lse, delta, dk, dv,
    # idx_t, cnt_t, plan, counters, partials, max_t, n_plan, B, H, Hkv, S, D,
    # causal, scale, stream
    "dstt_sparse_bwd_dkv_sm90": [_VP] * 13 + [_I] * 8 + [_F, _VP],
    # bf16 at block 128 (sparse_sm90.cu): q, k, v, dout, lse, delta, dq, idx,
    # cnt, order, max_a, B, H, Hkv, S, D, causal, scale, stream
    "dstt_sparse_bwd_dq_sm90": [_VP] * 10 + [_I] * 7 + [_F, _VP],
    # bf16 at block 128 (sparse_sm90.cu): q, k, v, o, lse, idx, cnt, order,
    # max_a, B, H, Hkv, S, D, causal, scale, stream
    "dstt_sparse_fwd_sm90": [_VP] * 8 + [_I] * 7 + [_F, _VP],
    # planted fault of sparse_sm90.cu's next launches (tests): 0 none
    "dstt_sparse_sm90_plant": [_I],
}

_LIB: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):   # sources and the headers they include
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of deepspeed_tpu_torch "
                       "need the CUDA toolkit (set CUDA_HOME)")


def build(verbose: bool = False) -> Path:
    """Compile the sources (if this source set has not been built yet) and
    return the shared library's path. Raises with nvcc's output on failure."""
    out_dir = BUILD_ROOT / _key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="tmp-", dir=out_dir))
    try:
        procs = []
        for src in sources():
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        objs = []
        for src, obj, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
            if verbose:
                print(f"[build] {src.name}:\n{out}", flush=True)
            objs.append(str(obj))
        tmp_lib = work / LIB_NAME
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs,
                               "-o", str(tmp_lib)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)   # atomic: a concurrent build sees all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


def load(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build(verbose=verbose)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.dstt_error_string.argtypes = [ctypes.c_int]
        lib.dstt_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        name = load().dstt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name})")
