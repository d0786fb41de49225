#!/usr/bin/env python3
"""Device times of the norm kernels and the block-sparse backward kernels
of one checkout of the PyTorch port, at the shapes ``chip_smoke.py`` gives
them:

- LayerNorm, bf16 with a bias: [1 x 2048] (the launch floor), [64 x 2048]
  (an OPT-1.3B serving step's 64 slots), [8192 x 2048] (an OPT-1.3B
  training micro-batch of 4 x 2048 tokens), [4096 x 4096] (a BLOOM-7b1
  micro-batch of 2 x 2048 tokens), and ``F.layer_norm`` on the same inputs;
- RMSNorm, bf16: [1 x 4096], [64 x 4096] (a Llama-3-8B serving step's 64
  slots), [4096 x 4096] (a Llama-3-8B training micro-batch), and
  ``F.rms_norm`` on the same inputs; where the checkout's ``rms_norm.cu``
  caps a row at ``kThreads = 256`` threads, a row of 4096 as 8 warps of two
  16-byte vectors a lane (the kernel as shipped) and as 16 warps of one (a
  copy of ``rms_norm.cu`` built here with the cap at 512), over 64 to 4096
  rows;
- the block-sparse forward, dQ and dK/dV (``sparse_fwd_cuda``,
  ``sparse_bwd_dq_cuda``, ``sparse_bwd_dkv_cuda``: whichever kernels the
  checkout routes each case to), batch 1, 32 query / 8 kv heads, hd 128,
  bf16: S 16384 at block 128 with the causal bigbird layout of
  ``blocksparse_attention``'s smoke phase; S 4096 with its three layouts
  (bigbird causal, fixed non-causal, sliding window) at blocks 128 and 32;
  the bigbird layout at blocks 16 and 64;
- ``blocksparse_attention`` forward and backward under autograd at that
  S 16384 and at S 4096 block 32 (every kernel of the step: the three
  sparse kernels, delta, the casts);
- int8 quantize (``quantize_int8_cuda``) of OPT-1.3B's ``w_up`` [2048 x
  8192] in bf16, fp16 and fp32 and of Llama-3-8B's MLP weight [4096 x
  14336] in bf16, at groups 128 and 2048; dequantize
  (``dequantize_int8_cuda``) of their codes to bf16, fp16 and fp32 (Llama:
  bf16); the module system's ``weight_only_quant`` up-projection on [64,
  2048] bf16 activations (dequantize + matmul); each kernel case with its
  bytes bound. A wrapper that refuses a dtype (fp16 before it was taken)
  records null.

    python3 scripts/norm_sparse_ab_timing.py --root PATH [--iters 100]
        [--kinds norms,fwd,dq,dkv,step,quant] [--plain]

``--kinds`` chooses what is timed: ``norms`` the LayerNorm and RMSNorm
cases, ``fwd``, ``dq`` and ``dkv`` the block-sparse kernels, ``step``
``blocksparse_attention`` forward and backward, ``quant`` the int8
quantize and dequantize kernels (not in the default).

Beside the times, ``bound_us`` holds each sparse case's bound
(``chip_smoke.py``'s ``sparse_work``: operations over the visible pairs
against the bytes moved once, on the H100 SXM's published peaks). With
``--plain``, ``plain_us`` and ``library_us`` also hold each sparse case's
plain version (``sparse_fwd_torch``; ``sparse_bwd_torch``, all three
grads, for dq and dkv; at S 16384 over 1024-row query chunks) and one
dense-masked SDPA call on the same inputs (K / V widened to the query
heads; the backward as forward + backward less the forward). Both are the
same functions in every checkout: time them once.

To compare two checkouts, run it on both in turns (parent, change, change,
parent) on one card, one after another: each run builds its checkout's
kernels (into PATH/build/) and prints one JSON line with the card's name
and power limit and, per case, the mean device time of one launch in
microseconds (the kernels' own time from ``torch.profiler``, after a
warm-up; ``paged_ab_timing.device_us``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from paged_ab_timing import device_us  # noqa: E402

LN_SHAPES = {"ln_1x2048": (1, 2048), "ln_64x2048": (64, 2048), "ln_8192x2048": (8192, 2048),
             "ln_4096x4096": (4096, 4096)}
RMS_SHAPES = {"rms_1x4096": (1, 4096), "rms_64x4096": (64, 4096),
              "rms_4096x4096": (4096, 4096)}
RMS_SHAPE_ROWS = (64, 256, 528, 1056, 2048, 4096)
H, HKV, HD, BS = 32, 8, 128, 128
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
QUANT_SHAPES = {"opt": (2048, 8192), "llama": (4096, 14336)}


def rms_thread_cap_variant(root: Path, threads: int):
    """``rms_norm.cu`` of the checkout alone, built with its row's thread cap
    ``kThreads`` at ``threads`` into ``root/build/rms_norm_cap<threads>/``
    and loaded through ctypes; None where the source has no such cap."""
    import ctypes

    from deepspeed_tpu_torch.ops import _build

    src = (root / "deepspeed_tpu_torch/ops/csrc/rms_norm.cu").read_text()
    cap = "constexpr int kThreads = 256;"
    if cap not in src:
        return None
    out = root / "build" / f"rms_norm_cap{threads}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "rms_norm.cu").write_text(src.replace(cap, f"constexpr int kThreads = {threads};"))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(out / "rms_norm.cu"),
                    "-o", str(out / "lib.so")], check=True, timeout=600)
    lib = ctypes.CDLL(str(out / "lib.so"))
    lib.dstt_rms_norm.argtypes = _build.SIGNATURES["dstt_rms_norm"]
    lib.dstt_rms_norm.restype = ctypes.c_int
    return lib


def time_quant(gen, iters: int, us: dict, bound: dict) -> None:
    """The ``quant`` kind (module docstring): device times into ``us``,
    bytes bounds into ``bound``, both in microseconds."""
    import torch

    from deepspeed_tpu_torch.inference import modules
    from deepspeed_tpu_torch.ops import quantization as qz

    dev = torch.device("cuda")
    dtypes = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}

    def case(name, fn, nbytes):
        try:
            fn()
        except ValueError:             # a dtype the checkout's wrapper refuses
            us[name] = None
        else:
            us[name] = device_us(fn, iters)
        if nbytes:
            bound[name] = nbytes / HBM_BYTES_PER_S * 1e6

    for shape_name, shape in QUANT_SHAPES.items():
        n = shape[0] * shape[1]
        base = torch.randn(shape, generator=gen, device=dev) * 0.05
        for tag, dtype in dtypes.items():
            if shape_name == "llama" and dtype != torch.bfloat16:
                continue
            x = base.to(dtype)
            for gs in (128, 2048):
                case(f"quantize_{shape_name}_g{gs}_{tag}", lambda: qz.quantize_int8_cuda(x, gs),
                     n * x.element_size() + n + n // gs * 4)
                if dtype != torch.bfloat16:
                    continue
                q, sc = qz.quantize_int8_cuda(x, gs)
                for otag, odt in dtypes.items():
                    if shape_name == "llama" and odt != torch.bfloat16:
                        continue
                    case(f"dequantize_{shape_name}_g{gs}_{otag}",
                         lambda: qz.dequantize_int8_cuda(q, sc, gs, odt),
                         n + n // gs * 4 + n * torch.empty(0, dtype=odt).element_size())
                del q, sc
            del x
        del base
        torch.cuda.empty_cache()
    # the module system's weight-only int8 up-projection (OPT-1.3B's w_up)
    w = (torch.randn(QUANT_SHAPES["opt"], generator=gen, device=dev) * 2048 ** -0.5)
    q, sc = qz.quantize_int8_cuda(w.to(torch.bfloat16), 128)
    y = torch.randn(64, 2048, generator=gen, device=dev).to(torch.bfloat16)
    b = torch.zeros(8192, device=dev, dtype=torch.bfloat16)
    lin = modules.registry.instantiate("linear", modules.LinearConfig(quant_bits=8,
                                                                      activation="relu"))
    case("quant_linear_up_64x2048_bf16", lambda: lin(y, q, sc, b), 0)


def _sparse_work():
    """``sparse_work`` of the ``chip_smoke.py`` beside this script (the
    bounds are the same whichever checkout is timed)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.sparse_work


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="checkout holding deepspeed_tpu_torch/")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--kinds", default="norms,fwd,dq,dkv,step",
                    help="what to time: norms, the block-sparse fwd, dq, dkv and step "
                         "(blocksparse_attention fwd + bwd), and quant (int8 quantize and "
                         "dequantize; not in the default)")
    ap.add_argument("--plain", action="store_true",
                    help="also time each sparse case's plain version and dense-masked SDPA")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("norm_sparse_ab_timing.py needs a CUDA GPU", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.norms import layer_norm_cuda, rms_norm_cuda, rms_norm_torch

    if Path(sa.__file__).resolve().parents[2] != root:
        print(f"imported {sa.__file__}, not from {root}", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    us, bound, plain, library = {}, {}, {}, {}
    kinds = set(args.kinds.split(","))
    norms = "norms" in kinds
    for name, (n, d) in (LN_SHAPES if norms else {}).items():
        x = (3 * torch.randn(n, d, generator=gen, device=dev) + 1).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(torch.bfloat16)
        b = (0.2 * torch.randn(d, generator=gen, device=dev)).to(torch.bfloat16)
        iters = args.iters * 10 if n <= 64 else args.iters
        us[name] = device_us(lambda: layer_norm_cuda(x, w, b, 1e-5), iters)
        us[name + "_F.layer_norm"] = device_us(lambda: F.layer_norm(x, (d,), w, b, 1e-5), iters)
    for name, (n, d) in (RMS_SHAPES if norms else {}).items():
        x = (3 * torch.randn(n, d, generator=gen, device=dev)).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(torch.bfloat16)
        iters = args.iters * 10 if n <= 64 else args.iters
        us[name] = device_us(lambda: rms_norm_cuda(x, w, 1e-5), iters)
        us[name + "_F.rms_norm"] = device_us(lambda: F.rms_norm(x, (d,), w, 1e-5), iters)
    variant = rms_thread_cap_variant(root, 512) if norms else None
    if variant is not None:
        # a row of 4096 as 8 warps of 2 vectors a lane (as shipped) or 16 of 1
        w = (1 + 0.1 * torch.randn(4096, generator=gen, device=dev)).to(torch.bfloat16)
        for n in RMS_SHAPE_ROWS:
            x = (3 * torch.randn(n, 4096, generator=gen, device=dev)).to(torch.bfloat16)
            y = torch.empty_like(x)
            iters = args.iters * 10 if n <= 528 else args.iters

            def cap512():
                variant.dstt_rms_norm(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, 4096, 1e-5,
                                      0, torch.cuda.current_stream().cuda_stream)

            cap512()
            torch.cuda.synchronize()
            ref = rms_norm_torch(x, w, 1e-5).float()
            if not torch.allclose(y.float(), ref, rtol=1e-2, atol=1e-2):
                print("the 512-thread copy of rms_norm.cu disagrees", file=sys.stderr)
                return 1
            us[f"rms_{n}x4096_8x2"] = device_us(lambda: rms_norm_cuda(x, w, 1e-5), iters)
            us[f"rms_{n}x4096_16x1"] = device_us(cap512, iters)

    if "quant" in kinds:
        time_quant(gen, args.iters, us, bound)

    sparse_work = _sparse_work()
    builders = {"bigbird": lambda nb: (sa.bigbird_layout(nb, 3, 1, 2, seed=0, causal=True), True),
                "fixed": lambda nb: (sa.fixed_layout(nb, 4, 4, causal=False), False),
                "sliding": lambda nb: (sa.sliding_window_layout(nb, 4, causal=True), True)}
    # (S, block, layout); the block-128 keys keep their names of earlier PRs
    cases = [(16384, BS, "bigbird")] + [(4096, bs, name) for bs in (BS, 32)
                                         for name in builders] + \
        [(4096, 16, "bigbird"), (4096, 64, "bigbird")]
    if not kinds & {"fwd", "dq", "dkv", "step"}:
        cases = []
    for s, bs, name in cases:
        lay, causal = builders[name](s // bs)
        tag = f"s{s}_{name}" + ("" if bs == BS else f"_block{bs}")
        q, k, v, do = (torch.randn(1, s, hh, HD, generator=gen, device=dev).to(torch.bfloat16)
                       for hh in (H, HKV, HKV, H))
        o, lse = sa.sparse_fwd_cuda(q, k, v, lay, bs, causal=causal)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(H, s)
        iters = max(args.iters // 10, 3)
        work = sparse_work(lay, bs, causal, 1, s, H, HKV, HD)
        for kind, fn in (
                ("fwd", lambda: sa.sparse_fwd_cuda(q, k, v, lay, bs, causal=causal)),
                ("dq", lambda: sa.sparse_bwd_dq_cuda(q, k, v, do, lse, delta, lay, bs,
                                                     causal=causal)),
                ("dkv", lambda: sa.sparse_bwd_dkv_cuda(q, k, v, do, lse, delta, lay, bs,
                                                       causal=causal))):
            if kind not in kinds:
                continue
            us[f"sparse_{kind}_{tag}"] = device_us(fn, iters)
            bound[f"sparse_{kind}_{tag}"] = work[kind][0] * 1e3
        if args.plain:
            q_chunk = 1024 if s > 4096 else None
            fwd_plain = device_us(lambda: sa.sparse_fwd_torch(q, k, v, lay, bs, causal=causal,
                                                              q_chunk=q_chunk), 3)
            bwd_plain = device_us(lambda: sa.sparse_bwd_torch(q, k, v, o, lse, do, lay, bs,
                                                              causal=causal, q_chunk=q_chunk), 3)
            mask = sa.token_mask(lay, bs, causal, dev)
            qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
            kt, vt = (x.repeat_interleave(H // HKV, dim=1) for x in (kt, vt))

            def sdpa_fwd_bwd():
                leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
                F.scaled_dot_product_attention(*leaves, attn_mask=mask).backward(dot)

            lib_fwd = device_us(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                       attn_mask=mask), 3)
            lib_bwd = device_us(sdpa_fwd_bwd, 3) - lib_fwd
            for kind in ("fwd", "dq", "dkv"):
                plain[f"sparse_{kind}_{tag}"] = fwd_plain if kind == "fwd" else bwd_plain
                library[f"sparse_{kind}_{tag}"] = lib_fwd if kind == "fwd" else lib_bwd
            del mask, qt, kt, vt, dot
        if name == "bigbird" and bs in (BS, 32) and "step" in kinds:
            leaves = [x.requires_grad_() for x in (q, k, v)]

            def step():
                for x in leaves:
                    x.grad = None
                sa.blocksparse_attention(*leaves, lay, bs, causal=causal).backward(do)

            us["blocksparse_fwd_bwd_" + tag] = device_us(step, iters)
            del leaves
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    print(json.dumps({"root": str(root), "card": card, "us": us, "bound_us": bound,
                      **({"plain_us": plain, "library_us": library} if args.plain else {})}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
