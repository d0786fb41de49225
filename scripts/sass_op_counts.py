#!/usr/bin/env python3
"""SASS instruction counts of the port's CUDA kernels in one checkout.

    python3 scripts/sass_op_counts.py --root PATH [--match REGEX] [--digest]
    python3 scripts/sass_op_counts.py --compare PARENT.json CHANGE.json

Builds PATH's kernels if needed (``deepspeed_tpu_torch/ops/_build.py``,
into PATH/build/), disassembles the library with ``cuobjdump -sass`` and
prints, for each kernel whose mangled name matches ``--match`` (default:
the bf16 flash backward kernels at hd 128 without a bias, those of
``flash_bwd_sm90.cu``), its instruction
count and the counts of the opcodes that tell two builds apart (branches,
constant loads, predicate ops, MUFU, HMMA, HGMMA, FFMA) as one JSON line
(``--match '^(?!.*paged)'``: every kernel outside the paged source). Two
checkouts whose kernels read the same here compiled to the same code
shape; run it on both when a kernel's time moves without its source.
``--digest`` adds each kernel's SHA-256 of its instructions (opcodes and
operands in order, with the addresses and encodings left out): equal
digests mean instruction-for-instruction equal code. ``--compare`` reads
two such JSON lines (one a checkout) and prints, as one JSON line, how many
of the first's kernels the second holds unchanged, changed or not at all,
and how many it adds; a kernel that gained a bf16 element-type parameter
keeps its name.
Needs the CUDA toolkit (``cuobjdump``) and a GPU-capable ``nvcc``.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

DEFAULT_MATCH = r"flash_bwd_(dq|dkv)_sm90_kernelILi128E"
SHOWN = ("BRA", "LDC", "PLOP3", "MUFU", "HMMA", "HGMMA", "FFMA")


def kernel_key(name: str) -> str:
    """A kernel's name with the anonymous namespace's path hash dropped;
    the flash and sparse kernels as ``name<dtype, D, [block | bias]>``
    (a name without a dtype is bf16), and any other kernel's leading bf16
    template argument dropped, so that a kernel which gained an element-type
    parameter matches its parent's name."""
    name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_", "_GLOBAL__N__", name)
    m = re.search(r"(?<=\d)((?:flash|sparse)_[a-z0-9_]+_kernel)I(13__nv_bfloat16|6__half|f)?"
                  r"Li(\d+)E(?:Li(\d+)E|Lb([01]))?", name)
    if not m:
        return re.sub(r"(_kernelI)13__nv_bfloat16(?=L)", r"\1", name)
    dtype = {"f": "f32", "6__half": "fp16"}.get(m.group(2), "bf16")
    return (f"{m.group(1)}<{dtype}, {m.group(3)}{', ' + m.group(4) if m.group(4) else ''}"
            f"{', bias' if m.group(5) == '1' else ''}>")


def compare(parent_path: str, change_path: str) -> dict:
    """The kernels of two runs of this script (JSON lines) side by side."""
    a, b = ({kernel_key(k): v for k, v in json.loads(Path(p).read_text())["kernels"].items()}
            for p in (parent_path, change_path))
    return {"parent_kernels": len(a), "unchanged": sum(k in b and a[k] == b[k] for k in a),
            "changed": sorted(k for k in a if k in b and a[k] != b[k]),
            "missing": sorted(k for k in a if k not in b),
            "new": len([k for k in b if k not in a])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", help="checkout holding deepspeed_tpu_torch/")
    ap.add_argument("--compare", nargs=2, metavar=("PARENT", "CHANGE"),
                    help="two JSON lines of this script to compare")
    ap.add_argument("--match", default=DEFAULT_MATCH, help="regex on the mangled kernel name")
    ap.add_argument("--digest", action="store_true",
                    help="also each kernel's SHA-256 of its instruction stream")
    args = ap.parse_args()
    if args.compare:
        print(json.dumps(compare(*args.compare)), flush=True)
        return 0
    if not args.root:
        ap.error("--root or --compare is required")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from deepspeed_tpu_torch.ops import _build

    if Path(_build.__file__).resolve().parents[2] != root:
        print(f"imported {_build.__file__}, not from {root}", file=sys.stderr)
        return 1
    lib = _build.build()
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {"root": str(root), "kernels": {}}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        # an anonymous namespace's name carries a hash of the build's path:
        # kernel_key drops it, so two checkouts' kernels match by name
        name = func.split("\n", 1)[0].strip()
        if not re.search(args.match, name):
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0]
            for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", func))
        key = kernel_key(name)
        out["kernels"][key] = {
            "total": sum(ops.values()), **{op: ops[op] for op in SHOWN}}
        if args.digest:
            # "/*0a40*/  @P0 HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], ... ;  /* 0x... */"
            # -> the text between the address and the encoding
            body = "\n".join(m.group(1).strip() for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", func))
            out["kernels"][key]["sha256"] = hashlib.sha256(body.encode()).hexdigest()[:16]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
