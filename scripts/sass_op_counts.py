#!/usr/bin/env python3
"""SASS instruction counts of the port's CUDA kernels in one checkout.

    python3 scripts/sass_op_counts.py --root PATH [--match REGEX]

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
Needs the CUDA toolkit (``cuobjdump``) and a GPU-capable ``nvcc``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

DEFAULT_MATCH = r"flash_bwd_(dq|dkv)_sm90_kernelILi128E"
SHOWN = ("BRA", "LDC", "PLOP3", "MUFU", "HMMA", "HGMMA", "FFMA")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="checkout holding deepspeed_tpu_torch/")
    ap.add_argument("--match", default=DEFAULT_MATCH, help="regex on the mangled kernel name")
    args = ap.parse_args()
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
        # drop it, so two checkouts' kernels match by name
        name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_", "_GLOBAL__N__",
                      func.split("\n", 1)[0].strip())
        if not re.search(args.match, name):
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0]
            for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", func))
        # <dtype (the sm90 kernels: bf16 only), D, [block | bias]>
        m = re.search(r"(?<=\d)((?:flash|sparse)_[a-z0-9_]+_kernel)I(13__nv_bfloat16|f)?Li(\d+)E"
                      r"(?:Li(\d+)E|Lb([01]))?", name)
        key = (f"{m.group(1)}<{'bf16' if m.group(2) != 'f' else 'f32'}, {m.group(3)}"
               f"{', ' + m.group(4) if m.group(4) else ''}"
               f"{', bias' if m.group(5) == '1' else ''}>") if m else name
        out["kernels"][key] = {
            "total": sum(ops.values()), **{op: ops[op] for op in SHOWN}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
