"""Offline consolidation of a (possibly ZeRO-sharded) regular checkpoint
into one fp32 state dict — counterpart of
``deepspeed_tpu/runtime/checkpoint/zero_to_fp32.py``
(``get_fp32_state_dict_from_checkpoint`` :23,
``convert_checkpoint_to_fp32_state_dict`` :40, ``main`` :53), the
reference's ``deepspeed/utils/zero_to_fp32.py``.

Every rank's parts of each master are put together whole, whatever world
size and ZeRO stage wrote them. The output is an ``.npz`` keyed by the
port's ``state_dict`` names (``layers.<i>.wq`` ``[out, in]``), which loads
into the family's ``nn.Module`` (``model.load_state_dict({k:
torch.from_numpy(v) ...})``), as the reference's ``pytorch_model.bin``
does. It is written one leaf at a time, so host memory stays O(largest
leaf). A host tool: it opens no device.

    python -m deepspeed_tpu_torch.runtime.checkpoint.zero_to_fp32 CKPT_DIR OUT.npz [--tag TAG]
"""

from __future__ import annotations

import os
import sys
import zipfile
from typing import Dict, Optional

import numpy as np

from ...utils.logging import log_dist

_PREFIX = "params/"


def _saved_masters(ckpt_dir: str, tag: Optional[str]):
    from .saver import read_state_tree, resolve_tag

    tag = resolve_tag(ckpt_dir, tag)
    saved = read_state_tree(os.path.join(ckpt_dir, tag))
    return saved, [n for n in saved.names() if n.startswith(_PREFIX)]


def _fp32(arr: np.ndarray) -> np.ndarray:
    return arr.astype(np.float32) if np.issubdtype(arr.dtype, np.floating) else arr


def get_fp32_state_dict_from_checkpoint(ckpt_dir: str,
                                        tag: Optional[str] = None
                                        ) -> Dict[str, np.ndarray]:
    """Reference ``get_fp32_state_dict_from_zero_checkpoint``: every master
    whole, in fp32, by its ``state_dict`` name."""
    saved, names = _saved_masters(ckpt_dir, tag)
    return {n[len(_PREFIX):]: _fp32(saved.full(n)) for n in names}


def convert_checkpoint_to_fp32_state_dict(ckpt_dir: str, output_file: str,
                                          tag: Optional[str] = None) -> str:
    """Reference ``convert_zero_checkpoint_to_fp32_state_dict`` CLI entry:
    the masters into one ``.npz`` (the suffix is added when missing),
    streamed a leaf at a time."""
    saved, names = _saved_masters(ckpt_dir, tag)
    out = output_file if output_file.endswith(".npz") else output_file + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    total = 0
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for n in names:
            arr = _fp32(saved.full(n))
            total += arr.size
            # a fixed timestamp: the same masters give the same bytes
            info = zipfile.ZipInfo(n[len(_PREFIX):] + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
            with zf.open(info, "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
    log_dist(f"consolidated {len(names)} tensors ({total / 1e6:.1f}M elements) "
             f"→ {out}")
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="Consolidate a deepspeed_tpu_torch checkpoint to one fp32 .npz")
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file")
    p.add_argument("--tag", default=None)
    args = p.parse_args(argv)
    convert_checkpoint_to_fp32_state_dict(args.checkpoint_dir, args.output_file, args.tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
