"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``cuda`` (the default of every
    entry point) raises ``RuntimeError`` when no GPU is present — the CPU is
    used only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("deepspeed_tpu_torch runs on a CUDA GPU and none "
                               "is available; pass device='cpu' to run the "
                               "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {dev}")
    return dev
