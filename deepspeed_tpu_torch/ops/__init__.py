"""Ops of the PyTorch/CUDA port. Importing this package registers every op's
implementations; no kernel is built until one is launched."""

from . import attention, flash_attention, norms, paged_attention  # noqa: F401 (registers)
from .registry import get_op, op, register  # noqa: F401
