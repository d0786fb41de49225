"""Ops of the PyTorch/CUDA port. Importing this package registers every op's
implementations; no kernel is built until one is launched."""

from . import attention, flash_attention, paged_attention  # noqa: F401 (registers)
from .evoformer_attn import evoformer_attention  # noqa: F401
from .norms import layer_norm, rms_norm  # noqa: F401
from .quantization import dequantize_int8, quantize_int8  # noqa: F401
from .registry import get_op, op, register  # noqa: F401
from .sparse_attention import blocksparse_attention  # noqa: F401
