"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package beside it is the reference; this package mirrors its layout
(``ops/``, ``models/``, ``inference/``) and names, imports ``torch`` and never
``jax`` or ``deepspeed_tpu``. Every kernel the JAX package wrote in Pallas for
the TPU is a hand-written CUDA kernel here (``ops/csrc/``), built at first
use; the plain PyTorch version beside each serves CPU tensors.

Ported so far:

- paged serving of the Llama family through the v2 continuous-batching
  engine (:func:`build_engine_v2`), with the RMSNorm and paged-decode
  kernels; speculative decoding with fused verification (the spec-verify
  kernel) and the int8 KV cache (the paged-decode kernel's int8 mode); the
  serving core: the prefix cache with copy-on-write, split prefill,
  ``step_many``, park / resume, fork and the KV export / import handoff;
  on a CUDA device every decode forward is a replay of one CUDA graph per
  engine;
- single-process training of the Llama family through :func:`initialize`
  → ``engine.train_batch`` (AdamW, bf16/fp16 with loss scaling, GAS,
  clipping, lr schedules), with the RMSNorm kernel and the flash-attention
  forward, dQ and dK/dV kernels;
- the GPT-2/OPT family (``models/gpt.py``) through both entry points, with
  the LayerNorm kernel;
- the inference module system (``inference/modules.py``), whose weight-only
  int8 linear runs the int8 quantize and dequantize kernels;
- the BLOOM family (``models/bloom.py``) through :func:`initialize`, its
  ALiBi bias on the flash kernels' bias mode;
- evoformer attention (``ops/evoformer_attn.py``: ``evoformer_attention``,
  ``msa_row_attention``, ``msa_column_attention``) over the bias mode, and
  block-sparse attention (``ops/sparse_attention.py``:
  ``blocksparse_attention`` and its layouts) over the block-sparse forward,
  dQ and dK/dV kernels.

Every function of the JAX package that reaches ``pl.pallas_call`` has its
CUDA counterpart: eighteen kernel entries and eight planted-fault hooks in
ten ``.cu`` sources (``ops/_build.py`` ``SIGNATURES``). The flash forward
runs bf16 on TMA + ``wgmma``, ``ops/csrc/flash_fwd_sm90.cu``, and fp32 on
``ops/csrc/flash_fwd.cu``; the flash backward runs bf16, with or without a
bias, on ``ops/csrc/flash_bwd_sm90.cu``, and fp32 on
``ops/csrc/flash_bwd.cu``; the block-sparse forward, dQ and dK/dV run bf16
at block 128 on ``ops/csrc/sparse_sm90.cu`` (TMA + ``wgmma``) and the rest
on ``ops/csrc/sparse_attention.cu``, both dK/dV kernels with the long
columns split over work items.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.5.0"

from .inference import InferenceConfig, build_engine_v2  # noqa: F401
from .runtime.config import DeepSpeedTPUConfig, parse_config  # noqa: F401
from .runtime.engine import (DeepSpeedTPUEngine, ModelSpec,  # noqa: F401
                             StepOutput, initialize)
