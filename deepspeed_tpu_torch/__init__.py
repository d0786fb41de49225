"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package beside it is the reference; this package mirrors its layout
(``ops/``, ``models/``, ``inference/``) and names, imports ``torch`` and never
``jax`` or ``deepspeed_tpu``. Every kernel the JAX package wrote in Pallas for
the TPU is a hand-written CUDA kernel here (``ops/csrc/``), built at first
use; the plain PyTorch version beside each serves CPU tensors.

Ported so far: paged serving of the Llama family through the v2
continuous-batching engine (:func:`build_engine_v2`), with the RMSNorm and
paged-decode kernels. Entry points run on the GPU unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from .inference import InferenceConfig, build_engine_v2  # noqa: F401
