"""The CPU simulation behind ``chip_smoke.py``'s quantized-weights limits
(``QUANT_VS_BF16_TOL``): how far a v1 engine's logits move when its weights
rest as int8, packed int4 or fp8 (``inference/engine.py``
``quantize_leaf`` / ``dequantize_leaf``, the JAX engine's per-row scheme)
against the same weights in bf16.

At Llama-3-8B's widths (hidden 4096, MLP 14336, 32 heads on 8 kv heads of
128) and at the depth the card's check runs (``QUANT_DEPTH`` = 2 layers),
with the vocabulary cut to 8192 so the embedding and the head fit a CPU
test (the check on the card has 128256 rows: a row's largest error is a
maximum over more entries, ~1.15x for Gaussian errors); weights from the
port's ``llama.init`` (seeds 0 and 1), 64 random tokens, bf16 compute on
both sides. Each limit is twice the largest row error / row RMS measured
here (measured: int8 0.229, fp8 0.620, int4 4.03; bf16 against fp32 reads
0.068, the compute's own noise). The test prints the measured values.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from deepspeed_tpu_torch.inference.engine import Dequantized, quantize_leaf
from deepspeed_tpu_torch.models import llama

# chip_smoke.py's QUANT_VS_BF16_TOL and QUANT_DEPTH
CHIP_QUANT_TOL = {"int8": 0.5, "fp8": 1.25, "int4": 8.5}
CHIP_QUANT_DEPTH = 2
MODES = {"int8": {"bits": 8}, "int4": {"bits": 4}, "fp8": {"fp8": True}}


def _row_err(got, ref):
    diff = (got.float() - ref.float()).abs()
    return float((diff.amax(-1) / ref.float().pow(2).mean(-1).sqrt()).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_quant_limits_hold_the_simulated_error(seed):
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=CHIP_QUANT_DEPTH,
                              vocab_size=8192)
    # each leaf drawn in fp32 and kept in bf16 (no whole fp32 model at once)
    params = llama.init(cfg, torch.Generator().manual_seed(seed),
                        keep=lambda name, t: t.bfloat16())
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size, (1, 64)))
    with torch.no_grad():
        ref = llama.apply(cfg, params, tokens, compute_dtype=torch.bfloat16)
        for mode, kw in MODES.items():
            # at rest quantized, dequantized a block at a time as the
            # engine's forward reads it
            qp = {k: quantize_leaf(k, v, **kw) if v.dim() >= 2 or k.startswith("layers.")
                  else v for k, v in params.items()}
            out = llama.apply(cfg, Dequantized(qp, torch.bfloat16), tokens,
                              compute_dtype=torch.bfloat16)
            err = _row_err(out, ref)
            del qp
            print(f"seed {seed} {mode}: row err / RMS {err:.4f} "
                  f"(chip limit {CHIP_QUANT_TOL[mode]})")
            assert 0 < err and 2 * err <= CHIP_QUANT_TOL[mode], (mode, err)
