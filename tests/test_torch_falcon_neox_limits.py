"""The CPU simulation behind ``chip_smoke.py``'s card-vs-CPU training steps
of Falcon-7B and GPT-NeoX-20B (phase 25): one step's loss and every leaf's
grad in bf16 against fp32 from the same fp32 masters, on the CPU, plain
attention standing in for the kernels on both sides, at reduced widths that
keep each family's attention shape and vocabulary (S 128):

- Falcon: 2 layers, hidden 1024, 16 query heads over ONE kv head, the tied
  embedding;
- GPT-NeoX: 2 layers, hidden 1536, 16 heads of 96 (GPT-NeoX-20B's head
  dim), intermediate 6144, partial rotary and the biases.

Sound bf16 reads under the limits by a stated margin (loss a tenth of
``TRAIN_LOSS_RTOL``; every leaf a third of ``TRAIN_GRAD_RTOL`` for Falcon,
half for GPT-NeoX, whose ``bk`` reads highest: rotary makes a bias on k
more than the shift softmax drops); the smoke's two planted faults, dV of
kv head 0 zeroed (here: its ``wv`` rows' grads) and LayerNorm's db zeroed,
read above the limit.
"""

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import falcon, gptneox

# chip_smoke.py's TRAIN_LOSS_RTOL and TRAIN_GRAD_RTOL
CHIP_LOSS_RTOL, CHIP_GRAD_RTOL = 2e-3, 0.05

CASES = {  # family, config, share of the grad limit a sound leaf stays under
    "falcon": (falcon, lambda: falcon.FalconConfig(hidden_size=1024, num_heads=16,
                                                   num_layers=2), 1 / 3),
    "gptneox": (gptneox, lambda: gptneox.GPTNeoXConfig(hidden_size=1536, num_heads=16,
                                                       intermediate_size=6144,
                                                       num_layers=2), 1 / 2),
}


def _bf16_against_fp32(fam, cfg, seq=128):
    masters = fam.init(cfg, torch.Generator().manual_seed(0))
    batch = {"tokens": np.random.RandomState(2).randint(0, cfg.vocab_size, (1, seq + 1))
             .astype(np.int32)}

    def step(bf16):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=deepspeed_tpu_torch.ModelSpec(
                params={k: v.clone() for k, v in masters.items()},
                loss_fn=lambda p, b: fam.loss_fn(
                    cfg, p, b, compute_dtype=torch.bfloat16 if bf16 else torch.float32)),
            config={"train_batch_size": 1, "bf16": {"enabled": bf16}, "steps_per_print": 0},
            device="cpu")
        return float(eng.forward(batch)), {k: p.grad.float() for k, p in eng.state.params.items()}

    l32, g32 = step(False)
    l16, g16 = step(True)
    return abs(l16 - l32) / l32, g32, g16


def _worst(grads, ref):
    rel = {k: float((grads[k] - ref[k]).norm()) / float(ref[k].norm()) for k in ref}
    worst = max(rel, key=rel.get)
    return worst, rel[worst]


@pytest.mark.parametrize("family", sorted(CASES))
def test_train_limits_separate_sound_from_faulty(family):
    fam, make_cfg, share = CASES[family]
    cfg = make_cfg()
    loss_rel, g32, g16 = _bf16_against_fp32(fam, cfg)
    leaf, worst = _worst(g16, g32)
    print(f"{family} sound: loss rel {loss_rel:.2e}; worst leaf {leaf} {worst:.4f}")
    assert loss_rel < CHIP_LOSS_RTOL / 10 and worst < CHIP_GRAD_RTOL * share
    no_dv = {k: v.clone() for k, v in g16.items()}
    for l in range(cfg.num_layers):
        no_dv[f"layers.{l}.wv"][:cfg.head_size] = 0        # kv head 0's rows
    no_db = {k: torch.zeros_like(v) if "ln" in k and k.endswith("_bias") else v
             for k, v in g16.items()}
    for what, bad in (("dV of kv head 0 zeroed", no_dv), ("LayerNorm's db zeroed", no_db)):
        leaf, worst = _worst(bad, g32)
        print(f"{family} {what}: worst leaf {leaf} {worst:.4f}")
        assert worst > CHIP_GRAD_RTOL
