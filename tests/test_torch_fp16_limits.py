"""The CPU simulation behind ``chip_smoke.py``'s fp16 card-vs-CPU training
step (phase 26): one step's loss and every leaf's grad in fp16 under
DeepSpeed's fp16 block (dynamic loss scale 2^16, unscaled before the
compare) against fp32 from the same fp32 masters, on the CPU, the plain
pieces standing in for the kernels on both sides (they round P and dS to
fp16 where the kernels do), at a reduced Llama width that keeps
Llama-3-8B's attention shape (heads of 128, 4 query heads a kv head) and
its SwiGLU MLP: 2 layers, hidden 1024 (8 heads over 2 kv heads),
intermediate 3584, vocabulary 32000 (the full 128256 would make the CPU
step the test's whole time), S 128.

The smoke's fp16 limits (``FP16_LOSS_RTOL``, ``FP16_GRAD_RTOL``) are set
here: sound fp16 reads under them by the stated margin (loss a tenth,
every leaf a third; fp16 carries 3 more mantissa bits than bf16, so it
reads ~0.003 here, ~5x below the bf16 step's 0.014-0.02), and the smoke's
planted fault, dV of kv head 0 zeroed (here: its ``wv`` rows' grads), reads
above the grad limit (~0.7 here). The test also holds that fp16's limit is
tighter than bf16's.
"""

import numpy as np
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import llama

# chip_smoke.py's FP16_LOSS_RTOL / FP16_GRAD_RTOL and the bf16 TRAIN_GRAD_RTOL
CHIP_FP16_LOSS_RTOL, CHIP_FP16_GRAD_RTOL, CHIP_BF16_GRAD_RTOL = 5e-4, 0.012, 0.05
FP16 = {"enabled": True, "loss_scale": 0, "initial_scale_power": 16, "loss_scale_window": 1000,
        "hysteresis": 2, "min_loss_scale": 1}


def _cfg():
    return llama.LlamaConfig(vocab_size=32000, hidden_size=1024, intermediate_size=3584,
                             num_layers=2, num_heads=8, num_kv_heads=2, max_seq_len=256)


def _step(cfg, masters, batch, fp16):
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=deepspeed_tpu_torch.ModelSpec(
            params={k: v.clone() for k, v in masters.items()},
            loss_fn=lambda p, b: llama.loss_fn(
                cfg, p, b, compute_dtype=torch.float16 if fp16 else torch.float32)),
        config={"train_batch_size": 1, "fp16": FP16 if fp16 else {"enabled": False},
                "steps_per_print": 0},
        device="cpu")
    loss = float(eng.forward(batch))
    scale = eng.loss_scale
    return loss, {k: p.grad.float() / scale for k, p in eng.state.params.items()}, scale


def _worst(grads, ref):
    rel = {k: float((grads[k] - ref[k]).norm()) / float(ref[k].norm()) for k in ref}
    worst = max(rel, key=rel.get)
    return worst, rel[worst]


def test_fp16_train_limits_separate_sound_from_faulty():
    cfg = _cfg()
    masters = llama.init(cfg, torch.Generator().manual_seed(0))
    batch = {"tokens": np.random.RandomState(2).randint(0, cfg.vocab_size, (1, 129))
             .astype(np.int32)}
    l32, g32, s32 = _step(cfg, masters, batch, False)
    l16, g16, s16 = _step(cfg, masters, batch, True)
    assert s32 == 1.0 and s16 == 2.0 ** 16
    assert all(torch.isfinite(g).all() for g in g16.values()), "the fp16 step overflowed"
    loss_rel = abs(l16 - l32) / l32
    leaf, worst = _worst(g16, g32)
    print(f"fp16 sound: loss rel {loss_rel:.2e}; worst leaf {leaf} {worst:.5f}")
    assert loss_rel < CHIP_FP16_LOSS_RTOL / 10 and worst < CHIP_FP16_GRAD_RTOL / 3
    assert CHIP_FP16_GRAD_RTOL < CHIP_BF16_GRAD_RTOL
    no_dv = {k: v.clone() for k, v in g16.items()}
    for l in range(cfg.num_layers):
        no_dv[f"layers.{l}.wv"][:cfg.head_size] = 0        # kv head 0's rows
    leaf, worst = _worst(no_dv, g32)
    print(f"fp16 dV of kv head 0 zeroed: worst leaf {leaf} {worst:.4f}")
    assert worst > CHIP_FP16_GRAD_RTOL
