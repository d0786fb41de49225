"""Token sampling — greedy / temperature / top-k / top-p — counterpart of
``deepspeed_tpu/inference/sampling.py``.

Randomness comes from an explicit ``torch.Generator`` (the JAX package folds
``jax.random`` keys); the two frameworks draw different numbers from the same
seed, so only greedy streams can agree bit for bit across them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SamplingParams(NamedTuple):
    temperature: float = 1.0
    top_k: int = 0          # 0 = disabled
    top_p: float = 1.0      # 1.0 = disabled
    greedy: bool = False


def filter_logits(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Temperature/top-k/top-p filtered logits (``-inf`` where cut), over the
    last axis. One descending sort serves both cutoffs; top-p runs over the
    top-k-filtered order, and ties at a cutoff are kept, as in the JAX
    ``filter_logits``."""
    logits = logits.float() / max(params.temperature, 1e-6)
    srt = None
    if params.top_k > 0 or params.top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
    if params.top_k > 0:
        k = min(params.top_k, logits.shape[-1])
        kth = srt[..., k - 1:k]                          # k-th largest
        logits = logits.masked_fill(logits < kth, float("-inf"))
        srt = srt.masked_fill(srt < kth, float("-inf"))
    if params.top_p < 1.0:
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest set with cumulative prob >= top_p (always keep #1);
        # the cutoff is the SMALLEST kept logit
        keep = cum - probs < params.top_p
        cutoff = torch.where(keep, srt, torch.full_like(srt, float("inf"))) \
            .min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def sample(logits: torch.Tensor, params: SamplingParams = SamplingParams(),
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits [..., vocab] → token ids [...] (int64)."""
    if params.greedy or params.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, params), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    ids = torch.multinomial(flat, 1, generator=generator)[:, 0]
    return ids.reshape(probs.shape[:-1])
