"""Embedding lookup — counterpart of ``deepspeed_tpu/ops/embedding.py``
(``embedding_lookup`` :31). Plain PyTorch gather; the vocab-sharded
(tensor-parallel) branch comes with tensor parallelism."""

from __future__ import annotations

import torch


def embedding_lookup(table: torch.Tensor, tokens: torch.Tensor,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """tokens [...] integer → embeddings [..., hidden] in ``compute_dtype``."""
    return table[tokens.long()].to(compute_dtype)
