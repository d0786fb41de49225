"""Evoformer attention (AlphaFold-style MSA attention) — counterpart of
``deepspeed_tpu/ops/evoformer_attn.py`` (``evoformer_attention`` :27,
``msa_row_attention`` :70, ``msa_column_attention`` :93).

softmax(q·kᵀ·scale + Σ biases)·v over the residue axis of 5-D MSA tensors,
with the mask bias (-1e30 on masked residues) and the pair bias as
additive biases. Shapes: q/k/v ``[*, s, r, h, d]`` (MSA rows s, residues
r); each bias broadcastable to ``[*, s, h, r, r]``.

The kernel path (the default, as the JAX package's on its accelerator)
folds the MSA rows into the batch, sums the biases in fp32 as the JAX
package does (one bias stays a broadcast view, read in place), and runs the
flash kernels' bias mode non-causally (``ops/flash_attention.py``
:class:`FlashAttentionBias`); the pair bias's gradient comes from the dQ
kernel's dbias. It needs CUDA tensors and raises ``RuntimeError`` on others,
and ``ValueError`` on fp16 (ROADMAP queue B.2). ``use_kernel=False`` is the
einsum path of the JAX signature, on any device.
A residue row whose every key is masked averages v uniformly on both paths,
as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .flash_attention import flash_attention

NEG_INF = -1e30
FP16_REFUSAL = ("evoformer_attention's kernel path takes no fp16 yet (ROADMAP queue B.2): "
                "run it in bf16 or fp32, or pass use_kernel=False")


def _kernel_path(q, k, v, biases, scale):
    """Fold MSA rows into the batch, sum the biases in fp32, and run the
    flash bias mode. On CPU tensors the flash pieces take their plain
    versions (the tests reach this path that way)."""
    *lead, s, r, h, d = q.shape
    bias = None
    if biases:
        shape = (*lead, s, h, r, r)
        bias = biases[0].float().expand(shape)
        for b in biases[1:]:
            bias = bias + b.float()
        bias = bias.reshape(-1, h, r, r)
    fold = lambda x: x.reshape(-1, r, h, d)  # noqa: E731
    out = flash_attention(fold(q), fold(k), fold(v), causal=False, scale=scale, bias=bias)
    return out.reshape(q.shape).to(q.dtype)


def evoformer_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        biases: Optional[Sequence[torch.Tensor]] = None,
                        scale: Optional[float] = None,
                        use_kernel: Optional[bool] = None) -> torch.Tensor:
    """softmax(q·kᵀ/√d + Σ biases)·v over the residue axis; q/k/v
    ``[*, s, r, h, d]``, returns q's shape and dtype. ``use_kernel`` None or
    True: the flash kernels' bias mode (CUDA tensors only); False: the
    einsum path."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    if use_kernel is not False:
        if q.device.type != "cuda":
            raise RuntimeError("evoformer_attention's kernel path runs on a CUDA GPU and "
                               f"got {q.device} tensors; pass use_kernel=False for the "
                               "einsum path")
        if q.dtype == torch.float16:
            raise ValueError(FP16_REFUSAL)
        return _kernel_path(q, k, v, biases, scale)
    logits = torch.einsum("...sqhd,...skhd->...shqk", q.float(), k.float()) * scale
    for b in (biases or ()):
        logits = logits + b.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("...shqk,...skhd->...sqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def msa_row_attention(msa: torch.Tensor, wq, wk, wv, wo,
                      pair_bias: Optional[torch.Tensor] = None,
                      mask: Optional[torch.Tensor] = None,
                      num_heads: int = 8,
                      use_kernel: Optional[bool] = None) -> torch.Tensor:
    """MSA row-wise self-attention with pair bias. msa ``[*, s, r, c]``;
    weights ``[c, c]`` used as ``x @ w`` (the JAX layout); pair_bias
    ``[*, h, r, r]``; mask ``[*, s, r]`` (1 = valid)."""
    *lead, s, r, c = msa.shape
    hd = c // num_heads
    q = (msa @ wq).reshape(*lead, s, r, num_heads, hd)
    k = (msa @ wk).reshape(*lead, s, r, num_heads, hd)
    v = (msa @ wv).reshape(*lead, s, r, num_heads, hd)
    biases: List[torch.Tensor] = []
    if mask is not None:
        valid = mask[..., :, None, None, :].bool()
        biases.append(torch.where(valid, 0.0, NEG_INF).to(torch.float32))
    if pair_bias is not None:
        biases.append(pair_bias[..., None, :, :, :])
    out = evoformer_attention(q, k, v, biases, use_kernel=use_kernel)
    return out.reshape(*lead, s, r, c) @ wo


def msa_column_attention(msa: torch.Tensor, wq, wk, wv, wo,
                         mask: Optional[torch.Tensor] = None,
                         num_heads: int = 8,
                         use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Column-wise attention = row attention on the transposed MSA."""
    msa_t = msa.transpose(-3, -2)
    mask_t = mask.transpose(-2, -1) if mask is not None else None
    out = msa_row_attention(msa_t, wq, wk, wv, wo, mask=mask_t,
                            num_heads=num_heads, use_kernel=use_kernel)
    return out.transpose(-3, -2)
