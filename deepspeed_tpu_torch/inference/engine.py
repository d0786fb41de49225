"""Inference engine v1 — counterpart of ``deepspeed_tpu/inference/engine.py``
(``ModelFamily`` :36-61, ``InferenceEngine`` :68, weight-only quantization
``_quantize_params`` / ``_dq_leaf`` / ``_dq`` :133-218, ``forward`` :231,
``_step_fns`` :239-287, ``generate`` :289-340, ``init_inference`` :343-441).

The engine holds a family's weights on the device in ``inference.dtype`` and
serves them two ways: :meth:`InferenceEngine.forward`, the no-cache forward
(scoring), and :meth:`InferenceEngine.generate`, a prefill into the family's
dense KV cache (``init_cache`` / ``apply_cached``) then decode steps. The
decode runs in chunks of :data:`CHUNK` steps with one host sync a chunk, the
EOS state carried on the device, as the JAX engine's ``decode_chunk`` scan
does. The compute dtype is ``inference.dtype`` (bf16 on the card).

Weight-only quantization (``inference.quant``): every float leaf of two or
more dims in the JAX package's tree (there a layer's leaves are stacked, so
a layer's norms and biases too) rests on the device quantized with a scale
per row of the JAX layout (its last dim; the port keeps the ``x @ W`` matrices
transposed, ``models/convert.py`` ``is_transposed``, so their rows run along
dim 0 here): int8 ``{q, scale}``, packed int4 ``{q4, scale}`` (two nibbles a
byte along that dim; an odd one falls back to int8) or fp8
``{f8, scale}`` (``float8_e4m3fn``, ``scale = amax / 448``). The family
reads a block's leaves when it enters the block, and each read dequantizes
that leaf alone (:class:`Dequantized`), so a bf16 copy of one block at a
time exists, never of the whole model (XLA fuses the dequantization into
the matmul in the JAX package).

The v2 engine (``engine_v2.py``) subclasses this one for the weights, and
builds the family's paged ``nn.Module`` over them. ``enable_cuda_graph`` is
accepted and ignored by v1, as in the JAX package; tensor parallelism is not
ported (``tensor_parallel.tp_size > 1`` raises).
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Mapping
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..models.convert import is_transposed
from ..utils.device import resolve_device
from ..utils.logging import log_dist
from .config import InferenceConfig, check_ported
from .sampling import SamplingParams, sample

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32,
           "float16": torch.float16, "fp16": torch.float16}

CHUNK = 32          # decode steps between host syncs (JAX ``generate``)
FP8_MAX = 448.0     # e4m3 max normal


@dataclasses.dataclass
class ModelFamily:
    """What the engines need from a model family: the v1 functions (the
    no-cache forward, the dense-cache forward and its cache) and, for the
    v2 engine, a module constructor, its paged forward and its paged
    cache. A family without a paged path (BLOOM) serves through v1 only."""

    cfg: Any
    apply_fn: Optional[Callable] = None       # (cfg, params, tokens, *, compute_dtype)
    apply_cached: Optional[Callable] = None   # (cfg, params, tokens, cache, cache_len, *, compute_dtype)
    init_cache: Optional[Callable] = None     # (cfg, batch, max_len, dtype, device)
    build: Optional[Callable] = None          # (cfg) -> nn.Module with uninitialised params
    apply_paged: Optional[Callable] = None    # (cfg, model, tokens, cache, tables, ctx, *, valid)
    init_paged_cache: Optional[Callable] = None  # (cfg, num_blocks, block_size, dtype, device)
    name: str = "model"

    @classmethod
    def from_module(cls, module, cfg) -> "ModelFamily":
        get = lambda name: getattr(module, name, None)  # noqa: E731
        apply_fn = get("apply")

        def apply_logits(*a, **kw):
            out = apply_fn(*a, **kw)
            # MoE families return (logits, aux_loss); inference wants logits
            return out[0] if isinstance(out, tuple) else out

        return cls(cfg=cfg, apply_fn=apply_logits if apply_fn is not None else None,
                   apply_cached=get("apply_cached"),
                   init_cache=get("init_cache"), build=get("build"),
                   apply_paged=get("apply_paged"), init_paged_cache=get("init_paged_cache"),
                   name=getattr(module, "__name__", "model").rsplit(".", 1)[-1])


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported inference dtype {name!r}") from None


# --------------------------------------------------------------------------- #
# weight-only quantization
# --------------------------------------------------------------------------- #
def _row_dim(name: str) -> int:
    """The dim a leaf's quantization rows run along: the JAX layout's last
    dim, which is dim 0 of a transposed matrix here."""
    return 0 if is_transposed(name) else -1


def quantize_leaf(name: str, leaf: torch.Tensor, bits: int = 8, fp8: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """One leaf's quantized form (JAX ``_quantize_params``), computed in the
    leaf's own dtype as the JAX engine computes it: the scale is the row's
    absolute max (at least 1e-8) over ``2**(bits-1) - 1``, or over 448 for
    fp8; the codes are ``round(leaf / scale)`` clipped to the signed range,
    or the quotient cast to ``float8_e4m3fn``."""
    dim = _row_dim(name)
    amax = torch.clamp(leaf.abs().amax(dim=dim, keepdim=True), min=1e-8)
    if fp8:
        scale = amax / FP8_MAX
        return {"f8": (leaf / scale).to(torch.float8_e4m3fn), "scale": scale.float()}
    qmax = 2 ** (bits - 1) - 1
    scale = amax / qmax
    q = torch.clamp(torch.round(leaf / scale), -qmax - 1, qmax).to(torch.int8)
    if bits == 4 and leaf.shape[dim] % 2 == 0:
        idx = torch.arange(0, leaf.shape[dim], 2, device=q.device)
        lo = q.index_select(dim, idx) & 0xF
        hi = (q.index_select(dim, idx + 1) & 0xF) << 4
        return {"q4": (lo | hi).to(torch.uint8), "scale": scale.float()}
    return {"q": q, "scale": scale.float()}


def dequantize_leaf(name: str, x: Dict[str, torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """A quantized leaf back in ``dtype`` (JAX ``_dq_leaf``): codes times
    scale, both cast to ``dtype`` first; packed int4 nibbles sign-extended
    and interleaved back along their dim."""
    scale = x["scale"].to(dtype)
    if "q" in x:
        return x["q"].to(dtype) * scale
    if "f8" in x:
        return x["f8"].to(dtype) * scale
    packed = x["q4"]
    dim = _row_dim(name) % packed.dim()
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    shape = list(packed.shape)
    shape[dim] *= 2
    q = torch.stack([lo, hi], dim=dim + 1).reshape(shape)
    return q.to(dtype) * scale


def is_quantized(x) -> bool:
    return isinstance(x, dict) and set(x) in ({"q", "scale"}, {"q4", "scale"}, {"f8", "scale"})


def quantized_bytes(params: Mapping[str, Any]) -> int:
    """Bytes of the weights at rest (codes and scales of quantized leaves)."""
    total = 0
    for v in params.values():
        for t in (v.values() if is_quantized(v) else [v]):
            total += t.numel() * t.element_size()
    return total


class Dequantized(Mapping):
    """The engine's params as the family reads them: a quantized leaf is
    dequantized to ``dtype`` at each read, anything else handed out as it
    rests."""

    def __init__(self, params: Mapping[str, Any], dtype: torch.dtype):
        self._params, self._dtype = params, dtype

    def __getitem__(self, name: str) -> torch.Tensor:
        x = self._params[name]
        return dequantize_leaf(name, x, self._dtype) if is_quantized(x) else x

    def __iter__(self):
        return iter(self._params)

    def __len__(self) -> int:
        return len(self._params)


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #
class InferenceEngine:
    """Construct through :func:`init_inference`. ``params`` maps the
    family's ``param_shapes`` names to tensors or arrays."""

    _engine = "v1"

    def __init__(self, family: ModelFamily, params: Mapping[str, Any],
                 config: Optional[InferenceConfig] = None, device="cuda"):
        self.family = family
        self.config = config or InferenceConfig()
        self.device = resolve_device(device)
        self.dtype = torch_dtype(self.config.dtype)
        self._check()
        qc = self.config.quant
        self._quantized = bool(qc.enabled)
        self._fp8 = str(qc.dtype).lower() in ("fp8", "float8", "e4m3")
        self.params: Dict[str, Any] = {}
        with torch.no_grad():
            for name, value in params.items():
                t = torch.as_tensor(value)
                if not t.is_floating_point():
                    self.params[name] = t.to(self.device)
                elif self._quantized and (t.dim() >= 2 or name.startswith("layers.")):
                    self.params[name] = quantize_leaf(name, t.to(self.device),
                                                      bits=int(qc.bits), fp8=self._fp8)
                else:
                    # a tensor already on the device in the dtype is not copied
                    self.params[name] = t.to(device=self.device, dtype=self.dtype)
        mode = ("fp8" if self._fp8 else f"int{qc.bits}") if self._quantized else "off"
        log_dist(f"InferenceEngine: {family.name} on {self.device} "
                 f"(dtype={self.dtype}, quant={mode})")

    def _check(self) -> None:
        check_ported(self.config, self._engine)
        if self.family.apply_cached is None or self.family.init_cache is None:
            raise ValueError(f"family {self.family.name!r} has no dense-cache path "
                             "(apply_cached / init_cache)")

    @property
    def module(self) -> ModelFamily:
        return self.family

    def weights(self) -> Mapping[str, torch.Tensor]:
        """The params as the family reads them (dequantized leaf by leaf)."""
        return Dequantized(self.params, self.dtype) if self._quantized else self.params

    def weight_bytes(self) -> int:
        """Device bytes of the weights at rest."""
        return quantized_bytes(self.params)

    def _tensor(self, a, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(device=self.device, dtype=dtype)

    def forward(self, tokens) -> torch.Tensor:
        """Full no-cache forward → logits [batch, seq, vocab] fp32 (the
        scoring / perplexity path)."""
        fam = self.family
        with torch.inference_mode():
            return fam.apply_fn(fam.cfg, self.weights(), self._tensor(tokens),
                                compute_dtype=self.dtype)

    __call__ = forward

    def _apply_cached(self, tokens, cache, cache_len):
        fam = self.family
        return fam.apply_cached(fam.cfg, self.weights(), tokens, cache, cache_len,
                                compute_dtype=self.dtype)

    def _prefill(self, padded, lengths: torch.Tensor, max_len: int):
        """The prompts' forward into a new dense cache: (logits [b, t, V]
        fp32, cache)."""
        fam = self.family
        b = padded.shape[0]
        cache = fam.init_cache(fam.cfg, b, max_len, dtype=self.dtype, device=self.device)
        return self._apply_cached(padded, cache, torch.zeros_like(lengths))

    def generate(self, prompts, prompt_lengths=None, max_new_tokens: int = 64,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0
                 ) -> np.ndarray:
        """prompts: [batch, t] int array (right-padded, ``prompt_lengths``
        the real lengths); returns [batch, max_new_tokens] generated ids,
        positions after a row's EOS holding EOS. Prompts are padded to a
        multiple of ``prefill_bucket``; the cache holds that plus
        ``max_new_tokens``."""
        prompts = np.asarray(prompts, np.int64)
        b, t = prompts.shape
        if prompt_lengths is None:
            prompt_lengths = np.full((b,), t, np.int64)
        pad_t = _round_up(t, self.config.prefill_bucket)
        max_len = pad_t + max_new_tokens
        padded = np.zeros((b, pad_t), np.int64)
        padded[:, :t] = prompts
        sp = SamplingParams(temperature=temperature, top_k=top_k, top_p=top_p,
                            greedy=temperature == 0.0)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.inference_mode():
            lengths = self._tensor(prompt_lengths)
            logits, cache = self._prefill(self._tensor(padded), lengths, max_len)
            last = logits[torch.arange(b, device=self.device), lengths - 1]
            tok = sample(last, sp, gen)
            first = tok.cpu().numpy()[:, None]
            if max_new_tokens <= 1:
                return first.astype(np.int32)
            # -1 never matches a token id: no EOS needs no separate path
            eos = -1 if eos_token_id is None else int(eos_token_id)
            finished = tok == eos
            cache_len = lengths.clone()
            outs = []
            remaining = max_new_tokens - 1
            while remaining > 0:
                n = min(CHUNK, remaining)
                steps = torch.empty((b, n), dtype=torch.long, device=self.device)
                for i in range(n):
                    logits, cache = self._apply_cached(tok[:, None], cache, cache_len)
                    nxt = sample(logits[:, 0], sp, gen)
                    tok = torch.where(finished, torch.full_like(nxt, eos), nxt)
                    finished = finished | (tok == eos)
                    steps[:, i] = tok
                    cache_len += 1
                outs.append(steps.cpu().numpy())      # one host sync a chunk
                remaining -= n
                if eos_token_id is not None and bool(finished.all()):
                    break
            if remaining > 0:     # early exit: the tail is EOS
                outs.append(np.full((b, remaining), eos, np.int64))
        return np.concatenate([first] + outs, axis=1).astype(np.int32)


# --------------------------------------------------------------------------- #
# init_inference
# --------------------------------------------------------------------------- #
def _checkpoint_params(checkpoint: str, model_cfg) -> Dict[str, torch.Tensor]:
    """The params of a tag the training engine wrote: a universal tag (the
    port's or the JAX engine's fragments) or a regular port tag."""
    from ..models.convert import _param_shapes
    from ..runtime.checkpoint.saver import read_state_tree, resolve_tag
    from ..runtime.checkpoint.universal import read_universal_params

    tag_dir = checkpoint
    if os.path.exists(os.path.join(checkpoint, "latest")):
        tag_dir = os.path.join(checkpoint, resolve_tag(checkpoint, None))
    if os.path.isdir(os.path.join(tag_dir, "param")) or \
            os.path.isdir(os.path.join(tag_dir, "universal")):
        return read_universal_params(tag_dir, model_cfg)
    state = read_state_tree(tag_dir)
    return {name: torch.from_numpy(np.array(state.full(f"params/{name}")))
            for name in _param_shapes(model_cfg)}


def init_inference(model=None, config=None, *, family: Optional[ModelFamily] = None,
                   model_cfg=None, params=None, checkpoint: Optional[str] = None,
                   device="cuda", **kwargs) -> InferenceEngine:
    """Counterpart of ``deepspeed.init_inference``: a :class:`ModelFamily`
    (``family=``) or a family module (``deepspeed_tpu_torch.models.llama``)
    with ``model_cfg=`` and ``params=`` (its ``state_dict``)::

        engine = init_inference(llama, model_cfg=cfg, params=params,
                                config={"quant": {"enabled": True, "bits": 4}})

    ``checkpoint`` reads the weights from disk instead: a training
    checkpoint (a directory with ``latest`` or a tag directory, of a regular
    port tag or a universal one, the port's or the JAX engine's fragments;
    pass the model module and ``model_cfg=`` too), or a local HF checkpoint
    directory, whose family, config and weights its files give
    (``models/hf_import.py``, no ``transformers`` needed). A ``transformers``
    model as ``model`` imports its weights into its family. Runs on the GPU
    unless ``device="cpu"``."""
    cfg = family.cfg if family is not None else model_cfg
    if params is None and checkpoint is not None:
        if (os.path.exists(os.path.join(checkpoint, "latest"))
                or os.path.exists(os.path.join(checkpoint, "meta.json"))
                or os.path.isdir(os.path.join(checkpoint, "state"))
                or os.path.isdir(os.path.join(checkpoint, "param"))):
            if cfg is None:
                raise ValueError("checkpoint= needs the model module and model_cfg= "
                                 "(or family=)")
            params = _checkpoint_params(checkpoint, cfg)
        else:
            # a local HF checkpoint directory: one read resolves the family,
            # its config and its weights
            from ..models.convert import from_jax_params
            from ..models.hf_import import load_checkpoint_dir_module

            fam, model, model_cfg, tree = load_checkpoint_dir_module(checkpoint)
            if not hasattr(model, "apply_cached"):
                raise ValueError(
                    f"family '{fam}' is not generative (no KV-cached "
                    f"decode path) — use its module API directly "
                    f"(e.g. models/{fam}.encode_*) instead of "
                    f"init_inference")
            params = from_jax_params(model_cfg, tree)
    if isinstance(config, dict) or config is None:
        config = InferenceConfig.from_dict({**(config or {}), **kwargs})
    if family is None and model is not None and model_cfg is None and params is None:
        # init_inference(<transformers model>): import its weights once and
        # route to the family's implementation
        from ..models.convert import from_jax_params
        from ..models.hf_import import from_hf, is_hf_model, resolve_module

        if is_hf_model(model):
            fam_name = model.config.model_type
            module = resolve_module(fam_name)
            model_cfg, tree = from_hf(model, fam_name)
            params = from_jax_params(model_cfg, tree)
            model = module
    if family is None:
        if model is None or model_cfg is None:
            raise ValueError("pass family= or (model module, model_cfg=) "
                             "or a transformers model")
        family = ModelFamily.from_module(model, model_cfg)
    if params is None:
        raise ValueError("params (or checkpoint=) is required")
    return InferenceEngine(family, params, config, device=device)
