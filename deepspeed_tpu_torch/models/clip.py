"""CLIP (contrastive text–image) — counterpart of
``deepspeed_tpu/models/clip.py`` (``CLIPTowerConfig`` :31, ``CLIPConfig``
:50, ``init`` :122, ``param_logical_axes`` :156, ``_block`` :177,
``encode_text`` :205, ``_patchify`` :231, ``encode_image`` :241, ``apply``
:260, ``loss_fn`` :273, ``model_spec`` :287).

Both towers are pre-LN encoders (quick-gelu or gelu MLPs) sharing one
block: the text tower causal with EOS pooling, the vision tower
bidirectional over the class token and the image's patches, embedded by a
reshape and a ``torch.matmul`` (no convolution, as the JAX package embeds
them); then the contrastive head (projections and a learned logit scale).
Attention is op ``attention``: the flash kernels on CUDA tensors.

Parameter names follow the JAX tree, nested dicts joined by dots and each
tower's layer dim unstacked (``text.layers.<i>.wq`` for
``text/layers/wq[i]``); the block matrices (``wq``, ``wk``, ``wv``, ``wo``,
``w_up``, ``w_down``) in ``nn.Linear`` layout ``[out, in]``
(``models/convert.py``), ``patch_embed`` and the projections ``x @ W`` as
the JAX tree keeps them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.attention import attention
from ..ops.embedding import embedding_lookup
from ..ops.norms import layer_norm
from ..runtime.partitioning import LeafAxes, linear

TOWERS = ("text", "vision")


@dataclass(frozen=True)
class CLIPTowerConfig:
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_layers: int = 12
    num_heads: int = 8
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"   # OpenAI CLIP; LAION/OpenCLIP use 'gelu'

    def __post_init__(self):
        if self.hidden_act not in ("quick_gelu", "gelu"):
            raise ValueError(f"unsupported CLIP activation "
                             f"{self.hidden_act!r} (quick_gelu | gelu)")

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class CLIPConfig:
    # text tower
    vocab_size: int = 49408
    max_seq_len: int = 77
    eos_token_id: int = 49407
    text: CLIPTowerConfig = field(default_factory=CLIPTowerConfig)
    # vision tower
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3
    vision: CLIPTowerConfig = field(default_factory=lambda: CLIPTowerConfig(
        hidden_size=768, intermediate_size=3072, num_heads=12))
    projection_dim: int = 512

    def __post_init__(self):
        # a config read back from JSON carries the towers as dicts
        for tower in TOWERS:
            t = getattr(self, tower)
            if isinstance(t, dict):
                object.__setattr__(self, tower, CLIPTowerConfig(**t))

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def tiny(cls, **kw) -> "CLIPConfig":
        base = dict(
            vocab_size=64, max_seq_len=16, eos_token_id=63,
            text=CLIPTowerConfig(hidden_size=32, intermediate_size=64,
                                 num_layers=2, num_heads=2),
            image_size=32, patch_size=8,
            vision=CLIPTowerConfig(hidden_size=32, intermediate_size=64,
                                   num_layers=2, num_heads=2),
            projection_dim=24)
        base.update(kw)
        return cls(**base)


def _tower_layer_shapes(tcfg: CLIPTowerConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    h, i = tcfg.hidden_size, tcfg.intermediate_size
    return {"ln1_scale": ((h,), 0), "ln1_bias": ((h,), 0),
            "wq": ((h, h), h), "bq": ((h,), 0),
            "wk": ((h, h), h), "bk": ((h,), 0),
            "wv": ((h, h), h), "bv": ((h,), 0),
            "wo": ((h, h), h), "bo": ((h,), 0),
            "ln2_scale": ((h,), 0), "ln2_bias": ((h,), 0),
            "w_up": ((i, h), h), "b_up": ((i,), 0),
            "w_down": ((h, i), i), "b_down": ((h,), 0)}


def param_shapes(cfg: CLIPConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """``state_dict`` name → (shape, fan_in) of every parameter, in the JAX
    ``init``'s order and distribution (fan_in 0: LayerNorm scales 1, biases
    and the class embedding 0; ``logit_scale`` is set apart in :func:`init`)."""
    h_t, h_v, p = cfg.text.hidden_size, cfg.vision.hidden_size, cfg.projection_dim
    patch_dim = cfg.num_channels * cfg.patch_size ** 2
    shapes = {"text.embed": ((cfg.vocab_size, h_t), h_t),
              "text.pos_embed": ((cfg.max_seq_len, h_t), h_t)}
    for l in range(cfg.text.num_layers):
        shapes.update({f"text.layers.{l}.{n}": s
                       for n, s in _tower_layer_shapes(cfg.text).items()})
    shapes.update({"text.final_ln_scale": ((h_t,), 0), "text.final_ln_bias": ((h_t,), 0),
                   "vision.class_embed": ((h_v,), 0),
                   "vision.patch_embed": ((patch_dim, h_v), patch_dim),
                   "vision.pos_embed": ((cfg.num_patches + 1, h_v), h_v),
                   "vision.pre_ln_scale": ((h_v,), 0), "vision.pre_ln_bias": ((h_v,), 0)})
    for l in range(cfg.vision.num_layers):
        shapes.update({f"vision.layers.{l}.{n}": s
                       for n, s in _tower_layer_shapes(cfg.vision).items()})
    shapes.update({"vision.post_ln_scale": ((h_v,), 0), "vision.post_ln_bias": ((h_v,), 0),
                   "text_projection": ((h_t, p), h_t), "visual_projection": ((h_v, p), h_v),
                   "logit_scale": ((), 0)})
    return shapes


def param_logical_axes(cfg: CLIPConfig) -> Dict[str, LeafAxes]:
    """Logical axes of every parameter (JAX ``param_logical_axes`` :156),
    per layer and in the port's layout."""
    vec = lambda name: LeafAxes((name,))  # noqa: E731
    per_layer = {"ln1_scale": vec("embed"), "ln1_bias": vec("embed"),
                 "wq": linear("heads", "embed"), "bq": vec("heads"),
                 "wk": linear("heads", "embed"), "bk": vec("heads"),
                 "wv": linear("heads", "embed"), "bv": vec("heads"),
                 "wo": linear("embed", "heads"), "bo": vec("embed"),
                 "ln2_scale": vec("embed"), "ln2_bias": vec("embed"),
                 "w_up": linear("mlp", "embed"), "b_up": vec("mlp"),
                 "w_down": linear("embed", "mlp"), "b_down": vec("embed")}
    top = {"text.embed": LeafAxes(("vocab", "embed")),
           "text.pos_embed": LeafAxes((None, "embed")),
           "text.final_ln_scale": vec("embed"), "text.final_ln_bias": vec("embed"),
           "vision.class_embed": vec("embed"),
           "vision.patch_embed": LeafAxes((None, "embed")),
           "vision.pos_embed": LeafAxes((None, "embed")),
           "vision.pre_ln_scale": vec("embed"), "vision.pre_ln_bias": vec("embed"),
           "vision.post_ln_scale": vec("embed"), "vision.post_ln_bias": vec("embed"),
           "text_projection": LeafAxes(("embed", None)),
           "visual_projection": LeafAxes(("embed", None)),
           "logit_scale": LeafAxes(())}
    return {name: top[name] if name in top else per_layer[name.rsplit(".", 1)[1]]
            for name in param_shapes(cfg)}


LOGIT_SCALE_INIT = 2.6592    # ln(1/0.07), HF init


@torch.no_grad()
def init(cfg: CLIPConfig, generator: torch.Generator, dtype=torch.float32,
         device=None, keep=None) -> Dict[str, torch.Tensor]:
    """Weights from ``generator`` with the JAX ``init``'s distribution:
    matrices and embedding tables N(0, 1/fan_in), LayerNorm scales 1,
    biases and the class embedding 0, ``logit_scale`` ln(1/0.07)."""
    gen_device = generator.device
    device = gen_device if device is None else device
    out: Dict[str, torch.Tensor] = {}
    for name, (shape, fan_in) in param_shapes(cfg).items():
        if fan_in:
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=gen_device).mul_(fan_in ** -0.5)
            out[name] = w.to(device=device, dtype=dtype)
            del w
        elif name == "logit_scale":
            out[name] = torch.full(shape, LOGIT_SCALE_INIT, dtype=dtype, device=device)
        elif name.endswith("_scale"):
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        if keep is not None:
            out[name] = keep(name, out[name])
    return out


def _act(tcfg: CLIPTowerConfig, x: torch.Tensor) -> torch.Tensor:
    if tcfg.hidden_act == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


def _block(tcfg: CLIPTowerConfig, x: torch.Tensor, w, causal: bool) -> torch.Tensor:
    """One pre-LN block (JAX ``_block``); ``w(name)`` hands out the layer's
    leaves."""
    b, s, h = x.shape
    nh, hd = tcfg.num_heads, tcfg.head_size
    eps = tcfg.layer_norm_eps
    y = layer_norm(x, w("ln1_scale"), w("ln1_bias"), eps)
    q = F.linear(y, w("wq"), w("bq")).reshape(b, s, nh, hd)
    k = F.linear(y, w("wk"), w("bk")).reshape(b, s, nh, hd)
    v = F.linear(y, w("wv"), w("bv")).reshape(b, s, nh, hd)
    a = attention(q, k, v, causal=causal)
    x = x + F.linear(a.reshape(b, s, h), w("wo"), w("bo"))
    y = layer_norm(x, w("ln2_scale"), w("ln2_bias"), eps)
    return x + F.linear(_act(tcfg, F.linear(y, w("w_up"), w("b_up"))),
                        w("w_down"), w("b_down"))


def _run_tower(tcfg: CLIPTowerConfig, params, tower: str, x: torch.Tensor,
               causal: bool, compute_dtype) -> torch.Tensor:
    """The tower's blocks, each layer's leaves read and cast when its block
    is entered."""
    names = _tower_layer_shapes(tcfg)
    for l in range(tcfg.num_layers):
        pre = f"{tower}.layers.{l}."
        p = {n: params[pre + n].to(compute_dtype) for n in names}
        x = _block(tcfg, x, p.__getitem__, causal)
    return x


def _top(params, tower: str, names, compute_dtype) -> Dict[str, torch.Tensor]:
    return {n: params[f"{tower}.{n}"].to(compute_dtype) for n in names}


def encode_text(cfg: CLIPConfig, params: Dict[str, torch.Tensor], tokens: torch.Tensor, *,
                compute_dtype=torch.float32, project: bool = True) -> torch.Tensor:
    """tokens [b, s] → pooled text features [b, proj] (EOS-position pooling,
    HF ``CLIPTextModel`` semantics; JAX ``encode_text``)."""
    tokens = tokens.long()
    tp = _top(params, "text", ("pos_embed", "final_ln_scale", "final_ln_bias"), compute_dtype)
    s = tokens.shape[1]
    x = embedding_lookup(params["text.embed"].to(compute_dtype), tokens, compute_dtype) \
        + tp["pos_embed"][:s][None]
    x = _run_tower(cfg.text, params, "text", x, True, compute_dtype)
    x = layer_norm(x, tp["final_ln_scale"], tp["final_ln_bias"], cfg.text.layer_norm_eps)
    if cfg.eos_token_id == 2:
        # legacy OpenAI checkpoints carry eos_token_id=2 in their configs
        # while the actual EOT token is the vocab max (HF's special case)
        eos_pos = torch.argmax(tokens, dim=-1)
    else:
        eos_pos = torch.argmax((tokens == cfg.eos_token_id).int(), dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eos_pos]
    if not project:
        return pooled
    return pooled @ params["text_projection"].to(compute_dtype)


def _patchify(cfg: CLIPConfig, images: torch.Tensor) -> torch.Tensor:
    """[b, c, H, W] → [b, num_patches, c*p*p], matching a stride-p
    convolution's weight layout (out_ch, c, p, p) flattened per patch."""
    b, c, H, W = images.shape
    p = cfg.patch_size
    x = images.reshape(b, c, H // p, p, W // p, p)
    x = x.permute(0, 2, 4, 1, 3, 5)          # [b, gh, gw, c, p, p]
    return x.reshape(b, (H // p) * (W // p), c * p * p)


def encode_image(cfg: CLIPConfig, params: Dict[str, torch.Tensor], images: torch.Tensor, *,
                 compute_dtype=torch.float32, project: bool = True) -> torch.Tensor:
    """images [b, c, H, W] → pooled image features [b, proj] (JAX
    ``encode_image``)."""
    vp = _top(params, "vision", ("class_embed", "patch_embed", "pos_embed", "pre_ln_scale",
                                 "pre_ln_bias", "post_ln_scale", "post_ln_bias"),
              compute_dtype)
    patches = torch.matmul(_patchify(cfg, images.to(compute_dtype)), vp["patch_embed"])
    b = patches.shape[0]
    cls = vp["class_embed"].expand(b, 1, cfg.vision.hidden_size)
    x = torch.cat([cls, patches], dim=1) + vp["pos_embed"][None]
    x = layer_norm(x, vp["pre_ln_scale"], vp["pre_ln_bias"], cfg.vision.layer_norm_eps)
    x = _run_tower(cfg.vision, params, "vision", x, False, compute_dtype)
    pooled = layer_norm(x[:, 0], vp["post_ln_scale"], vp["post_ln_bias"],
                        cfg.vision.layer_norm_eps)
    if not project:
        return pooled
    return pooled @ params["visual_projection"].to(compute_dtype)


def apply(cfg: CLIPConfig, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
          images: torch.Tensor, *, compute_dtype=torch.float32
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (logits_per_text [bt, bi], logits_per_image [bi, bt])."""
    t = encode_text(cfg, params, tokens, compute_dtype=compute_dtype)
    v = encode_image(cfg, params, images, compute_dtype=compute_dtype)
    t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    scale = torch.exp(params["logit_scale"].to(compute_dtype))
    logits_per_text = scale * t @ v.T
    return logits_per_text, logits_per_text.T


def loss_fn(cfg: CLIPConfig, params: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], *, compute_dtype=torch.float32
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Symmetric InfoNCE over in-batch pairs (JAX ``loss_fn``)."""
    lt, li = apply(cfg, params, batch["tokens"], batch["images"],
                   compute_dtype=compute_dtype)
    labels = torch.arange(lt.shape[0], device=lt.device)[:, None]

    def ce(lg):
        return -torch.mean(torch.gather(torch.log_softmax(lg, dim=-1), -1, labels))

    loss = 0.5 * (ce(lt) + ce(li))
    return loss, {"loss": loss.detach()}


def model_spec(cfg: CLIPConfig, compute_dtype=torch.float32):
    """The engine-facing ModelSpec for this config (JAX ``model_spec``);
    ``init_fn`` draws the weights from a ``torch.Generator``."""
    from ..runtime.engine import ModelSpec

    return ModelSpec(
        name="clip",
        init_fn=lambda gen, **kw: init(cfg, gen, **kw),
        loss_fn=lambda params, batch: loss_fn(cfg, params, batch,
                                              compute_dtype=compute_dtype),
        compute_dtype=compute_dtype,
        logical_axes=param_logical_axes(cfg),
        config=cfg,
    )
