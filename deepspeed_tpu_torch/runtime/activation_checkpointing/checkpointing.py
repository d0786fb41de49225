"""Activation checkpointing (rematerialization) — counterpart of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``
(names and policies :50-113, ``configure`` … ``get_policy`` :116-158,
``checkpoint`` / ``checkpoint_wrapper`` / ``CheckpointFunction`` :161-198,
``saved_bytes`` :201-231, ``model_parallel_cuda_manual_seed`` :234).

The JAX package states the trade as a ``jax.checkpoint`` policy: which
intermediates the backward keeps and which it recomputes. Here the same
policy names drive ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)``:

- ``full`` keeps nothing but the function's inputs: the backward re-runs the
  forward (its kernels included: a flash forward or an RMSNorm launches again
  in the recompute);
- ``dots_saveable`` / ``dots_with_no_batch_dims`` keep the outputs of the
  matmul ops (``mm``, ``addmm``, and for the first also ``bmm``) through
  ``torch.utils.checkpoint.create_selective_checkpoint_contexts``;
- the name policies keep the values a model marked with
  :func:`checkpoint_name`. Inside a region that saves a name, the mark is the
  custom op ``dstt::checkpoint_name`` (a copy the selective policy sees and
  keeps); everywhere else it is the identity. ``save_big_matmuls`` keeps its
  five matmul names as the matmul ops' own outputs (every ``mm`` / ``addmm``
  of a family's block is one of them), so the recompute does not redo those
  matmuls, and marks ``attn_mix`` alone;
- ``offload`` / ``offload_dots`` recompute nothing: every tensor the function
  saves for its backward, its inputs apart, is parked in pinned host memory by
  ``torch.autograd.graph.saved_tensors_hooks`` and copied back to the device
  when the backward unpacks it (the reference's ``cpu_checkpointing``).

Every policy computes the same values: the recompute runs the same ops on the
same inputs, so loss and grads are bit for bit those of ``none`` where the
kernels are deterministic.
"""

from __future__ import annotations

import functools
import threading
import types
from dataclasses import dataclass
from typing import Any, Callable, Dict, FrozenSet, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_config: Optional[Any] = None

# the names the model families attach with checkpoint_name (JAX :50-68):
#   "qkv_proj" — the q/k/v projection outputs (pre-rotary),
#   "attn_mix" — the attention output before the wo projection,
#   "attn_out" — the attention output projection,
#   "mlp_gate"/"mlp_up" — the FFN gate/up projections (pre-activation),
#   "mlp_out" — the FFN down-projection.
CHECKPOINT_NAMES = ("residual", "attn_out", "mlp_out", "block_out")
MATMUL_CHECKPOINT_NAMES = ("qkv_proj", "attn_mix", "attn_out",
                           "mlp_gate", "mlp_up", "mlp_out")

# policy name -> the checkpoint names it saves (name-based policies only)
POLICY_SAVED_NAMES = {
    "save_names": CHECKPOINT_NAMES,
    "offload": CHECKPOINT_NAMES,
    "save_attn_out": ("attn_out",),
    "save_big_matmuls": MATMUL_CHECKPOINT_NAMES,
}

_aten = torch.ops.aten
_MATMULS_NO_BATCH = frozenset({_aten.mm.default, _aten.addmm.default})
_MATMULS = _MATMULS_NO_BATCH | {_aten.bmm.default, _aten.baddbmm.default}


@dataclass(frozen=True)
class Policy:
    """What the backward keeps of a checkpointed function: the outputs of
    ``ops``, the values marked with a name in ``marked``; with ``offload``,
    everything it saves, in host memory, and nothing is recomputed."""

    name: str
    ops: FrozenSet[Any] = frozenset()
    marked: Tuple[str, ...] = ()
    offload: bool = False


POLICIES: Dict[str, Optional[Policy]] = {
    "full": Policy("full"),
    "none": None,                      # no remat at all
    "dots_saveable": Policy("dots_saveable", ops=_MATMULS),
    "dots_with_no_batch_dims": Policy("dots_with_no_batch_dims", ops=_MATMULS_NO_BATCH),
    "save_names": Policy("save_names", marked=CHECKPOINT_NAMES),
    "save_attn_out": Policy("save_attn_out", marked=POLICY_SAVED_NAMES["save_attn_out"]),
    # the matmul names are the mm / addmm outputs themselves; attn_mix is
    # the attention's output, marked
    "save_big_matmuls": Policy("save_big_matmuls", ops=_MATMULS_NO_BATCH,
                               marked=("attn_mix",)),
    "offload": Policy("offload", offload=True),
    "offload_dots": Policy("offload_dots", offload=True),
}


# --------------------------------------------------------------------------- #
# checkpoint_name: the identity a selective policy can see
# --------------------------------------------------------------------------- #
@torch.library.custom_op("dstt::checkpoint_name", mutates_args=())
def _named(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_named.register_fake
def _(x, name):
    return torch.empty_like(x)


_named.register_autograd(lambda ctx, grad: (grad, None))
_NAMED_OP = torch.ops.dstt.checkpoint_name.default

_state = threading.local()


def _marked() -> Tuple[str, ...]:
    return getattr(_state, "marked", ())


def in_checkpoint() -> bool:
    """True while a checkpointed function runs (its forward or its
    recompute): ZeRO stage 3 then gathers a leaf at each read instead of
    keeping it for the micro-batch, so the recompute gathers it again."""
    return getattr(_state, "depth", 0) > 0


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Mark ``x`` as the value ``name`` (JAX ``checkpoint_name``): the
    identity, except inside a checkpointed function whose policy saves
    ``name``, where it is the op ``dstt::checkpoint_name`` that the policy
    keeps."""
    if name in _marked():
        return _named(x, name)
    return x


def _region(fn: Callable, pol: Policy) -> Callable:
    """``fn`` with the policy's marks and the checkpoint flag on while it
    runs (forward and recompute alike)."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        prev_marked, prev_depth = _marked(), getattr(_state, "depth", 0)
        _state.marked, _state.depth = pol.marked, prev_depth + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _state.marked, _state.depth = prev_marked, prev_depth

    return run


def _saves(pol: Policy, func) -> bool:
    return func is _NAMED_OP or func in pol.ops


def _contexts(pol: Policy):
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    def policy_fn(ctx, func, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if _saves(pol, func) \
            else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy_fn)


# --------------------------------------------------------------------------- #
# offload: saved tensors parked in pinned host memory
# --------------------------------------------------------------------------- #
def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _HostPark:
    """The pack / unpack pair of the offload policies: a saved tensor that is
    not one of the function's inputs is copied to host memory (pinned when it
    comes from the GPU) and brought back at unpack; ``parked`` counts the
    bytes moved."""

    def __init__(self, inputs):
        self.keep = {_storage_key(t) for t in _tensors(inputs)}
        self.parked = 0

    def pack(self, t: torch.Tensor):
        if _storage_key(t) in self.keep or (t.is_leaf and t.requires_grad):
            return (None, t)
        host = torch.empty(t.size(), dtype=t.dtype, device="cpu", pin_memory=t.is_cuda)
        host.copy_(t, non_blocking=t.is_cuda)
        self.parked += t.numel() * t.element_size()
        return (t.device, host)

    @staticmethod
    def unpack(packed) -> torch.Tensor:
        device, t = packed
        if device is None:
            return t
        return t.to(device, non_blocking=device.type == "cuda")


def _offloaded(function: Callable, args, kwargs):
    park = _HostPark((args, kwargs))
    with torch.autograd.graph.saved_tensors_hooks(park.pack, park.unpack):
        return function(*args, **kwargs)


# --------------------------------------------------------------------------- #
# the reference's API
# --------------------------------------------------------------------------- #
def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, checkpoint_in_cpu=None,
              synchronize=None, profile=None):
    """The reference's ``configure``: stores the policy that
    :func:`checkpoint` uses by default (``checkpoint_in_cpu`` selects
    ``offload``). The caller's config object is not changed."""
    global _config
    src = deepspeed_config
    if src is not None and hasattr(src, "activation_checkpointing"):
        src = src.activation_checkpointing
    cfg = types.SimpleNamespace(
        policy=getattr(src, "policy", "full") if src is not None else "full",
        cpu_checkpointing=bool(checkpoint_in_cpu
                               or getattr(src, "cpu_checkpointing", False)),
        partition_activations=bool(partition_activations
                                   or getattr(src, "partition_activations", False)))
    if cfg.cpu_checkpointing:
        cfg.policy = "offload"
    get_policy(cfg.policy)          # an unknown name raises here
    _config = cfg
    return _config


def is_configured() -> bool:
    return _config is not None


def reset():
    """The reference frees its stashed buffers; nothing is held here
    between calls, so this only forgets the configured policy."""
    global _config
    _config = None


def _default_name() -> str:
    return getattr(_config, "policy", "full") if _config else "full"


def get_policy(name: Optional[str] = None) -> Optional[Policy]:
    """The :class:`Policy` of ``name`` (or of the configured one); None for
    ``none``."""
    if name is None:
        name = _default_name()
    if name not in POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; have {sorted(POLICIES)}")
    return POLICIES[name]


def checkpoint(function: Callable, *args, policy: Optional[str] = None, **kwargs):
    """The reference's ``checkpoint(function, *args)``: ``function(*args)``,
    whose backward keeps what ``policy`` (default: the configured one) says
    and recomputes the rest."""
    pol = get_policy(policy or _default_name())
    if pol is None:
        return function(*args, **kwargs)
    if pol.offload:
        return _offloaded(function, args, kwargs)
    from torch.utils.checkpoint import checkpoint as _checkpoint

    extra = {"context_fn": functools.partial(_contexts, pol)} if pol.ops or pol.marked else {}
    return _checkpoint(_region(function, pol), *args, use_reentrant=False, **extra, **kwargs)


def checkpoint_wrapper(function: Callable, policy: Optional[str] = None) -> Callable:
    """Decorator form: ``function`` under :func:`checkpoint` at every call."""
    name = policy or _default_name()
    if name == "none":
        return function

    @functools.wraps(function)
    def wrapped(*args, **kwargs):
        return checkpoint(function, *args, policy=name, **kwargs)

    return wrapped


class CheckpointFunction:
    """Name of the reference's autograd.Function."""

    @staticmethod
    def apply(run_function, *args):
        return checkpoint(run_function, *args)


class _SavedOutputs(TorchDispatchMode):
    """Adds up the bytes of the op outputs that ``pol`` keeps, one count a
    storage, the inputs' storages apart."""

    def __init__(self, pol: Policy, keep):
        super().__init__()
        self.pol, self.keep, self.seen = pol, keep, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _saves(self.pol, func):
            for t in _tensors(out):
                key = _storage_key(t)
                if key not in self.keep:
                    self.seen[key] = t.untyped_storage().nbytes()
        return out


def saved_bytes(function: Callable, *args, policy: Optional[str] = None) -> int:
    """Bytes the backward of ``function(*args)`` keeps alive under
    ``policy``, the function's inputs and leaf parameters apart (JAX
    ``saved_bytes``): ``none`` (or None) counts every storage the pack hook
    of ``saved_tensors_hooks`` receives, an offload policy the bytes it parks
    in host memory, a remat policy the outputs it keeps (``full``: 0). The
    function runs once, with grad, and its graph is dropped."""
    pol = get_policy(policy or "none")
    keep = {_storage_key(t) for t in _tensors(args)}
    with torch.enable_grad():
        if pol is None:
            seen: Dict[int, int] = {}

            def pack(t):
                if _storage_key(t) not in keep and not (t.is_leaf and t.requires_grad):
                    seen[_storage_key(t)] = t.untyped_storage().nbytes()
                return t

            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                function(*args)
            return sum(seen.values())
        if pol.offload:
            park = _HostPark(args)
            with torch.autograd.graph.saved_tensors_hooks(park.pack, park.unpack):
                function(*args)
            return park.parked
        mode = _SavedOutputs(pol, keep)
        with mode:
            _region(function, pol)(*args)
        return sum(mode.seen.values())


def model_parallel_cuda_manual_seed(seed: int, device=None) -> torch.Generator:
    """The reference's RNG-tracker entry: a ``torch.Generator`` seeded with
    ``seed`` (on the GPU when one is present, unless ``device`` says
    otherwise); nothing here draws from a global tracker."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.Generator(device=device).manual_seed(seed)
