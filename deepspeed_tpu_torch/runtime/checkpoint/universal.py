"""Universal checkpoint: topology-independent fp32 fragments that both the
JAX package and the port read — counterpart of
``deepspeed_tpu/runtime/checkpoint/universal.py`` (``_dump_leaf`` :84,
``derive_host_rng`` :191, ``save_universal`` :205, ``load_universal`` :280,
``save_universal_checkpoint`` :345, ``load_universal_checkpoint`` :563,
``ds_to_universal`` :679, ``main`` :702).

Layout (the JAX package's, file for file)::

    <tag>/
        meta.json                     (step, counters, loss scale, index)
        manifest.json                 (per-file SHA-256)
        param/<name>/fp32.npy         (the fp32 master)
        optim/mu.<name>/fp32.npy      (AdamW's first moment)
        optim/nu.<name>/fp32.npy      (its second moment)
        optim/step/fp32.npy           (AdamW's step, int32)

and so for every optimizer's state, under the JAX state tree's paths: Lion's
``mu``, Adagrad's ``accum``, Muon's ``mu`` with ``fb_state.{step,mu,nu}``,
the 1-bit ``mu`` / ``nu`` / ``error``; a grouped optimizer's
``<g>.step`` and ``<g>.mu.<i>``, ``i`` the JAX leaf's place in group
``g``'s list (``ops/optimizers.py`` ``grouped_optimizer``).

When the engine's ``ModelSpec`` carries its family's ``config`` (every
family's ``model_spec(cfg)`` sets it), ``<name>`` and the array are the JAX
tree's: the layer leaves stacked along a leading ``L`` dim
(``layers.wq`` ``[L, h, nh*hd]``) and every matrix in ``x @ W`` layout —
the table of ``models/convert.py``, applied one leaf at a time (never the
whole tree on the host). Under ZeRO every rank writes its own region of
each fragment through a memmap, as the JAX ``_dump_leaf`` writes each
shard's region; rank 0 creates the files, owns the staging directory and
publishes it, behind barriers. A ``ModelSpec`` without a config writes its
own names and ``[out, in]`` layout: still independent of topology, but
only the port reads such fragments.

Loading copies into the engine's tensors in place, each rank reading only
its own shard's region of each fragment (one leaf on the host at a time).
As in the JAX package, a universal load sets ``state.step`` to the saved
``global_steps`` (also when fp16 skips left the optimizer step behind) and
restarts a partial gradient-accumulation window; ``meta["loss_scale"]`` is
the list of the seven ``LossScaleState`` leaves in field order.

Left out: the NVMe and host optimizer tiers and the LoCo residuals; their
config blocks are still refused at ``initialize``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import sys
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...comm import comm
from ...models.convert import _param_shapes, is_transposed, jax_leaf
from ...utils.logging import log_dist, logger
from .engines import Part, _host_array, _safe
from .manifest import (_fsync_path, _sha256_many, fsync_tree, multihost_barrier,
                       publish_dir, tag_candidates, verify_manifest, with_io_retries,
                       write_latest, write_manifest)
from ...ops.optimizers import state_scalars, state_tensors, with_scalars
from .saver import _reliability, read_state_tree, resolve_tag, state_leaves

UNIVERSAL_DIR = "universal"
UNIVERSAL_FORMAT = "universal2"
FRAGMENT_FILE = "fp32.npy"


# --------------------------------------------------------------------------- #
# the port's leaves <-> the fragments
# --------------------------------------------------------------------------- #
class LeafMap(NamedTuple):
    """Where one port leaf lives in its fragment: the fragment's name and
    whole shape, the index along its stacked ``L`` dim (None when not
    stacked), and whether the matrix is transposed."""

    fragment: str
    shape: Tuple[int, ...]
    layer: Optional[int]
    transpose: bool

    def index(self, box) -> Tuple:
        """The fragment's index of a region of the port leaf ((lo, hi) per
        port dim)."""
        box = list(reversed(box)) if self.transpose else list(box)
        sl = tuple(slice(lo, hi) for lo, hi in box)
        return sl if self.layer is None else (self.layer,) + sl

    def to_fragment(self, data: Any) -> np.ndarray:
        """A part's data on the host in the fragment's layout (a tensor is
        transposed on its own device, where that is cheap)."""
        if torch.is_tensor(data):
            return _host_array(data.detach().t().contiguous() if self.transpose else data)
        arr = _host_array(data)
        return arr.T if self.transpose else arr


def fragment_map(shapes: Dict[str, Tuple[int, ...]],
                 model_config: Any = None) -> Dict[str, LeafMap]:
    """Port leaf name -> :class:`LeafMap`. With a family's config: the JAX
    tree's names and layout (``layers.<i>.<leaf>`` stacked into
    ``layers.<leaf>``, ``models/convert.py``'s matrices transposed); the
    names must be exactly the config's parameters. Without: the port's own
    names and layout."""
    if model_config is None:
        return {k: LeafMap(k, tuple(s), None, False) for k, s in shapes.items()}
    want = {k: tuple(s) for k, (s, _) in _param_shapes(model_config).items()}
    if want != {k: tuple(s) for k, s in shapes.items()}:
        raise ValueError(f"the engine's leaves are not {type(model_config).__name__}'s "
                         f"parameters: missing {sorted(set(want) - set(shapes))[:8]}, "
                         f"unexpected {sorted(set(shapes) - set(want))[:8]}")
    places = {name: jax_leaf(name) for name in want}
    n_layers: Dict[str, int] = {}
    for path, layer, _ in places.values():
        if layer is not None:
            n_layers[path] = n_layers.get(path, 0) + 1
    out = {}
    for name, shape in want.items():
        t = is_transposed(name) and len(shape) == 2
        fshape = tuple(reversed(shape)) if t else shape
        path, layer, _ = places[name]
        stacked = (n_layers[path],) if layer is not None else ()
        out[name] = LeafMap(path.replace("/", "."), stacked + fshape, layer, t)
    return out


def _path_order(name: str) -> Tuple:
    """The JAX tree's flatten order of a dotted fragment name (nested dict
    keys sorted)."""
    return tuple(name.split("."))


class Fragment(NamedTuple):
    """One fragment file to write: its whole shape and dtype, and this
    rank's regions of it (each a port leaf's part and its map)."""

    shape: Tuple[int, ...]
    dtype: np.dtype
    writes: List[Tuple[LeafMap, Part]]


def _span(shape: Tuple[int, ...], index: Tuple) -> Optional[Tuple[int, int]]:
    """(first element, element count) when ``index`` (ints and slices, one
    per dim) selects one contiguous run of a C-order array of ``shape``,
    else None."""
    box = [(i, i + 1) if isinstance(i, int) else (i.start, i.stop) for i in index]
    k = next((d for d, (lo, hi) in enumerate(box) if hi - lo != 1), len(box))
    if any(box[d] != (0, shape[d]) for d in range(k + 1, len(box))):
        return None
    return (int(np.ravel_multi_index([lo for lo, _ in box], shape)) if shape else 0,
            int(np.prod([hi - lo for lo, hi in box], dtype=np.int64)))


def _write_region(fn: str, mm: np.memmap, index: Tuple, arr: np.ndarray) -> None:
    """``mm[index] = arr``, as one positioned write of the file's bytes when
    the region is one contiguous run (no page faults on the mapping)."""
    span = _span(mm.shape, index)
    if span is None:
        mm[index] = arr
        return
    arr = np.require(arr, mm.dtype, "C")
    fd = os.open(fn, os.O_WRONLY)
    try:
        view, pos = memoryview(arr).cast("B"), mm.offset + span[0] * mm.dtype.itemsize
        while view:
            n = os.pwrite(fd, view, pos)
            view, pos = view[n:], pos + n
    finally:
        os.close(fd)


def _dump_tree(tree: Dict[str, Fragment], root: str) -> Dict[str, Dict]:
    """Write every fragment of ``tree`` under ``root`` (``root/<name>/fp32.npy``):
    rank 0 creates each file at its whole shape, every rank writes its own
    regions through a memmap, and rank 0 fsyncs each file and records its
    shape, dtype, SHA-256 and size (the returned index)."""
    rank0 = comm.get_rank() == 0
    files = {name: os.path.join(root, _safe(name), FRAGMENT_FILE) for name in tree}
    if rank0:
        for name, frag in tree.items():
            os.makedirs(os.path.dirname(files[name]), exist_ok=True)
            mm = np.lib.format.open_memmap(files[name], mode="w+", dtype=frag.dtype,
                                           shape=frag.shape)
            del mm
    multihost_barrier(f"fragments_created:{root}")
    for name, frag in tree.items():
        if not frag.writes:
            continue
        mm = np.lib.format.open_memmap(files[name], mode="r+")
        for lm, part in frag.writes:
            _write_region(files[name], mm, lm.index(part.box()), lm.to_fragment(part.data))
        mm.flush()
        del mm
    multihost_barrier(f"fragments_written:{root}")
    index: Dict[str, Dict] = {}
    if rank0:
        names = sorted(tree, key=_path_order)
        for name in names:
            _fsync_path(files[name])
            _fsync_path(os.path.dirname(files[name]))
        for name, digest in zip(names, _sha256_many([files[n] for n in names])):
            if isinstance(digest, OSError):
                raise digest
            index[name] = {"shape": list(tree[name].shape), "dtype": str(tree[name].dtype),
                           "sha256": digest, "bytes": os.path.getsize(files[name])}
        if tree:
            _fsync_path(root)
    return index


class _FragmentWriter:
    """The object whose ``save`` writes a fragment tree to disk — a seam the
    fault harness patches (``faults.crash_after_save(FRAGMENT_WRITER)``
    models process death between the fragment write and the seal/publish,
    ``faults.io_errors`` exercises ``checkpoint.io_retries``)."""

    def save(self, tree: Dict[str, Fragment], root: str) -> Dict[str, Dict]:
        return _dump_tree(tree, root)


FRAGMENT_WRITER = _FragmentWriter()


def _optim_names(group: str, names: List[str], fmap: Dict[str, LeafMap]) -> Dict[str, str]:
    """Port leaf -> its fragment in state dict ``group`` (a dotted state
    path): ``<group>.<JAX leaf>``; in a grouped optimizer's state (a path
    under a group index, JAX ``grouped_optimizer``), whose leaves are a
    list, ``<group>.<index of the JAX leaf in the group, JAX flatten
    order>``."""
    if group.split(".", 1)[0].isdigit():
        order = sorted({fmap[n].fragment for n in names}, key=_path_order)
        return {n: f"{group}.{order.index(fmap[n].fragment)}" for n in names}
    return {n: f"{group}.{fmap[n].fragment}" for n in names}


def fragment_trees(leaves: Dict[str, Part], opt_scalars: Optional[Dict[str, int]],
                   model_config: Any = None,
                   groups: Optional[Dict[str, List[str]]] = None
                   ) -> Tuple[Dict[str, Fragment], Dict[str, Fragment]]:
    """(param fragments, optim fragments) of this rank's parts, named
    ``params/<leaf>`` and ``<state path>/<leaf>``. ``opt_scalars``: the
    optimizer state's integers by path (None: no optimizer state);
    ``groups``: every port leaf of each state dict (default: the parts')."""
    shapes = {k.split("/", 1)[1]: p.shape for k, p in leaves.items() if k.startswith("params/")}
    fmap = fragment_map(shapes, model_config)
    f32 = np.dtype(np.float32)
    param = {lm.fragment: Fragment(lm.shape, f32, []) for lm in fmap.values()}
    optim: Dict[str, Fragment] = {}
    if opt_scalars is None:
        return param, optim
    for path, value in opt_scalars.items():
        optim[path] = Fragment((), np.dtype(np.int32),
                               [(LeafMap(path, (), None, False),
                                 Part(np.asarray(value, np.int32), (), None, 0))])
    if groups is None:
        groups = {}
        for key in leaves:
            group, name = key.split("/", 1)
            if group != "params":
                groups.setdefault(group, []).append(name)
    names = {g: _optim_names(g, ns, fmap) for g, ns in groups.items()}
    for g, ns in groups.items():
        for n in ns:
            optim[names[g][n]] = Fragment(fmap[n].shape, f32, [])
    for key, part in leaves.items():
        group, name = key.split("/", 1)
        lm = fmap[name]
        if group == "params":
            param[lm.fragment].writes.append((lm, part))
        else:
            optim[names[group][name]].writes.append((lm, part))
    return param, optim


def _engine_groups(engine) -> Dict[str, List[str]]:
    return {g: list(ts) for g, ts in state_tensors(engine.state.opt_state).items()}


def _read_region(root: str, lm: LeafMap, part: Part) -> np.ndarray:
    fn = os.path.join(root, _safe(lm.fragment), FRAGMENT_FILE)
    if not os.path.exists(fn):
        raise FileNotFoundError(f"universal checkpoint missing fragment {lm.fragment}")
    # memmap: each rank reads only ITS region (reference
    # ``universal_checkpoint.py:99`` load_hp_checkpoint_state)
    arr = np.load(fn, mmap_mode="r")
    if tuple(arr.shape) != tuple(lm.shape):
        raise ValueError(f"fragment {lm.fragment}: shape {arr.shape} != expected {lm.shape}")
    # a writable C-contiguous host copy of the region alone, in the
    # fragment's layout: one read when it is a contiguous run of the file
    index = lm.index(part.box())
    span = _span(arr.shape, index)
    if span is None:
        return np.require(arr[index], requirements=["C", "W"])
    shape = arr[index].shape
    return np.fromfile(fn, arr.dtype, span[1], offset=arr.offset + span[0] * arr.itemsize
                       ).reshape(shape)


def _copy_in(part: Part, arr: np.ndarray, transpose: bool, what: str) -> None:
    """Copy a fragment region into the part's tensor in place; a transposed
    region moves to the tensor's device first and is transposed there (one
    leaf of temporary device memory at most)."""
    dst = part.data
    src = torch.from_numpy(arr)
    if transpose:
        src = src.to(dst.device).t()
    if src.dtype != dst.dtype:
        raise ValueError(f"{what}: fragment dtype {src.dtype} != the engine's {dst.dtype}")
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: region {tuple(src.shape)} != the engine's {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def _load_fragments(root: str, engine) -> Optional[Dict[str, int]]:
    """Copy the param (and, when present, optim) fragments under ``root``
    into the engine's tensors in place; returns the saved optimizer state's
    integers by path (None without optim fragments)."""
    leaves = state_leaves(engine)
    shapes = {k.split("/", 1)[1]: p.shape for k, p in leaves.items() if k.startswith("params/")}
    fmap = fragment_map(shapes, getattr(engine.model, "config", None))
    optim_root = os.path.join(root, "optim")
    has_optim = os.path.isdir(optim_root)
    names = {g: _optim_names(g, ns, fmap) for g, ns in _engine_groups(engine).items()}
    for key, part in leaves.items():
        group, name = key.split("/", 1)
        lm = fmap[name]
        if group == "params":
            _copy_in(part, _read_region(os.path.join(root, "param"), lm, part), lm.transpose, key)
        elif has_optim:
            _copy_in(part, _read_region(optim_root, lm._replace(fragment=names[group][name]),
                                        part), lm.transpose, key)
    if not has_optim:
        return None
    out = {}
    for path in state_scalars(engine.state.opt_state):
        fn = os.path.join(optim_root, _safe(path), FRAGMENT_FILE)
        if not os.path.exists(fn):
            raise FileNotFoundError(f"universal checkpoint missing fragment {path}")
        out[path] = int(np.load(fn))
    return out


def derive_host_rng(seed: int, step: int, process_index: int,
                    process_count: int) -> torch.Generator:
    """This host's RNG stream for the CURRENT topology: a generator seeded
    by a fixed function (SHA-256) of (base seed, resume step, host count,
    host index), so a restart at any scale gets streams that are
    deterministic, distinct per host and independent of the topology the
    checkpoint was written on. The JAX package folds the same integers into
    a threefry key; threefry and Philox never agree, so the streams differ
    from JAX's."""
    h = hashlib.sha256(np.asarray([seed, step, process_count, process_index],
                                  np.int64).tobytes()).digest()
    return torch.Generator().manual_seed(int.from_bytes(h[:8], "little") >> 1)


# --------------------------------------------------------------------------- #
# fragment trees alone (offline conversion)
# --------------------------------------------------------------------------- #
def save_universal(leaves: Dict[str, Part], out_dir: str, *,
                   opt_scalars: Optional[Dict[str, int]] = None,
                   meta: Optional[Dict] = None, subdir: bool = True,
                   model_config: Any = None) -> str:
    """Write a state (``params/<leaf>`` and ``<state path>/<leaf>`` parts;
    ``opt_scalars`` the optimizer state's integers by path) as a universal
    checkpoint.
    Atomic: writes to a temp dir then renames; rank 0 owns the temp dir and
    the rename, every rank writes its own regions. A failure GCs the temp
    dir."""
    out_dir = os.path.normpath(out_dir)  # trailing '/' would nest tmp in final
    final = os.path.join(out_dir, UNIVERSAL_DIR) if subdir else out_dir
    if not subdir and os.path.exists(final) and os.listdir(final):
        # a user-supplied exact target is never rmtree'd
        raise ValueError(f"output folder {final} exists and is not empty; "
                         f"refusing to overwrite")
    tmp = final + ".tmp"
    rank0 = comm.get_rank() == 0
    if rank0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
    multihost_barrier(f"universal_stage:{os.path.basename(final)}")
    try:
        param, optim = fragment_trees(leaves, opt_scalars, model_config)
        index = {"param": FRAGMENT_WRITER.save(param, os.path.join(tmp, "param"))}
        if optim:
            index["optim"] = FRAGMENT_WRITER.save(optim, os.path.join(tmp, "optim"))
        if rank0:
            info = dict(meta or {})
            info["format"] = UNIVERSAL_FORMAT
            info["index"] = index
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(info, f, indent=2, default=str)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            _fsync_path(os.path.dirname(final))
        multihost_barrier(f"universal_published:{os.path.basename(final)}")
    except Exception:
        # stage-dir GC: an I/O error must not strand the .tmp dir
        if rank0:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    log_dist(f"wrote universal checkpoint {final} ({len(index['param'])} params)")
    return final


def _universal_root(universal_dir: str) -> str:
    """The fragments' root: ``universal_dir`` itself, or its ``universal``
    subdirectory when that is where the fragments are."""
    root = universal_dir
    if os.path.basename(root) != UNIVERSAL_DIR and \
            not os.path.isdir(os.path.join(root, "param")) and \
            os.path.isdir(os.path.join(root, UNIVERSAL_DIR)):
        root = os.path.join(root, UNIVERSAL_DIR)
    return root


def read_universal_params(universal_dir: str, model_config: Any) -> Dict[str, torch.Tensor]:
    """Every parameter of ``model_config``'s family, whole, in the port's
    names and layout, from the param fragments under ``universal_dir`` (the
    port's or the JAX engine's: one layout) — fp32 host tensors."""
    root = os.path.join(_universal_root(universal_dir), "param")
    shapes = {k: tuple(s) for k, (s, _) in _param_shapes(model_config).items()}
    out = {}
    for name, lm in fragment_map(shapes, model_config).items():
        arr = _read_region(root, lm, Part(None, shapes[name], None))
        t = torch.from_numpy(np.ascontiguousarray(arr.T if lm.transpose else arr))
        out[name] = t
    return out


def load_universal(universal_dir: str, engine) -> Dict:
    """Map the fp32 fragments under ``universal_dir`` onto the engine's
    CURRENT topology, in place; returns the fragments' ``meta.json``."""
    root = _universal_root(universal_dir)
    scalars = _load_fragments(root, engine)
    if scalars is not None:
        engine.state = engine.state._replace(
            opt_state=with_scalars(engine.state.opt_state, scalars))
    meta: Dict = {}
    mp = os.path.join(root, "meta.json")
    if os.path.exists(mp):
        with open(mp) as f:
            meta = json.load(f)
    return meta


# --------------------------------------------------------------------------- #
# engine-level elastic save/load
# --------------------------------------------------------------------------- #
def is_universal_tag(tag_dir: str) -> bool:
    """A tag dir written by :func:`save_universal_checkpoint` (fragment
    layout), as opposed to a regular engine checkpoint (``state/`` dir)."""
    return os.path.isdir(os.path.join(tag_dir, "param"))


def save_universal_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                              client_state: Optional[Dict] = None,
                              reason: Optional[str] = None) -> str:
    """Elastic (topology-free) engine checkpoint, two-phase-committed:
    stage fragments into ``<tag>.tmp.stage`` (fsync per fragment + dirs, GC
    on failure) → barrier → seal (``manifest.json`` over the full dir) →
    atomic publish → advance ``latest``. ``checkpoint.io_retries`` backoff
    wraps the whole write."""
    cfg = engine.config.checkpoint
    tag = tag or f"universal_step{engine.global_steps}"
    save_dir = os.path.abspath(save_dir)
    os.makedirs(save_dir, exist_ok=True)
    final = os.path.join(save_dir, tag)
    stage = os.path.join(save_dir, f"{tag}.tmp.stage")
    rank0 = comm.get_rank() == 0

    state = engine.state
    param_tree, optim_tree = fragment_trees(
        state_leaves(engine, writer_only=True), state_scalars(state.opt_state),
        getattr(engine.model, "config", None), _engine_groups(engine))
    mm = engine.mesh_mgr
    meta: Dict[str, Any] = {
        "format": UNIVERSAL_FORMAT,
        "global_steps": int(engine.global_steps),
        "micro_steps": int(engine.micro_steps),
        "global_tokens": int(engine.global_tokens),
        "skipped_steps": int(state.skipped_steps),
        "seed": int(engine.config.seed),
        "loss_scale": [float(getattr(state.loss_scale, f).item())
                       for f in state.loss_scale._fields],
        "lr_scheduler": engine.lr_scheduler.state_dict(),
        # a mid-GAS-window save records the phase; the staged grads are not
        # portable across topologies, so resume restarts the window
        "gas_phase": {"pending_micros": len(engine._staged)},
        "topology": {
            "mesh": dict(mm.sizes),
            "processes": int(comm.get_world_size()),
            "zero_stage": int(engine.config.zero_config.stage),
            "hpz": int(engine.config.zero_config.zero_hpz_partition_size),
            "optimizer_tier": "none",
        },
        "batch": {"global": int(engine.train_batch_size()),
                  "micro": int(engine.train_micro_batch_size_per_gpu()),
                  "gas": int(engine.gradient_accumulation_steps())},
        "client_state": client_state or {},
        "config": engine.config.raw,
        "reason": reason,
    }
    loader = getattr(engine, "training_dataloader", None)
    if loader is not None and hasattr(loader, "state_dict"):
        meta["dataloader"] = loader.state_dict()

    def _write():
        if rank0:
            if os.path.isdir(stage):
                shutil.rmtree(stage)  # stale stage from a crashed earlier save
            os.makedirs(stage, exist_ok=True)
        multihost_barrier(f"universal_stage:{tag}")
        try:
            index = {"param": FRAGMENT_WRITER.save(param_tree, os.path.join(stage, "param"))}
            if optim_tree:
                index["optim"] = FRAGMENT_WRITER.save(optim_tree,
                                                      os.path.join(stage, "optim"))
            if rank0:
                meta["index"] = index
                with open(os.path.join(stage, "meta.json"), "w") as f:
                    json.dump(meta, f, indent=2, default=str)
                    f.flush()
                    os.fsync(f.fileno())
                fsync_tree(stage)
                write_manifest(stage)
                publish_dir(stage, final)
                write_latest(save_dir, tag)
            # no rank returns before the tag is published
            multihost_barrier(f"universal_published:{tag}")
        except Exception:
            # stage-dir GC on failure (Exception only: a SimulatedCrash /
            # real process death leaves the stage, which is invisible to
            # loads and reclaimed by the next save of this tag)
            if rank0:
                shutil.rmtree(stage, ignore_errors=True)
            raise
        return final

    retries = int(getattr(cfg, "io_retries", 0) or 0)
    with_io_retries(
        _write, retries=retries,
        backoff_s=float(getattr(cfg, "io_backoff_s", 0.5)),
        what=f"universal checkpoint save '{tag}'",
        on_retry=lambda n, e: _reliability(engine, "checkpoint_io_retry"))
    _reliability(engine, "elastic/saves")
    log_dist(f"saved UNIVERSAL checkpoint {final} (step "
             f"{engine.global_steps}, reason={reason or 'scheduled'})")
    return final


def _newest_universal_tag(load_dir: str, exclude=()) -> Optional[str]:
    """Walk-back target among UNIVERSAL tags: newest tag dir that has the
    fragment layout and passes manifest verification."""
    excluded = set(exclude)
    for name in tag_candidates(load_dir):
        if name in excluded:
            continue
        full = os.path.join(load_dir, name)
        if not is_universal_tag(full):
            continue
        status, detail = verify_manifest(full)
        if status == "corrupt":
            logger.warning(f"walk-back: skipping corrupt universal "
                           f"checkpoint '{name}' ({detail})")
            continue
        return name
    return None


def load_universal_checkpoint(engine, load_dir: str,
                              tag: Optional[str] = None):
    """Restore an engine — at ANY topology — from a universal checkpoint tag.

    Verified load with walk-back: a corrupt (or non-universal) ``latest`` tag
    falls back to the newest verifiable universal tag instead of crashing.
    Returns ``(path, client_state)`` like ``engine.load_checkpoint``."""
    cfg = engine.config.checkpoint
    explicit = tag is not None
    try:
        tag = resolve_tag(load_dir, tag)
    except FileNotFoundError as e:
        logger.warning(str(e))
        return None, {}
    path = os.path.abspath(os.path.join(load_dir, tag))
    verify = bool(getattr(cfg, "verify_on_load", True))
    problem = None
    if not is_universal_tag(path):
        problem = "not a universal (fragment) checkpoint"
    elif verify:
        status, detail = verify_manifest(path)
        if status == "corrupt":
            problem = detail
    if problem is not None:
        logger.warning(f"universal checkpoint '{tag}' unusable ({problem}) "
                       f"— walking back to the newest verifiable universal "
                       f"tag")
        _reliability(engine, "checkpoint_rollback")
        alt = _newest_universal_tag(load_dir, exclude={tag})
        if alt is None:
            if explicit:
                raise RuntimeError(
                    f"universal checkpoint '{tag}' under {load_dir} is "
                    f"unusable ({problem}) and no verifiable universal "
                    f"fallback exists")
            logger.warning(f"no verifiable universal checkpoint under "
                           f"{load_dir} — starting fresh")
            return None, {}
        log_dist(f"universal checkpoint rollback: '{tag}' → '{alt}'")
        tag = alt
        path = os.path.abspath(os.path.join(load_dir, tag))

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)

    scalars = with_io_retries(
        lambda: _load_fragments(path, engine),
        retries=int(getattr(cfg, "io_retries", 0) or 0),
        backoff_s=float(getattr(cfg, "io_backoff_s", 0.5)),
        what=f"universal checkpoint load '{tag}'",
        on_retry=lambda n, e: _reliability(engine, "checkpoint_io_retry"))

    gstep = int(meta.get("global_steps", 0))
    st = engine.state
    ls = st.loss_scale
    ls_vals = meta.get("loss_scale")
    if ls_vals is not None and len(ls_vals) == len(ls._fields):
        ls = ls._replace(**{f: torch.tensor(v, dtype=getattr(ls, f).dtype,
                                            device=getattr(ls, f).device)
                            for f, v in zip(ls._fields, ls_vals)})
    opt = st.opt_state if scalars is None else with_scalars(st.opt_state, scalars)
    # the reference sets state.step to global_steps (JAX universal.py:642)
    engine.state = st._replace(step=gstep, opt_state=opt, loss_scale=ls,
                               skipped_steps=int(meta.get("skipped_steps", 0)))
    engine.global_steps = gstep
    engine.micro_steps = int(meta.get("micro_steps", 0))
    engine.global_tokens = int(meta.get("global_tokens", 0))
    if "lr_scheduler" in meta:
        engine.lr_scheduler.load_state_dict(meta["lr_scheduler"])
    # GAS phase: a partial accumulation window cannot be restored across
    # topologies — the window restarts (its micro grads recompute)
    pending = int(meta.get("gas_phase", {}).get("pending_micros", 0) or 0)
    if pending:
        logger.warning(f"universal checkpoint was taken mid-GAS-window "
                       f"({pending} staged micro(s)) — the window restarts "
                       f"on resume")
    engine.reset_accumulation()
    # per-host RNG stream, RE-DERIVED for the new topology
    engine.host_rng = derive_host_rng(
        int(meta.get("seed", engine.config.seed)), gstep,
        comm.get_rank(), comm.get_world_size())
    loader = getattr(engine, "training_dataloader", None)
    if loader is not None and hasattr(loader, "load_state_dict") and \
            meta.get("dataloader") is not None:
        loader.load_state_dict(meta["dataloader"])
    _reliability(engine, "elastic/resumes")
    _reliability(engine, "checkpoint_loaded")
    log_dist(f"loaded UNIVERSAL checkpoint {path} at step "
             f"{engine.global_steps}")
    return path, meta.get("client_state", {})


# --------------------------------------------------------------------------- #
# offline conversion
# --------------------------------------------------------------------------- #
def model_config_to_json(cfg: Any) -> Optional[Dict[str, Any]]:
    """A family config as JSON (``{"type": ..., "fields": ...}``), or None."""
    if cfg is None:
        return None
    return {"type": type(cfg).__name__, "fields": dataclasses.asdict(cfg)}


def model_config_from_json(doc: Optional[Dict[str, Any]]) -> Any:
    if not doc:
        return None
    from ...models import bert, bloom, clip, exaone4, falcon, gpt, gptneox, llama, mixtral

    types = {c.__name__: c for c in (llama.LlamaConfig, gpt.GPTConfig, bloom.BloomConfig,
                                     exaone4.Exaone4Config, mixtral.MixtralConfig,
                                     falcon.FalconConfig, gptneox.GPTNeoXConfig,
                                     bert.BertConfig, clip.CLIPConfig)}
    # CLIPConfig turns its towers' dicts back into CLIPTowerConfig
    return types[doc["type"]](**doc["fields"])


def _saved_scalars(header: Dict) -> Optional[Dict[str, int]]:
    if header.get("opt_scalars") is not None:
        return header["opt_scalars"]
    return None if header.get("opt_step") is None else {"step": int(header["opt_step"])}


def ds_to_universal(ckpt_dir: str, tag: Optional[str] = None,
                    out_dir: Optional[str] = None) -> str:
    """Offline converter (reference ``ds_to_universal.py`` CLI): a regular
    checkpoint → universal fragments, in the JAX layout when the tag
    records its model's config. Reads and writes one leaf at a time."""
    tag = resolve_tag(ckpt_dir, tag)
    saved = read_state_tree(os.path.join(ckpt_dir, tag))
    meta_path = os.path.join(ckpt_dir, tag, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = {k: v for k, v in json.load(f).items()
                    if k in ("global_steps", "micro_steps", "lr_scheduler")}
    leaves = {name: Part(lambda n=name: saved.full(n), tuple(saved.shape(name)), None, 0)
              for name in saved.names()}
    # an explicit out_dir is honored EXACTLY (reference ds_to_universal
    # contract: fragments land at --output_folder, not a subdir of it)
    return save_universal(
        leaves, out_dir or os.path.join(ckpt_dir, tag),
        opt_scalars=_saved_scalars(saved.header), meta=meta, subdir=out_dir is None,
        model_config=model_config_from_json(saved.header.get("model_config")))


def main(argv=None) -> int:
    """``python -m deepspeed_tpu_torch.runtime.checkpoint.universal``
    (reference ``deepspeed/checkpoint/ds_to_universal.py`` entry): a
    regular checkpoint → topology-free universal fragments."""
    import argparse

    p = argparse.ArgumentParser(prog="dstpu_to_universal")
    p.add_argument("--input_folder", required=True,
                   help="checkpoint dir written by engine.save_checkpoint")
    p.add_argument("--tag", default=None)
    p.add_argument("--output_folder", default=None,
                   help="default: <input>/<tag>/universal")
    args = p.parse_args(argv)
    out = ds_to_universal(args.input_folder, tag=args.tag,
                          out_dir=args.output_folder)
    print(f"universal checkpoint written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
