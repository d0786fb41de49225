"""Checkpoint engines: sync, fast (one buffered file a rank) and decoupled
(async background) writers — counterpart of
``deepspeed_tpu/runtime/checkpoint/engines.py`` (``CheckpointEngine`` :34,
``FastCheckpointEngine`` :104, ``DecoupledCheckpointEngine`` :167,
``get_checkpoint_engine`` :222), with the same names and aliases.

The JAX package's default engine is orbax and its fast engine pickles a JAX
treedef; neither exists here, so the port's regular format is its own:

- the unit of work is a :class:`StateTree`: named leaves, each this rank's
  :class:`Part` of a whole leaf (the slice ``[start, start + n)`` of the
  leaf's ``shape`` along ``dim``, or the whole leaf when ``dim`` is None),
  in the port's names and ``[out, in]`` layout, plus a JSON ``header`` of
  scalars;
- every rank writes only its own parts (a replicated leaf is written by
  rank 0 alone), so a tag holds each element once;
- headers are JSON and tensors raw bytes or ``.npy``; nothing is pickled.
  The sync engine (``default``) writes one ``.npy`` a part and
  ``index.r<rank>.json``; the fast engine one file a rank,
  ``state.r<rank>.bin``: an 8-byte little-endian length, the JSON index,
  then each part's bytes at its recorded offset;
- loading is independent of the writer's topology: :func:`read_state`
  reads any rank's index of either engine, and :meth:`SavedState.fill`
  copies into each of this rank's tensors, in place, the overlap of its
  own part with the saved parts, read through a memmap. Host memory stays
  O(largest part); a leaf whose whole shape disagrees raises.

The decoupled engine copies every part to host memory (pinned for CUDA
tensors, one leaf at a time) before :meth:`save` returns, since the next
``train_batch`` updates the live tensors in place; only the file write runs
on the writer thread, and a failed write is raised at :meth:`commit` /
:meth:`wait_all`.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...utils.logging import logger

STATE_FORMAT = "dstt-state1"


class Part(NamedTuple):
    """One rank's part of a leaf: ``data`` is the slice starting at
    ``start`` of the whole ``shape`` along ``dim`` (the whole leaf when
    ``dim`` is None)."""

    data: Any               # torch.Tensor (any device), numpy array, or a
                            # callable returning one (read when written)
    shape: Tuple[int, ...]  # the whole leaf's shape
    dim: Optional[int]
    start: int = 0

    def box(self) -> List[Tuple[int, int]]:
        """The part's region of the whole leaf, ``(lo, hi)`` per dim."""
        out = [(0, n) for n in self.shape]
        if self.dim is not None:
            out[self.dim] = (self.start, self.start + int(self.data.shape[self.dim]))
        return out


class StateTree(NamedTuple):
    """What one rank saves: its parts by leaf name and a JSON header."""

    leaves: Dict[str, Part]
    header: Dict[str, Any]
    rank: int = 0


def _safe(name: str) -> str:
    return "".join(c if c.isalnum() or c in "_.-" else "_" for c in name)


def _host_array(data: Any) -> np.ndarray:
    """A C-contiguous numpy array of a part's data (tensors move to the
    host one at a time; a bf16 tensor has no numpy dtype and is refused; a
    callable is a leaf read only when it is written)."""
    if callable(data):
        data = data()
    if torch.is_tensor(data):
        t = data.detach()
        if t.dtype == torch.bfloat16:
            raise TypeError("checkpoint leaves must have a numpy dtype (bf16 is not one); "
                            "the engine's masters and moments are fp32")
        return np.require(t.cpu().numpy(), requirements="C")
    # np.require keeps a 0-d array 0-d (np.ascontiguousarray would not)
    return np.require(np.asarray(data), requirements="C")


def _entry(part: Part, dtype: np.dtype) -> Dict[str, Any]:
    """A part's index entry: the whole leaf's shape, the dtype, where the
    part lies in the leaf."""
    return {"shape": [int(n) for n in part.shape], "dtype": dtype.str, "dim": part.dim,
            "start": int(part.start), "part_shape": [int(n) for n in part.data.shape]}


def _write_json(path: str, doc: Dict[str, Any]) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())


class CheckpointEngine:
    """save(tree, path) / load(path) / commit(tag) — see module docstring."""

    name = "base"

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def save(self, tree: StateTree, path: str,
             on_durable: Optional[Callable[[], None]] = None) -> None:
        """Write this rank's parts of ``tree`` under ``path``.
        ``on_durable`` is invoked exactly once after the bytes are durably
        on disk — synchronous engines call it before returning; the async
        engine calls it from the writer thread. If the write fails,
        ``on_durable`` is never called."""
        raise NotImplementedError

    def load(self, path: str, template: Optional[StateTree] = None) -> "SavedState":
        """The state saved under ``path`` (by any engine, at any topology).
        With a ``template``, each of its parts' tensors is filled in place
        with its region of the saved leaf."""
        saved = read_state(path)
        if template is not None:
            saved.fill(template.leaves)
        return saved

    def commit(self, tag: str) -> bool:
        """Wait until the tagged save is durable (async engines); re-raises
        any background-writer failure for that tag."""
        return True

    def wait_all(self) -> None:
        """Drain every pending write (no-op for synchronous engines)."""
        return None


class SyncCheckpointEngine(CheckpointEngine):
    """One ``.npy`` a part and a JSON index a rank, written before
    :meth:`save` returns — the reference's TorchCheckpointEngine
    counterpart; every rank writes its own parts in parallel."""

    name = "default"

    def save(self, tree: StateTree, path: str,
             on_durable: Optional[Callable[[], None]] = None) -> None:
        os.makedirs(path, exist_ok=True)
        index: Dict[str, Any] = {}
        for name, part in tree.leaves.items():
            arr = _host_array(part.data)
            fn = f"{_safe(name)}.r{tree.rank}.npy"
            with open(os.path.join(path, fn), "wb") as f:
                np.save(f, arr)
            index[name] = dict(_entry(part, arr.dtype), file=fn)
        _write_json(os.path.join(path, f"index.r{tree.rank}.json"),
                    {"format": STATE_FORMAT, "header": tree.header, "leaves": index})
        if on_durable is not None:
            on_durable()


class FastCheckpointEngine(CheckpointEngine):
    """One file a rank through a large write buffer, fsync'd, then an
    atomic rename (reference ``deepspeed/io/fast_file_writer.py``
    FastFileWriter): an 8-byte length, the JSON index, then each part's raw
    bytes at its recorded offset."""

    name = "fast"

    def __init__(self, buffer_mb: int = 64):
        self.buffer_bytes = buffer_mb << 20

    def save(self, tree: StateTree, path: str,
             on_durable: Optional[Callable[[], None]] = None) -> None:
        os.makedirs(path, exist_ok=True)
        # shapes and offsets first (the index precedes the bytes)
        entries: Dict[str, Any] = {}
        offset = 0
        for name, part in tree.leaves.items():
            dtype = _numpy_dtype(part.data)
            nbytes = int(np.prod(part.data.shape, dtype=np.int64)) * dtype.itemsize
            entries[name] = dict(_entry(part, dtype), offset=offset, nbytes=nbytes)
            offset += nbytes
        head = json.dumps({"format": STATE_FORMAT, "header": tree.header,
                           "leaves": entries}, sort_keys=True).encode()
        final = os.path.join(path, f"state.r{tree.rank}.bin")
        tmp = os.path.join(path, f".tmp_state.r{tree.rank}.{os.getpid()}.bin")
        with open(tmp, "wb", buffering=self.buffer_bytes) as f:
            f.write(len(head).to_bytes(8, "little"))
            f.write(head)
            for part in tree.leaves.values():
                f.write(memoryview(_host_array(part.data)).cast("B"))
            # durable before the rename publishes it
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        if on_durable is not None:
            on_durable()


def _numpy_dtype(data: Any) -> np.dtype:
    if torch.is_tensor(data):
        if data.dtype == torch.bfloat16:
            raise TypeError("checkpoint leaves must have a numpy dtype (bf16 is not one)")
        return np.dtype(torch.empty((), dtype=data.dtype).numpy().dtype)
    return np.asarray(data).dtype


def _tree_to_host(tree: StateTree) -> StateTree:
    """Device → host snapshot, one leaf at a time: a CUDA part is copied
    into a pinned buffer (all copies queued, then one synchronize), a host
    tensor or array is cloned. The snapshot no longer aliases the live
    state, which the next step updates in place."""
    leaves: Dict[str, Part] = {}
    cuda = False
    for name, part in tree.leaves.items():
        d = part.data
        if torch.is_tensor(d) and d.is_cuda:
            buf = torch.empty(d.shape, dtype=d.dtype, pin_memory=True)
            buf.copy_(d.detach(), non_blocking=True)
            cuda = True
        elif torch.is_tensor(d):
            buf = d.detach().clone()
        else:
            buf = np.array(d, copy=True)
        leaves[name] = part._replace(data=buf)
    if cuda:
        torch.cuda.synchronize()
    return StateTree(leaves, json.loads(json.dumps(tree.header)), tree.rank)


class DecoupledCheckpointEngine(CheckpointEngine):
    """Async engine: snapshot to host → background writer thread; ``commit``
    joins. Reference ``decoupled_checkpoint_engine.py`` (background process
    + commit at the next boundary, ``runtime/engine.py:2797``)."""

    name = "async"

    def __init__(self, inner: Optional[CheckpointEngine] = None):
        self.inner = inner or FastCheckpointEngine()
        self._pending: Dict[str, threading.Thread] = {}
        self._errors: Dict[str, BaseException] = {}

    def save(self, tree: StateTree, path: str,
             on_durable: Optional[Callable[[], None]] = None) -> None:
        host = _tree_to_host(tree)  # blocking D2H; the write is async

        def _write():
            try:
                self.inner.save(host, path)
                if on_durable is not None:
                    # two-phase commit phase 2 (manifest/publish/latest)
                    # runs HERE, in the writer thread; a write failure above
                    # means the checkpoint is never published
                    on_durable()
            except BaseException as e:  # surfaced at commit()
                self._errors[path] = e
                logger.error(f"async checkpoint write failed: {e}")

        t = threading.Thread(target=_write, name=f"ckpt-writer:{path}", daemon=True)
        self._pending[path] = t
        t.start()

    def load(self, path: str, template: Optional[StateTree] = None) -> "SavedState":
        self.commit(path)
        return self.inner.load(path, template)

    def commit(self, tag: str) -> bool:
        """Finalize saves whose path IS ``tag`` or has ``tag`` (or
        ``<tag>.tmp.stage``, the saver's staging name for it) as an exact
        path component (a substring match would conflate e.g. 'global_step1'
        with 'global_step10')."""
        for path, t in list(self._pending.items()):
            parts = os.path.normpath(path).split(os.sep)
            if os.path.normpath(tag) == os.path.normpath(path) or tag in parts \
                    or f"{tag}.tmp.stage" in parts:
                t.join()
                del self._pending[path]
                if path in self._errors:
                    raise self._errors.pop(path)
        return True

    def wait_all(self) -> None:
        for path in list(self._pending):
            self.commit(path)


def get_checkpoint_engine(name: str = "default", **kw) -> CheckpointEngine:
    """Factory (reference ``runtime/engine.py:_configure_checkpointing :1287``
    + ``model_checkpointing/writer_factory.py``)."""
    if name in ("default", "torch", "orbax", "nebula", "datastates"):
        # name parity: orbax, nebula and datastates are external services of
        # the other packages; the sync engine is the durable stand-in
        return SyncCheckpointEngine()
    if name == "fast":
        return FastCheckpointEngine(buffer_mb=kw.get("writer_buffer_mb", 64))
    if name in ("async", "decoupled"):
        return DecoupledCheckpointEngine()
    raise ValueError(f"unknown checkpoint engine '{name}'")


# --------------------------------------------------------------------------- #
# reading, at any topology
# --------------------------------------------------------------------------- #
class _SavedPart(NamedTuple):
    file: str
    offset: Optional[int]      # byte offset in a fast-engine file; None: .npy
    dtype: np.dtype
    part_shape: Tuple[int, ...]
    shape: Tuple[int, ...]
    dim: Optional[int]
    start: int

    def box(self) -> List[Tuple[int, int]]:
        out = [(0, n) for n in self.shape]
        if self.dim is not None:
            out[self.dim] = (self.start, self.start + self.part_shape[self.dim])
        return out

    def read_into(self, out: np.ndarray) -> None:
        """The whole part into ``out`` (C-contiguous, of the part's shape
        and dtype) by plain reads."""
        offset = np.load(self.file, mmap_mode="r").offset if self.offset is None else self.offset
        view = memoryview(out).cast("B")
        with open(self.file, "rb", buffering=0) as f:
            f.seek(offset)
            while view:
                n = f.readinto(view)
                if not n:
                    raise EOFError(f"{self.file}: ends inside a checkpoint leaf")
                view = view[n:]

    def array(self) -> np.ndarray:
        if self.offset is None:
            return np.load(self.file, mmap_mode="r")
        if not self.part_shape or 0 in self.part_shape:
            n = int(np.prod(self.part_shape, dtype=np.int64))
            with open(self.file, "rb") as f:
                f.seek(self.offset)
                return np.frombuffer(f.read(n * self.dtype.itemsize),
                                     self.dtype).reshape(self.part_shape)
        return np.memmap(self.file, self.dtype, "r", self.offset, self.part_shape)


class SavedState:
    """The parts every rank saved under one ``state`` dir, by leaf name,
    and rank 0's header."""

    def __init__(self, header: Dict[str, Any], parts: Dict[str, List[_SavedPart]]):
        self.header = header
        self.parts = parts

    def names(self) -> List[str]:
        return sorted(self.parts)

    def shape(self, name: str) -> Tuple[int, ...]:
        return self.parts[name][0].shape

    def read(self, name: str, box: Iterable[Tuple[int, int]]) -> np.ndarray:
        """The region ``box`` ((lo, hi) per dim) of leaf ``name``, gathered
        from the saved parts that overlap it; raises if they do not cover
        it."""
        if name not in self.parts:
            raise KeyError(f"checkpoint has no leaf '{name}'")
        box = [(int(lo), int(hi)) for lo, hi in box]
        first = self.parts[name][0]
        out = np.empty([hi - lo for lo, hi in box], first.dtype)
        if not out.size:
            return out
        covered = 0
        for p in self.parts[name]:
            inter = [(max(a, c), min(b, d)) for (a, b), (c, d) in zip(box, p.box())]
            if any(lo >= hi for lo, hi in inter):
                continue
            if inter == box == p.box() and out.ndim:
                p.read_into(out)           # the part is the region: one read
                covered += out.size
                continue
            src = tuple(slice(lo - c, hi - c) for (lo, hi), (c, _) in zip(inter, p.box()))
            dst = tuple(slice(lo - c, hi - c) for (lo, hi), (c, _) in zip(inter, box))
            out[dst] = p.array()[src]
            covered += int(np.prod([hi - lo for lo, hi in inter], dtype=np.int64))
        if covered != out.size:
            raise ValueError(f"checkpoint leaf '{name}': saved parts cover {covered} of "
                             f"the {out.size} elements asked for")
        return out

    def full(self, name: str) -> np.ndarray:
        return self.read(name, [(0, n) for n in self.shape(name)])

    def fill(self, leaves: Dict[str, Part]) -> None:
        """Copy into each part's tensor, in place, its region of the saved
        leaf of the same name (one leaf on the host at a time). Raises when
        the names, a whole shape or a dtype disagree."""
        missing = sorted(set(leaves) - set(self.parts))
        extra = sorted(set(self.parts) - set(leaves))
        if missing or extra:
            raise ValueError(f"checkpoint leaves do not match the engine's: missing "
                             f"{missing[:8]}, unexpected {extra[:8]}")
        for name, part in leaves.items():
            if tuple(self.shape(name)) != tuple(part.shape):
                raise ValueError(f"checkpoint leaf '{name}': shape {self.shape(name)} != "
                                 f"the engine's {tuple(part.shape)}")
            arr = self.read(name, part.box())
            dst = part.data
            if torch.is_tensor(dst):
                src = torch.from_numpy(arr)
                if src.dtype != dst.dtype:
                    raise ValueError(f"checkpoint leaf '{name}': dtype {src.dtype} != "
                                     f"the engine's {dst.dtype}")
                with torch.no_grad():
                    dst.copy_(src)
            else:
                dst[...] = arr


def read_state(path: str) -> SavedState:
    """Every rank's index under ``path``, of either engine's format."""
    header: Dict[str, Any] = {}
    parts: Dict[str, List[_SavedPart]] = {}
    found = False
    for fn in sorted(os.listdir(path)):
        full = os.path.join(path, fn)
        if fn.startswith("index.r") and fn.endswith(".json"):
            with open(full) as f:
                doc = json.load(f)
            base = None
        elif fn.startswith("state.r") and fn.endswith(".bin"):
            with open(full, "rb") as f:
                n = int.from_bytes(f.read(8), "little")
                doc = json.loads(f.read(n).decode())
            base = 8 + n
        else:
            continue
        if doc.get("format") != STATE_FORMAT:
            raise ValueError(f"{full}: not a {STATE_FORMAT} index")
        found = True
        if doc.get("header"):
            header = doc["header"]
        for name, e in doc["leaves"].items():
            parts.setdefault(name, []).append(_SavedPart(
                file=os.path.join(path, e["file"]) if base is None else full,
                offset=None if base is None else base + int(e["offset"]),
                dtype=np.dtype(e["dtype"]), part_shape=tuple(e["part_shape"]),
                shape=tuple(e["shape"]), dim=e["dim"], start=int(e["start"])))
    if not found:
        raise FileNotFoundError(f"no checkpoint state under {path}")
    return SavedState(header, parts)
