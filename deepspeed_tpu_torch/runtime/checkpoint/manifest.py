"""Crash-consistent checkpoint plumbing — a copy of
``deepspeed_tpu/runtime/checkpoint/manifest.py``, kept in the port so that it
imports nothing of the JAX package. Two things differ:
:func:`multihost_barrier` is a ``torch.distributed`` barrier on the
engine's process group (gloo on the CPU, NCCL on the card) and a no-op
without one; and :func:`write_manifest` / :func:`verify_manifest` hash a
tag's files on a pool of threads (``hashlib`` releases the GIL) rather than
one after another — the same manifest and the same verdicts, several times
faster on a tag of many files (SHA-256 runs at ~0.9 GB/s on one core of
the H100 host, ``PERF.md``).

The durable-save protocol (two-phase commit, see ``docs/reliability.md``):

1. **stage** — everything is written into ``<tag>.tmp.<pid>`` next to the
   final tag dir; a crash at any point here leaves ``latest`` untouched and
   the torn staging dir invisible to loads (staging names never match
   :func:`tag_candidates`).
2. **seal** — every staged file is fsync'd, then ``manifest.json`` (per-file
   SHA-256 + byte size) is written and fsync'd so load-time verification can
   tell a complete checkpoint from a torn one.
3. **publish** — the staging dir is atomically renamed onto the tag dir and
   only THEN is ``latest`` advanced (itself via write-tmp + fsync + rename).

This module holds the protocol's primitives — hashing/verification, fsync
helpers, atomic publish, tag scanning/walk-back, retention GC, and the
retry-with-backoff wrapper around checkpoint I/O. ``saver.py`` sequences
them; the fault-injection tests in ``tests/test_torch_checkpoint_faults.py``
attack every step.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

from ...utils.logging import log_dist, logger

MANIFEST_NAME = "manifest.json"
# name fragments that mark in-flight (staging) or displaced (pre-delete) dirs;
# such dirs are never load candidates and are swept opportunistically
_STAGING_MARKERS = (".tmp.", ".old.")


def is_staging_name(name: str) -> bool:
    return any(m in name for m in _STAGING_MARKERS)


def multihost_barrier(name: str, group=None) -> None:
    """Block until every rank of ``group`` (the default process group when
    None) reaches this point; a no-op without a process group or with one
    rank. The saver runs it between the state write and rank 0's
    seal/publish: every rank writes its shards into the same staging dir,
    and none of them may still be writing when rank 0 renames it onto the
    tag dir."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size(group) <= 1:
        return
    dist.barrier(group=group)


def _sha256(path: str, chunk: int = 1 << 22) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(chunk), b""):
            h.update(blk)
    return h.hexdigest()


def _sha256_many(paths: List[str]) -> List[Union[str, OSError]]:
    """Each file's SHA-256 (or the ``OSError`` reading it), hashed on up to
    one thread a core."""
    def one(path: str) -> Union[str, OSError]:
        try:
            return _sha256(path)
        except OSError as e:
            return e

    workers = min(len(paths), os.cpu_count() or 1)
    if workers <= 1:
        return [one(p) for p in paths]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(one, paths))


def _fsync_path(path: str) -> None:
    """Best-effort fsync of a file OR directory (directory fsync persists the
    dir entry itself; some filesystems refuse it — never fatal)."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def fsync_tree(root: str) -> None:
    """fsync every file and directory under ``root`` (phase-2 'seal': the
    manifest hashes are only meaningful if the hashed bytes are durable)."""
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in filenames:
            _fsync_path(os.path.join(dirpath, fn))
        _fsync_path(dirpath)


def write_manifest(tag_dir: str) -> Dict[str, object]:
    """Hash every file under ``tag_dir`` into ``manifest.json`` (write-tmp +
    fsync + atomic rename, so the manifest itself can't be torn)."""
    found: List[Tuple[str, str]] = []
    for dirpath, _dirnames, filenames in os.walk(tag_dir):
        for fn in filenames:
            if fn == MANIFEST_NAME or is_staging_name(fn):
                continue
            full = os.path.join(dirpath, fn)
            found.append((os.path.relpath(full, tag_dir).replace(os.sep, "/"), full))
    files: Dict[str, Dict[str, object]] = {}
    for (rel, full), digest in zip(found, _sha256_many([full for _, full in found])):
        if isinstance(digest, OSError):
            raise digest
        files[rel] = {"sha256": digest, "bytes": os.path.getsize(full)}
    doc = {"version": 1, "files": files}
    tmp = os.path.join(tag_dir, f"{MANIFEST_NAME}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(tag_dir, MANIFEST_NAME))
    _fsync_path(tag_dir)
    return doc


def verify_manifest(tag_dir: str) -> Tuple[str, str]:
    """Check ``tag_dir`` against its manifest → ``(status, detail)``.

    status: ``"verified"`` (every listed file exists, size + SHA-256 match),
    ``"legacy"`` (no manifest — a pre-atomic or ``atomic: false`` checkpoint;
    loadable but unverifiable), or ``"corrupt"``. Files NOT listed in the
    manifest (e.g. a ``universal/`` conversion added later) are ignored.
    """
    if not os.path.isdir(tag_dir):
        return "corrupt", "tag directory missing"
    mpath = os.path.join(tag_dir, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return "legacy", "no manifest (pre-atomic checkpoint)"
    try:
        with open(mpath) as f:
            files = json.load(f)["files"]
        items = list(files.items())
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        return "corrupt", f"unreadable manifest: {e}"
    # the first file that is missing or of the wrong size ends the walk;
    # the files before it are hashed together, and the first of them in
    # manifest order that mismatches is reported, as a file-by-file walk
    # would report it
    first_bad: Optional[Tuple[str, str]] = None
    sized: List[Tuple[str, str, object]] = []
    for rel, info in items:
        full = os.path.join(tag_dir, rel.replace("/", os.sep))
        if not os.path.exists(full):
            first_bad = ("corrupt", f"missing file {rel}")
            break
        try:
            if os.path.getsize(full) != int(info.get("bytes", -1)):
                first_bad = ("corrupt", f"size mismatch for {rel}")
                break
        except (OSError, ValueError, TypeError) as e:
            first_bad = ("corrupt", f"unreadable {rel}: {e}")
            break
        sized.append((rel, full, info.get("sha256")))
    digests = _sha256_many([full for _, full, _ in sized])
    for (rel, _, want), digest in zip(sized, digests):
        if isinstance(digest, OSError):
            return "corrupt", f"unreadable {rel}: {digest}"
        if digest != want:
            return "corrupt", f"sha256 mismatch for {rel}"
    if first_bad is not None:
        return first_bad
    return "verified", f"{len(items)} files verified"


def publish_dir(stage_dir: str, final_path: str) -> None:
    """Atomically move the sealed staging dir onto the tag dir. An existing
    tag dir (re-save of the same tag) is displaced to ``.old.<pid>`` first —
    never deleted before its replacement is in place — then reaped."""
    old = None
    if os.path.isdir(final_path):
        old = f"{final_path}.old.{os.getpid()}"
        if os.path.isdir(old):
            shutil.rmtree(old, ignore_errors=True)
        os.rename(final_path, old)
    os.rename(stage_dir, final_path)
    _fsync_path(os.path.dirname(final_path))
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def write_latest(save_dir: str, tag: str) -> None:
    """Advance the ``latest`` pointer durably (write-tmp + fsync + rename):
    a crash mid-update can't leave a torn/empty pointer file."""
    tmp = os.path.join(save_dir, f"latest.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(tag)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(save_dir, "latest"))
    _fsync_path(save_dir)


def tag_candidates(load_dir: str) -> List[str]:
    """Checkpoint-shaped dirs under ``load_dir``, newest first — ordered by
    ``meta.json`` ``global_steps`` when readable, directory mtime otherwise.
    Staging/displaced dirs and stray files never qualify."""
    scored: List[Tuple[int, float, str]] = []
    try:
        names = os.listdir(load_dir)
    except OSError:
        return []
    for name in names:
        full = os.path.join(load_dir, name)
        if not os.path.isdir(full) or is_staging_name(name):
            continue
        if not (os.path.isdir(os.path.join(full, "state"))
                or os.path.exists(os.path.join(full, "meta.json"))):
            continue
        steps = -1
        try:
            with open(os.path.join(full, "meta.json")) as f:
                steps = int(json.load(f).get("global_steps", -1))
        except (OSError, ValueError, TypeError):
            pass
        try:
            mtime = os.path.getmtime(full)
        except OSError:
            mtime = 0.0
        scored.append((steps, mtime, name))
    scored.sort(reverse=True)
    return [name for _steps, _mtime, name in scored]


def newest_verifiable_tag(load_dir: str, exclude: Iterable[str] = (),
                          verify: bool = True) -> Optional[str]:
    """Walk-back target: the newest tag under ``load_dir`` that passes
    manifest verification (legacy/no-manifest tags are accepted — they are
    loadable, just unverifiable)."""
    excluded = set(exclude)
    for name in tag_candidates(load_dir):
        if name in excluded:
            continue
        if verify:
            status, detail = verify_manifest(os.path.join(load_dir, name))
            if status == "corrupt":
                logger.warning(
                    f"walk-back: skipping corrupt checkpoint '{name}' "
                    f"({detail})")
                continue
        return name
    return None


def retention_sweep(save_dir: str, keep_last_n: int,
                    protect: Iterable[str] = ()) -> int:
    """``keep_last_n`` garbage collection: drop the oldest tag dirs beyond
    the newest N (0 = keep everything). ``protect`` tags (the one just
    written, the ``latest`` target) are never collected."""
    if keep_last_n <= 0:
        return 0
    tags = tag_candidates(save_dir)
    protected = set(protect)
    latest_path = os.path.join(save_dir, "latest")
    try:
        with open(latest_path) as f:
            protected.add(f.read().strip())
    except OSError:
        pass
    removed = 0
    for name in tags[keep_last_n:]:
        if name in protected:
            continue
        shutil.rmtree(os.path.join(save_dir, name), ignore_errors=True)
        removed += 1
    if removed:
        log_dist(f"checkpoint retention: removed {removed} old tag(s), "
                 f"keeping last {keep_last_n}")
    return removed


def with_io_retries(fn: Callable[[], object], retries: int = 0,
                    backoff_s: float = 0.5, what: str = "checkpoint I/O",
                    on_retry: Optional[Callable[[int, BaseException], None]]
                    = None):
    """Run ``fn``, retrying transient ``OSError`` up to ``retries`` times
    with exponential backoff + jitter (``backoff_s * 2**attempt`` plus up to
    one extra ``backoff_s``). Non-OSError failures — including the fault
    harness's SimulatedCrash — propagate immediately."""
    attempt = 0
    while True:
        try:
            return fn()
        except OSError as e:
            if attempt >= max(0, int(retries)):
                raise
            delay = float(backoff_s) * (2 ** attempt) + \
                random.uniform(0.0, float(backoff_s))
            attempt += 1
            logger.warning(f"{what} failed ({e}); retry {attempt}/{retries} "
                           f"in {delay:.2f}s")
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(delay)
