"""Checkpoint save/load — counterpart of
``deepspeed_tpu/runtime/checkpoint/saver.py`` (``resolve_tag`` :82,
``read_state_tree`` :106, ``save_checkpoint`` :125, ``load_checkpoint``
:259), with the same protocol.

Format: a tag directory with the engine's whole ``TrainState`` — the fp32
masters, the optimizer's state (every tensor by its state path, ``mu/<leaf>``,
``fb_state.nu/<leaf>``, ``0.mu/<leaf>``; its steps in the header), the
seven ``LossScaleState``
leaves, ``step`` and ``skipped_steps`` — written by the configured
:class:`~.engines.CheckpointEngine` under ``state/`` (each rank its own
parts, in the port's names and ``[out, in]`` layout; see ``engines.py``),
plus ``meta.json`` (the JAX package's keys), a per-file SHA-256
``manifest.json`` and a ``latest`` tag file. A tag written at any (world
size, ZeRO stage) loads at any other: each rank reads the overlap of its own
shards with the saved parts. Only the port reads this format; the universal
fragments (``universal.py``) are what both packages read.

Crash consistency (``checkpoint.atomic``, default on): saves stage into
``<tag>.tmp.stage`` — one name for every rank, which all write into — then
fsync, manifest, and an atomic rename publish the tag, and only afterwards
does ``latest`` advance; a crash or I/O error at any point leaves the
previous checkpoint loadable (the primitives live in ``manifest.py``). Over
a process group a barrier separates the state write from rank 0's
seal/publish. ``latest`` only moves forward across concurrent async
finalizes, and finalization takes a lock per save dir. Loads verify the
manifest (``checkpoint.verify_on_load``) and walk back to the newest
verifiable tag instead of crashing on a corrupt or missing one; a load that
finds no tag returns ``(None, {})``; a corrupt tag named explicitly with no
fallback raises ``RuntimeError``.

A load copies into the engine's tensors in place, one leaf at a time: the
masters stay ``requires_grad`` leaves, contiguous, on their device, and the
peak device memory of a load is its level before plus one leaf.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import torch

from ... import __version__
from ...comm import comm
from ...ops.optimizers import state_scalars, state_tensors, with_scalars
from ...telemetry.trace import NULL_TRACER
from ...utils.logging import log_dist, logger
from .engines import (CheckpointEngine, Part, SavedState, StateTree,
                      get_checkpoint_engine, read_state)
from .manifest import (multihost_barrier, newest_verifiable_tag, publish_dir,
                       retention_sweep, fsync_tree, verify_manifest,
                       with_io_retries, write_latest, write_manifest)

# Finalization (publish + latest + retention) is serialized per save dir:
# with the async engine several saves can be in flight at once and their
# writer threads would otherwise race on `latest` and on retention rmtrees.
# `_LATEST_STEPS` keeps `latest` monotonic — an OLDER save finalizing after
# a newer one must not move the pointer backwards.
_FINALIZE_MUTEX = threading.Lock()
_FINALIZE_LOCKS: Dict[str, threading.Lock] = {}
_LATEST_STEPS: Dict[str, int] = {}


def _finalize_lock(save_dir: str) -> threading.Lock:
    with _FINALIZE_MUTEX:
        lock = _FINALIZE_LOCKS.get(save_dir)
        if lock is None:
            lock = _FINALIZE_LOCKS[save_dir] = threading.Lock()
        return lock


def _reliability(engine, name: str, value: float = 1.0,
                 step: Optional[int] = None) -> None:
    """Count one ``Reliability/<name>`` event in the engine's
    ``reliability_counts`` (the port has no telemetry hub yet; absent on a
    bare engine — then this is a no-op)."""
    counts = getattr(engine, "reliability_counts", None)
    if counts is not None:
        key = f"Reliability/{name}"
        counts[key] = counts.get(key, 0) + 1


def _tracer(engine):
    """The engine's span tracer — NULL_TRACER on bare/test engines."""
    tr = getattr(getattr(engine, "telemetry", None), "tracer", None)
    return tr if tr is not None else NULL_TRACER


def resolve_tag(load_dir: str, tag: Optional[str],
                scan_fallback: bool = True) -> str:
    if tag is not None:
        return tag
    latest = os.path.join(load_dir, "latest")
    if not os.path.exists(latest):
        raise FileNotFoundError(f"no 'latest' file under {load_dir}")
    with open(latest) as f:
        tag = f.read().strip()
    if scan_fallback and not os.path.isdir(os.path.join(load_dir, tag)):
        # a deleted/renamed tag must not brick resume: fall back to the
        # newest checkpoint-shaped dir actually present (verification of its
        # CONTENTS happens in load_checkpoint)
        logger.warning(f"'latest' under {load_dir} names missing tag "
                       f"'{tag}' — scanning for existing checkpoints")
        alt = newest_verifiable_tag(load_dir, exclude={tag}, verify=False)
        if alt is None:
            raise FileNotFoundError(
                f"'latest' names '{tag}' but no checkpoint directories "
                f"exist under {load_dir}")
        return alt
    return tag


def read_state_tree(tag_dir: str) -> SavedState:
    """The saved state of a tag dir, whichever engine wrote it."""
    return read_state(os.path.join(tag_dir, "state"))


def _engine_for(engine) -> CheckpointEngine:
    ce = getattr(engine, "checkpoint_engine", None)
    if ce is None:
        cfg = engine.config.checkpoint
        ce = get_checkpoint_engine(cfg.engine,
                                   writer_buffer_mb=cfg.writer_buffer_mb)
        engine.checkpoint_engine = ce
    return ce


def _leaf_part(engine, name: str, t: torch.Tensor) -> Part:
    """This rank's part of master (or moment) leaf ``name``."""
    dim, n, index = engine.part_of(name)
    if dim is None:
        return Part(t, tuple(t.shape), None, 0)
    shape = list(t.shape)
    shape[dim] *= n
    return Part(t, tuple(shape), dim, index * t.shape[dim])


def state_leaves(engine, writer_only: bool = False) -> Dict[str, Part]:
    """The masters and every tensor of the optimizer state as this rank's
    parts, named ``params/<leaf>`` and ``<state path>/<leaf>`` with the JAX
    state tree's dotted paths (AdamW's ``mu`` and ``nu``, Muon's ``mu`` and
    ``fb_state.mu``, a grouped optimizer's ``0.mu``; ``ops/optimizers.py``
    ``state_tensors``). ``writer_only`` leaves out the replicated leaves on
    ranks other than 0 (each element is written once)."""
    rank0 = comm.get_rank() == 0
    out: Dict[str, Part] = {}
    groups = [("params", engine.state.params)] + list(state_tensors(engine.state.opt_state).items())
    for group, tensors in groups:
        for name, t in tensors.items():
            part = _leaf_part(engine, name, t)
            if writer_only and part.dim is None and not rank0:
                continue
            out[f"{group}/{name}"] = part
    return out


def state_header(engine) -> Dict[str, Any]:
    """The train state's scalars, as JSON: the loss scaler's fields by
    name with their values, the optimizer state's integers by path
    (``opt_scalars``; ``opt_step`` its top-level step), and the model's
    family config."""
    from .universal import model_config_to_json

    st = engine.state
    scalars = state_scalars(st.opt_state)
    return {"step": int(st.step), "skipped_steps": int(st.skipped_steps),
            "opt_step": scalars.get("step"), "opt_scalars": scalars,
            "loss_scale": {f: getattr(st.loss_scale, f).item()
                           for f in st.loss_scale._fields},
            # lets ds_to_universal write the JAX layout offline
            "model_config": model_config_to_json(getattr(engine.model, "config", None))}


def restore_header(engine, header: Dict[str, Any]) -> None:
    """Set the engine's step, skip count, optimizer steps and loss scaler
    from a saved header."""
    st = engine.state
    ls = st.loss_scale
    saved = header.get("loss_scale", {})
    new_ls = ls._replace(**{f: torch.tensor(saved[f], dtype=getattr(ls, f).dtype,
                                            device=getattr(ls, f).device)
                            for f in ls._fields if f in saved})
    scalars = header.get("opt_scalars") or {"step": int(header.get("opt_step", 0))}
    engine.state = st._replace(
        step=int(header.get("step", 0)),
        skipped_steps=int(header.get("skipped_steps", 0)),
        loss_scale=new_ls, opt_state=with_scalars(st.opt_state, scalars))


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[Dict[str, Any]] = None) -> str:
    ce = _engine_for(engine)
    cfg = engine.config.checkpoint
    tag = tag or f"global_step{engine.global_steps}"
    save_dir = os.path.abspath(save_dir)
    final_path = os.path.join(save_dir, tag)
    atomic = bool(getattr(cfg, "atomic", True))
    # one staging name for every rank: each writes its parts into it
    stage = os.path.join(save_dir, f"{tag}.tmp.stage") if atomic \
        else final_path
    rank0 = comm.get_rank() == 0
    multihost = comm.get_world_size() > 1
    if atomic and rank0 and os.path.isdir(stage):
        shutil.rmtree(stage)  # stale staging left by a crashed earlier save
    if multihost:
        # the rmtree above must land before any peer starts writing
        multihost_barrier(f"ckpt_stage:{tag}")
    os.makedirs(stage, exist_ok=True)

    tree = StateTree(state_leaves(engine, writer_only=True), state_header(engine),
                     comm.get_rank())

    meta = {
        "global_steps": engine.global_steps,
        "micro_steps": engine.micro_steps,
        "lr_scheduler": engine.lr_scheduler.state_dict(),
        "client_state": client_state or {},
        "config": engine.config.raw,
        "checkpoint_engine": ce.name,
        "framework_version": __version__,
    }
    # meta lands in the STAGING dir before the state write so the async
    # engine's deferred finalize sees a complete dir to seal + publish
    if rank0:
        with open(os.path.join(stage, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)

    keep_last_n = int(getattr(cfg, "keep_last_n", 0) or 0)
    retries = int(getattr(cfg, "io_retries", 0) or 0)
    backoff_s = float(getattr(cfg, "io_backoff_s", 0.5))
    step_at_save = int(engine.global_steps)

    done = {"synced": False, "durable": False, "published": False}

    def _finalize():
        # two-phase commit, phase 2: runs only once the state bytes are
        # durable (sync engines: inline; async: in the writer thread). Until
        # the rename + latest update below, a crash leaves the previous
        # checkpoint untouched and this save invisible.
        if multihost and not done["synced"]:
            # every rank must be done writing its parts before rank 0 seals
            # + renames the staging dir (first attempt only — a retry must
            # not wait for peers that already left the barrier)
            multihost_barrier(f"ckpt_seal:{tag}")
            done["synced"] = True
        done["durable"] = True
        if not rank0:
            return
        span = _tracer(engine).begin("checkpoint/publish", cat="checkpoint",
                                     tag=tag, atomic=atomic)
        try:
            with _finalize_lock(save_dir):
                if atomic and not done["published"]:
                    fsync_tree(stage)
                    write_manifest(stage)
                    publish_dir(stage, final_path)
                done["published"] = True
                prev = _LATEST_STEPS.get(save_dir)
                if prev is None or step_at_save >= prev:
                    write_latest(save_dir, tag)
                    _LATEST_STEPS[save_dir] = step_at_save
                else:
                    logger.warning(
                        f"checkpoint '{tag}' (step {step_at_save}) finalized "
                        f"after a newer save (step {prev}) — leaving 'latest' "
                        f"on the newer tag")
                removed = retention_sweep(save_dir, keep_last_n,
                                          protect=(tag,))
        finally:
            span.end()
        for _ in range(removed):
            _reliability(engine, "checkpoint_gc", step=step_at_save)
        _reliability(engine, "checkpoint_saved", step=step_at_save)
        log_dist(f"saved checkpoint {final_path} (engine={ce.name}, "
                 f"atomic={atomic})")

    state_path = os.path.join(stage, "state")

    def _write():
        if done["durable"]:
            # the state bytes landed on an earlier attempt and only the
            # publish/latest/GC tail failed — re-run just that (a second
            # ce.save would re-stage over the already-published tag)
            _finalize()
            return
        with _tracer(engine).span("checkpoint/save", cat="checkpoint",
                                  tag=tag, engine=ce.name,
                                  step=step_at_save):
            ce.save(tree, state_path, on_durable=_finalize)
        if retries or multihost:
            # retries: the policy needs to OBSERVE failures; multihost: the
            # seal barrier in the writer thread must not interleave with
            # training-step collectives on the main thread — either way,
            # confirm this save before returning
            ce.commit(state_path)

    with_io_retries(
        _write, retries=retries, backoff_s=backoff_s,
        what=f"checkpoint save '{tag}'",
        on_retry=lambda n, e: _reliability(engine, "checkpoint_io_retry",
                                           step=step_at_save))
    return final_path


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_universal: Optional[bool] = None, **kw):
    ce = _engine_for(engine)
    cfg = engine.config.checkpoint
    # in-flight async saves must land before a tag is chosen — otherwise
    # 'latest' may still be mid-advance; a failed one raises here
    ce.wait_all()
    # re-arm the monotonic-`latest` guard: after a restore/rollback, saves
    # on the restored (earlier-step) timeline must be able to advance it
    _LATEST_STEPS.pop(os.path.abspath(load_dir), None)
    explicit_tag = tag is not None
    try:
        tag = resolve_tag(load_dir, tag)
    except FileNotFoundError as e:
        logger.warning(str(e))
        return None, {}
    path = os.path.abspath(os.path.join(load_dir, tag))

    verify = bool(getattr(cfg, "verify_on_load", True))
    if verify:
        status, detail = verify_manifest(path)
        if status == "corrupt":
            logger.warning(f"checkpoint '{tag}' failed verification "
                           f"({detail}) — walking back to the newest "
                           f"verifiable tag")
            _reliability(engine, "checkpoint_rollback")
            alt = newest_verifiable_tag(load_dir, exclude={tag}, verify=True)
            if alt is None:
                if explicit_tag:
                    raise RuntimeError(
                        f"checkpoint '{tag}' under {load_dir} is corrupt "
                        f"({detail}) and no verifiable fallback exists")
                logger.warning(f"no verifiable checkpoint under {load_dir} "
                               f"— starting fresh")
                return None, {}
            log_dist(f"checkpoint rollback: '{tag}' → '{alt}'")
            tag = alt
            path = os.path.abspath(os.path.join(load_dir, tag))

    from .universal import UNIVERSAL_DIR, is_universal_tag

    if is_universal_tag(path):
        # the resolved tag is a fragment-layout checkpoint: the universal
        # loader places it onto this topology
        from .universal import load_universal_checkpoint

        return load_universal_checkpoint(engine, load_dir, tag=tag)

    if load_universal is None:
        load_universal = engine.config.checkpoint.load_universal
    if load_universal:
        # fragments converted beside the tag (ds_to_universal's default
        # output, <tag>/universal)
        from .universal import load_universal as _load_uni

        umeta = _load_uni(os.path.join(path, UNIVERSAL_DIR), engine)
        engine.global_steps = int(umeta.get("global_steps", 0))
        engine.micro_steps = int(umeta.get("micro_steps", 0))
        engine.state = engine.state._replace(step=engine.global_steps)
        if "lr_scheduler" in umeta:
            engine.lr_scheduler.load_state_dict(umeta["lr_scheduler"])
        log_dist(f"loaded UNIVERSAL checkpoint {path} at step {engine.global_steps}")
        return path, umeta.get("client_state", {})

    template = StateTree(state_leaves(engine), {}, comm.get_rank())
    retries = int(getattr(cfg, "io_retries", 0) or 0)
    saved = with_io_retries(
        lambda: ce.load(os.path.join(path, "state"), template),
        retries=retries, backoff_s=float(getattr(cfg, "io_backoff_s", 0.5)),
        what=f"checkpoint load '{tag}'",
        on_retry=lambda n, e: _reliability(engine, "checkpoint_io_retry"))
    restore_header(engine, saved.header)

    meta_path = os.path.join(path, "meta.json")
    client_state: Dict[str, Any] = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        engine.global_steps = meta.get("global_steps", int(saved.header.get("step", 0)))
        engine.micro_steps = meta.get("micro_steps", 0)
        engine.lr_scheduler.load_state_dict(meta.get("lr_scheduler", {"last_step": 0}))
        client_state = meta.get("client_state", {})
    _reliability(engine, "checkpoint_loaded")
    log_dist(f"loaded checkpoint {path} at step {engine.global_steps}")
    return path, client_state
