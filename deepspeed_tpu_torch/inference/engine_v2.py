"""Inference engine v2: continuous batching over a paged KV cache —
counterpart of ``deepspeed_tpu/inference/engine_v2.py``.

The same scheduling as the JAX engine: ``generate`` admits prompts through
``StateManager.admit_prompt``, runs one batched prefill per admission burst
(prompts padded to a multiple of ``prefill_bucket``, rows padded to a power
of two with zero-length dummy rows that write to the trash block), then one
decode step over all ``max_tracked_sequences`` slots, inactive slots writing
to the trash block 0. The pools are updated in place.

The serving core, as in the JAX engine:

- prefix cache (``inference.prefix_cache``, default OFF): admissions resolve
  cached prompt prefixes to shared blocks and prefill only the uncached
  suffix at its context offset; a write into a shared block is preceded by
  a copy-on-write (``StateManager.ensure_writable`` → :meth:`_copy_blocks`);
- split prefill (``split_prefill_chunk > 0``): :meth:`put_split` admits a
  prompt that enters the cache one chunk per ``step`` / ``step_many`` call,
  oldest first, and all at once when no decode is live;
- :meth:`step_many`: k decode steps with one host sync. The decode forward
  (of ``step`` and ``step_many`` alike) reads static device buffers
  (:class:`_DecodeBuffers`); on a CUDA device it is captured once per engine
  as a ``torch.cuda.CUDAGraph`` at the fixed slot batch and replayed for
  every tick (the counterpart of the JAX engine's compiled programs, so
  ``enable_cuda_graph`` is accepted and ignored, as there). Sampling stays
  outside the graph, as eager device ops. On the CPU there is no graph: the
  same forward runs eagerly over the same buffers, which is also the plain
  version the chip smoke holds the graph against;
- ``park`` / ``resume`` / ``fork``, ``kv_headroom``, ``set_speculative``;
- the disaggregated handoff: ``kv_chain_hashes``, ``resident_prefix``,
  ``export_kv_blocks`` (wire formats ``"native"`` and ``"int8"``) and
  ``import_kv_blocks``;
- the checks and counters ``debug_check_cache``, ``prefix_cache_events``,
  ``kv_quant_events`` and ``spec_events`` (plain ``(name, value, step)``
  lists; nothing publishes them yet);
- the request-trace plane (``inference.trace``, default OFF): each request
  is one trace of the engine's :class:`~..telemetry.trace.Tracer` (request
  span, queue wait, prefill / chunk spans, first-token and per-token
  instants, park / resume marks), with TTFT, inter-token latency, queue
  time and end-to-end latency kept for :meth:`latency_summary`. The spans
  are host events around the forwards, never inside a captured graph, and a
  token's time is taken after the copy that brings it to the host.

Speculative decoding (``inference.speculative``, default OFF): the
prompt-lookup drafter (:func:`prompt_lookup_draft`) proposes up to k tokens
per live sequence from its own history; ONE batched forward over the paged
cache scores ``[last_token, draft_1..k]`` for every slot; acceptance runs on
the device (greedy rows by argmax, stochastic rows by exact rejection
sampling) with one host sync per step; rejected positions are rolled back
with ``StateManager.truncate``. With ``fused_verify`` that forward's
attention is the paged spec-verify kernel instead of the gathered-view
prefill read. Quantized KV (``inference.kv_quant``, default OFF): int8 code
pools with fp32 scales (``models/_paged.py``).

Not ported: the prefix cache's host-spill tier and the compile monitor —
enabling them raises (``config.check_ported``).
"""

from __future__ import annotations

import time
import warnings
from contextlib import nullcontext
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models._paged import fused_verify_scope
from ..ops import paged_attention
from ..ops.quantization import kv_dequantize_int8, kv_quantize_int8
from ..telemetry.trace import Tracer, percentiles
from ..utils.logging import log_dist
from .config import InferenceConfig
from .engine import InferenceEngine, ModelFamily, _round_up
from .ragged import StateManager, UnknownSequenceError  # noqa: F401 (re-export)
from .sampling import SamplingParams, filter_logits_batch, sample, sp_arrays

_GREEDY = SamplingParams(greedy=True)


def prompt_lookup_draft(history, max_tokens: int, ngram_max: int = 3,
                        min_match: int = 1) -> List[int]:
    """Prompt-lookup (n-gram) drafting: match the TRAILING n-gram of
    ``history`` (n from ``ngram_max`` down to ``min_match``) against an
    earlier occurrence and propose up to ``max_tokens`` of the tokens that
    followed it — the most recent occurrence wins. Returns ``[]`` when
    nothing matches (the caller then runs a plain decode step)."""
    n_hist = len(history)
    if max_tokens <= 0 or n_hist < max(1, min_match) + 1:
        return []
    arr = np.asarray(history, np.int32)
    for n in range(min(ngram_max, n_hist - 1), max(1, min_match) - 1, -1):
        pat = arr[n_hist - n:]
        # windows over arr[:-1]: every match start i has i + n <= n_hist - 1,
        # so a continuation token exists and the trailing n-gram never
        # matches itself
        win = np.lib.stride_tricks.sliding_window_view(arr[:n_hist - 1], n)
        hits = np.flatnonzero((win == pat).all(axis=1))
        if hits.size:
            start = int(hits[-1]) + n
            return arr[start:start + max_tokens].tolist()
    return []


def _row_generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def _numel(a) -> int:
    return int(a.numel()) if isinstance(a, torch.Tensor) else int(a.size)


def _to_host(t: torch.Tensor):
    """A device slice → a host array: numpy where numpy has the dtype, a CPU
    ``torch.bfloat16`` tensor otherwise (numpy has no bfloat16)."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _from_host(a, device) -> torch.Tensor:
    """Inverse of :func:`_to_host`; also takes the JAX engine's numpy
    bfloat16 arrays (``ml_dtypes``), by their bits."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


class _DecodeBuffers:
    """The decode forward's inputs as device tensors at the fixed slot batch:
    tokens [B, 1], context lengths [B], block tables [B, width], the active
    mask as ``valid`` [B, 1] and as the int32 ``step`` [B] each tick adds to
    the lengths. A captured graph reads exactly these tensors, so they are
    allocated once and only ever written in place."""

    def __init__(self, B: int, width: int, device):
        self.tokens = torch.zeros((B, 1), dtype=torch.int32, device=device)
        self.lens = torch.zeros((B,), dtype=torch.int32, device=device)
        self.tables = torch.zeros((B, width), dtype=torch.int32, device=device)
        self.valid = torch.zeros((B, 1), dtype=torch.bool, device=device)
        self.step = torch.zeros((B,), dtype=torch.int32, device=device)

    def load(self, tokens, lens, tables, active) -> None:
        """Copy the host slot state in (before a quantum, outside a graph)."""
        self.tokens.copy_(torch.from_numpy(tokens[:, None]))
        self.lens.copy_(torch.from_numpy(lens))
        self.tables.copy_(torch.from_numpy(tables))
        self.valid.copy_(torch.from_numpy(active[:, None]))
        self.step.copy_(self.valid[:, 0])

    def clear(self) -> None:
        for t in (self.tokens, self.lens, self.tables, self.valid, self.step):
            t.zero_()


class InferenceEngineV2(InferenceEngine):
    """put()/step() continuous batching; ``generate`` drains a prompt list
    through the scheduler."""

    def __init__(self, family: ModelFamily, params: Mapping[str, Any],
                 config: Optional[InferenceConfig] = None, device="cuda"):
        super().__init__(family, params, config, device)
        rc = self.config.ragged
        pc = self.config.prefix_cache
        max_blocks_per_seq = max(
            2, (self.family.cfg.max_seq_len + rc.block_size - 1) // rc.block_size)
        self.state = StateManager(rc.max_tracked_sequences,
                                  rc.memory_config_blocks, rc.block_size,
                                  max_blocks_per_seq,
                                  prefix_cache=pc.enabled,
                                  max_retained_blocks=pc.max_retained_blocks)
        # quantized KV cache: int8 code pools + fp32 scale pools, validated
        # as the JAX engine does (engine_v2.py:106-129)
        kq = self.config.kv_quant
        self._kvq_on = bool(kq.enabled)
        self._kvq_group = 0
        pool_kw = {}
        if self._kvq_on:
            if kq.dtype != "int8":
                raise ValueError(f"inference.kv_quant.dtype {kq.dtype!r} is not "
                                 "wired — only 'int8' is supported")
            hd = self.family.cfg.head_size
            eff = min(int(kq.group_size), hd)
            if eff < 1 or hd % eff:
                raise ValueError(f"inference.kv_quant.group_size {kq.group_size} "
                                 f"does not divide head_size {hd}")
            self._kvq_group = pool_kw["kv_quant_group"] = eff
        try:
            self.cache = self.family.init_paged_cache(
                self.family.cfg, rc.memory_config_blocks, rc.block_size,
                dtype=self.dtype, device=self.device, **pool_kw)
        except TypeError:
            if not pool_kw:
                raise
            raise ValueError("this model's init_paged_cache does not accept "
                             "kv_quant_group — the family has no quantized KV "
                             "path; disable inference.kv_quant") from None
        # speculative decoding (default OFF: step() runs the plain decode)
        sc = self.config.speculative
        self._spec_on = bool(sc.enabled)
        self._spec_k = max(1, int(sc.max_draft_tokens))
        self._spec_ngram_max = max(1, int(sc.ngram_max))
        self._spec_min_match = max(1, int(sc.min_match))
        self._spec_fused = bool(self._spec_on and sc.fused_verify)
        # cumulative counters, the JAX engine's: model steps in spec mode
        # split into verify steps (>= 1 draft scored) and plain decode
        # fallbacks, plus drafted/accepted/emitted/rolled-back tokens and
        # verify-batch occupancy (valid positions / batch capacity)
        self.spec_stats: Dict[str, int] = {
            "verify_steps": 0, "decode_steps": 0, "step_seqs": 0,
            "drafted_tokens": 0, "accepted_tokens": 0, "emitted_tokens": 0,
            "rolled_back_tokens": 0, "verify_positions": 0,
            "verify_capacity": 0, "fused_verify_steps": 0}
        # request-lifecycle tracing and latency samples (default OFF: every
        # hook below is a no-op and no timer starts)
        self.tracer = Tracer(self.config.trace, name="serving")
        self._trace_on = self.tracer.enabled
        self._req: Dict[int, dict] = {}   # uid → open lifecycle record
        # uid → a router's cross-replica trace handle (``trace_id``,
        # ``parent_span``, ``replica``) that the uid's next admission joins
        self._adopted: Dict[int, Any] = {}
        self._lat: Dict[str, List[float]] = {
            "ttft_ms": [], "itl_ms": [], "queue_ms": [], "e2e_ms": []}
        B = rc.max_tracked_sequences
        self._slot_tokens = np.zeros((B,), np.int32)
        self._slot_lens = np.zeros((B,), np.int32)
        self._slot_tables = np.zeros((B, max_blocks_per_seq), np.int32)
        self._slot_active = np.zeros((B,), bool)
        # per-slot sampling params, recorded at admission
        self._slot_sp: List[SamplingParams] = [_GREEDY] * B
        # uid → (full prompt, SamplingParams) of split admissions, oldest first
        self._pending_prefill: Dict[int, Tuple[np.ndarray, SamplingParams]] = {}
        # the decode forward's static inputs; on a CUDA device, its graph
        # (captured at the first decode), the graph's outputs, the paged
        # kernel's scratch it reads and the replays so far. The kernel
        # wrappers' ``.launches`` move at capture only: a replay launches
        # what the graph holds
        self._dec = _DecodeBuffers(B, max_blocks_per_seq, self.device)
        self._graph_on = self.device.type == "cuda"
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._graph_scratch = None
        self.graph_replays = 0
        # one entry per model forward: (kind — "prefill", "prefill_chunk",
        # "decode", "verify", or "decode_many" for a step_many quantum of k
        # forwards —, host seconds including the token sync, tokens
        # produced, monotonic end time) — what the chip smoke reads TTFT,
        # step times and throughput from
        self.forward_log: List[Tuple[str, float, int, float]] = []
        spec_lbl = "off"
        if self._spec_on:
            spec_lbl = "on(k=%d%s)" % (self._spec_k,
                                       ",fused" if self._spec_fused else "")
        kvq_lbl = "int8(g=%d)" % self._kvq_group if self._kvq_on else "off"
        log_dist(f"InferenceEngineV2: {rc.memory_config_blocks} blocks × "
                 f"{rc.block_size} tokens, {B} sequence slots on {self.device}, "
                 f"kv_quant={kvq_lbl}, prefix_cache={'on' if pc.enabled else 'off'}, "
                 f"speculative={spec_lbl}, trace={'on' if self._trace_on else 'off'}, "
                 f"cuda_graph={'on' if self._graph_on else 'off'}")

    # ------------------------------------------------------------------ #
    # request-lifecycle accounting: admit → queue wait → prefill (chunks) →
    # per decode token → finish. Each request is one trace; TTFT, ITL, queue
    # time and e2e latency accumulate for the SLO percentiles. Token times
    # are host times after the tokens' copy to the host.
    # ------------------------------------------------------------------ #
    def adopt_trace(self, uid: int, ctx) -> None:
        """Join a router's cross-replica trace: the next admission of
        ``uid`` opens a ``replica_leg`` span under ``ctx.parent_span`` in
        trace ``ctx.trace_id`` instead of minting a private trace. No-op
        with tracing off."""
        if self._trace_on and ctx is not None:
            self._adopted[uid] = ctx

    def release_trace(self, uid: int, reason: str = "rehome") -> None:
        """This engine gives ``uid`` up (drain, failover, handoff): close its
        open spans, recording no latency samples (the destination leg owns
        the stream's latency). Tolerant of an absent record."""
        rec = self._req_close(uid)
        if rec is not None:
            rec["span"].end(handoff=reason)

    def _req_close(self, uid: int) -> Optional[dict]:
        """Forget ``uid``'s adopted handle and pop its open record, ending
        the queue span still open; → the record (None without one)."""
        self._adopted.pop(uid, None)
        rec = self._req.pop(uid, None)
        if rec is not None and rec["queue"] is not None:
            rec["queue"].end()
        return rec

    def _req_admit(self, uid: int, prompt_len: int, split: bool = False) -> None:
        if not self._trace_on or uid in self._req:
            return
        now = time.monotonic_ns()
        ctx = self._adopted.pop(uid, None)
        if ctx is not None:
            tid = ctx.trace_id
            span = self.tracer.begin("replica_leg", cat="serving", trace=tid,
                                     parent=ctx.parent_span, uid=uid,
                                     prompt_tokens=prompt_len, split=split,
                                     replica=ctx.replica)
        else:
            tid = self.tracer.new_trace(label=f"request:{uid}")
            span = self.tracer.begin("request", cat="serving", trace=tid, uid=uid,
                                     prompt_tokens=prompt_len, split=split)
        queue = self.tracer.begin("queue_wait", cat="serving", trace=tid,
                                  parent=span.span_id, uid=uid)
        self._req[uid] = {"trace": tid, "span": span, "queue": queue,
                          "t_admit": now, "last_ns": None, "first_done": False}

    def _req_compute_begin(self, uid: int) -> None:
        """The request's first forward is issued: its queue wait ends."""
        rec = self._req.get(uid)
        if rec is None or rec["queue"] is None:
            return
        rec["queue"].end()
        rec["queue"] = None
        self._lat["queue_ms"].append((time.monotonic_ns() - rec["t_admit"]) / 1e6)

    def _req_first_token(self, uid: int, t_ns: int) -> None:
        rec = self._req.get(uid)
        if rec is None or rec["first_done"]:
            return
        if rec["queue"] is not None:   # fork children never prefill
            rec["queue"].end()
            rec["queue"] = None
            self._lat["queue_ms"].append((t_ns - rec["t_admit"]) / 1e6)
        rec["first_done"] = True
        rec["last_ns"] = t_ns
        self._lat["ttft_ms"].append((t_ns - rec["t_admit"]) / 1e6)
        self.tracer.instant("first_token", cat="serving", trace=rec["trace"],
                            parent=rec["span"].span_id, ts_ns=t_ns, uid=uid)

    def _req_tokens(self, uid: int, k: int, t_ns: int) -> None:
        """``k`` decode tokens of ``uid`` reached the host at ``t_ns`` (one
        step or quantum): ITL per token = elapsed / k, the per-token
        instants interpolated across the quantum."""
        rec = self._req.get(uid)
        if rec is None or k <= 0:
            return
        start = rec["last_ns"] if rec["last_ns"] is not None else rec["t_admit"]
        per = (t_ns - start) / k
        i0 = 0
        if not rec["first_done"]:
            self._req_first_token(uid, int(start + per))
            i0 = 1
        for i in range(i0, k):
            self._lat["itl_ms"].append(per / 1e6)
            self.tracer.instant("decode_token", cat="serving", trace=rec["trace"],
                                parent=rec["span"].span_id,
                                ts_ns=int(start + per * (i + 1)), uid=uid)
        rec["last_ns"] = t_ns

    def _req_finish(self, uid: int, **args) -> None:
        rec = self._req_close(uid)
        if rec is not None:
            self._lat["e2e_ms"].append((time.monotonic_ns() - rec["t_admit"]) / 1e6)
            rec["span"].end(**args)

    def _req_drop(self, uid: int) -> None:
        """An admission rolled back: close its spans without latency samples.
        Tolerant of an absent record (tracing off opens none)."""
        rec = self._req_close(uid)
        if rec is not None:
            rec["span"].end(cancelled=True)

    def _trace_parent(self, uid: int) -> Tuple[Optional[int], Optional[int]]:
        """(trace, parent span) of ``uid``'s open record, (None, None)
        without one."""
        rec = self._req.get(uid)
        return (rec["trace"], rec["span"].span_id) if rec else (None, None)

    # ------------------------------------------------------------------ #
    def _tensor(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _forward(self, tokens, tables, ctx, valid) -> torch.Tensor:
        """One paged forward; numpy arguments are copied to the device,
        tensors are used as they are."""
        logits, self.cache = self.family.apply_paged(
            self.family.cfg, self.model, self._tensor(tokens), self.cache,
            self._tensor(tables), self._tensor(ctx), valid=self._tensor(valid))
        return logits

    @staticmethod
    def _canon_sp(sp: SamplingParams) -> SamplingParams:
        if sp.greedy or sp.temperature == 0.0:
            return _GREEDY
        return sp

    _sp_warned = False

    def _warn_ignored_sp(self, sp: SamplingParams) -> None:
        """step()/step_many() sample with admission-time params; a caller
        passing another sp here is told once that it is ignored."""
        if not self._sp_warned and self._canon_sp(sp) != _GREEDY:
            warnings.warn(
                "step()/step_many() ignore their sp argument — sampling "
                "params are per-request, fixed at put()/put_split() time; "
                "pass them there instead", DeprecationWarning, stacklevel=3)
            self._sp_warned = True

    def _sample_dev(self, last: torch.Tensor, sps: Sequence[SamplingParams],
                    seeds: Sequence[int], amax: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """last [n, V] → token ids [n] on the device: the argmax (``amax``
        where the caller has it) when every row is greedy, else each
        stochastic row draws from its own generator (seeded per row, so a
        row's draw does not depend on its batch neighbours)."""
        toks = torch.argmax(last, dim=-1) if amax is None else amax
        stochastic = [i for i, sp in enumerate(sps) if sp != _GREEDY]
        if stochastic:
            toks = toks.clone()
            for i in stochastic:
                toks[i] = sample(last[i], sps[i], _row_generator(self.device, seeds[i]))
        return toks

    def _sample_rows(self, last: torch.Tensor, sps: Sequence[SamplingParams],
                     seeds: Sequence[int]) -> np.ndarray:
        return self._sample_dev(last, sps, seeds).cpu().numpy().astype(np.int32)

    # ------------------------------------------------------------------ #
    # the decode forward over static buffers, eager or as a CUDA graph
    # ------------------------------------------------------------------ #
    def _decode_body(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """One decode forward over :attr:`_dec` → (logits [B, V], argmax
        [B]); inactive slots write to the trash block."""
        b = self._dec
        logits = self._forward(b.tokens, b.tables, b.lens, b.valid)[:, 0]
        return logits, torch.argmax(logits, dim=-1)

    def _capture(self) -> None:
        """Capture :meth:`_decode_body` as a CUDA graph on a stream of its
        own. Two warm-up forwards on that stream first build the kernels,
        create the library handles and size the paged kernel's scratch for
        the stream (its plan depends on the shapes only, which the capture
        repeats; every buffer is zero then: all slots inactive, every write
        lands in the trash block). The graph reads that scratch at every
        replay, so it is held for the life of the graph, and a capture that
        grew it raises, as a failed capture does."""
        dev = self.device
        self._dec.clear()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad(), torch.cuda.stream(stream):
            for _ in range(2):
                self._decode_body()
        torch.cuda.current_stream(dev).wait_stream(stream)
        scratch = paged_attention.workspace_of(dev, stream.cuda_stream)
        # the captured cudaGraph_t is kept beside its instance, so what a
        # replay launches can be read from its nodes (raw_cuda_graph())
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.no_grad(), torch.cuda.graph(graph, stream=stream):
            out = self._decode_body()
        held = paged_attention.workspace_of(dev, stream.cuda_stream)
        if [id(t) for t in held or ()] != [id(t) for t in scratch or ()]:
            raise RuntimeError("the paged kernel's scratch grew during the decode "
                               "graph's capture")
        graph.instantiate()
        self._graph, self._graph_out, self._graph_scratch = graph, out, scratch

    def _decode_forward(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if not self._graph_on:
            return self._decode_body()
        self._graph.replay()
        self.graph_replays += 1
        return self._graph_out

    def _advance(self, nxt: torch.Tensor) -> None:
        """After a tick: feed the sampled tokens back and advance the active
        slots' context lengths, on the device."""
        b = self._dec
        b.tokens[:, 0].copy_(nxt)
        b.lens.add_(b.step)

    def _decode_ticks(self, k: int, seed: int) -> np.ndarray:
        """k decode forwards over every slot from the host slot state, one
        host sync → tokens [k, B]. Tick t samples like ``step(seed=seed +
        t)``. Block capacity for all k tokens must be reserved first."""
        if self._graph_on and self._graph is None:
            self._capture()                        # clears the buffers
        b = self._dec
        B = self._slot_tokens.shape[0]
        b.load(self._slot_tokens, self._slot_lens, self._slot_tables,
               self._slot_active)
        hist = torch.empty((k, B), dtype=torch.int32, device=self.device)
        with torch.no_grad():
            for t in range(k):
                logits, amax = self._decode_forward()
                nxt = self._sample_dev(logits, self._slot_sp,
                                       [(seed + t) * 1_000_003 + s for s in range(B)],
                                       amax=amax)
                self._advance(nxt)
                hist[t].copy_(nxt)
        return hist.cpu().numpy()                                  # the one sync

    # ------------------------------------------------------------------ #
    def put(self, uid: int, prompt_tokens, sp: SamplingParams = _GREEDY,
            seed: int = 0) -> int:
        """Admit one sequence and run its prefill; returns the first sampled
        token."""
        return self.put_many([(uid, prompt_tokens)], sp, seed=seed)[uid]

    def put_many(self, uid_prompts, sp: SamplingParams = _GREEDY,
                 seed: int = 0) -> Dict[int, int]:
        """Admit a BATCH of sequences with one prefill → {uid: first token}.
        All-or-nothing: if capacity runs out mid-batch, already-admitted
        entries are retired before the error propagates."""
        entries = []
        cached = []
        try:
            for uid, p in uid_prompts:
                prompt = np.asarray(p, np.int32)
                desc, hit = self.state.admit_prompt(uid, prompt)
                entries.append((uid, prompt, desc))
                cached.append(hit)
                self._req_admit(uid, len(prompt))
        except (MemoryError, ValueError):
            for uid, _, _ in entries:
                self.state.retire(uid)
                self._req_drop(uid)
            raise
        return self._prefill_admitted(entries, [sp] * len(entries), seed,
                                      cached=cached)

    def _prefill_admitted(self, entries, sps, seed: int = 0,
                          cached=None) -> Dict[int, int]:
        """One batched prefill over already-admitted ``(uid, prompt, desc)``
        entries, with per-entry sampling params. ``cached[i]`` tokens of
        entry i were resolved to shared blocks by the prefix cache: the
        forward runs only over each prompt's uncached suffix, at context
        offset ``cached[i]``. Rows pad to a power of two with zero-length
        dummy rows; tokens pad to a multiple of ``prefill_bucket``."""
        if not entries:
            return {}
        if cached is None:
            cached = [0] * len(entries)
        sps = [self._canon_sp(s_) for s_ in sps]
        n = len(entries)
        n_pad = 1 << (n - 1).bit_length()
        pad_t = _round_up(max(max(len(p) - c for (_, p, _), c in zip(entries, cached)), 1),
                          self.config.prefill_bucket)
        padded = np.zeros((n_pad, pad_t), np.int32)
        lengths = np.zeros((n_pad,), np.int32)   # dummy rows: length 0
        ctx = np.zeros((n_pad,), np.int32)
        tables = np.zeros((n_pad, self._slot_tables.shape[1]), np.int32)
        for i, (uid, prompt, desc) in enumerate(entries):
            suffix = prompt[cached[i]:]
            padded[i, :len(suffix)] = suffix
            lengths[i] = len(suffix)
            ctx[i] = cached[i]
            tables[i] = self.state.block_table(desc)
        valid = np.arange(pad_t)[None, :] < lengths[:, None]
        if self._trace_on:
            for uid, prompt, _ in entries:
                self._req_admit(uid, len(prompt))   # generate() admits directly
                self._req_compute_begin(uid)
            t0_ns = time.monotonic_ns()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = self._forward(padded, tables, ctx, valid)
            last_idx = self._tensor(np.maximum(lengths[:n] - 1, 0).astype(np.int64))
            last = logits[torch.arange(n, device=self.device), last_idx]
            toks = self._sample_rows(last, sps,
                                     [seed * 1_000_003 + uid for uid, _, _ in entries])
        t1 = time.perf_counter()
        self.forward_log.append(("prefill", t1 - t0, n, time.monotonic()))
        if self._trace_on:
            t1_ns = time.monotonic_ns()     # the tokens are on the host
            self.tracer.complete("prefill_batch", t0_ns, t1_ns, cat="serving",
                                 n=n, pad_t=pad_t)
        out: Dict[int, int] = {}
        for i, (uid, prompt, desc) in enumerate(entries):
            tok = int(toks[i])
            desc.seen_tokens = len(prompt)
            self.state.mark_filled(desc)           # full prompt blocks → matchable
            desc.last_token = tok
            desc.generated.append(tok)
            self._activate(desc, tok, tables[i], sps[i])
            out[uid] = tok
            if self._trace_on:
                trace, parent = self._trace_parent(uid)
                if trace is not None:
                    self.tracer.complete("prefill", t0_ns, t1_ns, cat="serving",
                                         trace=trace, parent=parent, uid=uid,
                                         tokens=int(lengths[i]), cached=int(ctx[i]))
                self._req_first_token(uid, t1_ns)
        return out

    def _activate(self, desc, tok: int, table: np.ndarray, sp: SamplingParams) -> None:
        s = desc.slot
        self._slot_tokens[s] = tok
        self._slot_lens[s] = desc.seen_tokens
        self._slot_tables[s] = table
        self._slot_active[s] = True
        self._slot_sp[s] = sp

    # ------------------------------------------------------------------ #
    # split prefill: one chunk per step() / step_many() call
    # ------------------------------------------------------------------ #
    def put_split(self, uid: int, prompt_tokens,
                  sp: SamplingParams = _GREEDY) -> None:
        """Admit a sequence WITHOUT prefilling it: the prompt enters the KV
        cache one chunk per later ``step()`` / ``step_many()`` call, beside
        the live decodes, so a long prompt never holds them up for more than
        one chunk. The first sampled token arrives in the result of the
        call that completes the prompt. With the prefix cache on, chunking
        starts at the first uncached token."""
        prompt = np.asarray(prompt_tokens, np.int32)
        desc, cached = self.state.admit_prompt(uid, prompt)
        self._req_admit(uid, len(prompt), split=True)
        desc.seen_tokens = cached
        desc.prefilling = True
        self._pending_prefill[uid] = (prompt, sp)

    def _advance_prefill(self, seed: int = 0) -> Dict[int, int]:
        """Advance the OLDEST pending split prefill by one chunk of
        ``split_prefill_chunk`` tokens (rounded up to ``prefill_bucket``) at
        its context offset. Returns {uid: first token} when that chunk
        completes the prompt, else {}."""
        if not self._pending_prefill:
            return {}
        uid = next(iter(self._pending_prefill))
        prompt, sp = self._pending_prefill[uid]
        desc = self.state.seqs[uid]
        chunk_t = _round_up(max(self.config.split_prefill_chunk, 1),
                            self.config.prefill_bucket)
        done = desc.seen_tokens
        chunk = prompt[done:done + chunk_t]
        final = done + len(chunk) >= len(prompt)
        padded = np.zeros((1, chunk_t), np.int32)
        padded[0, :len(chunk)] = chunk
        table = self.state.block_table(desc)
        valid = np.arange(chunk_t)[None, :] < len(chunk)
        if self._trace_on:
            self._req_compute_begin(uid)   # the first chunk ends the queue wait
            t0_ns = time.monotonic_ns()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = self._forward(padded, table[None], np.asarray([done], np.int32),
                                   valid)
            if final:
                sp = self._canon_sp(sp)
                tok = int(self._sample_rows(logits[:, len(chunk) - 1], [sp],
                                            [seed * 1_000_003 + uid])[0])
        self.forward_log.append(("prefill_chunk", time.perf_counter() - t0,
                                 int(final), time.monotonic()))
        if self._trace_on:
            # a final chunk ends after its token's copy to the host; an
            # earlier one after its launches
            t1_ns = time.monotonic_ns()
            trace, parent = self._trace_parent(uid)
            self.tracer.complete("prefill_chunk", t0_ns, t1_ns, cat="serving",
                                 trace=trace, parent=parent, uid=uid,
                                 tokens=len(chunk), ctx=done, final=final)
            if final:
                self._req_first_token(uid, t1_ns)
        desc.seen_tokens = done + len(chunk)
        self.state.mark_filled(desc)               # completed chunks → matchable
        if not final:
            return {}
        del self._pending_prefill[uid]
        desc.prefilling = False
        desc.last_token = tok
        desc.generated.append(tok)
        self._activate(desc, tok, table, sp)
        return {uid: tok}

    def _start_step(self, seed: int) -> Tuple[Dict[int, int], list]:
        """The split-prefill half of a step: advance one chunk, and when no
        decode is live drain the oldest split prompt to completion (the
        one-chunk bound protects live decodes; with none, the prompt's
        reserved blocks would only sit idle). Returns (first tokens, the
        sequences to decode)."""
        out = self._advance_prefill(seed)
        live = [d for d in self.state.seqs.values()
                if not d.finished and not d.prefilling and d.uid not in out]
        if not live:
            while self._pending_prefill and not out:
                out.update(self._advance_prefill(seed))
        return out, live

    def _reserve(self, live, n: int) -> None:
        """Copy-on-write, then reserve ``n`` more positions for every live
        sequence and refresh its table (the copies land before any write)."""
        cow = []
        for d in live:
            # copy-on-write BEFORE extend: only pre-existing blocks can be
            # shared; the blocks extend allocates are fresh
            cow += self.state.ensure_writable(d, d.seen_tokens + n)
            self.state.extend(d, n=n)
            self._slot_tables[d.slot] = self.state.block_table(d)
        self._copy_blocks(cow)

    def step(self, sp: SamplingParams = _GREEDY, seed: int = 0) -> Dict[int, Any]:
        """One decode step over every live sequence → {uid: next_token}.
        Split-admitted sequences advance one prefill chunk first; a sequence
        whose prompt completes here contributes its first token. Sampling
        uses each sequence's admission-time params (``sp`` is accepted for
        the JAX signature and ignored).

        With ``inference.speculative.enabled`` the step drafts and verifies
        instead (:meth:`_spec_step`) and may emit several tokens per
        sequence, so every value is a list ({uid: [tokens]}), prefill first
        tokens and draft-less fallback steps included."""
        self._warn_ignored_sp(sp)
        out, live = self._start_step(seed)
        if not live:
            return {u: [t] for u, t in out.items()} if self._spec_on else out
        if self._spec_on:
            spec_out = self._spec_step(live, seed)
            if spec_out is not None:
                for u, t in out.items():
                    spec_out[u] = [t]
                return spec_out
            # no sequence drafted: the plain decode below, as in a non-spec
            # step
            self.spec_stats["decode_steps"] += 1
            self.spec_stats["step_seqs"] += len(live)
            self.spec_stats["emitted_tokens"] += len(live)
        self._reserve(live, 1)
        t0_ns = time.monotonic_ns() if self._trace_on else 0
        t0 = time.perf_counter()
        nxt = self._decode_ticks(1, seed)[0]
        t1 = time.perf_counter()
        self.forward_log.append(("decode", t1 - t0, len(live), time.monotonic()))
        if self._trace_on:
            t1_ns = time.monotonic_ns()     # after the tokens' copy to the host
            self.tracer.complete("decode_step", t0_ns, t1_ns, cat="serving",
                                 batch=len(live))
        for d in live:
            tok = int(nxt[d.slot])
            d.tokens.append(d.last_token)  # the id whose KV this step wrote
            d.seen_tokens += 1
            d.last_token = tok
            d.generated.append(tok)
            self._slot_tokens[d.slot] = tok
            self._slot_lens[d.slot] = d.seen_tokens
            self.state.mark_filled(d)
            out[d.uid] = tok
            if self._trace_on:
                self._req_tokens(d.uid, 1, t1_ns)
        return {u: [t] for u, t in out.items()} if self._spec_on else out

    def step_many(self, k: int, sp: SamplingParams = _GREEDY,
                  seed: int = 0) -> Dict[int, List[int]]:
        """k decode steps over every live sequence with ONE host sync →
        {uid: [k next tokens]}. Block capacity for all k tokens is reserved
        up front; k is clamped so no live sequence runs past max_seq_len.
        Tokens sampled after a sequence's EOS are still produced (the caller
        trims). Split-admitted sequences advance one prefill chunk per call;
        a prompt completing here contributes its first token as a 1-list.
        On a CUDA device each of the k forwards is one replay of the
        captured decode graph. Speculative decoding does not apply here
        (``generate`` steps with ``step()`` in spec mode)."""
        self._warn_ignored_sp(sp)
        first, live = self._start_step(seed)
        out: Dict[int, List[int]] = {u: [t] for u, t in first.items()}
        if not live or k <= 0:
            return out
        # a tick at seen writes KV position seen, so seen may reach exactly
        # max_seq_len after the last tick — the per-step path's boundary
        k = min(k, self.family.cfg.max_seq_len - max(d.seen_tokens for d in live))
        if k <= 0:
            return out
        self._reserve(live, k)
        t0_ns = time.monotonic_ns() if self._trace_on else 0
        t0 = time.perf_counter()
        toks = self._decode_ticks(k, seed)
        t1 = time.perf_counter()
        self.forward_log.append(("decode_many", t1 - t0, k * len(live), time.monotonic()))
        if self._trace_on:
            t1_ns = time.monotonic_ns()     # after the quantum's copy to the host
            self.tracer.complete("decode_quantum", t0_ns, t1_ns, cat="serving",
                                 k=k, batch=len(live))
        for d in live:
            seq = [int(t) for t in toks[:, d.slot]]
            # KV writes this quantum: the previous last_token, then each
            # sampled token except the newest (still pending its write)
            d.tokens.extend([d.last_token] + seq[:-1])
            d.seen_tokens += k
            d.last_token = seq[-1]
            d.generated.extend(seq)
            self._slot_tokens[d.slot] = seq[-1]
            self._slot_lens[d.slot] = d.seen_tokens
            self.state.mark_filled(d)
            out[d.uid] = seq
            if self._trace_on:
                self._req_tokens(d.uid, k, t1_ns)
        return out

    # ------------------------------------------------------------------ #
    # speculative decoding: prompt-lookup drafts, one batched verify
    # forward, acceptance on the device, KV rollback
    # ------------------------------------------------------------------ #
    def _copy_blocks(self, pairs) -> None:
        """Apply the (src, dst) whole-block copies ``StateManager``
        scheduled (copy-on-write, truncate into a shared block) to every
        pool — codes and scales alike — before the step that writes dst."""
        for src, dst in pairs:
            for pool in self.cache.values():
                pool[:, dst] = pool[:, src]

    def _draft_tokens(self, desc) -> List[int]:
        """Prompt-lookup draft for one live sequence, clamped so the verify
        write window ``[seen, seen + len + 1)`` stays inside max_seq_len and
        the fixed-width block table."""
        room = min(self.family.cfg.max_seq_len,
                   self.state.max_blocks_per_seq * self.state.block_size) \
            - desc.seen_tokens - 1
        k = min(self._spec_k, room)
        if k <= 0:
            return []
        return prompt_lookup_draft(desc.tokens + [desc.last_token], k,
                                   self._spec_ngram_max, self._spec_min_match)

    def _verify(self, tok_w: np.ndarray, nvalid: np.ndarray, drafts: np.ndarray,
                uids: np.ndarray, seed: int) -> Tuple[np.ndarray, np.ndarray]:
        """ONE forward over every slot's ``[last_token, draft_1..k]`` at
        context offset ``lens`` (positions past ``nvalid`` masked to the
        trash block), then acceptance on the device: greedy rows accept
        draft j while it equals the argmax of the logits before it;
        stochastic rows accept with probability ``p(draft_j)`` under their
        own filtered distribution — exact rejection sampling for the
        deterministic drafter, the correction drawn from p without the
        rejected token. When every draft is accepted the bonus position
        gives one more token. Returns (accepted length [B], next token [B])
        after one host sync."""
        B, kp1 = tok_w.shape
        k = kp1 - 1
        dev = self.device
        valid = (np.arange(kp1)[None, :] < nvalid[:, None]) \
            & self._slot_active[:, None]
        with fused_verify_scope() if self._spec_fused else nullcontext():
            logits = self._forward(tok_w, self._slot_tables, self._slot_lens, valid)
        amax = logits.argmax(-1)                                   # [B, kp1]
        dr = self._tensor(drafts.astype(np.int64))                 # [B, k]
        draft_len = self._tensor(nvalid.astype(np.int64)) - 1
        stochastic = [i for i, sp in enumerate(self._slot_sp) if sp != _GREEDY]
        ok = dr == amax[:, :k]
        if stochastic:
            temp, topk, topp, greedy = map(self._tensor, sp_arrays(self._slot_sp))
            is_greedy = greedy | (temp <= 0.0)
            V = logits.shape[-1]
            filt = filter_logits_batch(
                logits.reshape(B * kp1, V), temp.repeat_interleave(kp1),
                topk.repeat_interleave(kp1), topp.repeat_interleave(kp1)
            ).reshape(B, kp1, V)
            probs = torch.softmax(filt, dim=-1)
            # per-row draws from a generator seeded by (seed, uid), so a
            # row's draws do not depend on its batch neighbours
            accept_u = torch.zeros(B, k, device=dev)
            gumbel = torch.zeros(B, V, device=dev)
            for i in stochastic:
                gen = _row_generator(dev, seed * 1_000_003 + int(uids[i]))
                accept_u[i] = torch.rand(k, generator=gen, device=dev)
                u = torch.rand(V, generator=gen, device=dev).clamp_min(1e-20)
                gumbel[i] = -torch.log(-torch.log(u))
            p_draft = probs[:, :k].gather(-1, dr[..., None])[..., 0]
            ok = torch.where(is_greedy[:, None], ok, accept_u < p_draft)
        ok = ok & (torch.arange(k, device=dev)[None, :] < draft_len[:, None])
        # longest agreeing prefix: cumprod zeroes everything after the
        # first rejection
        m = torch.cumprod(ok.long(), dim=1).sum(dim=1)             # [B]
        nxt = amax.gather(1, m[:, None])[:, 0]
        if stochastic:
            lm = filt.gather(1, m[:, None, None].expand(B, 1, filt.shape[-1]))[:, 0]
            rejected = m < draft_len
            d_m = dr.gather(1, m.clamp(max=k - 1)[:, None])[:, 0]
            vocab = torch.arange(lm.shape[-1], device=dev)[None, :]
            residual = lm.masked_fill(rejected[:, None] & (vocab == d_m[:, None]),
                                      float("-inf"))
            # Gumbel-max: a categorical draw from the residual without a sync
            sampled = (residual + gumbel).argmax(-1)
            nxt = torch.where(is_greedy, nxt, sampled)
        res = torch.stack([m, nxt]).cpu().numpy()                  # the one sync
        return res[0], res[1]

    def _spec_step(self, live, seed: int = 0) -> Optional[Dict[int, List[int]]]:
        """One speculative decode step over ``live``: draft, verify every
        draft position in one batched forward, accept the longest agreeing
        prefix per sequence, roll back rejected KV. Returns {uid: [emitted
        tokens]} — at least one token per sequence, up to
        ``max_draft_tokens + 1`` — or None when no sequence drafted (the
        caller then runs a plain decode step)."""
        drafts = {d.uid: self._draft_tokens(d) for d in live}
        bs = self.state.block_size
        # capacity guard: verification may need blocks for up to k + 1 new
        # positions per sequence; if the pool cannot cover the batch, drop
        # the drafts — a plain decode step needs the fewest blocks
        need = 0
        for d in live:
            want = d.seen_tokens + len(drafts[d.uid]) + 1
            need += max(0, (want + bs - 1) // bs - len(d.blocks))
        if need > self.state.allocator.free_blocks + self.state.retained_blocks:
            drafts = {u: [] for u in drafts}
        if not any(drafts.values()):
            return None
        kmax = self._spec_k
        st = self.spec_stats
        st["verify_steps"] += 1
        if self._spec_fused:
            st["fused_verify_steps"] += 1
        st["step_seqs"] += len(live)
        cow = []
        for d in live:
            dl = len(drafts[d.uid])
            cow += self.state.ensure_writable(d, d.seen_tokens + dl + 1)
            self.state.extend(d, n=dl + 1)
            self._slot_tables[d.slot] = self.state.block_table(d)
        self._copy_blocks(cow)
        B = self._slot_tokens.shape[0]
        tok_w = np.zeros((B, kmax + 1), np.int32)
        tok_w[:, 0] = self._slot_tokens
        dr_arr = np.zeros((B, kmax), np.int32)
        nvalid = np.ones((B,), np.int32)
        uids_arr = np.zeros((B,), np.int64)
        for d in live:
            dr = drafts[d.uid]
            dr_arr[d.slot, :len(dr)] = dr
            tok_w[d.slot, 1:len(dr) + 1] = dr
            nvalid[d.slot] = 1 + len(dr)
            uids_arr[d.slot] = d.uid
        t0_ns = time.monotonic_ns() if self._trace_on else 0
        t0 = time.perf_counter()
        with torch.no_grad():
            m, nxt = self._verify(tok_w, nvalid, dr_arr, uids_arr, seed)
        t1 = time.perf_counter()
        if self._trace_on:
            t1_ns = time.monotonic_ns()     # after the acceptance's copy to the host
            self.tracer.complete(
                "spec_verify", t0_ns, t1_ns, cat="serving", batch=len(live),
                drafted=int(sum(len(v) for v in drafts.values())),
                accepted=int(sum(min(int(m[d.slot]), len(drafts[d.uid])) for d in live)))
        out: Dict[int, List[int]] = {}
        for d in live:
            dr = drafts[d.uid]
            dl = len(dr)
            mi = min(int(m[d.slot]), dl)
            tok = int(nxt[d.slot])
            # KV positions seen..seen+dl now hold [last_token] + drafts;
            # record them, then un-fill the rejected suffix
            d.tokens.extend([d.last_token] + dr)
            d.seen_tokens += dl + 1
            if mi < dl:
                self._copy_blocks(self.state.truncate(d, d.seen_tokens - (dl - mi)))
                self._slot_tables[d.slot] = self.state.block_table(d)
            emitted = dr[:mi] + [tok]
            d.last_token = tok
            d.generated.extend(emitted)
            self._slot_tokens[d.slot] = tok
            self._slot_lens[d.slot] = d.seen_tokens
            self.state.mark_filled(d)
            out[d.uid] = emitted
            st["drafted_tokens"] += dl
            st["accepted_tokens"] += mi
            st["emitted_tokens"] += mi + 1
            st["rolled_back_tokens"] += dl - mi
            st["verify_positions"] += dl + 1
            st["verify_capacity"] += kmax + 1
            if self._trace_on:
                self._req_tokens(d.uid, mi + 1, t1_ns)
        self.forward_log.append(("verify", t1 - t0,
                                 sum(len(v) for v in out.values()), time.monotonic()))
        return out

    def finish(self, uid: int) -> List[int]:
        """Retire a sequence, free its blocks, return its generated tokens
        (an in-flight split prefill is cancelled). An unknown or finished
        uid raises ``UnknownSequenceError``."""
        desc = self.state.lookup(uid)
        self._req_finish(uid, generated=len(desc.generated))
        self._pending_prefill.pop(uid, None)
        self._clear_slot(desc.slot)
        self.state.retire(uid)
        return desc.generated

    def _clear_slot(self, s: int) -> None:
        self._slot_active[s] = False
        self._slot_lens[s] = 0
        self._slot_tables[s] = 0
        self._slot_tokens[s] = 0
        self._slot_sp[s] = _GREEDY

    # ------------------------------------------------------------------ #
    # scheduler seams: KV headroom, the speculation toggle, preemption
    # (park / resume) and fork
    # ------------------------------------------------------------------ #
    def kv_headroom(self) -> Dict[str, int]:
        """Admission-control snapshot: free / retained / total KV blocks and
        free sequence slots. ``headroom_blocks`` is what an admission could
        obtain (retained prefix blocks are evicted on demand)."""
        st = self.state
        return {"free_blocks": st.allocator.free_blocks,
                "retained_blocks": st.retained_blocks,
                "headroom_blocks": st.headroom_blocks,
                "free_slots": st.free_slots,
                "total_blocks": st.allocator.num_blocks - 1}

    def set_speculative(self, enabled: bool) -> bool:
        """Turn speculative decoding on or off between steps (it cannot be
        turned on where the config never configured it); off routes
        ``step()`` through the plain decode. Returns the previous setting."""
        prev = self._spec_on
        self._spec_on = bool(enabled) and bool(self.config.speculative.enabled)
        return prev

    def park(self, uid: int) -> Dict[str, Any]:
        """Preempt a sequence: capture what continuing it needs, then
        release its slot and KV blocks. With the prefix cache on, its full
        blocks park in the retained pool, so :meth:`resume` re-prefills only
        what eviction took in between; with it off, resume re-prefills the
        whole history. The request's trace stays open; an instant marks the
        park."""
        desc = self.state.lookup(uid)
        self._pending_prefill.pop(uid, None)   # mid-split park: chunks stop
        history = list(desc.tokens) if desc.prefilling \
            else list(desc.tokens) + [desc.last_token]
        parked = {"uid": uid, "history": history,
                  "generated": list(desc.generated),
                  "prompt_len": len(history) - len(desc.generated),
                  "sp": self._slot_sp[desc.slot]}
        self._clear_slot(desc.slot)
        self.state.retire(uid)
        if self._trace_on:
            trace, parent = self._trace_parent(uid)
            self.tracer.instant("parked", cat="serving", trace=trace, parent=parent,
                                uid=uid, kv_tokens=len(history))
        return parked

    def resume(self, parked: Dict[str, Any], seed: int = 0,
               split: bool = False) -> List[int]:
        """Re-admit a :meth:`park`-ed sequence and continue its stream: the
        full history is re-prefilled (through the prefix cache when on) and
        the token sampled next is the next stream token, so a greedy
        park / resume cycle equals an uninterrupted run. Returns the tokens
        emitted now: one for a one-shot resume, ``[]`` with ``split=True``
        (the token then arrives from a later ``step()``). ``finish()``
        returns the complete stream."""
        uid, sp = parked["uid"], parked["sp"]
        history = parked["history"]
        if split:
            self.put_split(uid, history, sp)
            self.state.seqs[uid].generated = list(parked["generated"])
            self._resume_instant(uid, split=True)
            return []
        tok = self.put(uid, history, sp, seed=seed)
        self.state.seqs[uid].generated = list(parked["generated"]) + [tok]
        self._resume_instant(uid, split=False)
        return [tok]

    def _resume_instant(self, uid: int, split: bool) -> None:
        if self._trace_on:
            trace, parent = self._trace_parent(uid)
            self.tracer.instant("resumed", cat="serving", trace=trace, parent=parent,
                                uid=uid, split=split)

    def fork(self, uid: int, new_uid: int, sp: Optional[SamplingParams] = None):
        """Fork a live sequence: ``new_uid`` decodes from the same context
        without copying a KV byte. Both share every block, the partial tail
        included; whichever appends first gets a private copy (copy-on-
        write). The child starts with an empty ``generated`` and, unless
        ``sp`` is given, the parent's sampling params."""
        desc = self.state.fork(uid, new_uid)
        self._req_admit(new_uid, desc.seen_tokens)
        parent_slot = self.state.seqs[uid].slot
        self._activate(desc, desc.last_token, self.state.block_table(desc),
                       self._canon_sp(sp) if sp is not None
                       else self._slot_sp[parent_slot])
        return desc

    # ------------------------------------------------------------------ #
    # disaggregated prefill → decode handoff: export reads a sequence's
    # full chain-hashed blocks off the pools (optionally re-coded to int8 +
    # scales), import lands them in the destination's retained prefix pool
    # under the same chain hashes, and the parked request resumes there as
    # an admission-time prefix hit
    # ------------------------------------------------------------------ #
    def kv_chain_hashes(self, uid: int) -> List[bytes]:
        """Chain hashes of ``uid``'s full KV blocks, indexing newly full
        blocks first."""
        desc = self.state.lookup(uid)
        self.state.mark_filled(desc)
        return list(desc.block_hashes)

    def resident_prefix(self, chain_hashes: List[bytes]) -> int:
        """How many LEADING entries of ``chain_hashes`` are already canonical
        in this engine's prefix index (the blocks a handoff need not ship)."""
        if not self.state.prefix_cache:
            return 0
        return len(self.state.index.match(list(chain_hashes)))

    def export_kv_blocks(self, uid: int, skip: int = 0, wire: str = "native",
                         wire_group: int = 64) -> Dict[str, Any]:
        """Read ``uid``'s full KV blocks after ``skip`` off the pools as host
        arrays (numpy; CPU bfloat16 tensors for bf16 leaves) for a handoff.
        Call it while the sequence is tracked (before ``park``).

        Wire formats: ``"native"`` — the cache leaves verbatim (on a
        quantized-KV engine already int8 codes + fp32 group scales);
        ``"int8"`` — a float engine re-codes k/v to int8 codes + fp32
        per-``wire_group`` scales (the KV formula of
        ``ops.quantization.kv_quantize_int8``, bit for bit the JAX engine's
        payload on the same blocks); on a quantized engine an alias of
        ``"native"``.

        Returns ``{"uid", "hashes", "skip", "blocks", "wire_bytes",
        "bf16_equiv_bytes", "block_wire_bytes"}``: ``bf16_equiv_bytes`` is
        what the blocks cost as 2-byte k/v, ``block_wire_bytes`` one block's
        wire size (what each skipped block did not cost)."""
        if wire not in ("native", "int8"):
            raise ValueError(f"unknown KV wire format {wire!r}")
        desc = self.state.lookup(uid)
        self.state.mark_filled(desc)
        hashes = list(desc.block_hashes)
        skip = max(0, min(int(skip), len(hashes)))
        quantize = wire == "int8" and not self._kvq_on
        if quantize:
            hd = self.family.cfg.head_size
            wire_group = min(int(wire_group), hd)
            if wire_group < 1 or hd % wire_group:
                raise ValueError(f"wire_group {wire_group} does not divide "
                                 f"head_size {hd}")
        per_block = 0
        for n in sorted(self.cache):
            leaf = self.cache[n]
            elems = leaf.numel() // leaf.shape[1]
            if quantize and n in ("k", "v"):
                per_block += elems + (elems // wire_group) * 4
            else:
                per_block += elems * leaf.element_size()
        blocks: List[Dict[str, Any]] = []
        wire_bytes = 0
        bf16_equiv = 0
        for b in desc.blocks[skip:len(hashes)]:
            payload = {}
            for n in sorted(self.cache):
                x = self.cache[n][:, b]
                if quantize and n in ("k", "v"):
                    codes, scales = kv_quantize_int8(x, wire_group)
                    payload[n], payload[n + "_scale"] = _to_host(codes), _to_host(scales)
                else:
                    payload[n] = _to_host(x)
            # int8 codes mirror the bf16 element count, so k/v sizes give
            # the bf16-equivalent bytes in every wire mode
            bf16_equiv += 2 * (_numel(payload["k"]) + _numel(payload["v"]))
            wire_bytes += sum(a.nbytes for a in payload.values())
            blocks.append(payload)
        return {"uid": uid, "hashes": hashes[skip:], "skip": skip,
                "blocks": blocks, "wire_bytes": wire_bytes,
                "bf16_equiv_bytes": bf16_equiv, "block_wire_bytes": per_block}

    def import_kv_blocks(self, chain_hashes: List[bytes],
                         blocks: List[Dict[str, Any]]) -> Dict[str, int]:
        """Land exported blocks in this engine's retained prefix pool, keyed
        by their chain hashes: a hash already canonical here is deduplicated,
        the rest adopt a retained block (``StateManager.adopt_block``) and
        have the payload written into the pools. A dropped block (pool
        exhausted, retention off) only costs re-prefill at resume. Returns
        ``{"imported", "dedup", "dropped"}``."""
        res = {"imported": 0, "dedup": 0, "dropped": 0}
        for h, payload in zip(chain_hashes, blocks):
            if self.state.prefix_cache and h in self.state.index._by_hash:
                res["dedup"] += 1
                continue
            blk = self.state.adopt_block(h)
            if blk is None:
                res["dropped"] += 1
                continue
            for n, x in zip(sorted(self.cache), self._wire_to_cache(payload)):
                self.cache[n][:, blk] = x
            res["imported"] += 1
        return res

    def _wire_to_cache(self, payload: Dict[str, Any]) -> List[torch.Tensor]:
        """One wire-format block payload → this engine's cache leaves, in
        sorted-key order, on the device. Matching formats pass through bit
        for bit; int8 wire dequantizes into a float pool; float wire (or
        another scale grouping) re-quantizes into a quantized pool at the
        local group size."""
        keys = sorted(self.cache)
        dev = self.device
        wired_int8 = "k_scale" in payload
        if self._kvq_on:
            ng = self.family.cfg.head_size // self._kvq_group
            if wired_int8 and payload["k_scale"].shape[-1] == ng:
                return [_from_host(payload[k], dev) for k in keys]
            conv: Dict[str, torch.Tensor] = {}
            for n in ("k", "v"):
                x = (kv_dequantize_int8(_from_host(payload[n], dev),
                                        _from_host(payload[n + "_scale"], dev))
                     if wired_int8 else _from_host(payload[n], dev))
                conv[n], conv[n + "_scale"] = kv_quantize_int8(x, self._kvq_group)
            return [conv[k] for k in keys]
        if wired_int8:
            dt = self.cache["k"].dtype
            return [kv_dequantize_int8(_from_host(payload[n], dev),
                                       _from_host(payload[n + "_scale"], dev), dtype=dt)
                    for n in keys]
        return [_from_host(payload[k], dev) for k in keys]

    # ------------------------------------------------------------------ #
    # checks and counters: (name, value, step) lists under the JAX engine's
    # names; publishing them waits for the telemetry hub
    # ------------------------------------------------------------------ #
    def prefix_cache_events(self, step: int = 0):
        """``Serving/prefix_cache/*``: the cumulative counters plus the
        retained-pool occupancy."""
        stats = dict(self.state.prefix_stats)
        stats["retained_blocks"] = self.state.retained_blocks
        return [(f"Serving/prefix_cache/{k}", float(v), step)
                for k, v in sorted(stats.items())]

    def kv_quant_events(self, step: int = 0):
        """``Serving/kv_quant/*`` (quantized-KV mode only): blocks resident
        (live and retained), the bytes they do not take against a bf16 pool
        of the same blocks, the per-element dequantization bound
        ``max(scale) / 2``, and ``dequant_fused`` = 1 (the attention kernels
        dequantize in registers)."""
        if not self._kvq_on:
            return []
        resident = (self.state.allocator.num_blocks - 1
                    - self.state.allocator.free_blocks)
        code_elems = scale_elems = 0
        max_scale = 0.0
        for name in ("k", "v"):
            c, s = self.cache[name], self.cache[name + "_scale"]
            code_elems += c.numel() // c.shape[1]          # per-block elements
            scale_elems += s.numel() // s.shape[1]
            max_scale = max(max_scale, float(s.max()))
        saved_per_block = 2 * code_elems - (code_elems + 4 * scale_elems)
        vals = {"blocks_quantized": float(resident),
                "bytes_saved": float(saved_per_block * resident),
                "max_abs_err": 0.5 * max_scale, "dequant_fused": 1.0}
        return [(f"Serving/kv_quant/{k}", float(v), step)
                for k, v in sorted(vals.items())]

    def debug_check_cache(self) -> None:
        """Cache invariants beside ``StateManager.debug_check``: the leaves
        the mode needs and, in quantized-KV mode, int8 codes with fp32
        scales of ``head_size // group_size`` groups per vector, finite and
        non-negative through every block-lifecycle op. Raises
        AssertionError on a violation."""
        keys = set(self.cache)
        if not self._kvq_on:
            assert keys == {"k", "v"}, f"unquantized cache has unexpected leaves {keys}"
            return
        assert keys == {"k", "v", "k_scale", "v_scale"}, \
            f"quantized cache has unexpected leaves {keys}"
        ng = self.family.cfg.head_size // self._kvq_group
        for name in ("k", "v"):
            c, s = self.cache[name], self.cache[name + "_scale"]
            assert c.dtype == torch.int8, f"{name} codes are {c.dtype}"
            assert s.dtype == torch.float32, f"{name} scales are {s.dtype}"
            assert tuple(s.shape) == tuple(c.shape[:-1]) + (ng,), \
                f"{name}_scale shape {tuple(s.shape)} inconsistent with codes " \
                f"{tuple(c.shape)} at group_size {self._kvq_group}"
            smin, smax = float(s.min()), float(s.max())
            assert np.isfinite(smax) and smin >= 0.0, \
                f"{name}_scale range [{smin}, {smax}] invalid"

    def spec_events(self, step: int = 0):
        """``Serving/spec/*``: the cumulative counters plus ``accept_rate``
        (accepted / drafted), ``mean_accepted_len`` (accepted per verify
        step), ``tokens_per_step`` (emitted tokens per live sequence per
        forward) and ``verify_batch_occupancy`` (valid verify positions /
        batch capacity)."""
        s = self.spec_stats
        vals: Dict[str, float] = {k: float(v) for k, v in s.items()}
        vals["accept_rate"] = (s["accepted_tokens"] / s["drafted_tokens"]
                               if s["drafted_tokens"] else 0.0)
        vals["mean_accepted_len"] = (s["accepted_tokens"] / s["verify_steps"]
                                     if s["verify_steps"] else 0.0)
        vals["tokens_per_step"] = (s["emitted_tokens"] / s["step_seqs"]
                                   if s["step_seqs"] else 0.0)
        vals["verify_batch_occupancy"] = (
            s["verify_positions"] / s["verify_capacity"]
            if s["verify_capacity"] else 0.0)
        return [(f"Serving/spec/{k}", float(v), step) for k, v in sorted(vals.items())]

    # ------------------------------------------------------------------ #
    # latency SLOs: TTFT / inter-token latency / queue time / e2e, with
    # p50 / p90 / p99; samples accumulate while tracing is on
    # ------------------------------------------------------------------ #
    def latency_summary(self) -> Dict[str, Dict[str, float]]:
        """{metric: {"p50", "p90", "p99", "mean", "count"}} in ms."""
        out: Dict[str, Dict[str, float]] = {}
        for metric, vals in self._lat.items():
            stats = percentiles(vals, (50, 90, 99))
            stats["count"] = float(len(vals))
            stats["mean"] = (sum(vals) / len(vals)) if vals else 0.0
            out[metric] = stats
        return out

    def latency_events(self, step: int = 0):
        """``Serving/latency/*``: the percentiles and counts of
        :meth:`latency_summary`."""
        events = []
        for metric, stats in sorted(self.latency_summary().items()):
            for key in ("p50", "p90", "p99", "count"):
                events.append((f"Serving/latency/{metric}_{key}", float(stats[key]), step))
        return events

    def export_trace(self, path: str):
        """Dump the flight recorder as Chrome-trace / Perfetto JSON."""
        return self.tracer.export(path)

    # ------------------------------------------------------------------ #
    def generate(self, prompts, max_new_tokens: int = 64,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 prompt_lengths=None, steps_per_sync: int = 1,
                 sampling_params=None) -> List[List[int]]:
        """Continuous-batching driver: admit prompts as capacity allows,
        decode all live sequences each step. Returns generated ids per
        prompt. ``steps_per_sync > 1`` decodes that many tokens per host
        sync through :meth:`step_many` (admission and EOS retirement at
        quantum boundaries, completions trimmed at the first EOS); in spec
        mode each step may emit several tokens and ``steps_per_sync`` is
        subsumed, as in the JAX engine. Prompts longer than one effective
        ``split_prefill_chunk`` enter through :meth:`put_split`.
        ``sampling_params``: optional per-prompt SamplingParams."""
        sp = SamplingParams(temperature=temperature, top_k=top_k, top_p=top_p,
                            greedy=temperature == 0.0)
        if sampling_params is not None:
            if len(sampling_params) != len(prompts):
                raise ValueError(f"{len(sampling_params)} sampling_params for "
                                 f"{len(prompts)} prompts")
            sp_for = list(sampling_params)
        else:
            sp_for = [sp] * len(prompts)
        prompts = [np.asarray(p, np.int32) for p in prompts]
        if prompt_lengths is not None:
            prompts = [p[:n] for p, n in zip(prompts, prompt_lengths)]
        pending = list(enumerate(prompts))
        results: Dict[int, List[int]] = {}
        # reject prompts that can NEVER be admitted instead of spinning
        bs = self.state.block_size
        capacity = self.state.allocator.num_blocks - 1
        for _, p in pending:
            need = (len(p) + bs - 1) // bs + 1
            if need > capacity:
                raise MemoryError(
                    f"prompt of {len(p)} tokens needs {need} KV blocks but the "
                    f"pool only holds {capacity}; raise ragged.memory_config_blocks")
        split = self.config.split_prefill_chunk
        # a prompt that fits one EFFECTIVE chunk gains nothing from the
        # split path and stays in the batched one-shot burst
        eff_chunk = _round_up(split, self.config.prefill_bucket) if split > 0 else 0
        step_i = 0
        while pending or self.state.seqs:
            batch_adm, batch_cached = [], []
            while pending and self.state.can_admit(len(pending[0][1])):
                uid, prompt = pending.pop(0)
                if split > 0 and len(prompt) > eff_chunk:
                    self.put_split(uid, prompt, sp_for[uid])
                    continue
                desc, hit = self.state.admit_prompt(uid, prompt)
                batch_adm.append((uid, prompt, desc))
                batch_cached.append(hit)
            if batch_adm:  # one prefill for the whole burst
                self._prefill_admitted(
                    batch_adm, [sp_for[uid] for uid, _, _ in batch_adm],
                    seed=seed, cached=batch_cached)
            if steps_per_sync > 1 and not self._spec_on:
                k = max(1, min(steps_per_sync, max_new_tokens))
                self.step_many(k, seed=seed + step_i)
                step_i += k
            else:
                self.step(seed=seed + step_i)
                step_i += 1
            for uid in list(self.state.seqs):
                d = self.state.seqs[uid]
                if d.prefilling:
                    continue  # no tokens yet
                if eos_token_id is not None and eos_token_id in d.generated:
                    # a verify step or a quantum may emit tokens past the
                    # first EOS
                    d.generated = d.generated[:d.generated.index(eos_token_id) + 1]
                    d.last_token = d.generated[-1]
                hit_eos = eos_token_id is not None and d.last_token == eos_token_id
                if len(d.generated) >= max_new_tokens or hit_eos or \
                        d.seen_tokens >= self.family.cfg.max_seq_len:
                    d.generated = d.generated[:max_new_tokens]
                    results[uid] = self.finish(uid)
        return [results[i] for i in range(len(prompts))]


def build_engine_v2(model, model_cfg, params: Mapping[str, Any], config=None,
                    device="cuda", **kwargs) -> InferenceEngineV2:
    """Counterpart of the JAX ``build_engine_v2``: ``model`` is the family's
    module (``deepspeed_tpu_torch.models.llama`` or ``.gpt``), ``params`` its
    ``state_dict`` (the family's ``init`` or ``models.convert.from_jax_params``).
    Runs on the GPU unless ``device="cpu"`` is asked for."""
    if isinstance(config, dict) or config is None:
        config = InferenceConfig.from_dict({**(config or {}), **kwargs})
    family = ModelFamily.from_module(model, model_cfg)
    return InferenceEngineV2(family, params, config, device=device)
