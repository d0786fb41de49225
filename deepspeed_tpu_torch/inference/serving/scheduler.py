"""Continuous-batching serving scheduler — counterpart of
``deepspeed_tpu/inference/serving/scheduler.py``, over the port's
``InferenceEngineV2``.

Orca/FastGen-style request scheduling above ``InferenceEngineV2``: callers
``submit()`` requests and drive ``tick()`` (or ``run()``); the scheduler owns
admission, batch composition, preemption, and completion. Design points:

- **Priority/deadline queue.** A binary heap ordered by ``(priority,
  absolute deadline, arrival)`` — lower priority number is more urgent, ties
  break toward the earlier deadline, then FIFO. A bounded lookahead lets
  small requests bypass a blocked head-of-line request without starving it.
- **Admission control against KV headroom.** A request is admitted only when
  a sequence slot is free and ``StateManager.blocks_needed(prompt)`` fits the
  current ``headroom_blocks`` (free + retained-evictable) minus a configured
  reserve — budgeted cumulatively across a tick's admission burst, so a
  batched ``put_many`` can never over-commit the pool. Requests that could
  NEVER complete (prompt + generation outgrows the pool or ``max_seq_len``)
  are rejected at submit instead of thrashing forever.
- **SLO-aware batch composition.** With the engine's Dynamic-SplitFuse
  chunking enabled, long prompts are admitted via ``put_split`` so ongoing
  decodes never stall more than one chunk; short prompts batch into one
  ``put_many`` prefill per sampling config.
- **Decode preemption.** Before each decode quantum the scheduler asks
  ``StateManager.growth_blocks_short`` whether the next tokens' block needs
  (fresh tails AND copy-on-write) exceed headroom; if so, the least urgent
  live request is ``park()``-ed — its KV parks in the prefix cache's
  retained pool when enabled — and re-queued for ``resume()`` under its
  original priority/deadline. A greedy preempt/resume cycle is
  token-identical to an uninterrupted run (pinned by tests).
- **Streaming output.** Each submit returns a :class:`RequestHandle` whose
  ``drain()``/``on_token`` surface tokens as the engine emits them.

The scheduler drives the engine exclusively through its public API (``put``,
``put_split``, ``step``, ``step_many``, ``park``, ``resume``, ``finish``) —
serving WITHOUT a scheduler runs the exact pre-scheduler engine code. On a
CUDA device every decode the scheduler asks for is a replay of the engine's
decode graph; the scheduler itself is host code between those calls.

Not ported: ``publish_sched_telemetry`` (it writes to the telemetry hub),
and the fleet observability and online-tuning seams, which a router with
``serving.obs`` / ``serving.tuning`` enabled would attach (the port's router
refuses both blocks).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ...telemetry.trace import percentiles
from ..engine import _round_up
from ..ragged import UnknownSequenceError
from ..sampling import SamplingParams

QUEUED = "queued"
RUNNING = "running"
PARKED = "parked"
DONE = "done"
REJECTED = "rejected"


@dataclasses.dataclass
class Request:
    """One serving request. ``priority`` is lower-is-more-urgent;
    ``deadline_ms`` is the end-to-end SLO measured from ``submit()`` (used
    for queue ordering, optional expiry, and goodput-under-SLO accounting).
    ``uid`` is assigned at submit when left ``None``."""

    prompt: List[int]
    max_new_tokens: int = 64
    priority: int = 0
    deadline_ms: float = math.inf
    session_id: Optional[int] = None
    eos_token_id: Optional[int] = None
    sp: SamplingParams = SamplingParams(greedy=True)
    uid: Optional[int] = None
    # the billing/SLO tenant tag, and a cross-replica trace handle the
    # engine's next admission of this request joins (both default None; no
    # serving path of the port mints a handle)
    tenant: Optional[str] = None
    trace_ctx: Optional[Any] = None


class RequestHandle:
    """Streaming view of one submitted request: ``tokens`` grows as the
    engine emits, ``drain()`` returns the tokens since the last drain, and
    an optional ``on_token(token)`` callback fires per token. Terminal
    states set ``e2e_ms``/``slo_met``; ``error`` carries the rejection
    reason for :data:`REJECTED` handles."""

    def __init__(self, request: Request,
                 on_token: Optional[Callable[[int], None]] = None):
        self.request = request
        self.uid = request.uid
        self.state = QUEUED
        self.tokens: List[int] = []
        self.on_token = on_token
        self.error: Optional[str] = None
        self.queue_wait_ms: Optional[float] = None
        self.e2e_ms: Optional[float] = None
        self.slo_met: Optional[bool] = None
        self.preemptions = 0
        self.replica: Optional[int] = None   # stamped by ReplicaRouter
        self.kv_wire_bytes = 0   # disagg handoff wire traffic (router)
        self._cursor = 0
        self._submit_t: Optional[float] = None
        self._deadline_t = math.inf

    @property
    def done(self) -> bool:
        return self.state in (DONE, REJECTED)

    def drain(self) -> List[int]:
        new = self.tokens[self._cursor:]
        self._cursor = len(self.tokens)
        return new

    def _emit(self, toks: List[int]) -> int:
        room = self.request.max_new_tokens - len(self.tokens)
        eos = self.request.eos_token_id
        emitted = 0
        for t in toks[:max(0, room)]:
            self.tokens.append(t)
            emitted += 1
            if self.on_token is not None:
                self.on_token(t)
            if eos is not None and t == eos:
                break
        return emitted

    @property
    def finished_stream(self) -> bool:
        eos = self.request.eos_token_id
        return len(self.tokens) >= self.request.max_new_tokens or \
            (eos is not None and bool(self.tokens) and self.tokens[-1] == eos)


@dataclasses.dataclass
class SchedulerConfig:
    max_live: int = 0                # concurrent sequences; 0 = engine slots
    reserve_blocks: int = 0          # headroom kept back from admissions
    decode_quantum: int = 1          # fused decode ticks per scheduler tick
    preempt: bool = True             # allow decode preemption under pressure
    admission_lookahead: int = 4     # queue entries scanned past a blocked head
    max_admissions_per_tick: int = 0  # 0 = unlimited
    drop_expired: bool = False       # reject queued requests past deadline
    clock: Callable[[], float] = time.monotonic  # injectable for tests


class ServingScheduler:
    """See module docstring. One scheduler owns one engine; multi-replica
    serving composes schedulers behind :class:`~.router.ReplicaRouter`."""

    def __init__(self, engine, config: Optional[SchedulerConfig] = None):
        self.engine = engine
        self.cfg = config or SchedulerConfig()
        self.tracer = engine.tracer
        self._trace_on = engine.tracer.enabled
        self._clock = self.cfg.clock
        self._heap: List[Tuple[int, float, int, dict]] = []
        self._arrival = itertools.count()
        self._uids = itertools.count(1)
        self.handles: Dict[int, RequestHandle] = {}   # queued + live
        self._live: Dict[int, RequestHandle] = {}
        self.stats: Dict[str, int] = {
            "submitted": 0, "admitted": 0, "resumed": 0, "preempted": 0,
            "rejected": 0, "expired": 0, "completed": 0, "slo_met": 0,
            "slo_missed": 0, "ticks": 0, "chunked_admissions": 0,
            "tokens_emitted": 0}
        self._queue_wait_ms: List[float] = []
        self._e2e_ms: List[float] = []
        self._t0 = self._clock()
        # overload degradation (fleet.DegradationLadder level 3): when set,
        # every admission's max_new_tokens is clamped to this many tokens
        # (never below what the stream already emitted). None = no clamp —
        # the default path never consults it.
        self.degrade_max_new_tokens: Optional[int] = None

    # -- queue ----------------------------------------------------------- #
    @property
    def queue_depth(self) -> int:
        return sum(1 for *_, e in self._heap if e["valid"])

    @property
    def live_count(self) -> int:
        return len(self._live)

    @property
    def pending(self) -> bool:
        """Work remains: anything queued, parked, or live."""
        return bool(self._live) or self.queue_depth > 0

    def _push(self, handle: RequestHandle,
              parked: Optional[Dict[str, Any]] = None) -> None:
        entry = {"handle": handle, "parked": parked, "valid": True}
        heapq.heappush(self._heap, (handle.request.priority,
                                    handle._deadline_t,
                                    next(self._arrival), entry))

    def submit(self, request: Request,
               on_token: Optional[Callable[[int], None]] = None
               ) -> RequestHandle:
        """Enqueue one request → its streaming handle. Requests that can
        never be served — empty prompt, prompt at/over ``max_seq_len``, or a
        worst-case completion footprint larger than the whole KV pool — are
        rejected immediately (``state=REJECTED``, reason in ``error``)
        instead of wedging the queue."""
        if request.uid is None:
            request.uid = next(self._uids)
        handle = RequestHandle(request, on_token=on_token)
        now = self._clock()
        handle._submit_t = now
        handle._deadline_t = now + request.deadline_ms / 1e3 \
            if math.isfinite(request.deadline_ms) else math.inf
        self.stats["submitted"] += 1
        reason = self._reject_reason(request)
        if reason is not None:
            handle.state = REJECTED
            handle.error = reason
            self.stats["rejected"] += 1
            return handle
        self.handles[request.uid] = handle
        self._push(handle)
        return handle

    def _reject_reason(self, req: Request) -> Optional[str]:
        st = self.engine.state
        max_len = self.engine.family.cfg.max_seq_len
        capacity = st.allocator.num_blocks - 1
        if not req.prompt:
            return "empty prompt"
        if len(req.prompt) >= max_len:
            return (f"prompt of {len(req.prompt)} tokens >= max_seq_len "
                    f"{max_len}")
        if st.blocks_needed(len(req.prompt)) > capacity:
            return (f"prompt needs {st.blocks_needed(len(req.prompt))} KV "
                    f"blocks but the pool holds {capacity}")
        # worst-case single-request footprint: a park right before the last
        # token resumes with a history of total-1 tokens — if even that
        # admission can't fit an EMPTY pool, the request would thrash
        # park/resume forever instead of completing
        total = min(len(req.prompt) + req.max_new_tokens, max_len)
        if st.blocks_needed(total - 1) > capacity:
            return (f"completion footprint of {total} tokens "
                    f"({st.blocks_needed(total - 1)} blocks worst-case) can "
                    f"never fit the {capacity}-block pool")
        return None

    # -- router drain support -------------------------------------------- #
    def evict_all(self) -> List[Tuple[RequestHandle,
                                      Optional[Dict[str, Any]]]]:
        """Drain this scheduler (replica removal): park every live sequence
        and pop every queued entry, returning ``(handle, parked)`` pairs the
        router re-homes on surviving replicas via :meth:`accept` — the SAME
        handle objects keep streaming, and parked histories re-prefill on
        the new replica (KV never crosses engines; token history does)."""
        out: List[Tuple[RequestHandle, Optional[Dict[str, Any]]]] = []
        for uid, h in list(self._live.items()):
            parked = self.engine.park(uid)
            if h.request.trace_ctx is not None:
                # cross-replica move: close this engine's leg of the fleet
                # trace (park alone leaves it open for a SAME-engine resume)
                self.engine.release_trace(uid, reason="drain")
            h.state = PARKED
            h.preemptions += 1
            del self._live[uid]
            self.handles.pop(uid, None)
            out.append((h, parked))
        while self._heap:
            *_, entry = heapq.heappop(self._heap)
            if not entry["valid"]:
                continue
            h = entry["handle"]
            self.handles.pop(h.request.uid, None)
            out.append((h, entry["parked"]))
        return out

    def accept(self, handle: RequestHandle,
               parked: Optional[Dict[str, Any]] = None) -> None:
        """Enqueue a request that already has a handle (router re-homing
        after a drain or failover). Keeps the original submit time and
        deadline."""
        handle.state = QUEUED
        self.handles[handle.request.uid] = handle
        self._push(handle, parked=parked)

    def export_live(self, uid: int) -> Tuple[RequestHandle,
                                             Dict[str, Any]]:
        """Detach ONE live sequence for a disaggregated prefill→decode
        handoff: park it, close this replica's trace leg as a handoff, and
        hand back ``(handle, parked)`` for the router to :meth:`accept` on
        the decode-tier replica. The caller exports KV blocks BEFORE calling
        this — park retires the sequence, after which its uid is unknown
        here. Unlike :meth:`evict_all` this is the PLANNED move of the
        two-tier pipeline, not a preemption, so the handle's preemption
        count is untouched."""
        h = self._live.pop(uid)
        parked = self.engine.park(uid)
        if h.request.trace_ctx is not None:
            self.engine.release_trace(uid, reason="handoff")
        h.state = PARKED
        self.handles.pop(uid, None)
        return h, parked

    def abandon_all(self) -> List[Tuple[RequestHandle,
                                        Optional[Dict[str, Any]]]]:
        """Evict every request WITHOUT engine cooperation — the crash/hang
        failover counterpart of :meth:`evict_all`. Live continuations are
        reconstructed from each handle's CLIENT-VISIBLE stream (prompt + the
        tokens already emitted) instead of ``engine.park``, so a crashed or wedged engine is never
        asked to do anything on the failover path; its host bookkeeping is
        cleaned best-effort so a recovered replica starts empty. Streams
        that already emitted their full budget finalize as DONE here.
        Exactly-once delivery: the parked ``generated`` list carries every
        token the handle emitted, so ``engine.resume`` on the survivor
        continues the stream without re-emitting any of them — and a greedy
        replay of prompt + emitted history regenerates exactly the next
        stream token (token-identical failover, parity-pinned)."""
        out: List[Tuple[RequestHandle, Optional[Dict[str, Any]]]] = []
        for uid, h in list(self._live.items()):
            del self._live[uid]
            self.handles.pop(uid, None)
            # release BEFORE engine.finish: a stream leaving mid-flight must
            # end its replica leg tagged as a handoff, not as a normal
            # finish (finished streams keep the normal span-end path)
            if h.request.trace_ctx is not None and not h.finished_stream:
                try:
                    self.engine.release_trace(uid, reason="failover")
                except Exception:
                    pass
            try:
                self.engine.finish(uid)   # frees slot + blocks when the
            except Exception:             # engine still works (hang/slow);
                pass                      # a truly crashed engine may leak
                                          # until the breaker re-probes it
            if h.finished_stream:
                self._finalize(h)
                continue
            h.state = PARKED
            h.preemptions += 1
            out.append((h, {"uid": uid,
                            "history": list(h.request.prompt)
                            + list(h.tokens),
                            "generated": list(h.tokens),
                            "prompt_len": len(h.request.prompt),
                            "sp": h.request.sp}))
        while self._heap:
            *_, entry = heapq.heappop(self._heap)
            if not entry["valid"]:
                continue
            h = entry["handle"]
            self.handles.pop(h.request.uid, None)
            out.append((h, entry["parked"]))
        return out

    def shed(self, min_priority: int, reason: str) -> List[RequestHandle]:
        """Reject every QUEUED, not-yet-started request whose priority is
        ``min_priority`` or lower-urgency (higher number) — the degradation
        ladder's level-1 action. Requests that already consumed compute
        (parked/preempted histories) are spared: shedding admissions first
        loses the least work. Returns the shed handles."""
        out: List[RequestHandle] = []
        for *_, entry in self._heap:
            h = entry["handle"]
            if not entry["valid"] or entry["parked"] is not None or \
                    h.request.priority < min_priority:
                continue
            entry["valid"] = False
            self.handles.pop(h.request.uid, None)
            h.state = REJECTED
            h.error = reason
            h.slo_met = False
            self.stats["rejected"] += 1
            out.append(h)
        return out

    # -- the scheduling loop --------------------------------------------- #
    def tick(self, seed: Optional[int] = None) -> Dict[int, List[int]]:
        """One scheduler quantum: expire (optional) → admit/resume →
        preempt-guard → one engine step (or fused ``decode_quantum``) →
        stream tokens → retire completions. Returns {uid: tokens emitted
        this tick} for the requests that produced output."""
        self.stats["ticks"] += 1
        if seed is None:
            seed = self.stats["ticks"]
        t0 = time.monotonic_ns() if self._trace_on else 0
        now = self._clock()
        if self.cfg.drop_expired:
            self._expire(now)
        n_adm = self._admit(now, seed)
        n_pre = self._preempt_guard()
        out = self._step_engine(seed)
        emitted = self._harvest(out)
        self._retire()
        if self._trace_on:
            self.tracer.complete(
                "sched_tick", t0, time.monotonic_ns(), cat="serving",
                admitted=n_adm, preempted=n_pre, live=len(self._live),
                queued=self.queue_depth,
                tokens=sum(len(v) for v in emitted.values()))
        return emitted

    def run(self, max_ticks: int = 100000) -> None:
        """Drive ticks until every submitted request is done (or the tick
        budget, a runaway backstop, is spent)."""
        ticks = 0
        while self.pending and ticks < max_ticks:
            self.tick()
            ticks += 1
        if self.pending:
            raise RuntimeError(
                f"scheduler did not drain within {max_ticks} ticks "
                f"({len(self._live)} live, {self.queue_depth} queued)")

    def _expire(self, now: float) -> None:
        for *_, entry in self._heap:
            h = entry["handle"]
            if entry["valid"] and now > h._deadline_t:
                entry["valid"] = False
                self.handles.pop(h.request.uid, None)
                h.state = REJECTED
                h.error = "deadline expired in queue"
                h.slo_met = False
                self.stats["expired"] += 1
                self.stats["slo_missed"] += 1

    def _admit(self, now: float, seed: int) -> int:
        """Admit while slots + block headroom allow, most urgent first with
        bounded lookahead past a blocked head. One-shot prefills batch into
        one ``put_many`` per sampling config; long prompts (and resumes of
        long histories) take the chunked ``put_split`` path so live decodes
        keep ticking. The block budget decrements per admission, so the
        whole burst can never over-commit the pool."""
        eng, cfg = self.engine, self.cfg
        st = eng.state
        max_live = cfg.max_live or st.max_sequences
        budget = st.headroom_blocks - cfg.reserve_blocks
        slots = st.free_slots
        split = eng.config.split_prefill_chunk
        eff_chunk = _round_up(split, eng.config.prefill_bucket) if split > 0 else 0
        batches: Dict[SamplingParams, List[Tuple[int, List[int]]]] = {}
        stash: List[Tuple[int, float, int, dict]] = []
        admitted = 0
        skipped = 0
        while self._heap and slots > 0 and len(self._live) + admitted \
                < max_live:
            if cfg.max_admissions_per_tick and \
                    admitted >= cfg.max_admissions_per_tick:
                break
            item = heapq.heappop(self._heap)
            entry = item[3]
            if not entry["valid"]:
                continue
            h = entry["handle"]
            parked = entry["parked"]
            if self.degrade_max_new_tokens is not None:
                # overload clamp (degradation level 3): shorten what this
                # admission may generate, never below what it already
                # emitted — the stream stays exactly-once, just shorter
                h.request.max_new_tokens = min(
                    h.request.max_new_tokens,
                    max(self.degrade_max_new_tokens, len(h.tokens)))
            tokens = parked["history"] if parked else h.request.prompt
            need = st.blocks_needed(len(tokens))
            if need > budget:
                stash.append(item)
                skipped += 1
                if skipped > cfg.admission_lookahead:
                    break
                continue
            budget -= need
            slots -= 1
            admitted += 1
            uid = h.request.uid
            if h.request.trace_ctx is not None:
                eng.adopt_trace(uid, h.request.trace_ctx)
            h.state = RUNNING
            self._live[uid] = h
            if h.queue_wait_ms is None:
                h.queue_wait_ms = (now - h._submit_t) * 1e3
                self._queue_wait_ms.append(h.queue_wait_ms)
            if parked is not None:
                toks = eng.resume(parked, seed=seed,
                                  split=split > 0 and len(tokens) > eff_chunk)
                h._emit(toks)
                self.stats["resumed"] += 1
            elif split > 0 and len(tokens) > eff_chunk:
                eng.put_split(uid, tokens, h.request.sp)
                self.stats["chunked_admissions"] += 1
                self.stats["admitted"] += 1
            else:
                batches.setdefault(h.request.sp, []).append((uid, tokens))
                self.stats["admitted"] += 1
        for item in stash:
            heapq.heappush(self._heap, item)
        for sp, pairs in batches.items():
            first = eng.put_many(pairs, sp, seed=seed)
            for uid, tok in first.items():
                self.handles[uid]._emit([tok])
        return admitted

    def _preempt_guard(self) -> int:
        """Park the least urgent live requests until the next decode
        quantum's block needs fit headroom — admission control's runtime
        counterpart: with the guard, a decode step can never surface a
        pool-exhausted allocation to a request."""
        if not self.cfg.preempt:
            return 0
        st = self.engine.state
        n = max(1, self.cfg.decode_quantum)
        preempted = 0
        while len(self._live) > 1 and st.growth_blocks_short(n=n) > 0:
            victim = self._pick_victim()
            if victim is None:
                break
            preempted += 1
            self._park_to_queue(victim)
        return preempted

    def _pick_victim(self) -> Optional[RequestHandle]:
        """Least urgent live request: highest priority number, then latest
        deadline, then most recently admitted (prefilling sequences are
        spared — parking one discards chunk work for no freed decode
        pressure)."""
        best = None
        for uid, h in self._live.items():
            d = self.engine.state.seqs.get(uid)
            if d is None or d.prefilling:
                continue
            key = (h.request.priority, h._deadline_t, uid)
            if best is None or key > best[0]:
                best = (key, h)
        return best[1] if best else None

    def preempt(self, uid: int) -> None:
        """Explicitly park one live request and re-queue it (tests,
        draining, manual intervention)."""
        h = self._live.get(uid)
        if h is None:
            raise UnknownSequenceError(uid)
        self._park_to_queue(h)

    def _park_to_queue(self, h: RequestHandle) -> None:
        uid = h.request.uid
        parked = self.engine.park(uid)
        del self._live[uid]
        h.state = PARKED
        h.preemptions += 1
        self.stats["preempted"] += 1
        self._push(h, parked=parked)
        if self._trace_on:
            self.tracer.instant("sched_preempt", cat="serving", uid=uid,
                                kv_tokens=len(parked["history"]))

    def _step_engine(self, seed: int):
        if not self.engine.state.seqs:
            return {}
        if self.cfg.decode_quantum > 1 and not self.engine._spec_on:
            return self.engine.step_many(self.cfg.decode_quantum, seed=seed)
        return self.engine.step(seed=seed)

    def _harvest(self, out) -> Dict[int, List[int]]:
        emitted: Dict[int, List[int]] = {}
        for uid, t in out.items():
            h = self._live.get(uid)
            if h is None:
                continue
            toks = list(t) if isinstance(t, list) else [t]
            n = h._emit(toks)
            if n:
                emitted[uid] = h.tokens[-n:]
                self.stats["tokens_emitted"] += n
        return emitted

    def _retire(self) -> None:
        max_len = self.engine.family.cfg.max_seq_len
        for uid, h in list(self._live.items()):
            d = self.engine.state.seqs.get(uid)
            if d is None:
                continue
            if d.prefilling:
                continue
            if h.finished_stream or d.seen_tokens >= max_len:
                self.engine.finish(uid)
                del self._live[uid]
                self.handles.pop(uid, None)
                self._finalize(h)

    def _finalize(self, h: RequestHandle) -> None:
        """Mark a stream complete: terminal state, e2e latency, SLO and
        goodput accounting (shared by :meth:`_retire` and
        :meth:`abandon_all`)."""
        h.state = DONE
        h.e2e_ms = (self._clock() - h._submit_t) * 1e3
        h.slo_met = h.e2e_ms <= h.request.deadline_ms
        self._e2e_ms.append(h.e2e_ms)
        self.stats["completed"] += 1
        self.stats["slo_met" if h.slo_met else "slo_missed"] += 1

    # -- telemetry -------------------------------------------------------- #
    def sched_events(self, step: int = 0):
        """``Serving/sched/*`` telemetry events: cumulative scheduler
        counters, the queue-depth gauge, queue-wait percentiles, and
        goodput-under-SLO (requests completed within their deadline, as a
        fraction of completions and as a rate), under the JAX package's
        names."""
        vals: Dict[str, float] = {k: float(v) for k, v in self.stats.items()}
        vals["queue_depth"] = float(self.queue_depth)
        qw = percentiles(self._queue_wait_ms, (50, 90, 99))
        for k, v in qw.items():
            vals[f"queue_wait_ms_{k}"] = float(v)
        vals["queue_wait_ms_count"] = float(len(self._queue_wait_ms))
        done = self.stats["completed"]
        vals["goodput_frac"] = (self.stats["slo_met"] / done) if done else 0.0
        elapsed = max(self._clock() - self._t0, 1e-9)
        vals["goodput_rps"] = self.stats["slo_met"] / elapsed
        return [(f"Serving/sched/{k}", float(v), step)
                for k, v in sorted(vals.items())]

    def queue_wait_summary(self) -> Dict[str, float]:
        out = percentiles(self._queue_wait_ms, (50, 90, 99))
        out["count"] = float(len(self._queue_wait_ms))
        return out
