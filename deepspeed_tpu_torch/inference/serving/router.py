"""Multi-replica serving router — counterpart of
``deepspeed_tpu/inference/serving/router.py``.

N engines — each behind its own :class:`~.scheduler.ServingScheduler` —
behind one front door. Placement is **prefix-cache-affinity first**: the
router chain-hashes the prompt's full blocks (the same
``PrefixBlockIndex.chain_hashes`` keys the engines index under) and probes
every replica's prefix index for the longest cached match, so a follow-up
turn lands on the replica that already holds its session's KV blocks — the
hit costs block-table writes instead of prefill compute. When no replica
holds a usable prefix (or the affinity winner is overloaded past a
configured slack), placement falls back to least-loaded. ``drain()``
removes a replica (planned maintenance): its queued AND live requests move
to the survivors with their handles intact — live sequences are parked, and
their token histories re-prefill on the new replica (KV never crosses
engines; host-side history does).

With the ``serving.fleet`` block enabled (:class:`~.fleet.FleetConfig`,
default OFF — the no-fleet path is byte-identical to pre-fleet behavior),
the router also survives the *ungraceful* exits: per-replica circuit
breakers open after consecutive tick faults (crashes or deadline-blowing
hangs) and ``fail_over()`` re-homes the failed replica's requests onto
survivors by replaying prompt + already-emitted tokens through the
park/resume seam — token-identical greedy streams, exactly-once delivery —
while a hysteresis-guarded degradation ladder sheds load under KV/queue
pressure instead of letting the pool collapse.

With the ``serving.disagg`` block enabled (:class:`~.disagg.DisaggConfig`,
default OFF — the single-tier router is byte-identical with it off), the
pool splits into a prefill tier and a decode tier: admissions land only on
prefill replicas, and each sequence that finishes its prompt is handed off
to a decode replica as a chain-hash-keyed paged-KV block transfer
(``engine.export_kv_blocks`` → ``engine.import_kv_blocks``) over the
half-width int8 wire format, with destination-resident shared prefixes
deduplicated off the wire. The parked request then resumes on the decode
replica through the prefix cache — an admit-time hit — so greedy streams
stay token-identical across the handoff.

The ``serving.obs`` (fleet observability plane) and ``serving.tuning``
(online tuning) blocks parse into the same configs as in the JAX package;
enabling either raises ``NotImplementedError`` when the router is built
(:meth:`RouterConfig.unported_features`), as the engine does for its
unported config blocks.

The router catches ``Exception`` around a replica's tick, the disagg
export and the import (counted as ``import_failures``), as the JAX router
does: that is how the fleet survives an injected ``ReplicaCrash``. On a
CUDA device the same handlers would also turn a kernel's error into a
failover or a re-prefill, so a caller that must see such errors reads
``fleet_stats["tick_faults"]`` and ``disagg_stats["import_failures"]``
after the run.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence

from ...telemetry.fleet import FleetObsConfig
from ...tuning import TunerOptions
from ..ragged import PrefixBlockIndex
from .disagg import DisaggConfig
from .fleet import CLOSED, OPEN, CircuitBreaker, DegradationLadder, FleetConfig
from .scheduler import REJECTED, Request, RequestHandle, ServingScheduler


@dataclasses.dataclass
class RouterConfig:
    affinity: bool = True          # chain-hash prefix-index placement
    session_sticky: bool = True    # fall back to the session's last replica
    # an affinity/sticky winner is honored only while its load (live +
    # queued) exceeds the least-loaded replica by at most this many requests
    load_slack: int = 8
    # fleet resilience (circuit breakers, failover, overload degradation) —
    # default OFF: the router behaves exactly as before this block existed
    fleet: FleetConfig = dataclasses.field(default_factory=FleetConfig)
    # fleet observability plane (cross-replica tracing, tenant SLO
    # accounting, tsdb) — default OFF; parsed, not ported
    obs: FleetObsConfig = dataclasses.field(default_factory=FleetObsConfig)
    # disaggregated prefill/decode tiers (disagg.py) — default OFF likewise
    disagg: DisaggConfig = dataclasses.field(default_factory=DisaggConfig)
    # online self-tuning of serving knobs — default OFF; parsed, not ported
    tuning: TunerOptions = dataclasses.field(default_factory=TunerOptions)

    @classmethod
    def from_dict(cls, d) -> "RouterConfig":
        """Build from a config-tree dict, e.g. ``{"load_slack": 4,
        "fleet": {"enabled": true, "failure_threshold": 2}}`` — the
        ``serving.fleet`` block lands on :attr:`fleet`, the
        ``serving.obs`` block on :attr:`obs`, the ``serving.disagg``
        block on :attr:`disagg`, the ``serving.tuning`` block on
        :attr:`tuning`."""
        if isinstance(d, cls):
            return d
        d = dict(d or {})
        fleet = FleetConfig.from_dict(d.pop("fleet", {}))
        obs = FleetObsConfig.from_dict(d.pop("obs", {}))
        disagg = DisaggConfig.from_dict(d.pop("disagg", {}))
        tuning = TunerOptions.from_dict(d.pop("tuning", {}))
        known = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        unknown = set(d) - set(known)
        if unknown:
            raise ValueError(f"unknown serving router key(s): "
                             f"{sorted(unknown)}")
        return cls(fleet=fleet, obs=obs, disagg=disagg, tuning=tuning,
                   **known)

    def unported_features(self) -> List[str]:
        """Enabled blocks the port does not implement yet."""
        on = {"serving.obs": self.obs.enabled,
              "serving.tuning": self.tuning.enabled}
        return [name for name, enabled in on.items() if enabled]


def check_ported(config: RouterConfig) -> None:
    """Raise ``NotImplementedError`` naming every enabled router block the
    port does not implement yet."""
    missing = config.unported_features()
    if missing:
        raise NotImplementedError(
            f"not yet ported to deepspeed_tpu_torch: {', '.join(missing)}")


class ReplicaRouter:
    """See module docstring. Drive with ``submit()`` + ``step()`` (one
    scheduler tick per active replica) or ``run()``."""

    def __init__(self, schedulers: Sequence[ServingScheduler],
                 config: Optional[RouterConfig] = None):
        if not schedulers:
            raise ValueError("router needs at least one replica")
        self.replicas: List[ServingScheduler] = list(schedulers)
        self.cfg = config or RouterConfig()
        check_ported(self.cfg)
        self._active = [True] * len(self.replicas)
        self._uids = itertools.count(1)
        self._session_replica: Dict[int, int] = {}
        self.stats: Dict[str, int] = {
            "requests": 0, "affinity_hits": 0, "session_hits": 0,
            "load_fallbacks": 0, "reject_fallbacks": 0, "drains": 0}
        # fleet resilience state: one breaker + one degradation ladder per
        # replica. Constructed unconditionally (cheap) but consulted ONLY
        # when cfg.fleet.enabled — the disabled router never reads them.
        fc = self.cfg.fleet
        self._health: List[CircuitBreaker] = [
            CircuitBreaker(fc) for _ in self.replicas]
        self._ladders: List[DegradationLadder] = [
            DegradationLadder(fc, s, on_shed=self._count_shed)
            for s in self.replicas]
        self.fleet_stats: Dict[str, int] = {
            "failovers": 0, "replayed_tokens": 0, "tick_faults": 0,
            "slow_ticks": 0, "probe_ticks": 0, "circuit_open": 0,
            "circuit_half_open": 0, "circuit_closed": 0, "shed_requests": 0}
        # disaggregated prefill/decode (disagg.py): replicas
        # [0, num_prefill) are the prefill tier, the rest decode. An empty
        # _prefill_tier set means single-tier (the pre-disagg router).
        dc = self.cfg.disagg
        self._prefill_tier: frozenset = frozenset()
        self._session_decode: Dict[int, int] = {}
        self.disagg_stats: Dict[str, int] = {
            "handoffs": 0, "blocks_shipped": 0, "wire_bytes": 0,
            "bf16_equiv_bytes": 0, "dedup_blocks": 0,
            "dedup_bytes_saved": 0, "import_dropped": 0,
            "import_failures": 0, "handoff_fallbacks": 0,
            "tier_fallbacks": 0}
        if dc.enabled:
            if not 1 <= dc.num_prefill < len(self.replicas):
                raise ValueError(
                    f"serving.disagg.num_prefill {dc.num_prefill} must "
                    f"leave at least one replica in each tier "
                    f"({len(self.replicas)} replicas)")
            for k, s in enumerate(self.replicas):
                if not s.engine.state.prefix_cache:
                    raise ValueError(
                        f"serving.disagg requires prefix_cache enabled on "
                        f"every replica (replica {k} has it off) — the "
                        f"KV handoff lands in the retained prefix pool")
            self._prefill_tier = frozenset(range(dc.num_prefill))

    # -- placement -------------------------------------------------------- #
    def _active_idx(self) -> List[int]:
        idx = [i for i, a in enumerate(self._active) if a]
        if not idx:
            raise RuntimeError("all replicas drained — nowhere to route")
        return idx

    def _placeable_idx(self) -> List[int]:
        """Active replicas that may take NEW work: all of them pre-fleet;
        with fleet health tracking on, only those whose circuit breaker is
        CLOSED (an open/half-open replica must pass its probe first)."""
        active = self._active_idx()
        if not self.cfg.fleet.enabled:
            return active
        return [i for i in active if self._health[i].state == CLOSED]

    def load(self, i: int) -> int:
        sched = self.replicas[i]
        return sched.live_count + sched.queue_depth

    def affinity_tokens(self, i: int, prompt: Sequence[int]) -> int:
        """Tokens of ``prompt`` replica ``i`` could resolve from its prefix
        index right now (0 when its cache is off or nothing matches)."""
        st = self.replicas[i].engine.state
        if not st.prefix_cache:
            return 0
        bs = st.block_size
        n = max(0, (len(prompt) - 1) // bs)   # the admit rule: never all
        if n == 0:
            return 0
        hashes = PrefixBlockIndex.chain_hashes(list(prompt), bs, n)
        return len(st.index.match(hashes)) * bs

    def route(self, request: Request) -> Optional[int]:
        """Pick a replica: longest cached prefix wins while its load stays
        within ``load_slack`` of the least-loaded replica; then session
        stickiness under the same slack; then least-loaded. Returns ``None``
        only when fleet health tracking has every active replica's breaker
        open — the caller sheds instead of placing onto a known-dead
        replica. With disaggregation on, placement is restricted to the
        prefill tier; when no prefill replica can take work the decode
        tier absorbs admissions (counted as ``tier_fallbacks`` — degraded
        to monolithic rather than rejecting)."""
        placeable = self._placeable_idx()
        if self._prefill_tier and placeable:
            pre = [i for i in placeable if i in self._prefill_tier]
            if pre:
                placeable = pre
            else:
                self.disagg_stats["tier_fallbacks"] += 1
        if not placeable:
            return None
        loads = {i: self.load(i) for i in placeable}
        least = min(placeable, key=lambda i: (loads[i], i))
        if self.cfg.affinity:
            best, best_tok = least, 0
            for i in placeable:
                tok = self.affinity_tokens(i, request.prompt)
                if tok > best_tok:
                    best, best_tok = i, tok
            if best_tok > 0:
                if loads[best] - loads[least] <= self.cfg.load_slack:
                    self.stats["affinity_hits"] += 1
                    return best
                self.stats["load_fallbacks"] += 1
                return least
        sid = request.session_id
        if self.cfg.session_sticky and sid is not None:
            i = self._session_replica.get(sid)
            if i is not None and i in loads:
                if loads[i] - loads[least] <= self.cfg.load_slack:
                    self.stats["session_hits"] += 1
                    return i
                self.stats["load_fallbacks"] += 1
        return least

    def _reject(self, request: Request, reason: str,
                on_token: Optional[Callable[[int], None]]) -> RequestHandle:
        """A router-level terminal rejection (no scheduler ever saw it)."""
        handle = RequestHandle(request, on_token=on_token)
        handle.state = REJECTED
        handle.error = reason
        handle.slo_met = False
        self.fleet_stats["shed_requests"] += 1
        return handle

    def submit(self, request: Request,
               on_token: Optional[Callable[[int], None]] = None
               ) -> RequestHandle:
        """Route + submit. uids are router-assigned (globally unique across
        replicas, so a drain/failover can re-home a request without
        collisions); the chosen replica index lands on ``handle.replica``.
        If the chosen scheduler would reject the request at admission
        (footprint vs ITS pool) while another healthy replica has the
        capacity, placement falls over to the next-best replica instead of
        surfacing the rejection to the caller."""
        if request.uid is None:
            request.uid = next(self._uids)
        self.stats["requests"] += 1
        i = self.route(request)
        if i is None:
            return self._reject(request,
                                "no healthy replica (all circuit-open)",
                                on_token)
        fc = self.cfg.fleet
        if fc.enabled and fc.degrade and self._ladders[i].level >= 1 and \
                request.priority >= fc.shed_priority:
            return self._reject(
                request, f"shed by overload degradation "
                f"(level {self._ladders[i].level})", on_token)
        reason = self.replicas[i]._reject_reason(request)
        if reason is not None:
            pool = self._placeable_idx()
            if self._prefill_tier:
                pre = [k for k in pool if k in self._prefill_tier]
                pool = pre or pool
            for j in sorted((k for k in pool if k != i),
                            key=lambda k: (self.load(k), k)):
                if self.replicas[j]._reject_reason(request) is None:
                    i = j
                    self.stats["reject_fallbacks"] += 1
                    break
        handle = self.replicas[i].submit(request, on_token=on_token)
        handle.replica = i
        if request.session_id is not None:
            self._session_replica[request.session_id] = i
        return handle

    # -- driving ----------------------------------------------------------- #
    @property
    def pending(self) -> bool:
        return any(self.replicas[i].pending for i in range(len(self.replicas))
                   if self._active[i])

    def step(self) -> None:
        active = self._active_idx()
        disagg = bool(self._prefill_tier)
        if not self.cfg.fleet.enabled and not disagg:
            for i in active:            # the exact pre-fleet loop: no
                self.replicas[i].tick()  # wrapping, timing, or catching —
            return                       # a tick error propagates unchanged
        for i in active:
            if self.cfg.fleet.enabled:
                ok = self._step_replica(i)
            else:
                self.replicas[i].tick()  # disagg without fleet: a tick
                ok = True                # error still propagates unchanged
            # hand prefill-complete sequences to the decode tier only
            # after a CLEAN tick — a faulted tick already failed the
            # replica over (everything re-homes, nothing double-moves)
            if disagg and ok and i in self._prefill_tier:
                self._drain_prefill(i)

    def _step_replica(self, i: int) -> bool:
        """One health-tracked tick of replica ``i``: honor the breaker
        (skip while OPEN; run the half-open probe when due), drive the
        degradation ladder, then tick with fault + deadline accounting. A
        fault that opens the breaker triggers :meth:`fail_over`. Returns
        whether the replica completed a healthy tick."""
        fc = self.cfg.fleet
        br = self._health[i]
        if br.state == OPEN:
            if not br.allow_probe():
                return False
            self.fleet_stats["circuit_half_open"] += 1
            self.fleet_stats["probe_ticks"] += 1
        if fc.degrade:
            self._ladders[i].update()
        t0 = fc.clock()
        try:
            self.replicas[i].tick()
        except Exception as e:
            self._on_fault(i, f"tick raised {type(e).__name__}: {e}")
            return False
        dt = fc.clock() - t0
        if fc.tick_deadline_s > 0 and dt > fc.tick_deadline_s:
            self._on_fault(i, f"tick took {dt * 1e3:.0f} ms "
                           f"(> {fc.tick_deadline_s * 1e3:.0f} ms deadline)")
            return False
        if fc.slow_tick_s > 0 and dt > fc.slow_tick_s:
            self.fleet_stats["slow_ticks"] += 1
        if br.record_success():
            self.fleet_stats["circuit_closed"] += 1
            self._instant("circuit_closed", replica=i)
        return True

    def _on_fault(self, i: int, reason: str) -> None:
        self.fleet_stats["tick_faults"] += 1
        if self._health[i].record_failure():
            self.fleet_stats["circuit_open"] += 1
            self._instant("circuit_open", replica=i, reason=reason)
            self.fail_over(i, reason=reason)

    def _count_shed(self, handles: List[RequestHandle]) -> None:
        self.fleet_stats["shed_requests"] += len(handles)

    def run(self, max_steps: int = 100000) -> None:
        steps = 0
        while self.pending and steps < max_steps:
            self.step()
            steps += 1
        if self.pending:
            raise RuntimeError(f"router did not drain within {max_steps} "
                               f"steps")

    # -- disaggregated prefill → decode handoff ---------------------------- #
    def _drain_prefill(self, i: int) -> None:
        """Move every prefill-COMPLETE sequence off prefill-tier replica
        ``i`` onto a decode replica. A sequence qualifies once its
        descriptor stops prefilling (the prompt's KV is fully written and
        the first token is out); mid-SplitFuse chunks keep running here."""
        sched = self.replicas[i]
        for uid in list(sched._live):
            desc = sched.engine.state.seqs.get(uid)
            if desc is None or desc.prefilling:
                continue
            self._handoff(i, uid)

    def _pick_decode(self, handle: RequestHandle,
                     hashes: List[bytes]) -> Optional[int]:
        """Decode-tier placement: the session's previous decode replica
        wins while within ``decode_load_slack`` of the least-loaded decode
        replica; then the replica already holding the longest resident
        prefix of ``hashes`` (a fork sibling or refreshed session — those
        blocks never cross the wire); then least-loaded."""
        decode = [k for k in self._placeable_idx()
                  if k not in self._prefill_tier]
        if not decode:
            return None
        loads = {k: self.load(k) for k in decode}
        least = min(decode, key=lambda k: (loads[k], k))
        slack = self.cfg.disagg.decode_load_slack
        sid = handle.request.session_id
        if sid is not None:
            j = self._session_decode.get(sid)
            if j in loads and loads[j] - loads[least] <= slack:
                return j
        best, best_res = least, 0
        for k in decode:
            r = self.replicas[k].engine.resident_prefix(hashes)
            if r > best_res:
                best, best_res = k, r
        if best_res > 0 and loads[best] - loads[least] <= slack:
            return best
        return least

    def _handoff(self, i: int, uid: int) -> bool:
        """Ship one prefill-complete sequence from prefill replica ``i``
        to a decode replica: probe the destination's resident prefix,
        export only the novel block suffix in the configured wire format,
        detach via ``scheduler.export_live`` (park + trace-leg handoff),
        import into the destination's retained prefix pool, and re-enqueue
        the SAME handle there — its resume resolves the imported blocks as
        an admit-time prefix-cache hit (token-exact continuation rides the
        pinned park/resume protocol). With no decode replica available the
        sequence simply keeps decoding where it is (monolithic
        degradation, counted per tick as ``handoff_fallbacks``). A failed
        import is also survivable: the destination re-prefills from token
        history instead (correct, just slower)."""
        dc = self.cfg.disagg
        src = self.replicas[i]
        handle = src.handles.get(uid)
        if handle is None:
            return False
        st = self.disagg_stats
        try:
            hashes = src.engine.kv_chain_hashes(uid)
            j = self._pick_decode(handle, hashes)
            if j is None:
                st["handoff_fallbacks"] += 1
                return False
            dst = self.replicas[j]
            n_res = dst.engine.resident_prefix(hashes)
            exp = src.engine.export_kv_blocks(
                uid, skip=n_res, wire=dc.wire, wire_group=dc.wire_group)
        except Exception as e:
            # a replica that died between its tick and the export: with
            # health tracking on this is a fault like any other (the
            # request re-homes with everything else); without it the
            # error surfaces unchanged, matching tick semantics
            if self.cfg.fleet.enabled:
                self._on_fault(i, f"kv export raised "
                               f"{type(e).__name__}: {e}")
                return False
            raise
        handle, parked = src.export_live(uid)
        imp = {"imported": 0, "dedup": 0, "dropped": 0}
        try:
            imp = dst.engine.import_kv_blocks(exp["hashes"], exp["blocks"])
        except Exception:
            st["import_failures"] += 1
        dst.accept(handle, parked=parked)
        handle.replica = j
        handle.kv_wire_bytes += exp["wire_bytes"]
        st["handoffs"] += 1
        st["blocks_shipped"] += len(exp["blocks"])
        st["wire_bytes"] += exp["wire_bytes"]
        st["bf16_equiv_bytes"] += exp["bf16_equiv_bytes"]
        dedup = n_res + imp["dedup"]
        st["dedup_blocks"] += dedup
        st["dedup_bytes_saved"] += dedup * exp["block_wire_bytes"]
        st["import_dropped"] += imp["dropped"]
        sid = handle.request.session_id
        if sid is not None:
            self._session_decode[sid] = j
        self._instant("kv_handoff", uid=uid, src=i, dst=j,
                      blocks=len(exp["blocks"]),
                      wire_bytes=exp["wire_bytes"], dedup_blocks=dedup)
        return True

    # -- replica loss ------------------------------------------------------ #
    def _rehome(self, moved, exclude: int, reason: str) -> int:
        """Place ``(handle, parked)`` pairs on the best surviving replicas
        (same handle objects — streams continue after the re-prefill of each
        parked history). Prefers breaker-CLOSED survivors, falls back to any
        active survivor, and — failover only — re-queues on the failed
        replica itself when it is the sole member (its breaker probe may
        recover it; nothing is silently dropped). With disaggregation on,
        prefill-tier survivors are preferred: a re-homed request needs its
        history re-prefilled, which is the prefill tier's job — it then
        hands off to the decode tier again like any fresh admission (a
        dead DECODE replica's streams fail over token-exactly through the
        same path)."""
        targets = [i for i in self._placeable_idx() if i != exclude]
        if self._prefill_tier:
            pre = [i for i in targets if i in self._prefill_tier]
            if pre:
                targets = pre
        fallback = [i for i in self._active_idx() if i != exclude]
        n = 0
        for handle, parked in moved:
            pool = targets or fallback
            if not pool and self._active[exclude]:
                pool = [exclude]        # sole replica: wait for recovery
            j = min(pool, key=lambda k: (self.load(k), k))
            self.replicas[j].accept(handle, parked=parked)
            handle.replica = j
            n += 1
            if parked is not None:
                self.fleet_stats["replayed_tokens"] += len(parked["history"])
            sid = handle.request.session_id
            if sid is not None:
                self._session_replica[sid] = j
        if n:
            self._instant("rehome", replica=exclude, moved=n, reason=reason)
        return n

    def drain(self, idx: int) -> int:
        """Remove replica ``idx`` PERMANENTLY (planned maintenance or
        scale-down): stop placing onto it, park its live sequences through
        the engine, and re-home every queued/parked/live request onto the
        surviving replicas. Returns the number of requests moved."""
        if not self._active[idx]:
            raise ValueError(f"replica {idx} is already drained")
        self._active[idx] = False
        self.stats["drains"] += 1
        if not any(self._active):
            self._active[idx] = True
            self.stats["drains"] -= 1
            raise ValueError("cannot drain the last active replica")
        for sid, i in list(self._session_replica.items()):
            if i == idx:
                del self._session_replica[sid]
        for sid, i in list(self._session_decode.items()):
            if i == idx:
                del self._session_decode[sid]
        moved = self.replicas[idx].evict_all()
        return self._rehome(moved, exclude=idx, reason="drain")

    def fail_over(self, idx: int, reason: str = "replica fault") -> int:
        """Crash/hang failover — :meth:`drain` generalized to a replica
        whose engine can no longer be trusted: re-home its queued AND live
        requests onto survivors WITHOUT the failed engine's cooperation
        (``scheduler.abandon_all`` reconstructs each live stream from the
        handle's prompt + already-emitted tokens; ``resume`` on the survivor
        re-prefills that history, chunked when the destination runs
        SplitFuse). Greedy streams continue token-identically with
        exactly-once delivery (parity-pinned). Unlike ``drain``, the replica
        stays registered: its circuit breaker's half-open probe re-admits it
        for new placements once it recovers. Returns the requests moved."""
        if not self._active[idx]:
            raise ValueError(f"replica {idx} is already drained")
        for sid, i in list(self._session_replica.items()):
            if i == idx:
                del self._session_replica[sid]
        for sid, i in list(self._session_decode.items()):
            if i == idx:
                del self._session_decode[sid]
        moved = self.replicas[idx].abandon_all()
        self.fleet_stats["failovers"] += 1
        n = self._rehome(moved, exclude=idx, reason=reason)
        self._instant("failover", replica=idx, moved=n, reason=reason)
        return n

    # -- telemetry --------------------------------------------------------- #
    def _instant(self, name: str, **kw) -> None:
        """Failover/degradation instants land in the first replica's tracer
        that is enabled."""
        for sched in self.replicas:
            if sched.tracer.enabled:
                sched.tracer.instant(name, cat="serving", **kw)
                return

    def router_events(self, step: int = 0):
        """``Serving/router/*`` telemetry events, under the JAX package's
        names (publishing them waits for the telemetry hub)."""
        vals = {k: float(v) for k, v in self.stats.items()}
        vals["replicas"] = float(sum(self._active))
        return [(f"Serving/router/{k}", float(v), step)
                for k, v in sorted(vals.items())]

    def fleet_events(self, step: int = 0):
        """``Serving/fleet/*`` telemetry events: failover/replay counters,
        circuit-breaker transition counts, shed requests, and the live
        degradation-level / broken-replica gauges. Empty with the fleet
        block disabled (no-events parity pin)."""
        if not self.cfg.fleet.enabled:
            return []
        vals = {k: float(v) for k, v in self.fleet_stats.items()}
        vals["degrade_level"] = float(max(
            (lad.level for lad in self._ladders), default=0))
        vals["degrade_shifts"] = float(sum(
            lad.shifts for lad in self._ladders))
        vals["broken_replicas"] = float(sum(
            1 for i, a in enumerate(self._active)
            if a and self._health[i].state != CLOSED))
        return [(f"Serving/fleet/{k}", float(v), step)
                for k, v in sorted(vals.items())]

    def disagg_events(self, step: int = 0):
        """``Serving/disagg/*`` telemetry events: handoff/wire counters
        (wire bytes vs the bf16-equivalent footprint, chain-hash dedup
        savings, import drops) plus tier-shape gauges and the cumulative
        ``wire_ratio`` headline (≈0.5 with the int8 wire at realistic head
        sizes). Empty with the disagg block disabled (no-events parity
        pin)."""
        if not self.cfg.disagg.enabled:
            return []
        vals = {k: float(v) for k, v in self.disagg_stats.items()}
        bf16 = vals["bf16_equiv_bytes"]
        vals["wire_ratio"] = vals["wire_bytes"] / bf16 if bf16 else 0.0
        vals["prefill_replicas"] = float(sum(
            1 for i in self._prefill_tier if self._active[i]))
        vals["decode_replicas"] = float(sum(
            1 for i, a in enumerate(self._active)
            if a and i not in self._prefill_tier))
        return [(f"Serving/disagg/{k}", float(v), step)
                for k, v in sorted(vals.items())]
