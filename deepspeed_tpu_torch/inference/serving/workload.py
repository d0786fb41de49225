"""Seeded traffic generation for serving benchmarks and tests — a copy of
``deepspeed_tpu/inference/serving/workload.py``: the same config draws the
same arrivals, element by element, from the same numpy generator.

Open-loop arrival processes (Poisson, bursty, and a diurnally modulated
Poisson with optional burst overlay — the shape of a million-user trace
compressed onto a bench timescale), multi-turn sessions whose follow-up
prompts extend the previous turn's history (the prefix cache's natural
workload) with optionally heavy-tailed (lognormal) per-session turn
budgets, multi-tenant priority mixes, and the three prompt shapes the
serving bench exercises: ``random`` (closed-loop steady state),
``shared_prefix`` (N clients behind one long system prompt), and
``repetitive`` (the prompt-lookup drafter's best case). Everything is
derived from one seeded ``numpy`` Generator, so the same config replays
the same trace — scheduler-ON vs hand-rolled-loop comparisons see
identical traffic.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .scheduler import Request

Span = Union[int, Tuple[int, int]]


def _span(v: Span) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


@dataclasses.dataclass
class WorkloadConfig:
    """One synthetic traffic mix. Lengths are either a fixed int or an
    inclusive ``(lo, hi)`` uniform range."""

    seed: int = 0
    vocab_size: int = 256
    # arrival process: "poisson" (exponential inter-arrivals at rate_rps),
    # "bursty" (burst_size simultaneous arrivals every burst_interval_s),
    # or "diurnal" (Poisson whose rate swings sinusoidally around rate_rps
    # by ±diurnal_amplitude over diurnal_period_s — Lewis-Shedler thinning,
    # so the trace stays exactly reproducible from the seed)
    process: str = "poisson"
    rate_rps: float = 8.0
    burst_size: int = 4
    burst_interval_s: float = 1.0
    diurnal_amplitude: float = 0.5   # rate swing fraction, clamped to [0,1]
    diurnal_period_s: float = 60.0
    # burst overlay: ride burst_size extra simultaneous arrivals every
    # burst_interval_s ON TOP of a poisson/diurnal base process (flash
    # crowds over the daily curve); ignored for process="bursty"
    burst_overlay: bool = False
    # prompt shape: "random" | "shared_prefix" | "repetitive". For
    # shared_prefix, prompt_len is the per-request TAIL after the
    # shared_len-token common prefix; for repetitive the prompt tiles a
    # pattern_len-token pattern up to prompt_len.
    prompt_kind: str = "random"
    prompt_len: Span = (16, 32)
    shared_len: int = 0
    pattern_len: int = 6
    gen_len: Span = 8
    # multi-turn sessions: turn t+1's prompt is turn t's prompt + its output
    # + followup_len fresh user tokens, arriving think_time_s after turn t
    # completes (``TrafficGenerator.followup``)
    turns: int = 1
    think_time_s: float = 0.0
    followup_len: Span = 8
    # heavy-tail session lengths: turns_dist="lognormal" draws each
    # SESSION's turn budget as round(lognormal(turns_mu, turns_sigma))
    # clamped to [1, max_turns] at arrival time (most sessions short, a
    # few very long — the observed shape of large chat fleets); "fixed"
    # keeps the constant ``turns`` budget
    turns_dist: str = "fixed"
    turns_mu: float = 0.0
    turns_sigma: float = 1.0
    max_turns: int = 64
    # request SLO fields, stamped onto every generated Request
    priorities: Sequence[int] = (0,)
    deadline_ms: float = math.inf
    eos_token_id: Optional[int] = None
    # billing/SLO tenant tag, stamped onto every generated Request (a fleet
    # observability plane accounts goodput per tenant); None leaves the
    # request untagged
    tenant: Optional[str] = None
    # multi-tenant priority mix: (tenant, weight, priority) rows — each
    # request draws its tenant by weight and inherits that tenant's
    # priority, overriding ``tenant``/``priorities`` when non-empty
    tenant_mix: Sequence[Tuple[str, float, int]] = ()


@dataclasses.dataclass
class Arrival:
    """One request arriving at ``t`` seconds into the trace."""

    t: float
    request: Request
    session_id: int
    turn: int = 1
    # the session's drawn turn budget (turns_dist="lognormal"); None
    # defers to the config's fixed ``turns``
    turns: Optional[int] = None


class TrafficGenerator:
    """Deterministic request stream for one :class:`WorkloadConfig`: call
    :meth:`arrivals` for the open-loop trace, :meth:`prompt_tokens` /
    :meth:`request` for closed-loop drivers that admit on completion, and
    :meth:`followup` to chain multi-turn sessions (the harness feeds each
    finished turn's output back in)."""

    def __init__(self, cfg: WorkloadConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self._sessions = itertools.count(1)
        self.shared_prefix: List[int] = []
        if cfg.prompt_kind == "shared_prefix" and cfg.shared_len > 0:
            self.shared_prefix = self._tokens(cfg.shared_len)
        elif cfg.prompt_kind not in ("random", "shared_prefix", "repetitive"):
            raise ValueError(f"unknown prompt_kind {cfg.prompt_kind!r}")
        if cfg.turns_dist not in ("fixed", "lognormal"):
            raise ValueError(f"unknown turns_dist {cfg.turns_dist!r}")
        if cfg.tenant_mix and any(w <= 0 for _, w, _ in cfg.tenant_mix):
            raise ValueError("tenant_mix weights must be positive")

    # -- primitives ----------------------------------------------------- #
    def _tokens(self, n: int) -> List[int]:
        return self.rng.integers(0, self.cfg.vocab_size, (n,),
                                 dtype=np.int32).tolist()

    def _draw(self, span: Span) -> int:
        lo, hi = _span(span)
        return int(self.rng.integers(lo, hi + 1)) if hi > lo else lo

    def prompt_tokens(self) -> List[int]:
        """One prompt of the configured shape (fresh first-turn prompt)."""
        cfg = self.cfg
        n = self._draw(cfg.prompt_len)
        if cfg.prompt_kind == "shared_prefix":
            return self.shared_prefix + self._tokens(n)
        if cfg.prompt_kind == "repetitive":
            pat = self._tokens(max(1, cfg.pattern_len))
            reps = (n + len(pat) - 1) // len(pat)
            return (pat * reps)[:n]
        return self._tokens(n)

    def gen_tokens(self) -> int:
        return max(1, self._draw(self.cfg.gen_len))

    def session_turns(self) -> int:
        """One session's turn budget under the configured distribution."""
        cfg = self.cfg
        if cfg.turns_dist == "fixed":
            return cfg.turns
        n = int(round(float(self.rng.lognormal(cfg.turns_mu,
                                               cfg.turns_sigma))))
        return max(1, min(cfg.max_turns, n))

    def _tenant_priority(self) -> Tuple[Optional[str], int]:
        cfg = self.cfg
        if cfg.tenant_mix:
            w = np.asarray([r[1] for r in cfg.tenant_mix], dtype=float)
            i = int(self.rng.choice(len(cfg.tenant_mix), p=w / w.sum()))
            name, _, prio = cfg.tenant_mix[i]
            return name, int(prio)
        prio = cfg.priorities[0] if len(cfg.priorities) == 1 else \
            int(self.rng.choice(np.asarray(cfg.priorities)))
        return cfg.tenant, prio

    def request(self, session_id: Optional[int] = None,
                prompt: Optional[List[int]] = None) -> Request:
        cfg = self.cfg
        tenant, prio = self._tenant_priority()
        return Request(prompt=prompt if prompt is not None
                       else self.prompt_tokens(),
                       max_new_tokens=self.gen_tokens(),
                       priority=prio, deadline_ms=cfg.deadline_ms,
                       session_id=session_id,
                       eos_token_id=cfg.eos_token_id,
                       tenant=tenant)

    # -- open-loop trace ------------------------------------------------ #
    def arrivals(self, duration_s: float) -> List[Arrival]:
        """First-turn arrivals in ``[0, duration_s)`` under the configured
        process. Multi-turn follow-ups are NOT pre-materialized (they depend
        on each turn's output) — the harness chains them via
        :meth:`followup`."""
        cfg = self.cfg
        times: List[float] = []
        if cfg.process == "poisson":
            if cfg.rate_rps <= 0:
                raise ValueError("poisson arrivals need rate_rps > 0")
            t = 0.0
            while True:
                t += float(self.rng.exponential(1.0 / cfg.rate_rps))
                if t >= duration_s:
                    break
                times.append(t)
        elif cfg.process == "diurnal":
            # inhomogeneous Poisson via Lewis-Shedler thinning: candidates
            # at the peak rate, kept with probability rate(t)/peak — exact
            # and fully determined by the seed
            if cfg.rate_rps <= 0:
                raise ValueError("diurnal arrivals need rate_rps > 0")
            amp = min(max(float(cfg.diurnal_amplitude), 0.0), 1.0)
            peak = cfg.rate_rps * (1.0 + amp)
            t = 0.0
            while True:
                t += float(self.rng.exponential(1.0 / peak))
                if t >= duration_s:
                    break
                lam = cfg.rate_rps * (1.0 + amp * math.sin(
                    2.0 * math.pi * t / cfg.diurnal_period_s))
                if float(self.rng.random()) * peak <= lam:
                    times.append(t)
        elif cfg.process == "bursty":
            t = 0.0
            while t < duration_s:
                times.extend([t] * cfg.burst_size)
                t += cfg.burst_interval_s
        else:
            raise ValueError(f"unknown arrival process {cfg.process!r}")
        if cfg.burst_overlay and cfg.process != "bursty":
            t = cfg.burst_interval_s
            while t < duration_s:
                times.extend([t] * cfg.burst_size)
                t += cfg.burst_interval_s
            times.sort()
        out = []
        for t in times:
            sid = next(self._sessions)
            out.append(Arrival(t=t, request=self.request(session_id=sid),
                               session_id=sid, turn=1,
                               turns=(None if cfg.turns_dist == "fixed"
                                      else self.session_turns())))
        return out

    def followup(self, arrival: Arrival, output_tokens: Sequence[int],
                 now_s: float) -> Optional[Arrival]:
        """The session's next turn, arriving ``think_time_s`` after the
        previous turn completed at ``now_s``: its prompt is the full history
        (previous prompt + model output) plus fresh user tokens — exactly
        the shape the prefix cache resolves from retained blocks. Returns
        ``None`` once the session has used its turn budget (the arrival's
        drawn heavy-tail budget when set, the config's fixed ``turns``
        otherwise)."""
        budget = arrival.turns if arrival.turns is not None \
            else self.cfg.turns
        if arrival.turn >= budget:
            return None
        history = list(arrival.request.prompt) + list(output_tokens) \
            + self._tokens(self._draw(self.cfg.followup_len))
        req = self.request(session_id=arrival.session_id, prompt=history)
        return Arrival(t=now_s + self.cfg.think_time_s, request=req,
                       session_id=arrival.session_id, turn=arrival.turn + 1,
                       turns=arrival.turns)
