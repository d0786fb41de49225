"""Span-based tracing with a bounded crash flight recorder — a copy of
``deepspeed_tpu/telemetry/trace.py`` (same classes, ids, ring and export),
kept in the port so that it imports nothing of the JAX package.

- :class:`Tracer` produces monotonic-clock **spans** (name, category,
  trace/span/parent ids, duration, free-form args) and **instant** events.
  Spans nest automatically through a per-thread stack, or explicitly via
  ``trace=``/``parent=`` handles for lifecycles that cross calls (a serving
  request's admit → queue → prefill → decode arc).
- Completed events land in a bounded in-memory ring — the **flight
  recorder**. It holds the last ``ring_size`` events only, so tracing a
  long run costs a fixed few MB, and a crash dump shows the steps that
  *preceded* the failure.
- :meth:`Tracer.dump` exports the ring as Chrome-trace / Perfetto JSON
  (``chrome://tracing``, https://ui.perfetto.dev). Dumps fire on
  fault-injection crashes and ``atexit``: the crash paths call
  :func:`dump_all`, which reaches every live enabled tracer through a
  module registry.

Config: the ``trace`` block of ``InferenceConfig`` (:class:`TraceConfig`).
Default **OFF**: a disabled tracer allocates nothing, records nothing, and
returns a shared null span, so the default serving path is event-free.

Spans and instants are host events: a span around work on a CUDA device
ends where the host ends it, so callers that time device work take the end
after the copy that brings its result to the host.

Deliberately stdlib-only: the serving engine, the fault harness, and
offline tooling all import it, and a trace must be dumpable from any thread
at any point of a dying process.
"""

from __future__ import annotations

import atexit
import json
import math
import os
import tempfile
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence

__all__ = ["TraceConfig", "Tracer", "Span", "NULL_SPAN", "NULL_TRACER",
           "dump_all", "percentiles"]


@dataclass
class TraceConfig:
    """The ``trace`` block of ``InferenceConfig``."""

    enabled: bool = False
    # flight-recorder capacity: completed span/instant events retained
    ring_size: int = 4096
    # dump destination; "" → <tmpdir>/dstpu_trace/flight_<pid>_<name>.json
    export_path: str = ""
    # dump the ring automatically on crash paths (fault-injection crash,
    # atexit)
    dump_on_crash: bool = True


# live enabled tracers, reachable from crash paths that hold no engine
# handle (an injected crash, the atexit backstop)
_ACTIVE: "weakref.WeakSet[Tracer]" = weakref.WeakSet()


def dump_all(reason: str) -> List[str]:
    """Dump every live enabled tracer's flight recorder; returns the paths
    written. Never raises — this runs on paths where the process is dying
    and a tracing failure must not mask the original fault."""
    paths: List[str] = []
    for tr in list(_ACTIVE):
        try:
            p = tr.dump(reason)
        except Exception:
            p = None
        if p:
            paths.append(p)
    return paths


class _NullSpan:
    """Shared no-op span: what a disabled tracer hands out. One instance,
    zero allocation per call."""

    __slots__ = ()
    enabled = False
    trace_id = 0
    span_id = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self, **args):
        pass

    def set(self, **args):
        pass


NULL_SPAN = _NullSpan()


class Span:
    """One open span. Use as a context manager (nests via the tracer's
    per-thread stack) or hold the handle and call :meth:`end` when the
    traced lifecycle completes (cross-call spans, e.g. a serving request)."""

    __slots__ = ("_tracer", "name", "cat", "trace_id", "span_id", "parent_id",
                 "t0_ns", "args", "_tid", "_stacked", "_ended")
    enabled = True

    def __init__(self, tracer: "Tracer", name: str, cat: str, trace_id: int,
                 span_id: int, parent_id: int, args: Dict[str, Any],
                 stacked: bool):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.args = args
        self.t0_ns = time.monotonic_ns()
        self._tid = threading.get_ident()
        self._stacked = stacked
        self._ended = False

    def set(self, **args) -> None:
        """Attach/overwrite args on an open span."""
        self.args.update(args)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False

    def end(self, **args) -> None:
        if self._ended:
            return
        self._ended = True
        if args:
            self.args.update(args)
        self._tracer._finish(self)


class Tracer:
    """See module docstring. ``cfg`` is any object carrying the
    :class:`TraceConfig` attributes (``InferenceConfig.trace`` qualifies); ``None`` or ``enabled: false`` yields a disabled tracer
    whose every operation is a cheap no-op."""

    def __init__(self, cfg=None, name: str = "trace"):
        self.cfg = cfg if cfg is not None else TraceConfig()
        self.name = name
        self.enabled = bool(getattr(self.cfg, "enabled", False))
        self.ring_size = max(16, int(getattr(self.cfg, "ring_size", 4096)
                                     or 4096))
        self.export_path = str(getattr(self.cfg, "export_path", "") or "")
        self.dump_on_crash = bool(getattr(self.cfg, "dump_on_crash", True))
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=self.ring_size)
        self._lock = threading.Lock()
        self._next_id = 1
        self._tls = threading.local()
        self._pid = os.getpid()
        self.last_dump: Optional[str] = None
        if self.enabled:
            self._default_trace = self._new_id()
            _ACTIVE.add(self)
            if self.dump_on_crash:
                atexit.register(self._atexit_dump)
        else:
            self._default_trace = 0

    # ------------------------------------------------------------------ #
    def _new_id(self) -> int:
        with self._lock:
            i = self._next_id
            self._next_id += 1
        return i

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def new_trace(self, label: Optional[str] = None) -> int:
        """Allocate a fresh trace id (one per request/run/lifecycle)."""
        if not self.enabled:
            return 0
        tid = self._new_id()
        if label:
            self.instant("trace_begin", cat="meta", trace=tid, label=label)
        return tid

    # ------------------------------------------------------------------ #
    def span(self, name: str, cat: str = "app", trace: Optional[int] = None,
             parent: Optional[int] = None, **args):
        """Open a span. Used as a context manager it nests under the
        enclosing span of the same thread; ``trace``/``parent`` override
        for explicit lifecycles."""
        if not self.enabled:
            return NULL_SPAN
        st = self._stack()
        if parent is None and st:
            parent = st[-1].span_id
            if trace is None:
                trace = st[-1].trace_id
        sp = Span(self, name, cat, trace or self._default_trace,
                  self._new_id(), parent or 0, args, stacked=True)
        st.append(sp)
        return sp

    def begin(self, name: str, cat: str = "app", trace: Optional[int] = None,
              parent: Optional[int] = None, **args):
        """Open a NON-stacked span whose end is a later, separate call —
        the cross-call form (a serving request open across engine steps).
        The caller owns the handle and must call ``span.end()``."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, cat, trace or self._default_trace,
                    self._new_id(), parent or 0, args, stacked=False)

    def complete(self, name: str, t0_ns: int, t1_ns: int, cat: str = "app",
                 trace: Optional[int] = None, parent: Optional[int] = None,
                 **args) -> None:
        """Record a span with EXPLICIT monotonic-ns endpoints — for
        intervals measured around a batched operation and attributed to
        several traces (e.g. one compiled prefill serving many requests)."""
        if not self.enabled:
            return
        rec = {"ph": "X", "name": name, "cat": cat, "ts_ns": int(t0_ns),
               "dur_ns": max(0, int(t1_ns) - int(t0_ns)),
               "tid": threading.get_ident(),
               "trace": trace or self._default_trace,
               "span": self._new_id(), "parent": parent or 0, "args": args}
        with self._lock:
            self._ring.append(rec)

    def instant(self, name: str, cat: str = "app",
                trace: Optional[int] = None, parent: Optional[int] = None,
                ts_ns: Optional[int] = None, **args) -> None:
        """Record a zero-duration marker event."""
        if not self.enabled:
            return
        st = self._stack()
        if parent is None and st:
            parent = st[-1].span_id
            if trace is None:
                trace = st[-1].trace_id
        rec = {"ph": "i", "name": name, "cat": cat,
               "ts_ns": time.monotonic_ns() if ts_ns is None else int(ts_ns),
               "tid": threading.get_ident(),
               "trace": trace or self._default_trace,
               "span": self._new_id(), "parent": parent or 0,
               "args": args}
        with self._lock:
            self._ring.append(rec)

    def _finish(self, sp: Span) -> None:
        if sp._stacked:
            st = self._stack()
            # tolerate out-of-order exits (an exception unwinding through
            # several spans): pop everything above sp too
            while st and st[-1] is not sp:
                st.pop()
            if st:
                st.pop()
        rec = {"ph": "X", "name": sp.name, "cat": sp.cat, "ts_ns": sp.t0_ns,
               "dur_ns": max(0, time.monotonic_ns() - sp.t0_ns),
               "tid": sp._tid, "trace": sp.trace_id, "span": sp.span_id,
               "parent": sp.parent_id, "args": sp.args}
        with self._lock:
            self._ring.append(rec)

    # ------------------------------------------------------------------ #
    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of the flight-recorder ring (oldest first)."""
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def to_chrome(self, reason: str = "export") -> Dict[str, Any]:
        """Render the ring as a Chrome-trace / Perfetto JSON object
        (``ts``/``dur`` in microseconds on the monotonic clock)."""
        evs = []
        for r in self.events():
            e = {"name": r["name"], "cat": r["cat"], "ph": r["ph"],
                 "ts": r["ts_ns"] / 1e3, "pid": self._pid, "tid": r["tid"],
                 "args": dict(r["args"])}
            e["args"]["trace_id"] = r["trace"]
            e["args"]["span_id"] = r["span"]
            if r["parent"]:
                e["args"]["parent_id"] = r["parent"]
            if r["ph"] == "X":
                e["dur"] = r["dur_ns"] / 1e3
            else:
                e["s"] = "t"
            evs.append(e)
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": {"tool": "deepspeed_tpu_torch.telemetry.trace",
                              "reason": reason, "name": self.name,
                              "pid": self._pid,
                              "wall_time": time.time(),
                              "monotonic_ns": time.monotonic_ns()}}

    def dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Write the flight recorder to disk; returns the path (None when
        disabled or empty). Overwrites — each dump is a full snapshot."""
        if not self.enabled or not len(self._ring):
            return None
        path = path or self.export_path or os.path.join(
            tempfile.gettempdir(), "dstpu_trace",
            f"flight_{self._pid}_{self.name}.json")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(reason), f)
        self.last_dump = path
        return path

    def export(self, path: str) -> Optional[str]:
        return self.dump("export", path=path)

    def _atexit_dump(self) -> None:
        try:
            self.dump("atexit")
        except Exception:
            pass

    def close(self, dump: bool = True) -> None:
        """Shutdown: final dump (when configured), deregister from the
        crash-path registry and atexit. Idempotent; a closed tracer is
        indistinguishable from a disabled one."""
        if not self.enabled:
            return
        if dump and self.dump_on_crash:
            try:
                self.dump("close")
            except Exception:
                pass
        if self.dump_on_crash:
            try:
                atexit.unregister(self._atexit_dump)
            except Exception:
                pass
        _ACTIVE.discard(self)
        self.enabled = False


#: shared disabled tracer for call sites that may have no engine handle
NULL_TRACER = Tracer(None, name="null")


# --------------------------------------------------------------------------- #
def percentiles(values: Sequence[float],
                qs: Iterable[int] = (50, 90, 99)) -> Dict[str, float]:
    """Nearest-rank percentiles of ``values`` → ``{"p50": ..., ...}``.
    Empty input yields zeros (callers print "no samples" from the count)."""
    out: Dict[str, float] = {}
    if not values:
        return {f"p{q}": 0.0 for q in qs}
    s = sorted(values)
    n = len(s)
    for q in qs:
        k = max(1, math.ceil(q / 100.0 * n)) - 1
        out[f"p{q}"] = float(s[min(k, n - 1)])
    return out
