"""The config blocks of the fleet observability plane — parse-only copies
of ``FleetObsConfig`` (``deepspeed_tpu/telemetry/fleet.py``) and its
``TsdbConfig`` (``deepspeed_tpu/telemetry/tsdb.py``).

The plane itself (cross-replica request tracing, per-tenant SLO accounting
with burn-rate alerting, fleet rollups over a bounded time-series store) is
not ported: a ``serving.obs`` block parses into the same config as in the
JAX package, and ``ReplicaRouter`` refuses it when ``enabled`` is true
(``RouterConfig.unported_features``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict


@dataclasses.dataclass
class TsdbConfig:
    """The ``serving.obs.tsdb`` sub-block: level-0 bucket width, ring
    capacity per level, downsampling levels and fanout, series cap."""

    resolution_s: float = 1.0
    points_per_level: int = 360
    levels: int = 3
    fanout: int = 10
    max_series: int = 256

    @classmethod
    def from_dict(cls, d) -> "TsdbConfig":
        if isinstance(d, cls):
            return d
        d = dict(d or {})
        known = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        unknown = set(d) - set(known)
        if unknown:
            raise ValueError(
                f"unknown serving.obs.tsdb key(s): {sorted(unknown)}")
        return cls(**known)


@dataclasses.dataclass
class FleetObsConfig:
    """The ``serving.obs`` config block (default OFF; not ported)."""

    enabled: bool = False
    # mint TraceContexts at submit when any replica tracer is enabled
    trace_requests: bool = True
    # per-tenant SLO accounting + burn-rate alerting
    default_slo_target: float = 0.99
    slo_targets: Dict[str, float] = dataclasses.field(default_factory=dict)
    burn_fast_window_s: float = 60.0
    burn_slow_window_s: float = 300.0
    burn_threshold: float = 2.0
    max_tenants: int = 64
    sample_cap: int = 2048
    # fleet aggregation: replica straggler threshold
    outlier_frac: float = 0.25
    tsdb: TsdbConfig = dataclasses.field(default_factory=TsdbConfig)
    clock: Callable[[], float] = time.monotonic

    @classmethod
    def from_dict(cls, d) -> "FleetObsConfig":
        """Build from a config-tree dict, e.g. ``{"enabled": true,
        "burn_threshold": 4, "tsdb": {"resolution_s": 0.5}}``."""
        if isinstance(d, cls):
            return d
        d = dict(d or {})
        tsdb = TsdbConfig.from_dict(d.pop("tsdb", {}))
        known = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        unknown = set(d) - set(known)
        if unknown:
            raise ValueError(
                f"unknown serving.obs key(s): {sorted(unknown)}")
        return cls(tsdb=tsdb, **known)
