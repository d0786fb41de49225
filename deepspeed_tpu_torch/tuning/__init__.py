"""The ``serving.tuning`` config block — a parse-only copy of
``TunerOptions`` (``deepspeed_tpu/tuning/tuner.py``).

The online tuner itself is not ported: the block parses into the same
options as in the JAX package, and ``ReplicaRouter`` refuses it when
``enabled`` is true (``RouterConfig.unported_features``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass
class TunerOptions:
    """Knob-search options of the ``serving.tuning`` router block."""

    enabled: bool = False
    knobs: Tuple[str, ...] = ()     # () = every knob at this boundary
    steps_per_arm: int = 16         # boundary events per measured window
    window_s: float = 600.0         # max trailing window the score may use
    min_samples: int = 8            # samples required before a verdict
    max_dwell_factor: int = 4       # give up a window after this x dwell
    accept_mads: float = 3.0        # improvement > this many baseline MADs
    min_rel_delta: float = 0.02     # ... AND this fraction of baseline
    recompile_allowance: int = 2    # planned recompiles per arm (guards)
    seed: int = 0                   # arm-order shuffle seed
    persist: bool = True            # write winners to .dstpu_tuned.json
    reload: bool = True             # reload persisted winners (no re-search)
    path: str = ""                  # "" = the default persist resolver

    @classmethod
    def from_any(cls, obj: Any) -> "TunerOptions":
        """Build from anything carrying the same field names (a dict, or
        another TunerOptions)."""
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            src = dict(obj)
            opts = cls()
            for f in dataclasses.fields(cls):
                if f.name in src:
                    setattr(opts, f.name, src.pop(f.name))
            if src:
                raise ValueError(f"unknown tuning option(s): {sorted(src)}")
            opts.knobs = tuple(opts.knobs or ())
            return opts
        opts = cls()
        for f in dataclasses.fields(cls):
            if hasattr(obj, f.name):
                setattr(opts, f.name, getattr(obj, f.name))
        opts.knobs = tuple(opts.knobs or ())
        return opts

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "TunerOptions":
        return cls.from_any(dict(d or {}))
