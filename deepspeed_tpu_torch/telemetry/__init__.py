"""Telemetry of the port — counterpart of ``deepspeed_tpu/telemetry/``.

Ported: the span tracer with its flight recorder (:mod:`.trace`), which
engine v2's request-trace plane and the serving scheduler write to, and the
config blocks of the fleet observability plane (:mod:`.fleet`), which parse
as in the JAX package and refuse to be enabled. The telemetry hub, the
fleet plane itself, the time-series store and the anomaly detector are not
ported yet.
"""

from .fleet import FleetObsConfig, TsdbConfig  # noqa: F401
from .trace import TraceConfig, Tracer, dump_all, percentiles  # noqa: F401
