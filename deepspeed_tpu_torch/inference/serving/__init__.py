"""Serving layer above ``InferenceEngineV2`` — counterpart of
``deepspeed_tpu/inference/serving/``:

- :mod:`.scheduler` — Orca/FastGen-style continuous-batching request
  scheduler: priority/deadline queue, admission control against KV-block
  headroom, SLO-aware batch composition (chunked prefill interleaved with
  decode), decode preemption with park/resume, streaming token output;
- :mod:`.router` — multi-replica front door: prefix-cache-affinity
  placement via the chain-hash prefix index, load-based fallback, and a
  drain/remove path for replica loss;
- :mod:`.workload` — seeded open-loop traffic generation: Poisson/bursty/
  diurnal arrivals, multi-turn sessions, mixed prompt/gen-length
  distributions, tenant mixes;
- :mod:`.fleet` — fleet resilience (``serving.fleet`` config block,
  default OFF): per-replica circuit breakers over tick faults/hangs,
  crash failover with token-exact stream replay, and a hysteresis-guarded
  overload degradation ladder (shed → spec off → clamp);
- :mod:`.disagg` — disaggregated prefill/decode tiers (``serving.disagg``
  config block, default OFF): prefill replicas hand finished prompts to
  decode replicas as chain-hash-keyed paged-KV block transfers, absorbed
  via the destination's prefix cache.

The whole layer drives the engine through its public API (``put``,
``put_split``, ``step``, ``step_many``, ``park``, ``resume``, ``finish``),
so serving WITHOUT a scheduler is the engine alone. The fleet
observability plane (``serving.obs``) and online tuning
(``serving.tuning``) are not ported: their blocks parse, and enabling
either raises ``NotImplementedError``.
"""

from .scheduler import (QUEUED, RUNNING, PARKED, DONE,  # noqa: F401
                        REJECTED, Request, RequestHandle, SchedulerConfig,
                        ServingScheduler)
from .disagg import DisaggConfig  # noqa: F401
from .fleet import (CircuitBreaker, DegradationLadder,  # noqa: F401
                    FleetConfig)
from .router import ReplicaRouter, RouterConfig  # noqa: F401
from .workload import Arrival, TrafficGenerator, WorkloadConfig  # noqa: F401
