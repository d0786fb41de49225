from .config import (InferenceConfig, KVQuantConfig,  # noqa: F401
                     PrefixCacheConfig, RaggedConfig, SpeculativeConfig,
                     TPConfig, check_ported)
from .engine import InferenceEngine, ModelFamily  # noqa: F401
from .engine_v2 import InferenceEngineV2, build_engine_v2  # noqa: F401
from .ragged import (BlockedAllocator, PrefixBlockIndex,  # noqa: F401
                     SequenceDescriptor, StateManager, UnknownSequenceError)
from .engine_v2 import prompt_lookup_draft  # noqa: F401
from .sampling import (SamplingParams, filter_logits,  # noqa: F401
                       filter_logits_batch, sample, sp_arrays)
from .serving import (DisaggConfig, FleetConfig,  # noqa: F401
                      ReplicaRouter, Request, RequestHandle, RouterConfig,
                      SchedulerConfig, ServingScheduler, TrafficGenerator,
                      WorkloadConfig)
