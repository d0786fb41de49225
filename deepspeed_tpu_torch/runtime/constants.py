"""Config key constants and defaults.

A copy of ``deepspeed_tpu/runtime/constants.py``,
kept in the port so that it imports nothing of the JAX package.

Mirrors the role of the reference's ``runtime/constants.py``: the canonical JSON
key names users put in their config file, so configs written for the reference
map 1:1 onto this framework.
"""

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

OPTIMIZER = "optimizer"
SCHEDULER = "scheduler"

FP16 = "fp16"
BF16 = "bf16"
GRADIENT_CLIPPING = "gradient_clipping"
ZERO_OPTIMIZATION = "zero_optimization"

STEPS_PER_PRINT = "steps_per_print"
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
MEMORY_BREAKDOWN = "memory_breakdown"

PRESCALE_GRADIENTS = "prescale_gradients"
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
SPARSE_GRADIENTS = "sparse_gradients"

TENSOR_PARALLEL = "tensor_parallel"
SEQUENCE_PARALLEL_SIZE = "sequence_parallel_size"
PIPELINE = "pipeline"
EXPERT_PARALLEL_SIZE = "expert_parallel_size"

MESH = "mesh"

COMMS_LOGGER = "comms_logger"
COMMS_OVERLAP = "comms_overlap"

ZERO_STAGE_0 = 0
ZERO_STAGE_1 = 1
ZERO_STAGE_2 = 2
ZERO_STAGE_3 = 3

OFFLOAD_CPU = "cpu"
OFFLOAD_NVME = "nvme"
OFFLOAD_NONE = "none"

ROUTE_TRAIN = "train"
ROUTE_EVAL = "eval"
ROUTE_PREDICT = "predict"
ROUTE_ENCODE = "encode"
