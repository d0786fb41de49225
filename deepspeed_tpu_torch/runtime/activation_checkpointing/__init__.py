from .checkpointing import (CheckpointFunction, checkpoint,  # noqa: F401
                            checkpoint_name, checkpoint_wrapper, configure,
                            get_policy, in_checkpoint, is_configured,
                            model_parallel_cuda_manual_seed, reset, saved_bytes)

__all__ = [
    "CheckpointFunction", "checkpoint", "checkpoint_name", "checkpoint_wrapper",
    "configure", "get_policy", "in_checkpoint", "is_configured",
    "model_parallel_cuda_manual_seed", "reset", "saved_bytes",
]
