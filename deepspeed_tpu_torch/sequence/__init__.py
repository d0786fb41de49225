from .tiled import (TiledFusedLogitsLoss, TiledMLP,  # noqa: F401
                    sequence_tiled_compute, tiled_fused_logits_loss, tiled_mlp)

__all__ = ["TiledFusedLogitsLoss", "TiledMLP", "sequence_tiled_compute",
           "tiled_fused_logits_loss", "tiled_mlp"]
