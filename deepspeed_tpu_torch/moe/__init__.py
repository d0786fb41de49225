"""Mixture of experts — counterpart of ``deepspeed_tpu/moe``."""

from .layer import MoELayer, init_moe_ffn, moe_ffn_logical_axes
from .sharded_moe import top_k_gating

__all__ = ["MoELayer", "init_moe_ffn", "moe_ffn_logical_axes", "top_k_gating"]
