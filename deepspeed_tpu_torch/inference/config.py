"""Inference configuration — a copy of ``deepspeed_tpu/inference/config.py``
(same dataclasses, same ``from_dict`` schema), kept in the port so that it
imports nothing of the JAX package.

Features that the port has not brought over yet raise
``NotImplementedError`` when enabled (:func:`check_ported`) rather than being
ignored: ``prefix_cache.host_spill``, ``quant``, ``tensor_parallel.tp_size >
1``, ``trace`` and ``compile_monitor``.

``enable_cuda_graph`` is accepted and ignored, as in the JAX package (whose
programs are compiled anyway): on a CUDA device the v2 engine always captures
its decode forward once as a CUDA graph and replays it for every decode step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class TPConfig:
    """Tensor-parallel sub-config (reference ``DeepSpeedTPConfig``)."""

    tp_size: int = 1


@dataclass
class RaggedConfig:
    """v2 state-manager sub-config (reference ``DSStateManagerConfig``)."""

    max_tracked_sequences: int = 64      # concurrent sequence slots
    max_ragged_batch_size: int = 64      # decode batch per step
    memory_config_blocks: int = 512      # KV blocks in the pool
    block_size: int = 128                # tokens per KV block


@dataclass
class PrefixCacheConfig:
    """Prefix-aware KV-cache reuse for the v2 paged engine (default OFF):
    admissions resolve shared prompt prefixes to existing KV blocks through
    a chain-hash index and prefill from the first uncached token; retired
    sequences' full blocks park in a retained LRU pool, evicted only under
    allocation pressure. The host-spill tier is not ported."""

    enabled: bool = False
    # retained-pool cap: -1 = bounded only by the block pool, 0 = share
    # between live sequences but retain nothing after retire, > 0 = at most
    # this many unreferenced blocks
    max_retained_blocks: int = -1
    host_spill: bool = False
    max_spilled_blocks: int = -1


@dataclass
class SpeculativeConfig:
    """Speculative decoding for the v2 paged engine (prompt-lookup drafts,
    one batched verify forward; ``fused_verify`` runs its attention through
    the paged spec-verify kernel)."""

    enabled: bool = False
    max_draft_tokens: int = 4
    ngram_max: int = 3
    min_match: int = 1
    fused_verify: bool = False


@dataclass
class QuantConfig:
    """Weight quantization for inference (not ported)."""

    enabled: bool = False
    bits: int = 8
    dtype: str = "int"


@dataclass
class KVQuantConfig:
    """Quantized (int8) KV cache for the v2 paged engine: int8 code pools
    with fp32 scales per position, kv head and group of ``group_size``
    lanes (clamped to the head size)."""

    enabled: bool = False
    dtype: str = "int8"
    group_size: int = 128


@dataclass
class TraceConfig:
    """The ``telemetry.trace`` block (request-lifecycle tracing; not ported)."""

    enabled: bool = False
    ring_size: int = 4096
    export_path: str = ""
    dump_on_crash: bool = True


@dataclass
class CompileMonitorConfig:
    """The ``telemetry.compile`` block (recompilation sentinel; not ported)."""

    enabled: bool = False
    warmup_signatures: int = 1
    recompile_budget: int = 0
    on_budget: str = "warn"
    cost_analysis: bool = True


@dataclass
class InferenceConfig:
    dtype: str = "bfloat16"
    tensor_parallel: TPConfig = field(default_factory=TPConfig)
    max_out_tokens: int = 1024           # dense KV-cache length budget (v1)
    min_out_tokens: int = 1
    replace_with_kernel_inject: bool = False  # kernels are always used on CUDA
    enable_cuda_graph: bool = False      # ignored: the v2 decode is a graph on CUDA
    max_batch_size: int = 8
    prefill_bucket: int = 64             # pad prompts to a multiple of this
    # > 0: tokens per prefill chunk of a split admission (rounded up to
    # prefill_bucket); one chunk advances per step() / step_many() call
    split_prefill_chunk: int = 0
    ragged: RaggedConfig = field(default_factory=RaggedConfig)
    quant: QuantConfig = field(default_factory=QuantConfig)
    kv_quant: KVQuantConfig = field(default_factory=KVQuantConfig)
    prefix_cache: PrefixCacheConfig = field(default_factory=PrefixCacheConfig)
    speculative: SpeculativeConfig = field(default_factory=SpeculativeConfig)
    trace: TraceConfig = field(default_factory=TraceConfig)
    compile_monitor: CompileMonitorConfig = field(
        default_factory=CompileMonitorConfig)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "InferenceConfig":
        d = dict(d or {})
        tp = d.pop("tensor_parallel", {})
        if isinstance(tp, int):
            tp = {"tp_size": tp}
        ragged = d.pop("ragged", {})
        quant = d.pop("quant", {})
        kvq = d.pop("kv_quant", {})
        prefix = d.pop("prefix_cache", {})
        spec = d.pop("speculative", {})
        trace = d.pop("trace", {})
        cmon = d.pop("compile_monitor", {})
        known = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        return cls(tensor_parallel=TPConfig(**tp), ragged=RaggedConfig(**ragged),
                   quant=QuantConfig(**quant),
                   kv_quant=KVQuantConfig(**kvq),
                   prefix_cache=PrefixCacheConfig(**prefix),
                   speculative=SpeculativeConfig(**spec),
                   trace=TraceConfig(**trace),
                   compile_monitor=CompileMonitorConfig(**cmon), **known)

    def unported_features(self) -> List[str]:
        """Enabled features the port does not implement yet."""
        on = {
            "prefix_cache.host_spill": (self.prefix_cache.enabled
                                        and self.prefix_cache.host_spill),
            "quant": self.quant.enabled,
            "tensor_parallel.tp_size": self.tensor_parallel.tp_size > 1,
            "trace": self.trace.enabled,
            "compile_monitor": self.compile_monitor.enabled,
        }
        return [name for name, enabled in on.items() if enabled]


def check_ported(config: InferenceConfig) -> None:
    """Raise ``NotImplementedError`` naming every enabled feature the port
    does not implement yet."""
    missing = config.unported_features()
    if missing:
        raise NotImplementedError(
            f"not yet ported to deepspeed_tpu_torch: {', '.join(missing)}")
