"""DeepSpeed-compatible typed configuration — a copy of
``deepspeed_tpu/runtime/config.py`` (``DeepSpeedTPUConfig`` :597,
``parse_config`` :737, ``_resolve_batch_size`` :782), kept in the port so
that it imports nothing of the JAX package. The same JSON parses to the same
values, including the batch-size invariant ``train_batch_size ==
micro_batch * gradient_accumulation_steps * dp_world``.

Blocks the port has not brought over yet parse as in the JAX package but
raise ``NotImplementedError`` when enabled, at ``initialize``
(:func:`check_ported`): offload, pipeline, sequence parallelism and the
ring ``sequence`` options, ``comms_overlap``, tensor parallelism,
telemetry, profiler, tuning, watchdog, reliability, memory tiers, ``aio``,
ZeRO++ and MiCS; a ``mesh`` with a ``tensor``, ``pipe`` or ``seq`` axis
above 1. The ``moe`` block and the ``expert`` axis are accepted
(``moe.expert_parallel_size`` becomes the ``expert`` axis when no ``mesh``
is given, ``runtime/engine.py`` ``mesh_sizes``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from ..utils.logging import logger
from .config_utils import ConfigModel, is_auto, register_config_model
from . import constants as C


@register_config_model
@dataclass
class FP16Config(ConfigModel):
    """Reference: ``runtime/fp16`` config block (``runtime/config.py`` fp16 keys)."""
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 → dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0


@register_config_model
@dataclass
class BF16Config(ConfigModel):
    enabled: bool = False


@register_config_model
@dataclass
class OffloadDeviceConfig(ConfigModel):
    """Reference: ``runtime/zero/offload_config.py:21/:52``."""
    device: str = C.OFFLOAD_NONE  # none | cpu | nvme
    nvme_path: Optional[str] = None
    pin_memory: bool = False
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    ratio: float = 1.0
    max_in_cpu: int = 1_000_000_000


@register_config_model
@dataclass
class ZeroConfig(ConfigModel):
    """Reference: ``runtime/zero/config.py:95-376``. Stage semantics:

    0: plain DP (grad psum over data axis)
    1: optimizer states sharded over the fsdp axis
    2: + gradients reduce-scattered over fsdp
    3: + parameters sharded over fsdp, gathered on use (XLA SPMD schedules the
       all-gathers; replaces the IPG bucket/stream machinery of the reference)
    """
    stage: int = 0
    overlap_comm: bool = True          # XLA latency-hiding scheduler: always on
    contiguous_gradients: bool = True  # XLA owns layout; accepted for compat
    reduce_bucket_size: int = 500_000_000
    allgather_bucket_size: int = 500_000_000
    reduce_scatter: bool = True
    round_robin_gradients: bool = False
    offload_param: OffloadDeviceConfig = field(default_factory=OffloadDeviceConfig)
    offload_optimizer: OffloadDeviceConfig = field(default_factory=OffloadDeviceConfig)
    sub_group_size: int = 1_000_000_000
    stage3_max_live_parameters: int = 1_000_000_000
    stage3_max_reuse_distance: int = 1_000_000_000
    stage3_prefetch_bucket_size: int = 50_000_000
    stage3_param_persistence_threshold: int = 100_000
    stage3_gather_16bit_weights_on_model_save: bool = False
    zero_quantized_weights: bool = False     # ZeRO++ qwZ
    zero_quantized_gradients: bool = False   # ZeRO++ qgZ
    zero_hpz_partition_size: int = 1         # ZeRO++ hpZ (hierarchical partition)
    mics_shard_size: int = -1                # MiCS sub-axis shard size
    mics_hierarchical_params_gather: bool = False
    ignore_unused_parameters: bool = True
    elastic_checkpoint: bool = False


@register_config_model
@dataclass
class OptimizerConfig(ConfigModel):
    type: str = "adamw"
    params: Dict[str, Any] = field(default_factory=dict)
    # param-group analog (reference: the param_groups list handed to
    # torch optimizers): [{"pattern": <regex over leaf paths>, <hyper
    # overrides>}, ...]; first match wins, unmatched leaves use `params`
    param_groups: List[Dict[str, Any]] = field(default_factory=list)


@register_config_model
@dataclass
class SchedulerConfig(ConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


@register_config_model
@dataclass
class MeshConfig(ConfigModel):
    """TPU-native replacement for mpu/topology/process-groups: the named device
    mesh. Sizes of 1 mean the axis is unused. ``data`` defaults to "fill the
    remaining devices". fsdp is folded with data for ZeRO sharding (the ZeRO
    partition group == the data-parallel group, as in the reference)."""
    data: int = -1        # -1 → infer (devices / product(other axes))
    tensor: int = 1
    pipe: int = 1
    seq: int = 1
    expert: int = 1

    def axis_sizes(self, n_devices: int) -> Dict[str, int]:
        fixed = self.tensor * self.pipe * self.seq * self.expert
        data = self.data
        if data == -1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"device count {n_devices} not divisible by "
                    f"tensor*pipe*seq*expert={fixed}")
            data = n_devices // fixed
        total = data * fixed
        if total != n_devices:
            raise ValueError(
                f"mesh data={data} expert={self.expert} pipe={self.pipe} "
                f"seq={self.seq} tensor={self.tensor} = {total} != device count {n_devices}")
        return {"data": data, "expert": self.expert, "pipe": self.pipe,
                "seq": self.seq, "tensor": self.tensor}


@register_config_model
@dataclass
class TensorParallelConfig(ConfigModel):
    """Reference: ``autotp_size`` training config (``runtime/tensor_parallel/``)."""
    autotp_size: int = 1
    tp_overlap_comm: bool = False


@register_config_model
@dataclass
class AttentionOpsConfig(ConfigModel):
    """``attention`` block — attention-kernel behavior knobs
    (docs/performance.md "Native GQA attention").

    ``gqa_native: false`` (the default) keeps every attention program
    byte-identical to the historical widening path (K/V broadcast to the
    query head count before the kernel). ``true`` arms the native-GQA flash
    kernels process-wide (``ops.attention.configure_gqa_native``, published
    at engine init like the remat-policy registry): K/V stay kv-head-narrow
    through forward AND backward — up to nq/nkv× less KV HBM traffic —
    with ``repeat_kv`` surviving only as the XLA-fallback reference and
    the Ulysses head-sharding alignment widener."""
    gqa_native: bool = False


@register_config_model
@dataclass
class RingSequenceConfig(ConfigModel):
    """``sequence.ring`` block — ring context-parallelism schedule knobs
    (docs/performance.md "Million-token context").

    ``layout: zigzag`` replaces the contiguous causal layout (rank r does
    r+1 block-pairs; rank P-1 is a P× straggler) with the striped layout
    where rank r owns global half-chunks {r, 2P-1-r} — every rank then
    executes exactly 2P+1 flash pairs and causal wall-clock drops ~2×.
    ``overlap: true`` issues each hop's ``ppermute`` before the previous
    block's flash kernels so the ICI transfer hides under compute.
    Published at engine init via ``sequence.ring.configure_ring`` (the
    ``attention.gqa_native`` pattern); both settings preserve exact
    numerics — layout/ordering changes only."""
    layout: str = "contiguous"  # "contiguous" | "zigzag"
    overlap: bool = False


@register_config_model
@dataclass
class SequenceConfig(ConfigModel):
    """``sequence`` block — long-context behavior of the training engine.

    ``tiled_loss: true`` routes the engine loss through the model's tiled
    fused logits+loss head (``sequence.tiled.tiled_fused_logits_loss``):
    the ``[B, S, V]`` logits tensor — the FIRST thing to OOM at long
    context, before attention — is never materialized; logits exist one
    ``[B, S/shards, V]`` tile at a time inside a rematerialized scan.
    Default OFF keeps the train step byte-identical (pinned)."""
    tiled_loss: bool = False
    tiled_loss_shards: int = 8
    ring: RingSequenceConfig = field(default_factory=RingSequenceConfig)


@register_config_model
@dataclass
class ActivationCheckpointingConfig(ConfigModel):
    """Reference: ``runtime/activation_checkpointing/checkpointing.py`` flags.
    On TPU these select a ``jax.checkpoint`` (remat) policy."""
    partition_activations: bool = False
    cpu_checkpointing: bool = False   # → offload remat residuals to host memory
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    # none | full | dots_saveable | save_attn_out | save_big_matmuls |
    # save_names | offload | ... — the named-policy registry in
    # runtime/activation_checkpointing/checkpointing.py (POLICIES)
    policy: str = "none"


@register_config_model
@dataclass
class FlopsProfilerConfig(ConfigModel):
    enabled: bool = False
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


@register_config_model
@dataclass
class CommsLoggerConfig(ConfigModel):
    """Reference ``comms_logger`` block (``utils/comms_logging.py``): with
    ``prof_all`` off, only op names starting with a ``prof_ops`` entry are
    recorded by ``comm.CommsTelemetry``."""
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = field(default_factory=list)


@register_config_model
@dataclass
class CommsOverlapConfig(ConfigModel):
    """``comms_overlap`` block — the gradient-communication overlap engine
    (``comm/overlap.py``; see docs/performance.md). ``enabled: false`` (the
    default) reproduces the baseline numerics bit-for-bit; when enabled the
    engine reduces gradients with explicit, coalesced collectives under
    shard_map instead of per-leaf sharding-constraint-implied ones.

    The gradient-reduction engine requires ZeRO stage <= 2 (stage 3's
    gather-on-use parameter sharding conflicts with the manual data-parallel
    region) and no pipeline axis. At stage 3, enabling the block requires
    ``layer_prefetch`` — the ZeRO-3 half of the overlap story: per-layer
    param all-gather prefetch pipelined against the previous layer's
    matmuls (T3), with the XLA async-collective flags still applied."""
    enabled: bool = False
    # flatten small grad leaves into flat buckets of ~this size before the
    # reduce-scatter (reference reduce_bucket_size analog); leaves larger
    # than the cap keep their own per-leaf reduce-scatter
    coalesce_buckets: bool = True
    bucket_size_mb: float = 25.0
    # accumulate micro-batch grads locally and reduce ONCE per optimizer
    # step (gas x less DP comm volume; costs a full-size fp32 accumulator)
    deferred_gradient_reduce: bool = True
    # LoCo error feedback for the int8-quantized reduction paths (reference
    # all_to_all_loco_quant_reduce; needs zero_quantized_gradients or
    # quantized_all_reduce — without a quantizer there is no error to feed)
    loco: bool = False
    loco_err_beta: float = 0.8
    # EQuARX-style quantized all-reduce (comm/compressed.py
    # quantized_all_reduce): the non-ZeRO DP gradient path — leaves whose
    # grad layout stays replicated (stage 0/1, or indivisible dims) reduce
    # via int8 quantized reduce-scatter + int8 quantized all-gather instead
    # of a full-width psum (~4x less wire per half). Composes with loco
    # error feedback; bucketed small leaves keep their exact fp32 buckets.
    quantized_all_reduce: bool = False
    # ZeRO-3 per-layer all-gather prefetch (comm/overlap.py prefetch_scan):
    # the stacked-layer scan gathers layer i+1's param shards while layer
    # i's matmuls run instead of gathering at first use. prefetch_depth =
    # layers of gathered params kept in flight (1 = double buffer); each
    # costs one gathered layer of HBM
    layer_prefetch: bool = False
    prefetch_depth: int = 1
    # XLA latency-hiding-scheduler / async-collective programming
    async_collectives: bool = True
    combine_threshold_mb: float = 0.0  # 0 -> leave the XLA default
    extra_xla_flags: List[str] = field(default_factory=list)
    # optional link bandwidth (GB/s per device) for the telemetry hub's
    # estimated unoverlapped-comm fraction; 0 -> skip that event
    reference_bw_gbps: float = 0.0


@register_config_model
@dataclass
class ProfilerConfig(ConfigModel):
    """Config-gated JAX profiler session: brackets global steps
    ``[start_step, end_step]`` with ``jax.profiler.start_trace/stop_trace``
    (xprof/tensorboard-viewable), managed by ``telemetry.ProfilerSession``."""
    enabled: bool = False
    start_step: int = 1
    end_step: int = 1
    output_dir: str = ""  # "" → <tmpdir>/dstpu_profile


@register_config_model
@dataclass
class TraceTelemetryConfig(ConfigModel):
    """``telemetry.trace`` block — span tracer + crash flight recorder
    (``telemetry/trace.py``; docs/observability.md). Default OFF: the step
    and serving paths record nothing and start no timers."""
    enabled: bool = False
    ring_size: int = 4096       # flight-recorder capacity (events retained)
    export_path: str = ""       # "" → <tmpdir>/dstpu_trace/flight_<pid>.json
    dump_on_crash: bool = True  # auto-dump on watchdog/fault/preempt/atexit


@register_config_model
@dataclass
class CompileTelemetryConfig(ConfigModel):
    """``telemetry.compile`` block — recompilation sentinel + analytic
    cost-model MFU attribution (``telemetry/compile.py``;
    docs/observability.md). Default OFF: every monitored jit site gets the
    plain ``jax.jit`` object back and the default program is
    byte-identical."""
    enabled: bool = False
    # distinct signatures per program treated as expected warmup
    warmup_signatures: int = 1
    # unexpected recompiles tolerated before on_budget fires (0 = unlimited)
    recompile_budget: int = 0
    on_budget: str = "warn"       # warn | raise
    # pull cost_analysis() flops/bytes per compiled program
    cost_analysis: bool = True


@register_config_model
@dataclass
class AnomalyTelemetryConfig(ConfigModel):
    """``telemetry.anomaly`` block — step-time anomaly detection
    (``telemetry/anomaly.py``; docs/observability.md). Default OFF: the hub
    never feeds the detector."""
    enabled: bool = False
    window: int = 64              # rolling median/MAD window (samples)
    min_samples: int = 16         # silence until this many samples
    spike_mad: float = 6.0        # spike: x > median + spike_mad * MAD
    mad_floor_frac: float = 0.02  # MAD floor as a fraction of the median
    drift_frac: float = 0.25      # drift: rolling median vs frozen baseline
    straggler_frac: float = 0.25  # per-host: above cross-host median by this
    dump_flight_recorder: bool = True  # trace dump on the first finding


@register_config_model
@dataclass
class TelemetryConfig(ConfigModel):
    """Top-level ``telemetry`` block (trace + compile + anomaly sub-blocks;
    the older observability gates — ``wall_clock_breakdown``,
    ``comms_logger``, ``profiler`` — stay where reference configs put
    them)."""
    trace: TraceTelemetryConfig = field(default_factory=TraceTelemetryConfig)
    compile: CompileTelemetryConfig = field(
        default_factory=CompileTelemetryConfig)
    anomaly: AnomalyTelemetryConfig = field(
        default_factory=AnomalyTelemetryConfig)
    # JSONL monitor sink rotation threshold (MiB): when events.jsonl exceeds
    # this, it rotates to events.jsonl.1 so long serving runs can't fill the
    # disk. 0 = no rotation (docs/observability.md).
    jsonl_max_mb: float = 0.0


@register_config_model
@dataclass
class TuningConfig(ConfigModel):
    """Top-level ``tuning`` block — the telemetry-actuated online tuner
    (``tuning/tuner.py``; docs/tuning.md). Default OFF: the engine never
    constructs a tuner and the train step is byte-identical to pre-tuning
    behavior (pinned by tests/test_tuning.py). Field semantics mirror
    ``tuning.TunerOptions``; the serving side takes the same keys under
    ``serving.tuning`` on the router config."""
    enabled: bool = False
    # registered tunable names to search ([] = every train_step-boundary
    # knob in tuning/registry.py default_registry)
    knobs: List[str] = field(default_factory=list)
    steps_per_arm: int = 16       # optimizer steps dwelled per measured arm
    window_s: float = 600.0       # max trailing scoring window (seconds)
    min_samples: int = 8          # tsdb samples required before a verdict
    max_dwell_factor: int = 4     # abandon a window after this x dwell
    accept_mads: float = 3.0      # win margin: this many baseline MADs...
    min_rel_delta: float = 0.02   # ...AND this fraction of the baseline
    recompile_allowance: int = 2  # planned recompiles per arm (guard veto)
    seed: int = 0                 # arm-order shuffle seed
    persist: bool = True          # write winners to .dstpu_tuned.json
    reload: bool = True           # reload persisted winners (no re-search)
    path: str = ""                # "" = the default persist resolver


@register_config_model
@dataclass
class MonitorBackendConfig(ConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedTPUJob"
    # wandb / comet extras
    team: Optional[str] = None
    group: Optional[str] = None
    project: Optional[str] = None
    workspace: Optional[str] = None
    experiment_name: Optional[str] = None


@register_config_model
@dataclass
class PipelineConfig(ConfigModel):
    stages: int = 1
    partition_method: str = "parameters"  # parameters | uniform | type:regex
    activation_checkpoint_interval: int = 0
    pipe_schedule: str = "1f1b"           # 1f1b | gpipe | inference


@register_config_model
@dataclass
class MoEConfig(ConfigModel):
    enabled: bool = False
    expert_parallel_size: int = 1
    num_experts: int = 1
    top_k: int = 1
    capacity_factor: float = 1.0
    eval_capacity_factor: float = 1.0
    min_capacity: int = 4
    drop_tokens: bool = True
    use_rts: bool = True          # random token selection
    aux_loss_coef: float = 0.01


@register_config_model
@dataclass
class CheckpointConfig(ConfigModel):
    """Reference: checkpoint-engine selection + options (``runtime/engine.py:1287``).

    Crash-consistency knobs (``docs/reliability.md``): ``atomic`` stages each
    save in ``<tag>.tmp.*`` and publishes it with fsync + manifest + atomic
    rename before ``latest`` advances; ``verify_on_load`` checks the SHA-256
    manifest and walks back to the newest verifiable tag on corruption;
    ``keep_last_n`` garbage-collects old tags (0 = keep all); ``io_retries`` /
    ``io_backoff_s`` retry transient checkpoint I/O errors with exponential
    backoff + jitter (0 retries = fail fast, the legacy behavior)."""
    engine: str = "default"  # default | async | fast
    use_node_local_storage: bool = False
    parallel_write_pipeline: bool = False
    tag_validation: str = "Warn"  # Warn | Ignore | Fail
    load_universal: bool = False
    writer_buffer_mb: int = 64
    atomic: bool = True
    verify_on_load: bool = True
    keep_last_n: int = 0
    io_retries: int = 0
    io_backoff_s: float = 0.5


@register_config_model
@dataclass
class WatchdogConfig(ConfigModel):
    """Training watchdog (``runtime/watchdog.py``): acts on host-visible
    signals the loop already computes. Every detector defaults OFF so the
    default step is untouched; ``Reliability/*`` events flow through
    TelemetryHub (see ``docs/reliability.md``)."""
    enabled: bool = False
    # N consecutive overflow-skipped steps → violation (0 = off)
    max_skipped_steps: int = 0
    # NaN/Inf host-side loss → violation
    detect_non_finite: bool = True
    # loss > k × trailing-median loss → Reliability/loss_spike warning (0 = off)
    loss_spike_factor: float = 0.0
    loss_window: int = 32
    # step time > k × trailing-median step time → stall warning (0 = off)
    stall_factor: float = 0.0
    stall_window: int = 16
    # detectors based on a trailing median stay silent until this many samples
    min_samples: int = 5
    # any single step exceeding this wall-clock budget → violation (0 = off)
    hard_timeout_s: float = 0.0
    # raise | warn | restore (reload last good checkpoint from restore_dir)
    # | exit (request a checkpoint-and-exit via PreemptionGuard.step_boundary)
    on_violation: str = "raise"
    restore_dir: Optional[str] = None
    # ---- multi-host heartbeat (host-loss detection → elastic exit; see
    # docs/reliability.md "Elastic training & universal checkpoint") ----
    # run an allgather-based liveness round after optimizer steps
    heartbeat: bool = False
    # min seconds between liveness gathers (0 = every observed step)
    heartbeat_interval_s: float = 0.0
    # consecutive gathers a peer may miss / stall before it is declared dead
    heartbeat_max_missed: int = 3
    # wall-clock deadline on the liveness collective itself: a gather stuck
    # past this records a hung-collective host loss (0 = off)
    collective_deadline_s: float = 0.0


@register_config_model
@dataclass
class IntegrityConfig(ConfigModel):
    """``reliability.integrity`` block — the numerics-integrity plane
    (``deepspeed_tpu/reliability/integrity.py``; docs/reliability.md
    "Numerics integrity & SDC"). Default OFF: the training step is the exact
    pre-integrity program, byte-identical (pinned by tests/test_integrity.py).

    With ``enabled`` the jitted step additionally computes cheap per-leaf
    digests (bitcast-to-int32 wraparound sums + L2 norms + nonfinite counts)
    of replica-invariant quantities — post-all-reduce grads, post-step
    replicated params, optimizer moments, the loss scalar. Every
    ``check_interval`` steps the host allgathers the digest vector across
    processes and majority-votes: a minority row attributes the mismatch to a
    specific host. Every ``audit_interval`` steps a rotating auditor re-runs
    fwd/bwd on a recorded micro-batch and compares digests against the live
    step (catches all-replica compute SDC that replica invariance cannot
    see). ``quarantine_threshold`` repeated attributions to one host fire the
    elastic-exit path: durable universal save + ``reshard_hint.json`` with an
    ``excluded_hosts`` field that ``run_elastic`` reshards around."""
    enabled: bool = False
    # steps between cross-host digest compare rounds
    check_interval: int = 10
    # steps between shadow recompute audits (0 = off)
    audit_interval: int = 0
    # attributions to one host before quarantine fires (0 = never quarantine)
    quarantine_threshold: int = 3
    # relative tolerance for the shadow-audit L2 compare (bitcast sums are
    # exact; the audit recompute may legally differ by reduction order)
    audit_rtol: float = 1e-6
    # which quantities are fingerprinted
    fingerprint_grads: bool = True
    fingerprint_params: bool = True
    fingerprint_opt_state: bool = True
    # raise | warn | exit (quarantine via PreemptionGuard elastic exit)
    on_corruption: str = "exit"


@register_config_model
@dataclass
class ReliabilityConfig(ConfigModel):
    """Top-level ``reliability`` block (integrity sub-block;
    docs/reliability.md)."""
    integrity: IntegrityConfig = field(default_factory=IntegrityConfig)


@register_config_model
@dataclass
class MemoryTieringConfig(ConfigModel):
    """``memory.tiering`` block — the tiered memory subsystem
    (``deepspeed_tpu/memory``; docs/memory.md). Default OFF: the training
    step is the exact pre-tiering program, byte-identical (pinned by parity
    tests in tests/test_tiered_memory.py).

    ``optimizer_tier='host'`` keeps the optimizer state (fp32 masters'
    moments) host-resident between steps: the H2D restore prefetches on the
    transfer worker UNDER the fwd/bwd grad computation and the D2H
    writeback of the updated state overlaps the NEXT step — measured via
    ``Memory/tier/overlap_frac``. ``optimizer_tier='nvme'`` is the
    ZeRO-Infinity disk tier (``zero_optimization.offload_optimizer
    device=nvme`` is the streamed equivalent and remains supported).

    ``param_tier='host'`` parks cold ZeRO-3 stacked layer shards in host
    memory; the per-layer host→HBM copy-in rides the SAME pipeline as
    ``comms_overlap.layer_prefetch`` (the gather-to-compute constraint is
    issued a layer ahead — compose rule in docs/memory.md). Real on
    backends with a host memory space (TPU); identity on the CPU mesh."""
    enabled: bool = False
    optimizer_tier: str = "none"   # none | host | nvme
    param_tier: str = "none"       # none | host (needs layer_prefetch)
    pin_memory: bool = True
    nvme_path: Optional[str] = None


@register_config_model
@dataclass
class MemoryConfig(ConfigModel):
    """Top-level ``memory`` block (tiering sub-block; docs/memory.md)."""
    tiering: MemoryTieringConfig = field(default_factory=MemoryTieringConfig)


@register_config_model
@dataclass
class AIOConfig(ConfigModel):
    """Reference: ``runtime/swap_tensor/aio_config.py``."""
    block_size: int = 1048576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True


@dataclass
class DeepSpeedTPUConfig:
    """The full config tree. Built by :func:`parse_config`."""

    # batch sizes (resolved; see _resolve_batch_size)
    train_batch_size: int = 0
    train_micro_batch_size_per_gpu: int = 0
    gradient_accumulation_steps: int = 0

    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    fp16: FP16Config = field(default_factory=FP16Config)
    bf16: BF16Config = field(default_factory=BF16Config)
    zero_config: ZeroConfig = field(default_factory=ZeroConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    tensor_parallel: TensorParallelConfig = field(default_factory=TensorParallelConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    attention: AttentionOpsConfig = field(default_factory=AttentionOpsConfig)
    activation_checkpointing: ActivationCheckpointingConfig = field(
        default_factory=ActivationCheckpointingConfig)
    flops_profiler: FlopsProfilerConfig = field(default_factory=FlopsProfilerConfig)
    comms_logger: CommsLoggerConfig = field(default_factory=CommsLoggerConfig)
    comms_overlap: CommsOverlapConfig = field(default_factory=CommsOverlapConfig)
    profiler: ProfilerConfig = field(default_factory=ProfilerConfig)
    tensorboard: MonitorBackendConfig = field(default_factory=MonitorBackendConfig)
    wandb: MonitorBackendConfig = field(default_factory=MonitorBackendConfig)
    comet: MonitorBackendConfig = field(default_factory=MonitorBackendConfig)
    csv_monitor: MonitorBackendConfig = field(default_factory=MonitorBackendConfig)
    jsonl_monitor: MonitorBackendConfig = field(default_factory=MonitorBackendConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    watchdog: WatchdogConfig = field(default_factory=WatchdogConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    tuning: TuningConfig = field(default_factory=TuningConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    reliability: ReliabilityConfig = field(default_factory=ReliabilityConfig)
    aio: AIOConfig = field(default_factory=AIOConfig)
    sequence: SequenceConfig = field(default_factory=SequenceConfig)

    gradient_clipping: float = 0.0
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    steps_per_print: int = 10
    wall_clock_breakdown: bool = False
    memory_breakdown: bool = False
    sequence_parallel_size: int = 1
    seed: int = 42
    # persistent XLA compilation cache dir: re-runs skip the multi-minute
    # TPU compiles. None -> fall back to $DSTPU_COMPILE_CACHE; "" -> cache
    # explicitly OFF even if the env var is set
    compile_cache_dir: Optional[str] = None
    communication_data_type: Optional[str] = None
    gradient_accumulation_dtype: Optional[str] = None
    data_efficiency: Dict[str, Any] = field(default_factory=dict)
    compression_training: Dict[str, Any] = field(default_factory=dict)
    elasticity: Dict[str, Any] = field(default_factory=dict)
    autotuning: Dict[str, Any] = field(default_factory=dict)
    raw: Dict[str, Any] = field(default_factory=dict)

    # -- derived --
    @property
    def zero_enabled(self) -> bool:
        return self.zero_config.stage > 0

    @property
    def compute_dtype(self) -> str:
        if self.fp16.enabled:
            return "float16"
        if self.bf16.enabled:
            return "bfloat16"
        return "float32"

    @property
    def loss_scale_enabled(self) -> bool:
        return self.fp16.enabled

    def print_config(self) -> None:
        logger.info(json.dumps(_dictify(self), indent=2, default=str))


def _dictify(cfg: DeepSpeedTPUConfig) -> Dict[str, Any]:
    out = {}
    for k, v in cfg.__dict__.items():
        if k == "raw":
            continue
        out[k] = v.to_dict() if isinstance(v, ConfigModel) else v
    return out


_SUBCONFIG_KEYS = {
    "optimizer": OptimizerConfig,
    "scheduler": SchedulerConfig,
    "fp16": FP16Config,
    "bf16": BF16Config,
    "bfloat16": BF16Config,  # alias used by the reference
    "zero_optimization": ZeroConfig,
    "mesh": MeshConfig,
    "tensor_parallel": TensorParallelConfig,
    "pipeline": PipelineConfig,
    "moe": MoEConfig,
    "attention": AttentionOpsConfig,
    "activation_checkpointing": ActivationCheckpointingConfig,
    "flops_profiler": FlopsProfilerConfig,
    "comms_logger": CommsLoggerConfig,
    "comms_overlap": CommsOverlapConfig,
    "profiler": ProfilerConfig,
    "tensorboard": MonitorBackendConfig,
    "wandb": MonitorBackendConfig,
    "comet": MonitorBackendConfig,
    "csv_monitor": MonitorBackendConfig,
    "jsonl_monitor": MonitorBackendConfig,
    "checkpoint": CheckpointConfig,
    "watchdog": WatchdogConfig,
    "telemetry": TelemetryConfig,
    "tuning": TuningConfig,
    "memory": MemoryConfig,
    "reliability": ReliabilityConfig,
    "aio": AIOConfig,
    "sequence": SequenceConfig,
}

_ATTR_FOR_KEY = {"zero_optimization": "zero_config", "bfloat16": "bf16"}

_SCALAR_KEYS = [
    "gradient_clipping", "prescale_gradients", "gradient_predivide_factor",
    "steps_per_print", "wall_clock_breakdown", "memory_breakdown",
    "sequence_parallel_size", "seed", "communication_data_type",
    "gradient_accumulation_dtype", "compile_cache_dir",
]

_DICT_KEYS = ["data_efficiency", "compression_training", "elasticity", "autotuning"]

# keys accepted but intentionally inert on TPU (GPU-runtime specific); kept so
# reference configs parse cleanly
_IGNORED_KEYS = {
    "amp", "zero_allow_untested_optimizer", "zero_force_ds_cpu_optimizer",
    "dump_state", "sparse_gradients", "checkpoint_tag_validation", "dataloader_drop_last",
    "use_data_before_expert_parallel_", "hybrid_engine", "data_types", "compile",
}


def parse_config(config: Union[str, Dict[str, Any], None],
                 world_size: int = 1,
                 dp_world_size: Optional[int] = None,
                 resolve_batch: bool = True) -> DeepSpeedTPUConfig:
    """JSON path / dict → :class:`DeepSpeedTPUConfig` with batch math resolved.

    ``dp_world_size`` is the size of the data-parallel axis (batch replication
    degree); defaults to ``world_size`` (pure DP).
    """
    if config is None:
        config = {}
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    if not isinstance(config, dict):
        raise TypeError(f"config must be a dict or JSON path, got {type(config)}")

    cfg = DeepSpeedTPUConfig(raw=dict(config))
    for key, value in config.items():
        if key in _SUBCONFIG_KEYS:
            attr = _ATTR_FOR_KEY.get(key, key)
            setattr(cfg, attr, _SUBCONFIG_KEYS[key].from_dict(value))
        elif key in _SCALAR_KEYS:
            setattr(cfg, key, value)
        elif key in _DICT_KEYS:
            setattr(cfg, key, dict(value))
        elif key in (C.TRAIN_BATCH_SIZE, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
                     C.GRADIENT_ACCUMULATION_STEPS):
            # reference configs may carry the "auto" sentinel (resolved by
            # integrations like HF) — treat as unset here
            setattr(cfg, key, 0 if is_auto(value) else int(value))
        elif key in _IGNORED_KEYS:
            logger.debug(f"config key '{key}' accepted but inert on TPU")
        else:
            logger.warning(f"Unknown top-level config key '{key}' (ignored)")

    if cfg.fp16.enabled and cfg.bf16.enabled:
        raise ValueError("fp16 and bf16 cannot both be enabled")

    dp = dp_world_size if dp_world_size is not None else world_size
    if resolve_batch:
        _resolve_batch_size(cfg, dp)
    return cfg


def _resolve_batch_size(cfg: DeepSpeedTPUConfig, dp_world_size: int) -> None:
    """Reference semantics (``runtime/config.py`` batch assertions):
    train_batch == micro_batch * gas * dp_world_size; any missing values are
    derived, all-missing defaults to micro=1, gas=1."""
    tb, mb, gas = (cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu,
                   cfg.gradient_accumulation_steps)
    if tb and mb and gas:
        if tb != mb * gas * dp_world_size:
            raise ValueError(
                f"train_batch_size {tb} != micro_batch {mb} * gas {gas} * dp {dp_world_size}")
    elif tb and mb:
        if tb % (mb * dp_world_size) != 0:
            raise ValueError(f"train_batch_size {tb} not divisible by micro*dp")
        gas = tb // (mb * dp_world_size)
    elif tb and gas:
        if tb % (gas * dp_world_size) != 0:
            raise ValueError(f"train_batch_size {tb} not divisible by gas*dp")
        mb = tb // (gas * dp_world_size)
    elif mb and gas:
        tb = mb * gas * dp_world_size
    elif tb:
        mb = tb // dp_world_size
        gas = 1
        if mb * dp_world_size != tb:
            raise ValueError(f"train_batch_size {tb} not divisible by dp {dp_world_size}")
    elif mb:
        gas = 1
        tb = mb * dp_world_size
    else:
        mb, gas = 1, 1
        tb = dp_world_size
    cfg.train_batch_size = tb
    cfg.train_micro_batch_size_per_gpu = mb
    cfg.gradient_accumulation_steps = gas


def unported_features(cfg: DeepSpeedTPUConfig) -> List[str]:
    """Enabled config blocks the port does not implement yet."""
    zc = cfg.zero_config
    tel = cfg.telemetry
    on = {
        "zero_optimization.offload_optimizer":
            zc.offload_optimizer.device != C.OFFLOAD_NONE,
        "zero_optimization.offload_param":
            zc.offload_param.device != C.OFFLOAD_NONE,
        "zero_optimization.zero_quantized_weights": zc.zero_quantized_weights,
        "zero_optimization.zero_quantized_gradients":
            zc.zero_quantized_gradients,
        "zero_optimization.zero_hpz_partition_size":
            zc.zero_hpz_partition_size > 1,
        "zero_optimization.mics_shard_size": zc.mics_shard_size > 1,
        "pipeline": cfg.pipeline.stages > 1,
        "mesh": any(int(getattr(cfg.mesh, a)) > 1 for a in ("tensor", "pipe", "seq")),
        "tensor_parallel": cfg.tensor_parallel.autotp_size > 1,
        "sequence_parallel_size": cfg.sequence_parallel_size > 1,
        "sequence.ring": (cfg.sequence.ring.layout != "contiguous"
                          or cfg.sequence.ring.overlap),
        "comms_overlap": cfg.comms_overlap.enabled,
        "comms_logger": cfg.comms_logger.enabled,
        "telemetry": (tel.trace.enabled or tel.compile.enabled
                      or tel.anomaly.enabled),
        "profiler": cfg.profiler.enabled,
        "flops_profiler": cfg.flops_profiler.enabled,
        "tuning": cfg.tuning.enabled,
        "watchdog": cfg.watchdog.enabled,
        "reliability.integrity": cfg.reliability.integrity.enabled,
        "memory.tiering": cfg.memory.tiering.enabled,
        "aio": "aio" in cfg.raw,
        "wall_clock_breakdown": cfg.wall_clock_breakdown,
        "monitors": any(m.enabled for m in (cfg.tensorboard, cfg.wandb,
                                            cfg.comet, cfg.csv_monitor,
                                            cfg.jsonl_monitor)),
        "data_efficiency": bool(cfg.data_efficiency),
    }
    return [name for name, enabled in on.items() if enabled]


def check_ported(cfg: DeepSpeedTPUConfig, world_size: int = 1) -> None:
    """Raise ``NotImplementedError`` naming every enabled block the port
    does not implement yet. A world size above 1 is data parallel: every
    rank on the ``data`` axis (ZeRO stages 0-3 shard over it); a mesh that
    does not fill ``world_size`` raises ``ValueError``."""
    missing = unported_features(cfg)
    if missing:
        raise NotImplementedError(
            f"not yet ported to deepspeed_tpu_torch: {', '.join(missing)}")
    cfg.mesh.axis_sizes(world_size)
