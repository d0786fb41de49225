"""Disaggregated prefill/decode serving — the ``serving.disagg`` config
block, a copy of ``deepspeed_tpu/inference/serving/disagg.py``.

With the block enabled the :class:`~.router.ReplicaRouter` splits its
replica pool into two tiers: replicas ``[0, num_prefill)`` are the
**prefill tier** (admission control + chunked/SplitFuse prefill only) and
the rest are the **decode tier** (steady-state token generation). When a
prefill-tier sequence finishes its prompt, the router ships its full
chain-hashed KV blocks to a decode replica as a paged-block transfer —
the wire payload is the engine's cache leaves (on a quantized-KV engine
that is already int8 codes + fp32 group scales, i.e. roughly half the
bytes of a bf16 transfer), keyed by the same
``PrefixBlockIndex.chain_hashes`` the engines index under, so:

- blocks whose chain hash is already canonical on the destination are
  **never sent** (shared-prefix dedup — only the novel suffix crosses
  the wire), and
- the destination absorbs the transfer through its retained prefix pool:
  the parked request's resume resolves the imported blocks as an
  ordinary admit-time prefix-cache hit, riding the token-exactness
  already pinned for park/resume.

Default OFF: a disabled block leaves the router literally untouched —
the single-tier placement and tick loops are the exact pre-disagg code
paths (parity-pinned), and ``disagg_events()`` is empty.
"""

from __future__ import annotations

import dataclasses

WIRE_FORMATS = ("native", "int8")


@dataclasses.dataclass
class DisaggConfig:
    """``serving.disagg`` — two-tier prefill/decode disaggregation."""

    enabled: bool = False
    # replicas [0, num_prefill) take admissions + prefill; the rest decode.
    # Must leave at least one replica in each tier when enabled.
    num_prefill: int = 1
    # KV wire format for the handoff (engine_v2.export_kv_blocks):
    # "native" ships cache leaves bitwise (a quantized-KV engine's native
    # format IS the int8 wire); "int8" makes a float engine re-code k/v to
    # int8 + fp32 group scales at the seam, halving wire bytes (lossy at
    # the handoff boundary only).
    wire: str = "native"
    wire_group: int = 64          # quantization group for wire="int8"
    # a session-sticky / resident-prefix decode target is honored only
    # while its load exceeds the least-loaded decode replica by at most
    # this many requests (mirrors RouterConfig.load_slack within the tier)
    decode_load_slack: int = 8

    def __post_init__(self) -> None:
        if self.wire not in WIRE_FORMATS:
            raise ValueError(f"serving.disagg.wire {self.wire!r} — "
                             f"expected one of {WIRE_FORMATS}")
        if self.enabled and self.num_prefill < 1:
            raise ValueError("serving.disagg.num_prefill must be >= 1")
        if self.wire_group < 1:
            raise ValueError("serving.disagg.wire_group must be >= 1")

    @classmethod
    def from_dict(cls, d) -> "DisaggConfig":
        if isinstance(d, cls):
            return d
        d = dict(d or {})
        known = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        unknown = set(d) - set(known)
        if unknown:
            raise ValueError(f"unknown serving.disagg key(s): "
                             f"{sorted(unknown)}")
        return cls(**known)
