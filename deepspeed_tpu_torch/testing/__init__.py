"""Fault injection for the port's tests and chip smoke — counterpart of
``deepspeed_tpu/testing/``; so far the serving-fleet chaos injectors
(:mod:`.faults`)."""

from .faults import (ReplicaCrash, chaos_soak, flaky_tick,  # noqa: F401
                     replica_crash, replica_hang, slow_replica)
