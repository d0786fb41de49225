"""Fault injection for the port's tests and chip smoke — counterpart of
``deepspeed_tpu/testing/``: the serving-fleet chaos injectors and the
checkpoint injectors (:mod:`.faults`)."""

from .faults import (ReplicaCrash, SimulatedCrash, chaos_soak,  # noqa: F401
                     corrupt_file, corrupt_fragment, crash_after_save, flaky_tick,
                     io_errors, patch_attr, replica_crash, replica_hang, slow_replica,
                     truncated_write, write_delay)
