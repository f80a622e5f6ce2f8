"""Fault tolerance for the coherence engine: failure injection,
straggler detection, barrier checkpoints and exact crash recovery."""
from repro_torch.ft.runtime import (
    ElasticPlan, FailureInjector, StragglerMonitor, WorkerFailure,
)
from repro_torch.ft.coherence import (
    ChaosHarness, RecoveryReport, assert_bit_equal, harness_ticks,
    load_runtime, run_uninjected, save_runtime,
)

__all__ = ["ChaosHarness", "ElasticPlan", "FailureInjector",
           "RecoveryReport", "StragglerMonitor", "WorkerFailure",
           "assert_bit_equal", "harness_ticks", "load_runtime",
           "run_uninjected", "save_runtime"]
