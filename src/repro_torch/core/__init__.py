"""Public surface of the ported RegC protocol core.

Build runtimes through ``make_runtime``/``RuntimeConfig`` (on the card
unless ``device="cpu"`` is asked for) and drive them through
``repro_torch.dsm.session``.
"""
from repro_torch.core.carry import reference_from_state, runtime_from_snapshot
from repro_torch.core.config import (
    BACKENDS, DANGER_MODES, DRIVERS, ENGINES, FINE_PROTO, IDEAL_PROTO,
    PAGE_PROTO, PROTOCOLS, RuntimeConfig, check_choice, make_runtime,
)
from repro_torch.core.directory import IntervalLog, RegionDirectory
from repro_torch.core.regc import GasArray, RegCRuntime, Traffic
from repro_torch.core.regc_scale import RegCScaleRuntime

__all__ = [
    # config / factory
    "RuntimeConfig", "make_runtime", "check_choice",
    # canonical string-knob vocabularies
    "PROTOCOLS", "BACKENDS", "DANGER_MODES", "DRIVERS", "ENGINES",
    "FINE_PROTO", "PAGE_PROTO", "IDEAL_PROTO",
    # engines + data types
    "RegCScaleRuntime", "RegCRuntime", "GasArray", "Traffic",
    "IntervalLog", "RegionDirectory",
    # state carried across from the reference
    "runtime_from_snapshot", "reference_from_state",
]
