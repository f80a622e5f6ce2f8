"""Public configuration surface for the PyTorch RegC runtime.

One frozen spec (``RuntimeConfig``) and one factory (``make_runtime``)
build either protocol engine on a torch device: the directory-vectorized
``RegCScaleRuntime`` (``engine="scale"``) or the per-page reference
``RegCRuntime`` (``engine="reference"``).
The string-knob vocabularies and the validator ``check_choice`` mirror
``repro.core.config``; ``BACKENDS`` names this package's three
plane-reduction tiers instead of numpy/pallas/pallas-jit.

Entry points run on the card: ``device=None`` resolves to ``"cuda"``, and
a CUDA request on a machine without a card raises.  Only an explicit
``device="cpu"`` runs on the host (the parity tests do).

This module is the bottom layer of ``repro_torch.core``: it imports
nothing from the engine modules at import time (they import *us*).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.dsm.costmodel import CostModel, IB_2013

# protocol vocabulary (the paper's three series)
PAGE_PROTO = "page"    # samhita_page: page invalidation for BOTH region kinds
FINE_PROTO = "fine"    # samhita: fine-grain diffs for consistency regions
IDEAL_PROTO = "ideal"  # cache-coherent shared memory (Pthreads baseline)

PROTOCOLS = (FINE_PROTO, PAGE_PROTO, IDEAL_PROTO)
# plane-reduction tier of the scale engine:
#   'plain'   boolean-plane torch reductions (CPU only; twin of 'numpy')
#   'kernels' per-op CUDA kernels popcount_rows / coverage_multi
#             (twin of 'pallas')
#   'fused'   one phase_step launch per barrier flush (twin of 'pallas-jit')
BACKENDS = ("plain", "kernels", "fused")
DANGER_MODES = ("vec", "scalar")    # mid-op refetch replay path (spill)
DRIVERS = ("auto", "batched", "loop")   # SPMD phase drivers (Session)
ENGINES = ("scale", "reference")        # make_runtime targets

# mechanism costs (calibration constants, as in the reference package):
# instrumented store = call + hash-table update; write fault = trap +
# mprotect re-arm, order ~microseconds on the paper's Harpertown.
INSTR_S_PER_WORD = 1.5e-9
FAULT_S = 4.0e-6

# the reference engine's fault-injection hooks never existed (the
# reference package refuses them too)
_REFERENCE_REFUSES = ("chaos", "injector", "straggler")


def check_choice(name: str, value, allowed) -> str:
    """Validate a string knob against its canonical vocabulary.

    Raises ``ValueError`` naming the bad value AND the allowed set."""
    if value not in allowed:
        raise ValueError(
            f"invalid {name}={value!r}; allowed: "
            + ", ".join(repr(c) for c in allowed))
    return value


def resolve_device(device=None, backend: str = "fused") -> torch.device:
    """The runtime's device: ``None`` means the card.  A CUDA device on a
    machine without one raises; so does the CPU-only 'plain' tier on a
    CUDA device.  Nothing falls back to the host quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}; use 'cuda' or 'cpu'")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev!s} requested but torch finds no CUDA device; "
                "pass device='cpu' explicitly to run on the host")
        if backend == "plain":
            raise ValueError(
                "backend='plain' is the CPU-only tier; use 'kernels' or "
                "'fused' on a CUDA device")
    return dev


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Frozen spec for building a RegC runtime (either engine).

    The reference's spec plus ``device``, less ``n_mem_servers`` (which
    neither engine reads).  The reference engine ignores the scale
    engine's performance and mechanism knobs and refuses the
    fault-injection hooks (``chaos``, ``injector``, ``straggler``), which
    the scale engine takes."""

    page_words: int = 1024
    protocol: str = FINE_PROTO
    cost: CostModel = IB_2013
    cache_pages: Optional[int] = None   # per-worker cache (None = infinite)
    prefetch: int = 1
    track_values: bool = True           # reference only: materialize pages
    model_mechanism: bool = True        # scale only: §IV store tracking
    instr_s_per_word: float = INSTR_S_PER_WORD   # scale only
    fault_s: float = FAULT_S                     # scale only
    fetch_batch: int = 1                # scale only: bulk-fetch batching
    backend: str = "fused"              # scale only: plane-reduction tier
    danger_mode: str = "vec"            # scale only: mid-op refetch replay
    detect_races: bool = False          # pure-observer race detection
    chaos: Any = None                   # scale only: dsm.costmodel.ChaosNet
    injector: Any = None                # scale only: ft.FailureInjector
    straggler: Any = None               # scale only: ft.StragglerMonitor
    device: Any = None                  # None = "cuda"

    def __post_init__(self):
        check_choice("protocol", self.protocol, PROTOCOLS)
        check_choice("backend", self.backend, BACKENDS)
        check_choice("danger_mode", self.danger_mode, DANGER_MODES)


def make_runtime(n_workers: int, config: Optional[RuntimeConfig] = None,
                 *, engine: str = "scale", **overrides):
    """Build a RegC runtime from one spec.

    ``config`` defaults to ``RuntimeConfig()``; keyword ``overrides`` are
    applied on top via ``dataclasses.replace`` (unknown field names
    raise).  ``engine="scale"`` returns the directory-vectorized
    ``RegCScaleRuntime``; ``engine="reference"`` the per-page
    ``RegCRuntime``.  Both are driven through ``repro_torch.dsm.session``."""
    check_choice("engine", engine, ENGINES)
    cfg = config if config is not None else RuntimeConfig()
    if overrides:
        try:
            cfg = dataclasses.replace(cfg, **overrides)
        except TypeError as e:
            known = ", ".join(f.name for f in dataclasses.fields(cfg))
            raise ValueError(
                f"make_runtime(): unknown RuntimeConfig override "
                f"({e}); known fields: {known}") from None
    if engine == "reference":
        for hook in _REFERENCE_REFUSES:
            if getattr(cfg, hook) is not None:
                raise ValueError(
                    f"make_runtime(engine='reference'): the reference "
                    f"engine does not support the {hook!r} fault-injection "
                    f"hook of the recovery slice (use engine='scale')")
        from repro_torch.core.regc import RegCRuntime
        return RegCRuntime(
            n_workers, page_words=cfg.page_words, protocol=cfg.protocol,
            cost=cfg.cost, track_values=cfg.track_values,
            cache_pages=cfg.cache_pages, prefetch=cfg.prefetch,
            detect_races=cfg.detect_races, device=cfg.device)
    from repro_torch.core.regc_scale import RegCScaleRuntime
    return RegCScaleRuntime(
        n_workers, page_words=cfg.page_words, protocol=cfg.protocol,
        cost=cfg.cost, prefetch=cfg.prefetch,
        model_mechanism=cfg.model_mechanism,
        instr_s_per_word=cfg.instr_s_per_word, fault_s=cfg.fault_s,
        fetch_batch=cfg.fetch_batch, backend=cfg.backend,
        cache_pages=cfg.cache_pages, danger_mode=cfg.danger_mode,
        detect_races=cfg.detect_races, chaos=cfg.chaos,
        injector=cfg.injector, straggler=cfg.straggler, device=cfg.device)
