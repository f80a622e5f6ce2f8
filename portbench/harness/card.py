"""The process around a run: cache directories inside the checkout, the
look for cards, the float32 settings, the device record and the guard
against the JAX package.

``prepare_env`` runs before ``torch`` is imported.  Every cache a run
could write (Triton's, Inductor's, the extension builder's, CUDA's JIT
cache) goes to a fixed directory under ``build/portbench/`` in the
checkout; the port's own CUDA libraries go to ``build/repro_torch/``
(``repro_torch.kernels._build``).  So only a checkout's first run
builds, and two checkouts share nothing.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

# top-level module names a run may not hold once its window has closed:
# the JAX package, JAX itself and the JAX package's benchmark harness
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def prepare_env(root: Path):
    cache = root / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(cache / sub)
    # a library that would load JAX by itself is kept from doing so
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules():
    """The forbidden top-level names ``sys.modules`` holds, compared
    whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


class NoCard(RuntimeError):
    pass


def require_cards(torch, n: int):
    """Raise ``NoCard`` unless this process sees ``n`` CUDA cards."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark "
                     "measures the card and has no CPU fallback")
    have = torch.cuda.device_count()
    if have < n:
        raise NoCard(f"the cell asks for {n} cards, this process sees {have}")


def float32_settings(torch, tf32: bool):
    """float32 products in float32 (TF32 off), as the configurations
    state; ``tf32`` turns TF32 on, for the control only."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def device_record(torch, device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
