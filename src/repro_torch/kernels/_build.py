"""Build the package's CUDA sources at first use, load them with ctypes,
and launch their entries.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch/lib<name>_<hash>.so <name>.cu

The library lands in ``build/repro_torch/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.
Sources are compiled in parallel, one ``nvcc`` process each, all started
together.  Nothing here runs at import time: the first wrapper that
launches a kernel triggers the build.

``Kernels`` binds one source's C entries (``rt_<name>``, each taking its
operands and a stream and returning a cudaError) and counts launches and
wrapper calls; ``check``, ``on_card`` and ``ptr`` are the wrappers' shared
operand helpers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda); "
                       "the CUDA kernels are built from source at first use")


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build(*sources: str) -> Dict[str, Path]:
    """Compile every source whose library is missing, all at once; returns
    the library path of each source.  Raises with nvcc's output when a
    compile fails."""
    paths = {s: library_path(s) for s in sources}
    todo = {s: p for s, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for s, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
        procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, p)
    failed = []
    for s, (proc, tmp, p) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{s}:\n{out}")
        else:
            os.replace(tmp, p)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    lib = _LOADED.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)[source]))
        _LOADED[source] = lib
    return lib


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
          device: torch.device):
    """Raise unless ``t`` has ``dtype``, ``ndim`` dimensions, lies on
    ``device`` and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def on_card(device: torch.device) -> bool:
    """True for a CUDA device (launch the kernel), False for the CPU (run
    the plain version); any other device raises."""
    if device.type == "cuda":
        return True
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return False


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


class Kernels:
    """The C entries of ``csrc/<source>``: ``signatures`` maps each kernel
    name to the ctypes types of its operands (the stream comes last and is
    added here).  ``launches[name]`` counts the launches of each kernel
    and is bumped nowhere else; ``calls[name]`` counts the calls of its
    wrapper on any device (``called``), so a CPU run says how many
    launches the same run makes on the card."""

    def __init__(self, source: str, signatures: Dict[str, Tuple]):
        self.source = source
        self.signatures = signatures
        self.launches = dict.fromkeys(signatures, 0)
        self.calls = dict.fromkeys(signatures, 0)
        self._bound: Dict[str, object] = {}

    def reset(self):
        for counts in (self.launches, self.calls):
            for k in counts:
                counts[k] = 0

    def called(self, name: str):
        self.calls[name] += 1

    def entry(self, name: str):
        """The bound C function ``rt_<name>``, built and loaded on first
        use."""
        if not self._bound:
            lib = load(self.source)
            for kernel, argtypes in self.signatures.items():
                f = getattr(lib, "rt_" + kernel)
                f.argtypes = [*argtypes, ctypes.c_void_p]
                f.restype = ctypes.c_int
                self._bound[kernel] = f
        return self._bound[name]

    def launch(self, name: str, device: torch.device, *args):
        """Launch ``name`` on ``device``'s current stream; raise if the
        launch was refused."""
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = self.entry(name)(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
        self.launches[name] += 1
