"""Build the package's CUDA sources at first use, load them with ctypes,
and launch their entries.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch/lib<name>_<hash>.so <name>.cu

The library lands in ``build/repro_torch/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is.
Sources are compiled in parallel, one ``nvcc`` process each, all started
together.  Nothing here runs at import time: the first wrapper that
launches a kernel triggers the build.

``ptxas -v`` reports each kernel's registers, shared memory and spills;
the report is kept beside the library (``lib<name>_<hash>.ptxas.txt``)
and ``resources`` parses it.

``Kernels`` binds one source's C entries (``rt_<name>``, each taking its
operands and a stream and returning a cudaError) and counts launches and
wrapper calls; ``check`` and ``on_card`` are the wrappers' shared operand
helpers.

The launch path is lean, because at the reference engine's shapes (one
page of 256 or 1024 words) the host's work per call is most of a
wrapper's time: each entry is bound once, pointers go to ctypes as
plain ``data_ptr()`` integers, the stream is the raw handle of the
current stream (no ``torch.cuda.Stream`` object), and the device is
switched only when the operands lie on another card than the current
one.  A launch the card refuses still raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
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
            report_path(p).write_text(out)
            os.replace(tmp, p)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def report_path(library: Path) -> Path:
    return library.with_name(library.stem + ".ptxas.txt")


def resources(source: str) -> List[Dict[str, object]]:
    """The ``ptxas -v`` report of ``csrc/<source>``'s built library: one
    dict per kernel (its mangled ``name``, ``registers``, static
    ``smem_bytes``, ``stack_bytes``, ``spill_stores`` and
    ``spill_loads`` in bytes)."""
    text = report_path(library_path(source)).read_text()
    out: List[Dict[str, object]] = []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            out.append({"name": m.group(1), "registers": 0, "smem_bytes": 0,
                        "stack_bytes": 0, "spill_stores": 0,
                        "spill_loads": 0})
            continue
        if not out:
            continue
        k = out[-1]
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            k["stack_bytes"], k["spill_stores"], k["spill_loads"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            k["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            k["smem_bytes"] = int(m.group(1)) if m else 0
    return out


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
    ``device`` and is contiguous (one combined test when all hold)."""
    if (t.dtype is dtype and t.dim() == ndim and t.is_contiguous()
            and t.device == device):
        return
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def on_card(t: torch.Tensor) -> bool:
    """True for a tensor on a CUDA device (launch the kernel), False for
    one on the CPU (run the plain version); any other device raises."""
    if t.is_cuda:
        return True
    if not t.is_cpu:
        raise ValueError(f"unsupported device {t.device}")
    return False


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

    def launch(self, name: str, device, *args, launches: int = 1):
        """Launch ``name`` on the current stream of ``device`` (a CUDA
        ``torch.device`` or its index); raise if the launch was
        refused.  ``launches`` is the number of kernel launches the C
        entry makes for this call."""
        f = self._bound.get(name) or self.entry(name)
        index = device if device.__class__ is int else device.index
        current = torch._C._cuda_getDevice()
        if index is None or index == current:
            rc = f(*args, torch._C._cuda_getCurrentRawStream(current))
        else:
            with torch.cuda.device(index):
                rc = f(*args, torch._C._cuda_getCurrentRawStream(index))
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
        self.launches[name] += launches
