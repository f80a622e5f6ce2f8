"""Op-level accounting of one rank's step: FLOPs, HBM bytes, collective
bytes and peak live bytes (the port's counterpart of the reference's
``launch/hlo_analysis.py``).

The reference parses the HLO text of a compiled GSPMD program, because
that text is all XLA hands back: ops inside while bodies have to be
multiplied by trip counts recovered from loop conditions.  An eager
PyTorch step has no program text and no loops to recover: every op it
runs reaches the dispatcher once, in order, with its operands.  So
``analyze`` runs the step under a ``TorchDispatchMode`` (on ``meta``
tensors in the dry run, where nothing is computed) and counts each op as
it passes.  ``OpStats`` keeps ``HloStats``'s fields and meanings:

* ``flops``: 2*M*N*K of the matmul-class ops (``mm``, ``bmm``,
  ``addmm``, ``baddbmm`` and the rest of
  ``torch.utils.flop_counter``'s table; the reference counts ``dot``);
  ``dot_count`` how many ran;
* ``bytes_dot``: those ops' operands plus outputs;
* ``bytes_accessed``: every op's tensor inputs plus outputs, views and
  metadata-only ops left out (the reference's ``_SKIP_BYTES_OPS``): the
  pessimistic bound;
* ``bytes_entry``: the step's tensor arguments read once and outputs
  written once, plus the optimiser's elementwise passes: every op that
  runs with autograd off, outside a backward and outside an
  ``autograd.Function``'s forward (the update under ``torch.no_grad``),
  as the reference's entry computation holds the update outside its
  layer loops;
* ``bytes_hbm_est = bytes_dot + bytes_entry``;
* ``collective_bytes`` / ``collective_count`` under the reference's five
  kinds, zeros where the port has none (all-to-all,
  collective-permute), each message at ``max(operand, result)`` bytes
  as the reference charges it: ``models.collectives`` counts the
  operand, so an all-gather's result is that times its group's size.

``while_trips`` has no counterpart: eager code runs its loops in Python
and the dispatcher sees every trip.

``peak_bytes`` is the most that the storages the step creates held at
once (each counted from the op that made it until it is freed); the
step's arguments are not in it.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Dict

import torch
from torch.autograd.function import FunctionCtx
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.models import collectives as C

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    bytes_dot: float = 0.0
    bytes_entry: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    collective_count: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    dot_count: float = 0.0
    peak_bytes: int = 0
    ops: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    @property
    def bytes_hbm_est(self) -> float:
        """HBM-traffic estimate: the matmuls' operands and outputs (each
        visit, remat recompute included) plus the entry's passes (the
        arguments, the outputs and the optimiser's update)."""
        return self.bytes_dot + self.bytes_entry


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensors(tree, out=None) -> list:
    """The tensors of a tree of tuples, lists and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            tensors(x, out)
    return out


class _Counter(TorchDispatchMode):
    def __init__(self, stats: OpStats, known):
        super().__init__()
        self.stats = stats
        self.live = 0
        # storages seen: the arguments' (not counted) and the step's own
        self.seen: Dict[int, bool] = {}
        for t in known:
            self._see(t.untyped_storage(), count=False)

    def _see(self, st, count: bool):
        key = id(st)
        if key in self.seen:
            return
        n = st.nbytes() if count else 0
        self.seen[key] = True
        self.live += n
        if self.live > self.stats.peak_bytes:
            self.stats.peak_bytes = self.live
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n):
        self.seen.pop(key, None)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        s = self.stats
        s.ops += 1
        outs = tensors(out)
        for t in outs:
            self._see(t.untyped_storage(), count=True)
        if func.is_view or func._overloadpacket in _METADATA:
            return out
        io = sum(map(_nbytes, tensors((args, kwargs)))) + sum(
            map(_nbytes, outs))
        s.bytes_accessed += io
        packet = func._overloadpacket
        if packet in flop_registry:
            s.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            s.dot_count += 1
            s.bytes_dot += io
        if (not torch.is_grad_enabled()
                and torch._C._current_autograd_node() is None
                and not _in_function_forward()):
            s.bytes_entry += io
        return out


def _in_function_forward() -> bool:
    """Whether an ``autograd.Function``'s forward is on the stack (its
    ops run with autograd off, as the update's do)."""
    f = sys._getframe(2)
    while f is not None:
        if (f.f_code.co_name == "forward"
                and isinstance(f.f_locals.get("ctx"), FunctionCtx)):
            return True
        f = f.f_back
    return False


_aten = torch.ops.aten
# ops that move no data (the reference's parameter/tuple/bitcast/...)
_METADATA = {_aten.detach, _aten.alias, _aten.lift_fresh, _aten.empty,
             _aten.empty_like, _aten.empty_strided, _aten.new_empty,
             _aten.new_empty_strided}


def collective_stats(stats: OpStats, mesh, counts_bytes, counts_msgs):
    """Fill ``stats``'s collective fields from a rank's
    ``models.collectives`` counters, by (kind, axes): an all-gather's
    message at its result's bytes (operand times the group's size), the
    others at their operand's."""
    for (kind, axes), b in counts_bytes.items():
        stats.collective_bytes[kind] += float(
            b * (mesh.size(axes) if kind == "all-gather" else 1))
        stats.collective_count[kind] += float(counts_msgs[(kind, axes)])


def analyze(fn, *args, mesh=None, **kwargs):
    """(fn's result, ``OpStats``) of one call of ``fn(*args, **kwargs)``
    counted op by op.  With ``mesh``, the collective fields come from
    the messages ``models.collectives`` counted during the call (its
    counters are reset first and left holding the call's)."""
    stats = OpStats()
    known = tensors((args, kwargs))
    C.reset_collectives()
    with _Counter(stats, known):
        out = fn(*args, **kwargs)
    entry = sum(_nbytes(t) for t in known) + sum(
        _nbytes(t) for t in tensors(out))
    stats.bytes_entry += entry
    if mesh is not None:
        collective_stats(stats, mesh, C.COLLECTIVE_BYTES, C.COLLECTIVE_MSGS)
    return out, stats
