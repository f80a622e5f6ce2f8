"""RegC gradient synchronisation (``regc_sync/`` of the reference): the
sync policy, the barrier sync of gradients, the int8 ring and the
reduction extension, over the ranks of a ``torch.distributed`` world."""
from repro_torch.regc_sync.policies import (
    RegCSyncPolicy, barrier_sync_grads, ring_allreduce_int8, span_reduce,
)

__all__ = ["RegCSyncPolicy", "barrier_sync_grads", "ring_allreduce_int8",
           "span_reduce"]
