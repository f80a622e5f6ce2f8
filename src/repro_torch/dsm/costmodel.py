"""Linear (alpha-beta) interconnect + node cost model.

Traffic counts in the DSM runtime are EXACT (every byte is accounted as
the protocol moves it); only *time* is modeled, as latency +
bytes/bandwidth.  ``IB_2013`` is the paper's System G: QDR InfiniBand
(32 Gbit/s effective, ~1.3 us), dual quad-core 2.8 GHz Harpertown nodes
(8 cores/node), node memory bandwidth ~6.4 GB/s shared across the node's
cores.  The constants and every formula are those of the reference
package, so modeled clocks agree bit for bit.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CostModel:
    name: str
    net_latency_s: float          # per message
    net_bw_Bps: float             # per link
    node_mem_bw_Bps: float        # all sockets of a node combined
    node_size: int                # workers per node (placement fills nodes)
    flops_per_worker: float       # SUSTAINED scalar flops per worker
    socket_size: int = 0          # 0 = no socket effect; else cores/socket:
    #   <= socket_size workers see only one socket's memory bandwidth
    #   (node_mem_bw / n_sockets), the paper's fill-socket-0-first placement

    def node_bw(self, workers_sharing: int) -> float:
        if self.socket_size and workers_sharing <= self.socket_size:
            n_sockets = max(1, self.node_size // self.socket_size)
            return self.node_mem_bw_Bps / n_sockets
        return self.node_mem_bw_Bps

    def xfer_s(self, n_bytes: float, n_msgs: int = 1) -> float:
        return self.net_latency_s * n_msgs + n_bytes / self.net_bw_Bps

    def mem_s(self, n_bytes: float, workers_sharing: int = 1) -> float:
        bw = self.node_bw(workers_sharing) / max(1, workers_sharing)
        return n_bytes / bw

    def compute_s(self, flops: float = 0.0, mem_bytes: float = 0.0,
                  workers_sharing: int = 1) -> float:
        return max(flops / self.flops_per_worker,
                   self.mem_s(mem_bytes, workers_sharing))

    def workers_on_node(self, n_workers: int) -> int:
        return min(n_workers, self.node_size)


IB_2013 = CostModel(
    name="ib2013",
    net_latency_s=1.3e-6,
    net_bw_Bps=4.0e9,             # QDR 32 Gbit/s
    node_mem_bw_Bps=6.4e9,        # Penryn Harpertown node (STREAM-class)
    node_size=8,
    socket_size=4,                # dual quad-core, fill-first placement
    flops_per_worker=2.8e9,       # 2.8 GHz, ~1 sustained flop/cycle
)
