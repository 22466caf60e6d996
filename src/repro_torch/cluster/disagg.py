"""Disaggregated prefill/decode: KV-handoff types + interconnect accounting.

When the cluster runs split pools (DistServe / Splitwise style), a prefill
replica finishes the prompt pass and ships the request's KV cache to a
decode replica.  ``HandoffChannel`` charges the transfer against the link
bandwidth and keeps the aggregate accounting (handoffs, bytes, seconds)
that the benchmarks report.  Between two H100 cards the KV hop is an
NVLink transfer, so the default rate is one direction of NVLink 4
(``core.cost_model.H100_NVLINK_BW``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.cost_model import H100_NVLINK_BW
from ..core.types import Request


@dataclass
class KVHandoff:
    """One prefilled request in transit from a prefill to a decode replica."""

    req: Request
    kv_tokens: int
    src_replica: int
    kv_bytes: float = 0.0
    dst_replica: int = -1
    ready_time: float = 0.0          # when the KV lands on the destination
    transfer_time: float = 0.0


@dataclass
class HandoffChannel:
    """Shared interconnect between the prefill and decode pools.

    Transfers are serialized per channel (one link-group); ``send``
    returns the handoff stamped with its arrival time at the destination.
    """

    bandwidth: float = H100_NVLINK_BW
    latency: float = 20e-6           # per-hop launch latency
    busy_until: float = 0.0

    # accounting
    handoffs: int = 0
    total_bytes: float = 0.0
    total_transfer_time: float = 0.0

    def send(self, handoff: KVHandoff, now: float, dst_replica: int) -> KVHandoff:
        """Charge one KV transfer against the serialized channel; returns the
        handoff stamped with its destination arrival time."""
        start = max(now, self.busy_until)
        xfer = self.latency + handoff.kv_bytes / max(self.bandwidth, 1.0)
        self.busy_until = start + xfer
        handoff.dst_replica = dst_replica
        handoff.ready_time = start + xfer
        handoff.transfer_time = xfer
        self.handoffs += 1
        self.total_bytes += handoff.kv_bytes
        self.total_transfer_time += xfer
        return handoff

    def stats(self) -> dict:
        """Aggregate handoff accounting (count, bytes, transfer seconds)."""
        return {"handoffs": self.handoffs,
                "total_gb": self.total_bytes / 1e9,
                "total_transfer_s": self.total_transfer_time,
                "mean_transfer_ms": (self.total_transfer_time
                                     / max(self.handoffs, 1) * 1e3)}
