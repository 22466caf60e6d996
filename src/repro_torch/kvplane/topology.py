"""Per-link interconnect topology with compute overlap.

Replaces the data plane's single serialized channel (the
``disagg.HandoffChannel``: *every* KV movement in the cluster queued behind
one ``busy_until``) with a per-directed-link model: each (src, dst) replica
pair owns its own link, so a prefill→decode handoff on one pair no longer
delays a prefix fetch between two other replicas.  Hop count follows a ring
of the replicas (per-hop launch latency adds up), bandwidth is per link;
the default is one direction of an H100's NVLink 4
(``core.cost_model.H100_NVLINK_BW``).

**Compute overlap**: on real hardware the KV transfer is a DMA that runs
under compute — the destination keeps decoding (and the source keeps
prefilling) while blocks stream.  ``overlap`` is the hidden fraction: a
transfer of duration T exposes only ``(1-overlap)·T`` on the critical path
of the request being moved.  ``send`` (handoffs) stamps ``ready_time`` with
the *exposed* completion, and ``transfer`` (remote prefix fetches) returns
the exposed seconds for the caller to charge — both share the same link
clocks, so handoff and fetch traffic genuinely contend per link.

``send`` is signature-compatible with ``HandoffChannel.send`` and ``stats``
is a superset, so the cluster simulator swaps between them freely.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.cost_model import H100_NVLINK_BW


@dataclass
class PrefixFetch:
    """A routing-time plan to pull a cached prefix from a remote replica:
    stamped onto ``Request.prefix_fetch`` by a prefix-aware router,
    executed (charged on the topology) by the destination at dispatch."""

    src_replica: int
    blocks: int                      # advertised prefix depth to fetch
    kv_bytes: float = 0.0


@dataclass
class LinkTopologyConfig:
    """Per-link bandwidth, hop latency, and the compute-overlap factor."""
    link_bandwidth: float = H100_NVLINK_BW   # bytes/s per directed link
    hop_latency: float = 20e-6       # per-hop launch latency (s)
    overlap: float = 0.7             # fraction of transfer hidden by compute
    ring_size: int = 0               # 0 = derive from the ids seen so far


@dataclass
class LinkTopology:
    """Per-(src,dst) link clocks over a ring: KV handoffs and remote
    prefix fetches contend on the same links, overlapped with compute."""
    cfg: LinkTopologyConfig = field(default_factory=LinkTopologyConfig)
    # (src, dst) -> busy-until clock for that directed link
    busy: dict = field(default_factory=dict)
    _max_id: int = 0

    # accounting (superset of HandoffChannel.stats)
    handoffs: int = 0
    fetches: int = 0
    total_bytes: float = 0.0
    total_transfer_time: float = 0.0
    total_exposed_time: float = 0.0

    # ---- geometry --------------------------------------------------------

    def hops(self, src: int, dst: int) -> int:
        """Ring hop distance between two replicas."""
        if src == dst or src < 0 or dst < 0:
            return 0
        self._max_id = max(self._max_id, src, dst)
        n = self.cfg.ring_size or (self._max_id + 1)
        d = abs(src - dst) % max(n, 1)
        return max(min(d, n - d), 1)

    def transfer_time(self, n_bytes: float, src: int, dst: int) -> float:
        """Raw (un-overlapped) wire time for ``n_bytes`` src→dst."""
        return (self.hops(src, dst) * self.cfg.hop_latency
                + n_bytes / max(self.cfg.link_bandwidth, 1.0))

    def exposed_time(self, n_bytes: float, src: int, dst: int) -> float:
        """Critical-path seconds a transfer costs after compute overlap —
        the router's estimate term (no link-clock side effects)."""
        return (1.0 - self.cfg.overlap) * self.transfer_time(n_bytes, src,
                                                             dst)

    # ---- shared link clocks ---------------------------------------------

    def _occupy(self, n_bytes: float, src: int, dst: int,
                now: float) -> tuple[float, float]:
        """Serialize on the (src, dst) link only; returns
        (raw transfer seconds, completion time)."""
        xfer = self.transfer_time(n_bytes, src, dst)
        start = max(now, self.busy.get((src, dst), 0.0))
        self.busy[(src, dst)] = start + xfer
        return xfer, start + xfer

    # ---- traffic ---------------------------------------------------------

    def send(self, handoff, now: float, dst_replica: int):
        """Disaggregated prefill→decode handoff (HandoffChannel-compatible).
        ``ready_time`` reflects compute overlap: the decode replica can
        admit the sequence once the *exposed* tail of the transfer lands."""
        xfer, done = self._occupy(handoff.kv_bytes, handoff.src_replica,
                                  dst_replica, now)
        exposed = (1.0 - self.cfg.overlap) * xfer
        handoff.dst_replica = dst_replica
        handoff.ready_time = done - (xfer - exposed)
        handoff.transfer_time = xfer
        self.handoffs += 1
        self.total_bytes += handoff.kv_bytes
        self.total_transfer_time += xfer
        self.total_exposed_time += exposed
        return handoff

    def fetch(self, n_bytes: float, src: int, dst: int, now: float) -> float:
        """Remote prefix fetch src→dst: charge the link, return the exposed
        seconds the destination must add to its prefill critical path."""
        xfer, _ = self._occupy(n_bytes, src, dst, now)
        exposed = (1.0 - self.cfg.overlap) * xfer
        self.fetches += 1
        self.total_bytes += n_bytes
        self.total_transfer_time += xfer
        self.total_exposed_time += exposed
        return exposed

    def stats(self) -> dict:
        """Aggregate transfer accounting (compatible with HandoffChannel)."""
        moves = self.handoffs + self.fetches
        return {"handoffs": self.handoffs,
                "fetches": self.fetches,
                "total_gb": self.total_bytes / 1e9,
                "total_transfer_s": self.total_transfer_time,
                "total_exposed_s": self.total_exposed_time,
                "mean_transfer_ms": (self.total_transfer_time
                                     / max(moves, 1) * 1e3),
                "links_used": len(self.busy)}
