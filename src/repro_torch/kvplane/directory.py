"""Fleet prefix directory — which replicas hold which hot prefixes.

The cluster-level half of the KV plane: each replica periodically publishes
its hottest cached prefixes (``RadixPrefixIndex.hot_adverts`` — a bounded
``{block_hash: depth}`` map), and the directory merges them into one
bounded, epoch-versioned view the router consults per arrival.  The sync
protocol mirrors the :class:`~repro_torch.cluster.policy_store.PolicyStore`:
publish is last-writer-wins per replica and never blocks; merge runs on the
control plane's cadence; staleness is counted in merge rounds so a dead
publisher's adverts age out even when nothing else changes; the **epoch**
advances only when the merged view materially changed, so router-side memos
keyed on it stay valid across no-op syncs.

The directory stores *hashes*, never tokens — chained block hashes identify
prefixes without carrying content, so the fleet view is cheap to ship and
holds no prompt text.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence


@dataclass
class PrefixDirectoryConfig:
    """Sync cadence, capacity bound, and staleness window for the fleet
    prefix map."""
    sync_interval: float = 2.0       # publish→merge cadence (s)
    advertise_k: int = 64            # per-replica advert cap (enforced here too)
    max_entries: int = 4096          # bound on distinct hashes in the view
    max_staleness_rounds: int = 4    # drop a publisher after this many
                                     # merge rounds without a republish


@dataclass
class _Advert:
    replica_id: int
    adverts: Dict[int, int]          # block_hash -> depth (blocks from root)
    time: float


class PrefixDirectory:
    """Bounded, epoch-versioned map ``block_hash -> {replica_id: depth}``."""

    def __init__(self, cfg: PrefixDirectoryConfig | None = None):
        self.cfg = cfg or PrefixDirectoryConfig()
        self._adverts: dict[int, _Advert] = {}
        self._pub_round: dict[int, int] = {}
        self._round = 0
        self._last_sync = float("-inf")
        self.epoch = 0
        self._by_hash: dict[int, dict[int, int]] = {}
        # telemetry
        self.publishes = 0
        self.merges = 0
        self.stale_dropped = 0
        self.truncated = 0               # hashes dropped by the entry bound

    # ---- cadence ---------------------------------------------------------

    def due(self, now: float) -> bool:
        """Whether a directory sync round is owed on the shared cadence."""
        return now - self._last_sync >= self.cfg.sync_interval

    # ---- publish / forget ------------------------------------------------

    def publish(self, replica_id: int, adverts: Dict[int, int],
                now: float) -> None:
        """Record one replica's advertisement (last-writer-wins)."""
        if len(adverts) > self.cfg.advertise_k:
            ranked = sorted(adverts.items(), key=lambda kv: kv[1],
                            reverse=True)[:self.cfg.advertise_k]
            adverts = dict(ranked)
        self._adverts[replica_id] = _Advert(replica_id, dict(adverts), now)
        self._pub_round[replica_id] = self._round
        self.publishes += 1

    def forget(self, replica_id: int) -> None:
        """A failed/drained replica's KV is gone — drop its adverts now and
        rebuild the view so the router never fetches from a corpse."""
        if self._adverts.pop(replica_id, None) is not None:
            self._pub_round.pop(replica_id, None)
            self._rebuild()

    # ---- merge -----------------------------------------------------------

    def merge(self, now: float) -> None:
        """One merge round: age out stale publishers, rebuild the bounded
        view, advance the epoch only on material change."""
        self._last_sync = now
        self._round += 1
        stale = [rid for rid, rnd in self._pub_round.items()
                 if self._round - rnd > self.cfg.max_staleness_rounds]
        for rid in stale:
            self._adverts.pop(rid, None)
            self._pub_round.pop(rid, None)
            self.stale_dropped += 1
        self._rebuild()
        self.merges += 1

    def _rebuild(self) -> None:
        by_hash: dict[int, dict[int, int]] = {}
        for adv in self._adverts.values():
            for h, depth in adv.adverts.items():
                by_hash.setdefault(h, {})[adv.replica_id] = depth
        if len(by_hash) > self.cfg.max_entries:
            # Keep the hottest hashes: most advertisers first (a prefix many
            # replicas hold is hot fleet-wide), deepest second (more blocks
            # saved per hit).
            ranked = sorted(
                by_hash.items(),
                key=lambda kv: (len(kv[1]), max(kv[1].values())),
                reverse=True)
            self.truncated += len(by_hash) - self.cfg.max_entries
            by_hash = dict(ranked[:self.cfg.max_entries])
        if by_hash != self._by_hash:
            self._by_hash = by_hash
            self.epoch += 1

    # ---- read side -------------------------------------------------------

    def lookup(self, hashes: Sequence[int]) -> dict[int, int]:
        """Deepest advertised prefix of ``hashes`` per replica:
        ``{replica_id: matched_blocks}``.  Walks the chain deepest-first so
        the first advertised hash seen per replica is its best match."""
        out: dict[int, int] = {}
        for i in range(len(hashes) - 1, -1, -1):
            holders = self._by_hash.get(hashes[i])
            if not holders:
                continue
            for rid in holders:
                if rid not in out:
                    out[rid] = i + 1
            # every replica can only improve at shallower depths, so once
            # all publishers are matched we are done
            if len(out) == len(self._adverts):
                break
        return out

    def best_holder(self, hashes: Sequence[int],
                    exclude: Optional[int] = None) -> tuple[int, int]:
        """(replica_id, blocks) of the deepest advertised holder, excluding
        ``exclude`` (the candidate replica itself).  (-1, 0) when none."""
        best_rid, best_blocks = -1, 0
        for rid, blocks in self.lookup(hashes).items():
            if rid == exclude:
                continue
            if blocks > best_blocks or (blocks == best_blocks
                                        and rid < best_rid):
                best_rid, best_blocks = rid, blocks
        return best_rid, best_blocks

    def advertised_replicas(self) -> set:
        """Replica ids present in the merged view.  Conformance surface:
        a forgotten or staled-out publisher must never appear here (the
        router would plan fetches from a corpse)."""
        out: set = set()
        for holders in self._by_hash.values():
            out.update(holders)
        return out

    def stats(self) -> dict:
        """Directory telemetry: epoch, entry count, publish/merge totals."""
        return {"epoch": self.epoch, "entries": len(self._by_hash),
                "publishers": len(self._adverts),
                "publishes": self.publishes, "merges": self.merges,
                "stale_dropped": self.stale_dropped,
                "truncated": self.truncated}
