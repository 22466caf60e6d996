"""Per-replica radix prefix index over token-block hashes.

The KV plane's data structure (SGLang's RadixAttention / vLLM's hash-based
prefix caching, adapted to the paged accounting this repo already has): the
prompt is split into fixed-size token blocks, each block identified by a
*chained* hash — block ``i``'s hash mixes block ``i-1``'s hash with the
block's token content, so equal hashes imply equal *prefixes*, not just
equal blocks.  Cached blocks form a radix tree (one node per block, children
keyed by hash); a new request walks the tree to find its longest cached
prefix and only prefills the uncached suffix.

Memory accounting is shared with the executor: the index allocates every
cached block out of the same :class:`repro_torch.serving.kv_cache.BlockPool` the
running sequences draw from (one pool, two tenants), so prefix caching and
decode growth genuinely contend for KV capacity — exactly the pressure the
router's KV-occupancy signal must see.  Invariants (property-tested):

* every resident node owns exactly one pool block under its own alloc key;
* ``cached_blocks`` equals the pool's total radix-tenant allocation;
* pinned nodes (an in-flight request's prefix path) are never evicted;
* eviction is leaf-first LRU, so the tree always stores closed prefixes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from ..serving.kv_cache import BlockPool

_MASK64 = (1 << 64) - 1


def mix_hash(a: int, b: int) -> int:
    """Deterministic 64-bit mix (splitmix-style) — independent of
    PYTHONHASHSEED, stable across platforms and runs."""
    x = (a * 0x9E3779B97F4A7C15 + b + 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def chain_block_hashes(tokens: Sequence[int], block_size: int,
                       seed: int = 0x5EED) -> tuple[int, ...]:
    """Chained hashes of every *full* token block of ``tokens`` (vLLM-style:
    partial trailing blocks are never cacheable)."""
    out: list[int] = []
    h = seed
    n_full = len(tokens) // block_size
    for i in range(n_full):
        for t in tokens[i * block_size:(i + 1) * block_size]:
            h = mix_hash(h, int(t))
        out.append(h)
    return tuple(out)


@dataclass
class _Node:
    """One cached token block.  ``pins`` counts in-flight requests whose
    prefix path runs through this node; a pinned node (or any ancestor of a
    pinned node — pins are taken along the whole path) cannot be evicted."""

    hash: int
    parent: Optional["_Node"]
    node_id: int
    depth: int                       # blocks from root (root excluded)
    children: dict = field(default_factory=dict)   # hash -> _Node
    pins: int = 0
    hits: int = 0
    last_access: float = 0.0


@dataclass
class PrefixMatch:
    """Longest cached prefix for one hash chain."""

    node: Optional[_Node]            # deepest matched node (None = no match)
    blocks: int                      # matched full blocks

    def tokens(self, block_size: int) -> int:
        """Matched prefix depth in tokens (blocks x block_size)."""
        return self.blocks * block_size


class RadixPrefixIndex:
    """Refcounted radix tree of cached KV blocks over one replica's pool.

    ``capacity_blocks`` caps the index's pool footprint (None = may use the
    whole pool); the executor's own allocations always win ties — ``insert``
    never evicts *running* sequences, only colder cached prefixes, and gives
    up when the pool is genuinely full.
    """

    def __init__(self, pool: BlockPool, block_size: int = 16,
                 capacity_blocks: Optional[int] = None):
        self.pool = pool
        self.block_size = block_size
        self.capacity_blocks = capacity_blocks
        # Eviction callback: ``on_evict(node_id)`` fires whenever a node
        # leaves the tree (LRU eviction or clear()).  The real engine hangs
        # its host-side KV block store off this so evicted prefixes drop
        # their tensors in the same breath as their pool blocks.
        self.on_evict: Optional[Callable[[int], None]] = None
        self._root = _Node(hash=0, parent=None, node_id=0, depth=0)
        self._next_id = 1
        self._nodes: dict[int, _Node] = {}       # node_id -> node (non-root)
        self._leaves: dict[int, _Node] = {}      # childless nodes (eviction
                                                 # candidates; scanned by LRU)
        self.cached_blocks = 0
        # telemetry
        self.hits = 0                            # matched blocks (cumulative)
        self.lookups = 0
        self.inserted = 0
        self.evicted = 0

    # ---- lookup ----------------------------------------------------------

    def match(self, hashes: Sequence[int], now: float = 0.0,
              touch: bool = True) -> PrefixMatch:
        """Longest cached prefix of ``hashes``.  ``touch=False`` is the
        router's read-only probe (no LRU refresh, no hit counters) so that
        costing N replicas per arrival doesn't distort eviction order."""
        node = self._root
        depth = 0
        for h in hashes:
            child = node.children.get(h)
            if child is None:
                break
            node = child
            depth += 1
            if touch:
                node.last_access = now
                node.hits += 1
        if touch:
            self.lookups += 1
            self.hits += depth
        return PrefixMatch(node=node if depth else None, blocks=depth)

    # ---- pinning ---------------------------------------------------------

    def pin(self, node: Optional[_Node]) -> None:
        """Pin the path root→node (in-flight request holds this prefix)."""
        while node is not None and node is not self._root:
            node.pins += 1
            node = node.parent

    def unpin(self, node: Optional[_Node]) -> None:
        """Release one pin on a node's path (eviction eligibility returns
        when the last pin drops)."""
        while node is not None and node is not self._root:
            node.pins = max(0, node.pins - 1)
            node = node.parent

    # ---- insert / evict --------------------------------------------------

    def _alloc_key(self, node_id: int) -> tuple:
        return ("pfx", id(self), node_id)

    def insert(self, hashes: Sequence[int], now: float = 0.0
               ) -> tuple[Optional[_Node], int]:
        """Insert the chain, allocating one pool block per new node (evicting
        cold cached blocks if needed, never running sequences).  Stops at the
        first block the pool cannot hold — the cached set stays a closed
        prefix.  Returns (deepest resident node, newly inserted blocks)."""
        node = self._root
        new = 0
        for h in hashes:
            child = node.children.get(h)
            if child is None:
                # Guard the node being extended: it may be a leaf, and
                # _make_room's LRU sweep must not evict the very path this
                # insert is growing (ancestors are safe — they have
                # children).
                node.pins += 1
                ok = self._make_room()
                node.pins -= 1
                if not ok:
                    break
                child = _Node(hash=h, parent=node, node_id=self._next_id,
                              depth=node.depth + 1)
                if not self.pool.allocate(self._alloc_key(child.node_id),
                                          self.block_size):
                    break
                self._next_id += 1
                node.children[h] = child
                self._nodes[child.node_id] = child
                self._leaves.pop(node.node_id, None)   # parent grew a child
                self._leaves[child.node_id] = child
                self.cached_blocks += 1
                self.inserted += 1
                new += 1
            child.last_access = now
            node = child
        return (node if node is not self._root else None), new

    def _make_room(self) -> bool:
        """Ensure one block is allocatable: respect the capacity cap, then
        evict LRU leaves if the pool itself is full."""
        if (self.capacity_blocks is not None
                and self.cached_blocks >= self.capacity_blocks
                and not self._evict_one()):
            return False
        if self.pool.free_blocks >= 1:
            return True
        return self._evict_one() and self.pool.free_blocks >= 1

    def _evict_one(self) -> bool:
        # Scan only the leaf set (childless nodes): for chain-shaped reuse
        # (conversations, agent trees) leaves number the live branches,
        # not the cached blocks, so eviction at a full pool stays cheap.
        victim: Optional[_Node] = None
        for node in self._leaves.values():
            if node.pins:
                continue
            if victim is None or node.last_access < victim.last_access \
                    or (node.last_access == victim.last_access
                        and node.node_id < victim.node_id):
                victim = node
        if victim is None:
            return False
        self._remove(victim)
        return True

    def evict(self, n_blocks: int) -> int:
        """Evict up to ``n_blocks`` cold blocks (LRU leaves first).  Returns
        the number actually freed."""
        freed = 0
        while freed < n_blocks and self._evict_one():
            freed += 1
        return freed

    def _remove(self, node: _Node) -> None:
        assert not node.children and node.pins == 0
        self.pool.free(self._alloc_key(node.node_id))
        if self.on_evict is not None:
            self.on_evict(node.node_id)
        node.parent.children.pop(node.hash, None)
        self._nodes.pop(node.node_id, None)
        self._leaves.pop(node.node_id, None)
        parent = node.parent
        if parent is not self._root and not parent.children:
            self._leaves[parent.node_id] = parent
        self.cached_blocks -= 1
        self.evicted += 1

    def clear(self) -> None:
        """Drop the whole index (replica failure: the KV is gone)."""
        for node in list(self._nodes.values()):
            node.pins = 0
            node.children = {}
        for node in list(self._nodes.values()):
            self.pool.free(self._alloc_key(node.node_id))
            if self.on_evict is not None:
                self.on_evict(node.node_id)
        self._root = _Node(hash=0, parent=None, node_id=0, depth=0)
        self._nodes.clear()
        self._leaves.clear()
        self.cached_blocks = 0

    # ---- directory advertisement ----------------------------------------

    def hot_adverts(self, k: int = 64) -> dict[int, int]:
        """The replica's hottest cached prefixes as ``{block_hash: depth}``
        — what it publishes to the fleet :class:`PrefixDirectory`.  Ranked
        by (hits, depth): a deep, frequently re-matched node is the most
        valuable remote-fetch target."""
        ranked = sorted(self._nodes.values(),
                        key=lambda n: (n.hits, n.depth), reverse=True)
        return {n.hash: n.depth for n in ranked[:k]}

    # ---- introspection ---------------------------------------------------

    def check_invariants(self) -> None:
        """Assert the pool/tree accounting invariants (test hook)."""
        radix_allocs = sum(v for key, v in self.pool.allocs.items()
                           if isinstance(key, tuple) and key[0] == "pfx"
                           and key[1] == id(self))
        blocks_per_node = self.pool.blocks_for(self.block_size)
        assert radix_allocs == self.cached_blocks * blocks_per_node, \
            (radix_allocs, self.cached_blocks)
        assert len(self._nodes) == self.cached_blocks
        used = sum(self.pool.allocs.values())
        assert self.pool.free_blocks + used == self.pool.total_blocks
        assert set(self._leaves) == {n.node_id for n in self._nodes.values()
                                     if not n.children}
        for node in self._nodes.values():
            assert node.pins >= 0
            assert node.parent.children.get(node.hash) is node
            if node.pins and node.parent is not self._root:
                # pins are path-complete: an ancestor is at least as pinned
                assert node.parent.pins >= node.pins

    def stats(self) -> dict:
        """Cache telemetry: nodes, resident blocks, lookups, hits, evictions."""
        return {"cached_blocks": self.cached_blocks,
                "lookups": self.lookups, "hit_blocks": self.hits,
                "inserted": self.inserted, "evicted": self.evicted,
                "hit_rate": self.hits / max(self.lookups, 1)}
