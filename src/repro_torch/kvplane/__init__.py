"""Prefix-reuse KV plane: radix prefix caching, fleet prefix directory,
per-link KV-transfer topology, and shared-prefix workload generation (a
copy of the JAX package's ``kvplane``; link rates default to H100 NVLink).

The subsystem spans three layers:

* **serving** — :class:`RadixPrefixIndex` caches KV blocks per replica
  (chained token-block hashes, refcounted sharing, LRU eviction, in-flight
  pinning) out of the same ``BlockPool`` the executor allocates from;
* **cluster** — :class:`PrefixDirectory` is the bounded, epoch-versioned
  fleet view of who holds which hot prefixes, and :class:`LinkTopology`
  models per-link KV movement (handoffs + remote prefix fetches) with
  compute overlap;
* **scheduling** — requests carry ``prompt_hashes``/``cached_len``, and the
  cost model / router / EWSJF scoring consume *effective* (uncached-suffix)
  lengths, so a long prompt with a hot prefix schedules like the short job
  it actually is.
"""

from .directory import PrefixDirectory, PrefixDirectoryConfig
from .radix import (PrefixMatch, RadixPrefixIndex, chain_block_hashes,
                    mix_hash)
from .topology import LinkTopology, LinkTopologyConfig, PrefixFetch
from .workload import (SharedPrefixWorkloadSpec, agentic_mix,
                       unique_hashes_for)

__all__ = [
    "RadixPrefixIndex", "PrefixMatch", "chain_block_hashes", "mix_hash",
    "PrefixDirectory", "PrefixDirectoryConfig",
    "LinkTopology", "LinkTopologyConfig", "PrefixFetch",
    "SharedPrefixWorkloadSpec", "agentic_mix", "unique_hashes_for",
]
