"""Prefix-reuse KV plane of the port: the per-replica radix prefix index
(a copy of the JAX package's ``kvplane.radix``).

:class:`RadixPrefixIndex` caches KV blocks per replica (chained token-block
hashes, refcounted sharing, LRU eviction, in-flight pinning) out of the same
``BlockPool`` the executor allocates from.  The fleet directory, the link
topology and the shared-prefix workloads come with the port's fleet.
"""

from .radix import (PrefixMatch, RadixPrefixIndex, chain_block_hashes,
                    mix_hash)

__all__ = ["RadixPrefixIndex", "PrefixMatch", "chain_block_hashes",
           "mix_hash"]
