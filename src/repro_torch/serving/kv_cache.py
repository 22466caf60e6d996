"""Paged KV block pool + slot-based decode cache management.

Two layers of bookkeeping, mirroring vLLM's split between logical blocks
and physical memory (TPU adaptation — DESIGN.md §3):

* ``BlockPool`` — host-side paged accounting (allocate/free/fragmentation
  stats).  The EWSJF admission budget reads ``free_blocks`` from here, so
  scheduling semantics match vLLM's: a request is admitted only when its
  prompt fits in free pages, decode growth can exhaust the pool and trigger
  preemption.
* ``SlotAllocator`` — the static-shape execution side: a fixed number of
  decode slots (batch rows of the compiled serve_step); each active
  sequence owns one slot + its pages.

The Pallas paged_attention kernel consumes the same (pages, block_table)
layout; the CPU engine uses contiguous per-slot caches with the identical
accounting so scheduler behaviour is bit-identical.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class BlockPool:
    """Host-side paged KV accounting: a fixed budget of fixed-size blocks,
    allocated per sequence id.  Admission reads ``free_blocks``; decode
    growth that cannot be satisfied triggers preemption upstream."""

    total_blocks: int
    block_size: int = 16
    free_blocks: int = field(init=False)
    allocs: dict = field(default_factory=dict)    # seq_id -> n_blocks

    def __post_init__(self):
        self.free_blocks = self.total_blocks

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` KV entries (ceil division)."""
        return -(-tokens // self.block_size)

    def can_allocate(self, tokens: int) -> bool:
        """True when ``tokens`` worth of blocks fit in the free pool."""
        return self.blocks_for(tokens) <= self.free_blocks

    def allocate(self, seq_id: int, tokens: int) -> bool:
        """Guarded allocation for a sequence; False (no-op) on exhaustion."""
        need = self.blocks_for(tokens)
        if need > self.free_blocks:
            return False
        self.free_blocks -= need
        self.allocs[seq_id] = self.allocs.get(seq_id, 0) + need
        return True

    def allocate_unchecked(self, seq_id, tokens: int) -> int:
        """Allocate without the free-space guard (``free_blocks`` may go
        negative).  The cluster replica executor uses this to reproduce the
        DES's historical accounting exactly: batch admission is guarded
        upstream on *prompt* blocks, so the +1-token decode block of a
        boundary-length prompt may transiently overdraw the pool — the
        decode-time preemption loop then reclaims.  Returns blocks taken."""
        need = self.blocks_for(tokens)
        self.free_blocks -= need
        self.allocs[seq_id] = self.allocs.get(seq_id, 0) + need
        return need

    def grow(self, seq_id: int, new_total_tokens: int) -> bool:
        """Ensure seq owns enough blocks for new_total_tokens; may fail."""
        need = self.blocks_for(new_total_tokens) - self.allocs.get(seq_id, 0)
        if need <= 0:
            return True
        if need > self.free_blocks:
            return False
        self.free_blocks -= need
        self.allocs[seq_id] += need
        return True

    def free(self, seq_id: int) -> None:
        """Return every block owned by ``seq_id`` to the pool."""
        self.free_blocks += self.allocs.pop(seq_id, 0)

    @property
    def utilization(self) -> float:
        """Fraction of the pool currently allocated (0.0–1.0)."""
        return 1.0 - self.free_blocks / max(self.total_blocks, 1)


@dataclass
class SlotAllocator:
    """Fixed decode-slot bookkeeping: each active sequence owns one batch
    row of the compiled decode step; lowest free slot is handed out first
    so compiled shapes stay stable."""

    n_slots: int
    free: list = field(default_factory=list)
    owner: dict = field(default_factory=dict)     # slot -> seq_id

    def __post_init__(self):
        self.free = list(range(self.n_slots))

    def acquire(self, seq_id: int) -> Optional[int]:
        """Claim the lowest free slot for ``seq_id``; None when full."""
        if not self.free:
            return None
        slot = self.free.pop(0)
        self.owner[slot] = seq_id
        return slot

    def release(self, slot: int) -> None:
        """Return a slot to the free list (kept sorted for lowest-first)."""
        self.owner.pop(slot, None)
        self.free.append(slot)
        self.free.sort()

    def active_slots(self) -> list:
        """Sorted list of slots currently owned by a sequence."""
        return sorted(self.owner)
