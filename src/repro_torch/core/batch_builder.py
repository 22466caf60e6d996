"""Batch construction — Algorithm 1 lines 15–23 (GreedyFill + Backfill).

The engine exposes a *budget* per scheduling tick:

    max_requests   — engine batch-slot limit (vLLM's max_num_seqs)
    max_tokens     — prefill token budget per step (chunked-prefill style)
    kv_blocks_free — paged-KV admission guard: a request is only admitted if
                     its prompt fits in the free block pool (vLLM semantics)

TPU adaptation (DESIGN.md §3): prefill batches are *bucketed* — all requests
in one batch are padded to the bucket edge of the primary queue.  Because an
EWSJF queue is performance-homogeneous, padding waste inside a batch is
small; `BatchPlan.padded_tokens` records the padded footprint so benchmarks
can quantify the effect vs FCFS.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from .queues import QueueManager, SchedulerQueue
from .types import BatchPlan, Request


@dataclass
class BatchBudget:
    """Per-tick limits a batch must fit: requests, tokens and free KV blocks."""
    max_requests: int = 64
    max_tokens: int = 8192
    kv_blocks_free: Optional[int] = None   # None = unconstrained
    block_size: int = 16
    pad_mode: bool = True      # TPU bucket padding: backfill may not raise
                               # the batch's bucket edge (GPU mode: no cap)

    def blocks_needed(self, req: Request) -> int:
        """KV blocks the request must newly allocate: its full paged
        footprint minus any cached prefix blocks it can share (KV plane;
        equal to the full footprint when cached_len is 0)."""
        total = -(-int(req.prompt_len) // self.block_size)
        if req.cached_len > 0:
            total -= int(req.cached_len) // self.block_size
        return max(total, 1)


def _bucket_edge(tokens: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if tokens <= b:
            return b
    return buckets[-1]


DEFAULT_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


class BatchBuilder:
    """Greedy fill from the primary (argmax-score) queue, then backfill from
    adjacent queues while budget remains."""

    def __init__(self, budget: BatchBudget, buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 admit_fn: Optional[Callable[[Request], bool]] = None):
        self.budget = budget
        self.buckets = tuple(sorted(buckets))
        # Optional extra admission predicate from the engine (e.g. per-arch
        # context-length caps).
        self.admit_fn = admit_fn or (lambda r: True)

    def build(self, manager: QueueManager, primary: SchedulerQueue,
              now: float) -> BatchPlan:
        """Fill one batch from ``primary``, then backfill from adjacent queues
        under the budget."""
        plan = BatchPlan(requests=[], primary_queue=primary.queue_id)
        free_blocks = self.budget.kv_blocks_free
        self._fill_from(primary, plan, free_blocks)
        # Backfill must preserve batch homogeneity (the whole point of the
        # partitioning): it may not raise the primary batch's bucket edge.
        # Only meaningful under TPU bucket padding; GPU mode has no edge.
        edge = (_bucket_edge(max(int(r.effective_len)
                                 for r in plan.requests), self.buckets)
                if plan.requests and self.budget.pad_mode else None)
        if len(plan.requests) < self.budget.max_requests and \
                plan.total_tokens < self.budget.max_tokens:
            for q in manager.adjacent_of(primary.queue_id):
                if not len(q):
                    continue
                took = self._fill_from(q, plan, free_blocks, max_len=edge)
                if took:
                    plan.backfill_queues.append(q.queue_id)
                if (len(plan.requests) >= self.budget.max_requests
                        or plan.total_tokens >= self.budget.max_tokens):
                    break
        # Bucket-pad to the largest member's bucket edge (one compiled shape
        # per batch => pad every row to the same edge).
        if plan.requests:
            edge = _bucket_edge(max(int(r.effective_len)
                                    for r in plan.requests), self.buckets)
            plan.padded_tokens = edge * len(plan.requests)
        return plan

    def _fill_from(self, q: SchedulerQueue, plan: BatchPlan,
                   free_blocks: Optional[int],
                   max_len: Optional[int] = None) -> int:
        took = 0
        while len(q):
            head = q.peek()
            if max_len is not None and head.effective_len > max_len:
                break
            if len(plan.requests) >= self.budget.max_requests:
                break
            if plan.total_tokens + head.effective_len > self.budget.max_tokens \
                    and plan.requests:
                break
            if free_blocks is not None:
                need = self.budget.blocks_needed(head)
                used = sum(self.budget.blocks_needed(r) for r in plan.requests)
                if used + need > free_blocks:
                    break
            if not self.admit_fn(head):
                break
            req = q.pop()
            plan.requests.append(req)
            plan.total_tokens += int(req.effective_len)
            took += 1
        return took
