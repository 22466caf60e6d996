"""Queue manager: dynamic routing, on-demand bubble queues, pruning.

Implements the Dispatcher of the tactical loop (§3.2) and Algorithm 2
(On-Demand Bubble Queue Creation, §4.3 / App. D):

    1:  Q_i, Q_{i+1} ← FindAdjacentQueues(L, Q)
    3:  if L ≤ Q_i.max_len × 1.10:            assign to Q_i
    5:  elif L ≥ Q_{i+1}.min_len × 0.90:      assign to Q_{i+1}
    7:  else:  true gap — create a bubble queue centered on L, width
        min(default_bubble_width, available), clipped to neighbours.

Queues are kept in ascending order of their interval; indices are re-derived
after structural changes, so the scoring queue-factor q_i always reflects the
current ordering.  Empty-queue pruning (Alg. 1 lines 8–13) removes queues
whose empty-streak exceeds ``empty_threshold`` — but never *policy* queues
(those from the strategic partition), only bubbles, unless
``prune_policy_queues`` is set (the strategic loop owns policy structure).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from .scoring import QueueProfile, weights_for_queue
from .types import MetaParams, QueueBounds, Request


@dataclass
class SchedulerQueue:
    """A single FIFO prompt-length queue."""

    bounds: QueueBounds
    queue_id: int
    is_bubble: bool = False
    requests: deque = field(default_factory=deque)
    empty_cnt: int = 0
    routed_count: int = 0
    routed_len_sum: float = 0.0
    tok_sum: int = 0                  # waiting prompt tokens (incremental)
    obs_min: float = float("inf")     # observed data edges (Alg. 2's
    obs_max: float = float("-inf")    # Q_i.max_len / Q_{i+1}.min_len)

    def __len__(self) -> int:
        return len(self.requests)

    def peek(self) -> Optional[Request]:
        """Oldest request in the queue, or None when empty."""
        return self.requests[0] if self.requests else None

    def push(self, req: Request) -> None:
        # All queue statistics run on the *work* length (uncached suffix +
        # predicted decode work) — identical to prompt_len when cached_len
        # is 0 and no prediction is stamped.  Stamps are set at ingest and
        # never mutated while queued, so push/pop stay balanced.
        """Append a request and update the queue's length statistics."""
        L = req.work_len
        self.requests.append(req)
        self.routed_count += 1
        self.routed_len_sum += L
        self.tok_sum += int(L)
        self.obs_min = min(self.obs_min, L)
        self.obs_max = max(self.obs_max, L)
        self.empty_cnt = 0

    def pop(self) -> Request:
        """Remove and return the oldest request."""
        req = self.requests.popleft()
        self.tok_sum -= int(req.work_len)
        return req

    def clear_requests(self) -> list[Request]:
        """Remove every request and return them in queue order."""
        out = list(self.requests)
        self.requests.clear()
        self.tok_sum = 0
        return out

    @property
    def mean_len(self) -> float:
        """b̄_q — mean prompt length of everything ever routed here; falls
        back to the interval center for fresh queues."""
        if self.routed_count:
            return self.routed_len_sum / self.routed_count
        c = self.bounds.center
        return c if c != float("inf") else self.bounds.lo


@dataclass
class BubbleConfig:
    """Knobs of the empty-queue (bubble) handling between partitions."""
    default_bubble_width: float = 256.0
    lower_tolerance: float = 1.10      # Alg. 2 line 3
    upper_tolerance: float = 0.90      # Alg. 2 line 5


class QueueManager:
    """Owns the live queue set; applies policies from the strategic loop and
    routes requests on the tactical path."""

    def __init__(self, boundaries: list[QueueBounds], meta: MetaParams,
                 bubble: BubbleConfig | None = None,
                 empty_threshold: int = 50):
        self.bubble_cfg = bubble or BubbleConfig()
        self.empty_threshold = empty_threshold
        self.meta = meta
        self._next_id = 0
        self.queues: list[SchedulerQueue] = []
        self.bubbles_created = 0
        self.apply_policy(boundaries, meta)

    # ---- strategic-loop interface --------------------------------------

    def apply_policy(self, boundaries: list[QueueBounds], meta: MetaParams) -> None:
        """Install a new queue structure, re-routing any waiting requests.

        Called by the strategic loop (infrequent).  Waiting requests keep
        their arrival times, so no work is lost across policy swaps."""
        pending: list[Request] = []
        for q in self.queues:
            pending.extend(q.requests)
        self.meta = meta
        self.queues = []
        for b in sorted(boundaries, key=lambda x: x.lo):
            self.queues.append(SchedulerQueue(bounds=b, queue_id=self._alloc_id()))
        for r in sorted(pending, key=lambda r: r.arrival_time):
            self.route(r)

    def _alloc_id(self) -> int:
        self._next_id += 1
        return self._next_id - 1

    # ---- tactical-loop interface ---------------------------------------

    def route(self, req: Request, allow_bubble: bool = True) -> SchedulerQueue:
        """Dispatcher (Algorithm 2) against *observed* data edges:

        1. a queue whose observed range [obs_min, obs_max] (with the ±10%
           tolerance bands of lines 3/5) covers L takes the request;
        2. otherwise L sits in a true gap between the nearest observed data
           below and above → bubble queue (lines 8–14), carved out of the
           containing interval;
        3. with no observed data on one side (cold start / new extreme),
           fall back to interval routing — there is no meaningful gap yet.

        Routing runs on the request's *work* length: a long prompt with a
        hot cached prefix joins the queue of the short job it actually is
        (KV plane), and a short prompt predicted to decode long joins the
        queue of the long job it actually is (prediction plane); identical
        to prompt_len when neither plane has stamped the request.
        """
        L = req.work_len
        qi = self._find_interval(L)
        q = self.queues[qi]
        c = self.bubble_cfg

        def assign(target: SchedulerQueue) -> SchedulerQueue:
            target.push(req)
            req.queue_id = target.queue_id
            return target

        if not allow_bubble or q.routed_count == 0:
            return assign(q)
        # Line 3/5 tolerance test against the containing interval's own data
        # and its observed neighbours.
        below = max((x.obs_max for x in self.queues
                     if x.routed_count and x.obs_max <= L), default=None)
        above = min((x.obs_min for x in self.queues
                     if x.routed_count and x.obs_min >= L), default=None)
        if q.obs_min <= L <= q.obs_max:
            return assign(q)                      # inside observed mass
        if below is not None and L <= below * c.lower_tolerance:
            return assign(q if q.bounds.contains(below) else
                          self._queue_with_obs(below))
        if above is not None and L >= above * c.upper_tolerance:
            return assign(q if q.bounds.contains(above) else
                          self._queue_with_obs(above))
        if below is None or above is None:
            return assign(q)                      # one-sided: no gap defined
        # True gap: create a bubble queue (Alg. 2 lines 8–14).
        bubble = self._create_bubble(L, qi, below, above)
        return assign(bubble)

    def _queue_with_obs(self, value: float) -> SchedulerQueue:
        for x in self.queues:
            if x.routed_count and x.obs_min <= value <= x.obs_max:
                return x
        return self.queues[self._find_interval(value)]

    def _find_interval(self, L: float) -> int:
        for i, q in enumerate(self.queues):
            if q.bounds.lo <= L < q.bounds.hi or (
                    q.bounds.hi == float("inf") and L >= q.bounds.lo):
                return i
        return len(self.queues) - 1      # beyond range → last queue

    def _create_bubble(self, L: float, qi: int, below: float,
                       above: float) -> SchedulerQueue:
        """Algorithm 2 lines 8–14: split the containing interval around L,
        clipped to the observed neighbour edges (below, above)."""
        q = self.queues[qi]
        left_hi = max(below, q.bounds.lo)
        right_lo = min(above, q.bounds.hi)
        available = max(right_lo - left_hi, 1.0)
        rng = min(self.bubble_cfg.default_bubble_width, available)
        new_min = max(L - rng / 2.0, left_hi)
        new_max = min(L + rng / 2.0, right_lo)
        if new_max <= new_min:
            new_min, new_max = L - 0.5, L + 0.5
        # Carve the bubble interval out of the containing queue so the
        # partition stays contiguous and non-overlapping.
        bubble = SchedulerQueue(
            bounds=QueueBounds(new_min, new_max),
            queue_id=self._alloc_id(), is_bubble=True)
        old = q.bounds
        q.bounds = QueueBounds(old.lo, new_min)
        tail = SchedulerQueue(bounds=QueueBounds(new_max, old.hi),
                              queue_id=self._alloc_id(), is_bubble=q.is_bubble)
        # Move any waiting requests that now belong to the new intervals.
        stay, move_b, move_t = deque(), [], []
        for r in q.requests:
            if bubble.bounds.contains(r.work_len):
                move_b.append(r)
            elif tail.bounds.contains(r.work_len):
                move_t.append(r)
            else:
                stay.append(r)
        q.requests = stay
        # recompute q's observed edges (its requests may have moved)
        q.obs_min, q.obs_max = float("inf"), float("-inf")
        q.routed_count, q.routed_len_sum, q.tok_sum = 0, 0.0, 0
        for r in stay:
            L = r.work_len
            q.obs_min = min(q.obs_min, L)
            q.obs_max = max(q.obs_max, L)
            q.routed_count += 1
            q.routed_len_sum += L
            q.tok_sum += int(L)
        # re-label moved requests: queue_id drives delta publication
        # (scheduler._snapshot_delta) and must name the queue that now
        # actually holds the request
        for r in move_b:
            bubble.push(r)
            r.queue_id = bubble.queue_id
        for r in move_t:
            tail.push(r)
            r.queue_id = tail.queue_id
        self.queues[qi + 1: qi + 1] = [bubble, tail]
        self.bubbles_created += 1
        return bubble

    def prune_empty(self) -> list[int]:
        """Alg. 1 lines 8–13: advance empty counters, drop expired bubbles.
        Returns removed queue ids."""
        removed = []
        keep = []
        for q in self.queues:
            if len(q) == 0:
                q.empty_cnt += 1
                if q.is_bubble and q.empty_cnt > self.empty_threshold:
                    removed.append(q.queue_id)
                    continue
            keep.append(q)
        if removed:
            # Re-absorb the removed bubbles' intervals into left neighbours.
            self.queues = keep
            self._heal_intervals()
        return removed

    def _heal_intervals(self) -> None:
        for a, b in zip(self.queues[:-1], self.queues[1:]):
            if a.bounds.hi != b.bounds.lo:
                a.bounds = QueueBounds(a.bounds.lo, b.bounds.lo)
        if self.queues:
            first = self.queues[0]
            if first.bounds.lo != 0.0:
                first.bounds = QueueBounds(0.0, first.bounds.hi)
            last = self.queues[-1]
            if last.bounds.hi != float("inf"):
                last.bounds = QueueBounds(last.bounds.lo, float("inf"))

    # ---- scoring support -------------------------------------------------

    def profiles(self) -> dict[int, QueueProfile]:
        """Per-queue profiles with context-aware weights (index = ascending
        position, so qf follows the paper's queue-index convention)."""
        out = {}
        for i, q in enumerate(self.queues):
            out[q.queue_id] = QueueProfile(
                index=i, mean_len=q.mean_len,
                weights=weights_for_queue(self.meta, q.mean_len))
        return out

    def non_empty(self) -> list[SchedulerQueue]:
        """Queues that hold at least one request."""
        return [q for q in self.queues if len(q)]

    def waiting_count(self) -> int:
        """Requests waiting across all queues."""
        return sum(len(q) for q in self.queues)

    def adjacent_of(self, queue_id: int) -> list[SchedulerQueue]:
        """GetAdjacent(q) for backfill — nearest neighbours first."""
        idx = next((i for i, q in enumerate(self.queues)
                    if q.queue_id == queue_id), None)
        if idx is None:
            return []
        order: list[SchedulerQueue] = []
        lo, hi = idx - 1, idx + 1
        while lo >= 0 or hi < len(self.queues):
            if lo >= 0:
                order.append(self.queues[lo]); lo -= 1
            if hi < len(self.queues):
                order.append(self.queues[hi]); hi += 1
        return order
