"""Refine-and-Prune — the strategic partitioning core of EWSJF (§4.2).

Given the sorted prompt lengths observed in the strategic window, produce a
set of contiguous, non-overlapping prompt-length intervals ("queues") that
are (i) performance-homogeneous, (ii) contiguous, (iii) bounded in number.

Three stages, exactly as in the paper:

  Stage 1  Coarse partitioning      — 1-D k-means, k=3 (short/medium/long).
  Stage 2  Recursive refinement     — split a cluster at gap j whenever
                                      Gap_j > α · mean(G)            (Eq. 2)
                                      until no significant gap remains or the
                                      cluster is below the min-width floor.
  Stage 3  Intelligent pruning      — merge the adjacent pair with the lowest
                                      Scheduling Utility
                                      U = (ρ_i + ρ_{i+1}) / (|b̄_{i+1}−b̄_i|+ε)
                                      (Eq. 3) until ≤ max_queues remain.

The output intervals tile the *full* observed range with no holes: each
cluster's interval is extended to the midpoint of the inter-cluster gap so
that routing (core/queues.py) is a total function.  Requests beyond the
observed range route to the first/last queue; genuinely new in-gap regimes
are handled by bubble queues at dispatch time (§4.3).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .types import QueueBounds


@dataclass(frozen=True)
class PartitionConfig:
    """Knobs of the refine-and-prune queue partitioning."""
    alpha_split: float = 3.0        # Eq. 2 significance ratio (meta-tuned)
    max_queues: int = 32
    min_width: int = 8              # min interval width for further splitting
    min_cluster_size: int = 4       # don't split clusters smaller than this
    coarse_k: int = 3               # Stage-1 anchors (short/medium/long)
    eps: float = 1e-6               # Eq. 3 numerical-stability constant
    kmeans_iters: int = 32


# --------------------------------------------------------------------------
# Stage 1: coarse 1-D k-means
# --------------------------------------------------------------------------

def kmeans_1d(values: np.ndarray, k: int, iters: int = 32,
              seed: int = 0) -> list[np.ndarray]:
    """Plain 1-D k-means on sorted values; returns list of contiguous
    clusters (sorted by center).  Deterministic: quantile init."""
    values = np.sort(np.asarray(values, dtype=np.float64))
    n = len(values)
    if n == 0:
        return []
    k = min(k, len(np.unique(values)))
    if k <= 1:
        return [values]
    # Quantile initialization keeps centers ordered and deterministic.
    centers = np.quantile(values, (np.arange(k) + 0.5) / k)
    for _ in range(iters):
        # 1-D assignment = nearest center; with sorted centers this is a
        # thresholding at midpoints, keeping clusters contiguous.
        mids = (centers[:-1] + centers[1:]) / 2.0
        idx = np.searchsorted(mids, values, side="right")
        new_centers = centers.copy()
        for j in range(k):
            sel = values[idx == j]
            if len(sel):
                new_centers[j] = sel.mean()
        if np.allclose(new_centers, centers):
            break
        centers = np.sort(new_centers)
    mids = (centers[:-1] + centers[1:]) / 2.0
    idx = np.searchsorted(mids, values, side="right")
    return [values[idx == j] for j in range(k) if np.any(idx == j)]


# --------------------------------------------------------------------------
# Stage 2: recursive gap refinement
# --------------------------------------------------------------------------

def refine_cluster(cluster: np.ndarray, cfg: PartitionConfig) -> list[np.ndarray]:
    """Split ``cluster`` (sorted 1-D array) at significant gaps (Eq. 2),
    recursing on both halves.  Iterative worklist form — the recursive
    formulation overflows Python's stack at N=100k histories."""
    out: list[np.ndarray] = []
    work = [cluster]
    while work:
        c = work.pop()
        if (len(c) < cfg.min_cluster_size
                or c[-1] - c[0] < cfg.min_width):
            out.append(c)
            continue
        gaps = np.diff(c)
        mean_gap = gaps.mean() if len(gaps) else 0.0
        if mean_gap <= 0:
            out.append(c)
            continue
        j = int(np.argmax(gaps))
        if gaps[j] > cfg.alpha_split * mean_gap:      # Eq. 2
            work.append(c[: j + 1])
            work.append(c[j + 1:])
        else:
            out.append(c)
    out.sort(key=lambda c: float(c[0]))
    return out


# --------------------------------------------------------------------------
# Stage 3: utility-based pruning (merging)
# --------------------------------------------------------------------------

def scheduling_utility(c1: np.ndarray, c2: np.ndarray, eps: float) -> float:
    """Eq. 3: U(q_i, q_{i+1}) = (ρ_i + ρ_{i+1}) / (|b̄_{i+1} − b̄_i| + ε).

    ρ(q) — request density — requests per unit of interval width."""
    def density(c: np.ndarray) -> float:
        width = max(float(c[-1] - c[0]), 1.0)
        return len(c) / width
    return (density(c1) + density(c2)) / (abs(float(c2.mean() - c1.mean())) + eps)


def prune_clusters(clusters: list[np.ndarray], cfg: PartitionConfig) -> list[np.ndarray]:
    """Merge adjacent pairs by Scheduling Utility until ≤ max_queues remain.

    INTERPRETATION NOTE (DESIGN.md §8): Eq. 3's U = (ρ_i+ρ_j)/(Δb̄+ε) is a
    merge *affinity* — highest for dense, nearby pairs, i.e. pairs whose
    separation buys the least scheduling value.  The paper's prose says
    "queues with the lowest utility are merged", but merging the lowest-U
    (sparse, far-apart) pairs empirically reproduces exactly the
    mega-queue + micro-queue pathology Table 2 says EWSJF avoids (on dense
    integer length data every unit gap survives as its own queue).  We
    therefore merge the *highest-affinity* pair first, which yields the
    intended behaviour: micro-queues collapse, distinct regimes survive."""
    clusters = [c for c in clusters if len(c)]
    if len(clusters) <= cfg.max_queues:
        return clusters
    # Incremental merge: recompute only the utilities adjacent to each
    # merge (the naive re-scan is O(m^2) and dominates at 100k histories).
    utils = [scheduling_utility(clusters[i], clusters[i + 1], cfg.eps)
             for i in range(len(clusters) - 1)]
    while len(clusters) > cfg.max_queues:
        i = int(np.argmax(utils))
        merged = np.concatenate([clusters[i], clusters[i + 1]])
        clusters[i: i + 2] = [merged]
        del utils[i]
        if i > 0:
            utils[i - 1] = scheduling_utility(clusters[i - 1], clusters[i],
                                              cfg.eps)
        if i < len(clusters) - 1:
            utils[i] = scheduling_utility(clusters[i], clusters[i + 1],
                                          cfg.eps)
    return clusters


# --------------------------------------------------------------------------
# Full pipeline
# --------------------------------------------------------------------------

def refine_and_prune(prompt_lengths, cfg: PartitionConfig | None = None
                     ) -> list[QueueBounds]:
    """Run the full Refine-and-Prune pipeline; returns interval bounds that
    tile [min(D), max(D)] contiguously (gap midpoints assigned to the nearer
    side implicitly by splitting at the midpoint)."""
    cfg = cfg or PartitionConfig()
    values = np.sort(np.asarray(list(prompt_lengths), dtype=np.float64))
    if len(values) == 0:
        return [QueueBounds(0.0, float("inf"))]

    # Stage 1 — coarse anchors.
    clusters = kmeans_1d(values, cfg.coarse_k, cfg.kmeans_iters)
    # Stage 2 — recursive refinement inside each anchor.
    refined: list[np.ndarray] = []
    for c in clusters:
        refined.extend(refine_cluster(np.sort(c), cfg))
    refined = [c for c in refined if len(c)]
    refined.sort(key=lambda c: float(c[0]))
    # Stage 3 — utility pruning to the queue budget.
    pruned = prune_clusters(refined, cfg)
    # Stage 3b — budget fill: gap-splitting finds no structure inside smooth
    # regimes, but queue granularity is itself scheduling value (the paper's
    # Table 3: throughput rises to the 32-queue budget; Refine-and-Prune
    # "identifies 32 queues as optimal").  Subdivide the most populous
    # clusters at their median until the budget is met (DESIGN.md §8).
    pruned = fill_budget(pruned, cfg)

    return clusters_to_bounds(pruned)


def fill_budget(clusters: list[np.ndarray], cfg: PartitionConfig
                ) -> list[np.ndarray]:
    """Split the largest cluster at its median until there are
    ``max_queues`` clusters or none can be split further."""
    clusters = list(clusters)
    while len(clusters) < cfg.max_queues:
        idx = max(range(len(clusters)), key=lambda i: len(clusters[i]))
        c = clusters[idx]
        if (len(c) < 2 * cfg.min_cluster_size
                or c[-1] - c[0] < 2 * cfg.min_width):
            break
        mid = len(c) // 2
        # split at the median *value* boundary (keep equal values together)
        v = c[mid]
        left = c[c < v]
        right = c[c >= v]
        if len(left) == 0 or len(right) == 0:
            break
        clusters[idx: idx + 1] = [left, right]
    return clusters


def clusters_to_bounds(clusters: list[np.ndarray]) -> list[QueueBounds]:
    """Convert contiguous clusters to hole-free interval bounds by splitting
    each inter-cluster gap at its midpoint."""
    if not clusters:
        return [QueueBounds(0.0, float("inf"))]
    edges = [0.0]
    for c1, c2 in zip(clusters[:-1], clusters[1:]):
        edges.append(0.5 * (float(c1[-1]) + float(c2[0])))
    edges.append(float("inf"))
    return [QueueBounds(edges[i], edges[i + 1]) for i in range(len(clusters))]


def pooled_lengths(pools, weights=None, cap: int = 50_000,
                   seed: int = 0) -> np.ndarray:
    """Weighted pooling of per-replica length samples (fleet-level strategic
    plane).  Each pool is resampled to a share of ``cap`` proportional to its
    weight (its replica's true arrival count, not the capped sample size), so
    high-traffic replicas dominate the merged distribution while the merge
    cost stays bounded regardless of fleet size.  Deterministic given
    ``seed``."""
    pools = [np.asarray(p, dtype=np.float64) for p in pools]
    if weights is None:
        w = np.asarray([len(p) for p in pools], dtype=np.float64)
    else:
        w = np.asarray(list(weights), dtype=np.float64)
        if len(w) != len(pools):
            raise ValueError(f"{len(weights)} weights for {len(pools)} pools")
    # drop empty pools *and their weights together* so an explicit weight
    # list stays aligned with the pools it describes
    keep = [i for i, p in enumerate(pools) if len(p)]
    pools = [pools[i] for i in keep]
    if not pools:
        return np.empty(0, dtype=np.float64)
    w = np.where(w[keep] > 0, w[keep], 0.0)
    if w.sum() <= 0:
        w = np.asarray([len(p) for p in pools], dtype=np.float64)
    total = int(min(cap, sum(len(p) for p in pools)))
    shares = np.maximum(1, np.round(total * w / w.sum()).astype(int))
    rng = np.random.default_rng(seed)
    parts = []
    for p, n in zip(pools, shares):
        if len(p) <= n:
            parts.append(p)                    # keep everything we have
        else:
            parts.append(rng.choice(p, size=n, replace=False))
    return np.sort(np.concatenate(parts))


def weighted_refine_and_prune(pools, weights=None,
                              cfg: PartitionConfig | None = None,
                              cap: int = 50_000, seed: int = 0
                              ) -> list[QueueBounds]:
    """Fleet-level Refine-and-Prune: merge per-replica length distributions
    (weighted by each replica's arrival volume) and partition the pooled
    distribution.  This is the global half of the shared policy store — a
    single queue structure every replica can adopt."""
    return refine_and_prune(pooled_lengths(pools, weights, cap=cap,
                                           seed=seed), cfg)


def edge_divergence(local_edges, global_edges) -> float | None:
    """Mean relative distance from each local interior edge to its nearest
    global one — the one divergence definition shared by the policy store
    (operator signal), the EWSJF router (alignment penalty), and the
    policy-store benchmark.  Infinite edges are ignored; returns None when
    either side has no finite interior edges (no structure to compare)."""
    g = np.asarray([e for e in global_edges if e != float("inf")],
                   dtype=np.float64)
    loc = [e for e in local_edges if e != float("inf")]
    if not len(g) or not loc:
        return None
    return float(np.mean([np.min(np.abs(g - e)) / max(e, 1.0)
                          for e in loc]))


def kmeans_partition(prompt_lengths, k: int) -> list[QueueBounds]:
    """Baseline partitioner: plain k-means with fixed k (paper Table 3's
    'EWSJF (K-Means)' rows)."""
    values = np.sort(np.asarray(list(prompt_lengths), dtype=np.float64))
    if len(values) == 0:
        return [QueueBounds(0.0, float("inf"))]
    clusters = kmeans_1d(values, k)
    return clusters_to_bounds(clusters)


def static_partition(lo: float, hi: float, k: int) -> list[QueueBounds]:
    """Baseline: fixed uniform-width buckets (the 'STATIC' row in Table 2)."""
    edges = np.linspace(lo, hi, k + 1)
    bounds = [QueueBounds(float(edges[i]), float(edges[i + 1]))
              for i in range(k)]
    return ([QueueBounds(0.0, bounds[0].hi)] + bounds[1:-1]
            + [QueueBounds(bounds[-1].lo, float("inf"))]) if k >= 2 else \
        [QueueBounds(0.0, float("inf"))]


def validate_partition(bounds: list[QueueBounds]) -> None:
    """Invariants (tested by hypothesis): contiguous, non-overlapping,
    monotonically ordered, covering [0, inf)."""
    assert bounds, "empty partition"
    assert bounds[0].lo == 0.0
    assert bounds[-1].hi == float("inf")
    for a, b in zip(bounds[:-1], bounds[1:]):
        assert a.hi == b.lo, f"hole or overlap between {a} and {b}"
        assert a.lo < a.hi
