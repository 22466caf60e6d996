"""Derived SLO views: per-class latency percentiles + burn timelines.

The paper's quality target is per-class latency *distributions* (PAPERS.md,
"Optimal Scheduling Algorithms for LLM Inference"), not means.  This module
turns the raw histograms the fleet records (``request_ttft_seconds``,
``request_tbt_seconds``, ``request_e2e_seconds``, labeled by ``slo_class``)
into the summary every bench reports: per-class p50/p95/p99 plus exact
means, and the autoscaler's burn-rate timelines.

Two entry points:

* :func:`slo_report` — read the views out of a live registry (the wired
  path: simulator/engine record at finish time).
* :func:`slo_from_requests` — build the same report from a bare list of
  finished :class:`~repro_torch.core.types.Request`\\ s (duck-typed), for benches
  whose result objects predate the observability plane.  Means are exact;
  percentiles carry the one-bucket histogram bound.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from .metrics import MetricsRegistry

# Canonical metric names for the request-latency histograms (one place, so
# recorders and readers cannot drift).
TTFT_HIST = "request_ttft_seconds"
TBT_HIST = "request_tbt_seconds"
E2E_HIST = "request_e2e_seconds"
BURN_TIMELINE = "autoscaler_burn"

# Length threshold for the fallback classifier; matches
# cluster.admission.classify_by_length's default so the obs plane and the
# admission plane agree when no explicit classifier is wired.
SHORT_THRESHOLD = 256


def classify_request(req, short_threshold: int = SHORT_THRESHOLD) -> str:
    """Fallback SLO classifier (duck-typed on ``prompt_len`` /
    ``priority_class``): interactive for short prompts, batch for
    explicitly deprioritized work, standard otherwise.  Cluster wiring
    overrides this with the admission controller's classifier."""
    if getattr(req, "priority_class", 0) < 0:
        return "batch"
    if getattr(req, "prompt_len", 0) <= short_threshold:
        return "interactive"
    return "standard"


def record_finish(metrics: MetricsRegistry, req, slo_class: str) -> None:
    """Record one finished request's TTFT / E2E / per-token TBT into the
    shared latency histograms.  TBT is (finish − first_token) divided by
    the number of inter-token gaps, i.e. the request-level mean time
    between tokens — defined only when ≥ 2 tokens were generated."""
    labels = {"slo_class": slo_class}
    if req.ttft is not None:
        metrics.observe(TTFT_HIST, req.ttft, labels)
    if req.e2e_latency is not None:
        metrics.observe(E2E_HIST, req.e2e_latency, labels)
    if (req.finish_time is not None and req.first_token_time is not None
            and req.generated > 1):
        tbt = (req.finish_time - req.first_token_time) / (req.generated - 1)
        metrics.observe(TBT_HIST, tbt, labels)


def slo_report(metrics: MetricsRegistry,
               pcts: Iterable[float] = (50, 95, 99)) -> dict:
    """Per-class latency summary from a registry's request histograms:

    ``{class: {ttft: {mean,n,p50,p95,p99}, tbt: {...}, e2e: {...}}}``

    plus an ``_all`` row that pools every class (histogram merge — the
    same associative fold a fleet aggregator would do across shards).
    """
    out: dict = {}
    for row, name in (("ttft", TTFT_HIST), ("tbt", TBT_HIST),
                      ("e2e", E2E_HIST)):
        pooled = None
        for key, h in metrics.histograms(name).items():
            cls = dict(key).get("slo_class", "_")
            out.setdefault(cls, {})[row] = h.summary(pcts)
            pooled = h.copy() if pooled is None else pooled.merge(h)
        if pooled is not None:
            out.setdefault("_all", {})[row] = pooled.summary(pcts)
    return out


def burn_view(metrics: MetricsRegistry) -> dict:
    """Burn-rate timelines keyed by rendered label string:
    ``{"role=prefill": [(t, burn), ...], ...}`` (empty when the autoscaler
    never ran)."""
    out = {}
    for key in list(metrics._timelines.get(BURN_TIMELINE, {})):
        label = ",".join(f"{a}={b}" for a, b in key) or "_"
        out[label] = metrics.timeline(BURN_TIMELINE, dict(key))
    return out


def slo_from_requests(requests: Iterable,
                      classify: Optional[Callable] = None,
                      pcts: Iterable[float] = (50, 95, 99)) -> dict:
    """Build the :func:`slo_report` view directly from finished requests.

    The bench-side bridge: every bench that predates the observability
    plane has a list of finished Request objects; this pushes them through
    a throwaway registry so all benches report percentiles from the same
    histogram code path (identical bucketing, identical bound).
    """
    classify = classify or classify_request
    reg = MetricsRegistry()
    for r in requests:
        record_finish(reg, r, classify(r))
    return slo_report(reg, pcts)


def slo_or_fallback(metrics: Optional[MetricsRegistry], finished: Iterable,
                    classify: Optional[Callable] = None,
                    pcts: Iterable[float] = (50, 95, 99)) -> dict:
    """One per-class-percentile code path for *both* backends: read the
    live registry when the run recorded one, otherwise rebuild the exact
    same report from the finished requests (:func:`slo_from_requests` —
    identical histograms, identical bounds).  ``ClusterSimResult`` (DES)
    and ``ServingEngine`` (real engine) both route through this, so bench
    tables never mix percentile implementations across backends."""
    if metrics is not None:
        return slo_report(metrics, pcts)
    return slo_from_requests(finished, classify, pcts)


def ttft_percentile(report: dict, cls: str, p: int = 95) -> Optional[float]:
    """Convenience: one TTFT percentile out of an :func:`slo_report` dict
    (None when the class has no finished requests)."""
    row = report.get(cls, {}).get("ttft")
    return row.get(f"p{p}") if row else None
