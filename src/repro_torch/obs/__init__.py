"""Observability pieces the serving engine reaches: labeled metrics and the
SLO views over them (copies of the JAX package's ``obs.metrics`` and
``obs.slo``).  Tracing and cost calibration are not ported yet; the engine
takes an untyped ``obs`` bundle, so any object with the same surface plugs
in."""

from .metrics import DEFAULT_SPEC, HistogramSpec, LogHistogram, MetricsRegistry
from .slo import (E2E_HIST, TBT_HIST, TTFT_HIST, burn_view, classify_request,
                  record_finish, slo_from_requests, slo_or_fallback,
                  slo_report, ttft_percentile)

__all__ = [
    "E2E_HIST", "TBT_HIST", "TTFT_HIST",
    "MetricsRegistry", "LogHistogram", "HistogramSpec", "DEFAULT_SPEC",
    "slo_report", "slo_from_requests", "slo_or_fallback", "record_finish",
    "burn_view", "classify_request", "ttft_percentile",
]
