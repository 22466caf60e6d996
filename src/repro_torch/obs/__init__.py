"""Observability plane of the port: tracing, labeled metrics, SLO views
and cost calibration (copies of the JAX package's ``obs``).

One :class:`Observability` handle threads through the stack
(``serving.ServingEngine`` and its admission controller).  It bundles an
optional :class:`~repro_torch.obs.trace.TraceRecorder` and an optional
:class:`~repro_torch.obs.metrics.MetricsRegistry` behind null-safe helpers so
instrumentation sites stay one line and the disabled path stays zero-cost:
every emission site in the hot loops is guarded by ``if obs is not None``,
and with ``obs=None`` scheduling decisions are bit-identical to the
uninstrumented code.

This package is a **leaf**: stdlib-only, no imports from
repro_torch.serving — the engine takes an untyped ``obs`` parameter
instead, so no import cycle can form.
"""

from __future__ import annotations

from typing import Callable, Optional

from .calibration import (ATTACH_COPY, DECODE_STEP, OP_CLASSES,
                          PREFILL_CHUNK, CostCalibrator, PredictorCalibration)
from .metrics import (DEFAULT_SPEC, HistogramSpec, LogHistogram,
                      MetricsRegistry)
from .slo import (E2E_HIST, TBT_HIST, TTFT_HIST, burn_view, classify_request,
                  record_finish, slo_from_requests, slo_or_fallback,
                  slo_report, ttft_percentile)
from .trace import FlightDump, TraceEvent, TraceRecorder

__all__ = [
    "Observability", "TraceRecorder", "TraceEvent", "FlightDump",
    "MetricsRegistry", "LogHistogram", "HistogramSpec", "DEFAULT_SPEC",
    "CostCalibrator", "PredictorCalibration", "OP_CLASSES",
    "PREFILL_CHUNK", "DECODE_STEP", "ATTACH_COPY",
    "slo_report", "slo_from_requests", "slo_or_fallback", "record_finish",
    "burn_view", "classify_request", "ttft_percentile",
]


class Observability:
    """Bundle of tracer + metrics handed to every instrumented component.

    Either half may be None (trace-only or metrics-only runs); the
    convenience methods no-op safely on the missing half.  ``classify``
    maps a Request to its SLO-class label — defaults to the length-based
    fallback; cluster wiring replaces it with the admission controller's
    classifier so labels agree with admission decisions.
    """

    __slots__ = ("trace", "metrics", "classify", "calib", "pred_calib",
                 "_finish_h")

    def __init__(self, trace: Optional[TraceRecorder] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 classify: Optional[Callable] = None,
                 calib: Optional[CostCalibrator] = None,
                 pred_calib: Optional[PredictorCalibration] = None):
        self.trace = trace
        self.metrics = metrics
        self.classify = classify or classify_request
        # Calibration plane (obs/calibration.py): cost-model residual fits
        # fed by the engine's step timings, and the predicted-vs-actual
        # length view fed from finished requests (see ``finish``).  Both
        # default off — pure-recording consumers pay nothing.
        self.calib = calib
        self.pred_calib = pred_calib
        # per-SLO-class pre-bound (ttft, e2e, tbt, terminal) handles for
        # the finish hot path (labels resolved once per class)
        self._finish_h: dict = {}

    @classmethod
    def enabled(cls, trace_capacity: int = 65536,
                classify: Optional[Callable] = None,
                calibration: bool = False) -> "Observability":
        """Everything on: tracer ring + metrics registry; pass
        ``calibration=True`` to also attach the cost/predictor
        calibrators (engine-backed runs)."""
        return cls(trace=TraceRecorder(capacity=trace_capacity),
                   metrics=MetricsRegistry(), classify=classify,
                   calib=CostCalibrator() if calibration else None,
                   pred_calib=(PredictorCalibration() if calibration
                               else None))

    def slo_class(self, req) -> str:
        """Classify ``req``, caching the label on the request itself
        (``Request.slo_class``) so arrival/dispatch/finish pay for one
        classification total.  Objects without the cache field (duck-typed
        engine requests) just classify every time."""
        try:
            cls = req.slo_class
        except AttributeError:
            return self.classify(req)
        if cls is None:
            cls = req.slo_class = self.classify(req)
        return cls

    # ---- null-safe one-liners for instrumentation sites ------------------

    def event(self, kind: str, t: float, request_id: int = -1,
              replica_id: int = -1, dur: float = 0.0,
              data: Optional[dict] = None) -> None:
        if self.trace is not None:
            self.trace.emit(kind, t, request_id=request_id,
                            replica_id=replica_id, dur=dur, data=data)

    def inc(self, name: str, labels: Optional[dict] = None,
            v: float = 1.0) -> None:
        if self.metrics is not None:
            self.metrics.inc(name, labels, v)

    def observe(self, name: str, value: float,
                labels: Optional[dict] = None) -> None:
        if self.metrics is not None:
            self.metrics.observe(name, value, labels)

    def gauge(self, name: str, labels: Optional[dict] = None,
              v: float = 0.0) -> None:
        if self.metrics is not None:
            self.metrics.set_gauge(name, labels, v)

    def timeline(self, name: str, t: float, v: float,
                 labels: Optional[dict] = None) -> None:
        if self.metrics is not None:
            self.metrics.record_timeline(name, t, v, labels)

    def calibrate(self, op_class: str, predicted: float,
                  measured: float) -> None:
        """Feed one (predicted, measured) seconds pair to the cost
        calibrator (no-op when no calibrator is attached)."""
        if self.calib is not None:
            self.calib.observe(op_class, predicted, measured)

    def finish(self, req, t: float, replica_id: int = -1) -> None:
        """Record a request finishing: trace instant, latency histograms,
        and the unified terminal-state counter.  Equivalent to
        :func:`~repro_torch.obs.slo.record_finish` + the terminal inc, through
        per-class pre-bound handles (this is the hottest metrics site)."""
        if self.trace is not None:
            self.trace.emit("finish", t, req.request_id, replica_id)
        if self.pred_calib is not None:
            self.pred_calib.observe(req)
        m = self.metrics
        if m is not None:
            cls = getattr(req, "slo_class", None)
            if cls is None:
                cls = self.slo_class(req)
            h = self._finish_h.get(cls)
            if h is None:
                labels = {"slo_class": cls}
                h = self._finish_h[cls] = (
                    m.hist(TTFT_HIST, labels), m.hist(E2E_HIST, labels),
                    m.hist(TBT_HIST, labels),
                    m.counter("requests_terminal_total",
                              {"state": "finished", "slo_class": cls}))
            ttft_h, e2e_h, tbt_h, term = h
            first, fin = req.first_token_time, req.finish_time
            if first is not None:
                ttft_h.observe(first - req.arrival_time)
            if fin is not None:
                e2e_h.observe(fin - req.arrival_time)
                if first is not None and req.generated > 1:
                    tbt_h.observe((fin - first) / (req.generated - 1))
            term.inc()

    def dump(self, reason: str, t: float) -> None:
        """Flight-recorder dump (failure / straggler onset)."""
        if self.trace is not None:
            self.trace.dump(reason, t)

    # ---- reading ---------------------------------------------------------

    def slo_report(self) -> dict:
        """Per-class latency percentiles (empty dict when metrics off)."""
        return slo_report(self.metrics) if self.metrics is not None else {}

    def snapshot(self) -> dict:
        """JSON-able snapshot: metrics + tracer telemetry."""
        out: dict = {}
        if self.metrics is not None:
            out["metrics"] = self.metrics.snapshot()
            out["slo"] = slo_report(self.metrics)
            out["burn"] = burn_view(self.metrics)
        if self.trace is not None:
            out["trace"] = self.trace.stats()
        if self.calib is not None:
            out["calibration"] = self.calib.snapshot()
        if self.pred_calib is not None:
            out["predictor_calibration"] = self.pred_calib.snapshot()
        return out
