"""Continuous calibration layer: cost-model residual fits + predictor
calibration views.

The DES's roofline :class:`~repro_torch.core.cost_model.CostModel` and the
prediction plane's length estimates are only as good as their agreement
with what the real engine measurably does.  This module turns the obs
plane's raw observations into *calibration signal*:

* :class:`CostCalibrator` — pairs measured engine step wall times against
  the roofline prediction for the same op, **per op class** (canonical
  classes: ``prefill_chunk``, ``decode_step``, ``attach_copy``), and
  maintains a streaming affine fit ``measured ≈ scale · predicted +
  offset`` per class plus a raw measured/predicted ratio histogram and a
  recent-window drift detector.  :meth:`CostCalibrator.correction`
  exports the fitted per-class ``{scale, offset}`` map that
  ``core.cost_model.CalibratedCostModel`` consumes — the loop that makes
  *absolute* DES latencies (not just orderings) transfer to silicon.

* :class:`PredictorCalibration` — the predicted-vs-actual output-length
  view fed from finished requests (``Observability.finish``): a binned
  calibration curve (mean predicted vs mean actual per predicted-length
  bin), over-prediction coverage ``P(actual ≤ predicted)``, signed bias
  ``E[log(predicted/actual)]`` globally and per session/prompt-bucket
  key, and a relative expected-calibration-error (:meth:`ece`) summary —
  the quality telemetry the learned-ranking scheduling literature makes
  the predictor's value hinge on.

Like the rest of ``repro_torch.obs`` this module is a stdlib-only **leaf**: it
never imports ``repro_torch.core``; predictions arrive as plain floats and the
fitted correction leaves as a plain dict.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Callable, Optional

from .metrics import HistogramSpec, LogHistogram

# Canonical op classes the engine instruments.  The calibrator accepts any
# string, but these three are what the engine emits and the report tables
# expect (docs/ENGINE.md, "Telemetry & calibration").
PREFILL_CHUNK = "prefill_chunk"
DECODE_STEP = "decode_step"
ATTACH_COPY = "attach_copy"
OP_CLASSES = (PREFILL_CHUNK, DECODE_STEP, ATTACH_COPY)

# Residual-ratio histograms need fine buckets around 1.0, not the default
# factor-2 latency layout: 0.05 · 1.1^i spans ~[0.05, 100) at ~10% error.
RESIDUAL_SPEC = HistogramSpec(lo=0.05, growth=1.1, n_buckets=80)


class _StreamingFit:
    """Streaming least-squares affine fit ``y ≈ scale · x + offset``.

    Keeps the five running sums OLS needs; degenerate inputs (fewer than
    two samples, or zero variance in x) fall back to the ratio-of-means
    scale with zero offset, and a non-positive fitted scale falls back the
    same way so a correction can never flip the sign of a cost."""

    __slots__ = ("n", "sx", "sy", "sxx", "sxy")

    def __init__(self):
        self.n = 0
        self.sx = self.sy = self.sxx = self.sxy = 0.0

    def add(self, x: float, y: float) -> None:
        self.n += 1
        self.sx += x
        self.sy += y
        self.sxx += x * x
        self.sxy += x * y

    def fit(self) -> tuple[float, float]:
        """(scale, offset); identity when empty."""
        if self.n == 0:
            return 1.0, 0.0
        ratio = self.sy / self.sx if self.sx > 0 else 1.0
        if self.n < 2:
            return ratio, 0.0
        var = self.n * self.sxx - self.sx * self.sx
        if var <= 1e-24:
            return ratio, 0.0
        scale = (self.n * self.sxy - self.sx * self.sy) / var
        if scale <= 0.0:
            return ratio, 0.0
        offset = (self.sy - scale * self.sx) / self.n
        return scale, offset


class CostCalibrator:
    """Online per-op-class calibration of a roofline cost model.

    Feed ``observe(op_class, predicted, measured)`` pairs (both in
    seconds); read back:

    * :meth:`correction` — fitted ``{op: {scale, offset, n}}`` map for
      ``CalibratedCostModel``;
    * :meth:`residuals` — post-fit residual-ratio quantiles
      (``measured / (scale·predicted + offset)``) over the bounded recent
      window, the bench's ``residual_ratio`` claim;
    * :meth:`drift` — recent-window scale vs all-time scale per class;
      ``drifting`` flips when they diverge beyond ``drift_threshold``
      (the engine changed regimes faster than the global fit tracks);
    * :meth:`report` / :meth:`snapshot` — the JSON payload
      ``tools/calib_report.py`` and ``BENCH_calib.json`` render.
    """

    def __init__(self, window: int = 512, drift_window: int = 64,
                 drift_threshold: float = 0.3, min_samples: int = 8,
                 spec: HistogramSpec = RESIDUAL_SPEC):
        self.window = int(window)
        self.drift_window = int(drift_window)
        self.drift_threshold = float(drift_threshold)
        self.min_samples = int(min_samples)
        self._spec = spec
        self._fits: dict[str, _StreamingFit] = {}
        self._recent: dict[str, deque] = {}       # (predicted, measured)
        self._raw_ratio: dict[str, LogHistogram] = {}
        self.dropped = 0                          # non-positive inputs

    # ---- recording -------------------------------------------------------

    def observe(self, op_class: str, predicted: float,
                measured: float) -> None:
        """Record one (predicted, measured) seconds pair for an op class.
        Non-positive values carry no calibration information (cleared
        timers, compile-poisoned samples the caller chose to zero) and are
        dropped, counted in ``dropped``."""
        if predicted <= 0.0 or measured <= 0.0:
            self.dropped += 1
            return
        fit = self._fits.get(op_class)
        if fit is None:
            fit = self._fits[op_class] = _StreamingFit()
            self._recent[op_class] = deque(maxlen=self.window)
            self._raw_ratio[op_class] = LogHistogram(self._spec)
        fit.add(predicted, measured)
        self._recent[op_class].append((predicted, measured))
        self._raw_ratio[op_class].observe(measured / predicted)

    def samples(self, op_class: str) -> int:
        """Total pairs ever recorded for one class."""
        fit = self._fits.get(op_class)
        return fit.n if fit is not None else 0

    # ---- fitted correction ----------------------------------------------

    def correction(self) -> dict:
        """Fitted per-class affine correction:
        ``{op: {"scale": s, "offset": o, "n": count}}`` — the payload
        ``core.cost_model.CalibratedCostModel`` consumes.  Classes below
        ``min_samples`` are excluded (an under-observed fit is worse than
        the uncorrected roofline)."""
        out: dict = {}
        for op, fit in self._fits.items():
            if fit.n < self.min_samples:
                continue
            scale, offset = fit.fit()
            out[op] = {"scale": scale, "offset": offset, "n": fit.n}
        return out

    def residuals(self, op_class: str) -> dict:
        """Post-fit residual-ratio stats over the recent window:
        ``measured / (scale·predicted + offset)`` p50/p90/mean.  A healthy
        fit sits near 1.0; the bench gates p50 ∈ [0.8, 1.25]."""
        fit = self._fits.get(op_class)
        recent = self._recent.get(op_class)
        if fit is None or not recent:
            return {"n": 0}
        scale, offset = fit.fit()
        ratios = sorted(
            y / max(scale * x + offset, 1e-12) for x, y in recent)
        n = len(ratios)
        return {
            "n": n,
            "p50": ratios[n // 2],
            "p90": ratios[min(int(math.ceil(0.9 * n)) - 1, n - 1)],
            "mean": sum(ratios) / n,
        }

    def drift(self, op_class: str) -> dict:
        """Recent-window fit vs all-time fit for one class.  The drift
        ratio is recent_scale / global_scale; ``drifting`` is set when it
        leaves ``[1/(1+thr), 1+thr]`` with enough recent evidence —
        meaning the engine's cost regime moved and the global fit is
        stale (recalibrate, or suspect interference)."""
        fit = self._fits.get(op_class)
        recent = self._recent.get(op_class)
        if fit is None or recent is None:
            return {"n": 0, "drifting": False}
        g_scale, _ = fit.fit()
        tail = list(recent)[-self.drift_window:]
        rfit = _StreamingFit()
        for x, y in tail:
            rfit.add(x, y)
        r_scale, _ = rfit.fit()
        ratio = r_scale / max(g_scale, 1e-12)
        thr = 1.0 + self.drift_threshold
        drifting = (len(tail) >= max(self.min_samples, 2)
                    and fit.n >= 2 * len(tail)
                    and not (1.0 / thr <= ratio <= thr))
        return {"n": len(tail), "recent_scale": r_scale,
                "global_scale": g_scale, "drift_ratio": ratio,
                "drifting": drifting}

    def worst_drift(self, k: int = 3) -> list[tuple[str, float]]:
        """Op classes ranked by |log drift_ratio| descending (worst first)."""
        rows = []
        for op in self._fits:
            d = self.drift(op)
            if d.get("n", 0) > 0 and d.get("drift_ratio", 0) > 0:
                rows.append((op, abs(math.log(d["drift_ratio"]))))
        rows.sort(key=lambda r: r[1], reverse=True)
        return rows[:k]

    # ---- exposition ------------------------------------------------------

    def report(self) -> dict:
        """Per-class calibration view: raw-ratio histogram summary, fitted
        scale/offset, post-fit residual quantiles, drift state."""
        out: dict = {}
        for op, fit in sorted(self._fits.items()):
            scale, offset = fit.fit()
            out[op] = {
                "n": fit.n,
                "scale": scale,
                "offset": offset,
                "raw_ratio": self._raw_ratio[op].summary((50, 90)),
                "residual": self.residuals(op),
                "drift": self.drift(op),
            }
        return out

    def snapshot(self) -> dict:
        """JSON-able payload (``BENCH_calib.json`` / ``calib_report``)."""
        return {"classes": self.report(),
                "correction": self.correction(),
                "dropped": self.dropped,
                "window": self.window}


def _default_key(req) -> str:
    """Default calibration bucket key: the session when the request has
    one (the empirical predictor's strongest conditioning key), else the
    prompt-length power-of-two bucket — mirrors the prediction plane's own
    posterior keying."""
    sid = getattr(req, "session_id", None)
    if sid is not None:
        return f"session={sid}"
    plen = max(int(getattr(req, "prompt_len", 0)), 1)
    return f"plen_pow2={1 << (plen - 1).bit_length()}"


class _KeyStats:
    __slots__ = ("n", "sum_log_ratio", "sum_pred", "sum_actual", "covered")

    def __init__(self):
        self.n = 0
        self.sum_log_ratio = 0.0
        self.sum_pred = 0.0
        self.sum_actual = 0.0
        self.covered = 0


class PredictorCalibration:
    """Predicted-vs-actual output-length calibration from finished requests.

    ``observe(req)`` reads the prediction plane's ``predicted_output``
    stamp and the true generated count; requests without a stamp count as
    abstentions (the predictor's escape hatch, tracked but never scored).
    Derived views:

    * :meth:`curve` — calibration curve over geometric predicted-length
      bins: ``{lo, hi, n, mean_predicted, mean_actual}`` per bin;
    * :meth:`ece` — relative expected calibration error:
      ``Σ_b (n_b/N) · |mean_pred_b − mean_actual_b| / mean_actual_b``
      (0 = perfectly calibrated in every bin; ~1 = off by ~2x);
    * :meth:`coverage` — ``P(actual ≤ predicted)`` (over-prediction
      coverage: the fraction of requests whose KV/budget reservation the
      prediction would have covered);
    * :meth:`bias` / :meth:`worst_keys` — signed ``E[log(pred/actual)]``
      globally and per session/prompt-bucket key, worst offenders first.
    """

    def __init__(self, key_fn: Optional[Callable] = None,
                 max_keys: int = 512, min_key_n: int = 4):
        self.key_fn = key_fn or _default_key
        self.max_keys = int(max_keys)
        self.min_key_n = int(min_key_n)
        # Geometric bins over predicted length: [2^i, 2^(i+1)).
        self._bins: dict[int, _KeyStats] = {}
        self._keys: dict[str, _KeyStats] = {}
        self._global = _KeyStats()
        self.observed = 0
        self.abstained = 0

    def observe(self, req) -> None:
        """Fold one finished request into the calibration state."""
        pred = getattr(req, "predicted_output", None)
        actual = float(getattr(req, "generated", 0) or 0)
        if pred is None:
            self.abstained += 1
            return
        if pred <= 0.0 or actual <= 0.0:
            return
        self.observed += 1
        covered = 1 if actual <= pred else 0
        log_ratio = math.log(pred / actual)
        b = self._bins.setdefault(max(int(pred), 1).bit_length() - 1,
                                  _KeyStats())
        for st in (b, self._global):
            st.n += 1
            st.sum_log_ratio += log_ratio
            st.sum_pred += pred
            st.sum_actual += actual
            st.covered += covered
        key = self.key_fn(req)
        ks = self._keys.get(key)
        if ks is None:
            if len(self._keys) >= self.max_keys:
                return                      # bounded: overflow keys pool
            ks = self._keys[key] = _KeyStats()
        ks.n += 1
        ks.sum_log_ratio += log_ratio
        ks.sum_pred += pred
        ks.sum_actual += actual
        ks.covered += covered

    # ---- derived views ---------------------------------------------------

    def curve(self) -> list[dict]:
        """Calibration curve: one row per populated predicted-length bin."""
        rows = []
        for i in sorted(self._bins):
            st = self._bins[i]
            rows.append({"lo": float(1 << i), "hi": float(1 << (i + 1)),
                         "n": st.n,
                         "mean_predicted": st.sum_pred / st.n,
                         "mean_actual": st.sum_actual / st.n})
        return rows

    def ece(self) -> float:
        """Relative expected calibration error over the curve bins."""
        if self.observed == 0:
            return 0.0
        total = 0.0
        for st in self._bins.values():
            mp = st.sum_pred / st.n
            ma = st.sum_actual / st.n
            total += (st.n / self.observed) * abs(mp - ma) / max(ma, 1e-9)
        return total

    def coverage(self) -> float:
        """P(actual ≤ predicted) over observed requests (0.0 when none)."""
        return (self._global.covered / self.observed
                if self.observed else 0.0)

    def bias(self) -> float:
        """Global signed bias E[log(predicted/actual)] (0 = unbiased)."""
        return (self._global.sum_log_ratio / self.observed
                if self.observed else 0.0)

    def key_bias(self, key: str) -> Optional[float]:
        """Signed bias for one bucket key (None when unseen)."""
        st = self._keys.get(key)
        return st.sum_log_ratio / st.n if st is not None and st.n else None

    def worst_keys(self, k: int = 5) -> list[dict]:
        """Keys ranked by |signed bias| descending, with evidence counts
        (keys below ``min_key_n`` observations are not ranked)."""
        rows = []
        for key, st in self._keys.items():
            if st.n < self.min_key_n:
                continue
            rows.append({"key": key, "n": st.n,
                         "bias": st.sum_log_ratio / st.n,
                         "coverage": st.covered / st.n})
        rows.sort(key=lambda r: abs(r["bias"]), reverse=True)
        return rows[:k]

    def snapshot(self) -> dict:
        """JSON-able payload (``BENCH_calib.json`` / ``calib_report``)."""
        return {"observed": self.observed,
                "abstained": self.abstained,
                "ece": self.ece(),
                "coverage": self.coverage(),
                "bias": self.bias(),
                "curve": self.curve(),
                "worst_keys": self.worst_keys(),
                "keys_tracked": len(self._keys)}
