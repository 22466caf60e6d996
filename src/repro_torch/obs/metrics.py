"""Labeled metrics registry: counters, gauges, log-bucketed histograms.

One shared instrumentation surface for every plane (scheduler queues, KV
plane, policy store, autoscaler, admission): components record against a
:class:`MetricsRegistry` through ``inc`` / ``set_gauge`` / ``observe``,
keyed by metric name plus a small label set (SLO class, role, replica,
link — tenant-ready: labels are open-ended).  The registry is deliberately
stdlib-only and allocation-light — recording one observation is a dict
lookup plus a bisect — because the overhead contract of the observability
plane is "≤ 10% on the quick cluster bench with everything enabled, zero
when disabled" (see docs/ARCHITECTURE.md, Observability plane).

Percentiles come from :class:`LogHistogram`\\ s — fixed geometric bucket
edges (``lo · growth^i``), so

* a quantile estimate is always within **one bucket bound** of the exact
  sample quantile (the estimate is the upper edge of the bucket holding
  the exact value, tested in tests/test_obs.py);
* histograms **merge associatively** (bucket counts add), so per-shard /
  per-replica histograms can be pooled into fleet views without ever
  shipping raw samples — the property the 10k-replica control-plane
  direction needs (merge(h1, merge(h2, h3)) == pooled, also tested).

Exposition: ``render_prometheus()`` emits the Prometheus text format
(counters/gauges as samples, histograms as cumulative ``_bucket{le=...}``
series with ``_sum``/``_count``); ``snapshot()`` returns the same data as
one nested dict for JSON artifacts and in-process consumers (the SLO
views in obs/slo.py).
"""

from __future__ import annotations

import math
from bisect import bisect_left
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable, Optional

LabelDict = Optional[dict]
_LabelKey = tuple  # sorted ((k, v), ...) tuple


def _label_key(labels: LabelDict) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


@dataclass(frozen=True)
class HistogramSpec:
    """Geometric bucket layout: upper edges ``lo * growth**i``.

    ``growth`` is the percentile error bound above ``lo``: an estimate
    never exceeds the exact quantile by more than one bucket (factor
    ``growth``).  The underflow bucket has the weaker bound of
    :meth:`LogHistogram.percentile`."""

    lo: float = 1e-4          # first upper edge (underflow bucket [0, lo])
    growth: float = 2.0       # geometric bucket ratio
    n_buckets: int = 44       # covers lo .. lo*growth^(n-1); then overflow

    def edges(self) -> list[float]:
        """All finite upper edges, ascending."""
        return [self.lo * self.growth ** i for i in range(self.n_buckets)]


DEFAULT_SPEC = HistogramSpec()


class LogHistogram:
    """Log-bucketed histogram with exact sum/count/min/max side-channels.

    ``percentile(p)`` returns the upper edge of the bucket containing the
    p-th sample — an overestimate by at most ``spec.growth`` (one bucket
    bound).  The overflow bucket reports the exact observed max instead of
    an unbounded edge, and the underflow bucket ``[0, lo]`` the largest
    sample it holds (``under_max``).  ``merge`` adds bucket counts (same
    spec required), which is associative and commutative by
    construction."""

    __slots__ = ("spec", "_edges", "counts", "count", "sum", "min", "max",
                 "under_max")

    def __init__(self, spec: HistogramSpec = DEFAULT_SPEC):
        self.spec = spec
        self._edges = spec.edges()
        self.counts = [0] * (spec.n_buckets + 1)   # +1 overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.under_max = -math.inf      # largest sample in [0, lo]

    def observe(self, value: float) -> None:
        """Record one sample (negative values clamp into the first bucket)."""
        v = value if value > 0.0 else 0.0
        i = bisect_left(self._edges, v)
        self.counts[i] += 1
        if i == 0 and v > self.under_max:
            self.under_max = v
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        """Exact mean of all observations (0.0 when empty)."""
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Estimate of the p-th percentile (0 < p <= 100); 0.0 when empty.

        Bound (tested): ``exact <= estimate <= exact * spec.growth`` for
        samples landing in the finite buckets above ``lo``; overflow reports
        the exact max.  The underflow bucket ``[0, lo]`` has no edge within
        a factor ``growth`` of its samples, so it reports the largest sample
        it holds: ``exact <= estimate <= that sample <= lo`` — exact when
        the bucket holds one value, and within ``exact * spec.growth`` when
        its samples lie within a factor ``growth`` of each other.
        """
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(p / 100.0 * self.count))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                if i >= len(self._edges):        # overflow bucket
                    return self.max
                if i == 0:                       # underflow bucket
                    return self.under_max
                return self._edges[i]
        return self.max

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Fold ``other`` into self (in place; returns self).  Requires an
        identical bucket spec — shard histograms must agree on layout."""
        if other.spec != self.spec:
            raise ValueError("cannot merge histograms with different specs")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self.under_max = max(self.under_max, other.under_max)
        return self

    def copy(self) -> "LogHistogram":
        """Independent deep copy (merge without mutating the source)."""
        h = LogHistogram(self.spec)
        h.counts = list(self.counts)
        h.count, h.sum, h.min, h.max = self.count, self.sum, self.min, self.max
        h.under_max = self.under_max
        return h

    def summary(self, pcts: Iterable[float] = (50, 95, 99)) -> dict:
        """{mean, n, p50, p95, p99} view (the benches' SLO row)."""
        out = {"mean": self.mean, "n": self.count}
        for p in pcts:
            out[f"p{int(p)}"] = self.percentile(p)
        return out


@dataclass
class _Timeline:
    """Bounded (time, value) series — burn-rate timelines and similar
    low-rate control-plane signals.  Not exposed to Prometheus (it would
    be a gauge there); surfaced through ``snapshot()`` and the SLO views."""

    maxlen: int = 2048
    points: deque = field(default_factory=deque)

    def append(self, t: float, v: float) -> None:
        if len(self.points) >= self.maxlen:
            self.points.popleft()
        self.points.append((t, v))


class _CounterHandle:
    """A pre-resolved counter series: ``inc`` is one dict update, no label
    hashing/sorting.  Hot loops (per-tick, per-dispatch emission) bind one
    of these once instead of paying ``_label_key`` per event."""

    __slots__ = ("_series", "_key")

    def __init__(self, series: dict, key: _LabelKey):
        self._series = series
        self._key = key

    def inc(self, v: float = 1.0) -> None:
        self._series[self._key] = self._series.get(self._key, 0.0) + v


class _GaugeHandle:
    """A pre-resolved gauge series (see :class:`_CounterHandle`)."""

    __slots__ = ("_series", "_key")

    def __init__(self, series: dict, key: _LabelKey):
        self._series = series
        self._key = key

    def set(self, v: float) -> None:
        self._series[self._key] = v


class MetricsRegistry:
    """Name+labels → metric store with Prometheus-style exposition.

    Metric kinds are implicit in the API used: ``inc`` creates counters,
    ``set_gauge`` gauges, ``observe`` histograms, ``record_timeline``
    timelines.  A name must keep one kind (enforced).

    For hot paths, ``counter(name, labels)`` / ``gauge(name, labels)`` /
    ``hist(name, labels)`` resolve the label set once and return a bound
    handle (the Prometheus-client ``labels().inc()`` pattern) — recording
    through a handle is a single dict update or bisect."""

    def __init__(self, hist_spec: HistogramSpec = DEFAULT_SPEC):
        self.hist_spec = hist_spec
        self._counters: dict[str, dict[_LabelKey, float]] = {}
        self._gauges: dict[str, dict[_LabelKey, float]] = {}
        self._hists: dict[str, dict[_LabelKey, LogHistogram]] = {}
        self._timelines: dict[str, dict[_LabelKey, _Timeline]] = {}
        self._hist_specs: dict[str, HistogramSpec] = {}

    # ---- recording -------------------------------------------------------

    def inc(self, name: str, labels: LabelDict = None, v: float = 1.0) -> None:
        """Increment a labeled counter by ``v``."""
        series = self._counters.setdefault(name, {})
        key = _label_key(labels)
        series[key] = series.get(key, 0.0) + v

    def set_gauge(self, name: str, labels: LabelDict = None,
                  v: float = 0.0) -> None:
        """Set a labeled gauge to ``v``."""
        self._gauges.setdefault(name, {})[_label_key(labels)] = v

    def declare_histogram(self, name: str, spec: HistogramSpec) -> None:
        """Pin a non-default bucket spec for ``name`` (before first use)."""
        self._hist_specs[name] = spec

    def observe(self, name: str, value: float,
                labels: LabelDict = None) -> None:
        """Record one sample into a labeled log-bucketed histogram."""
        series = self._hists.setdefault(name, {})
        key = _label_key(labels)
        h = series.get(key)
        if h is None:
            h = series[key] = LogHistogram(
                self._hist_specs.get(name, self.hist_spec))
        h.observe(value)

    def record_timeline(self, name: str, t: float, v: float,
                        labels: LabelDict = None) -> None:
        """Append a (t, v) point to a bounded labeled timeline."""
        series = self._timelines.setdefault(name, {})
        key = _label_key(labels)
        tl = series.get(key)
        if tl is None:
            tl = series[key] = _Timeline()
        tl.append(t, v)

    # ---- bound handles (hot-path recording) ------------------------------

    def counter(self, name: str, labels: LabelDict = None) -> _CounterHandle:
        """Bind a counter series once; the handle's ``inc`` is O(1)."""
        series = self._counters.setdefault(name, {})
        key = _label_key(labels)
        series.setdefault(key, 0.0)
        return _CounterHandle(series, key)

    def gauge(self, name: str, labels: LabelDict = None) -> _GaugeHandle:
        """Bind a gauge series once; the handle's ``set`` is O(1)."""
        series = self._gauges.setdefault(name, {})
        key = _label_key(labels)
        series.setdefault(key, 0.0)
        return _GaugeHandle(series, key)

    def hist(self, name: str, labels: LabelDict = None) -> LogHistogram:
        """Bind (creating if needed) one labeled histogram; callers then
        ``observe`` on it directly."""
        series = self._hists.setdefault(name, {})
        key = _label_key(labels)
        h = series.get(key)
        if h is None:
            h = series[key] = LogHistogram(
                self._hist_specs.get(name, self.hist_spec))
        return h

    # ---- reading ---------------------------------------------------------

    def counter_value(self, name: str, labels: LabelDict = None) -> float:
        """Current value of one counter series (0.0 if never incremented)."""
        return self._counters.get(name, {}).get(_label_key(labels), 0.0)

    def histogram(self, name: str,
                  labels: LabelDict = None) -> Optional[LogHistogram]:
        """The histogram for one exact label set (None if absent)."""
        return self._hists.get(name, {}).get(_label_key(labels))

    def histograms(self, name: str) -> dict[_LabelKey, LogHistogram]:
        """All label sets recorded under a histogram name."""
        return self._hists.get(name, {})

    def timeline(self, name: str,
                 labels: LabelDict = None) -> list[tuple[float, float]]:
        """The (t, v) points of one timeline series ([] if absent)."""
        tl = self._timelines.get(name, {}).get(_label_key(labels))
        return list(tl.points) if tl is not None else []

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another registry (a shard) into this one: counters add,
        gauges last-writer-wins, histograms merge, timelines concatenate."""
        for name, series in other._counters.items():
            for key, v in series.items():
                dst = self._counters.setdefault(name, {})
                dst[key] = dst.get(key, 0.0) + v
        for name, series in other._gauges.items():
            self._gauges.setdefault(name, {}).update(series)
        for name, series in other._hists.items():
            dst = self._hists.setdefault(name, {})
            for key, h in series.items():
                if key in dst:
                    dst[key].merge(h)
                else:
                    dst[key] = h.copy()
        for name, series in other._timelines.items():
            dst = self._timelines.setdefault(name, {})
            for key, tl in series.items():
                mine = dst.setdefault(key, _Timeline(maxlen=tl.maxlen))
                for t, v in tl.points:
                    mine.append(t, v)
        return self

    # ---- exposition ------------------------------------------------------

    def snapshot(self) -> dict:
        """Nested-dict view of everything recorded (JSON-serializable):
        ``{counters, gauges, histograms, timelines}``, histograms as
        mean/n/p50/p95/p99 summaries keyed by rendered label strings."""
        def k(key: _LabelKey) -> str:
            return ",".join(f"{a}={b}" for a, b in key) or "_"

        return {
            "counters": {name: {k(key): v for key, v in series.items()}
                         for name, series in sorted(self._counters.items())},
            "gauges": {name: {k(key): v for key, v in series.items()}
                       for name, series in sorted(self._gauges.items())},
            "histograms": {name: {k(key): h.summary()
                                  for key, h in series.items()}
                           for name, series in sorted(self._hists.items())},
            "timelines": {name: {k(key): list(tl.points)
                                 for key, tl in series.items()}
                          for name, series in sorted(self._timelines.items())},
        }

    def render_prometheus(self) -> str:
        """Prometheus text exposition (counters, gauges, histograms with
        cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``)."""
        def fmt_labels(key: _LabelKey, extra: str = "") -> str:
            parts = [f'{a}="{b}"' for a, b in key]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        lines: list[str] = []
        for name, series in sorted(self._counters.items()):
            lines.append(f"# TYPE {name} counter")
            for key, v in sorted(series.items()):
                lines.append(f"{name}{fmt_labels(key)} {v:g}")
        for name, series in sorted(self._gauges.items()):
            lines.append(f"# TYPE {name} gauge")
            for key, v in sorted(series.items()):
                lines.append(f"{name}{fmt_labels(key)} {v:g}")
        for name, series in sorted(self._hists.items()):
            lines.append(f"# TYPE {name} histogram")
            for key, h in sorted(series.items()):
                acc = 0
                for edge, c in zip(h._edges, h.counts):
                    acc += c
                    le = 'le="%g"' % edge
                    lines.append(f"{name}_bucket{fmt_labels(key, le)} {acc}")
                inf = 'le="+Inf"'
                lines.append(f"{name}_bucket{fmt_labels(key, inf)} {h.count}")
                lines.append(f"{name}_sum{fmt_labels(key)} {h.sum:g}")
                lines.append(f"{name}_count{fmt_labels(key)} {h.count}")
        return "\n".join(lines) + "\n"
