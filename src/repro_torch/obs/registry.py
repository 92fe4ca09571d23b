"""A minimal in-process metrics registry (a copy of ``repro.obs.registry``
without its Prometheus exposition): counters, gauges and histograms with
label sets, and JSON snapshots.

It is the single source of truth for the engine's serving statistics:
``ContinuousEngine.run`` reports counter movements over a run.

Design points:

* **Names are Prometheus-style** (``snake_case``, ``_total`` suffix for
  counters); label values are stringified and keyed by a sorted
  ``(key, value)`` tuple so ``counter("x", a=1, b=2)`` and
  ``counter("x", b=2, a=1)`` address the same series.
* **Counters are monotonic.**  ``inc`` rejects negative deltas, which
  is what makes the ``mark()``/``delta()`` per-run accounting sound.
* **``mark()``/``delta()``**: a mark is a frozen copy of every counter
  series; ``delta(mark, name)`` is how much a counter moved since,
  summed over label sets unless one is given.
* No background threads, no locks: the serving engine is single-threaded
  host code, and a few dict updates per engine step is the entire cost.
"""
from __future__ import annotations

import bisect
from typing import Dict, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

DEFAULT_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                   1000.0, 2500.0, 5000.0, 10000.0)


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render(name: str, key: LabelKey) -> str:
    if not key:
        return name
    inner = ",".join(f"{k}={v}" for k, v in key)
    return f"{name}{{{inner}}}"


class _Metric:
    """One named metric: a family of series keyed by label set."""

    def __init__(self, name: str, kind: str, help: str = "",
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.kind = kind                     # "counter" | "gauge" | "histogram"
        self.help = help
        self.buckets = tuple(buckets) if buckets else None
        self.series: Dict[LabelKey, object] = {}


class _Handle:
    """A metric bound to one label set — what ``registry.counter(...)``
    returns.  Cheap to construct per call site."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: _Metric, key: LabelKey):
        self._metric = metric
        self._key = key

    @property
    def value(self) -> float:
        return float(self._metric.series.get(self._key, 0.0))

    # -- counter ------------------------------------------------------------

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(
                f"counter {self._metric.name} cannot decrease (inc {v})")
        self._metric.series[self._key] = (
            self._metric.series.get(self._key, 0.0) + v)

    def set_to(self, v: float) -> None:
        """Mirror an external monotonic total (the prefix cache's own
        ``stats``) into this counter.  Rejects decreases."""
        cur = self._metric.series.get(self._key, 0.0)
        if v < cur:
            raise ValueError(
                f"counter {self._metric.name} cannot decrease ({cur} -> {v})")
        self._metric.series[self._key] = float(v)

    # -- gauge --------------------------------------------------------------

    def set(self, v: float) -> None:
        self._metric.series[self._key] = float(v)

    def set_max(self, v: float) -> None:
        """High-water-mark gauge: keep the maximum of what was set."""
        cur = self._metric.series.get(self._key)
        if cur is None or v > cur:
            self._metric.series[self._key] = float(v)

    # -- histogram ----------------------------------------------------------

    def observe(self, v: float) -> None:
        st = self._metric.series.get(self._key)
        if st is None:
            st = {"count": 0, "sum": 0.0,
                  "buckets": [0] * len(self._metric.buckets)}
            self._metric.series[self._key] = st
        st["count"] += 1
        st["sum"] += float(v)
        i = bisect.bisect_left(self._metric.buckets, v)
        if i < len(self._metric.buckets):
            st["buckets"][i] += 1


class MetricsRegistry:
    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    # -- access -------------------------------------------------------------

    def _get(self, name: str, kind: str, help: str = "",
             buckets: Optional[Tuple[float, ...]] = None,
             labels: Dict[str, object] = {}) -> _Handle:
        m = self._metrics.get(name)
        if m is None:
            m = _Metric(name, kind, help, buckets)
            self._metrics[name] = m
        elif m.kind != kind:
            raise TypeError(
                f"metric {name!r} is a {m.kind}, requested as {kind}")
        return _Handle(m, _label_key(labels))

    def counter(self, name: str, help: str = "", **labels) -> _Handle:
        return self._get(name, "counter", help, labels=labels)

    def gauge(self, name: str, help: str = "", **labels) -> _Handle:
        return self._get(name, "gauge", help, labels=labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels) -> _Handle:
        return self._get(name, "histogram", help, buckets, labels=labels)

    def get(self, name: str, **labels) -> float:
        """Current value of one counter/gauge series (0.0 if unset).
        Without labels, counters sum across their label sets."""
        m = self._metrics.get(name)
        if m is None:
            return 0.0
        if labels or m.kind == "gauge":
            v = m.series.get(_label_key(labels), 0.0)
            return float(v) if not isinstance(v, dict) else 0.0
        return float(sum(v for v in m.series.values()
                         if not isinstance(v, dict)))

    # -- per-run accounting --------------------------------------------------

    def mark(self) -> Dict[str, Dict[LabelKey, float]]:
        """Freeze every counter series — the baseline for ``delta``."""
        return {name: dict(m.series) for name, m in self._metrics.items()
                if m.kind == "counter"}

    def delta(self, mark: Dict[str, Dict[LabelKey, float]], name: str,
              **labels) -> float:
        """Counter movement since ``mark``: one series when labels are
        given, else summed across the metric's label sets."""
        m = self._metrics.get(name)
        if m is None:
            return 0.0
        base = mark.get(name, {})
        if labels:
            k = _label_key(labels)
            return float(m.series.get(k, 0.0)) - float(base.get(k, 0.0))
        return (sum(m.series.values()) - sum(base.values())) if m.series else 0.0

    # -- export --------------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """Flat JSON-friendly view: ``name{label=value,...} -> number``
        (histograms export ``_count``/``_sum``/``_bucket`` series)."""
        out: Dict[str, object] = {}
        for name, m in sorted(self._metrics.items()):
            for key, v in sorted(m.series.items()):
                if m.kind == "histogram":
                    out[_render(name + "_count", key)] = v["count"]
                    out[_render(name + "_sum", key)] = v["sum"]
                    for le, n in zip(m.buckets, v["buckets"]):
                        out[_render(name + "_bucket",
                                    key + (("le", repr(le)),))] = n
                else:
                    out[_render(name, key)] = v
        return out
