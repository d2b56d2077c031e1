"""Prometheus-style metrics registry (self-contained).

Reference: pkg/metrics/constants.go (namespace "karpenter", duration buckets
5 ms … 60 s, Measure defer-timer); a copy of the JAX package's
``metrics/registry.py``. Exposition follows the Prometheus text format so
any scraper can consume /metrics.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

NAMESPACE = "karpenter"

# constants.go:33-38
DURATION_BUCKETS = [0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60]

LabelValues = Tuple[Tuple[str, str], ...]


def _lv(labels: Dict[str, str]) -> LabelValues:
    return tuple(sorted(labels.items()))


_ABSENT = object()


def _project(lv: LabelValues, names: Tuple[str, ...]) -> tuple:
    """``lv``'s values of ``names``, _ABSENT where it lacks one."""
    labels = dict(lv)
    return tuple(labels.get(k, _ABSENT) for k in names)


class Gauge:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._values: Dict[LabelValues, float] = {}
        # the label names delete_matching was asked for -> {their values:
        # the series holding them}: built at the first such call and kept
        # current by every write, so a per-object cleanup costs that
        # object's series, not the family's (pods_state has one per pod)
        self._index: Dict[Tuple[str, ...], Dict[tuple, set]] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels) -> None:
        lv = _lv(labels)
        with self._lock:
            if lv not in self._values:
                self._index_locked(lv)
            self._values[lv] = value

    def inc(self, amount: float = 1.0, **labels) -> None:
        lv = _lv(labels)
        with self._lock:
            if lv not in self._values:
                self._index_locked(lv)
            self._values[lv] = self._values.get(lv, 0.0) + amount

    def delete(self, **labels) -> None:
        lv = _lv(labels)
        with self._lock:
            if self._values.pop(lv, None) is not None:
                self._unindex_locked(lv)

    def delete_matching(self, **labels) -> None:
        """Drop every series whose labels include the given subset — the
        stale-series cleanup used by the node metrics controller
        (metrics/node/controller.go:196-208)."""
        names = tuple(sorted(labels))
        with self._lock:
            index = self._index.get(names)
            if index is None:
                index = self._index[names] = {}
                for lv in self._values:
                    index.setdefault(_project(lv, names), set()).add(lv)
            for lv in index.pop(tuple(labels[k] for k in names), ()):
                del self._values[lv]
                self._unindex_locked(lv)

    def _index_locked(self, lv: LabelValues) -> None:
        for names, index in self._index.items():
            index.setdefault(_project(lv, names), set()).add(lv)

    def _unindex_locked(self, lv: LabelValues) -> None:
        for names, index in self._index.items():
            key = _project(lv, names)
            held = index.get(key)
            if held is not None:
                held.discard(lv)
                if not held:
                    del index[key]

    def collect(self) -> Dict[LabelValues, float]:
        with self._lock:
            return dict(self._values)


class Counter(Gauge):
    pass


class Histogram:
    def __init__(self, name: str, help_: str = "", buckets: Optional[List[float]] = None):
        self.name = name
        self.help = help_
        self.buckets = list(buckets or DURATION_BUCKETS)
        self._counts: Dict[LabelValues, List[int]] = {}
        self._sums: Dict[LabelValues, float] = {}
        self._totals: Dict[LabelValues, int] = {}
        # exemplar per series: the trace id of one recent observation so a
        # histogram quantile can be joined back to a concrete window trace
        # (surfaced via /debug/vars, never in the Prometheus text format)
        self._exemplars: Dict[LabelValues, Dict[str, object]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels) -> None:
        lv = _lv(labels)
        with self._lock:
            counts = self._counts.setdefault(lv, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[lv] = self._sums.get(lv, 0.0) + value
            self._totals[lv] = self._totals.get(lv, 0) + 1
            if exemplar is not None:
                self._exemplars[lv] = {"trace_id": exemplar, "value": value}

    def collect_exemplars(self) -> Dict[LabelValues, Dict[str, object]]:
        with self._lock:
            return dict(self._exemplars)

    @contextmanager
    def time(self, **labels):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0, **labels)

    def collect(self):
        with self._lock:
            return {lv: (list(c), self._sums[lv], self._totals[lv])
                    for lv, c in self._counts.items()}


class Registry:
    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help_), help_)

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_create(name, lambda: Counter(name, help_), help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: Optional[List[float]] = None) -> Histogram:
        return self._get_or_create(
            name, lambda: Histogram(name, help_, buckets), help_)

    def _get_or_create(self, name: str, factory, help_: str = ""):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = factory()
            elif help_ and not metric.help:
                # help attachment is order-independent: whichever call
                # site carries the help text wins, whenever it runs
                metric.help = help_
            return metric

    @contextmanager
    def time(self, name: str, **labels):
        with self.histogram(name).time(**labels):
            yield

    def expose(self) -> str:
        """Prometheus text exposition format."""
        lines: List[str] = []
        with self._lock:
            metrics = dict(self._metrics)
        for name, metric in sorted(metrics.items()):
            full = f"{NAMESPACE}_{name}"
            if metric.help:
                lines.append(f"# HELP {full} {metric.help}")
            if isinstance(metric, Histogram):
                lines.append(f"# TYPE {full} histogram")
                for lv, (counts, sum_, total) in metric.collect().items():
                    base = _fmt_labels(lv)
                    cum = 0
                    for b, c in zip(metric.buckets, counts):
                        cum = c
                        lines.append(f'{full}_bucket{{{_join(base, ("le", str(b)))}}} {cum}')
                    lines.append(f'{full}_bucket{{{_join(base, ("le", "+Inf"))}}} {total}')
                    lines.append(f"{full}_sum{{{_fmt(base)}}} {sum_}")
                    lines.append(f"{full}_count{{{_fmt(base)}}} {total}")
            else:
                kind = "counter" if isinstance(metric, Counter) else "gauge"
                lines.append(f"# TYPE {full} {kind}")
                for lv, v in metric.collect().items():
                    lines.append(f"{full}{{{_fmt(lv)}}} {v}")
        return "\n".join(lines) + "\n"

    def registered(self) -> Dict[str, object]:
        """Name -> metric object view."""
        with self._lock:
            return dict(self._metrics)

    def snapshot(self) -> Dict[str, dict]:
        """JSON-serializable dump of every registered series — the
        /debug/vars payload. Histograms report count/sum per series plus
        the stored exemplar trace id when one was attached."""
        out: Dict[str, dict] = {}
        with self._lock:
            metrics = dict(self._metrics)
        for name, metric in sorted(metrics.items()):
            if isinstance(metric, Histogram):
                series = {}
                exemplars = metric.collect_exemplars()
                for lv, (_, sum_, total) in metric.collect().items():
                    entry: Dict[str, object] = {"count": total, "sum": sum_}
                    ex = exemplars.get(lv)
                    if ex is not None:
                        entry["exemplar"] = ex
                    series[_fmt(lv)] = entry
                out[name] = {"type": "histogram", "help": metric.help,
                             "series": series}
            else:
                kind = "counter" if isinstance(metric, Counter) else "gauge"
                out[name] = {"type": kind, "help": metric.help,
                             "series": {_fmt(lv): v
                                        for lv, v in metric.collect().items()}}
        return out


def _fmt_labels(lv: LabelValues) -> List[Tuple[str, str]]:
    return list(lv)


def _fmt(pairs) -> str:
    return ",".join(f'{k}="{v}"' for k, v in pairs)


def _join(pairs, extra) -> str:
    return _fmt(list(pairs) + [extra])


# Process-wide default registry (the controller-runtime registry analog).
DEFAULT = Registry()
HISTOGRAMS = DEFAULT
