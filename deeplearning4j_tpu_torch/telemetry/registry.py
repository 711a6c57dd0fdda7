"""Metrics registry: counters, gauges, histograms + Prometheus exposition
— the port of ``deeplearning4j_tpu/telemetry/registry.py``, pure Python and
copied so that the two packages' ``/metrics`` text is the same for the same
sequence of ``inc`` / ``set`` / ``observe``.

- :class:`MetricsRegistry` — thread-safe name → metric map with a
  process-global default (:func:`get_registry`).  Hot-path users fetch
  their metric through the idempotent ``counter()/gauge()/histogram()``
  constructors (a dict lookup under a lock).
- Prometheus text exposition (:meth:`MetricsRegistry.exposition`) served
  from ``/metrics`` by the serving tier's HTTP fronts
  (``remote.serving.InferenceServer``, ``remote.server.JsonModelServer``).

Naming convention: every public metric is ``dl4j_tpu_<subsystem>_<name>``;
counters end in ``_total``, time histograms in ``_seconds``.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "set_registry", "DEFAULT_BUCKETS"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: step/restore latencies span ~1ms (CPU toy nets) to minutes (pod-scale
#: compile) — log-spaced like the Prometheus defaults, stretched upward
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0)


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


def _label_str(labelnames: Sequence[str], labelvalues: Tuple[str, ...]) -> str:
    if not labelnames:
        return ""
    inner = ",".join(
        '%s="%s"' % (n, str(v).replace("\\", r"\\").replace('"', r"\"")
                     .replace("\n", r"\n"))
        for n, v in zip(labelnames, labelvalues))
    return "{" + inner + "}"


class _Metric:
    """Shared label-set bookkeeping.  One ``_Metric`` per registered name;
    per-label-set cells live in ``_cells`` keyed by the label-value tuple."""

    typ = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 maxLabelSets: int = 1000):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.maxLabelSets = int(maxLabelSets)
        self._cells: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def _cell(self, labels: Dict[str, str]):
        key = self._key(labels)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                if len(self._cells) >= self.maxLabelSets:
                    # unbounded label cardinality is the classic way a
                    # metrics pipeline OOMs its own process — fail loudly
                    raise ValueError(
                        f"{self.name}: label cardinality limit "
                        f"{self.maxLabelSets} exceeded")
                cell = self._new_cell()
                self._cells[key] = cell
            return cell

    def _new_cell(self):
        raise NotImplementedError

    def expose(self) -> List[str]:
        raise NotImplementedError

    def data(self) -> dict:
        """JSON-able structural dump of this metric (type/help/labels plus
        every cell's raw state) — what the retention ring samples and
        ``health_summary`` reads."""
        with self._lock:
            items = list(self._cells.items())
        return {"type": self.typ, "help": self.help,
                "labelnames": list(self.labelnames),
                "cells": [[list(key), self._cell_data(cell)]
                          for key, cell in sorted(items)]}

    def _cell_data(self, cell):
        raise NotImplementedError

    def _header(self) -> List[str]:
        out = []
        if self.help:
            out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.typ}")
        return out


class _Value:
    __slots__ = ("v", "lock")

    def __init__(self):
        self.v = 0.0
        self.lock = threading.Lock()


class _ScalarMetric(_Metric):
    """One float cell per label set (counter/gauge share this shape)."""

    def _new_cell(self) -> _Value:
        return _Value()

    def inc(self, amount: float = 1.0, **labels) -> None:
        cell = self._cell(labels)
        with cell.lock:
            cell.v += amount

    def value(self, **labels) -> float:
        cell = self._cell(labels)
        with cell.lock:
            return cell.v

    def expose(self) -> List[str]:
        out = self._header()
        with self._lock:
            items = list(self._cells.items())
        for key, cell in sorted(items):
            out.append(f"{self.name}{_label_str(self.labelnames, key)} "
                       f"{_fmt(cell.v)}")
        return out

    def _cell_data(self, cell: _Value) -> float:
        with cell.lock:
            return cell.v


class Counter(_ScalarMetric):
    typ = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        super().inc(amount, **labels)


class Gauge(_ScalarMetric):
    typ = "gauge"

    def set(self, value: float, **labels) -> None:
        cell = self._cell(labels)
        with cell.lock:
            cell.v = float(value)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class _HistCell:
    __slots__ = ("counts", "sum", "count", "lock")

    def __init__(self, nbuckets: int):
        self.counts = [0] * (nbuckets + 1)     # +1 for +Inf
        self.sum = 0.0
        self.count = 0
        self.lock = threading.Lock()


class Histogram(_Metric):
    typ = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 maxLabelSets: int = 1000):
        super().__init__(name, help, labelnames, maxLabelSets)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"{self.name}: need at least one bucket")
        self.buckets = tuple(bs)

    def _new_cell(self) -> _HistCell:
        return _HistCell(len(self.buckets))

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        cell = self._cell(labels)
        i = len(self.buckets)
        for j, b in enumerate(self.buckets):
            if v <= b:
                i = j
                break
        with cell.lock:
            cell.counts[i] += 1
            cell.sum += v
            cell.count += 1

    def count(self, **labels) -> int:
        cell = self._cell(labels)
        with cell.lock:
            return cell.count

    def sum(self, **labels) -> float:
        cell = self._cell(labels)
        with cell.lock:
            return cell.sum

    def data(self) -> dict:
        out = super().data()
        out["buckets"] = list(self.buckets)
        return out

    def _cell_data(self, cell: _HistCell) -> dict:
        with cell.lock:
            return {"counts": list(cell.counts), "sum": cell.sum,
                    "count": cell.count}

    def bucketCounts(self, **labels) -> Dict[float, int]:
        """CUMULATIVE per-upper-bound counts (Prometheus ``le`` semantics),
        +Inf included."""
        cell = self._cell(labels)
        with cell.lock:
            raw = list(cell.counts)
        out, acc = {}, 0
        for b, c in zip(self.buckets + (math.inf,), raw):
            acc += c
            out[b] = acc
        return out

    def expose(self) -> List[str]:
        out = self._header()
        with self._lock:
            items = list(self._cells.items())
        for key, cell in sorted(items):
            with cell.lock:
                raw, s, n = list(cell.counts), cell.sum, cell.count
            acc = 0
            for b, c in zip(self.buckets + (math.inf,), raw):
                acc += c
                lv = key + (_fmt(b),)
                out.append(
                    f"{self.name}_bucket"
                    f"{_label_str(self.labelnames + ('le',), lv)} {acc}")
            out.append(f"{self.name}_sum{_label_str(self.labelnames, key)} "
                       f"{_fmt(s)}")
            out.append(f"{self.name}_count{_label_str(self.labelnames, key)} "
                       f"{n}")
        return out


class MetricsRegistry:
    """Thread-safe name → metric map with idempotent constructors."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, cls, name: str, help: str, labelnames, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"{name} already registered as {existing.typ}, "
                        f"not {cls.typ}")
                if tuple(labelnames) != existing.labelnames:
                    raise ValueError(
                        f"{name}: labelnames {tuple(labelnames)} != "
                        f"registered {existing.labelnames}")
                buckets = kw.get("buckets")
                if buckets is not None and tuple(sorted(
                        float(b) for b in buckets)) != existing.buckets:
                    # silently observing into someone else's bounds would
                    # leave the caller's expected le series empty
                    raise ValueError(
                        f"{name}: buckets {tuple(buckets)} != registered "
                        f"{existing.buckets}")
                return existing
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def clear(self) -> None:
        """Drop every metric (tests; the process-global default registry
        would otherwise leak state across test cases)."""
        with self._lock:
            self._metrics.clear()

    def exposition(self) -> str:
        """Prometheus text format, trailing newline included."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able {name: metric.data()} dump of every registered
        metric."""
        with self._lock:
            metrics = [(n, self._metrics[n]) for n in sorted(self._metrics)]
        return {n: m.data() for n, m in metrics}


_default = MetricsRegistry()
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global default registry (what ``/metrics`` serves)."""
    return _default


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (tests); returns the previous one."""
    global _default
    with _default_lock:
        prev, _default = _default, registry
    return prev
