"""The part of ``prometheus_client`` the control plane's metrics use, on the
standard library: labelled counters, gauges and histograms on a registry,
and the text exposition format (0.0.4) that ``/metrics`` answers with.

``server/observability.py`` writes every metric through this module,
whether ``prometheus_client`` is installed or not (the card's machine has
none), so one metrics path runs everywhere. Its text is
``prometheus_client``'s, names and values, except that no ``*_created``
samples are written.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

INF = float("inf")
_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75,
                    1.0, 2.5, 5.0, 7.5, 10.0, INF)


def float_to_go_string(d: float) -> str:
    """A value as ``prometheus_client`` writes it (Go's float format)."""
    d = float(d)
    if d == INF:
        return "+Inf"
    if d == -INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape(value: str) -> str:
    return value.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _labels(pairs: Sequence[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(pairs)) + "}"


class CollectorRegistry:
    def __init__(self) -> None:
        self._metrics: List["_Metric"] = []

    def register(self, metric: "_Metric") -> None:
        self._metrics.append(metric)

    def render(self) -> str:
        return "".join(m.render() for m in self._metrics)


class _Child:
    def __init__(self, kind: str, buckets: Sequence[float]) -> None:
        self._lock = threading.Lock()
        self.value = 0.0
        self.buckets = list(buckets)
        self.counts = [0.0] * len(self.buckets)
        self.sum = 0.0
        self._kind = kind

    def inc(self, amount: float = 1.0) -> None:
        if self._kind == "counter" and amount < 0:
            raise ValueError("Counters can only be incremented by non-negative amounts.")
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def observe(self, amount: float) -> None:
        with self._lock:
            self.sum += amount
            for i, bound in enumerate(self.buckets):
                if amount <= bound:
                    self.counts[i] += 1.0
                    break


class _Metric:
    kind = ""

    def __init__(self, name: str, documentation: str,
                 labelnames: Sequence[str] = (),
                 registry: Optional[CollectorRegistry] = None,
                 buckets: Sequence[float] = _DEFAULT_BUCKETS) -> None:
        if self.kind == "counter" and name.endswith("_total"):
            name = name[:-len("_total")]
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        bs = [float(b) for b in buckets]
        if bs and bs[-1] != INF:
            bs.append(INF)
        self._buckets = bs
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:
            self._children[()] = _Child(self.kind, bs)
        if registry is not None:
            registry.register(self)

    def labels(self, *values: object, **kw: object) -> _Child:
        if kw:
            values = tuple(kw[n] for n in self.labelnames)
        if len(values) != len(self.labelnames):
            raise ValueError("Incorrect label count")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _Child(self.kind, self._buckets)
            return child

    def _only(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"{self.name}: a labelled metric needs labels()")
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._only().dec(amount)

    def set(self, value: float) -> None:
        self._only().set(value)

    def observe(self, amount: float) -> None:
        self._only().observe(amount)

    def _head(self, name: str) -> str:
        doc = self.documentation.replace("\\", r"\\").replace("\n", r"\n")
        return f"# HELP {name} {doc}\n# TYPE {name} {self.kind}\n"

    def render(self) -> str:
        with self._lock:
            children = list(self._children.items())
        if self.kind == "counter":
            out = self._head(self.name + "_total")
            for key, c in children:
                pairs = list(zip(self.labelnames, key))
                out += f"{self.name}_total{_labels(pairs)} {float_to_go_string(c.value)}\n"
            return out
        out = self._head(self.name)
        for key, c in children:
            pairs = list(zip(self.labelnames, key))
            if self.kind == "gauge":
                out += f"{self.name}{_labels(pairs)} {float_to_go_string(c.value)}\n"
                continue
            acc = 0.0
            for bound, n in zip(c.buckets, c.counts):
                acc += n
                le = pairs + [("le", float_to_go_string(bound))]
                out += f"{self.name}_bucket{_labels(le)} {float_to_go_string(acc)}\n"
            out += f"{self.name}_count{_labels(pairs)} {float_to_go_string(acc)}\n"
            out += f"{self.name}_sum{_labels(pairs)} {float_to_go_string(c.sum)}\n"
        return out


class Counter(_Metric):
    kind = "counter"


class Gauge(_Metric):
    kind = "gauge"


class Histogram(_Metric):
    kind = "histogram"


def generate_latest(registry: CollectorRegistry) -> bytes:
    return registry.render().encode("utf-8")
