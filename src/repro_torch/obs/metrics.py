"""Metrics registry — counters, gauges, fixed-bucket histograms.

The always-on half of the observability layer (the tracer is opt-in;
counters are cheap enough to publish unconditionally): every serving
component increments named metrics here, and a scrape reads them as a
flat dict (:meth:`Registry.snapshot`).

Histograms use **fixed log-spaced buckets**: p50/p99/p999 come from
cumulative bucket counts with linear interpolation inside the landing
bucket — O(buckets) memory, no stored samples, mergeable across
scrapes. That is the trade a serving system wants: a bounded-error
quantile forever beats an exact quantile that OOMs the recorder.

Publication discipline: one update per *batch or request*, never per
row — the hot path pays a dict ``get`` plus a lock-free-read /
locked-write pair per update, which is noise against a device batch but
would not be against a per-row loop.

The process-global :data:`REGISTRY` is what production code publishes
into; tests scope themselves with :func:`scoped` or call
:meth:`Registry.reset`.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "REGISTRY", "Registry",
           "default_latency_buckets", "scoped"]

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: dict) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def default_latency_buckets() -> Tuple[float, ...]:
    """Log-spaced seconds, 10µs → ~84s at ×2 per bucket: wide enough
    for a device batch and a hung collective in the same histogram,
    with ≤ ×2 relative quantile error."""
    return tuple(1e-5 * (2.0 ** i) for i in range(24))


class Counter:
    """Monotonic counter. ``inc`` only; never reset in production."""

    __slots__ = ("name", "labels", "_lock", "_v")

    kind = "counter"

    def __init__(self, name: str, labels: _LabelKey = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up — use a Gauge")
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    """Point-in-time value (queue depth, failed shards, generation)."""

    __slots__ = ("name", "labels", "_lock", "_v")

    kind = "gauge"

    def __init__(self, name: str, labels: _LabelKey = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Fixed-bucket histogram: ``observe`` lands each sample in the
    first bucket whose upper bound covers it (overflow past the last
    bound goes to a +inf bucket); quantiles interpolate linearly inside
    the landing bucket. Bounds are upper edges, ascending."""

    __slots__ = ("name", "labels", "bounds", "_lock", "_counts", "_sum",
                 "_n")

    kind = "histogram"

    def __init__(self, name: str, labels: _LabelKey = (),
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.labels = labels
        bounds = tuple(buckets) if buckets is not None \
            else default_latency_buckets()
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError("histogram buckets must be ascending")
        self.bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)     # +1: overflow (+inf)
        self._sum = 0.0
        self._n = 0

    def observe(self, v: float) -> None:
        # binary search for the landing bucket (bounds are upper edges)
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self._counts[lo] += 1
            self._sum += v
            self._n += 1

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def bucket_counts(self) -> List[int]:
        with self._lock:
            return list(self._counts)

    def quantile(self, p: float) -> float:
        """Estimated p-quantile (p in [0, 1]); NaN when empty, the last
        finite bound when the quantile lands in the overflow bucket."""
        if not 0.0 <= p <= 1.0:
            raise ValueError("p must be in [0, 1]")
        with self._lock:
            counts, n = list(self._counts), self._n
        if n == 0:
            return float("nan")
        rank = p * n
        seen = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if seen + c >= rank:
                if i >= len(self.bounds):       # overflow bucket
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.bounds[-1]


class Registry:
    """Named get-or-create home for metrics. Lookups of existing
    metrics are a lock-free dict ``get`` (GIL-consistent); creation
    takes the registry lock once per (name, labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[tuple, object] = {}

    def _get_or_create(self, cls, name: str, labels: dict, **kw):
        key = (cls.kind, name, _label_key(labels))
        m = self._metrics.get(key)
        if m is not None:
            return m
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[2], **kw)
                self._metrics[key] = m
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get_or_create(Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        return self._get_or_create(Histogram, name, labels,
                                   buckets=buckets)

    def metrics(self) -> List[object]:
        """All registered metrics, sorted by (name, labels) for stable
        rendering."""
        with self._lock:
            ms = list(self._metrics.values())
        return sorted(ms, key=lambda m: (m.name, m.labels))

    def snapshot(self) -> Dict[str, float]:
        """Flat {rendered-name: value}; histograms contribute ``_count``
        / ``_sum`` / ``_p50`` / ``_p99`` / ``_p999`` entries."""
        out: Dict[str, float] = {}
        for m in self.metrics():
            base = m.name + _render_labels(m.labels)
            if isinstance(m, Histogram):
                out[base + "_count"] = float(m.count)
                out[base + "_sum"] = m.sum
                out[base + "_p50"] = m.quantile(0.50)
                out[base + "_p99"] = m.quantile(0.99)
                out[base + "_p999"] = m.quantile(0.999)
            else:
                out[base] = m.value
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


def _render_labels(labels: _LabelKey) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


REGISTRY = Registry()


class scoped:
    """Swap a fresh registry in for a ``with`` block (tests / benches):
    publications inside the block land in the scoped registry, the
    process-global one is restored on exit."""

    def __init__(self):
        self.registry = Registry()
        self._prev: Optional[Registry] = None

    def __enter__(self) -> Registry:
        global REGISTRY
        self._prev = REGISTRY
        REGISTRY = self.registry
        return self.registry

    def __exit__(self, *exc) -> bool:
        global REGISTRY
        REGISTRY = self._prev
        return False
