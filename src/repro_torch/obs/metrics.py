"""Process-wide metrics registry: counters, gauges, fixed-bucket
histograms.

All metrics are plain host-side Python objects — observing one is a
dict lookup plus a few float ops, never a device sync, so the round hot
path can mirror its telemetry here without breaking the trainers'
host-sync contract.

Percentiles are estimated from fixed buckets (log-spaced 1-2.5-5 per
decade by default): ``percentile(q)`` returns the upper edge of the
bucket holding the q-quantile rank, clamped to the observed [min, max].
The estimate is exact to within one bucket granule (<= 2.5x), which is
what regression gating on phase times needs — not a t-digest.
"""
from __future__ import annotations

import math
from bisect import bisect_left
from typing import Dict, Optional, Sequence

# log-spaced seconds: 1 us .. 500 s (1 / 2.5 / 5 per decade)
TIME_BUCKETS = tuple(round(10.0 ** e * m, 12)
                     for e in range(-6, 3) for m in (1.0, 2.5, 5.0))
# small-integer counts: scheduler iterations, device tallies, ...
COUNT_BUCKETS = (1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
                 10_000, 100_000, 1_000_000)


class Counter:
    """Monotone accumulator (float increments allowed — e.g. seconds)."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        self.value += amount

    def reset(self) -> None:
        self.value = 0.0


class Gauge:
    """Last-write-wins scalar."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = math.nan

    def set(self, value: float) -> None:
        self.value = float(value)

    def reset(self) -> None:
        self.value = math.nan


class Histogram:
    """Fixed-bucket histogram with running count/sum/min/max."""
    __slots__ = ("name", "buckets", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str, buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.buckets = tuple(sorted(buckets)) if buckets else TIME_BUCKETS
        self.counts = [0] * (len(self.buckets) + 1)
        self.reset()

    def reset(self) -> None:
        for i in range(len(self.counts)):
            self.counts[i] = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        self.counts[bisect_left(self.buckets, value)] += 1
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def percentile(self, q: float) -> float:
        """Upper bucket edge at quantile ``q`` in [0, 1], clamped to the
        observed [min, max] (exact for q=0/q=1)."""
        if not self.count:
            return math.nan
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if q == 0.0:
            return self.min
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target and c:
                edge = (self.buckets[i] if i < len(self.buckets)
                        else self.max)
                return min(max(edge, self.min), self.max)
        return self.max


class Registry:
    """Name -> metric, get-or-create.  One registry per ``Obs`` facade;
    ``repro_torch.obs.DEFAULT`` carries the process-wide instance."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, buckets)
        return h

    @property
    def counters(self) -> Dict[str, Counter]:
        return dict(self._counters)

    @property
    def gauges(self) -> Dict[str, Gauge]:
        return dict(self._gauges)

    @property
    def histograms(self) -> Dict[str, Histogram]:
        return dict(self._histograms)

    def reset(self) -> None:
        """Zero every metric in place (object identities survive, so
        held references stay valid — e.g. steady-state benchmarking
        resets after warmup)."""
        for m in (*self._counters.values(), *self._gauges.values(),
                  *self._histograms.values()):
            m.reset()

    def snapshot(self) -> Dict:
        """Plain-data view of every metric (JSON-serializable)."""
        return {
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: g.value for k, g in self._gauges.items()},
            "histograms": {
                k: {"count": h.count, "sum": h.sum, "mean": h.mean,
                    "min": h.min if h.count else math.nan,
                    "max": h.max if h.count else math.nan,
                    "p50": h.percentile(0.5), "p95": h.percentile(0.95),
                    "p99": h.percentile(0.99)}
                for k, h in self._histograms.items()},
        }
