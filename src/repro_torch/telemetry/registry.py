"""MetricsRegistry: counters / gauges / streaming histograms.

A copy of the JAX package's ``repro/telemetry/registry.py`` (pure Python;
the port imports nothing of ``repro``).

One registry instance declares a *schema* — every instrument registered
up front — and ``snapshot()`` renders the full schema every time, so the
empty and populated stats paths of a consumer (``ServeEngine.generate``)
are the same dict by construction and can never drift.

Histograms are fixed-log-bucket streaming estimators: observations land
in geometric buckets (×1.12 growth, so worst-case value error ~12%
before the per-bucket (min, max) tightening below), and percentiles are
interpolated with numpy's rank convention (``rank = p/100 * (n-1)``).
Each bucket keeps its observed (count, min, max, sum); interpolating
between a bucket's own min and max — instead of its nominal edges —
makes the estimator exact whenever a bucket holds one distinct value and
exact at the global min/max. For pointwise-dominated series (a_i <= b_i,
e.g. decode-only ITL vs wall ITL) the true order statistics are ordered,
so estimated percentiles respect the order up to one bucket's width —
consumers needing the strict inequality (the serve stats row) clamp it.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

# geometric bucket layout: index i covers [LO * G**i, LO * G**(i+1)).
# LO = 1ns covers sub-microsecond ITLs; buckets are stored sparsely so
# the range costs nothing.
_LO = 1e-9
_G = 1.12
_LOG_G = math.log(_G)


class Counter:
    """Monotone (int) counter; ``set`` exists for snapshot-time fills
    from an external counter dict (scheduler / cache-manager stats)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def set(self, v) -> None:
        self.value = int(v)


class Gauge:
    """Point-in-time float value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: float = 0.0):
        self.name = name
        self.value = float(value)

    def set(self, v) -> None:
        self.value = float(v)


class Histogram:
    """Streaming fixed-bucket histogram with interpolated percentiles.

    ``snapshot()`` emits ``{name}_p{p}{suffix}`` per requested
    percentile (matching the serve stats row's ``ttft_p50_s`` naming).

    >>> h = Histogram("ttft", percentiles=(50, 95))
    >>> for v in (1.0, 2.0, 3.0, 4.0):
    ...     h.observe(v)
    >>> round(h.percentile(50), 6)             # numpy convention: 2.5
    2.5
    >>> h.percentile(0), h.percentile(100)     # exact at the extremes
    (1.0, 4.0)
    """

    __slots__ = ("name", "percentiles", "suffix", "n", "_buckets")

    def __init__(self, name: str, percentiles: Sequence[float] = (50, 95),
                 suffix: str = "_s"):
        self.name = name
        self.percentiles = tuple(percentiles)
        self.suffix = suffix
        self.n = 0
        # bucket index -> [count, min, max, sum]; index None = zero/neg
        self._buckets: Dict[Optional[int], List[float]] = {}

    @staticmethod
    def _index(v: float) -> Optional[int]:
        if v <= 0.0:
            return None                       # zero bucket (sorts first)
        return int(math.floor(math.log(v / _LO) / _LOG_G))

    def observe(self, v: float) -> None:
        v = float(v)
        idx = self._index(v)
        b = self._buckets.get(idx)
        if b is None:
            self._buckets[idx] = [1, v, v, v]
        else:
            b[0] += 1
            b[1] = min(b[1], v)
            b[2] = max(b[2], v)
            b[3] += v
        self.n += 1

    def observe_many(self, vs) -> None:
        for v in vs:
            self.observe(v)

    # -- estimation --------------------------------------------------------
    def _sorted_buckets(self) -> List[Tuple[float, List[float]]]:
        # zero bucket (key None) first, then ascending geometric index
        items = sorted(((k, b) for k, b in self._buckets.items()
                        if k is not None))
        zero = self._buckets.get(None)
        return ([(-1, zero)] if zero else []) + items

    def _value_at(self, k: int, buckets) -> float:
        """Estimated value of the k-th order statistic (0-indexed)."""
        cum = 0
        for _, b in buckets:
            c = int(b[0])
            if k < cum + c:
                if c == 1:
                    return b[1]
                frac = (k - cum) / (c - 1)
                return b[1] + frac * (b[2] - b[1])
            cum += c
        return buckets[-1][1][2]              # pragma: no cover (clamp)

    def percentile(self, p: float) -> float:
        if self.n == 0:
            return 0.0
        buckets = self._sorted_buckets()
        r = (p / 100.0) * (self.n - 1)
        lo, hi = int(math.floor(r)), int(math.ceil(r))
        v_lo = self._value_at(lo, buckets)
        if hi == lo:
            return v_lo
        v_hi = self._value_at(hi, buckets)
        return v_lo + (r - lo) * (v_hi - v_lo)

    @property
    def sum(self) -> float:
        return sum(b[3] for b in self._buckets.values())

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0


class MetricsRegistry:
    """A declared set of instruments; ``snapshot()`` renders them all.

    >>> reg = MetricsRegistry()
    >>> c = reg.counter("new_tokens"); g = reg.gauge("tokens_per_s")
    >>> h = reg.histogram("ttft", percentiles=(50, 95))
    >>> sorted(reg.snapshot())                 # schema exists while empty
    ['new_tokens', 'tokens_per_s', 'ttft_p50_s', 'ttft_p95_s']
    >>> c.inc(3); g.set(1.5); h.observe(0.25)
    >>> reg.snapshot()["new_tokens"]
    3
    """

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        if name not in self._counters:
            self._counters[name] = Counter(name)
        return self._counters[name]

    def gauge(self, name: str, value: float = 0.0) -> Gauge:
        if name not in self._gauges:
            self._gauges[name] = Gauge(name, value)
        return self._gauges[name]

    def histogram(self, name: str, percentiles: Sequence[float] = (50, 95),
                  suffix: str = "_s") -> Histogram:
        if name not in self._histograms:
            self._histograms[name] = Histogram(name, percentiles, suffix)
        return self._histograms[name]

    def fill_counters(self, mapping: Dict[str, float],
                      prefix: str = "") -> None:
        """Set already-declared counters from an external counter dict
        (unknown keys are an error: the schema is declared up front)."""
        for k, v in mapping.items():
            name = prefix + k
            if name not in self._counters:
                raise KeyError(f"counter {name!r} not declared in registry")
            self._counters[name].set(v)

    def snapshot(self) -> Dict[str, float]:
        """Render every declared instrument — identical key set whether
        or not anything was observed."""
        out: Dict[str, float] = {}
        for name, c in self._counters.items():
            out[name] = int(c.value)
        for name, g in self._gauges.items():
            out[name] = float(g.value)
        for name, h in self._histograms.items():
            for p in h.percentiles:
                key = f"{name}_p{p:g}{h.suffix}"
                out[key] = h.percentile(p)
        return out
