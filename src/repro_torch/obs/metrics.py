"""Thread-safe metrics registry: labeled counters, gauges, and
log-bucketed histograms (the Prometheus data model, stdlib-only).

A copy of ``repro.obs.metrics``: the port imports nothing of ``repro``.
The inference engine mirrors its counters into ONE registry at chunk
granularity (never per key).  ``registry().enabled = False`` (or
:func:`repro_torch.obs.set_enabled`) turns every mutation into an
early return.

Metric families are get-or-create by name (:meth:`MetricsRegistry.counter`
etc. return the existing family on repeat calls), and label values are
passed as kwargs at increment time::

    reg = metrics.registry()
    reg.counter("deepmap_executor_morsels_total").inc(kind="scan")
    reg.histogram("deepmap_executor_plan_seconds").observe(0.012, kind="scan")

There is a process-global default registry (:func:`registry`) plus
injectable instances (:func:`set_registry` swaps the default; tests
install a fresh one for isolation).
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

#: Default histogram bucket upper bounds: powers of two from ~1 µs to
#: 64 s.  Log-spaced so one bucket layout covers µs-scale operator
#: stages and second-scale plans; quantiles interpolate geometrically
#: within a bucket.
LATENCY_BUCKETS: Tuple[float, ...] = tuple(2.0**e for e in range(-20, 7))

#: Bucket layout for size-like observations (rows per morsel, keys per
#: merged batch): powers of two from 1 to 2^24.
SIZE_BUCKETS: Tuple[float, ...] = tuple(2.0**e for e in range(0, 25))

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> _LabelKey:
    """Canonical (sorted) hashable form of a label kwarg set."""
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    """Base metric family: one name, one kind, many label children."""

    kind = "untyped"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name = name
        self.help = help
        self._registry = registry
        self._lock = threading.Lock()
        self._values: Dict[_LabelKey, float] = {}  # guarded-by: _lock

    # ------------------------------------------------------------- reading
    def value(self, **labels) -> float:
        """Current value for one label set (0.0 if never touched)."""
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def items(self) -> List[Tuple[_LabelKey, float]]:
        """Stable snapshot of ``(label_key, value)`` pairs."""
        with self._lock:
            return sorted(self._values.items())


class Counter(_Metric):
    """Monotonically increasing counter (negative increments raise)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        """Add ``amount`` (default 1) to the labeled child."""
        if not self._registry.enabled:
            return
        if amount < 0:
            raise ValueError(f"counter {self.name} increment must be >= 0")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(_Metric):
    """Point-in-time value (queue depth, in-flight morsels)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        """Set the labeled child to ``value``."""
        if not self._registry.enabled:
            return
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        """Add ``amount`` (may be negative) to the labeled child."""
        if not self._registry.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        """Subtract ``amount`` from the labeled child."""
        self.inc(-amount, **labels)


class _HistState:
    """One label child's histogram state: bucket counts + sum + count."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self, nbuckets: int):
        self.counts = [0] * (nbuckets + 1)  # +1 = +Inf overflow bucket
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Log-bucketed histogram with p50/p99 estimation.

    Buckets are fixed at construction (default
    :data:`LATENCY_BUCKETS`); an observation lands in the first bucket
    whose upper bound is >= the value, values beyond the last bound go
    to +Inf.  :meth:`quantile` interpolates geometrically inside the
    winning bucket — exact enough for the p50/p99 evidence the
    benchmarks record, at O(buckets) memory forever.
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        registry: "MetricsRegistry",
        buckets: Optional[Sequence[float]] = None,
    ):
        super().__init__(name, help, registry)
        bounds = tuple(buckets) if buckets is not None else LATENCY_BUCKETS
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram {name} buckets must be ascending")
        self.buckets = bounds
        self._states: Dict[_LabelKey, _HistState] = {}  # guarded-by: _lock

    def observe(self, value: float, **labels) -> None:
        """Record one observation into the labeled child."""
        if not self._registry.enabled:
            return
        key = _label_key(labels)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            state = self._states.get(key)
            if state is None:
                state = self._states[key] = _HistState(len(self.buckets))
            state.counts[idx] += 1
            state.sum += value
            state.count += 1

    # ------------------------------------------------------------- reading
    def state(self, **labels) -> Optional[_HistState]:
        """The labeled child's state, or None if never observed."""
        with self._lock:
            return self._states.get(_label_key(labels))

    def value(self, **labels) -> float:
        """Observation count for the labeled child (counter parity)."""
        s = self.state(**labels)
        return float(s.count) if s is not None else 0.0

    def items(self) -> List[Tuple[_LabelKey, _HistState]]:
        """Stable snapshot of ``(label_key, state)`` pairs."""
        with self._lock:
            return sorted(self._states.items(), key=lambda kv: kv[0])

    def quantile(self, q: float, **labels) -> float:
        """Estimated ``q``-quantile (0..1) via geometric interpolation
        within the winning log bucket; 0.0 with no observations."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        state = self.state(**labels)
        if state is None or state.count == 0:
            return 0.0
        rank = q * state.count
        seen = 0.0
        for i, c in enumerate(state.counts):
            seen += c
            if seen >= rank and c:
                if i >= len(self.buckets):  # +Inf bucket: no upper bound
                    return self.buckets[-1]
                hi = self.buckets[i]
                lo = self.buckets[i - 1] if i else hi / 2.0
                frac = (rank - (seen - c)) / c
                return lo * math.exp(frac * math.log(hi / lo))
        return self.buckets[-1]


class MetricsRegistry:
    """Named metric families behind one lock, one ``enabled`` switch.

    Families are get-or-create: asking for an existing name returns
    the existing family (a kind mismatch raises — two layers must not
    silently write one name with different types).  ``snapshot()``
    produces the JSON-able view the benchmarks embed into
    ``BENCH_*.json``; the Prometheus/Chrome exporters live in
    :mod:`repro_torch.obs.export`.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}  # guarded-by: _lock

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = cls(name, help, self, **kwargs)
            elif not isinstance(metric, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {metric.kind}, "
                    f"requested {cls.kind}"
                )
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        """Get-or-create a :class:`Counter` family."""
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        """Get-or-create a :class:`Gauge` family."""
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets: Optional[Sequence[float]] = None
    ) -> Histogram:
        """Get-or-create a :class:`Histogram` family (``buckets`` only
        applies at creation; later calls reuse the existing layout)."""
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def collect(self) -> List[_Metric]:
        """All families, name-sorted (the exporters' iteration order)."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def get(self, name: str) -> Optional[_Metric]:
        """Look up a family by exact name (None if absent)."""
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> Dict:
        """JSON-able dump of every family.

        Counters/gauges: ``{"kind", "help", "values": [{"labels",
        "value"}]}``.  Histograms additionally carry per-child bucket
        counts, sum, count, and estimated p50/p99 — the benchmark
        evidence format.
        """
        out: Dict = {}
        for metric in self.collect():
            fam: Dict = {"kind": metric.kind, "help": metric.help}
            if isinstance(metric, Histogram):
                fam["buckets"] = list(metric.buckets)
                fam["values"] = [
                    {
                        "labels": dict(key),
                        "count": st.count,
                        "sum": st.sum,
                        "bucket_counts": list(st.counts),
                        "p50": metric.quantile(0.5, **dict(key)),
                        "p99": metric.quantile(0.99, **dict(key)),
                    }
                    for key, st in metric.items()
                ]
            else:
                fam["values"] = [
                    {"labels": dict(key), "value": v} for key, v in metric.items()
                ]
            out[metric.name] = fam
        return out


# ----------------------------------------------------------- default registry
_default_registry = MetricsRegistry()
_default_lock = threading.Lock()


def registry() -> MetricsRegistry:
    """The process-global default registry (every built-in mirror
    resolves it at call time, so :func:`set_registry` swaps take effect
    immediately)."""
    return _default_registry


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Install ``reg`` as the process default; returns the previous
    one (tests install a fresh registry and restore on teardown)."""
    global _default_registry
    with _default_lock:
        prev = _default_registry
        _default_registry = reg
    return prev
