"""Unified observability: metrics registry, span tracing, exporters.

A copy of ``repro.obs``: the port imports nothing of ``repro``.  The
inference engine mirrors its ``EngineStats`` into the registry, and the
streaming executor records plan, dispatch and collect spans.

Dependency-free (stdlib only) and imported BY the engine/executor/
serving layers — never the reverse — so it sits at the bottom of the
dependency graph next to :mod:`repro_torch.api.plan`.

Quick tour::

    from repro_torch import obs

    obs.counter("deepmap_executor_morsels_total").inc(kind="scan")
    with obs.span("collect", track="host", morsel=0):
        ...                                  # timed work
    print(obs.to_prometheus())               # /metrics scrape body
    obs.write_chrome_trace("trace.json")     # open in Perfetto

``obs.set_enabled(False)`` flips both the registry and tracer to
no-ops in one call.
"""

from repro_torch.obs.export import (
    to_chrome_trace,
    to_json_snapshot,
    to_prometheus,
    write_chrome_trace,
    write_json_snapshot,
    write_prometheus,
)
from repro_torch.obs.metrics import (
    LATENCY_BUCKETS,
    SIZE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    registry,
    set_registry,
)
from repro_torch.obs.tracing import Span, Tracer, set_tracer, tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS",
    "MetricsRegistry",
    "SIZE_BUCKETS",
    "Span",
    "Tracer",
    "counter",
    "gauge",
    "histogram",
    "registry",
    "set_enabled",
    "set_registry",
    "set_tracer",
    "snapshot",
    "span",
    "to_chrome_trace",
    "to_json_snapshot",
    "to_prometheus",
    "tracer",
    "write_chrome_trace",
    "write_json_snapshot",
    "write_prometheus",
]


def counter(name: str, help: str = "") -> Counter:
    """``registry().counter(...)`` on the current default registry."""
    return registry().counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    """``registry().gauge(...)`` on the current default registry."""
    return registry().gauge(name, help)


def histogram(name: str, help: str = "", buckets=None) -> Histogram:
    """``registry().histogram(...)`` on the current default registry."""
    return registry().histogram(name, help, buckets=buckets)


def span(name: str, track: str = "host", **args):
    """``tracer().span(...)`` on the current default tracer."""
    return tracer().span(name, track=track, **args)


def snapshot() -> dict:
    """JSON-able dump of the current default registry."""
    return registry().snapshot()


def set_enabled(enabled: bool) -> None:
    """Flip BOTH the default registry and default tracer on/off —
    the one-flag kill-switch for overhead measurement."""
    registry().enabled = enabled
    tracer().enabled = enabled
