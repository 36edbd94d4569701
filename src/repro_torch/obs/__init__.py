"""Observability for the port: the stdlib metrics registry.

A copy of the registry half of ``repro.obs`` (tracing and the
exporters come with a later slice).  The inference engine mirrors its
``EngineStats`` into it::

    from repro_torch import obs

    obs.counter("deepmap_engine_events_total").value(event="fused_calls")
"""

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

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS",
    "MetricsRegistry",
    "SIZE_BUCKETS",
    "counter",
    "registry",
    "set_enabled",
    "set_registry",
]


def counter(name: str, help: str = "") -> Counter:
    """``registry().counter(...)`` on the current default registry."""
    return registry().counter(name, help)


def set_enabled(enabled: bool) -> None:
    """Turn the default registry on or off."""
    registry().enabled = enabled
