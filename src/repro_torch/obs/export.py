"""Export sinks: Prometheus text exposition, JSON snapshot, Chrome
trace events.

A copy of ``repro.obs.export`` with its imports rewritten to the port, which
imports nothing of ``repro``.

All three render the same underlying state (a
:class:`~repro_torch.obs.metrics.MetricsRegistry` and/or a
:class:`~repro_torch.obs.tracing.Tracer`) so one process can serve a
``/metrics`` scrape, embed a snapshot into a ``BENCH_*.json``, and
drop a ``trace.json`` for Perfetto — without three bookkeeping paths.

Chrome trace format notes: each span becomes one complete ("X") event
with ``ts``/``dur`` in microseconds; each logical track (see
:mod:`repro_torch.obs.tracing`) becomes a tid under one pid, named via "M"
(metadata) ``thread_name`` events so Perfetto shows "device" and
"host" as labeled rows.  Open ``trace.json`` at https://ui.perfetto.dev
(or chrome://tracing) — the dispatch/collect pipeline overlap shows up
as device-track spans covering the host-track spans beneath them.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from repro_torch.obs.metrics import Histogram, MetricsRegistry, _LabelKey
from repro_torch.obs.metrics import registry as default_registry
from repro_torch.obs.tracing import Tracer
from repro_torch.obs.tracing import tracer as default_tracer


def _fmt_value(v: float) -> str:
    """Prometheus-style number: integers bare, floats via repr."""
    if v == int(v) and abs(v) < 2**53:
        return str(int(v))
    return repr(v)


def _fmt_labels(key: _LabelKey, extra: Optional[List] = None) -> str:
    pairs = list(key) + (extra or [])
    if not pairs:
        return ""
    inner = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in pairs
    )
    return "{" + inner + "}"


def to_prometheus(reg: Optional[MetricsRegistry] = None) -> str:
    """Render the registry in Prometheus text exposition format 0.0.4
    (``# HELP``/``# TYPE`` headers; histograms as cumulative
    ``_bucket{le=...}`` series plus ``_sum``/``_count``)."""
    reg = reg if reg is not None else default_registry()
    lines: List[str] = []
    for metric in reg.collect():
        if metric.help:
            lines.append(f"# HELP {metric.name} {metric.help}")
        lines.append(f"# TYPE {metric.name} {metric.kind}")
        if isinstance(metric, Histogram):
            for key, st in metric.items():
                cum = 0
                for bound, count in zip(metric.buckets, st.counts):
                    cum += count
                    le = _fmt_labels(key, [("le", _fmt_value(bound))])
                    lines.append(f"{metric.name}_bucket{le} {cum}")
                cum += st.counts[-1]
                le = _fmt_labels(key, [("le", "+Inf")])
                lines.append(f"{metric.name}_bucket{le} {cum}")
                lines.append(f"{metric.name}_sum{_fmt_labels(key)} {repr(st.sum)}")
                lines.append(f"{metric.name}_count{_fmt_labels(key)} {st.count}")
        else:
            for key, value in metric.items():
                lines.append(f"{metric.name}{_fmt_labels(key)} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


def to_json_snapshot(
    reg: Optional[MetricsRegistry] = None, indent: Optional[int] = 2
) -> str:
    """The registry's :meth:`~repro_torch.obs.metrics.MetricsRegistry.snapshot`
    serialized to a JSON string."""
    reg = reg if reg is not None else default_registry()
    return json.dumps(reg.snapshot(), indent=indent, sort_keys=True)


def to_chrome_trace(
    trc: Optional[Tracer] = None,
    process_name: str = "deepmapping",
) -> Dict:
    """Render the tracer's spans as a Chrome trace-event object
    (``{"traceEvents": [...], "displayTimeUnit": "ms"}``).

    Timestamps are rebased so the oldest recorded span starts at 0 µs
    (perf_counter's epoch is arbitrary).  Track → tid assignment is
    first-seen order, with "device" pinned to tid 0 when present so
    the async device row renders above the host rows in Perfetto.
    """
    trc = trc if trc is not None else default_tracer()
    spans = trc.spans()
    events: List[Dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": 1,
            "tid": 0,
            "args": {"name": process_name},
        }
    ]
    if not spans:
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    t0 = min(s.start for s in spans)
    tracks: Dict[str, int] = {}
    if any(s.track == "device" for s in spans):
        tracks["device"] = 0
    for s in spans:
        if s.track not in tracks:
            tracks[s.track] = len(tracks)
    for track, tid in tracks.items():
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {"name": track},
            }
        )
    for s in spans:
        events.append(
            {
                "name": s.name,
                "cat": s.track,
                "ph": "X",
                "pid": 1,
                "tid": tracks[s.track],
                "ts": (s.start - t0) * 1e6,
                "dur": s.duration * 1e6,
                "args": {k: str(v) for k, v in s.args.items()},
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _open_for_write(path: str):
    # Sinks are usually pointed at a fresh --telemetry-dir; create it.
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    return open(path, "w")


def write_prometheus(path: str, reg: Optional[MetricsRegistry] = None) -> str:
    """Write :func:`to_prometheus` output to ``path``; returns the path."""
    with _open_for_write(path) as f:
        f.write(to_prometheus(reg))
    return path


def write_json_snapshot(path: str, reg: Optional[MetricsRegistry] = None) -> str:
    """Write :func:`to_json_snapshot` output to ``path``; returns the path."""
    with _open_for_write(path) as f:
        f.write(to_json_snapshot(reg))
    return path


def write_chrome_trace(path: str, trc: Optional[Tracer] = None) -> str:
    """Write :func:`to_chrome_trace` output (JSON) to ``path``;
    returns the path.  Load it at https://ui.perfetto.dev."""
    with _open_for_write(path) as f:
        json.dump(to_chrome_trace(trc), f)
    return path
