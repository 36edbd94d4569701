"""Always-on span tracing into a bounded ring buffer.

A copy of ``repro.obs.tracing`` with its imports rewritten to the port, which
imports nothing of ``repro``.

Spans form the plan → morsel → operator hierarchy of the streaming
executor (DESIGN.md §Observability).  Each span is one complete
interval — name, track, start/end on the shared
:func:`time.perf_counter` clock, small ``args`` dict — appended to a
``deque(maxlen=...)`` so memory stays bounded no matter how long a
server runs; old spans fall off the back.

Two recording styles:

* ``with tracer.span("collect", track="host", morsel=3):`` — timed by
  the context manager.  This is the common case for host-side work.
* ``tracer.add_span("infer_dispatch", t0, t1, track="device", ...)`` —
  explicitly-timed.  The executor uses this for device-window spans,
  which are only *known* retroactively: the dispatch span for morsel
  *i* spans [dispatch(i) → collect-start(i)], and collect-start only
  happens after morsel *i+1* was dispatched.  Recording them
  retroactively is what makes the overlap show up as overlapping
  tracks in the Chrome trace instead of nested ones.

Tracks are logical timelines ("host", "device"), not OS threads: the
executor's dispatch/collect both run on one Python thread, but the
device work they bracket proceeds asynchronously, so it gets its own
track.  The Chrome exporter maps each track to a tid with a
thread_name metadata event.

``tracer.enabled = False`` turns :meth:`Tracer.span` into a shared
no-op context manager and :meth:`add_span` into an early return — the
same kill-switch discipline as the metrics registry.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

#: Default ring capacity — at 8 spans per morsel this holds ~4k
#: morsels of history, a few hundred bytes each.
DEFAULT_CAPACITY = 32768


@dataclass
class Span:
    """One completed interval on a logical track."""

    name: str
    track: str
    start: float  # perf_counter seconds
    end: float
    args: Dict[str, object] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start


class _SpanContext:
    """Context manager handed out by :meth:`Tracer.span`; records the
    span on exit (even when the body raises, so traces show the work
    that was attempted)."""

    __slots__ = ("_tracer", "_name", "_track", "_args", "_start")

    def __init__(self, tracer: "Tracer", name: str, track: str, args: Dict):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._args = args
        self._start = 0.0

    def __enter__(self) -> "_SpanContext":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._tracer.add_span(
            self._name, self._start, time.perf_counter(), self._track, **self._args
        )


@contextlib.contextmanager
def _noop_span() -> Iterator[None]:
    yield None


class Tracer:
    """Bounded span recorder (thread-safe append, snapshot reads)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, enabled: bool = True):
        self.enabled = enabled
        self.capacity = capacity
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)  # guarded-by: _lock

    def span(self, name: str, track: str = "host", **args):
        """Context manager timing one span; ``args`` become trace-event
        args (keep them small and low-cardinality)."""
        if not self.enabled:
            return _noop_span()
        return _SpanContext(self, name, track, args)

    def add_span(
        self, name: str, start: float, end: float, track: str = "host", **args
    ) -> None:
        """Record an explicitly-timed span (perf_counter endpoints)."""
        if not self.enabled:
            return
        # clamp negative durations (clock skew between explicit endpoints)
        span = Span(name=name, track=track, start=start, end=max(start, end), args=args)
        with self._lock:
            self._spans.append(span)

    def spans(self, name: Optional[str] = None, track: Optional[str] = None) -> List[Span]:
        """Snapshot of recorded spans, oldest first, optionally
        filtered by exact name and/or track."""
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        if track is not None:
            out = [s for s in out if s.track == track]
        return out

    def clear(self) -> None:
        """Drop all recorded spans (capacity unchanged)."""
        with self._lock:
            self._spans.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


# ------------------------------------------------------------ default tracer
_default_tracer = Tracer()
_default_lock = threading.Lock()


def tracer() -> Tracer:
    """The process-global default tracer (resolved at call time)."""
    return _default_tracer


def set_tracer(t: Tracer) -> Tracer:
    """Install ``t`` as the process default; returns the previous one."""
    global _default_tracer
    with _default_lock:
        prev = _default_tracer
        _default_tracer = t
    return prev
