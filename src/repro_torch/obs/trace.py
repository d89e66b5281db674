"""Host-plane tracing: monotonic clocks and a span tracer (counterpart of
``repro.obs.trace``).

Pure stdlib: importing this module never imports torch, so a launch
script can route its timing through :func:`now` before it touches the
card.  The opt-in :func:`profiler_trace` hook imports ``torch.profiler``
lazily, and only when given a log directory.

Spans are recorded as a well-nested B/E event sequence *by
construction*: ``span()`` pushes the begin event on entry and the end
event on exit, so the exported Chrome trace (Perfetto's legacy JSON
format) is always valid regardless of clock granularity — the
``python -m repro_torch.obs validate`` check replays exactly this stack
discipline.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["now", "Span", "SpanTracer", "profiler_trace", "PROFILE_TRACE"]

# file name of the Chrome trace profiler_trace writes under its logdir
PROFILE_TRACE = "profile_trace.json"


def now() -> float:
    """Monotonic seconds for duration measurement.

    ``time.perf_counter()`` — unlike ``time.time()`` it never jumps on
    NTP adjustment or DST, so durations cannot go negative.  The epoch
    is arbitrary: only differences are meaningful.
    """
    return time.perf_counter()


@dataclass
class Span:
    """One completed (or still-open) span, relative to the tracer t0."""
    name: str
    start_s: float
    dur_s: float
    depth: int
    meta: Dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "start_s": self.start_s,
                "dur_s": self.dur_s, "depth": self.depth,
                "meta": self.meta}


class SpanTracer:
    """Nestable wall-clock spans with Chrome-trace / JSONL export.

    >>> tr = SpanTracer("demo")
    >>> with tr.span("compile", engine="scan"):
    ...     with tr.span("lower"):
    ...         pass
    >>> trace = tr.chrome_trace()   # load in ui.perfetto.dev

    All clocks are :func:`now` (monotonic); timestamps in the exported
    trace are microseconds relative to tracer construction.
    """

    def __init__(self, name: str = "run",
                 meta: Optional[Dict[str, Any]] = None):
        self.name = name
        self.meta = dict(meta or {})
        self.t0 = now()
        self.spans: List[Span] = []
        self._events: List[Dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": f"repro_torch.obs:{name}"}},
        ]
        self._depth = 0

    # -- recording ------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **meta: Any) -> Iterator[Span]:
        """Context manager: times the enclosed block as one span."""
        start = now()
        rel = start - self.t0
        self._events.append(self._event(name, "B", rel, meta))
        self._depth += 1
        sp = Span(name, rel, 0.0, self._depth - 1, dict(meta))
        try:
            yield sp
        finally:
            self._depth -= 1
            sp.dur_s = now() - start
            self._events.append(self._event(name, "E", rel + sp.dur_s, {}))
            self.spans.append(sp)

    def record(self, name: str, start_s: float, dur_s: float,
               **meta: Any) -> Span:
        """Record an already-measured interval (``start_s`` in the
        :func:`now` clock) as a top-level span."""
        rel = start_s - self.t0
        self._events.append(self._event(name, "B", rel, meta))
        self._events.append(self._event(name, "E", rel + dur_s, {}))
        sp = Span(name, rel, dur_s, 0, dict(meta))
        self.spans.append(sp)
        return sp

    def _event(self, name: str, ph: str, rel_s: float,
               meta: Dict[str, Any]) -> Dict[str, Any]:
        ev = {"name": name, "ph": ph, "ts": rel_s * 1e6, "pid": 0, "tid": 0}
        if meta:
            ev["args"] = {k: _jsonable(v) for k, v in meta.items()}
        return ev

    # -- export views ---------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """Trace-event JSON (Chrome ``about:tracing`` / Perfetto)."""
        return {"traceEvents": list(self._events),
                "displayTimeUnit": "ms",
                "otherData": {"tracer": self.name,
                              **{k: _jsonable(v)
                                 for k, v in self.meta.items()}}}

    def jsonl_lines(self) -> List[Dict[str, Any]]:
        """One dict per completed span (newline-delimited export)."""
        return [s.as_dict() for s in self.spans]

    def total_s(self) -> float:
        return now() - self.t0


def _jsonable(v: Any) -> Any:
    return v if isinstance(v, (int, float, bool, str, type(None))) else str(v)


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str] = None) -> Iterator[None]:
    """Opt-in ``torch.profiler.profile`` wrapper (the reference's
    ``jax.profiler.trace``).

    A falsy ``logdir`` is a no-op (and keeps torch out of the import
    graph entirely); otherwise the enclosed block is profiled and its
    Chrome trace written to ``<logdir>/PROFILE_TRACE`` on exit.  Where a
    CUDA device is present the card's activity is recorded too, and a
    profiler that cannot record it raises rather than writing a trace
    without the device.
    """
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("profiler_trace: a CUDA device is present but this "
                               "torch.profiler cannot record CUDA activity")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(logdir), exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(str(logdir), PROFILE_TRACE))
