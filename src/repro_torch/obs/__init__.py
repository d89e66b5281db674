"""Run telemetry: device-resident round metrics + host-plane tracing
(counterpart of ``repro.obs``).

Two planes, deliberately separate:

- **Device plane** (:mod:`repro_torch.obs.device`): the ``RoundTelemetry``
  row the FL engines compute *inside* the round body — cache hit/miss
  census, participation and staleness counters, payload bytes,
  teacher-entropy and sharpening gauges.  Opt-in via
  ``FLConfig.telemetry`` / ``run_method(telemetry=...)``; on the device
  engine the rows stay on the card and come back with the leg's one
  read-back.
- **Host plane** (:mod:`repro_torch.obs.trace` / ``export`` / ``report``):
  monotonic span tracing around setup/run/eval blocks, Chrome-trace
  (Perfetto) + JSONL exporters, run records, the ``torch.profiler`` hook
  and the ``python -m repro_torch.obs`` renderer/validator.

Importing ``repro_torch.obs`` (or ``repro_torch.obs.trace``) never
imports torch; the device-plane names are re-exported lazily.
"""
from __future__ import annotations

from typing import Any

from repro_torch.obs.trace import Span, SpanTracer, now, profiler_trace

__all__ = [
    "now", "Span", "SpanTracer", "profiler_trace",
    # lazy (torch-importing) device-plane names
    "RoundTelemetry", "TelemetryLog",
]

_DEVICE_NAMES = ("RoundTelemetry", "TelemetryLog")


def __getattr__(name: str) -> Any:
    if name in _DEVICE_NAMES:
        from repro_torch.obs import device

        return getattr(device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
