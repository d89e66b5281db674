"""Exporters: Chrome traces, span JSONL, and self-contained run records
(counterpart of ``repro.obs.export``).

A *run record* is the single JSON artifact ``python -m repro_torch.obs
render`` consumes: run metadata + the
:class:`~repro_torch.fl.rounds.History` dict + the telemetry log + the
host-plane spans.  The record's schema and its ``record`` marker are the
reference's, so either package's CLI renders the other's records.
Everything here is stdlib-only; inputs are plain dicts or the obs-layer
objects (duck-typed via ``as_dict`` / ``summary``), never engine types.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

__all__ = ["write_chrome_trace", "write_spans_jsonl", "run_record",
           "write_run_record", "telemetry_summary"]

RUN_RECORD_KIND = "repro.obs/run"


def _ensure_dir(path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)


def _as_dict(obj: Any) -> Optional[Dict[str, Any]]:
    if obj is None or isinstance(obj, dict):
        return obj
    return obj.as_dict()


def write_chrome_trace(path: str, tracer) -> str:
    """Write the tracer's trace-event JSON (Perfetto-loadable)."""
    _ensure_dir(path)
    with open(path, "w") as f:
        json.dump(tracer.chrome_trace(), f)
        f.write("\n")
    return path


def write_spans_jsonl(path: str, tracer) -> str:
    """One JSON object per completed span, newline-delimited."""
    _ensure_dir(path)
    with open(path, "w") as f:
        for line in tracer.jsonl_lines():
            f.write(json.dumps(line) + "\n")
    return path


def run_record(*, name: str, config: Any = None,
               history: Any = None, telemetry: Any = None,
               tracer=None, extra: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """Assemble the run-record dict (see module docstring)."""
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        config = dataclasses.asdict(config)
    if telemetry is None:  # default to the history's own telemetry log
        telemetry = (history.get("telemetry") if isinstance(history, dict)
                     else getattr(history, "telemetry", None))
    rec: Dict[str, Any] = {
        "record": RUN_RECORD_KIND,
        "schema": 1,
        "name": name,
        "config": config,
        "history": _as_dict(history),
        "telemetry": _as_dict(telemetry),
        "spans": tracer.jsonl_lines() if tracer is not None else [],
    }
    if extra:
        rec.update(extra)
    return rec


def write_run_record(path: str, **kwargs: Any) -> Dict[str, Any]:
    """Build with :func:`run_record` and write it; returns the record."""
    rec = run_record(**kwargs)
    _ensure_dir(path)
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, sort_keys=True)
        f.write("\n")
    return rec


def telemetry_summary(history) -> Optional[Dict[str, Any]]:
    """The telemetry summary dict off a History (or None) — the shape
    ``benchmarks._common.write_bench`` embeds in ``BENCH_*.json``."""
    tel = getattr(history, "telemetry", None)
    if tel is None:
        return None
    return tel.summary()
