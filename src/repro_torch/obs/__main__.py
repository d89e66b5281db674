"""CLI: ``python -m repro_torch.obs <render|validate> ...`` (counterpart
of ``repro.obs.__main__``).

``render RECORD.json [--format markdown|text] [--out PATH]``
    Render a run record (written by ``repro_torch.obs.export``) into a
    human-readable report.

``validate TRACE.json``
    Check an exported Chrome trace is loadable trace-event JSON with
    paired, well-nested B/E events — the CI smoke that keeps the
    exporter honest.  Exit code is nonzero on any violation.

stdlib only: neither subcommand imports torch.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Tuple

from repro_torch.obs import report as report_mod
from repro_torch.obs.export import RUN_RECORD_KIND


def _cmd_render(args) -> int:
    with open(args.record) as f:
        record = json.load(f)
    if record.get("record") != RUN_RECORD_KIND:
        print(f"warning: {args.record} has no "
              f"record={RUN_RECORD_KIND!r} marker; rendering anyway",
              file=sys.stderr)
    text = report_mod.render(record, fmt=args.format)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    else:
        print(text, end="")
    return 0


def validate_trace(trace: Dict[str, Any]) -> List[str]:
    """Violation messages for a parsed Chrome trace (empty = valid)."""
    problems: List[str] = []
    if not isinstance(trace, dict):
        return ["top-level document is not a trace object"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["top-level 'traceEvents' missing or not a list"]
    stacks: Dict[Tuple[Any, Any], List[str]] = {}
    n_spans = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        name = ev.get("name")
        if ph is None or name is None:
            problems.append(f"event {i}: missing 'ph' or 'name'")
            continue
        if ph in ("M", "C", "i", "I"):  # metadata / counters / instants
            continue
        if ph == "X":
            if "dur" not in ev or "ts" not in ev:
                problems.append(f"event {i} ({name}): X event without "
                                "ts/dur")
            continue
        if ph not in ("B", "E"):
            problems.append(f"event {i} ({name}): unsupported phase {ph!r}")
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"event {i} ({name}): missing numeric 'ts'")
            continue
        key = (ev.get("pid", 0), ev.get("tid", 0))
        stack = stacks.setdefault(key, [])
        if ph == "B":
            stack.append(name)
            n_spans += 1
        else:
            if not stack:
                problems.append(f"event {i}: E({name}) with empty stack "
                                f"on pid/tid {key}")
            elif stack[-1] != name:
                problems.append(f"event {i}: E({name}) does not close "
                                f"open span {stack[-1]!r} on pid/tid {key}")
                stack.pop()
            else:
                stack.pop()
    for key, stack in stacks.items():
        if stack:
            problems.append(f"unclosed span(s) on pid/tid {key}: {stack}")
    if not problems and n_spans == 0:
        problems.append("no B/E span events found")
    return problems


def _cmd_validate(args) -> int:
    try:
        with open(args.trace) as f:
            trace = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"INVALID {args.trace}: {e}")
        return 1
    problems = validate_trace(trace)
    if problems:
        print(f"INVALID {args.trace}:")
        for p in problems:
            print(f"  - {p}")
        return 1
    n = len(trace["traceEvents"])
    print(f"ok: {args.trace} ({n} events, paired B/E spans well-nested)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="telemetry run-record renderer and trace validator")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a run record as a report")
    r.add_argument("record", help="run-record JSON path")
    r.add_argument("--format", choices=("markdown", "text"),
                   default="markdown")
    r.add_argument("--out", default=None, help="write instead of print")
    r.set_defaults(fn=_cmd_render)

    v = sub.add_parser("validate",
                       help="check a Chrome trace for paired B/E events")
    v.add_argument("trace", help="trace-event JSON path")
    v.set_defaults(fn=_cmd_validate)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
