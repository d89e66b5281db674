"""Render a run record (``repro_torch.obs.export.run_record``) as a
report (counterpart of ``repro.obs.report``).

``fmt="markdown"`` emits GitHub-flavored tables; ``fmt="text"`` emits
aligned plain text for terminals without markdown rendering.  Both
share the same row builders so they cannot drift apart.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["render"]


def _fmt_num(v: Any) -> str:
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, int):
        return f"{v:,}"
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1e6 or abs(v) < 1e-3:
            return f"{v:.3e}"
        return f"{v:.4g}"
    return str(v)


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(b) < 1000.0:
            return f"{b:.2f} {unit}"
        b /= 1000.0
    return f"{b:.2f} TB"


def _table(headers: Sequence[str], rows: List[Sequence[str]],
           markdown: bool) -> List[str]:
    if markdown:
        out = ["| " + " | ".join(headers) + " |",
               "|" + "|".join("---" for _ in headers) + "|"]
        out += ["| " + " | ".join(r) + " |" for r in rows]
        return out
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    out = ["  ".join(h.ljust(w) for h, w in zip(headers, widths)),
           "  ".join("-" * w for w in widths)]
    out += ["  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows]
    return out


def _section(title: str, markdown: bool) -> List[str]:
    return [f"## {title}", ""] if markdown else [title, "-" * len(title), ""]


def _span_rows(spans: List[Dict[str, Any]]) -> List[Sequence[str]]:
    rows = []
    for s in sorted(spans, key=lambda s: s.get("start_s", 0.0)):
        indent = "  " * int(s.get("depth", 0))
        meta = s.get("meta") or {}
        rows.append((indent + s.get("name", "?"),
                     f"{s.get('start_s', 0.0):.3f}",
                     f"{s.get('dur_s', 0.0):.3f}",
                     ", ".join(f"{k}={v}" for k, v in meta.items())))
    return rows


def render(record: Dict[str, Any], fmt: str = "markdown") -> str:
    """Render a run-record dict to a markdown or plain-text report."""
    if fmt not in ("markdown", "text"):
        raise ValueError(f"unknown format {fmt!r} (want markdown|text)")
    md = fmt == "markdown"
    name = record.get("name", "run")
    lines: List[str] = []
    lines += [f"# Run report: {name}", ""] if md else \
        [f"Run report: {name}", "=" * (12 + len(str(name))), ""]

    # --- host-plane spans ---------------------------------------------
    spans = record.get("spans") or []
    if spans:
        lines += _section("Spans (host plane)", md)
        lines += _table(("span", "start [s]", "dur [s]", "meta"),
                        _span_rows(spans), md)
        lines.append("")

    hist = record.get("history") or {}

    # --- accuracy / run outcome ---------------------------------------
    if hist:
        rows: List[Sequence[str]] = []
        for key in ("final_server_acc", "final_client_acc"):
            if key in hist:
                v = hist[key]
                # None = that model was never evaluated in this run leg
                # (distinct from a measured 0.0 accuracy)
                rows.append((key, "n/a" if v is None else _fmt_num(v)))
        comm = hist.get("comm") or {}
        if comm:
            rows.append(("rounds", _fmt_num(comm.get("rounds", 0))))
            rows.append(("cumulative comm",
                         _fmt_bytes(float(comm.get("cumulative_total", 0.0)))))
            rows.append(("uplink mean/round",
                         _fmt_bytes(float(comm.get("uplink_mean", 0.0)))))
            rows.append(("downlink mean/round",
                         _fmt_bytes(float(comm.get("downlink_mean", 0.0)))))
        if rows:
            lines += _section("Run outcome", md)
            lines += _table(("metric", "value"), rows, md)
            lines.append("")

    # --- device-plane telemetry ---------------------------------------
    tel = record.get("telemetry") or {}
    summ = tel.get("summary") or {}
    if summ:
        lines += _section("Telemetry (device plane)", md)
        rows = []
        for key in ("rounds", "active_rounds", "participants_total",
                    "cache_hits", "cache_miss_new", "cache_expired",
                    "cache_hit_rate", "catch_up_clients",
                    "teacher_entropy_pre_mean", "teacher_entropy_post_mean",
                    "beta_mean", "beta_last", "codec_quant_error_mean"):
            if key in summ:
                rows.append((key, _fmt_num(summ[key])))
        for key in ("uplink_bytes", "downlink_bytes", "catch_up_bytes"):
            if key in summ:
                rows.append((key, _fmt_bytes(float(summ[key]))))
        lines += _table(("counter", "value"), rows, md)
        lines.append("")
        hist_row = summ.get("staleness_hist")
        if hist_row:
            lines += _section("Participant staleness histogram", md)
            lines += _table(
                tuple(f"{i}" if i < len(hist_row) - 1 else f">={i}"
                      for i in range(len(hist_row))),
                [tuple(_fmt_num(int(x)) for x in hist_row)], md)
            lines += ["", "(rounds since previous participation, over all "
                          "participating client-rounds)", ""]

    if len(lines) <= 3:
        lines += ["(empty record: no spans, history, or telemetry)", ""]
    return "\n".join(lines).rstrip() + "\n"
