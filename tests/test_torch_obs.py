"""``repro_torch.obs`` against ``repro.obs``, on the CPU.

Device plane: each helper of ``repro_torch.obs.device`` against the
reference's on the same seeded numpy inputs.  Counters are int32 and
equal; gauges (participant means, entropies, codec error: float32 sums in
other orders) agree to atol 1e-6.  ``TelemetryLog`` over the same rows
gives the reference's ``stacks()``, ``summary()`` and ``as_dict()``.

Host plane: the reference's ``tests/test_obs.py`` cases on the port (span
nesting, ``record``, ``validate_trace``, exporters, ``render``, the CLI),
one run record rendered by both packages to the same text byte for byte,
and ``profiler_trace``.
"""
import json
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import device as rdev
from repro.obs import export as rexport
from repro.obs import report as rreport
from repro.obs.trace import SpanTracer as RSpanTracer
from repro_torch.obs import SpanTracer, profiler_trace
from repro_torch.obs import device as obs_device
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.__main__ import main as obs_main
from repro_torch.obs.__main__ import validate_trace
from repro_torch.obs.device import RoundTelemetry, TelemetryLog
from repro_torch.obs.export import (
    run_record,
    telemetry_summary,
    write_chrome_trace,
    write_run_record,
    write_spans_jsonl,
)
from repro_torch.obs.report import render

GAUGE_ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _equal(port, ref):
    """A port tensor equals a reference array, dtype included."""
    got, want = port.numpy(), np.asarray(ref)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# device plane against the reference, seeded inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cache_signal_counts_match_reference(seed):
    rng = np.random.default_rng(seed)
    present, miss = rng.random(40) < 0.5, rng.random(40) < 0.6
    got = obs_device.cache_signal_counts(_t(present), _t(miss))
    want = rdev.cache_signal_counts(jnp.asarray(present), jnp.asarray(miss))
    for g, w in zip(got, want):
        _equal(g, w)
    assert sum(int(g) for g in got) == 40


def test_cache_off_counts_every_request_new():
    got = obs_device.cache_signal_counts(torch.zeros(5, dtype=torch.bool),
                                         torch.ones(5, dtype=torch.bool))
    assert [int(g) for g in got] == [0, 5, 0]
    want = rdev.cache_signal_counts(jnp.zeros(5, bool), jnp.ones(5, bool))
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("seed,t", [(0, 5), (1, 12), (2, 1), (3, 40)])
def test_staleness_and_returning_clients_match_reference(seed, t):
    rng = np.random.default_rng(seed)
    K = 30
    part = rng.random(K) < 0.6
    # last_sync anywhere from "never" (0) to the previous round; -1 too,
    # which with t = 40 lands past the top bucket
    last_sync = rng.integers(-1, t, K).astype(np.int32)
    _equal(obs_device.staleness_histogram(_t(part), _t(last_sync), t),
           rdev.staleness_histogram(jnp.asarray(part), jnp.asarray(last_sync), t))
    _equal(obs_device.returning_client_count(_t(part), _t(last_sync), t),
           rdev.returning_client_count(jnp.asarray(part), jnp.asarray(last_sync), t))


def test_staleness_histogram_clips_top_bucket():
    hist = obs_device.staleness_histogram(torch.tensor([True]), torch.tensor([-1]), 100)
    assert hist[obs_device.STALENESS_BUCKETS - 1] == 1 and int(hist.sum()) == 1
    # hand-computed (the reference's case): t=5, last_sync 4 -> 0, 0 -> 4, 2 -> 2
    part = torch.tensor([True, True, True, False])
    ls = torch.tensor([4, 0, 2, 4], dtype=torch.int32)
    want = np.zeros(obs_device.STALENESS_BUCKETS, np.int32)
    want[[0, 4, 2]] = 1
    np.testing.assert_array_equal(obs_device.staleness_histogram(part, ls, 5).numpy(), want)
    assert int(obs_device.returning_client_count(part, ls, 5)) == 2


@pytest.mark.parametrize("offsets,sizes", [((0,), (9,)), ((0, 2, 5), (2, 3, 4))])
def test_participants_per_cohort_match_reference(offsets, sizes):
    part = np.random.default_rng(7).random(9) < 0.5
    _equal(obs_device.participants_per_cohort(_t(part), offsets, sizes),
           rdev.participants_per_cohort(jnp.asarray(part), offsets, sizes))


@pytest.mark.parametrize("seed", [0, 1])
def test_participant_mean_entropy_and_codec_error_match_reference(seed):
    rng = np.random.default_rng(seed)
    K, m, N = 7, 13, 5
    z = rng.dirichlet(np.ones(N), size=(K, m)).astype(np.float32)
    z_post = (z + rng.normal(0, 2e-3, z.shape)).astype(np.float32)
    part = (rng.random(K) < 0.6).astype(np.float32)
    n_part = np.float32(part.sum())
    for got, want in [
            (obs_device.participant_mean(_t(z), _t(part), _t(n_part)),
             rdev.participant_mean(z, part, n_part)),
            (obs_device.mean_entropy(_t(z[0])), rdev.mean_entropy(z[0])),
            (obs_device.codec_error_mean(_t(z_post), _t(z), _t(part), _t(n_part)),
             rdev.codec_error_mean(z_post, z, part, n_part))]:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=GAUGE_ATOL)
    # a count given as a host number, and no participant at all
    np.testing.assert_allclose(
        obs_device.participant_mean(_t(z), _t(part), int(n_part)).numpy(),
        np.asarray(rdev.participant_mean(z, part, int(n_part))), rtol=0, atol=GAUGE_ATOL)
    assert not obs_device.participant_mean(_t(z), torch.zeros(K), 0).any()
    assert float(obs_device.codec_error_mean(_t(z_post), _t(z), torch.zeros(K), 0)) == 0.0


def test_hand_computed_gauges():
    z = torch.tensor([[[1.0, 0.0]], [[0.0, 1.0]], [[0.5, 0.5]]])
    zbar = obs_device.participant_mean(z, torch.tensor([1.0, 0.0, 1.0]), 2)
    assert torch.allclose(zbar, torch.tensor([[0.75, 0.25]]))
    assert float(obs_device.mean_entropy(torch.full((3, 4), 0.25))) == pytest.approx(
        math.log(4.0), abs=1e-6)
    err = obs_device.codec_error_mean(torch.tensor([[[0.25, 0.75]], [[9.0, 9.0]]]),
                                      torch.tensor([[[0.5, 0.5]], [[1.0, 0.0]]]),
                                      torch.tensor([1.0, 0.0]), 1)
    assert float(err) == pytest.approx(0.25, abs=1e-6)


def test_zeros_gate_and_accumulate():
    z = obs_device.zeros(2)
    rz = rdev.zeros(2)
    for a, b in zip(z, rz):
        _equal(a, b)
    row = z._replace(cache_hits=torch.tensor(3, dtype=torch.int32),
                     uplink_bytes=torch.tensor(10.0))
    gated = obs_device.gate(row, torch.tensor(False))
    assert int(gated.cache_hits) == 0 and float(gated.uplink_bytes) == 0.0
    assert gated.cache_hits.dtype == torch.int32
    assert int(obs_device.gate(row, torch.tensor(True)).cache_hits) == 3
    total = obs_device.accumulate(obs_device.accumulate(obs_device.zeros(2), row), row)
    assert int(total.cache_hits) == 6 and float(total.uplink_bytes) == 20.0
    assert [a.dtype for a in total] == [a.dtype for a in z]


def test_field_partition_is_the_references():
    assert RoundTelemetry._fields == rdev.RoundTelemetry._fields
    assert obs_device.EXACT_FIELDS == rdev.EXACT_FIELDS
    assert obs_device.GAUGE_FIELDS == rdev.GAUGE_FIELDS
    assert (set(obs_device.EXACT_FIELDS) | set(obs_device.GAUGE_FIELDS)
            == set(RoundTelemetry._fields))
    assert not set(obs_device.EXACT_FIELDS) & set(obs_device.GAUGE_FIELDS)
    assert obs_device.STALENESS_BUCKETS == rdev.STALENESS_BUCKETS


# ---------------------------------------------------------------------------
# TelemetryLog against the reference's
# ---------------------------------------------------------------------------

def _rows(seed, T=5, n_coh=2):
    """T seeded numpy rows in the reference's dtypes, an outage row among
    them."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(T):
        i32 = lambda *s: rng.integers(0, 50, s).astype(np.int32)  # noqa: E731
        f32 = lambda: np.float32(rng.random() * 1e4)  # noqa: E731
        row = RoundTelemetry(i32(n_coh), i32(), i32(), i32(), i32(), i32(8), f32(), f32(),
                             f32(), f32(), f32(), f32(), f32())
        if i == 2:
            row = RoundTelemetry(*(np.zeros_like(a) for a in row))
        rows.append(row)
    return rows


def test_telemetry_log_matches_reference():
    rows = _rows(3)
    port = TelemetryLog([RoundTelemetry(*(_t(a) for a in r)) for r in rows])
    ref = rdev.TelemetryLog([rdev.RoundTelemetry(*r) for r in rows])
    ps, rs = port.stacks(), ref.stacks()
    for f in rs:
        assert ps[f].dtype == rs[f].dtype
        np.testing.assert_array_equal(ps[f], rs[f])
    assert port.summary() == ref.summary()
    assert port.summary()["active_rounds"] == 4
    assert json.dumps(port.as_dict(), sort_keys=True) == json.dumps(ref.as_dict(), sort_keys=True)
    for a, b in zip(port.totals(), ref.totals()):
        np.testing.assert_array_equal(a, b)
    # from_stacked of the stacks reproduces the log
    again = TelemetryLog.from_stacked(RoundTelemetry(*(_t(ps[f]) for f in RoundTelemetry._fields)))
    assert again.as_dict() == port.as_dict()
    assert TelemetryLog().summary() == {"rounds": 0} == rdev.TelemetryLog().summary()


def test_telemetry_log_hand_computed_summary():
    log = TelemetryLog()
    log.append(obs_device.zeros(1)._replace(
        participants=torch.tensor([2], dtype=torch.int32),
        cache_hits=torch.tensor(3, dtype=torch.int32),
        cache_miss_new=torch.tensor(7, dtype=torch.int32),
        uplink_bytes=torch.tensor(100.0), beta=torch.tensor(1.5)))
    log.append(obs_device.zeros(1))
    s = log.summary()
    assert (s["rounds"], s["active_rounds"], s["cache_hits"]) == (2, 1, 3)
    assert s["cache_hit_rate"] == pytest.approx(0.3)
    assert s["beta_mean"] == 1.5 and s["beta_last"] == 1.5 and s["uplink_bytes"] == 100.0
    assert int(log.totals().cache_hits) == 3


# ---------------------------------------------------------------------------
# host plane: tracer, validator, exporters, report, CLI
# ---------------------------------------------------------------------------

def test_span_tracer_nesting_and_chrome_trace():
    tr = SpanTracer("t", meta={"k": "v"})
    with tr.span("outer", engine="scan"):
        with tr.span("inner"):
            pass
    assert [s.name for s in tr.spans] == ["inner", "outer"]  # exit order
    assert tr.spans[0].depth == 1 and tr.spans[1].depth == 0
    assert tr.spans[1].dur_s >= tr.spans[0].dur_s >= 0.0
    trace = tr.chrome_trace()
    assert validate_trace(trace) == []
    assert trace["otherData"]["k"] == "v"
    phs = [e["ph"] for e in trace["traceEvents"] if e["ph"] in "BE"]
    assert phs == ["B", "B", "E", "E"]


def test_span_tracer_record():
    tr = SpanTracer()
    tr.record("precompile", tr.t0 + 1.0, 2.5, stage="warmup")
    (line,) = tr.jsonl_lines()
    assert line["name"] == "precompile"
    assert line["start_s"] == pytest.approx(1.0) and line["dur_s"] == pytest.approx(2.5)
    assert validate_trace(tr.chrome_trace()) == []


@pytest.mark.parametrize("trace,needle", [
    ({}, "top-level 'traceEvents' missing or not a list"),
    ([], "top-level document is not a trace object"),
    ({"traceEvents": [{"name": "a", "ph": "B", "ts": 0.0},
                      {"name": "MISMATCH", "ph": "E", "ts": 1.0}]}, "does not close"),
    ({"traceEvents": [{"name": "a", "ph": "B", "ts": 0.0}]}, "unclosed"),
    ({"traceEvents": []}, "no B/E span events found"),
    ({"traceEvents": [{"name": "a", "ph": "E", "ts": 0.0}]}, "empty stack"),
    ({"traceEvents": [{"name": "a", "ph": "X", "ts": 0.0}]}, "without ts/dur"),
    ({"traceEvents": [{"name": "a", "ph": "Q", "ts": 0.0}]}, "unsupported phase"),
    ({"traceEvents": [{"name": "a", "ph": "B"}]}, "missing numeric 'ts'"),
])
def test_validate_trace_catches_malformed(trace, needle):
    from repro.obs.__main__ import validate_trace as rvalidate

    got = validate_trace(trace)
    assert any(needle in p for p in got)
    assert got == rvalidate(trace)


def _record_inputs(lib_tracer):
    tr = lib_tracer("exp")
    tr.t0 = 0.0  # fixed clock: equal spans in both packages
    tr.record("setup", 1.0, 2.5, engine="scan")
    tr.record("run", 3.5, 0.25)
    rows = _rows(5, T=4, n_coh=1)
    history = {"final_server_acc": 0.75, "final_client_acc": None,
               "comm": {"rounds": 4, "cumulative_total": 2.5e6,
                        "uplink_mean": 3.0e5, "downlink_mean": 3.25e5}}
    return tr, rows, history


def test_run_record_and_render_match_reference_byte_for_byte():
    ptr, rows, history = _record_inputs(SpanTracer)
    rtr, _, _ = _record_inputs(RSpanTracer)
    plog = TelemetryLog([RoundTelemetry(*(_t(a) for a in r)) for r in rows])
    rlog = rdev.TelemetryLog([rdev.RoundTelemetry(*r) for r in rows])
    prec = run_record(name="demo", config={"K": 4}, history=history, telemetry=plog,
                      tracer=ptr, extra={"device": "cpu"})
    rrec = rexport.run_record(name="demo", config={"K": 4}, history=history,
                              telemetry=rlog, tracer=rtr, extra={"device": "cpu"})
    assert json.dumps(prec, sort_keys=True) == json.dumps(rrec, sort_keys=True)
    for fmt in ("markdown", "text"):
        assert render(prec, fmt=fmt) == rreport.render(rrec, fmt=fmt)
    md = render(prec)
    assert "| cache_hits |" in md and "staleness" in md.lower()
    with pytest.raises(ValueError, match="unknown format"):
        render(prec, fmt="html")
    assert "empty record" in render({"name": "nothing"}, fmt="text")


def test_exporters_and_run_record(tmp_path):
    tr = SpanTracer("exp")
    with tr.span("run"):
        pass
    trace_path = write_chrome_trace(str(tmp_path / "a" / "trace.json"), tr)
    assert validate_trace(json.load(open(trace_path))) == []
    jsonl_path = write_spans_jsonl(str(tmp_path / "spans.jsonl"), tr)
    lines = [json.loads(li) for li in open(jsonl_path)]
    assert len(lines) == 1 and lines[0]["name"] == "run"
    log = TelemetryLog([obs_device.zeros(1)._replace(
        cache_hits=torch.tensor(4, dtype=torch.int32),
        participants=torch.tensor([2], dtype=torch.int32))])
    rec = write_run_record(str(tmp_path / "rec.json"), name="unit", telemetry=log, tracer=tr,
                           history={"final_server_acc": 0.5})
    assert json.load(open(tmp_path / "rec.json")) == rec
    assert rec["record"] == "repro.obs/run" and rec["telemetry"]["summary"]["cache_hits"] == 4
    # telemetry defaults from the history's own log
    rec2 = run_record(name="u2", history={"telemetry": log.as_dict()})
    assert rec2["telemetry"]["summary"]["cache_hits"] == 4
    assert telemetry_summary(object()) is None


def test_run_record_of_a_port_history(tmp_path):
    import repro_torch.fl as P

    cfg = P.FLConfig(n_clients=4, n_classes=4, dim=8, rounds=2, local_steps=1,
                     distill_steps=1, public_size=40, public_per_round=10,
                     private_size=64, hidden=8, eval_every=1, telemetry=True)
    h = P.run_method("scarlet", cfg, cache_duration=2, device="cpu")
    rec = write_run_record(str(tmp_path / "rec.json"), name="port", config=cfg, history=h)
    assert rec["config"]["n_clients"] == 4 and rec["telemetry"] == h.telemetry.as_dict()
    assert telemetry_summary(h) == h.telemetry.summary()
    assert "Telemetry (device plane)" in render(json.load(open(tmp_path / "rec.json")))


def test_cli_render_and_validate(tmp_path, capsys):
    tr = SpanTracer("cli")
    with tr.span("work"):
        pass
    trace_path = str(tmp_path / "trace.json")
    write_chrome_trace(trace_path, tr)
    rec_path = str(tmp_path / "rec.json")
    write_run_record(rec_path, name="cli-demo", tracer=tr)
    assert obs_main(["validate", trace_path]) == 0
    assert "ok:" in capsys.readouterr().out
    out_path = str(tmp_path / "report.md")
    assert obs_main(["render", rec_path, "--out", out_path]) == 0
    capsys.readouterr()
    assert "cli-demo" in open(out_path).read()
    assert obs_main(["render", rec_path, "--format", "text"]) == 0
    assert "Run report: cli-demo" in capsys.readouterr().out
    bad_path = str(tmp_path / "bad.json")
    json.dump({"traceEvents": [{"name": "a", "ph": "B", "ts": 0.0}]}, open(bad_path, "w"))
    assert obs_main(["validate", bad_path]) == 1
    assert "INVALID" in capsys.readouterr().out
    json.dump([], open(bad_path, "w"))
    assert obs_main(["validate", bad_path]) == 1
    open(bad_path, "w").write("{not json")
    assert obs_main(["validate", bad_path]) == 1
    capsys.readouterr()


def test_cli_runs_as_a_module_without_torch(tmp_path):
    """``python -m repro_torch.obs`` in a child process: the host plane is
    stdlib only."""
    tr = SpanTracer("child")
    with tr.span("work"):
        pass
    trace_path = write_chrome_trace(str(tmp_path / "trace.json"), tr)
    code = ("import runpy, sys; sys.argv = ['obs', 'validate', sys.argv[1]]\n"
            "try:\n    runpy.run_module('repro_torch.obs', run_name='__main__')\n"
            "except SystemExit as e:\n    assert e.code == 0, e.code\n"
            "assert 'torch' not in sys.modules\n")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    p = subprocess.run([sys.executable, "-c", code, trace_path], capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=src), timeout=60)
    assert p.returncode == 0, p.stderr
    assert p.stdout.startswith("ok:")


def test_profiler_trace(tmp_path, monkeypatch):
    with profiler_trace(None):  # falsy: a no-op that writes nothing
        pass
    with profiler_trace(str(tmp_path)):
        torch.ones(64).mul(2.0).sum()
    trace = json.load(open(tmp_path / obs_trace.PROFILE_TRACE))
    assert any("mul" in str(e.get("name", "")) for e in trace["traceEvents"])
    # a card is present but the profiler cannot record it: refuse, never
    # write a trace without the device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiler_trace(str(tmp_path / "x")):
            pass
