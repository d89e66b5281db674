"""The port's static analyzer (``repro_torch.analysis``) on the CPU, and
against the reference analyzer (``repro.analysis``).

Parity: for every subject the port has (scarlet, dsfl, cfd, mean and
selective_fd with their analysis variants; the identity, quant8, quant4, quant1 and cache_delta
codecs; the four broken strategies), the multiset of finding levels of the
port's contract pass equals that of the reference's jaxpr pass, run live.
Under jax releases where ``jax.core`` no longer exports ``ClosedJaxpr``
and ``Jaxpr``, the test sets them from ``jax.extend.core`` through
``monkeypatch`` for its own duration (the reference's traceutil reads
them); nothing in the reference changes.

The fixture kernels' plain versions are held, bit for bit, against the
reference fixtures' kernel bodies (``_copy_kernel``, ``_scale_kernel``)
run through ``pl.pallas_call(interpret=True)`` with aligned BlockSpecs
on the same numpy-seeded inputs.
"""
import json
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro.analysis import fixtures as rfix
from repro_torch.analysis import contract_checks, fixtures, launch_checks, obs_checks, traceutil
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.report import Finding, Report
from repro_torch.kernels import fixture_kernel, ops, runtime

S = traceutil.tensor_spec


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------

def test_report_exit_codes():
    r = Report()
    assert r.exit_code() == 0 and r.exit_code(strict=True) == 0
    r.add("ok", "contract", "a", "fine")
    r.add("info", "launch", "b", "note")
    assert r.exit_code(strict=True) == 0
    r.add("warn", "contract", "c", "hmm")
    assert r.exit_code() == 0 and r.exit_code(strict=True) == 1
    r.add("error", "launch", "d", "bad")
    assert r.exit_code() == 1
    assert r.counts() == {"error": 1, "warn": 1, "info": 1, "ok": 1}
    with pytest.raises(ValueError):
        Finding("fatal", "p", "s", "m")


def test_report_render_and_json():
    r = Report()
    r.add("ok", "contract", "strategy:x", "verified")
    r.add("error", "launch", "k", "misaligned")
    assert "[ERROR] launch: k: misaligned" in r.render()
    assert "verified" not in r.render() and "verified" in r.render(verbose=True)
    d = json.loads(r.to_json())
    assert d["counts"]["error"] == 1 and len(d["findings"]) == 2
    assert d["findings"][1] == {"level": "error", "pass_name": "launch", "subject": "k",
                                "message": "misaligned"}


# ---------------------------------------------------------------------------
# The trace and its spies
# ---------------------------------------------------------------------------

def test_trace_records_a_host_read():
    tr = traceutil.trace(lambda z: z * float(z.sum()), S((4, 5)))
    assert tr.ok and len(tr.host_reads) == 1
    assert tr.output.device.type == "cuda" and tuple(tr.output.shape) == (4, 5)
    assert "host reads" in tr.scan_safety_violations()[0]


def test_trace_records_a_device_to_host_copy():
    for fn in (lambda z: z.cpu(), lambda z: z.to("cpu"),
               lambda z: torch.empty(4, 5).copy_(z)):
        tr = traceutil.trace(fn, S((4, 5)))
        assert tr.ok and len(tr.to_host) == 1, tr.error
        assert "device-to-host" in tr.scan_safety_violations()[0]
    tr = traceutil.trace(lambda z: z.cpu().numpy(), S((4, 5)))
    assert not tr.ok and len(tr.scan_safety_violations()) == 2


def test_trace_records_host_rng():
    tr = traceutil.trace(lambda z: z + np.random.default_rng(0).normal(), S((2,)))
    assert tr.ok and tr.host_rng == ["np.random.default_rng"]
    tr = traceutil.trace(lambda z: z + np.random.RandomState(0).rand(), S((2,)))
    assert tr.host_rng == ["np.random.RandomState"]
    assert np.random.default_rng is not None and traceutil.trace(lambda: 0).host_rng == []


def test_trace_records_a_launch_and_moves_no_count():
    ops.reset_launches()
    tr = traceutil.trace(lambda z: ops.enhanced_era_fused(z, 1.5), S((4, 8, 10)))
    assert tr.ok and tr.scan_safety_violations() == []
    (launch,) = tr.launches
    assert (launch.lib, launch.fn, launch.plan.kernel) == (
        "era_fused", "era_fused_launch", "era_fused_kernel")
    assert tr.launched("era_fused") and not tr.launched("qdq")
    assert all(n == 0 for n in ops.launches().values())
    assert runtime.launch.__name__ == "launch"  # the recorder is gone


def test_trace_indexes_fake_cuda_tensors_as_views():
    tr = traceutil.trace(lambda z: (z[:, 1:], z[0], z[..., None], z.t().contiguous(),
                                    z[torch.zeros(3, dtype=torch.long, device="cuda")]),
                         S((4, 5)))
    assert tr.ok, tr.error
    a, b, c, d, e = tr.output
    assert (a.shape, a.stride(), a.storage_offset()) == ((4, 4), (5, 1), 1)
    assert (b.shape, b.storage_offset()) == ((5,), 0)
    assert c.shape == (4, 5, 1) and d.stride() == (4, 1) and e.shape == (3, 5)


# ---------------------------------------------------------------------------
# Passes on the real registries and on the fixtures
# ---------------------------------------------------------------------------

def test_repo_contract_pass_clean():
    plans = []
    got = contract_checks.run(plans=plans)
    assert [f for f in got if f.level in ("error", "warn")] == []
    assert {f.subject for f in got} >= {"strategy:scarlet", "strategy:dsfl", "codec:quant8"}
    assert any(launch.plan.kernel == "fused_round_tile<10>" for _, launch in plans)
    # the comparison methods: scan-safe by trace, CFD's transmit a qdq launch
    for name in ("cfd", "cfd{'b_up': 8}", "mean", "selective_fd",
                 "selective_fd{'tau_client': 0.25}"):
        assert [f.message for f in got if f.subject == f"strategy:{name}"] == [
            "scan_safe=True verified by trace"]
    assert {label: launch.plan.kernel for label, launch in plans
            if label.startswith(("strategy:cfd", "strategy:mean", "strategy:selective_fd"))
            } == {"strategy:cfd/transmit#0": "qdq_tile",
                  "strategy:cfd{'b_up': 8}/transmit#0": "qdq_tile"}
    # COMET is host-only, justified by its aggregate; top-k is scan-safe,
    # its wire forms traced as well
    for name in ("comet", "comet{'n_clusters': 3}"):
        msgs = [f.message for f in got if f.subject == f"strategy:{name}"]
        assert len(msgs) == 1 and msgs[0].startswith("scan_safe=False justified: ")
        assert "to the host" in msgs[0]
    assert [f.message for f in got if f.subject == "codec:topk"] == [
        "scan_safe=True verified"]


@pytest.mark.parametrize("kw", [{}, {"n_clusters": 3}])
def test_comet_aggregate_trace_records_the_host_copy_and_the_rng(kw):
    """COMET's k-means copies the stack to the host and seeds a numpy
    Generator: the trace records both (the copy's ``.numpy()`` then fails
    on the fake tensor)."""
    from repro_torch.analysis.traceutil import tensor_spec, trace
    from repro_torch.fl.strategies import STRATEGIES

    s = STRATEGIES["comet"](**kw)
    tr = trace(lambda z_: s.aggregate(z_, None, 1), tensor_spec((8, 16, 10)))
    assert not tr.ok
    assert tr.to_host == ["(8, 160) to the host"]
    assert tr.host_rng == ["np.random.default_rng"]
    assert len(tr.scan_safety_violations()) == 3


def test_repo_launch_pass_clean():
    got = launch_checks.run()
    assert got and all(f.level == "ok" for f in got), [str(f) for f in got if f.level != "ok"]


@pytest.mark.parametrize("name", sorted(fixtures.BROKEN_STRATEGIES))
def test_broken_strategy_flagged(name):
    got = contract_checks.check_strategy(name, fixtures.BROKEN_STRATEGIES[name])
    want = fixtures.EXPECTED_STRATEGY_LEVEL[name]
    assert any(f.level == want for f in got), [str(f) for f in got]


@pytest.mark.parametrize("label,fn,args,want", fixtures.broken_kernel_cases(),
                         ids=[c[0] for c in fixtures.broken_kernel_cases()])
def test_broken_kernel_flagged(label, fn, args, want):
    got = launch_checks.check_case(label, fn, args)
    assert [f.level for f in got] == [want], [str(f) for f in got]


@pytest.mark.parametrize("label,fn,args", fixtures.valid_kernel_cases(),
                         ids=[c[0] for c in fixtures.valid_kernel_cases()])
def test_valid_kernel_plans_clean(label, fn, args):
    assert [f.level for f in launch_checks.check_case(label, fn, args)] == ["ok"]


def test_smuggler_is_flagged_for_its_copy_and_its_numpy():
    got = contract_checks.check_strategy("s", fixtures.CallbackSmugglerStrategy)
    (err,) = [f for f in got if f.level == "error"]
    assert "aggregate_masked" in err.message and "device-to-host" in err.message
    assert ".numpy()" in err.message or "numpy" in err.message


def test_analysis_variants_and_declared_contract():
    from repro_torch.fl.strategies import STRATEGIES

    assert STRATEGIES["scarlet"].analysis_variants == ({}, {"beta": "adaptive"})
    assert STRATEGIES["dsfl"].analysis_variants == ({}, {"T": 0.5})
    assert STRATEGIES["scarlet"]().declared_contract() == {
        "name": "scarlet", "scan_safe": True, "supports_fused_round": True, "uses_cache": True}
    assert STRATEGIES["scarlet"](beta="adaptive").declared_contract()[
        "supports_fused_round"] is False


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_selftest_cpu(capsys):
    assert main(["--selftest", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "NOT flagged" not in out and "fixture/smem-hog" in out
    assert "[OK   ] selftest: fixture/telemetry-callback: flagged as expected (error)" in out


# ---------------------------------------------------------------------------
# The telemetry (obs) pass
# ---------------------------------------------------------------------------

def test_obs_pass_clean_on_the_references_variants():
    from repro.analysis import obs_checks as robs

    assert obs_checks.ANALYSIS_VARIANTS == robs.ANALYSIS_VARIANTS
    plans = []
    got = obs_checks.run(plans=plans)
    assert [f for f in got if f.level in ("error", "warn")] == []
    assert {f.subject for f in got} == {
        "telemetry[scarlet]", "telemetry[scarlet+adaptive]",
        "telemetry[scarlet+cache_delta+quant8]", "telemetry[dsfl]",
        "telemetry[scarlet+fused]", "telemetry[scarlet+cache_delta+quant8+fused]",
        "telemetry[structure]", "telemetry[structure+fused]"}
    # the fused path's server view is the telemetry's own qdq launch
    assert [(label, launch.plan.kernel) for label, launch in plans] == [
        ("telemetry[scarlet+cache_delta+quant8+fused]#0", "qdq_tile")]
    linted = launch_checks.check_launches(plans)
    assert linted and not [f for f in linted if f.level in ("error", "warn")]


def test_telemetry_callback_fixture_flagged():
    got = obs_checks.check_round_body("fixture/telemetry-callback",
                                      fixtures.telemetry_callback_engine())
    assert [f.level for f in got] == ["error"]
    assert "host reads of device values" in got[0].message


def test_obs_pass_flags_telemetry_that_moves_the_round():
    """A telemetry path that also touches the round's state is caught by
    the off/on round, though its row looks right."""
    from repro_torch.fl.scan_engine import ScannedFederatedDistillation

    class Meddling(ScannedFederatedDistillation):
        def _round_device(self, st, t, part, idx, do_eval, u=None):
            new_st, out = super()._round_device(st, t, part, idx, do_eval, u=u)
            if self._telemetry:
                new_st["server_params"] = {k: v + 1e-7 for k, v in new_st["server_params"].items()}
            return new_st, out

    def make(tel):
        eng = obs_checks.build_engine("scarlet", {}, {"cache_duration": 2}, "identity", tel)
        eng.__class__ = Meddling
        return eng

    got = obs_checks.check_off_on("fixture/meddling", make)
    assert [f.level for f in got] == ["error"] and "server_params" in got[0].message
    clean = obs_checks.check_off_on("clean", lambda tel: obs_checks.build_engine(
        "dsfl", {}, {}, "identity", tel))
    assert [f.level for f in clean] == ["ok"]


def test_contract_pass_traces_sharpen_gauge():
    """``sharpen_gauge`` runs inside the device round with telemetry on: a
    host read there breaks a strategy's scan_safe claim."""
    from repro_torch.fl.strategies import STRATEGIES

    class ReadingGauge(STRATEGIES["scarlet"]):
        name = "fixture_reading_gauge"

        def sharpen_gauge(self, zbar, t):
            return torch.full((), float(zbar.max()), device=zbar.device)

    got = contract_checks.check_strategy("fixture_reading_gauge", ReadingGauge)
    errors = [f.message for f in got if f.level == "error"]
    assert errors and all("sharpen_gauge: host reads" in m for m in errors)


def test_cli_strict_cpu_json(capsys, tmp_path):
    p = tmp_path / "report.json"
    assert main(["--strict", "--fast", "--device", "cpu", "--json", str(p)]) == 0
    d = json.loads(p.read_text())
    assert d["counts"]["error"] == 0 and d["counts"]["warn"] == 0
    infos = [f["message"] for f in d["findings"] if f["level"] == "info"]
    assert "compiled attributes not read: device=cpu" in infos
    assert any("wait for" in m for m in infos)
    subjects = {f["subject"] for f in d["findings"]}
    assert {"attn/whisper-B4-S384-H20-d64-bf16", "era_fused/K2-B3-N12288",
            "strategy:scarlet/aggregate_masked#0"} <= subjects
    capsys.readouterr()


def test_cli_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--strict"])


def test_cli_fails_on_a_flagged_registry(monkeypatch, capsys):
    """A broken strategy in the registry turns the exit code nonzero."""
    import repro_torch.fl.strategies as strategies

    monkeypatch.setitem(strategies.STRATEGIES, "fixture_host_rng", fixtures.HostRNGStrategy)
    assert main(["--device", "cpu"]) == 1
    assert "fixture_host_rng" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Against the reference analyzer
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_core_shim(monkeypatch):
    """``jax.core.ClosedJaxpr`` / ``Jaxpr`` where this jax has moved them to
    ``jax.extend.core`` (the reference's traceutil reads them)."""
    for name in ("ClosedJaxpr", "Jaxpr"):
        if not hasattr(jax.core, name):
            import jax.extend.core as jec
            monkeypatch.setattr(jax.core, name, getattr(jec, name), raising=False)


def _levels(findings):
    return Counter(f.level for f in findings)


@pytest.mark.parametrize("name", ["scarlet", "dsfl", "cfd", "mean", "selective_fd", "comet"])
def test_strategy_levels_match_the_reference(jax_core_shim, name):
    from repro.analysis import jaxpr_checks
    from repro.fl.strategies import STRATEGIES as RSTRAT
    from repro_torch.fl.strategies import STRATEGIES as PSTRAT

    ref = jaxpr_checks.check_strategy(name, RSTRAT[name])
    port = contract_checks.check_strategy(name, PSTRAT[name])
    assert {f.subject for f in ref} == {f.subject for f in port}
    for subject in {f.subject for f in ref}:
        assert _levels(f for f in port if f.subject == subject) == _levels(
            f for f in ref if f.subject == subject), subject


@pytest.mark.parametrize("name", ["identity", "quant8", "quant4", "quant1", "topk",
                                  "cache_delta"])
def test_codec_levels_match_the_reference(jax_core_shim, name):
    from repro.analysis import jaxpr_checks
    from repro.compress.codecs import CODECS as RCOD
    from repro_torch.compress.codecs import CODECS as PCOD

    assert _levels(contract_checks.check_codec(name, PCOD[name])) == _levels(
        jaxpr_checks.check_codec(name, RCOD[name]))


@pytest.mark.parametrize("name", sorted(rfix.BROKEN_STRATEGIES))
def test_fixture_levels_match_the_reference(jax_core_shim, name):
    from repro.analysis import jaxpr_checks

    assert fixtures.EXPECTED_STRATEGY_LEVEL[name] == rfix.EXPECTED_STRATEGY_LEVEL[name]
    assert _levels(contract_checks.check_strategy(name, fixtures.BROKEN_STRATEGIES[name])) == \
        _levels(jaxpr_checks.check_strategy(name, rfix.BROKEN_STRATEGIES[name]))


def test_port_registries_are_the_references_subset():
    from repro.compress.codecs import CODECS as RCOD
    from repro.fl.strategies import STRATEGIES as RSTRAT
    from repro_torch.compress.codecs import CODECS as PCOD
    from repro_torch.fl.strategies import STRATEGIES as PSTRAT

    assert set(PSTRAT) == set(RSTRAT)
    assert set(PCOD) == set(RCOD)


# the reference's kernel fixtures -> the port's, label for label
_KERNEL_FIXTURES = {"fixture/misaligned-rows": "fixture/misaligned-vec4",
                    "fixture/scalar-in-vmem": "fixture/scalar-by-value",
                    "fixture/vmem-hog": "fixture/smem-hog"}


def test_kernel_fixture_levels_match_the_reference_expectations():
    ref = {label: want for label, _, _, want in rfix.broken_kernel_cases()}
    port = {label: want for label, _, _, want in fixtures.broken_kernel_cases()}
    assert {_KERNEL_FIXTURES[k]: v for k, v in ref.items()} == port


@pytest.mark.parametrize("ref_label", sorted(_KERNEL_FIXTURES))
def test_kernel_fixture_verdicts_match_the_live_pallas_lint(jax_core_shim, ref_label):
    """Where the reference's Pallas lint runs under the installed jax, its
    verdict on each fixture is the port's."""
    from repro.analysis import pallas_checks

    (fn, args) = [(f, a) for label, f, a, _ in rfix.broken_kernel_cases() if label == ref_label][0]
    try:
        ref = pallas_checks.check_case(ref_label, fn, args)
    except AttributeError as e:
        pytest.skip(f"the reference Pallas lint does not run under jax {jax.__version__}: {e}")
    (_, pfn, pargs, _) = [c for c in fixtures.broken_kernel_cases()
                          if c[0] == _KERNEL_FIXTURES[ref_label]][0]
    port = launch_checks.check_case(ref_label, pfn, pargs)
    assert {f.level for f in ref if f.level in ("error", "ok")} == {
        f.level for f in port if f.level in ("error", "ok")}


def _pallas(kernel, x, *rest, rest_specs=()):
    """``kernel`` over ``x`` in aligned (8, 128) blocks, interpreted."""
    rows, cols = x.shape
    spec = pl.BlockSpec((8, 128), lambda i, j: (i, j))
    return pl.pallas_call(kernel, grid=(rows // 8, cols // 128),
                          in_specs=[spec, *rest_specs], out_specs=spec,
                          out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                          interpret=True)(x, *rest)


@pytest.mark.parametrize("shape", [(16, 128), (96, 128), (64, 256)])
def test_copy_plain_matches_the_reference_copy_kernel(shape):
    x = np.random.default_rng(shape[0]).standard_normal(shape, dtype=np.float32)
    want = np.asarray(_pallas(rfix._copy_kernel, jnp.asarray(x)))
    got = fixture_kernel.copy_plain(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(fixture_kernel.copy_vec4(torch.from_numpy(x)).numpy(), want)
    assert np.array_equal(fixture_kernel.copy_smem(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("s", [1.5, -0.3, 1e-20])
def test_scale_plain_matches_the_reference_scale_kernel(s):
    x = np.random.default_rng(3).standard_normal((16, 128), dtype=np.float32)
    sv = np.array([s], np.float32)
    want = np.asarray(_pallas(rfix._scale_kernel, jnp.asarray(x), jnp.asarray(sv),
                              rest_specs=(pl.BlockSpec((1,), lambda i, j: (0,)),)))
    got = fixture_kernel.scale_plain(torch.from_numpy(x), torch.from_numpy(sv))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        fixture_kernel.scale(torch.from_numpy(x), torch.from_numpy(sv)).numpy(), want)


def test_fixture_wrappers_take_the_plain_version_on_the_cpu():
    ops.reset_launches()
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert torch.equal(fixture_kernel.copy_vec4(x), x)
    assert torch.equal(fixture_kernel.copy_smem(x, fixture_kernel.HOG_TILE), x)
    assert torch.equal(fixture_kernel.scale(x, torch.tensor([2.0]), sync=True), 2 * x)
    assert ops.launches()["copy_vec4"] == ops.launches()["scale"] == 0
    assert ops.launches()["copy_smem"] == 0


def test_the_port_imports_neither_jax_nor_the_reference():
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch" / "analysis").glob("*.py"))
    files.append(root / "src" / "repro_torch" / "kernels" / "fixture_kernel.py")
    assert len(files) == 9
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("jax", "repro") for n in names), f
