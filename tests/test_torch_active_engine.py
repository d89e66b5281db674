"""The port's active-set engine (``engine="active"``) on the CPU: against the
port's own engines, and against the JAX package's active-set engine.

The conformance matrix is the reference's (``tests/test_engine_conformance.py``
active cells): {scarlet, dsfl} x {bernoulli, outage} x {identity,
cache_delta+quant8}.  In every cell the three port engines run the same
numpy draws, and the active engine's ledger must equal the device engine's
(``engine="scan"``) bit for bit (every cost input is an exact small-integer
count through the same float32 expression) and the host loop's to float32;
caches to atol 1e-5, 5e-3 under a lossy codec (one 8-bit level, the band of
the reference's own suite); accuracies within one test sample.
Selective-FD's ledger is allclose only: its per-client upload average is a
float reduction over the stack, as the reference's docstring says.

Against the reference, the port starts from the reference's initial
parameters (``load_params``) and runs on the reference's jax-stream draws
(``ref._draw_round(t)``, what its active engine draws): per-round ledgers
equal to the reference's float32 values, caches, parameters and
accuracies in the bands of ``tests/test_torch_scan_engine.py``.
"""
import numpy as np
import pytest
import torch

import repro.fl as R
import repro_torch.fl as P
from repro.fl.active_engine import ActiveSetFederatedDistillation as RActive
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.obs.device import EXACT_FIELDS, GAUGE_FIELDS

A = P.ActiveSetFederatedDistillation

BASE = dict(n_clients=6, n_classes=5, dim=8, rounds=4, local_steps=2, distill_steps=2,
            public_size=60, public_per_round=16, private_size=120, hidden=12,
            eval_every=2, alpha=0.5)
SKW = {"scarlet": {"beta": 1.5}, "dsfl": {}, "cfd": {}, "mean": {}, "selective_fd": {}}
CACHE_D = {"scarlet": 1}  # entries expire within 3 rounds; the rest run cache-off


def _scenario(lib, name):
    """``bernoulli``: each client with p = 0.5 (stacks of 1, 2, 4);
    ``outage``: a fixed half, clients 0 and 2 offline in rounds 2-3 and
    every client in round 4 (returning stragglers, a total outage);
    ``single``: one client a round (a stack of one)."""
    K = BASE["n_clients"]
    if name == "bernoulli":
        return lib.Scenario(participation=lib.bernoulli_participation(0.5))
    if name == "single":
        return lib.Scenario(participation=lib.fixed_fraction(1.0 / K))
    return lib.Scenario(participation=lib.fixed_fraction(0.5),
                        outages=(lib.Outage(0, 2, 3), lib.Outage(2, 2, 3))
                        + tuple(lib.Outage(k, 4, 4) for k in range(K)))


def _ledger(h):
    return np.array([(r.uplink, r.downlink) for r in h.ledger.rounds])


def _build(engine, method, scen, cfg=None, **kw):
    cfg = cfg or P.FLConfig(**BASE)
    kw.setdefault("rng_backend", "numpy")  # the three engines on the same numpy draws
    eng = engine(cfg, P.STRATEGIES[method](**SKW[method]),
                 cache_duration=CACHE_D.get(method, 0),
                 scenario=kw.pop("scenario", None) or _scenario(P, scen), device="cpu", **kw)
    return eng, eng.run()


def _hold(a, b, *, exact, cache_atol, ledger_rtol=1e-7):
    (ea, ha), (eb, hb) = a, b
    if exact:
        np.testing.assert_array_equal(_ledger(ha), _ledger(hb))
    else:
        np.testing.assert_allclose(_ledger(ha), _ledger(hb), rtol=ledger_rtol, atol=0)
    assert ha.rounds == hb.rounds
    assert torch.equal(ea.cache_g.ts, eb.cache_g.ts)
    assert torch.equal(ea.cache_g.present, eb.cache_g.present)
    np.testing.assert_allclose(ea.cache_g.values.numpy(), eb.cache_g.values.numpy(),
                               rtol=0, atol=cache_atol)
    np.testing.assert_array_equal(ea.last_sync, eb.last_sync)
    one = 1.0 / len(ea.y_test)
    np.testing.assert_allclose(ha.server_acc, hb.server_acc, rtol=0, atol=one)
    np.testing.assert_allclose(ha.client_acc, hb.client_acc, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ha.client_val_loss, hb.client_val_loss, rtol=1e-4)
    assert len(ha.server_val_loss) == len(hb.server_val_loss)
    np.testing.assert_allclose(ha.server_val_loss, hb.server_val_loss, rtol=1e-4)
    for k, v in eb.server_params.items():
        np.testing.assert_allclose(ea.server_params[k].numpy(), v.numpy(), rtol=0, atol=1e-4)
    for pa, pb in zip(ea.client_params, eb.client_params):
        for k in pb:
            np.testing.assert_allclose(np.asarray(pa[k]), np.asarray(pb[k]), rtol=0, atol=1e-4)


MATRIX = [(s, p, c) for s in ("dsfl", "scarlet") for p in ("bernoulli", "outage")
          for c in ("identity", "cache_delta+quant8")]


@pytest.mark.parametrize("method,scen,codec", MATRIX, ids=["-".join(c) for c in MATRIX])
def test_active_engine_conformance_cell(method, scen, codec):
    cfg = P.FLConfig(**BASE, uplink_codec=codec)
    atol = 1e-5 if codec == "identity" else 5e-3
    active = _build(A, method, scen, cfg)
    scan = _build(P.ScannedFederatedDistillation, method, scen, cfg)
    host = _build(P.FederatedDistillation, method, scen, cfg)
    _hold(active, scan, exact=True, cache_atol=atol)
    _hold(active, host, exact=False, cache_atol=atol)
    if scen == "outage":
        assert tuple(_ledger(active[1])[3]) == (0.0, 0.0)
    if method == "scarlet":
        assert bool(active[0].cache_g.present.any())


@pytest.mark.parametrize("method", ["cfd", "mean", "selective_fd"])
def test_active_engine_comparison_methods(method):
    active = _build(A, method, "bernoulli")
    scan = _build(P.ScannedFederatedDistillation, method, "bernoulli")
    # Selective-FD: a float average over the stack
    _hold(active, scan, exact=method != "selective_fd", cache_atol=1e-5, ledger_rtol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_active_engine_single_participant_stacks(fused):
    """One participant a round: the gathered stack is (1, ...), a case the
    dense engines never reach; the fused kernel path too."""
    cfg = P.FLConfig(**BASE, uplink_codec="cache_delta+quant8", fused_round=fused)
    active = _build(A, "scarlet", "single", cfg)
    assert (active[0].last_sync == active[0].t_done).sum() == 1
    _hold(active, _build(P.ScannedFederatedDistillation, "scarlet", "single", cfg),
          exact=True, cache_atol=5e-3)


@pytest.mark.parametrize("codec", ["identity", "cache_delta+quant8"])
def test_active_engine_fused_round(codec):
    cfg = P.FLConfig(**BASE, uplink_codec=codec, fused_round=True)
    _hold(_build(A, "scarlet", "outage", cfg),
          _build(P.ScannedFederatedDistillation, "scarlet", "outage", cfg),
          exact=True, cache_atol=5e-3)


def test_active_engine_cohort_conformance():
    """Heterogeneous model cohorts: the gather and scatter are per cohort."""
    cohorts = (P.CohortSpec(2, 8, 1), P.CohortSpec(4, 16, 2))
    cfg = P.FLConfig(**BASE, cohorts=cohorts)
    active = _build(A, "scarlet", "bernoulli", cfg)
    assert len(active[1].cohort_client_acc[0]) == 2
    scan = _build(P.ScannedFederatedDistillation, "scarlet", "bernoulli", cfg)
    _hold(active, scan, exact=True, cache_atol=1e-5)
    np.testing.assert_allclose(active[1].cohort_client_acc, scan[1].cohort_client_acc,
                               rtol=0, atol=1e-4)


def test_active_engine_heterogeneous_schedules_and_expiry():
    """Per-client rates and step counts are gathered rows; probabilistic
    expiry takes the round's row of uniforms."""
    het = P.Heterogeneity(local_steps=(1, 0, 3, 2, 0, 1),
                          lr_scale=(1.0, 0.5, 2.0, 1.0, 0.5, 2.0), lr_decay=0.9)
    sc = P.Scenario(participation=P.bernoulli_participation(0.7), heterogeneity=het)
    kw = dict(scenario=sc, probabilistic_expiry=True)
    active = _build(A, "scarlet", None, **dict(kw))
    scan = _build(P.ScannedFederatedDistillation, "scarlet", None, **dict(kw))
    host = _build(P.FederatedDistillation, "scarlet", None, **dict(kw))
    _hold(active, scan, exact=True, cache_atol=1e-5)
    _hold(active, host, exact=False, cache_atol=1e-5)


def test_active_engine_telemetry_matches_scan():
    cfg = P.FLConfig(**BASE, uplink_codec="cache_delta+quant8", telemetry=True)
    ta = _build(A, "scarlet", "outage", cfg)[1].telemetry.stacks()
    ts = _build(P.ScannedFederatedDistillation, "scarlet", "outage", cfg)[1].telemetry.stacks()
    for f in EXACT_FIELDS:
        assert ta[f].dtype == ts[f].dtype, f
        np.testing.assert_array_equal(ta[f], ts[f], err_msg=f)
    for f in GAUGE_FIELDS:
        np.testing.assert_allclose(ta[f], ts[f], rtol=0, atol=1e-5, err_msg=f)
    assert ta["participants"][3].sum() == 0 and ta["catch_up_clients"].sum() > 0


def test_active_engine_telemetry_is_additive():
    on = _build(A, "scarlet", "bernoulli", P.FLConfig(**BASE, telemetry=True))
    off = _build(A, "scarlet", "bernoulli")
    np.testing.assert_array_equal(_ledger(on[1]), _ledger(off[1]))
    assert torch.equal(on[0].cache_g.values, off[0].cache_g.values)
    assert on[1].server_acc == off[1].server_acc and off[1].telemetry is None


def test_active_engine_memmap_matches_ram(tmp_path):
    ram = _build(A, "scarlet", "bernoulli")
    mm = _build(A, "scarlet", "bernoulli", store_backing="memmap", store_dir=str(tmp_path))
    np.testing.assert_array_equal(_ledger(mm[1]), _ledger(ram[1]))
    assert torch.equal(mm[0].cache_g.values, ram[0].cache_g.values)
    for k, v in ram[0].client_params[0].items():
        np.testing.assert_array_equal(mm[0].client_params[0][k], v)
    assert mm[1].server_acc == ram[1].server_acc


def test_active_engine_rejects_bad_store_config():
    cfg, strat = P.FLConfig(**BASE), P.STRATEGIES["scarlet"](beta=1.5)
    with pytest.raises(ValueError, match="directory"):
        A(cfg, strat, cache_duration=3, store_backing="memmap", device="cpu")
    with pytest.raises(ValueError, match="backing"):
        A(cfg, strat, cache_duration=3, store_backing="tape", device="cpu")
    with pytest.raises(ValueError, match="track_local_caches"):
        A(cfg, strat, cache_duration=3, track_local_caches=True, device="cpu")
    with pytest.raises(ValueError, match="scan-safe"):
        A(cfg, P.STRATEGIES["comet"](), device="cpu")


def test_active_engine_keeps_client_state_on_the_host():
    eng = A(P.FLConfig(**BASE), P.STRATEGIES["scarlet"](beta=1.5), device="cpu")
    for a in (eng.xs, eng.ys, eng.mask, eng.xts, eng.tmask, eng.x_test, eng.y_test,
              eng.train_mask_c[0], eng.val_mask_c[0]):
        assert isinstance(a, np.ndarray)
    assert eng.ys.dtype == np.int64 and eng.mask.dtype == np.float32
    assert isinstance(eng.client_params[0]["w0"], np.ndarray)
    # the store holds what the dense engines draw, and the server follows
    dense = P.ScannedFederatedDistillation(P.FLConfig(**BASE), P.STRATEGIES["scarlet"](beta=1.5),
                                           device="cpu")
    for k, v in dense.client_params[0].items():
        np.testing.assert_array_equal(eng.client_params[0][k], v.numpy())
    for k, v in dense.server_params.items():
        assert torch.equal(eng.server_params[k], v)


def test_gather_plan_pads_to_powers_of_two_in_client_order():
    eng = A(P.FLConfig(**BASE, cohorts=(P.CohortSpec(2, 8, 1), P.CohortSpec(4, 16, 2))),
            P.STRATEGIES["scarlet"](beta=1.5), device="cpu")
    plan = eng._gather_plan(np.array([False, False, True, False, True, True]))
    assert len(plan) == 1
    ci, rows, pad = plan[0]
    assert ci == 1 and rows.tolist() == [0, 2, 3] and pad.tolist() == [0, 2, 3, 0]
    plan = eng._gather_plan(np.array([True, False, False, True, False, False]))
    assert [(c, r.tolist(), p.tolist()) for c, r, p in plan] == [(0, [0], [0]), (1, [1], [1])]


def test_active_engine_restore_then_continue_bitwise(tmp_path):
    """5 rounds, a checkpoint, a fresh engine restored from it, 5 more: the
    same ledger, cache, store and server as 10 uninterrupted rounds."""
    cfg = P.FLConfig(**dict(BASE, rounds=10), uplink_codec="cache_delta+quant8")

    def make():
        return A(cfg, P.STRATEGIES["scarlet"](beta=1.5), cache_duration=1,
                 scenario=_scenario(P, "bernoulli"), device="cpu")

    whole = make()
    hw = whole.run(10)
    first = make()
    h1 = first.run(5)
    save_pytree(str(tmp_path / "ck.npz"), first.state_dict())
    second = make()
    second.load_state_dict(load_pytree(str(tmp_path / "ck.npz"), second.state_dict()))
    h2 = second.run(5)
    np.testing.assert_array_equal(np.concatenate([_ledger(h1), _ledger(h2)]), _ledger(hw))
    assert h2.rounds == [6, 8, 10] and hw.server_acc[-3:] == h2.server_acc
    for a, b in zip(whole.cache_g, second.cache_g):
        assert torch.equal(a, b)
    for k, v in whole.server_params.items():
        assert torch.equal(second.server_params[k], v)
    for k, v in whole.client_params[0].items():
        np.testing.assert_array_equal(second.client_params[0][k], v)
    np.testing.assert_array_equal(second.last_sync, whole.last_sync)


def test_active_engine_draws_are_checked():
    eng = A(P.FLConfig(**BASE), P.STRATEGIES["scarlet"](beta=1.5), device="cpu")
    K, m = BASE["n_clients"], BASE["public_per_round"]
    with pytest.raises(ValueError, match="draws must be"):
        eng.run(2, draws=(np.ones((1, K), bool), np.zeros((2, m), np.int64)))
    with pytest.raises(ValueError, match="distinct public"):
        eng.run(1, draws=(np.ones((1, K), bool), np.zeros((1, m), np.int64)))


@pytest.mark.parametrize("method", ["scarlet", "dsfl", "cfd", "mean", "selective_fd"])
def test_run_method_active_engine(method):
    cfg = P.FLConfig(**dict(BASE, rounds=2))
    kw = dict(engine="active", device="cpu", scenario=_scenario(P, "bernoulli"),
              cache_duration=CACHE_D.get(method, 0), **SKW[method])
    h = P.run_method(method, cfg, **kw)
    hs = P.run_method(method, cfg, **dict(kw, engine="scan"))
    np.testing.assert_allclose(_ledger(h), _ledger(hs), rtol=1e-6 if method == "selective_fd"
                               else 0, atol=0)
    assert h.rounds == [2] and np.isfinite(h.final_server_acc)


def test_run_method_refuses_the_engines_still_to_port():
    # the sharded engine is ported: with no process group it runs a world
    # of one on the CPU (gloo), the device engine's ledger
    h = P.run_method("scarlet", P.FLConfig(**BASE), engine="shard", device="cpu")
    np.testing.assert_array_equal(_ledger(h), _ledger(P.run_method(
        "scarlet", P.FLConfig(**BASE), engine="scan", device="cpu")))
    # the async engine is ported: it runs, and refuses COMET as the others do
    h = P.run_method("scarlet", P.FLConfig(**BASE), engine="async", device="cpu")
    assert len(h.ledger.rounds) == BASE["rounds"]
    with pytest.raises(ValueError, match="scan-safe"):
        P.run_method("comet", P.FLConfig(**BASE), engine="async", device="cpu")
    with pytest.raises(ValueError, match="no scanned/sharded"):
        P.run_method("fedavg", P.FLConfig(**BASE), engine="active", device="cpu")
    with pytest.raises(ValueError, match="scan-safe"):
        P.run_method("comet", P.FLConfig(**BASE), engine="active", device="cpu")


# ---------------------------------------------------------------------------
# Against the JAX package's active-set engine
# ---------------------------------------------------------------------------

REF_CELLS = [(s, c) for s in ("scarlet", "dsfl") for c in ("identity", "cache_delta+quant8")]


@pytest.mark.parametrize("method,codec", REF_CELLS, ids=["-".join(c) for c in REF_CELLS])
def test_active_engine_matches_reference_active_engine(method, codec):
    cfg = dict(BASE, rounds=3, eval_every=1, uplink_codec=codec)
    D = CACHE_D.get(method, 0)
    ref = RActive(R.FLConfig(**cfg), R.STRATEGIES[method](**SKW[method]), cache_duration=D,
                  scenario=_scenario(R, "bernoulli"))
    port = A(P.FLConfig(**cfg), P.STRATEGIES[method](**SKW[method]), cache_duration=D,
             scenario=_scenario(P, "bernoulli"), device="cpu")
    port.load_params([{k: np.array(v) for k, v in p.items()} for p in ref.client_params],
                     {k: np.array(v) for k, v in ref.server_params.items()})
    draws = [ref._draw_round(t) for t in range(1, 4)]
    part = np.stack([np.asarray(p) for p, _ in draws])
    idx = np.stack([np.asarray(i) for _, i in draws])
    rh, ph = ref.run(), port.run(draws=(part, idx))

    np.testing.assert_array_equal(_ledger(ph), _ledger(rh))
    assert ph.rounds == rh.rounds and ph.cumulative_mb == rh.cumulative_mb
    np.testing.assert_array_equal(port.cache_g.ts.numpy(), np.asarray(ref.cache_g.ts))
    np.testing.assert_array_equal(port.cache_g.present.numpy(), np.asarray(ref.cache_g.present))
    np.testing.assert_allclose(port.cache_g.values.numpy(), np.asarray(ref.cache_g.values),
                               rtol=0, atol=5e-3 if "quant" in codec else 1e-5)
    np.testing.assert_array_equal(port.last_sync, np.asarray(ref.last_sync))
    for k, v in ref.server_params.items():
        np.testing.assert_allclose(port.server_params[k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-4)
    for k, v in ref.client_params[0].items():
        np.testing.assert_allclose(port.client_params[0][k], np.asarray(v), rtol=0, atol=1e-4)
    one = 1.0 / len(ref.y_test)
    np.testing.assert_allclose(ph.server_acc, rh.server_acc, rtol=0, atol=one)
    np.testing.assert_allclose(ph.client_acc, rh.client_acc, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ph.server_val_loss, rh.server_val_loss, rtol=1e-4)
    np.testing.assert_allclose(ph.client_val_loss, rh.client_val_loss, rtol=1e-4)
