"""The port's run telemetry against the JAX package's, on the CPU.

The host loop runs the reference's conformance matrix
(``tests/test_telemetry_conformance.py``: SCARLET D=3 β=1.5 and DS-FL with
the cache, Bernoulli(0.5) and an outage window, identity and
``cache_delta+quant8``) against the reference's host loop with
``rng_backend="numpy"``, from the reference's initial parameters.  The
device engine, per-op and fused, runs on the reference's jax-stream draws
against the reference's scan engine, as ``tests/test_torch_scan_engine.py``
does.  Every cell holds ``History.telemetry.stacks()`` to:

- ``EXACT_FIELDS`` (counters, bytes) equal, with equal dtypes: integer
  counts from the same draws and cache masks;
- ``GAUGE_FIELDS`` (entropies, β, codec error) to atol/rtol 1e-5: float32
  means over clients and rows, summed in other orders.

One band is wider: the fused engine's ``teacher_entropy_post`` reads the
teacher its fused round kernel made, which on a rounding tie of the
8-bit residual code lies one level (range/255) from the per-op one, the
5e-3 band the caches are held to there (``test_torch_scan_engine.py``).

Telemetry is an observation: turning it on leaves ledgers, caches and
parameters bit for bit as they are with it off, on each engine.
"""
import numpy as np
import pytest
import torch

import repro.fl as R
import repro_torch.fl as P
from repro.fl.scan_engine import ScannedFederatedDistillation as RScan
from repro_torch.obs import device as obs_device
from repro_torch.obs.device import EXACT_FIELDS, GAUGE_FIELDS

# the reference's conformance configuration (mesh_spec aside)
CFG = dict(n_clients=4, n_classes=4, dim=8, rounds=4, local_steps=2,
           distill_steps=2, public_size=48, public_per_round=10,
           private_size=64, alpha=0.5, eval_every=2, seed=0, hidden=12,
           telemetry=True)

STRATEGY_KW = {
    "scarlet": (dict(beta=1.5), dict(cache_duration=3)),
    # DS-FL with the cache plugged in, so its cells count hits and expiry
    "dsfl": (dict(T=0.1), dict(use_cache=True, cache_duration=3)),
}


def _participation(lib, name):
    if name == "bernoulli":
        return lib.Scenario(participation=lib.bernoulli_participation(0.5))
    # an outage window: a returning straggler (catch-up, staleness tail)
    return lib.Scenario(participation=lib.fixed_fraction(0.5),
                        outages=(lib.Outage(1, 2, 3),))


MATRIX = [(s, p, c) for s in sorted(STRATEGY_KW) for p in ("bernoulli", "outage")
          for c in ("identity", "cache_delta+quant8")]


def _params_np(params):
    return {k: np.array(v) for k, v in params.items()}


def _ledger(hist):
    return [(r.uplink, r.downlink) for r in hist.ledger.rounds]


def _hold_stacks(port, ref, post_atol=1e-5):
    """``port``'s telemetry stacks against ``ref``'s (both Histories)."""
    ps, rs = port.telemetry.stacks(), ref.telemetry.stacks()
    assert sorted(ps) == sorted(rs)
    for f in EXACT_FIELDS:
        assert ps[f].dtype == rs[f].dtype, f
        np.testing.assert_array_equal(ps[f], rs[f], err_msg=f)
    for f in GAUGE_FIELDS:
        assert ps[f].dtype == rs[f].dtype, f
        atol = post_atol if f == "teacher_entropy_post" else 1e-5
        np.testing.assert_allclose(ps[f], rs[f], rtol=1e-5, atol=atol, err_msg=f)


def _host_pair(method, part, codec, skw=None, ekw=None, **cfg_kw):
    """(reference History, port History, port engine) of one host-loop cell."""
    skw0, ekw0 = STRATEGY_KW.get(method, ({}, {}))
    skw, ekw = dict(skw0, **(skw or {})), dict(ekw0, **(ekw or {}))
    cfg = dict(CFG, uplink_codec=codec, **cfg_kw)
    ref = R.FederatedDistillation(R.FLConfig(**cfg), R.STRATEGIES[method](**skw),
                                  scenario=_participation(R, part), rng_backend="numpy",
                                  **ekw)
    port = P.FederatedDistillation(P.FLConfig(**cfg), P.STRATEGIES[method](**skw),
                                   scenario=_participation(P, part), device="cpu", **ekw)
    port.load_params([_params_np(p) for p in ref.client_params],
                     _params_np(ref.server_params))
    rh, ph = ref.run(), port.run()
    assert ph.ledger.summary() == rh.ledger.summary()
    return rh, ph, port


@pytest.mark.parametrize("method,part,codec", MATRIX, ids=[f"{s}-{p}-{c}" for s, p, c in MATRIX])
def test_host_loop_telemetry_matches_reference(method, part, codec):
    rh, ph, _ = _host_pair(method, part, codec)
    _hold_stacks(ph, rh)
    assert ph.telemetry.summary() == pytest.approx(rh.telemetry.summary(), rel=1e-5, abs=1e-5)
    # the partition invariant: each distilled row is one cache signal
    s = ph.telemetry.summary()
    assert (s["cache_hits"] + s["cache_miss_new"] + s["cache_expired"]
            == s["active_rounds"] * CFG["public_per_round"])
    # the byte counters are the ledger's rows in float32
    st = ph.telemetry.stacks()
    led = np.array(_ledger(ph), np.float32)
    np.testing.assert_array_equal(st["uplink_bytes"], led[:, 0])
    np.testing.assert_array_equal(st["downlink_bytes"], led[:, 1])
    if part == "outage":  # client 1 comes back in round 4 after its outage
        assert st["catch_up_clients"].sum() > 0 and st["catch_up_bytes"].sum() > 0
        assert st["staleness_hist"][:, 1:].sum() > 0


# the device engine: (method, codec, scenario, fused) on test_torch_scan_engine's
# configuration, D=1 so entries expire within its 3 rounds
SCAN_BASE = dict(n_clients=6, n_classes=5, dim=8, rounds=3, local_steps=3,
                 distill_steps=3, public_size=60, public_per_round=24,
                 private_size=120, hidden=16, eval_every=1, alpha=0.5, telemetry=True)
SCAN_CELLS = [("scarlet", "identity", "half", False),
              ("scarlet", "cache_delta+quant8", "outage", False),
              ("scarlet", "cache_delta+quant8", "outage", True),
              ("scarlet", "identity", "half", True),
              ("dsfl", "identity", "half", False)]


def _scan_scenario(lib, name):
    """``half``: a fixed half each round; ``outage``: half, with every client
    offline in round 2 (a round with no participant)."""
    K = SCAN_BASE["n_clients"]
    outages = (tuple(lib.Outage(k, 2, 2) for k in range(K)) if name == "outage" else ())
    return lib.Scenario(participation=lib.fixed_fraction(0.5), outages=outages)


@pytest.mark.parametrize("method,codec,scen,fused", SCAN_CELLS)
def test_device_engine_telemetry_matches_reference_scan(method, codec, scen, fused):
    cfg = dict(SCAN_BASE, uplink_codec=codec, fused_round=fused)
    skw = {"beta": 1.5} if method == "scarlet" else {}
    D = 1 if method == "scarlet" else 0
    ref = RScan(R.FLConfig(**cfg), R.STRATEGIES[method](**skw), cache_duration=D,
                scenario=_scan_scenario(R, scen))
    port = P.ScannedFederatedDistillation(P.FLConfig(**cfg), P.STRATEGIES[method](**skw),
                                          cache_duration=D, scenario=_scan_scenario(P, scen),
                                          device="cpu")
    port.load_params([_params_np(p) for p in ref.client_params],
                     _params_np(ref.server_params))
    draws = [ref._draw_round(t) for t in range(1, SCAN_BASE["rounds"] + 1)]
    rh = ref.run()
    ph = port.run(draws=(np.stack([p for p, _ in draws]), np.stack([i for _, i in draws])))
    assert _ledger(ph) == _ledger(rh)
    # the fused teacher within one 8-bit level of the per-op one (module doc)
    _hold_stacks(ph, rh, post_atol=5e-3 if fused and "quant" in codec else 1e-5)
    st = ph.telemetry.stacks()
    if scen == "outage":  # the gated row of the round nobody took part in
        for f in st:
            assert not st[f][1].any(), f
    np.testing.assert_array_equal(st["uplink_bytes"], np.array(_ledger(ph), np.float32)[:, 0])


def test_adaptive_beta_gauge_matches_reference():
    rh, ph, _ = _host_pair("scarlet", "outage", "identity", skw={"beta": "adaptive"})
    _hold_stacks(ph, rh)
    beta = ph.telemetry.stacks()["beta"]
    assert np.all((beta > 1.0) & (beta < 2.5)) and len(np.unique(beta)) > 1


def test_comet_rows_on_the_host_loop_match_reference():
    rh, ph, _ = _host_pair("comet", "outage", "cache_delta+quant8",
                           ekw=dict(use_cache=True, cache_duration=3),
                           downlink_codec="quant8")
    _hold_stacks(ph, rh)
    assert not ph.telemetry.stacks()["beta"].any()  # COMET has no sharpener


def _engines():
    """(label, engine class, fused) of the three engines."""
    return [("host", P.FederatedDistillation, False),
            ("scan", P.ScannedFederatedDistillation, False),
            ("fused", P.ScannedFederatedDistillation, True)]


@pytest.mark.parametrize("label,engine,fused", _engines(), ids=["host", "scan", "fused"])
def test_telemetry_on_leaves_the_run_bit_identical(label, engine, fused):
    runs = []
    for tel in (False, True):
        cfg = P.FLConfig(**dict(SCAN_BASE, telemetry=tel, fused_round=fused,
                                uplink_codec="cache_delta+quant8"))
        eng = engine(cfg, P.STRATEGIES["scarlet"](beta=1.5), cache_duration=1,
                     scenario=_scan_scenario(P, "outage"), device="cpu")
        runs.append((eng, eng.run()))
    (off, hoff), (on, hon) = runs
    assert hoff.telemetry is None and "telemetry" not in hoff.as_dict()
    assert hon.telemetry is not None and len(hon.telemetry) == SCAN_BASE["rounds"]
    assert hon.as_dict()["telemetry"] == hon.telemetry.as_dict()
    assert _ledger(hon) == _ledger(hoff)
    assert hon.server_acc == hoff.server_acc and hon.client_acc == hoff.client_acc
    assert hon.server_val_loss == hoff.server_val_loss
    for a, b in zip(on.cache_g, off.cache_g):
        assert torch.equal(a, b)
    for k in off.server_params:
        assert torch.equal(on.server_params[k], off.server_params[k])
        assert torch.equal(on.client_params[0][k], off.client_params[0][k])
    np.testing.assert_array_equal(on.last_sync, off.last_sync)
    assert torch.equal(on.prev_teacher[1], off.prev_teacher[1])
    # a second leg starts a fresh log
    assert len(on.run(1).telemetry) == 1


@pytest.mark.parametrize("label,engine,fused", _engines(), ids=["host", "scan", "fused"])
def test_telemetry_hook_is_applied_in_the_round(label, engine, fused):
    seen = []

    def hook(tel, t):
        seen.append(t)
        return tel._replace(beta=tel.beta * 2.0, cache_hits=tel.cache_hits + t)

    cfg = P.FLConfig(**dict(SCAN_BASE, fused_round=fused))
    eng = engine(cfg, P.STRATEGIES["scarlet"](beta=1.5), cache_duration=1, device="cpu")
    eng.telemetry_hook = hook
    st = eng.run().telemetry.stacks()
    assert seen == [1, 2, 3]
    np.testing.assert_array_equal(st["beta"], np.full(3, 3.0, np.float32))
    plain = engine(cfg, P.STRATEGIES["scarlet"](beta=1.5), cache_duration=1,
                   device="cpu").run().telemetry.stacks()
    np.testing.assert_array_equal(st["cache_hits"], plain["cache_hits"] + np.arange(1, 4))
    assert st["cache_hits"].dtype == np.int32


def test_telemetry_runs_through_run_method_and_the_baselines_refuse_it():
    cfg = P.FLConfig(**dict(CFG, telemetry=False))
    for engine, fused in (("host", False), ("scan", False), ("scan", True)):
        h = P.run_method("scarlet", cfg, engine=engine, fused_round=fused, telemetry=True,
                         cache_duration=2, device="cpu")
        assert len(h.telemetry) == CFG["rounds"]
    for method in ("dsfl", "cfd", "mean", "selective_fd"):
        h = P.run_method(method, cfg, engine="scan", telemetry=True, device="cpu")
        assert h.telemetry.summary()["participants_total"] == CFG["rounds"] * CFG["n_clients"]
    assert P.run_method("comet", cfg, telemetry=True, device="cpu").telemetry is not None
    assert P.run_method("scarlet", cfg, device="cpu").telemetry is None
    for method in ("fedavg", "individual"):
        with pytest.raises(ValueError, match="telemetry"):
            P.run_method(method, cfg, telemetry=True, device="cpu")


def test_outage_round_appends_the_zero_row_on_the_host_loop():
    cfg = P.FLConfig(**dict(SCAN_BASE, rounds=3))
    eng = P.FederatedDistillation(cfg, P.STRATEGIES["scarlet"](beta=1.5), cache_duration=1,
                                  scenario=_scan_scenario(P, "outage"), device="cpu")
    log = eng.run().telemetry
    zero = obs_device.zeros(1)
    row = log._rounds[1]
    for f, z in zip(row, zero):
        np.testing.assert_array_equal(f, z.numpy())
        assert f.dtype == z.numpy().dtype
    assert log.summary()["active_rounds"] == 2
