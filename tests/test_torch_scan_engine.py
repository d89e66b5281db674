"""The port's device-resident engine (``engine="scan"``) against the JAX
package's scan engine, and against the port's own host loop, on the CPU.

Against the reference, the port starts from the reference's initial
parameters and runs on the reference's jax-stream draws: the reference's
``_draw_round(t)`` under ``rng_backend="jax"`` is exactly what its scan
engine draws (``repro/fl/scan_engine.py:14-19``), and the port's
``run(draws=...)`` takes those stacks.  Every cell holds the port to:

- per-round uplink/downlink equal to the reference's float32 values (the
  ledger is float32 arithmetic on integer counts, in the same order);
- equal History rounds, cache timestamps, presence and ``last_sync``;
- cache values to atol 1e-5 (float32 predictions, averaged and sharpened
  in other orders over a few rounds), 5e-3 for lossy codecs: a rounding
  difference that lands on a tie of the 8-bit code moves one value by a
  level, the one-step band of the reference's own conformance suite
  (``tests/test_engine_conformance.py:239``);
- server and client parameters to atol 1e-4 (float32 SGD steps on the
  same gradients, rounding drift only);
- accuracies within one test sample, proxy validation losses to rtol 1e-4.

Against the host loop, the two port engines run the same numpy draws:
ledgers to rtol 1e-7 (float32 on the device, float64 on the host; every
count here is an exact integer in both), caches as above.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.fl as R
import repro_torch.fl as P
from repro.fl.scan_engine import ScannedFederatedDistillation as RScan
from repro_torch.compress.codecs import IdentityCodec
from repro_torch.fl.strategies.base import Strategy
from repro_torch.kernels import ops

BASE = dict(n_clients=6, n_classes=5, dim=8, rounds=3, local_steps=3,
            distill_steps=3, public_size=60, public_per_round=24,
            private_size=120, hidden=16, eval_every=1, alpha=0.5)
CODECS = ("identity", "quant8", "cache_delta+quant8")
SCENARIOS = ("full", "half", "outage")


def _scenario(lib, name):
    """``full``: every client; ``half``: a fixed half each round (catch-up
    packages for returning stragglers); ``outage``: half, with every client
    offline in round 2, a round with no participant."""
    K = BASE["n_clients"]
    if name == "full":
        return lib.Scenario()
    outages = (tuple(lib.Outage(k, 2, 2) for k in range(K))
               if name == "outage" else ())
    return lib.Scenario(participation=lib.fixed_fraction(0.5), outages=outages)


def _params_np(params):
    return {k: np.array(v) for k, v in params.items()}


def _ledger(hist):
    return [(r.uplink, r.downlink) for r in hist.ledger.rounds]


def _assert_cache_close(a, b_ts, b_present, b_values, atol):
    np.testing.assert_array_equal(a.ts.numpy(), b_ts)
    np.testing.assert_array_equal(a.present.numpy(), b_present)
    np.testing.assert_allclose(a.values.numpy(), b_values, rtol=0, atol=atol)


CELLS = ([("scarlet", codec, scen, fused) for codec in CODECS
          for scen in SCENARIOS for fused in (False, True)]
         + [("dsfl", "identity", "full", False)]
         + [(method, "identity", scen, False)
            for method in ("cfd", "mean", "selective_fd") for scen in SCENARIOS]
         + [("scarlet", "cache_delta+topk2", "full", False)])


@pytest.mark.parametrize("method,codec,scen,fused", CELLS)
def test_device_engine_matches_reference_scan(method, codec, scen, fused):
    _hold_device_engine(method, codec, scen, fused,
                        {"beta": 1.5} if method == "scarlet" else {})


@pytest.mark.parametrize("scen", ["half", "outage"])
def test_selective_fd_mask_under_partial_participation(scen):
    """At tau 0.25 the gate withholds uploads of the half that takes part
    (at the default tau these clients upload everything), so the mask
    meets the participation weights in the ledger and the aggregate."""
    rh = _hold_device_engine("selective_fd", "identity", scen, False, {"tau_client": 0.25})
    K, m, N = BASE["n_clients"], BASE["public_per_round"], BASE["n_classes"]
    assert _ledger(rh)[0][0] < K // 2 * m * N * 4.0


def _hold_device_engine(method, codec, scen, fused, skw):
    cfg = dict(BASE, uplink_codec=codec, fused_round=fused)
    D = 1 if method == "scarlet" else 0  # D=1: entries expire within 3 rounds
    ref = RScan(R.FLConfig(**cfg), R.STRATEGIES[method](**skw), cache_duration=D,
                scenario=_scenario(R, scen))
    port = P.ScannedFederatedDistillation(P.FLConfig(**cfg), P.STRATEGIES[method](**skw),
                                          cache_duration=D,
                                          scenario=_scenario(P, scen), device="cpu")
    port.load_params([_params_np(p) for p in ref.client_params],
                     _params_np(ref.server_params))
    draws = [ref._draw_round(t) for t in range(1, BASE["rounds"] + 1)]
    part = np.stack([p for p, _ in draws])
    idx = np.stack([i for _, i in draws])
    rh = ref.run()
    ph = port.run(draws=(part, idx))

    assert _ledger(ph) == _ledger(rh)
    assert ph.ledger.summary() == rh.ledger.summary()
    assert ph.rounds == rh.rounds
    assert ph.cumulative_mb == rh.cumulative_mb
    if scen == "outage":
        assert _ledger(ph)[1] == (0.0, 0.0)
    lossy = "quant" in codec
    _assert_cache_close(port.cache_g, np.asarray(ref.cache_g.ts),
                        np.asarray(ref.cache_g.present),
                        np.asarray(ref.cache_g.values), 5e-3 if lossy else 1e-5)
    np.testing.assert_array_equal(port.last_sync, np.asarray(ref.last_sync))
    if method == "scarlet":
        assert bool(np.asarray(ref.cache_g.present).any())

    for k, v in ref.server_params.items():
        np.testing.assert_allclose(port.server_params[k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-4)
    for k, v in ref.client_params[0].items():
        np.testing.assert_allclose(port.client_params[0][k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-4)
    one_sample = 1.0 / len(ref.y_test)
    np.testing.assert_allclose(ph.server_acc, rh.server_acc, rtol=0, atol=one_sample)
    np.testing.assert_allclose(ph.client_acc, rh.client_acc, rtol=0, atol=one_sample)
    assert len(ph.server_val_loss) == len(rh.server_val_loss)
    np.testing.assert_allclose(ph.server_val_loss, rh.server_val_loss, rtol=1e-4)
    np.testing.assert_allclose(ph.client_val_loss, rh.client_val_loss, rtol=1e-4)
    return rh


AGREE = [("scarlet", codec, scen, fused) for codec in CODECS
         for scen in ("half", "outage") for fused in (False, True)]
AGREE += [("dsfl", "identity", "half", False), ("cfd", "identity", "half", False),
          ("selective_fd", "identity", "half", False)]


@pytest.mark.parametrize("method,codec,scen,fused", AGREE)
def test_device_engine_agrees_with_host_loop(method, codec, scen, fused):
    cfg = P.FLConfig(**BASE, uplink_codec=codec, fused_round=fused)
    skw = {"beta": 1.5} if method == "scarlet" else {}
    D = 1 if method == "scarlet" else 0
    runs = []
    for engine in (P.FederatedDistillation, P.ScannedFederatedDistillation):
        eng = engine(cfg, P.STRATEGIES[method](**skw), cache_duration=D,
                     scenario=_scenario(P, scen), device="cpu")
        runs.append((eng, eng.run()))
    (host, hh), (dev, dh) = runs
    np.testing.assert_allclose(np.array(_ledger(dh)), np.array(_ledger(hh)),
                               rtol=1e-7, atol=0)
    assert dh.rounds == hh.rounds
    lossy = "quant" in codec
    c = host.cache_g
    _assert_cache_close(dev.cache_g, c.ts.numpy(), c.present.numpy(),
                        c.values.numpy(), 5e-3 if lossy else 1e-5)
    np.testing.assert_array_equal(dev.last_sync, host.last_sync)
    for k, v in host.server_params.items():
        np.testing.assert_allclose(dev.server_params[k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-4)
    one_sample = 1.0 / len(host.y_test)
    np.testing.assert_allclose(dh.server_acc, hh.server_acc, rtol=0, atol=one_sample)
    np.testing.assert_allclose(dh.client_acc, hh.client_acc, rtol=0, atol=one_sample)


def test_split_runs_equal_one_run():
    cfg = P.FLConfig(**BASE, uplink_codec="cache_delta+quant8", fused_round=True)

    def make():
        return P.ScannedFederatedDistillation(
            cfg, P.STRATEGIES["scarlet"](beta=1.5), cache_duration=1,
            scenario=_scenario(P, "outage"), device="cpu")

    a, b = make(), make()
    h1, h2 = a.run(1), a.run(2)
    hb = b.run(3)
    assert (h1.rounds, h2.rounds, a.t_done) == ([1], [2, 3], 3)
    assert _ledger(h1) + _ledger(h2) == _ledger(hb)
    assert h1.server_acc + h2.server_acc == hb.server_acc
    for x, y in [(a.cache_g.values, b.cache_g.values), (a.cache_g.ts, b.cache_g.ts),
                 (a.cache_g.present, b.cache_g.present)]:
        assert torch.equal(x, y)
    np.testing.assert_array_equal(a.last_sync, b.last_sync)
    for k in a.server_params:
        assert torch.equal(a.server_params[k], b.server_params[k])
        assert torch.equal(a.client_params[0][k], b.client_params[0][k])
    empty = a.run(0)
    assert empty.ledger.summary()["rounds"] == 0.0
    assert empty.final_server_acc is None and a.t_done == 3


@pytest.mark.parametrize("fused", [True, False])
def test_round_runs_one_aggregation_kernel_path(monkeypatch, fused):
    """The CPU counterpart of the card's launch counts: the fused engine
    calls ``fused_round`` once a round and neither per-op kernel; the
    per-op engine calls the qdq and ERA wrappers once a round each.  A
    total-outage round still aggregates (fixed shapes, gated result)."""
    calls = {name: 0 for name in ("enhanced_era_fused", "quantize_dequantize",
                                  "fused_round")}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    cfg = P.FLConfig(**BASE, uplink_codec="cache_delta+quant8", fused_round=fused)
    h = P.run_method("scarlet", cfg, engine="scan", cache_duration=1, beta=1.5,
                     scenario=_scenario(P, "outage"), device="cpu")
    n = BASE["rounds"]
    assert calls == ({"enhanced_era_fused": 0, "quantize_dequantize": 0, "fused_round": n}
                     if fused else
                     {"enhanced_era_fused": n, "quantize_dequantize": n, "fused_round": 0})
    assert _ledger(h)[1] == (0.0, 0.0)


def test_run_method_passes_fused_round_through():
    cfg = P.FLConfig(**BASE, uplink_codec="quant8")
    h = P.run_method("scarlet", cfg, engine="scan", fused_round=True, cache_duration=1,
                     beta=1.5, device="cpu")
    eng = P.ScannedFederatedDistillation(dataclasses.replace(cfg, fused_round=True),
                                         P.STRATEGIES["scarlet"](beta=1.5),
                                         cache_duration=1, device="cpu")
    h2 = eng.run()
    assert _ledger(h) == _ledger(h2)
    assert h.server_acc == h2.server_acc


class _HostStrategy(Strategy):
    name = "host_only"


class _HostCodec(IdentityCodec):
    name = "host_codec"
    scan_safe = False


def test_constructor_rejects_what_the_engine_cannot_run():
    cfg = P.FLConfig(**BASE)
    S = P.ScannedFederatedDistillation
    scarlet = P.STRATEGIES["scarlet"]
    with pytest.raises(ValueError, match="scan-safe"):
        S(cfg, _HostStrategy(), device="cpu")
    with pytest.raises(ValueError, match="scan-safe"):
        S(dataclasses.replace(cfg, uplink_codec=_HostCodec()), scarlet(), device="cpu")
    with pytest.raises(ValueError, match="adaptive"):
        S(dataclasses.replace(cfg, fused_round=True), scarlet(beta="adaptive"),
          device="cpu")
    with pytest.raises(ValueError, match="no kernel form"):
        S(dataclasses.replace(cfg, fused_round=True,
                              uplink_codec="cache_delta+cache_delta"),
          scarlet(), device="cpu")
    with pytest.raises(ValueError, match="fused round path"):
        S(dataclasses.replace(cfg, fused_round=True), P.STRATEGIES["dsfl"](),
          device="cpu")
    with pytest.raises(ValueError, match="track_local_caches"):
        S(cfg, scarlet(), track_local_caches=True, device="cpu")
    with pytest.raises(NotImplementedError):
        S(cfg, scarlet(), device="cpu", rng_backend="jax")
    # telemetry is ported: a telemetry-on engine builds and runs a round
    h = S(dataclasses.replace(cfg, telemetry=True), scarlet(), cache_duration=1,
          device="cpu").run(1)
    assert len(h.telemetry) == 1 and h.telemetry.summary()["participants_total"] == 6
    # the per-op path runs adaptive beta and a codec with no kernel form
    h = S(dataclasses.replace(cfg, uplink_codec="cache_delta+cache_delta"),
          scarlet(beta="adaptive"), cache_duration=1, device="cpu").run(1)
    assert h.ledger.summary()["rounds"] == 1.0


@pytest.mark.parametrize("lib", ["reference", "port"])
def test_comet_and_a_fused_topk_uplink_are_refused(lib):
    """COMET (host numpy k-means) is not scan-safe, and top-k has no form
    in the fused round kernel: both engines refuse them with ValueError."""
    if lib == "reference":
        L, S, kw = R, RScan, {}
    else:
        L, S, kw = P, P.ScannedFederatedDistillation, {"device": "cpu"}
    cfg = L.FLConfig(**BASE)
    with pytest.raises(ValueError, match="not scan-safe"):
        S(cfg, L.STRATEGIES["comet"](), **kw)
    with pytest.raises(ValueError, match="cache_delta\\+topk2"):
        S(dataclasses.replace(cfg, fused_round=True, uplink_codec="cache_delta+topk2"),
          L.STRATEGIES["scarlet"](), **kw)
    if lib == "port":
        with pytest.raises(ValueError, match="not scan-safe"):
            P.run_method("comet", cfg, engine="scan", device="cpu")


def test_injected_draws_are_checked():
    eng = P.ScannedFederatedDistillation(P.FLConfig(**BASE), P.STRATEGIES["scarlet"](),
                                         scenario=_scenario(P, "outage"), device="cpu")
    K, m = BASE["n_clients"], BASE["public_per_round"]
    part = np.ones((2, K), bool)
    idx = np.tile(np.arange(m), (2, 1))
    with pytest.raises(ValueError, match=r"\(2, 6\)"):
        eng.run(2, draws=(part[:1], idx))
    with pytest.raises(ValueError, match="offline"):
        eng.run(2, draws=(part, idx))  # every client is offline in round 2
    part[1] = False
    bad = idx.copy()
    bad[0, 1] = bad[0, 0]
    with pytest.raises(ValueError, match="distinct"):
        eng.run(2, draws=(part, bad))
    bad[0, 1] = BASE["public_size"]
    with pytest.raises(ValueError, match="distinct"):
        eng.run(2, draws=(part, bad))
    h = eng.run(2, draws=(part, idx))
    assert _ledger(h)[1] == (0.0, 0.0) and eng.t_done == 2


def test_device_engine_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = P.FLConfig(**BASE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.run_method("scarlet", cfg, engine="scan", cache_duration=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.ScannedFederatedDistillation(cfg, P.STRATEGIES["scarlet"]())
