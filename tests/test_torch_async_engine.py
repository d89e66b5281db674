"""The port's async engine (``engine="async"``) on the CPU against the JAX
package's async engine (its contracts on the port alone, and against the
port's device engine, are in ``tests/test_torch_async_contracts.py``).

Against the reference, the port starts from the reference's initial
parameters (``load_params``) and draws its dispatches from the reference's
key stream: round ``t``'s ``fold_in(_key_rounds, t)``, split, and
``participation_mask_device(k_part, blocked)`` with the round's blocked
clients (offline, unreachable or in flight), which the port's
``run(draws=...)`` hands the callable round by round.  Every cell holds the
port to the bands of ``tests/test_torch_scan_engine.py``: per-round ledgers
equal to the reference's float32 values; cache timestamps, presence,
``last_sync`` and the flight state equal; cache values to atol 1e-5, 5e-3
under a lossy codec (one 8-bit level); parameters to atol 1e-4; accuracies
within one test sample.  The staleness weights are float32 ``pow`` on both
sides: at decay 0.5 they are exact powers of two.

Mean and DS-FL under decay: the reference divides the weighted sum by
``max(sum w, 1)``, so a round whose arrivals' weights sum below 1 gets a
teacher of mass ``sum w``; the port divides by ``sum w`` where it is
positive (ROADMAP Queue C).  Those cells are held against the reference's
strategy with the port's divisor (``_repaired``), and
``test_weighted_mean_divisor_differs_from_reference_below_unit_mass`` pins
both values.  SCARLET's sharpening renormalises, so its cells are held
against the reference as it is.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.checkpoint as RC
import repro.fl as R
import repro_torch.fl as P
from repro.fl.async_engine import AsyncFederatedDistillation as RAsync
from repro_torch.checkpoint import load_pytree, save_pytree

A = P.AsyncFederatedDistillation

BASE = dict(n_clients=6, n_classes=5, dim=8, rounds=6, local_steps=2, distill_steps=2,
            public_size=60, public_per_round=16, private_size=120, hidden=12,
            eval_every=2, alpha=0.5)
CODECS = ("identity", "quant8", "cache_delta+quant8")
CACHE_D = {"scarlet": 2}


def _traffic(lib, name):
    """``default``: the synchronous model; ``poisson``: rate 1.5 a tick
    (reachable with p = 0.777), 0-2 windows of latency, decay 0.5;
    ``fixed2``: every report two windows late."""
    if name == "default":
        return lib.TrafficModel()
    if name == "poisson":
        return lib.TrafficModel(arrivals=lib.ArrivalProcess("poisson", rate=1.5),
                                latency=lib.LatencyModel("uniform", lo=0, hi=2), seed=3)
    return lib.TrafficModel(latency=lib.LatencyModel("fixed", ticks=2))


DECAY = {"default": 1.0, "poisson": 0.5, "fixed2": 1.0}


def _ledger(h):
    return [(r.uplink, r.downlink) for r in h.ledger.rounds]


def _params_np(params):
    return {k: np.array(v) for k, v in params.items()}


def reference_draws(ref):
    """The reference async engine's dispatch draw, as ``run(draws=...)``
    takes it."""
    c = ref.cfg

    def draw(t, blocked):
        k_idx, k_part = jax.random.split(jax.random.fold_in(ref._key_rounds, t))
        idx = np.asarray(jnp.sort(jax.random.choice(
            k_idx, c.public_size, (c.public_per_round,), replace=False)))
        part = np.asarray(ref.scenario.participation_mask_device(k_part, jnp.asarray(blocked)))
        return part, idx

    return draw


def _repaired(name, **kw):
    """The reference's strategy with the port's weighted-mean divisor: the
    moments are normalised by ``sum w`` where positive and handed to the
    reference's own finalize with unit weight (a division by 1.0, exact)."""
    class Repaired(type(R.STRATEGIES[name]())):
        def finalize_aggregate(self, partials, t):
            w = partials["wsum"]
            zbar = partials["zsum"] / jnp.where(w > 0, w, 1.0)
            return super().finalize_aggregate({"zsum": zbar, "wsum": jnp.float32(1.0)}, t)

    return Repaired(**kw)


def _hold_reference(method, codec, traffic, fused=False):
    cfg = dict(BASE, uplink_codec=codec, fused_round=fused)
    skw = dict({"beta": 1.5} if method == "scarlet" else {},
               staleness_decay=DECAY[traffic])
    rstrat = (_repaired(method, **skw) if method in ("mean", "dsfl")
              else R.STRATEGIES[method](**skw))
    D = CACHE_D.get(method, 0)
    ref = RAsync(R.FLConfig(**cfg), rstrat, cache_duration=D, traffic=_traffic(R, traffic))
    port = A(P.FLConfig(**cfg), P.STRATEGIES[method](**skw), cache_duration=D,
             traffic=_traffic(P, traffic), device="cpu")
    port.load_params([_params_np(p) for p in ref.client_params], _params_np(ref.server_params))
    rh = ref.run()
    ph = port.run(draws=reference_draws(ref))

    assert _ledger(ph) == _ledger(rh)
    assert ph.rounds == rh.rounds and ph.cumulative_mb == rh.cumulative_mb
    lossy = "quant" in codec
    np.testing.assert_array_equal(port.cache_g.ts.numpy(), np.asarray(ref.cache_g.ts))
    np.testing.assert_array_equal(port.cache_g.present.numpy(), np.asarray(ref.cache_g.present))
    np.testing.assert_allclose(port.cache_g.values.numpy(), np.asarray(ref.cache_g.values),
                               rtol=0, atol=5e-3 if lossy else 1e-5)
    np.testing.assert_array_equal(port.last_sync, np.asarray(ref.last_sync))
    np.testing.assert_array_equal(port.in_flight, ref.in_flight)
    np.testing.assert_array_equal(port.flight_arrival, ref.flight_arrival)
    np.testing.assert_array_equal(port.flight_nreq.numpy(), ref.flight_nreq)
    for k, v in ref.server_params.items():
        np.testing.assert_allclose(port.server_params[k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-4)
    for k, v in ref.client_params[0].items():
        np.testing.assert_allclose(port.client_params[0][k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-4)
    one = 1.0 / len(ref.y_test)
    np.testing.assert_allclose(ph.server_acc, rh.server_acc, rtol=0, atol=one)
    np.testing.assert_allclose(ph.client_acc, rh.client_acc, rtol=0, atol=one)
    np.testing.assert_allclose(ph.server_val_loss, rh.server_val_loss, rtol=1e-4)
    np.testing.assert_allclose(ph.client_val_loss, rh.client_val_loss, rtol=1e-4)
    return port, ph


CELLS = ([(m, c, tr, False) for m in ("scarlet", "dsfl", "mean") for c in CODECS
          for tr in ("default", "poisson", "fixed2")]
         + [("scarlet", "cache_delta+quant8", "poisson", True),
            ("scarlet", "identity", "fixed2", True)])


@pytest.mark.parametrize("method,codec,traffic,fused", CELLS)
def test_async_engine_matches_reference(method, codec, traffic, fused):
    port, ph = _hold_reference(method, codec, traffic, fused)
    up = [u for u, _ in _ledger(ph)]
    if traffic == "fixed2":  # dispatch, in flight, arrive, ...
        assert up[0] == up[1] == up[3] == up[4] == 0.0 and up[2] > 0 and up[5] > 0
    if traffic == "poisson":  # reports in flight at some point, some arrive late
        assert port.last_plan.dispatch.sum() > port.last_plan.arrive[
            port.last_plan.dispatch].sum()


def test_checkpoint_moves_between_the_packages(tmp_path):
    """The reference's npz (flight state included) restores into the port,
    and the port's into the reference."""
    cfg = dict(BASE, uplink_codec="cache_delta+quant8")
    ref = RAsync(R.FLConfig(**cfg), R.STRATEGIES["scarlet"](beta=1.5), cache_duration=2,
                 traffic=_traffic(R, "fixed2"))
    ref.run(4)
    path = os.path.join(tmp_path, "ref.npz")
    RC.save_pytree(path, ref.state_dict())
    port = A(P.FLConfig(**cfg), P.STRATEGIES["scarlet"](beta=1.5), cache_duration=2,
             traffic=_traffic(P, "fixed2"), device="cpu")
    port.load_state_dict(load_pytree(path, port.state_dict()))
    assert port.t_done == 4 and port.in_flight.all()
    np.testing.assert_array_equal(port.flight_arrival, ref.flight_arrival)
    np.testing.assert_array_equal(port.flight_nreq.numpy(), ref.flight_nreq)
    port_path = os.path.join(tmp_path, "port.npz")
    save_pytree(port_path, port.state_dict())
    back = RC.load_pytree(port_path, ref.state_dict())
    for key in ("in_flight", "flight_arrival", "flight_nreq", "last_sync"):
        np.testing.assert_array_equal(np.asarray(back[key]), np.asarray(ref.state_dict()[key]))
        assert np.asarray(back[key]).dtype == np.asarray(ref.state_dict()[key]).dtype


def test_traffic_on_other_engines_raises():
    for engine in ("host", "scan", "active"):
        with pytest.raises(ValueError) as got:
            P.run_method("scarlet", P.FLConfig(**BASE), engine=engine,
                         traffic=P.TrafficModel(), device="cpu")
        with pytest.raises(ValueError) as want:
            R.run_method("scarlet", R.FLConfig(**BASE), engine=engine,
                         traffic=R.TrafficModel())
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The weighted mean's divisor under decay (a reference fault not copied)
# ---------------------------------------------------------------------------

def test_weighted_mean_divisor_differs_from_reference_below_unit_mass():
    """One report two rounds late at decay 0.5 weighs 0.25: the reference's
    mean teacher has mass 0.25, the port's is the report itself.  At 0/1
    weights, or a weight sum of at least 1, the two divisors agree bit for
    bit."""
    rng = np.random.default_rng(0)
    z = rng.dirichlet(np.ones(5), size=(4, 7)).astype(np.float32)
    for w, port_mass, ref_mass in (([0.25, 0, 0, 0], 1.0, 0.25), ([0.5, 0.25, 0, 0], 1.0, 0.75),
                                   ([1, 0, 1, 0], 1.0, 1.0), ([0.5, 0.5, 0.5, 0], 1.0, 1.0)):
        w = np.asarray(w, np.float32)
        got = P.STRATEGIES["mean"]().aggregate_masked(torch.from_numpy(z), torch.from_numpy(w),
                                                      None, 1).numpy()
        want = np.asarray(R.STRATEGIES["mean"]().aggregate_masked(jnp.asarray(z), jnp.asarray(w),
                                                                  None, 1))
        np.testing.assert_allclose(got.sum(-1), port_mass, rtol=1e-6)
        np.testing.assert_allclose(want.sum(-1), ref_mass, rtol=1e-6)
        if w.sum() >= 1:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want / w.sum(), rtol=1e-6)
    # DS-FL: the temperature softmax of a short vector is flatter
    w = np.asarray([0.25, 0, 0, 0], np.float32)
    got = P.STRATEGIES["dsfl"]().aggregate_masked(torch.from_numpy(z), torch.from_numpy(w),
                                                  None, 1).numpy()
    want = np.asarray(R.STRATEGIES["dsfl"]().aggregate_masked(jnp.asarray(z), jnp.asarray(w),
                                                              None, 1))
    assert got.max(-1).mean() > want.max(-1).mean()
    # SCARLET renormalises: the two agree to float rounding
    for name, kw in (("scarlet", {"beta": 1.5}),):
        got = P.STRATEGIES[name](**kw).aggregate_masked(torch.from_numpy(z), torch.from_numpy(w),
                                                        None, 1).numpy()
        want = np.asarray(R.STRATEGIES[name](**kw).aggregate_masked(jnp.asarray(z),
                                                                    jnp.asarray(w), None, 1))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_mean_teacher_mass_in_a_run():
    """K = 2 under a fixed two-window latency at decay 0.5: every arrival
    weighs 0.25, so the reference caches rows of mass 0.5 and the port rows
    of mass 1, in the same run."""
    cfg = dict(BASE, n_clients=2, private_size=40, rounds=3)
    tr = "fixed2"
    ref = RAsync(R.FLConfig(**cfg), R.STRATEGIES["mean"](staleness_decay=0.5),
                 cache_duration=2, use_cache=True, traffic=_traffic(R, tr))
    port = A(P.FLConfig(**cfg), P.STRATEGIES["mean"](staleness_decay=0.5), cache_duration=2,
             use_cache=True, traffic=_traffic(P, tr), device="cpu")
    port.load_params([_params_np(p) for p in ref.client_params], _params_np(ref.server_params))
    rh, ph = ref.run(), port.run(draws=reference_draws(ref))
    assert _ledger(ph) == _ledger(rh)
    present = np.asarray(ref.cache_g.present)
    assert present.any()
    np.testing.assert_allclose(np.asarray(ref.cache_g.values)[present].sum(-1), 0.5, rtol=1e-6)
    np.testing.assert_allclose(port.cache_g.values.numpy()[present].sum(-1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(port.cache_g.values.numpy()[present],
                               np.asarray(ref.cache_g.values)[present] * 2.0, rtol=0, atol=1e-6)
