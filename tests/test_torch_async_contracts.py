"""The port's async engine (``engine="async"``) on the CPU against the
port's own device engine, and the reference's traffic contracts
(``tests/test_traffic.py``) run on the port; the cells against the JAX
package's async engine are in ``tests/test_torch_async_engine.py``.

Under zero delay everywhere (the default traffic model, or a window wider
than every latency) the async engine draws what the device engine draws
and must equal it bit for bit: ledger, caches, parameters, accuracies and
telemetry.  Under real delay the contracts are the reference's: a fixed
delay alternates dispatch and arrival rounds, staleness decay never moves
a byte, the staleness histogram's buckets are the reports' delays, split
runs equal unsplit ones with reports in flight (through ``state_dict``
and the npz checkpoint), and no client in flight is dispatched again.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import repro_torch.fl as P
from repro_torch.checkpoint import load_pytree, save_pytree

A = P.AsyncFederatedDistillation

BASE = dict(n_clients=6, n_classes=5, dim=8, rounds=6, local_steps=2, distill_steps=2,
            public_size=60, public_per_round=16, private_size=120, hidden=12,
            eval_every=2, alpha=0.5)
CACHE_D = {"scarlet": 2}


def _ledger(h):
    return [(r.uplink, r.downlink) for r in h.ledger.rounds]


# ---------------------------------------------------------------------------
# The device engine under the synchronous regime
# ---------------------------------------------------------------------------

def _build(engine, cfg=None, traffic=None, method="scarlet", scenario=None, **skw):
    cfg = cfg or P.FLConfig(**BASE, uplink_codec="cache_delta+quant8")
    kw = {} if traffic is None else {"traffic": traffic}
    eng = engine(cfg, P.STRATEGIES[method](**dict({"beta": 1.5} if method == "scarlet" else {},
                                                  **skw)),
                 cache_duration=CACHE_D.get(method, 0), scenario=scenario, device="cpu", **kw)
    return eng, eng.run()


def _state_equal(a, b):
    assert torch.equal(a.cache_g.values, b.cache_g.values)
    assert torch.equal(a.cache_g.ts, b.cache_g.ts)
    np.testing.assert_array_equal(a.last_sync, b.last_sync)
    for pa, pb in zip(a.client_params, b.client_params):
        for k in pa:
            assert torch.equal(pa[k], pb[k])
    for k in a.server_params:
        assert torch.equal(a.server_params[k], b.server_params[k])


SYNC_TRAFFIC = {"default": None,
                "wide-window": P.TrafficModel(latency=P.LatencyModel("uniform", lo=0, hi=3),
                                              window_ticks=4, seed=1)}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("traffic", sorted(SYNC_TRAFFIC))
@pytest.mark.parametrize("scen", ["full", "half-outage"])
def test_synchronous_traffic_equals_device_engine(fused, traffic, scen):
    """Zero delay everywhere: the same numpy draws, and the ledger, caches,
    parameters and accuracies equal the device engine's bit for bit."""
    scenario = (None if scen == "full" else
                P.Scenario(participation=P.fixed_fraction(0.5),
                           outages=tuple(P.Outage(k, 3, 3) for k in range(6))))
    cfg = P.FLConfig(**BASE, uplink_codec="cache_delta+quant8", fused_round=fused,
                     telemetry=True)
    if SYNC_TRAFFIC[traffic] is not None:
        assert SYNC_TRAFFIC[traffic].is_synchronous
    a, ha = _build(A, cfg, SYNC_TRAFFIC[traffic], scenario=scenario)
    s, hs = _build(P.ScannedFederatedDistillation, cfg, scenario=scenario)
    assert _ledger(ha) == _ledger(hs)
    assert ha.server_acc == hs.server_acc and ha.client_acc == hs.client_acc
    assert ha.server_val_loss == hs.server_val_loss
    _state_equal(a, s)
    for f, v in ha.telemetry.stacks().items():
        np.testing.assert_array_equal(v, hs.telemetry.stacks()[f])
    if scen == "half-outage":
        assert _ledger(ha)[2] == (0.0, 0.0)


@pytest.mark.parametrize("method", ["dsfl", "mean", "cfd", "selective_fd"])
def test_other_methods_equal_device_engine_at_zero_delay(method):
    a, ha = _build(A, P.FLConfig(**BASE), method=method)
    s, hs = _build(P.ScannedFederatedDistillation, P.FLConfig(**BASE), method=method)
    assert _ledger(ha) == _ledger(hs)
    _state_equal(a, s)


# ---------------------------------------------------------------------------
# The reference's traffic contracts (tests/test_traffic.py), on the port
# ---------------------------------------------------------------------------

POISSON = P.TrafficModel(arrivals=P.ArrivalProcess("poisson", rate=1.5),
                         latency=P.LatencyModel("uniform", lo=0, hi=2), seed=7)


def test_fixed_delay_alternates_dispatch_and_arrival():
    _, h = _build(A, traffic=P.TrafficModel(latency=P.LatencyModel("fixed", ticks=1)))
    up = [u for u, _ in _ledger(h)]
    assert up[0] == up[2] == up[4] == 0.0 and min(up[1], up[3], up[5]) > 0.0
    assert np.isfinite(h.final_server_acc)


@pytest.mark.parametrize("method", ["scarlet", "dsfl", "mean", "cfd"])
def test_staleness_decay_never_changes_the_ledger(method):
    """The weights reach the teacher and the parameters, never a byte count
    (Selective-FD is left out: its uploads follow the clients' confidence,
    which the teacher moves)."""
    unit = _build(A, traffic=POISSON, method=method, staleness_decay=1.0)
    decayed = _build(A, traffic=POISSON, method=method, staleness_decay=0.5)
    assert _ledger(unit[1]) == _ledger(decayed[1])
    np.testing.assert_array_equal(unit[0].last_plan.arrive, decayed[0].last_plan.arrive)
    assert not torch.equal(unit[0].server_params["w0"], decayed[0].server_params["w0"])


def test_staleness_histogram_buckets_equal_delay():
    cfg = P.FLConfig(**dict(BASE, rounds=9), uplink_codec="cache_delta+quant8", telemetry=True)
    _, h = _build(A, cfg, P.TrafficModel(latency=P.LatencyModel("fixed", ticks=2)))
    hist = np.asarray(h.telemetry.summary()["staleness_hist"])
    assert hist[2] > 0 and hist.sum() == hist[2] == 3 * 6
    rows = h.telemetry.stacks()
    # rounds with no arrival record the zero row
    for i in (0, 1, 3, 4, 6, 7):
        assert all(not np.any(v[i]) for v in rows.values())
    assert h.ledger.rounds[2].uplink == rows["uplink_bytes"][2]


def test_telemetry_buckets_follow_the_planned_flight():
    """Under Poisson traffic the histogram of every arrival round equals a
    host replay from the plan: ``t - 1 - last_sync`` before the round, the
    delay for a report that was in flight."""
    cfg = P.FLConfig(**dict(BASE, rounds=8), uplink_codec="cache_delta+quant8", telemetry=True)
    eng, h = _build(A, cfg, POISSON)
    plan = eng.last_plan
    ls = np.zeros(6, np.int64)
    dispatched_at = np.zeros(6, np.int64)
    hist = h.telemetry.stacks()["staleness_hist"]
    late = 0
    for i, t in enumerate(range(1, 9)):
        d, a = plan.dispatch[i], plan.arrive[i]
        want = np.zeros(hist.shape[1], np.int64)
        for k in np.nonzero(a)[0]:
            lag = t - 1 - ls[k]
            if not d[k]:  # in flight: the lag is the delay
                assert lag == t - dispatched_at[k]
                late += 1
            want[min(lag, hist.shape[1] - 1)] += 1
        np.testing.assert_array_equal(hist[i], want)
        dispatched_at[d] = t
        ls[d] = t - 1
        ls[a] = t
    assert late > 0
    np.testing.assert_array_equal(eng.last_sync, ls)


def test_split_runs_match_unsplit_with_reports_in_flight(tmp_path):
    cfg = P.FLConfig(**BASE, uplink_codec="cache_delta+quant8", fused_round=True)
    full, hf = _build(A, cfg, POISSON, staleness_decay=0.5)

    def make():
        return A(cfg, P.STRATEGIES["scarlet"](beta=1.5, staleness_decay=0.5),
                 cache_duration=2, traffic=POISSON, device="cpu")

    chained = make()
    h1 = chained.run(3)
    assert chained.in_flight.any()  # the split falls with reports in flight
    first = make()
    first.run(3)
    path = os.path.join(tmp_path, "async.npz")
    save_pytree(path, first.state_dict())
    by_dict, by_file = make(), make()
    by_dict.load_state_dict(first.state_dict())
    by_file.load_state_dict(load_pytree(path, by_file.state_dict()))
    for eng in (chained, by_dict, by_file):
        h2 = eng.run(3)
        assert _ledger(h1) + _ledger(h2) == _ledger(hf)
        assert h2.server_acc == hf.server_acc[1:]
        _state_equal(eng, full)
        np.testing.assert_array_equal(eng.in_flight, full.in_flight)
        np.testing.assert_array_equal(eng.flight_arrival, full.flight_arrival)
        assert torch.equal(eng.flight_nreq, full.flight_nreq)
    state = first.state_dict()
    assert (state["in_flight"].dtype, state["flight_arrival"].dtype,
            state["flight_nreq"].dtype) == (torch.bool, torch.int32, torch.float32)


def test_in_flight_clients_are_never_redispatched():
    eng, h = _build(A, traffic=P.TrafficModel(latency=P.LatencyModel("fixed", ticks=2)))
    up = [u for u, _ in _ledger(h)]
    assert up[0] == up[1] == 0.0 and up[2] > 0 and up[3] == up[4] == 0.0 and up[5] > 0
    assert not eng.in_flight.any()
    eng, _ = _build(A, P.FLConfig(**dict(BASE, rounds=12)), POISSON)
    plan, busy, due = eng.last_plan, np.zeros(6, bool), np.zeros(6, np.int64)
    for i, t in enumerate(range(1, 13)):
        assert not (plan.dispatch[i] & busy).any()
        assert not (plan.dispatch[i] & ~plan.available[i]).any()
        arrive = (busy & (due == t)) | (plan.dispatch[i] & (plan.delay[i] == 0))
        np.testing.assert_array_equal(plan.arrive[i], arrive)
        busy = (busy & ~arrive) | (plan.dispatch[i] & (plan.delay[i] > 0))
        due = np.where(plan.dispatch[i], t + plan.delay[i], due)


def test_draws_that_dispatch_a_blocked_client_raise():
    eng = A(P.FLConfig(**BASE), P.STRATEGIES["mean"](), traffic=P.TrafficModel(
        latency=P.LatencyModel("fixed", ticks=1)), device="cpu")
    idx = np.arange(BASE["public_per_round"])
    with pytest.raises(ValueError, match="blocked clients"):
        eng.run(2, draws=lambda t, blocked: (np.ones(6, bool), idx))
    h = eng.run(2, draws=lambda t, blocked: (~blocked, idx))
    assert eng.t_done == 2 and _ledger(h)[0][0] == 0.0 < _ledger(h)[1][0]


@pytest.mark.parametrize("method", ["scarlet", "dsfl", "mean", "cfd", "selective_fd"])
def test_run_method_async(method):
    kw = dict(cache_duration=2) if method == "scarlet" else {}
    h = P.run_method(method, P.FLConfig(**BASE), engine="async", traffic=POISSON,
                     device="cpu", staleness_decay=0.5, **kw)
    assert len(h.ledger.rounds) == 6 and np.isfinite(h.final_server_acc)
    if method == "scarlet":
        hf = P.run_method(method, P.FLConfig(**BASE), engine="async", traffic=POISSON,
                          device="cpu", fused_round=True, **kw)
        assert _ledger(hf) == _ledger(h)
    with pytest.raises(ValueError, match="scan-safe"):
        P.run_method("comet", P.FLConfig(**BASE), engine="async", device="cpu")
    # the sharded engine is ported: a world of one on the CPU (gloo)
    h = P.run_method("scarlet", P.FLConfig(**BASE), engine="shard", device="cpu")
    assert len(h.ledger.rounds) == BASE["rounds"]


def test_zero_round_leg():
    eng = A(P.FLConfig(**BASE), P.STRATEGIES["scarlet"](beta=1.5), cache_duration=2,
            traffic=POISSON, device="cpu")
    h = eng.run(0)
    assert h.ledger.summary()["rounds"] == 0.0 and eng.t_done == 0
    assert eng.last_plan.dispatch.shape == (0, 6)


def test_poisson_cells_reach_weight_sums_below_one():
    """A sanity check of the cells: under Poisson traffic at decay 0.5 some
    round's weights sum below 1 (the case the divisor repair is about)."""
    eng, _ = _build(A, traffic=dataclasses.replace(POISSON, seed=3))
    plan = eng.last_plan
    sums = []
    ls = np.zeros(6, np.int64)
    for i, t in enumerate(range(1, 7)):
        d, a = plan.dispatch[i], plan.arrive[i]
        mid = np.where(d, t - 1, ls)
        if a.any():
            sums.append(float((0.5 ** (t - 1 - mid[a])).sum()))
        ls = np.where(a, t, mid)
    assert min(sums) < 1.0 <= max(sums)
