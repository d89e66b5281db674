"""The port's traffic models (``repro_torch.fl.traffic``), the async catch-up
charge (``cache.catch_up_bytes_async``), ``Strategy.staleness_weight`` and
the blocked dispatch draw, against the JAX package on the CPU.

- ``TrafficModel.compile`` is numpy on both sides, from the same
  ``default_rng([seed, 911, t])`` stream: equal bit for bit, for every
  arrival and latency kind, with churn, from ``start > 1`` and as row
  slices of a longer compile.  The validation errors carry the reference's
  messages.
- ``catch_up_bytes_async`` counts exact small integers times one constant,
  summed over the same clients: equal to the reference's float32 bit for
  bit, for both counting methods; at zero delay it equals the synchronous
  charge bit for bit.
- ``staleness_weight`` is a float32 ``pow``; XLA's and PyTorch's differ by
  up to one ulp (seen at decays 0.9 and 0.77), and XLA flushes results
  below float32's normal range to zero where PyTorch keeps the subnormal
  value: held to rtol 2**-22 and atol 2**-126 (the smallest normal float32).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.fl as R
import repro_torch.fl as P
from repro.core import cache as rcache
from repro.fl import traffic as RT
from repro_torch.core import cache as pcache
from repro_torch.fl import traffic as PT

ARRIVALS = (dict(kind="always"), dict(kind="poisson", rate=0.7),
            dict(kind="poisson", rate=1.5), dict(kind="diurnal", rate=0.5, period=8,
                                                 amplitude=0.9))
LATENCIES = (dict(kind="zero"), dict(kind="fixed", ticks=2), dict(kind="uniform", lo=0, hi=3),
             dict(kind="uniform", lo=1, hi=5), dict(kind="geometric", p=0.4))


def _model(lib, arrivals, latency, window=1, churn=True, seed=5):
    events = ((lib.ChurnEvent(0, join=3), lib.ChurnEvent(2, join=1, leave=4),
               lib.ChurnEvent(2, join=7))
              if churn else ())
    return lib.TrafficModel(arrivals=lib.ArrivalProcess(**arrivals),
                            latency=lib.LatencyModel(**latency), churn=events,
                            window_ticks=window, seed=seed)


def _same(a, b):
    assert a.available.dtype == b.available.dtype == bool
    assert a.delay.dtype == b.delay.dtype == np.int32
    np.testing.assert_array_equal(a.available, b.available)
    np.testing.assert_array_equal(a.delay, b.delay)


@pytest.mark.parametrize("arrivals", ARRIVALS, ids=[a["kind"] + str(a.get("rate", "")) for a in ARRIVALS])
@pytest.mark.parametrize("latency", LATENCIES, ids=[f"{x['kind']}{i}" for i, x in enumerate(LATENCIES)])
def test_compile_equals_reference(arrivals, latency):
    for window, start, T, K in ((1, 1, 9, 7), (2, 4, 6, 5), (3, 1, 4, 11)):
        ref = _model(R, arrivals, latency, window).compile(T, K, start=start)
        got = _model(P, arrivals, latency, window).compile(T, K, start=start)
        _same(got, ref)
    # absolute-round keying: a later leg is a row slice of the full compile
    tm = _model(P, arrivals, latency)
    full, tail = tm.compile(10, 6), tm.compile(4, 6, start=7)
    np.testing.assert_array_equal(full.available[6:], tail.available)
    np.testing.assert_array_equal(full.delay[6:], tail.delay)
    assert tm.is_synchronous == _model(R, arrivals, latency).is_synchronous


def test_model_helpers_equal_reference():
    for t in range(1, 12):
        for a in ARRIVALS:
            for w in (1, 3):
                assert (P.ArrivalProcess(**a).window_probability(t, w)
                        == R.ArrivalProcess(**a).window_probability(t, w))
        np.testing.assert_array_equal(
            _model(P, ARRIVALS[0], LATENCIES[0]).member_mask(t, 4),
            _model(R, ARRIVALS[0], LATENCIES[0]).member_mask(t, 4))
    for lat in LATENCIES:
        assert P.LatencyModel(**lat).max_ticks == R.LatencyModel(**lat).max_ticks
    wide = P.TrafficModel(latency=P.LatencyModel("uniform", lo=0, hi=3), window_ticks=4)
    assert wide.is_synchronous and P.TrafficModel().is_synchronous
    assert not P.TrafficModel(latency=P.LatencyModel("geometric", p=0.9)).is_synchronous
    ticks = P.LatencyModel("geometric", p=0.5).sample_ticks(2000, np.random.default_rng(0))
    assert ticks.min() == 0 and ticks.max() > 0
    assert PT.TRAFFIC_SALT == RT.TRAFFIC_SALT == 911


def test_churn_membership():
    tm = P.TrafficModel(churn=(P.ChurnEvent(0, join=3), P.ChurnEvent(2, join=1, leave=2)))
    np.testing.assert_array_equal(
        tm.compile(4, 3).available,
        [[False, True, True], [False, True, True], [True, True, False], [True, True, False]])


BAD = (lambda lib: lib.TrafficModel(window_ticks=0),
       lambda lib: lib.TrafficModel(arrivals=lib.ArrivalProcess("lunar")).compile(1, 2),
       lambda lib: lib.TrafficModel(latency=lib.LatencyModel("uniform", lo=3, hi=1)).compile(1, 2),
       lambda lib: lib.TrafficModel(latency=lib.LatencyModel("fixed", ticks=-1)).compile(1, 2),
       lambda lib: lib.TrafficModel(latency=lib.LatencyModel("carrier-pigeon")).compile(1, 2))


@pytest.mark.parametrize("case", range(len(BAD)))
def test_validation_errors_equal_reference(case):
    with pytest.raises(ValueError) as want:
        BAD[case](R)
    with pytest.raises(ValueError) as got:
        BAD[case](P)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# catch_up_bytes_async
# ---------------------------------------------------------------------------

def _random_cache(rng, n_pub=40, N=5, t=9):
    present = rng.random(n_pub) < 0.7
    ts = np.where(present, rng.integers(1, t, n_pub), rcache._NEVER).astype(np.int32)
    values = rng.random((n_pub, N)).astype(np.float32)
    return values, ts, present


@pytest.mark.parametrize("method", ["dense", "sorted"])
@pytest.mark.parametrize("seed", range(4))
def test_catch_up_bytes_async_equals_reference(method, seed):
    rng = np.random.default_rng(seed)
    K, t = 23, 9
    values, ts, present = _random_cache(rng, t=t)
    last_sync = rng.integers(0, t, K).astype(np.int32)
    dispatch = rng.random(K) < 0.4
    arrive = (rng.random(K) < 0.4) | (dispatch & (rng.random(K) < 0.5))
    rc = rcache.CacheState(jnp.asarray(values), jnp.asarray(ts), jnp.asarray(present))
    pc = pcache.CacheState(torch.from_numpy(values), torch.from_numpy(ts),
                           torch.from_numpy(present))
    want = rcache.catch_up_bytes_async(rc, jnp.asarray(last_sync), jnp.asarray(dispatch),
                                       jnp.asarray(arrive), t, method=method)
    got = pcache.catch_up_bytes_async(pc, torch.from_numpy(last_sync),
                                      torch.from_numpy(dispatch), torch.from_numpy(arrive), t,
                                      method=method)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert g.item() == float(np.asarray(w))
    assert got[0].item() > got[1].item() > 0.0
    # zero delay: the arrivals are the dispatches, and the total is the
    # synchronous charge bit for bit
    total, disp = pcache.catch_up_bytes_async(pc, torch.from_numpy(last_sync),
                                              torch.from_numpy(dispatch),
                                              torch.from_numpy(dispatch), t, method=method)
    sync = pcache.catch_up_bytes_device(pc, torch.from_numpy(last_sync),
                                        torch.from_numpy(dispatch), t, method=method)
    assert total.item() == disp.item() == sync.item() > 0.0


# ---------------------------------------------------------------------------
# staleness_weight and the blocked draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["scarlet", "dsfl", "mean", "cfd", "selective_fd"])
def test_staleness_weight_matches_reference(name):
    s = np.arange(0, 64, dtype=np.int32)
    for decay in (1.0, 0.9, 0.77, 0.5, 0.3, 0.123):
        want = np.asarray(R.STRATEGIES[name](staleness_decay=decay).staleness_weight(
            jnp.asarray(s)))
        got = P.STRATEGIES[name](staleness_decay=decay).staleness_weight(torch.from_numpy(s))
        assert got.dtype == torch.float32 and got.shape == (64,)
        np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -22, atol=2.0 ** -126)
    one = P.STRATEGIES[name]().staleness_weight(torch.arange(5, dtype=torch.int32))
    assert torch.equal(one, torch.ones(5))


@pytest.mark.parametrize("part", [P.full_participation(), P.fixed_fraction(0.5),
                                  P.bernoulli_participation(0.3)])
def test_blocked_draw_folds_into_the_offline_mask(part):
    """Blocked clients are never drawn; conscription picks the lowest
    unblocked ones; the Generator advances as without ``blocked``."""
    K = 9
    sc = P.Scenario(participation=part, outages=(P.Outage(4, 1, 50),))
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    blk = np.random.default_rng(8)
    for t in range(1, 40):
        blocked = blk.random(K) < 0.5
        got = sc.participation_mask(t, K, rng_a, blocked=blocked)
        free = sc.participation_mask(t, K, rng_b)
        off = sc.offline_mask(t, K) | blocked
        assert not (got & off).any()
        if got.sum() == 0:
            assert off.all()
        elif (free & ~off).any():
            np.testing.assert_array_equal(got, free & ~off)
        else:  # conscription: the lowest-indexed available client
            assert got.sum() == 1 and np.argmax(got) == np.argmin(off)
    assert rng_a.random() == rng_b.random()
