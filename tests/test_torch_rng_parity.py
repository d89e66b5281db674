"""Whole runs of the port against the reference at the same seed, with
nothing injected: no draws, no parameters, no expiry uniforms.

Both packages' ``run_method`` run each case; each engine is caught as
``run_method`` builds it (its class in the api's engine table wrapped), so
its final cache can be read.  What the two share is the seed alone: the
port's initial parameters come from ``split(key(seed), K + 1)``, its
expiry uniforms from ``fold_in(key(seed), t)`` and, under
``rng_backend="jax"``, P^t and the participation from the round keys of
``fold_in(key(seed), 43)``, all through ``repro_torch.core.prng``.  Each
case holds the port to:

- initial client parameters (``ClientModels.init_params``) and server
  parameters to atol 1e-6 (``normal``'s last bit, see
  ``tests/test_torch_prng.py``);
- the reference's ``CommLedger.summary()``, equal as a dict of floats
  (byte for byte);
- the same History rounds, cache timestamps and presence;
- accuracies within one test sample (the parameters agree to float32
  rounding: the same SGD on the same draws).

Cases: the numpy host loop with probabilistic expiry (its draws are the
numpy Generators', its expiry the key stream's), and the jax stream on
``engine="scan"`` per-op and fused, ``"active"`` and ``"async"`` (their
default).  The reference's sharded engine does not run under jax 0.9.0,
so the port's shard engine is held to the port's own jax-stream scan
engine, byte for byte.  A jax-stream restore at round 2 continues as the
uninterrupted run, with nothing replayed.
"""
import numpy as np
import pytest
import torch

import repro.fl as R
import repro.fl.api as rapi
import repro_torch.fl as P
import repro_torch.fl.api as papi

BASE = dict(n_clients=6, n_classes=4, dim=8, rounds=4, local_steps=1, distill_steps=1,
            public_size=40, public_per_round=8, private_size=60, hidden=8, eval_every=1,
            participation=0.5)


def _run(lib, api, monkeypatch, method="scarlet", **kw):
    """``lib.run_method(method, ...)`` on the cell's configuration; returns
    (History, the engine it built, that engine's initial client and server
    parameters)."""
    engine = kw.get("engine", "host")
    cls = api._ENGINES[engine]
    built = []

    def build(*a, **k):
        eng = cls(*a, **k)
        built.append((eng, [{n: np.array(v) for n, v in p.items()}
                            for p in list(eng.client_params) + [eng.server_params]]))
        return eng

    monkeypatch.setitem(api._ENGINES, engine, build)
    extra = {} if lib is R else {"device": "cpu"}
    hist = lib.run_method(method, lib.FLConfig(**BASE), cache_duration=2,
                          probabilistic_expiry=True, **kw, **extra)
    return (hist,) + built[0]


def _hold(port, ref):
    (ph, pe, p0), (rh, re, r0) = port, ref
    for got, want in zip(p0, r0):  # ClientModels.init_params, the server's init_mlp
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    assert ph.ledger.summary() == rh.ledger.summary()
    assert [(r.uplink, r.downlink) for r in ph.ledger.rounds] == \
        [(float(r.uplink), float(r.downlink)) for r in rh.ledger.rounds]
    assert ph.rounds == rh.rounds
    np.testing.assert_array_equal(pe.cache_g.ts.numpy(), np.asarray(re.cache_g.ts))
    np.testing.assert_array_equal(pe.cache_g.present.numpy(), np.asarray(re.cache_g.present))
    n_test = len(re.y_test)
    np.testing.assert_allclose(ph.server_acc, rh.server_acc, rtol=0, atol=1.0 / n_test)
    shard = int(np.asarray(re.tmask).sum(1).min())
    np.testing.assert_allclose(ph.client_acc, rh.client_acc, rtol=0, atol=1.0 / shard)


CASES = [dict(rng_backend="numpy"), dict(engine="scan"), dict(engine="scan", fused_round=True),
         dict(engine="active"), dict(engine="async")]


@pytest.mark.parametrize("case", CASES, ids=["host-numpy", "scan", "scan-fused", "active",
                                              "async"])
def test_run_method_matches_the_reference_at_the_same_seed(case, monkeypatch):
    ref = _run(R, rapi, monkeypatch, **case)
    port = _run(P, papi, monkeypatch, **case)
    assert port[1].rng_backend == ref[1].rng_backend == case.get("rng_backend", "jax")
    _hold(port, ref)


def test_shard_engine_is_the_scan_engine_on_the_jax_stream(monkeypatch):
    sh, se, s0 = _run(P, papi, monkeypatch, engine="shard")
    ch, ce, c0 = _run(P, papi, monkeypatch, engine="scan")
    for a, b in zip(s0, c0):  # a world of one holds every client
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    assert se.rng_backend == ce.rng_backend == "jax"
    assert sh.ledger.summary() == ch.ledger.summary()
    assert [(r.uplink, r.downlink) for r in sh.ledger.rounds] == \
        [(r.uplink, r.downlink) for r in ch.ledger.rounds]
    assert torch.equal(se.cache_g.ts, ce.cache_g.ts)


def test_jax_stream_restore_continues_without_replay():
    cfg = P.FLConfig(**BASE)
    kw = dict(cache_duration=2, probabilistic_expiry=True, device="cpu")
    whole = P.ScannedFederatedDistillation(cfg, P.STRATEGIES["scarlet"](), **kw)
    full = whole.run(4)
    first = P.ScannedFederatedDistillation(cfg, P.STRATEGIES["scarlet"](), **kw)
    head = first.run(2)
    state = first.state_dict()
    second = P.ScannedFederatedDistillation(cfg, P.STRATEGIES["scarlet"](), **kw)

    def no_replay(*a, **k):
        raise AssertionError("a jax-stream restore replays no draw")

    second._draw_round = no_replay
    second.load_state_dict(state)
    tail = second.run(2)
    got = [(r.uplink, r.downlink) for r in head.ledger.rounds + tail.ledger.rounds]
    assert got == [(r.uplink, r.downlink) for r in full.ledger.rounds]
    assert head.server_acc + tail.server_acc == full.server_acc
    for a, b in zip(second.client_params, whole.client_params):
        for k in a:
            assert torch.equal(a[k], b[k])
    assert torch.equal(second.cache_g.values, whole.cache_g.values)
