"""The port's host round loop against the JAX package's, end to end.

Both run the same configuration with the reference's numpy draws
(``rng_backend="numpy"``), and the port starts from the reference's
initial parameters, handed over through ``params_from_numpy``.  The
cells cover SCARLET and DS-FL, and the comparison methods CFD (its 1-bit
``transmit``), mean and Selective-FD (its upload mask, which the ledger
charges).  Every cell holds the port to:

- a byte-identical ledger summary (it is a function of integer counts);
- equal cache timestamps and presence, and cache values to atol 1e-5
  (float32 predictions, averaged and sharpened; the two frameworks sum
  in other orders, ~1e-7 per operation over a few rounds);
- server and client parameters to atol 1e-4 (float32 SGD steps on the
  same gradients, rounding drift only);
- accuracies within one test sample.
"""
import numpy as np
import pytest
import torch

import repro.fl as R
import repro_torch.fl as P

BASE = dict(n_clients=6, n_classes=5, dim=8, rounds=3, local_steps=3,
            distill_steps=3, public_size=60, public_per_round=24,
            private_size=120, hidden=16, eval_every=1, alpha=0.5)

CELLS = [("scarlet", codec, part)
         for codec in ("identity", "quant8", "cache_delta+quant8")
         for part in (1.0, 0.5)] + [("dsfl", "identity", 1.0)]


def _params_np(params):
    return {k: np.array(v) for k, v in params.items()}


# the comparison methods (D=1 with the cache on: Fig. 11's plug-in);
# Selective-FD at its default tau, and at tau 0.25 where at half
# participation the default withholds nothing from these clients
METHOD_CELLS = [("cfd", "identity", 1.0, 0, None), ("cfd", "identity", 0.5, 0, None),
                ("cfd", "identity", 1.0, 1, None), ("mean", "identity", 1.0, 0, None),
                ("selective_fd", "identity", 1.0, 0, None),
                ("selective_fd", "identity", 0.5, 0, None),
                ("selective_fd", "identity", 0.5, 0, 0.25),
                ("selective_fd", "quant8", 1.0, 0, None),
                ("selective_fd", "identity", 1.0, 1, None)]


@pytest.mark.parametrize("method,codec,part", CELLS)
def test_host_loop_matches_reference(method, codec, part):
    skw = {"beta": 1.5} if method == "scarlet" else {}
    D = 1 if method == "scarlet" else 0  # D=1: entries expire within 3 rounds
    _hold_host_loop(method, codec, part, D, None, skw)


@pytest.mark.parametrize("method,codec,part,D,tau", METHOD_CELLS)
def test_comparison_method_matches_reference(method, codec, part, D, tau):
    skw = {} if tau is None else {"tau_client": tau}
    ref, _ = _hold_host_loop(method, codec, part, D, D > 0, skw)
    if method == "selective_fd":
        # no round uploads more than every requested sample; where the
        # gate withholds, the mask reached the ledger
        K, m, N = BASE["n_clients"], BASE["public_per_round"], BASE["n_classes"]
        bits = 8 if codec == "quant8" else 32
        full = K * part * m * N * bits / 8.0
        ups = [r.uplink for r in ref.ledger.rounds]
        assert max(ups) <= full
        if (part, tau) != (0.5, None):
            assert min(ups) < full


def _hold_host_loop(method, codec, part, D, use_cache, skw):
    cfg = dict(BASE, participation=part, uplink_codec=codec)
    ref = R.FederatedDistillation(R.FLConfig(**cfg), R.STRATEGIES[method](**skw),
                                  cache_duration=D, use_cache=use_cache,
                                  rng_backend="numpy")
    port = P.FederatedDistillation(P.FLConfig(**cfg), P.STRATEGIES[method](**skw),
                                   cache_duration=D, use_cache=use_cache, device="cpu")
    port.load_params([_params_np(p) for p in ref.client_params],
                     _params_np(ref.server_params))
    rh, ph = ref.run(), port.run()

    assert ph.ledger.summary() == rh.ledger.summary()
    assert ph.cumulative_mb == rh.cumulative_mb
    assert ph.rounds == rh.rounds

    np.testing.assert_array_equal(port.cache_g.ts.numpy(), np.asarray(ref.cache_g.ts))
    np.testing.assert_array_equal(port.cache_g.present.numpy(),
                                  np.asarray(ref.cache_g.present))
    np.testing.assert_allclose(port.cache_g.values.numpy(),
                               np.asarray(ref.cache_g.values), rtol=0, atol=1e-5)
    if method == "scarlet" or use_cache:
        assert bool(np.asarray(ref.cache_g.present).any())

    for k, v in ref.server_params.items():
        np.testing.assert_allclose(port.server_params[k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-4)
    for k, v in ref.client_params[0].items():
        np.testing.assert_allclose(port.client_params[0][k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-4)

    one_sample = 1.0 / len(ref.y_test)
    np.testing.assert_allclose(ph.server_acc, rh.server_acc, rtol=0,
                               atol=one_sample)
    # client accuracy is a mean over clients of per-client test accuracy
    np.testing.assert_allclose(ph.client_acc, rh.client_acc, rtol=0,
                               atol=one_sample)
    np.testing.assert_allclose(ph.server_val_loss, rh.server_val_loss,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(port.last_sync),
                                  np.asarray(ref.last_sync))
    return rh, ph


def test_run_method_front_door_on_cpu():
    cfg = P.FLConfig(**BASE, uplink_codec="cache_delta+quant8")
    h = P.run_method("scarlet", cfg, cache_duration=2, beta=1.5, device="cpu")
    eng = P.FederatedDistillation(cfg, P.STRATEGIES["scarlet"](beta=1.5),
                                  cache_duration=2, device="cpu")
    h2 = eng.run()
    assert h.ledger.summary() == h2.ledger.summary()
    assert h.server_acc == h2.server_acc
    assert h.final_server_acc == h.server_acc[-1]
    assert all(0.0 <= a <= 1.0 for a in h.server_acc + h.client_acc)


def test_split_runs_continue_round_numbering():
    cfg = P.FLConfig(**BASE)
    a = P.FederatedDistillation(cfg, P.STRATEGIES["scarlet"](), cache_duration=2,
                                device="cpu")
    h1, h2 = a.run(1), a.run(2)
    assert (h1.rounds, h2.rounds, a.t_done) == ([1], [2, 3], 3)
    b = P.FederatedDistillation(cfg, P.STRATEGIES["scarlet"](), cache_duration=2,
                                device="cpu")
    hb = b.run()
    assert [r.uplink for r in h1.ledger.rounds + h2.ledger.rounds] == \
        [r.uplink for r in hb.ledger.rounds]
    assert torch.equal(a.cache_g.values, b.cache_g.values)
    empty = a.run(0)
    assert empty.ledger.summary()["rounds"] == 0.0
    assert empty.final_server_acc is None
