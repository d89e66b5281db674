"""The engine options of the port against the JAX package's, on the CPU:
heterogeneous client schedules, probabilistic cache expiry, mirrored
local caches, and checkpoints through the reference's npz format.

The port has no jax stream.  Where the reference draws from one, the
test computes the reference's numbers and hands them over: its initial
parameters (``load_params``), its scan engine's draws (``run(draws=)``)
and its expiry uniforms, ``jax.random.uniform(fold_in(PRNGKey(seed), t),
(m,))`` (``run(expiry_uniforms=)``).  Tolerances, as in
``test_torch_slice.py`` and ``test_torch_scan_engine.py``:

- ledgers byte-identical to the reference's host loop (a function of
  integer counts), and equal to its scan engine's float32 values;
- cache timestamps, presence, ``last_sync`` and request masks equal;
- cache values to atol 1e-5 (float32 predictions, averaged and sharpened
  in other orders), 5e-3 with an 8-bit codec (a rounding tie of the code
  moves one value by a level);
- parameters to atol 1e-4 (float32 SGD on the same gradients; the decay
  ``lr_decay ** (t - 1)`` may differ by an ulp between numpy's and XLA's
  float32 power);
- accuracies within one test sample;
- a port run split by a checkpoint against the port's uninterrupted run:
  bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as RC
import repro.core.cache as jcache
import repro.fl as R
import repro.fl.scenarios as jscen
import repro_torch.checkpoint as PC
import repro_torch.core.cache as pcache
import repro_torch.fl as P
from repro.fl.scan_engine import ScannedFederatedDistillation as RScan
from repro_torch.checkpoint import io as pio

BASE = dict(n_clients=4, n_classes=4, dim=8, rounds=4, local_steps=2,
            distill_steps=2, public_size=48, public_per_round=12,
            private_size=64, hidden=12, eval_every=2, alpha=0.5, seed=0)
# E_k = 0 for client 0: frozen through local training
HET = dict(local_steps=(0, 2, 5, 3), lr_scale=(0.5, 1.0, 2.0, 1.0), lr_decay=0.9)


def _scenario(lib, het=True, part=1.0, outage=None):
    outages = () if outage is None else (lib.Outage(*outage),)
    participation = (lib.full_participation() if part >= 1.0
                     else lib.fixed_fraction(part))
    return lib.Scenario(participation=participation, outages=outages,
                        heterogeneity=lib.Heterogeneity(**HET) if het else None)


def _params_np(params):
    return {k: np.array(v) for k, v in params.items()}


def _ledger(hist):
    return [(r.uplink, r.downlink) for r in hist.ledger.rounds]


def _ref_uniforms(t0, T, m, seed=0):
    """The reference's expiry uniforms of rounds t0+1..t0+T."""
    return np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(seed), t), (m,)))
        for t in range(t0 + 1, t0 + T + 1)]).reshape(T, m)


def _hold(port, ref, ph, rh, lossy, exact_ledger=True):
    if exact_ledger:
        assert ph.ledger.summary() == rh.ledger.summary()
    assert _ledger(ph) == _ledger(rh)
    assert ph.rounds == rh.rounds
    np.testing.assert_array_equal(port.cache_g.ts.numpy(), np.asarray(ref.cache_g.ts))
    np.testing.assert_array_equal(port.cache_g.present.numpy(),
                                  np.asarray(ref.cache_g.present))
    np.testing.assert_allclose(port.cache_g.values.numpy(), np.asarray(ref.cache_g.values),
                               rtol=0, atol=5e-3 if lossy else 1e-5)
    np.testing.assert_array_equal(port.last_sync, np.asarray(ref.last_sync))
    for k, v in ref.server_params.items():
        np.testing.assert_allclose(port.server_params[k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-4)
    for k, v in ref.client_params[0].items():
        np.testing.assert_allclose(port.client_params[0][k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-4)
    one_sample = 1.0 / len(ref.y_test)
    np.testing.assert_allclose(ph.server_acc, rh.server_acc, rtol=0, atol=one_sample)
    np.testing.assert_allclose(ph.client_acc, rh.client_acc, rtol=0, atol=one_sample)


# ---------------------------------------------------------------------------
# Heterogeneity
# ---------------------------------------------------------------------------

RESOLVE_CASES = [dict(), dict(local_steps=(1, 0, 4, 2)),
                 dict(lr_scale=(0.5, 1.0, 2.0, 0.25), lr_decay=0.95), HET,
                 dict(local_steps=(1, 2, 3)), dict(lr_scale=(1.0,) * 5)]


@pytest.mark.parametrize("case", range(len(RESOLVE_CASES)))
def test_heterogeneity_resolve_matches_reference(case):
    kw = RESOLVE_CASES[case]
    try:
        want = jscen.Heterogeneity(**kw).resolve(4, 0.1, 3)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            P.Heterogeneity(**kw).resolve(4, 0.1, 3)
        assert str(got.value) == str(e)
        return
    got = P.Heterogeneity(**kw).resolve(4, 0.1, 3)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]


# (heterogeneity, participation, cache duration, probabilistic expiry, codec)
HOST_CELLS = [(True, 1.0, 2, False, "identity"), (True, 0.5, 2, True, "identity"),
              (False, 1.0, 3, True, "cache_delta+quant8")]


@pytest.mark.parametrize("het,part,D,prob,codec", HOST_CELLS)
def test_host_loop_options_match_reference(het, part, D, prob, codec):
    cfg = dict(BASE, participation=part, uplink_codec=codec)
    kw = dict(cache_duration=D, probabilistic_expiry=prob)
    ref = R.FederatedDistillation(R.FLConfig(**cfg), R.STRATEGIES["scarlet"](beta=1.5),
                                  scenario=_scenario(R, het, part), rng_backend="numpy",
                                  **kw)
    port = P.FederatedDistillation(P.FLConfig(**cfg), P.STRATEGIES["scarlet"](beta=1.5),
                                   scenario=_scenario(P, het, part), device="cpu", **kw)
    port.load_params([_params_np(p) for p in ref.client_params],
                     _params_np(ref.server_params))
    if het:  # client 0 (E_0 = 0) leaves local training bit for bit unchanged
        before = port.client_params[0]
        after = port._local_train_all(port.client_params, 3)[0]
        for k in before:
            assert torch.equal(after[k][0], before[k][0])
            assert not torch.equal(after[k][1:], before[k][1:])
    u = _ref_uniforms(0, BASE["rounds"], BASE["public_per_round"]) if prob else None
    rh, ph = ref.run(), port.run(expiry_uniforms=u)
    _hold(port, ref, ph, rh, lossy="quant" in codec)
    if prob:  # the draw moved some expiries off the deterministic schedule
        det = P.FederatedDistillation(P.FLConfig(**cfg), P.STRATEGIES["scarlet"](beta=1.5),
                                      scenario=_scenario(P, het, part), device="cpu",
                                      cache_duration=D)
        assert _ledger(det.run()) != _ledger(ph)


@pytest.mark.parametrize("fused", [False, True])
def test_device_engine_options_match_reference(fused):
    """Heterogeneous schedules and probabilistic expiry at half
    participation with an outage, the reference's draws and uniforms."""
    cfg = dict(BASE, uplink_codec="cache_delta+quant8", fused_round=fused)
    kw = dict(cache_duration=2, probabilistic_expiry=True)
    ref = RScan(R.FLConfig(**cfg), R.STRATEGIES["scarlet"](beta=1.5),
                scenario=_scenario(R, True, 0.5, (1, 2, 3)), **kw)
    port = P.ScannedFederatedDistillation(P.FLConfig(**cfg), P.STRATEGIES["scarlet"](beta=1.5),
                                          scenario=_scenario(P, True, 0.5, (1, 2, 3)),
                                          device="cpu", **kw)
    port.load_params([_params_np(p) for p in ref.client_params],
                     _params_np(ref.server_params))
    draws = [ref._draw_round(t) for t in range(1, BASE["rounds"] + 1)]
    part = np.stack([p for p, _ in draws])
    idx = np.stack([i for _, i in draws])
    u = _ref_uniforms(0, BASE["rounds"], BASE["public_per_round"])
    rh = ref.run()
    ph = port.run(draws=(part, idx), expiry_uniforms=u)
    _hold(port, ref, ph, rh, lossy=True)


# ---------------------------------------------------------------------------
# probabilistic expiry
# ---------------------------------------------------------------------------

def _aged_cache(D, t=40):
    """Present entries of every age 0..D+2, then absent ones."""
    ages = np.arange(D + 3)
    P_ = len(ages) + 4
    ts = np.full(P_, -(2 ** 30), np.int32)
    ts[:len(ages)] = t - ages
    present = np.arange(P_) < len(ages)
    values = np.full((P_, 3), 1.0 / 3.0, np.float32)
    j = jcache.CacheState(jnp.asarray(values), jnp.asarray(ts), jnp.asarray(present))
    p = pcache.CacheState(torch.from_numpy(values), torch.from_numpy(ts),
                          torch.from_numpy(present))
    return j, p, ages, t


@pytest.mark.parametrize("D", [0, 1, 3, 25])
def test_probabilistic_miss_mask_matches_reference(D):
    """The reference's mask from its key equals the port's from the
    key's uniforms, over ages 0..D+2 and 16 keys; at a uniform equal to
    the hazard the entry stays, one float below it expires."""
    jc, pc, ages, t = _aged_cache(D)
    idx = np.arange(jc.size)
    ji, pi = jnp.asarray(idx), torch.from_numpy(idx)
    for s in range(16):
        key = jax.random.PRNGKey(s)
        want = jcache.miss_mask(jc, ji, t, D, probabilistic=True, key=key)
        u = torch.tensor(np.asarray(jax.random.uniform(key, idx.shape)))
        got = pcache.miss_mask(pc, pi, t, D, probabilistic=True, u=u)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if D == 0:
        assert got.all()
        return
    f32 = np.float32
    hazard = np.clip((ages.astype(f32) - f32(1.0)) / f32(D), f32(0), f32(1))
    pad = np.zeros(jc.size - len(ages), np.float32)
    at = np.concatenate([hazard, pad])
    # one float below the hazard, or 0 where the hazard is 0 (age <= 1)
    below = np.concatenate([np.where(hazard > 0, np.nextafter(hazard, f32(-1)), f32(0)),
                            pad])
    got_at = pcache.miss_mask(pc, pi, t, D, probabilistic=True, u=torch.from_numpy(at))
    got_below = pcache.miss_mask(pc, pi, t, D, probabilistic=True,
                                 u=torch.from_numpy(below))
    n = len(ages)
    np.testing.assert_array_equal(got_at.numpy()[:n], np.zeros(n, bool))
    np.testing.assert_array_equal(got_below.numpy()[:n], hazard > 0)
    assert got_at.numpy()[n:].all() and got_below.numpy()[n:].all()


def test_default_expiry_uniforms_are_stateless():
    cfg = P.FLConfig(**BASE)
    eng = P.FederatedDistillation(cfg, P.STRATEGIES["scarlet"](beta=1.5), cache_duration=2,
                                  probabilistic_expiry=True, device="cpu")
    u = eng.expiry_uniforms(3)
    assert u.shape == (BASE["public_per_round"],) and u.dtype == torch.float32
    assert torch.equal(u, eng.expiry_uniforms(3))
    assert not torch.equal(u, eng.expiry_uniforms(4))
    # the reference's uniforms of round 3: its key fold_in(PRNGKey(seed), 3)
    want = jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 3),
                              (BASE["public_per_round"],))
    np.testing.assert_array_equal(u.numpy(), np.asarray(want))
    assert torch.equal(eng.expiry_uniforms(3, count=2)[0], u)
    u = u.numpy()
    with pytest.raises(ValueError, match="expiry_uniforms"):
        eng.run(2, expiry_uniforms=np.zeros((3, BASE["public_per_round"]), np.float32))
    with pytest.raises(ValueError, match="expiry_uniforms"):
        P.FederatedDistillation(cfg, P.STRATEGIES["scarlet"](beta=1.5), cache_duration=2,
                                device="cpu").run(1, expiry_uniforms=u[None])


# ---------------------------------------------------------------------------
# mirrored local caches
# ---------------------------------------------------------------------------

def test_local_cache_functions_match_reference():
    rng = np.random.default_rng(3)
    P_, N, t = 30, 5, 7
    values = rng.random((P_, N)).astype(np.float32)
    ts = rng.integers(0, t, P_).astype(np.int32)
    present = rng.random(P_) < 0.5
    j = jcache.CacheState(jnp.asarray(values), jnp.asarray(ts), jnp.asarray(present))
    p = pcache.CacheState(torch.from_numpy(values), torch.from_numpy(ts),
                          torch.from_numpy(present))
    idx = np.sort(rng.choice(P_, 12, replace=False))
    miss = rng.random(12) < 0.5
    miss[0] = True
    z = rng.random((12, N)).astype(np.float32)
    jq = jcache.pack_queue(jnp.asarray(z), miss)
    pq = pcache.pack_queue(torch.from_numpy(z), torch.from_numpy(miss))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    jd = jcache.unpack_queue(jq, jnp.asarray(miss), N)
    pd = pcache.unpack_queue(pq, torch.from_numpy(miss), N)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    empty = pcache.unpack_queue(pq[:0], torch.zeros(12, dtype=torch.bool), N)
    np.testing.assert_array_equal(
        empty.numpy(), np.asarray(jcache.unpack_queue(jq[:0], jnp.zeros(12, bool), N)))
    sig = np.where(miss, np.where(present[idx], 2, 0), 1).astype(np.int32)
    jn, jt = jcache.update_local_cache(j, jnp.asarray(idx), jnp.asarray(sig), jd, t)
    pn, pt = pcache.update_local_cache(p, torch.from_numpy(idx), torch.from_numpy(sig), pd, t)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    for a, b in zip(pn, jn):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jpkg = jcache.make_catch_up(j, 3)
    ppkg = pcache.make_catch_up(p, 3)
    blank_j = jcache.init_cache(P_, N)
    blank_p = pcache.init_cache(P_, N)
    for a, b in zip(pcache.apply_catch_up(blank_p, ppkg), jcache.apply_catch_up(blank_j, jpkg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_mirrored_local_caches_match_reference():
    """Half participation, client 1 offline in rounds 2-3: each mirror
    equals the reference's, and a client that took part in the last
    round holds the global cache."""
    cfg = dict(BASE, participation=0.5, rounds=5)
    kw = dict(cache_duration=2, track_local_caches=True)
    ref = R.FederatedDistillation(R.FLConfig(**cfg), R.STRATEGIES["scarlet"](beta=1.5),
                                  scenario=_scenario(R, False, 0.5, (1, 2, 3)),
                                  rng_backend="numpy", **kw)
    h = P.run_method("scarlet", P.FLConfig(**cfg), beta=1.5, device="cpu",
                     scenario=_scenario(P, False, 0.5, (1, 2, 3)), **kw)
    port = P.FederatedDistillation(P.FLConfig(**cfg), P.STRATEGIES["scarlet"](beta=1.5),
                                   scenario=_scenario(P, False, 0.5, (1, 2, 3)),
                                   device="cpu", **kw)
    port.load_params([_params_np(p) for p in ref.client_params],
                     _params_np(ref.server_params))
    rh, ph = ref.run(), port.run()
    assert ph.ledger.summary() == rh.ledger.summary() == h.ledger.summary()
    assert len(port.local_caches) == BASE["n_clients"]
    for mine, theirs in zip(port.local_caches, ref.local_caches):
        np.testing.assert_array_equal(mine.ts.numpy(), np.asarray(theirs.ts))
        np.testing.assert_array_equal(mine.present.numpy(), np.asarray(theirs.present))
        np.testing.assert_allclose(mine.values.numpy(), np.asarray(theirs.values),
                                   rtol=0, atol=1e-5)
    last = np.nonzero(port.last_sync == cfg["rounds"])[0]
    assert len(last) == 2
    for k in last:
        for a, b in zip(port.local_caches[k], port.cache_g):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# checkpoint io: the reference's tests/test_checkpoint.py cases
# ---------------------------------------------------------------------------

def _io_roundtrip(tmp_path):
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7.0,
            "nested": {"ts": torch.tensor([-5, 0, 9], dtype=torch.int32),
                       "flag": torch.tensor([True, False])},
            "tup": (torch.tensor(3.25), torch.tensor([1.5, -2.5], dtype=torch.bfloat16)),
            "np": np.arange(3, dtype=np.int64),
            "cache": pcache.init_cache(5, 2)}
    path = str(tmp_path / "tree.npz")
    PC.save_pytree(path, tree)
    out = PC.load_pytree(path, tree)
    assert isinstance(out["cache"], pcache.CacheState) and isinstance(out["tup"], tuple)
    assert isinstance(out["np"], np.ndarray)
    flat_in, flat_out = pio._flatten(tree), pio._flatten(out)
    assert [k for k, _ in flat_in] == [k for k, _ in flat_out]
    for (_, a), (_, b) in zip(flat_in, flat_out):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            np.testing.assert_array_equal(a, b)


def _io_shape_mismatch(tmp_path):
    path = str(tmp_path / "tree.npz")
    PC.save_pytree(path, {"w": torch.zeros((2, 3))})
    with pytest.raises(PC.CheckpointShapeError, match=r"\(2, 3\)"):
        PC.load_pytree(path, {"w": torch.zeros((3, 2))})


def _io_dtype_mismatch(tmp_path):
    path = str(tmp_path / "tree.npz")
    PC.save_pytree(path, {"w": np.zeros((2, 3), np.float64)})
    with pytest.raises(PC.CheckpointDtypeError, match="refusing to cast"):
        PC.load_pytree(path, {"w": torch.zeros((2, 3), dtype=torch.float32)})
    PC.save_pytree(path, {"w": torch.zeros(2, dtype=torch.bfloat16)})
    with pytest.raises(PC.CheckpointDtypeError, match="refusing to cast"):
        PC.load_pytree(path, {"w": torch.zeros(2)})


def _io_missing_and_extra(tmp_path):
    path = str(tmp_path / "tree.npz")
    PC.save_pytree(path, {"a": torch.zeros(2), "b": torch.ones(2)})
    with pytest.raises(PC.CheckpointKeyError, match="no stored array"):
        PC.load_pytree(path, {"a": torch.zeros(2), "c": torch.zeros(2)})
    with pytest.raises(PC.CheckpointKeyError, match="never consumed"):
        PC.load_pytree(path, {"a": torch.zeros(2)})


def _io_escaping(tmp_path):
    tree = {"a/b": torch.tensor([1.0, 2.0]), "a": {"b": torch.tensor([3.0, 4.0])},
            "s": {"0": torch.tensor([5.0])}, "t": (torch.tensor([6.0]),)}
    path = str(tmp_path / "tree.npz")
    PC.save_pytree(path, tree)
    out = PC.load_pytree(path, tree)
    assert out["a/b"].tolist() == [1.0, 2.0] and out["a"]["b"].tolist() == [3.0, 4.0]
    assert out["s"]["0"].tolist() == [5.0] and out["t"][0].tolist() == [6.0]
    with np.load(path) as data:
        assert sorted(data.files) == ["d:a%2Fb", "d:a/d:b", "d:s/d:0", "d:t/i:0"]


def _io_collision(tmp_path):
    tree = {"x": torch.zeros(2), "y": torch.ones(2)}
    orig = pio._key
    pio._key = lambda path: "same"
    try:
        with pytest.raises(PC.CheckpointKeyError, match="duplicate npz key"):
            PC.save_pytree(str(tmp_path / "t.npz"), tree)
    finally:
        pio._key = orig


def _io_legacy(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"ts": torch.tensor([1, 2], dtype=torch.int32)},
            "tup": (torch.tensor([1.5]),), "cache": pcache.init_cache(2, 2)}
    path = str(tmp_path / "legacy.npz")
    np.savez(path, **{"w": tree["w"].numpy(), "nested/ts": tree["nested"]["ts"].numpy(),
                      "tup/0": tree["tup"][0].numpy(),
                      **{f"cache/.{f}": getattr(tree["cache"], f).numpy()
                         for f in ("values", "ts", "present")}})
    out = PC.load_pytree(path, tree)
    for (_, a), (_, b) in zip(pio._flatten(tree), pio._flatten(out)):
        assert torch.equal(a, b)


IO_CASES = {"roundtrip": _io_roundtrip, "shape_mismatch": _io_shape_mismatch,
            "dtype_mismatch": _io_dtype_mismatch, "missing_and_extra": _io_missing_and_extra,
            "key_escaping": _io_escaping, "colliding_keys": _io_collision,
            "legacy_keys": _io_legacy}


@pytest.mark.parametrize("case", sorted(IO_CASES))
def test_pytree_io(case, tmp_path):
    IO_CASES[case](tmp_path)


# ---------------------------------------------------------------------------
# engine state: files between the packages, restore-then-continue
# ---------------------------------------------------------------------------

def _pair(**kw):
    cfg = dict(BASE, participation=0.5, uplink_codec="cache_delta+quant8")
    ref = R.FederatedDistillation(R.FLConfig(**cfg), R.STRATEGIES["scarlet"](beta=1.5),
                                  cache_duration=2, rng_backend="numpy", **kw)
    port = P.FederatedDistillation(P.FLConfig(**cfg), P.STRATEGIES["scarlet"](beta=1.5),
                                   cache_duration=2, device="cpu", **kw)
    port.load_params([_params_np(p) for p in ref.client_params],
                     _params_np(ref.server_params))
    return ref, port


def _tree_np(state):
    return {pio._key(k): np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in pio._flatten(state)}


def test_checkpoint_files_move_between_packages(tmp_path):
    """A reference npz restores into the port, which then continues as
    the reference does; a port npz loads into the reference; both files
    hold the same keys, shapes and dtypes."""
    ref, port = _pair()
    ref.run(2)
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    RC.save_pytree(ref_path, ref.state_dict())

    fresh = _pair()[1]
    fresh.load_state_dict(PC.load_pytree(ref_path, fresh.state_dict()))
    assert fresh.t_done == 2
    PC.save_pytree(port_path, fresh.state_dict())
    with np.load(ref_path) as a, np.load(port_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
            np.testing.assert_array_equal(a[k], b[k])
    back = RC.load_pytree(port_path, ref.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref.state_dict())):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the restored port continues as the reference continues (the draws
    # of rounds 1-2 replayed)
    rh, ph = ref.run(2), fresh.run(2)
    assert ph.ledger.summary() == rh.ledger.summary()
    _hold(fresh, ref, ph, rh, lossy=True)


ENGINES = [("host", False), ("scan", False), ("scan", True)]


@pytest.mark.parametrize("engine,fused", ENGINES)
def test_restore_then_continue_is_bit_identical(engine, fused, tmp_path):
    """Heterogeneous schedules, probabilistic expiry (default uniforms)
    and half participation with an outage: 2 rounds, a checkpoint, a
    fresh engine restored from it, 3 more rounds, against 5 rounds in one
    engine: ledgers byte-identical, state bit-equal."""
    cfg = P.FLConfig(**dict(BASE, rounds=5, participation=0.5, fused_round=fused,
                            uplink_codec="cache_delta+quant8"))
    Engine = P.FederatedDistillation if engine == "host" else P.ScannedFederatedDistillation

    def make():
        return Engine(cfg, P.STRATEGIES["scarlet"](beta=1.5), cache_duration=2,
                      probabilistic_expiry=True, device="cpu",
                      scenario=_scenario(P, True, 0.5, (1, 2, 3)))

    full = make()
    hf = full.run(5)
    first = make()
    h1 = first.run(2)
    path = str(tmp_path / "engine.npz")
    PC.save_pytree(path, first.state_dict())
    restored = make()
    restored.load_state_dict(PC.load_pytree(path, restored.state_dict()))
    assert restored.t_done == 2
    h2 = restored.run(3)
    assert _ledger(h1) + _ledger(h2) == _ledger(hf)
    assert h2.server_acc == hf.server_acc[-len(h2.server_acc):]
    assert h2.client_acc == hf.client_acc[-len(h2.client_acc):]
    np.testing.assert_array_equal(restored.last_sync, full.last_sync)
    a, b = _tree_np(restored.state_dict()), _tree_np(full.state_dict())
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_restore_refuses_track_local_caches_as_the_reference_does():
    ref, port = _pair()
    port.run(1)
    ref_v = R.FederatedDistillation(R.FLConfig(**BASE), R.STRATEGIES["scarlet"](beta=1.5),
                                    cache_duration=2, rng_backend="jax",
                                    track_local_caches=True)
    port_v = P.FederatedDistillation(P.FLConfig(**BASE), P.STRATEGIES["scarlet"](beta=1.5),
                                     cache_duration=2, track_local_caches=True,
                                     device="cpu")
    with pytest.raises(ValueError) as want:
        ref_v.load_state_dict(ref_v.state_dict())
    with pytest.raises(ValueError) as got:
        port_v.load_state_dict(port.state_dict())
    assert str(got.value) == str(want.value)


def test_state_dict_refuses_comet_teacher_stacks_as_the_reference_does():
    """COMET's per-client (K, m, N) teachers do not fit the fixed (m, N)
    slot: both packages refuse to snapshot them, with one message."""
    cfg = dict(BASE, rounds=2)
    ref = R.FederatedDistillation(R.FLConfig(**cfg), R.STRATEGIES["comet"](),
                                  rng_backend="numpy")
    port = P.FederatedDistillation(P.FLConfig(**cfg), P.STRATEGIES["comet"](), device="cpu")
    ref.run(), port.run()
    assert port.prev_teacher[1].dim() == 3
    with pytest.raises(ValueError) as want:
        ref.state_dict()
    with pytest.raises(ValueError) as got:
        port.state_dict()
    assert str(got.value) == str(want.value)
    assert "per-client prev_teacher" in str(got.value)


def test_run_method_passes_the_options_through():
    cfg = P.FLConfig(**BASE)
    kw = dict(cache_duration=2, probabilistic_expiry=True,
              scenario=_scenario(P, True, 0.5, (1, 2, 3)))
    for engine, Engine in (("host", P.FederatedDistillation),
                           ("scan", P.ScannedFederatedDistillation)):
        h = P.run_method("scarlet", cfg, engine=engine, beta=1.5, device="cpu", **kw)
        h2 = Engine(cfg, P.STRATEGIES["scarlet"](beta=1.5), device="cpu", **kw).run()
        assert _ledger(h) == _ledger(h2) and h.server_acc == h2.server_acc
    with pytest.raises(ValueError, match="track_local_caches"):
        P.run_method("scarlet", cfg, engine="scan", device="cpu",
                     track_local_caches=True, cache_duration=2)
    from repro_torch.fl import engine as facade  # the reference's facade names

    assert facade.Heterogeneity is P.Heterogeneity
    assert facade.local_train_masked is not None
