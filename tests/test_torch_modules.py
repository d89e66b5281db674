"""The port's modules against the JAX package's, one module at a time.

Inputs come from numpy with fixed seeds and go through both.  Integer
results (data draws, masks, timestamps, signals) and the byte ledger must
be equal; float32 soft-label results agree to atol 1e-6 (the same
operations in float32, reduction order aside).
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.compress as jcodecs
import repro.core.cache as jcache
import repro.core.comm as jcomm
import repro.core.era as jera
import repro.data.synthetic as jdata
import repro.fl.scenarios as jscen
from repro.models import resnet as jresnet
from repro_torch.checkpoint import ClientParamStore
import repro_torch.compress as pcodecs
import repro_torch.core.cache as pcache
from repro_torch.core import prng
import repro_torch.core.comm as pcomm
import repro_torch.core.era as pera
import repro_torch.data.synthetic as pdata
import repro_torch.fl as pfl
import repro_torch.fl.scenarios as pscen
from repro_torch.fl.cohorts import ClientModels, resolve_cohorts
from repro_torch.models import resnet as presnet

ATOL = 1e-6
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _probs(rng, shape):
    z = rng.dirichlet(np.ones(shape[-1]), size=int(np.prod(shape[:-1])))
    return z.astype(np.float32).reshape(shape)


# ---------------------------------------------------------------------------
# data/synthetic: a copy, equal arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_data_equals_reference(seed):
    a = jdata.make_public_private(300, 120, 5, 8, seed=seed)
    b = pdata.make_public_private(300, 120, 5, 8, seed=seed)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    pa = jdata.dirichlet_partition(a["y_private"], 6, 0.3, seed=seed)
    pb = pdata.dirichlet_partition(b["y_private"], 6, 0.3, seed=seed)
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(x, y)
    for fa, fb in [(jdata.pad_client_shards(a["x_private"], a["y_private"], pa),
                    pdata.pad_client_shards(b["x_private"], b["y_private"], pb)),
                   (jdata.uniform_client_shards(a["x_test"], a["y_test"], 7),
                    pdata.uniform_client_shards(b["x_test"], b["y_test"], 7))]:
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# fl/scenarios: the same participation draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,rate", [("full", 1.0), ("fraction", 0.5),
                                       ("fraction", 0.01), ("bernoulli", 0.3)])
def test_participation_mask_sequence_equals_reference(kind, rate):
    outages = ((0, 2, 4), (3, 1, 8), (5, 6, 6))
    ja = jscen.Scenario(jscen.Participation(kind, rate),
                        tuple(jscen.Outage(*o) for o in outages))
    pa = pscen.Scenario(pscen.Participation(kind, rate),
                        tuple(pscen.Outage(*o) for o in outages))
    rj, rp = np.random.default_rng([4, 29]), np.random.default_rng([4, 29])
    for t in range(1, 13):
        np.testing.assert_array_equal(ja.participation_mask(t, 9, rj),
                                      pa.participation_mask(t, 9, rp))
        np.testing.assert_array_equal(ja.offline_mask(t, 9), pa.offline_mask(t, 9))
    for r in (1.0, 0.4):
        assert (jscen.Scenario.from_participation_rate(r).participation.kind
                == pscen.Scenario.from_participation_rate(r).participation.kind)


# ---------------------------------------------------------------------------
# core/cache
# ---------------------------------------------------------------------------

def _cache_pair(rng, P=40, N=6, t=9):
    values = _probs(rng, (P, N))
    ts = rng.integers(0, t, P).astype(np.int32)
    present = rng.random(P) < 0.6
    ts[~present] = -(2 ** 30)
    j = jcache.CacheState(jnp.asarray(values), jnp.asarray(ts), jnp.asarray(present))
    p = pcache.CacheState(torch.from_numpy(values), torch.from_numpy(ts),
                          torch.from_numpy(present))
    return j, p


@pytest.mark.parametrize("D", [0, 1, 3, 25])
def test_cache_round_equals_reference(D):
    rng = np.random.default_rng(D)
    jc, pc = _cache_pair(rng)
    t = 9
    idx = np.sort(rng.choice(40, 15, replace=False))
    ji, pi = jnp.asarray(idx), torch.from_numpy(idx)
    jm = jcache.miss_mask(jc, ji, t, D)
    pm = pcache.miss_mask(pc, pi, t, D)
    np.testing.assert_array_equal(np.asarray(jm), pm.numpy())
    for a, b in zip(jcache.cached_at(jc, ji), pcache.cached_at(pc, pi)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    fresh = _probs(rng, (15, 6))
    jt = jcache.assemble_teacher(jc, ji, jnp.asarray(fresh), jm)
    pt = pcache.assemble_teacher(pc, pi, torch.from_numpy(fresh), pm)
    np.testing.assert_array_equal(np.asarray(jt), pt.numpy())
    jn, jsig = jcache.update_global_cache(jc, ji, jt, jm, t)
    pn, psig = pcache.update_global_cache(pc, pi, pt, pm, t)
    np.testing.assert_array_equal(np.asarray(jsig), psig.numpy())
    for a, b in zip(jn, pn):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the update is functional: the pre-round cache is untouched
    for a, b in zip(jc, pc):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for last_sync in (-(2 ** 30), 0, 4, 8, 9):
        jp = jcache.make_catch_up(jn, last_sync)
        pp = pcache.make_catch_up(pn, last_sync)
        for a, b in zip(jp, pp):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert jcache.catch_up_bytes(jp) == pcache.catch_up_bytes(pp)


@pytest.mark.parametrize("t", [2, 5, 9, 12])
def test_catch_up_bytes_device_equals_reference(t):
    """The device engine's catch-up count (float32 on the device) against
    the reference's, and against the host loop's packages summed."""
    rng = np.random.default_rng(t)
    jc, pc = _cache_pair(rng, P=40, N=6, t=t)
    K = 7
    last_sync = rng.integers(0, t, K).astype(np.int32)
    part = rng.random(K) < 0.6
    want = jcache.catch_up_bytes_device(jc, jnp.asarray(last_sync), jnp.asarray(part), t)
    got = pcache.catch_up_bytes_device(pc, torch.from_numpy(last_sync),
                                       torch.from_numpy(part), t)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == float(want)
    host = sum(pcache.catch_up_bytes(pcache.make_catch_up(pc, int(last_sync[k])))
               for k in range(K) if part[k] and last_sync[k] < t - 1)
    assert float(got) == host


def test_cache_duration_validation_matches_reference():
    for D in (0, 3, np.int64(2), 4.0):
        assert jcache.normalize_cache_duration(D) == pcache.normalize_cache_duration(D)
    for bad, err in ((True, TypeError), (1.5, TypeError), ("3", TypeError),
                     (-1, ValueError)):
        with pytest.raises(err):
            pcache.normalize_cache_duration(bad)
    # probabilistic expiry: the reference's uniforms of its key give its
    # mask; without uniforms the port raises, as the reference does
    # without a key
    jc, pc = _cache_pair(np.random.default_rng(0))
    idx = np.arange(40)
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, idx.shape))
    for D in (1, 3, 25):
        want = jcache.miss_mask(jc, jnp.asarray(idx), 9, D, probabilistic=True, key=key)
        got = pcache.miss_mask(pc, torch.from_numpy(idx), 9, D, probabilistic=True,
                               u=torch.from_numpy(u))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        pcache.miss_mask(pc, torch.arange(3), 2, 3, probabilistic=True)


def test_init_cache_equals_reference():
    j, p = jcache.init_cache(12, 4), pcache.init_cache(12, 4)
    for a, b in zip(j, p):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype


# ---------------------------------------------------------------------------
# core/comm: byte-identical ledger
# ---------------------------------------------------------------------------

def test_ledger_summary_byte_identical():
    rng = np.random.default_rng(1)
    jl, pl = jcomm.CommLedger(), pcomm.CommLedger()
    assert jl.summary() == pl.summary()  # empty: honest zeros
    for _ in range(7):
        up, down = float(rng.integers(0, 10 ** 6)), float(rng.random() * 1e6)
        jl.record(jcomm.RoundCost(up, down))
        pl.record(pcomm.RoundCost(up, down))
    assert jl.summary() == pl.summary()
    assert jl.cumulative_total == pl.cumulative_total


@pytest.mark.parametrize("n_clients,n_params,bits", [(6, 229, 32.0), (100, 3210, 32.0),
                                                     (3, 17, 8.0), (0, 5, 32.0)])
def test_fedavg_round_cost_equals_reference(n_clients, n_params, bits):
    kw = dict(n_clients=n_clients, n_params=n_params, bits=bits)
    got, want = pcomm.fedavg_round_cost(**kw), jcomm.fedavg_round_cost(**kw)
    assert (got.uplink, got.downlink) == (want.uplink, want.downlink)


@pytest.mark.parametrize("spec", ["identity", "quant8", "quant4", "quant1",
                                  "quant6", "cache_delta", "cache_delta+quant8",
                                  "cache_delta+quant4", "topk", "topk4",
                                  "cache_delta+topk2"])
def test_round_cost_and_payload_bytes_equal(spec):
    jc, pc = jcodecs.get_codec(spec), pcodecs.get_codec(spec)
    assert jc.name == pc.name and jc.is_identity == pc.is_identity
    for n, N in [(1000, 10), (37, 5), (0, 3), (12.5, 10)]:
        assert jc.payload_bytes(n, N) == pc.payload_bytes(n, N)
    for kw in [dict(n_clients=100, n_selected=1000, n_requested=640,
                    n_classes=10, with_cache_signals=True, catch_up_down=1234.0),
               dict(n_clients=3, n_selected=24, n_up_samples=7.5,
                    n_down_samples=9, n_classes=5, bytes_index=2.0),
               dict(n_clients=6, n_selected=24, n_requested=24, n_classes=5,
                    with_request_list=False, uplink_bits=8.0)]:
        a = jcomm.distillation_round_cost(**kw, uplink_codec=jc, downlink_codec=jc)
        b = pcomm.distillation_round_cost(**kw, uplink_codec=pc, downlink_codec=pc)
        assert (a.uplink, a.downlink) == (b.uplink, b.downlink)
    for n in (10, 256, 257, 65536, 65537):
        assert jcomm.index_bytes_for(n) == pcomm.index_bytes_for(n)


# ---------------------------------------------------------------------------
# compress/codecs: round trips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["identity", "quant8", "cache_delta+quant8"])
@pytest.mark.parametrize("cache", [False, True])
def test_device_round_cost_equals_reference_float32(spec, cache):
    """The device engine's float32 cost on 0-dim tensors: bit for bit the
    reference scan engine's, and a pair of float32 tensors."""
    for n_clients, n_req, catch_up in [(6.0, 24.0, 0.0), (3.0, 17.0, 336.0),
                                       (100.0, 1000.0, 48.0), (0.0, 5.0, 0.0)]:
        kw = dict(n_selected=24.0, n_classes=10, with_cache_signals=cache,
                  bytes_index=4.0, uplink_bits=32.0, downlink_bits=32.0)
        ju, jd = jcomm.distillation_round_cost_device(
            n_clients=jnp.float32(n_clients), n_up_samples=jnp.float32(n_req),
            n_down_samples=jnp.float32(n_req),
            catch_up_down=jnp.float32(catch_up) if cache else 0.0,
            uplink_codec=jcodecs.get_codec(spec), **kw)
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
        pu, pd = pcomm.distillation_round_cost_device(
            n_clients=f32(n_clients), n_up_samples=f32(n_req),
            n_down_samples=f32(n_req), catch_up_down=f32(catch_up) if cache else 0.0,
            uplink_codec=pcodecs.get_codec(spec), **kw)
        assert pu.dtype == pd.dtype == torch.float32
        assert (pu.item(), pd.item()) == (float(ju), float(jd))


@pytest.mark.parametrize("spec", ["identity", "quant8", "quant4", "quant1",
                                  "cache_delta", "cache_delta+quant8",
                                  "cache_delta+quant1"])
def test_codec_roundtrip_matches_reference(spec):
    rng = np.random.default_rng(11)
    z = _probs(rng, (5, 16, 7))
    base = _probs(rng, (16, 7))
    present = rng.random(16) < 0.5
    jc, pc = jcodecs.get_codec(spec), pcodecs.get_codec(spec)
    for b, pr in [(None, None), (base, present)]:
        want = np.asarray(jc.roundtrip(
            jnp.asarray(z), None if b is None else jnp.asarray(b),
            None if pr is None else jnp.asarray(pr)))
        got = pc.roundtrip(
            torch.from_numpy(z), None if b is None else torch.from_numpy(b),
            None if pr is None else torch.from_numpy(pr)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_codec_registry():
    assert isinstance(pcodecs.get_codec(None), pcodecs.IdentityCodec)
    c = pcodecs.QuantCodec(3)
    assert pcodecs.get_codec(c) is c
    t4 = pcodecs.get_codec("topk4")
    assert (type(t4), t4.name, t4.k, t4.renormalize, t4.index_bytes) == (
        pcodecs.TopKCodec, "topk4", 4, True, 4.0)
    d2 = pcodecs.get_codec("cache_delta+topk2", index_bytes=1)
    assert (d2.name, d2.inner.name, d2.inner.k, d2.inner.renormalize,
            d2.inner.index_bytes) == ("cache_delta+topk2", "topk2", 2, False, 1.0)
    assert pcodecs.get_codec("topk").k == 2
    for bad in ("nope", "cache_deltaX"):
        with pytest.raises(ValueError):
            pcodecs.get_codec(bad)


# ---------------------------------------------------------------------------
# core/era, models/resnet (MLP)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta", [0.5, 1.0, 2.5])
def test_era_functions_match_reference(beta):
    z = _probs(np.random.default_rng(2), (20, 10))
    zt, zj = torch.from_numpy(z), jnp.asarray(z)
    np.testing.assert_allclose(pera.enhanced_era(zt, beta).numpy(),
                               np.asarray(jera.enhanced_era(zj, beta)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(pera.era(zt, 0.1).numpy(),
                               np.asarray(jera.era(zj, 0.1)), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pera.entropy(zt).numpy(),
                               np.asarray(jera.entropy(zj)), rtol=0, atol=ATOL)


@pytest.mark.parametrize("depth", [0, 2])
def test_mlp_forward_matches_reference(depth):
    import jax

    rng = np.random.default_rng(depth)
    keys = jax.random.split(jax.random.PRNGKey(depth), 4)
    stacked = jax.vmap(lambda k: jresnet.init_mlp(k, 8, 5, 16, depth))(keys)
    sp = {k: np.array(v) for k, v in stacked.items()}  # writable copies
    x = rng.normal(size=(4, 11, 8)).astype(np.float32)
    want = np.asarray(jax.vmap(jresnet.apply_mlp)(stacked, jnp.asarray(x)))
    got = presnet.apply_mlp({k: torch.from_numpy(v) for k, v in sp.items()},
                            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # one model, and a shared input broadcast over the stack
    one = {k: torch.from_numpy(v[0]) for k, v in sp.items()}
    np.testing.assert_allclose(presnet.apply_mlp(one, torch.from_numpy(x[0])).numpy(),
                               want[0], rtol=1e-5, atol=1e-5)
    shared = presnet.apply_mlp({k: torch.from_numpy(v) for k, v in sp.items()},
                               torch.from_numpy(x[0]))
    np.testing.assert_allclose(shared.numpy()[0], want[0], rtol=1e-5, atol=1e-5)


def test_init_mlp_is_he_normal():
    p = presnet.init_mlp(prng.split(prng.key(0), 50), 64, 10, 128, 2)
    assert p["w0"].shape == (50, 64, 128) and p["b2"].shape == (50, 10)
    for i, fan_in in enumerate([64, 128, 128]):
        std = float(p[f"w{i}"].std())
        assert abs(std - np.sqrt(2.0 / fan_in)) < 0.02 * np.sqrt(2.0 / fan_in)
        assert float(p[f"b{i}"].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# fl/scenarios offline masks, fl/strategies fixed-shape hooks
# ---------------------------------------------------------------------------

def test_offline_masks_equal_reference():
    outages = (2, 3, 5), (0, 1, 1), (4, 2, 9)
    js = jscen.Scenario(outages=tuple(jscen.Outage(*o) for o in outages))
    ps = pscen.Scenario(outages=tuple(pscen.Outage(*o) for o in outages))
    for T, start in [(6, 1), (4, 3), (0, 7)]:
        want = js.offline_masks(T, 5, start=start)
        got = ps.offline_masks(T, 5, start=start)
        assert got.shape == want.shape == (T, 5)
        np.testing.assert_array_equal(got, want)


def _strategy_pair(method, **kw):
    from repro.fl.strategies import STRATEGIES as JS
    return JS[method](**kw), pfl.STRATEGIES[method](**kw)


_STRATEGY_CASES = [("scarlet", {"beta": 1.5}), ("scarlet", {"beta": "adaptive"}),
                   ("dsfl", {}), ("dsfl", {"T": 0.5})]


@pytest.mark.parametrize("method,kw", _STRATEGY_CASES)
def test_two_phase_contract_equals_reference(method, kw):
    """partial/finalize/aggregate_masked against the reference, and
    aggregate_masked against aggregate on the participants (atol 1e-6:
    float32 sums in other orders)."""
    js, ps = _strategy_pair(method, **kw)
    assert ps.scan_safe and js.scan_safe
    assert ps.supports_fused_round == js.supports_fused_round
    rng = np.random.default_rng(4)
    z = _probs(rng, (6, 9, 10))
    part = np.array([1, 0, 1, 1, 0, 1], np.float32)
    jz, pz = jnp.asarray(z), torch.from_numpy(z)
    jp, pp = jnp.asarray(part), torch.from_numpy(part)
    jpart, ppart = js.partial_aggregate(jz, jp, None, 1), ps.partial_aggregate(pz, pp, None, 1)
    np.testing.assert_allclose(ppart["zsum"].numpy(), np.asarray(jpart["zsum"]),
                               rtol=0, atol=ATOL)
    assert float(ppart["wsum"]) == float(jpart["wsum"]) == 4.0
    np.testing.assert_allclose(ps.finalize_aggregate(ppart, 1).numpy(),
                               np.asarray(js.finalize_aggregate(jpart, 1)),
                               rtol=0, atol=ATOL)
    masked = ps.aggregate_masked(pz, pp, None, 1).numpy()
    np.testing.assert_allclose(masked, np.asarray(js.aggregate_masked(jz, jp, None, 1)),
                               rtol=0, atol=ATOL)
    subset, _ = ps.aggregate(pz[pp > 0], None, 1)
    np.testing.assert_allclose(masked, subset.numpy(), rtol=0, atol=ATOL)
    # total outage: the uniform teacher, as the two-phase path gives it
    zero = torch.zeros(6)
    np.testing.assert_allclose(ps.aggregate_masked(pz, zero, None, 1).numpy(),
                               np.asarray(js.aggregate_masked(jz, jnp.zeros(6), None, 1)),
                               rtol=0, atol=ATOL)


def test_base_strategy_hooks():
    s = pfl.Strategy()
    z = torch.rand(3, 4, 5)
    assert s.transmit(z) is z and s.upload_mask(z) is None
    assert not s.scan_safe and not s.supports_fused_round
    with pytest.raises(NotImplementedError):
        s.aggregate_masked_fused(z, torch.ones(3), {"mode": "identity", "bits": None},
                                 None, 1)
    with pytest.raises(NotImplementedError):
        s.partial_aggregate_fused(z, torch.ones(3), {"mode": "identity", "bits": None},
                                  None, 1)


@pytest.mark.parametrize("n", [2, 3, 5, 10, 100, 1000])
def test_adaptive_beta_divides_by_the_reference_float32_log(n):
    """``_adaptive_beta`` divides by ``math.log(n)`` (a Python float, no
    host-to-device copy); in float32 that is the reference's jnp.log(n)."""
    js, ps = _strategy_pair("scarlet", beta="adaptive", beta_max=3.0)
    zbar = _probs(np.random.default_rng(n), (7, n))
    got = ps._adaptive_beta(torch.from_numpy(zbar))
    want = js._adaptive_beta(jnp.asarray(zbar))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert np.float32(np.log(n)) == np.asarray(jnp.log(n))


def test_state_dict_is_the_fixed_structure():
    cfg = pfl.FLConfig(**_TINY)
    eng = pfl.FederatedDistillation(cfg, pfl.STRATEGIES["scarlet"](), cache_duration=2,
                                    device="cpu")
    st = eng.state_dict()
    assert set(st) == {"t_done", "client_params", "server_params", "cache", "prev_idx",
                       "prev_teacher", "have_prev", "teacher_val", "have_tv",
                       "last_sync"}
    m, N = cfg.public_per_round, cfg.n_classes
    assert st["prev_idx"].shape == (m,) and st["prev_teacher"].shape == (m, N)
    assert not bool(st["have_prev"]) and not bool(st["have_tv"])
    assert st["last_sync"].dtype == torch.int32 and int(st["t_done"]) == 0
    eng.run(1)
    st = eng.state_dict()
    assert bool(st["have_prev"]) and bool(st["have_tv"]) and int(st["t_done"]) == 1
    assert st["prev_teacher"].shape == (m, N)
    assert st["teacher_val"].shape == (len(eng.pub_val_idx), N)
    assert st["last_sync"].tolist() == [1] * cfg.n_clients


# ---------------------------------------------------------------------------
# Device and carry-over contracts
# ---------------------------------------------------------------------------

_TINY = dict(n_clients=4, n_classes=4, dim=8, rounds=2, local_steps=1,
             distill_steps=1, public_size=40, public_per_round=8,
             private_size=60, hidden=8, eval_every=1)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = pfl.FLConfig(**_TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfl.run_method("scarlet", cfg, cache_duration=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfl.FederatedDistillation(cfg, pfl.STRATEGIES["scarlet"]())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfl.run_method("scarlet", cfg, cache_duration=2, engine="active")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfl.run_method("scarlet", cfg, cache_duration=2, engine="async",
                       traffic=pfl.TrafficModel())
    h = pfl.run_method("scarlet", cfg, cache_duration=2, engine="async",
                       traffic=pfl.TrafficModel(), device="cpu")
    assert h.ledger.summary()["rounds"] == 2.0
    models = ClientModels(resolve_cohorts(cfg), cfg.dim, cfg.n_classes)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClientParamStore(models, prng.split(prng.key(0), cfg.n_clients))
    store = ClientParamStore(models, prng.split(prng.key(0), cfg.n_clients), device="cpu")
    assert store.gather(0, np.arange(2))["w0"].device.type == "cpu"
    h = pfl.run_method("scarlet", cfg, cache_duration=2, device="cpu")
    assert h.ledger.summary()["rounds"] == 2.0
    # the model families: whisper's, jamba's and mamba2's entry points
    from repro_torch.configs import registry as creg
    from repro_torch.launch.specs import make_batch
    from repro_torch.models import convert, registry

    for name in ("whisper-large-v3", "jamba-v0.1-52b", "mamba2-1.3b"):
        mcfg = creg.get(name).reduced()
        for call in (lambda: registry.init(mcfg, torch.Generator()),
                     lambda: make_batch(mcfg, 1, 8),
                     lambda: registry.init_decode_cache(mcfg, 1, 8),
                     lambda: convert.params_from_numpy(mcfg, {}),
                     lambda: convert.cache_from_numpy(mcfg, {})):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
        cache = registry.init_decode_cache(mcfg, 1, 8, device="cpu")
        assert all(t.device.type == "cpu" for t in cache.values())
        assert make_batch(mcfg, 1, 8, device="cpu")["tokens"].device.type == "cpu"


def test_unported_options_raise():
    cfg = pfl.FLConfig(**_TINY)
    # the jax key stream is ported: it runs on every engine (the host loop
    # draws numpy by default, the device engines jax), and an unknown
    # stream is refused
    for engine in ("host", "scan"):
        h = pfl.run_method("scarlet", cfg, device="cpu", engine=engine, rng_backend="jax")
        assert h.ledger.summary()["rounds"] == 2.0
    with pytest.raises(ValueError, match="rng_backend"):
        pfl.run_method("scarlet", cfg, device="cpu", rng_backend="philox")
    # the active-set, async and sharded engines are ported: they run (the
    # sharded one in a world of one)
    for engine in ("active", "async", "shard"):
        h = pfl.run_method("scarlet", cfg, device="cpu", engine=engine)
        assert h.ledger.summary()["rounds"] == 2.0
    # telemetry is ported: it runs and fills History.telemetry
    h = pfl.run_method("scarlet", cfg, device="cpu", telemetry=True)
    assert len(h.telemetry) == h.ledger.summary()["rounds"] == 2.0
    for method in ("fedavg", "individual"):
        for kw in [dict(engine="shard"), dict(engine="scan"), dict(rng_backend="numpy"),
                   dict(codec="quant8"), dict(telemetry=True)]:
            with pytest.raises(ValueError, match=method):
                pfl.run_method(method, cfg, device="cpu", **kw)
    h = pfl.run_method("comet", cfg, device="cpu")
    assert h.ledger.summary()["rounds"] == 2.0
    with pytest.raises(ValueError):
        pfl.run_method("scarlet", cfg, engine="bogus", device="cpu")


def test_load_params_checks_types_and_shapes():
    cfg = pfl.FLConfig(**_TINY)
    eng = pfl.FederatedDistillation(cfg, pfl.STRATEGIES["dsfl"](), device="cpu")
    cp = [{k: v.numpy() for k, v in p.items()} for p in eng.client_params]
    sp = {k: v.numpy() for k, v in eng.server_params.items()}
    eng.load_params(cp, sp)
    with pytest.raises(TypeError):
        eng.load_params([{k: v.astype(np.float64) for k, v in cp[0].items()}], sp)
    with pytest.raises(ValueError):
        eng.load_params([{k: v[:2] for k, v in cp[0].items()}], sp)


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_slice.py"]
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"src/repro_torch/fl/scan_engine.py",
            "src/repro_torch/kernels/round_kernel.py"} <= names
    assert len(files) > 15
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f} imports {mod}"
