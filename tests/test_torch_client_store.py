"""The port's client-parameter store (``repro_torch.checkpoint.store``) and
the sorted catch-up count (``catch_up_bytes_device(method="sorted")``), on
the CPU: the counterparts of the reference's ``tests/test_client_store.py``.

The store must hold exactly what the dense engines draw: each client's
parameters from its own key of the reference's key stream
(``ClientModels.init_params``), drawn in chunks of ``init_chunk`` clients;
the stream is counter-based, so the chunking changes nothing, whatever the
widths (rows of 15, 9 and 12 values here).  Files move both ways: the
reference's store loads what the port's saves, shard names included.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.fl as R
from repro.checkpoint.store import ClientParamStore as RStore
from repro_torch.checkpoint import CheckpointKeyError, ClientParamStore
from repro_torch.core import cache as cache_lib
from repro_torch.core import prng
from repro_torch.fl.cohorts import ClientModels, CohortSpec, resolve_cohorts
from repro_torch.fl.config import FLConfig
from repro_torch.models.resnet import init_mlp

# widths whose rows hold 15, 9 and 12 values
CFG = FLConfig(n_clients=37, n_classes=4, dim=5, hidden=3, mlp_depth=2)
COHORTS = (CohortSpec(20, 3, 1), CohortSpec(17, 6, 2))


def _models(cfg):
    return ClientModels(resolve_cohorts(cfg), cfg.dim, cfg.n_classes)


def _keys(models, seed=0):
    return prng.split(prng.key(seed), models.n_clients)


def _dense(models, seed=0):
    return models.init_params(_keys(models, seed))


def _store(models, seed=0, **kw):
    return ClientParamStore(models, _keys(models, seed), device="cpu", **kw), None


def _assert_store_equals(store, params):
    got = store.as_param_list()
    assert len(got) == len(params)
    for g, p in zip(got, params):
        assert list(g) == list(p)
        for k in p:
            assert g[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], p[k].numpy())


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [CFG, dataclasses.replace(CFG, cohorts=COHORTS)],
                         ids=["one-cohort", "two-cohorts"])
@pytest.mark.parametrize("init_chunk", [1, 3, 16, 4096])
def test_store_init_matches_dense_init_bitwise(cfg, init_chunk):
    models = _models(cfg)
    params = _dense(models)
    store, _ = _store(models, init_chunk=init_chunk)
    _assert_store_equals(store, params)
    # a client's row is its own key's model, whatever chunk drew it
    keys = _keys(models)
    for c, (spec, sl) in enumerate(zip(models.cohorts, models.slices)):
        for k in (sl.start, sl.stop - 1):
            one = init_mlp(keys[k], cfg.dim, cfg.n_classes, spec.hidden, spec.depth)
            for name, v in one.items():
                np.testing.assert_array_equal(store.as_param_list()[c][name][k - sl.start],
                                              v.numpy())


# ---------------------------------------------------------------------------
# The data path
# ---------------------------------------------------------------------------

def test_store_gather_scatter_roundtrip():
    store, _ = _store(_models(CFG), init_chunk=8)
    rows = np.array([3, 0, 36, 17])
    got = store.gather(0, rows)
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.shape[0] == 4
        np.testing.assert_array_equal(v.numpy(), store.as_param_list()[0][k][rows])
    before = {k: v.copy() for k, v in store.as_param_list()[0].items()}
    new = {k: v + 1.0 for k, v in got.items()}
    store.scatter(0, rows, new)
    after = store.as_param_list()[0]
    for k in new:
        np.testing.assert_array_equal(after[k][rows], new[k].numpy())
        rest = np.setdiff1d(np.arange(37), rows)
        np.testing.assert_array_equal(after[k][rest], before[k][rest])
    # the gathered tensors are copies: the scatter did not move them
    np.testing.assert_array_equal(got["w0"].numpy(), before["w0"][rows])
    sl = store.gather(0, slice(4, 9))
    np.testing.assert_array_equal(sl["w1"].numpy(), after["w1"][4:9])


def test_store_memmap_backing_matches_ram(tmp_path):
    cfg = dataclasses.replace(CFG, cohorts=COHORTS)
    ram, _ = _store(_models(cfg), init_chunk=5)
    mm, _ = _store(_models(cfg), init_chunk=5, backing="memmap", directory=str(tmp_path / "m"))
    assert mm.nbytes == ram.nbytes and mm.n_cohorts == ram.n_cohorts == 2
    for a, b in zip(mm.as_param_list(), ram.as_param_list()):
        assert isinstance(a["w0"], np.memmap)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    assert sorted(p.name for p in (tmp_path / "m").iterdir())[:2] == [
        "cohort0_b0.npy", "cohort0_b1.npy"]


def test_store_nbytes_counts_every_float():
    store, _ = _store(_models(CFG))
    per_client = 5 * 3 + 3 + 3 * 3 + 3 + 3 * 4 + 4
    assert store.nbytes == 37 * per_client * 4


def test_store_rejects_bad_backing(tmp_path):
    m = _models(CFG)
    with pytest.raises(ValueError, match="backing"):
        ClientParamStore(m, _keys(m), backing="tape")
    with pytest.raises(ValueError, match="directory"):
        ClientParamStore(m, _keys(m), backing="memmap")


def test_store_ingest_validates_structure():
    store, _ = _store(_models(CFG))
    params = [{k: v.copy() for k, v in p.items()} for p in store.as_param_list()]
    with pytest.raises(ValueError, match="cohort stacks"):
        store.ingest_param_list(params + params)
    bad = [{k: v[:5] for k, v in params[0].items()}]
    with pytest.raises(ValueError, match="stack shape"):
        store.ingest_param_list(bad)
    with pytest.raises(ValueError, match="leaves"):
        store.ingest_param_list([{k: v for k, v in params[0].items() if k != "b2"}])
    # tensors from any device are taken as they are
    store.ingest_param_list([{k: torch.from_numpy(v * 2.0) for k, v in params[0].items()}])
    np.testing.assert_array_equal(store.as_param_list()[0]["w1"], params[0]["w1"] * 2.0)


# ---------------------------------------------------------------------------
# Persistence, and files moved to and from the reference's store
# ---------------------------------------------------------------------------

def _reference_store(cfg, **kw):
    models = R.ClientModels(R.resolve_cohorts(cfg), cfg.dim, cfg.n_classes)
    keys = jax.random.split(jax.random.PRNGKey(1), cfg.n_clients)
    return RStore(models, keys, **kw)


def _rcfg(cfg):
    return R.FLConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                         if f.name != "cohorts"},
                      cohorts=None if cfg.cohorts is None else tuple(
                          R.CohortSpec(c.n_clients, c.hidden, c.depth) for c in cfg.cohorts))


def test_store_save_load_roundtrip(tmp_path):
    cfg = dataclasses.replace(CFG, cohorts=COHORTS)
    a, _ = _store(_models(cfg))
    b, _ = _store(_models(cfg), seed=5)
    a.save(str(tmp_path / "s.npz"))
    b.load(str(tmp_path / "s.npz"))
    for x, y in zip(a.as_param_list(), b.as_param_list()):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    # the reference's store loads the port's file leaf for leaf
    ref = _reference_store(_rcfg(cfg))
    ref.load(str(tmp_path / "s.npz"))
    for x, y in zip(a.as_param_list(), ref.as_param_list()):
        for k in x:
            np.testing.assert_array_equal(x[k], np.asarray(y[k]))


def test_store_sharded_save_load_roundtrip(tmp_path):
    cfg = dataclasses.replace(CFG, cohorts=COHORTS)
    a, _ = _store(_models(cfg))
    a.save_sharded(str(tmp_path / "sh"), clients_per_shard=8)
    names = sorted(p.name for p in (tmp_path / "sh").iterdir())
    assert names[:3] == ["cohort0_clients_00000000_00000008.npz",
                         "cohort0_clients_00000008_00000016.npz",
                         "cohort0_clients_00000016_00000020.npz"]
    assert len(names) == 3 + 3
    b, _ = _store(_models(cfg), seed=5, backing="memmap", directory=str(tmp_path / "mm"))
    b.load_sharded(str(tmp_path / "sh"), clients_per_shard=8)
    for x, y in zip(a.as_param_list(), b.as_param_list()):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    # the reference's shards, under the same names, load into the port's store
    ref = _reference_store(_rcfg(cfg))
    ref.save_sharded(str(tmp_path / "ref"), clients_per_shard=8)
    b.load_sharded(str(tmp_path / "ref"), clients_per_shard=8)
    for x, y in zip(ref.as_param_list(), b.as_param_list()):
        for k in y:
            np.testing.assert_array_equal(np.asarray(x[k]), y[k])


def test_store_load_sharded_missing_shard(tmp_path):
    a, _ = _store(_models(CFG))
    a.save_sharded(str(tmp_path), clients_per_shard=10)
    (tmp_path / "cohort0_clients_00000010_00000020.npz").unlink()
    with pytest.raises(CheckpointKeyError, match="missing store shard"):
        a.load_sharded(str(tmp_path), clients_per_shard=10)


# ---------------------------------------------------------------------------
# The sorted catch-up count
# ---------------------------------------------------------------------------

def _random_cache(rng, P, N):
    ts = rng.integers(-3, 40, P).astype(np.int32)
    present = rng.random(P) < 0.6
    ts[~present & (rng.random(P) < 0.5)] = cache_lib._NEVER  # never cached
    return cache_lib.CacheState(torch.from_numpy(rng.random((P, N), dtype=np.float32)),
                                torch.from_numpy(ts), torch.from_numpy(present))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_catch_up_bytes_sorted_matches_dense_bitwise(seed):
    rng = np.random.default_rng(seed)
    for K, P in ((1, 7), (193, 41), (1001, 64), (37, 1)):
        cache = _random_cache(rng, P, 10)
        last_sync = rng.integers(0, 42, K).astype(np.int32)
        last_sync[rng.random(K) < 0.2] = cache_lib._NEVER  # clients that never synced
        last_sync = torch.from_numpy(last_sync)
        part = torch.from_numpy(rng.random(K) < 0.5)
        for t in (1, 2, 20, 43):
            dense = cache_lib.catch_up_bytes_device(cache, last_sync, part, t)
            srt = cache_lib.catch_up_bytes_device(cache, last_sync, part, t, method="sorted")
            assert dense.dtype == srt.dtype == torch.float32
            assert torch.equal(dense, srt), (K, P, t, dense, srt)
            # an int64 last_sync (the host's) counts the same
            wide = cache_lib.catch_up_bytes_device(cache, last_sync.to(torch.int64), part, t,
                                                   method="sorted")
            assert torch.equal(dense, wide)


def test_catch_up_bytes_sorted_counts_each_newer_entry():
    cache = cache_lib.CacheState(torch.zeros(4, 3), torch.tensor([5, 2, 9, 7], dtype=torch.int32),
                                 torch.tensor([True, True, False, True]))
    last_sync = torch.tensor([1, 6, 2, cache_lib._NEVER], dtype=torch.int32)
    part = torch.tensor([True, True, False, True])
    got = cache_lib.catch_up_bytes_device(cache, last_sync, part, 10, method="sorted")
    # client 0: entries 5, 2, 7 newer than 1; client 1: 7; client 3: all 3 present
    assert float(got) == (3 + 1 + 3) * (3 * 4.0 + 8.0)


def test_catch_up_bytes_rejects_unknown_method():
    cache = cache_lib.init_cache(4, 3)
    with pytest.raises(ValueError, match="unknown catch-up method"):
        cache_lib.catch_up_bytes_device(cache, torch.zeros(2, dtype=torch.int32),
                                        torch.ones(2, dtype=torch.bool), 3, method="bisect")
