"""The port's ``jax.random`` key stream (``repro_torch.core.prng``) against
``jax.random`` itself, on the CPU.

Every function but ``normal`` must give jax's bits: ``np.array_equal`` on
the uint32 words (held as int64) and on the float32 uniforms, for the
seeds and shapes below, for a batch of keys against ``jax.vmap``, and for
``choice(replace=False)`` at the sizes the FL path draws (n = 1, 60, 100
and 10^4: 0, 1, 1 and 2 sort rounds) and by selection, one key over many
items a chunk at a time (the active engine's participation over K).  ``normal`` evaluates the same
single-precision inverse error function, whose last bit may round
otherwise: it is held at atol 1e-6 (its values are below 6 in
magnitude, where a float32 ulp is at most 4.8e-7), and so are the
reference's ``init_mlp``.  The
stream's users follow: the expiry draw of ``cache.miss_mask``, the
participation draws of ``Scenario.participation_mask_device`` and the
client store's chunked initialisation.  The kernel's own launch layout
is checked here on its arithmetic; the kernel itself runs in
``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fl as R
from repro.core import cache as rcache
from repro.models import resnet as rresnet
from repro_torch.checkpoint import ClientParamStore
from repro_torch.core import cache as pcache
from repro_torch.core import prng
from repro_torch.fl.cohorts import ClientModels, CohortSpec
from repro_torch.fl.scenarios import (Outage, Participation, Scenario,
                                      bernoulli_participation, fixed_fraction)
from repro_torch.kernels import prng_kernel
from repro_torch.models import resnet as presnet

SEEDS = (0, 1, 7, 123456, 2 ** 31 - 1)
SHAPES = ((1,), (7, 9), (1000,), (3, 5, 11))


def _words(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_and_split_are_jax_bits(seed):
    k, t = jax.random.PRNGKey(seed), prng.key(seed)
    assert np.array_equal(_words(k), t.numpy())
    for num in (2, 3, 101):
        assert np.array_equal(_words(jax.random.split(k, num)), prng.split(t, num).numpy())
    for d in (0, 43, 71, 2 ** 32 - 1):
        assert np.array_equal(_words(jax.random.fold_in(k, d)), prng.fold_in(t, d).numpy())
    # a run of folds is one hash: the leg's round keys
    run = prng.fold_in(t, 5, count=4).numpy()
    assert np.array_equal(run, np.stack([_words(jax.random.fold_in(k, d))
                                         for d in range(5, 9)]))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_uniform_and_normal(seed, shape):
    k, t = jax.random.fold_in(jax.random.PRNGKey(seed), 3), prng.fold_in(prng.key(seed), 3)
    assert np.array_equal(_words(jax.random.bits(k, shape)), prng.random_bits(t, shape).numpy())
    u = prng.uniform(t, shape)
    assert u.dtype == torch.float32 and u.shape == shape
    assert np.array_equal(np.asarray(jax.random.uniform(k, shape)), u.numpy())
    n = prng.normal(t, shape)
    assert n.dtype == torch.float32 and n.shape == shape
    np.testing.assert_allclose(n.numpy(), np.asarray(jax.random.normal(k, shape)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 60, 100, 10000])
def test_choice_without_replacement_is_jax_bits(n):
    assert prng.shuffle_rounds(n) == {1: 0, 60: 1, 100: 1, 10000: 2}[n]
    for seed in SEEDS:
        k, t = jax.random.PRNGKey(seed), prng.key(seed)
        for m in sorted({1, min(n, 24), n}):
            want = np.asarray(jax.random.choice(k, n, (m,), replace=False))
            assert np.array_equal(want, prng.choice(t, n, m).numpy()), (seed, m)
        assert np.array_equal(np.asarray(jax.random.permutation(k, n)),
                              prng.permutation(t, n).numpy())


@pytest.mark.parametrize("n,chunk", [(100, 32), (10000, 3001), (2 ** 17 + 3, None)],
                         ids=["100-chunks-of-32", "10000-chunks-of-3001", "2^17+3"])
def test_choice_by_selection_is_jax_bits(n, chunk, monkeypatch):
    """One key over many items: ``choice`` selects its m in chunks, never
    sorting all n (here from n = 100 up, with chunks that leave a short
    last one); the same bits as jax's sort."""
    if chunk is not None:
        monkeypatch.setattr(prng, "SELECT_MIN_N", 1)
        monkeypatch.setattr(prng, "SELECT_CHUNK", chunk)
    assert n >= prng.SELECT_MIN_N

    def no_sort(*a, **k):
        raise AssertionError("choice sorted all n")

    monkeypatch.setattr(prng, "permutation", no_sort)
    for seed in (0, 123456):
        k, t = jax.random.PRNGKey(seed), prng.key(seed)
        for m in sorted({1, 64, min(n, 1000)} | ({n} if n <= 10000 else set())):
            want = np.asarray(jax.random.choice(k, n, (m,), replace=False))
            got = prng.choice(t[None], n, m)
            assert got.shape == (1, m) and np.array_equal(want, got[0].numpy()), (seed, m)


def test_a_batch_of_keys_is_jax_vmap():
    keys = jax.random.split(jax.random.PRNGKey(11), 5)
    t = torch.from_numpy(_words(keys))
    vm = lambda f: np.asarray(jax.vmap(f)(keys))  # noqa: E731
    assert np.array_equal(_words(vm(lambda k: jax.random.split(k, 3))), prng.split(t, 3).numpy())
    assert np.array_equal(_words(vm(lambda k: jax.random.fold_in(k, 9))),
                          prng.fold_in(t, 9).numpy())
    assert np.array_equal(_words(vm(lambda k: jax.random.bits(k, (5, 2)))),
                          prng.random_bits(t, (5, 2)).numpy())
    assert np.array_equal(vm(lambda k: jax.random.uniform(k, (7,))),
                          prng.uniform(t, (7,)).numpy())
    assert np.array_equal(vm(lambda k: jax.random.choice(k, 100, (10,), replace=False)),
                          prng.choice(t, 100, 10).numpy())
    np.testing.assert_allclose(prng.normal(t, (6,)).numpy(),
                               vm(lambda k: jax.random.normal(k, (6,))), rtol=0, atol=1e-6)
    # leading axes of any rank: the (5, 2) batch as (5, 1, 2) and (1, 5, 2)
    for shaped in (t[:, None], t[None]):
        got = prng.uniform(shaped, (7,))
        assert np.array_equal(got.reshape(5, 7).numpy(), vm(lambda k: jax.random.uniform(k, (7,))))


def test_erfinv_matches_lax_and_its_edges():
    x = np.float32(np.linspace(-1, 1, 20001))
    got = prng.erfinv_f32(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    assert np.isinf(got[0]) and got[0] < 0 and np.isinf(got[-1]) and got[-1] > 0
    np.testing.assert_allclose(got[1:-1], want[1:-1], rtol=2e-7, atol=1e-7)


def test_plain_hash_refuses_misuse():
    t = prng.key(0)
    with pytest.raises(ValueError, match="uint32"):
        prng.fold_in(t, -1)
    with pytest.raises(ValueError, match="int64"):
        prng.split(t.to(torch.int32))
    with pytest.raises(ValueError, match="without replacement"):
        prng.choice(t, 5, 6)
    with pytest.raises(ValueError, match="mode"):
        prng_kernel.threefry(t[None], 0, 3, "gauss")
    # an empty batch and an empty count are empty, not errors
    assert prng.split(torch.zeros((0, 2), dtype=torch.int64)).shape == (0, 2, 2)
    assert prng.random_bits(t, (0,)).shape == (0,)


@pytest.mark.parametrize("n_keys,count,want", [
    (1, 1, (0, 1, 1)), (300, 2, (1, 3, 1)), (10 ** 6 + 1, 2, (1, 7813, 1)),
    (1, 10 ** 6 + 1, (8, 1, 1024)), (300, 10000, (8, 204, 40)), (100, 100, (7, 50, 1)),
    (300, 1000, (8, 300, 4)), (7, 3, (2, 1, 1)),
])
def test_kernel_layout_covers_every_count(n_keys, count, want):
    """The kernel's threads: 2^lanes_log2 a key, the block's other threads
    on the next keys, grid y over chunks of counts; every (key, count) is
    reached once by the grid-stride loops (replayed here)."""
    lanes_log2, gx, gy = prng_kernel.layout(n_keys, count)
    assert (lanes_log2, gx, gy) == want
    lanes = 1 << lanes_log2
    per_block = prng_kernel.THREADS // lanes
    assert lanes >= min(count, prng_kernel.THREADS) and gx * gy <= prng_kernel.MAX_BLOCKS
    if n_keys * count <= 10 ** 5:
        seen = np.zeros((n_keys, count), np.int64)
        for bx in range(gx):
            for sub in range(per_block):
                for k in range(bx * per_block + sub, n_keys, gx * per_block):
                    for by in range(gy):
                        for lane in range(lanes):
                            seen[k, by * lanes + lane::gy * lanes] += 1
        assert (seen == 1).all()


# ---------------------------------------------------------------------------
# The stream's users
# ---------------------------------------------------------------------------

def test_init_mlp_matches_the_reference_and_cohorts_take_global_keys():
    """One model against the reference's ``init_mlp`` (under ``jax.jit``:
    one compile instead of one an op), at the FL configs' layout (dim 8,
    hidden 16); a stack of keys is the models of its keys one by one, and
    each cohort's clients take their global keys.  The engines' initial
    parameters are held against the reference's ``ClientModels.init_params``
    in ``tests/test_torch_rng_parity.py``."""
    key = jax.random.PRNGKey(5)
    one = presnet.init_mlp(prng.key(5), 8, 10, 16, 2)
    want = jax.jit(lambda k: rresnet.init_mlp(k, 8, 10, 16, 2))(key)
    assert sorted(one) == sorted(want)
    for name, v in want.items():
        assert one[name].dtype == torch.float32 and tuple(one[name].shape) == v.shape
        np.testing.assert_allclose(one[name].numpy(), np.asarray(v), rtol=0, atol=1e-6)
    keys = prng.split(prng.key(5), 7)
    pm = ClientModels([CohortSpec(4, 16, 1), CohortSpec(3, 16, 2)], 8, 10)
    for (lo, depth), stack in zip(((0, 1), (4, 2)), pm.init_params(keys)):
        for i in range(len(stack["w0"])):
            single = presnet.init_mlp(keys[lo + i], 8, 10, 16, depth)
            for name, v in single.items():
                assert torch.equal(stack[name][i], v)


def test_store_init_is_the_dense_init_in_any_chunks():
    models = ClientModels([CohortSpec(20, 3, 1), CohortSpec(17, 6, 2)], 5, 4)
    keys = prng.split(prng.key(0), 37)
    dense = models.init_params(keys)
    for chunk in (1, 3, 16, 4096):
        store = ClientParamStore(models, keys, device="cpu", init_chunk=chunk)
        for got, want in zip(store.as_param_list(), dense):
            assert list(got) == list(want)
            for name in want:
                assert got[name].dtype == np.float32
                np.testing.assert_array_equal(got[name], want[name].numpy())


@pytest.mark.parametrize("seed", [0, 3])
def test_probabilistic_miss_mask_draws_from_the_key(seed):
    rng = np.random.default_rng(seed)
    P, m, N, D, t = 50, 20, 4, 3, 9
    ts = rng.integers(0, t, P).astype(np.int32)
    present = rng.random(P) < 0.8
    idx = np.sort(rng.choice(P, m, replace=False))
    rc = rcache.CacheState(jnp.zeros((P, N)), jnp.asarray(ts), jnp.asarray(present))
    pc = pcache.CacheState(torch.zeros(P, N), torch.from_numpy(ts), torch.from_numpy(present))
    want = rcache.miss_mask(rc, jnp.asarray(idx), t, D, probabilistic=True,
                            key=jax.random.fold_in(jax.random.PRNGKey(seed), t))
    got = pcache.miss_mask(pc, torch.from_numpy(idx), t, D, probabilistic=True,
                           key=prng.fold_in(prng.key(seed), t))
    assert np.array_equal(np.asarray(want), got.numpy())
    with pytest.raises(ValueError, match="key"):
        pcache.miss_mask(pc, torch.from_numpy(idx), t, D, probabilistic=True)


@pytest.mark.parametrize("name", ["full", "fraction", "bernoulli", "outage", "conscript"])
def test_participation_mask_device_is_the_references(name):
    K = 100
    part = {"full": ("full", 1.0), "fraction": ("fraction", 0.3),
            "bernoulli": ("bernoulli", 0.3), "outage": ("fraction", 0.5),
            "conscript": ("bernoulli", 0.01)}[name]
    outages = tuple((k, 2, 4) for k in range(0, K, 3)) if name in ("outage", "conscript") else ()
    mins = 5 if name == "conscript" else 1
    ps = Scenario(participation=Participation(*part),
                  outages=tuple(Outage(*o) for o in outages), min_participants=mins)
    rs = R.Scenario(participation=R.Participation(*part),
                    outages=tuple(R.Outage(*o) for o in outages), min_participants=mins)
    keys = jax.random.split(jax.random.PRNGKey(2), 6)
    off = ps.offline_masks(6, K, start=1)
    want = np.stack([np.asarray(rs.participation_mask_device(k, jnp.asarray(o)))
                     for k, o in zip(keys, off)])
    got = ps.participation_mask_device(torch.from_numpy(_words(keys)), torch.from_numpy(off))
    assert got.dtype == torch.bool and np.array_equal(want, got.numpy())
    assert name != "conscript" or (got.sum(-1) >= mins).all()


def test_fraction_and_bernoulli_helpers_sample_the_same_policy():
    keys = prng.split(prng.key(4), 3)
    assert fixed_fraction(0.25).sample_device(keys, 40).sum(-1).tolist() == [10, 10, 10]
    b = bernoulli_participation(0.5).sample_device(keys, 1000)
    assert b.shape == (3, 1000) and 0.4 < float(b.float().mean()) < 0.6


def test_the_stream_imports_no_jax_and_nothing_of_the_reference():
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    for f in (root / "core" / "prng.py", root / "kernels" / "prng_kernel.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("jax", "repro") for n in names), f
