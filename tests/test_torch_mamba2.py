"""The port's Mamba2 (chunked SSD mixer, recurrent decode, the mamba2 LM)
against the JAX package's, on the CPU.

The mixer runs at the reduced mamba2-1.3b configuration (d_model 256,
d_inner 512, 16 heads of 32, SSM state 64, chunk 32, vocab 512, 2 layers,
float32), on the reference's weights carried across by
``params_from_numpy`` and inputs from a numpy seed.  No attention and no
kernel runs here.  Tolerances (float32 throughout):

- ``ssd_chunked`` against the reference's at chunks 8 and 16, with and
  without a carried-in state: outputs and final states atol SSD_ATOL =
  1e-5 and rtol CACHE_RTOL = 1e-5 (the reference's inter-chunk scan is
  log-depth, the port's a loop, so the sums differ in order only; the
  states reach ~20, where float32's step is 2e-6; measured 1.3e-5);
- chunk invariance: the port at chunks 8, 16 and 32 within the same
  tolerance of each other (measured 4.2e-5 on values up to ~20);
- the mixer's prefill and decode, and the LM's logits and caches, atol
  ATOL = 2e-5 (measured 5.6e-6 on logits up to 3.2) and, for the float32
  SSM state, which grows over the steps, rtol CACHE_RTOL = 1e-5;
- decode against the port's own prefill, rtol = atol = 5e-3, the
  reference's tolerance for the same check (``tests/test_models.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_1_3b as jconfig
from repro.launch import specs as jspecs
from repro.models import mamba2 as jm2
from repro.models import registry as jreg
from repro_torch.configs import registry as creg
from repro_torch.configs.mamba2_1_3b import CONFIG
from repro_torch.launch.specs import make_batch
from repro_torch.models import convert, mamba2, registry

ATOL = 2e-5
CACHE_RTOL = 1e-5
SSD_ATOL = 1e-5
FORWARD_TOL = 5e-3
CFG = CONFIG.reduced()
JCFG = jconfig.CONFIG.reduced()
B = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (see ``tests/test_torch_jamba.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """(reference params, port params, the numpy tree), the same weights."""
    init = jax.jit(lambda key: jreg.init(JCFG, key)[0])
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    return (jax.tree.map(jnp.asarray, tree), convert.params_from_numpy(CFG, tree, device="cpu"),
            tree)


# the reference's functions, each compiled once a shape
_REF_SSD = jax.jit(jm2.ssd_chunked, static_argnames="chunk")
_REF_MIXER = jax.jit(functools.partial(jm2.mixer_forward, JCFG))
_REF_MIXER_DECODE = jax.jit(functools.partial(jm2.mixer_decode, JCFG))
_REF_FORWARD = jax.jit(functools.partial(jm2.forward, JCFG))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_config_matches_the_reference():
    for c, j in ((CONFIG, jconfig.CONFIG), (CFG, JCFG)):
        assert dataclasses.asdict(c) == dataclasses.asdict(j)
        assert (c.d_inner, c.n_ssm_heads, c.padded_vocab) == \
            (j.d_inner, j.n_ssm_heads, j.padded_vocab)
    assert creg.get("mamba2-1.3b") is CONFIG
    b = make_batch(CFG, B, 24, seed=2, device="cpu")
    assert set(b) == {"tokens"}
    np.testing.assert_array_equal(b["tokens"].numpy(),
                                  np.asarray(jspecs.make_batch(JCFG, B, 24, seed=2)["tokens"]))


def test_params_and_cache_layout_match_the_reference(weights):
    _, p, tree = weights
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(jax.tree.leaves(p))
    for path, ref in flat:
        t = p
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == ref.shape and t.dtype == torch.float32
    drawn = registry.init(CFG, torch.Generator().manual_seed(0), device="cpu")
    assert bool((drawn["layers"]["D_skip"] == 1).all()) and not drawn["layers"]["norm"].any()
    assert drawn["layers"]["in_x"].std().item() == pytest.approx(
        float(tree["layers"]["in_x"].std()), rel=0.05)
    want = jreg.init_decode_cache(JCFG, B, 99)
    got = registry.init_decode_cache(CFG, B, 99, device="cpu")
    assert {n: (tuple(t.shape), str(t.dtype)[6:]) for n, t in got.items()} == \
        {n: (a.shape, str(a.dtype)) for n, a in want.items()}
    assert registry.cache_axes(CFG) == jreg.cache_axes(JCFG)
    bad = dict(tree, layers=dict(tree["layers"]))
    del bad["layers"]["A_log"]
    with pytest.raises(ValueError, match="A_log"):
        convert.params_from_numpy(CFG, bad, device="cpu")


def _ssd_inputs(seed, S=64, nh=4, hd=8, N=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, nh)))).astype(np.float32)  # softplus
    A = -np.exp(rng.normal(size=(nh,)) * 0.5).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, S, N)).astype(np.float32) for _ in range(2))
    h0 = rng.normal(size=(B, nh, N, hd)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("carry", [False, True])
def test_ssd_chunked_matches_the_reference(chunk, carry):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(chunk)
    h0 = h0 if carry else None
    y, h = mamba2.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), chunk=chunk,
                              h0=None if h0 is None else _t(h0))
    wy, wh = _REF_SSD(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=chunk,
                             h0=None if h0 is None else jnp.asarray(h0))
    assert y.shape == x.shape and h.shape == (B, 4, 16, 8) and h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=CACHE_RTOL, atol=SSD_ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), rtol=CACHE_RTOL, atol=SSD_ATOL)


def test_ssd_chunked_is_invariant_to_the_chunk():
    x, dt, A, Bm, Cm, h0 = map(_t, _ssd_inputs(3))
    outs = [mamba2.ssd_chunked(x, dt, A, Bm, Cm, chunk=c, h0=h0) for c in (8, 16, 32)]
    for y, h in outs[1:]:
        np.testing.assert_allclose(y.numpy(), outs[0][0].numpy(), rtol=CACHE_RTOL,
                                   atol=SSD_ATOL)
        np.testing.assert_allclose(h.numpy(), outs[0][1].numpy(), rtol=CACHE_RTOL,
                                   atol=SSD_ATOL)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        mamba2.ssd_chunked(x, dt, A, Bm, Cm, chunk=24)


def _layer0(params):
    return {n: w[0] for n, w in params["layers"].items() if n != "ln"}


def test_mixer_forward_and_decode_match_the_reference(weights):
    """The mixer over 64 positions, then 6 decode steps from a nonzero
    state and conv ring."""
    jp, p, _ = weights
    rng = np.random.default_rng(7)
    u = rng.normal(size=(B, 64, CFG.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        mamba2.mixer_forward(CFG, _layer0(p), _t(u)).numpy(),
        np.asarray(_REF_MIXER(_layer0(jp), jnp.asarray(u))), rtol=0, atol=ATOL)
    cache = jreg.init_decode_cache(JCFG, B, 0)
    ssm = (rng.normal(size=cache["ssm"].shape[1:]) * 0.3).astype(np.float32)
    conv = rng.normal(size=cache["conv"].shape[1:]).astype(np.float32)
    js, jc, s, c = jnp.asarray(ssm), jnp.asarray(conv), _t(ssm), _t(conv)
    for i in range(6):
        out, s, c = mamba2.mixer_decode(CFG, _layer0(p), s, c, _t(u[:, i:i + 1]))
        jout, js, jc = _REF_MIXER_DECODE(_layer0(jp), js, jc, jnp.asarray(u[:, i:i + 1]))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=CACHE_RTOL, atol=ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=ATOL)


@pytest.mark.parametrize("S", [128, 96])
def test_prefill_matches_the_reference(weights, S):
    """S=128: four chunks of 32; S=96: three."""
    jp, p, _ = weights
    b = make_batch(CFG, B, S, seed=1, device="cpu")
    want, want_aux = _REF_FORWARD(jp, jnp.asarray(b["tokens"].numpy()))
    got = registry.prefill(CFG, p, b)
    assert got.shape == (B, S, CFG.padded_vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert float(mamba2.forward(CFG, p, b["tokens"])[1]) == float(want_aux) == 0.0


def test_decode_matches_the_reference_and_the_prefill(weights):
    """64 steps (two SSD chunks of the prefill) against the reference's
    ``decode_step`` (logits and final caches), the reference's cache after
    48 steps carried across by ``cache_from_numpy`` and continued, and
    every step against the port's own prefill."""
    jp, p, _ = weights
    S, cut = 64, 48
    toks = make_batch(CFG, B, S, seed=3, device="cpu")["tokens"]
    step = jax.jit(functools.partial(jreg.decode_step, JCFG))
    jcache = jreg.init_decode_cache(JCFG, B, S)
    cache = registry.init_decode_cache(CFG, B, S, device="cpu")
    got, want, carried = [], [], None
    for i in range(S):
        if i == cut:
            carried = convert.cache_from_numpy(CFG, jax.tree.map(np.asarray, jcache),
                                               device="cpu")
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, i:i + 1].numpy()), jnp.int32(i))
        lg, cache = registry.decode_step(CFG, p, cache, toks[:, i:i + 1], torch.tensor(i))
        want.append(np.asarray(jl))
        got.append(lg)
    got = torch.stack(got, 1)
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=0, atol=ATOL)
    for name, t in cache.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jcache[name]), rtol=CACHE_RTOL,
                                   atol=ATOL, err_msg=name)
    cont = [registry.decode_step(CFG, p, carried, toks[:, i:i + 1], i)[0] for i in range(cut, S)]
    np.testing.assert_allclose(torch.stack(cont, 1).numpy(), np.stack(want[cut:], 1),
                               rtol=0, atol=ATOL)
    prefill = registry.prefill(CFG, p, {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), prefill.numpy(), rtol=FORWARD_TOL, atol=FORWARD_TOL)
    with pytest.raises(ValueError, match="neither 'k' nor 'ssm'"):
        convert.cache_from_numpy(CFG, {"conv": np.zeros(1)}, device="cpu")
