"""The port's Jamba hybrid and sort-based MoE FFN against the JAX
package's, on the CPU.

The reduced jamba-v0.1-52b configuration (one block of 8 sublayers:
attention, 7 Mamba2 mixers, 4 dense SwiGLU and 4 MoE FFNs of 4 experts
top-2; d_model 256, 4 heads of 64 over 2 kv heads, SSM state 16, heads of
32, chunk 32, vocab 512, float32) runs through the reference's
``forward`` with ``ATTN_IMPL = "pallas"`` (the flash kernel in interpret
mode) and through the port's on the same weights, carried across by
``params_from_numpy``, and the same tokens from ``make_batch``'s numpy
seed.

Conditioning.  As in ``tests/test_torch_whisper.py``, the reference's
fan-in rule takes H (4) and Hkv (2) as the fan-in of ``wq`` and ``wk``, so
q and k entries have standard deviations near 8 and 11 and the scores
near 90: near-ties of so peaked a softmax turn float32 roundings into
large logit differences between any two implementations.  The parity
tests scale ``wq`` and ``wk`` by QK_SCALE = 1/8 before both packages get
them.  Tolerances (float32 throughout):

- prefill logits and the MoE sublayers' summed aux loss, atol ATOL = 2e-5
  (measured 4.3e-6 on logits up to 3.3);
- MoE routing: ``eidx`` and ``keep`` equal exactly, outputs atol 1e-5;
- each decode step's logits and the final caches against the reference's
  ``decode_step``, atol ATOL (measured 2.6e-6 on logits, 1.4e-5 on the
  float32 SSM state);
- decode against the port's own prefill, rtol = atol = 5e-3, the
  reference's tolerance for the same check (``tests/test_models.py``),
  at ``capacity_factor = n_experts / top_k``, where the prefill drops no
  token (a decode step never does);
- the weights as drawn, atol AS_DRAWN_ATOL = 0.5 (the conditioning
  above), which catches only gross faults.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import jamba_v01_52b as jconfig
from repro.launch import specs as jspecs
from repro.models import common as jcm
from repro.models import jamba as jjamba
from repro.models import registry as jreg
from repro_torch.configs import registry as creg
from repro_torch.configs.jamba_v01_52b import CONFIG
from repro_torch.kernels import ops
from repro_torch.launch.specs import make_batch
from repro_torch.models import common as cm
from repro_torch.models import convert, jamba, registry

ATOL = 2e-5
CACHE_RTOL = 1e-5
FORWARD_TOL = 5e-3
AS_DRAWN_ATOL = 0.5
QK_SCALE = np.float32(1 / 8)
CFG = CONFIG.reduced()
JCFG = jconfig.CONFIG.reduced()
NODROP = dict(capacity_factor=CFG.n_experts / CFG.top_k)
B = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the reduced model's operations are tiny, and
    with every core busy (parallel test workers) a pool of a thread a
    core spends most of each one waiting at its barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tempered(tree):
    tree = jax.tree.map(np.array, tree)
    for n in ("wq", "wk"):
        tree["blocks"][n] = tree["blocks"][n] * QK_SCALE
    return tree


@pytest.fixture(scope="module")
def drawn():
    """The reference's parameters as drawn, as numpy."""
    init = jax.jit(lambda key: jreg.init(JCFG, key)[0])
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def weights(drawn):
    """(reference params, port params), the same tempered weights."""
    tree = _tempered(drawn)
    return jax.tree.map(jnp.asarray, tree), convert.params_from_numpy(CFG, tree, device="cpu")


_REF_FORWARD = jax.jit(functools.partial(jjamba.forward, JCFG))


def _ref_forward(params, tokens):
    """The reference's forward, traced (once a shape) under ATTN_IMPL =
    "pallas"."""
    try:
        jcm.ATTN_IMPL = "pallas"
        logits, aux = _REF_FORWARD(params, tokens)
    finally:
        jcm.ATTN_IMPL = "xla"
    return np.asarray(logits), float(aux)


# ---------------------------------------------------------------------------
# configuration, inputs, parameters
# ---------------------------------------------------------------------------

def test_config_matches_the_reference():
    for c, j in ((CONFIG, jconfig.CONFIG), (CFG, JCFG)):
        assert dataclasses.asdict(c) == dataclasses.asdict(j)
        assert (c.dh, c.padded_vocab, c.d_inner, c.n_ssm_heads, c.expert_d_ff) == \
            (j.dh, j.padded_vocab, j.d_inner, j.n_ssm_heads, j.expert_d_ff)
    assert creg.get("jamba-v0.1-52b") is CONFIG
    assert (CONFIG.dh, CONFIG.n_ssm_heads, CONFIG.d_inner) == (128, 128, 8192)


def test_make_batch_matches_the_reference():
    b = make_batch(CFG, B, 40, seed=5, device="cpu")
    assert set(b) == {"tokens"} and b["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(b["tokens"].numpy(),
                                  np.asarray(jspecs.make_batch(JCFG, B, 40, seed=5)["tokens"]))


def test_param_shapes_and_scales_match_the_reference(drawn):
    """Every leaf's shape; norms zero, ``D_skip`` one; each normal leaf of
    more than 4096 values drawn at the reference's spread (within 5 %),
    the mixers' at the fan-in of the reference's flat stacked shape."""
    p = registry.init(CFG, torch.Generator().manual_seed(0), device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(drawn)[0]
    assert len(flat) == len(jax.tree.leaves(p))
    for path, ref in flat:
        t = p
        for key in path:
            t = t[key.key]
        ref = np.asarray(ref)
        name = "/".join(k.key for k in path)
        assert tuple(t.shape) == ref.shape and t.dtype == torch.float32, name
        if not ref.std():
            np.testing.assert_array_equal(t.numpy(), ref, err_msg=name)
        elif ref.size > 4096:
            assert t.std().item() == pytest.approx(ref.std(), rel=0.05), name
    assert not p["blocks"]["mamba"]["ln"].any()
    assert bool((p["blocks"]["mamba"]["D_skip"] == 1).all())
    specs = jamba.param_specs(CFG)["blocks"]["mamba"]
    assert specs["A_log"][1] == 0.5 and specs["in_x"][1] == pytest.approx(1 / 16)


def test_ones_init():
    p = cm.init_params({"a": cm.spec((3, 4), init="ones"), "b": cm.spec((2,), init="zeros")},
                       torch.Generator().manual_seed(0), torch.bfloat16, torch.device("cpu"))
    assert p["a"].dtype == torch.bfloat16 and bool((p["a"] == 1).all()) and not p["b"].any()


def test_params_from_numpy_refuses_a_wrong_tree(drawn):
    tree = jax.tree.map(np.asarray, drawn)
    del tree["blocks"]["mamba"]["ln"]
    with pytest.raises(ValueError, match="blocks.mamba."):
        convert.params_from_numpy(CFG, tree, device="cpu")
    tree = jax.tree.map(np.asarray, drawn)
    tree["blocks"]["mw1"] = tree["blocks"]["mw1"][:, :, :-1]
    with pytest.raises(ValueError, match="mw1"):
        convert.params_from_numpy(CFG, tree, device="cpu")


def test_cache_layout_matches_the_reference():
    want = jreg.init_decode_cache(JCFG, B, 24)
    got = registry.init_decode_cache(CFG, B, 24, device="cpu")
    assert {n: (tuple(t.shape), str(t.dtype)[6:]) for n, t in got.items()} == \
        {n: (a.shape, str(a.dtype)) for n, a in want.items()}
    for shape in ("", "long_500k"):
        assert registry.cache_axes(CFG, shape) == jreg.cache_axes(JCFG, shape)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_rope_and_swiglu_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 4, 64)).astype(np.float32)
    for pos in (np.arange(7), np.arange(14).reshape(2, 7) * 3 + 5):
        np.testing.assert_allclose(
            cm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy(),
            np.asarray(jax.jit(jcm.apply_rope, static_argnums=2)(jnp.asarray(x),
                                                                jnp.asarray(pos), 1e4)),
            rtol=0, atol=2e-5)
    h = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w1, w3 = ((rng.normal(size=(64, 96)) / 8).astype(np.float32) for _ in range(2))
    w2 = (rng.normal(size=(96, 64)) / 10).astype(np.float32)
    np.testing.assert_allclose(
        cm.swiglu(*map(torch.from_numpy, (h, w1, w3, w2))).numpy(),
        np.asarray(jax.jit(jcm.swiglu)(*map(jnp.asarray, (h, w1, w3, w2)))), rtol=0, atol=1e-5)


@functools.partial(jax.jit, static_argnames=("top_k", "C"))
def _ref_route(x, router, top_k, C):
    T, E = x.shape[0] * x.shape[1], router.shape[1]
    probs = jax.nn.softmax(jnp.einsum("td,de->te", x.reshape(T, -1), router), axis=-1)
    _, eidx = jax.lax.top_k(probs, top_k)
    flat_e = eidx.reshape(-1)
    sort_idx = jnp.argsort(flat_e)
    counts = jnp.bincount(flat_e, length=E)
    pos_in_e = jnp.arange(T * top_k) - (jnp.cumsum(counts) - counts)[flat_e[sort_idx]]
    return eidx, pos_in_e < C


def _ref_routing(x, router, top_k, capacity_factor):
    """The reference's routing (``repro/models/common.py`` moe_ffn, the
    lines from the router's softmax to ``keep``), which it does not
    return: (eidx, keep, C)."""
    T, E = x.shape[0] * x.shape[1], router.shape[1]
    C = max(int(math.ceil(T * top_k / E * capacity_factor)), top_k)
    C = (C + 7) // 8 * 8
    eidx, keep = _ref_route(jnp.asarray(x), jnp.asarray(router), top_k, C)
    return np.asarray(eidx), np.asarray(keep), C


@pytest.mark.parametrize("router_scale,capacity_factor,drops", [
    (1.0, 1.25, False),   # balanced, the published factor
    (5.0, 0.5, True),     # skewed and tight: entries dropped
    (0.0, 1.25, True),    # every probability tied: experts 0 and 1 for all
])
def test_moe_ffn_matches_the_reference(router_scale, capacity_factor, drops):
    rng = np.random.default_rng(2)
    D, Fe, E = 32, 48, 4
    x = rng.normal(size=(2, 40, D)).astype(np.float32)
    router = (rng.normal(size=(D, E)) * router_scale).astype(np.float32)
    w1, w3 = ((rng.normal(size=(E, D, Fe)) * 0.1).astype(np.float32) for _ in range(2))
    w2 = (rng.normal(size=(E, Fe, D)) * 0.1).astype(np.float32)
    routing = []
    out, aux = cm.moe_ffn(*map(torch.from_numpy, (x, router, w1, w3, w2)), top_k=2,
                          capacity_factor=capacity_factor, routing=routing)
    want, want_aux = jax.jit(jcm.moe_ffn, static_argnames=("top_k", "capacity_factor"))(
        *map(jnp.asarray, (x, router, w1, w3, w2)), top_k=2, capacity_factor=capacity_factor)
    eidx, keep, C = _ref_routing(x, router, 2, capacity_factor)
    (r,) = routing
    np.testing.assert_array_equal(r["eidx"].numpy(), eidx)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    assert r["capacity"] == C and int(r["dropped"]) == int((~keep).sum())
    assert (int(r["dropped"]) > 0) == drops
    if router_scale == 0.0:
        assert (eidx == [0, 1]).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert float(aux) == pytest.approx(float(want_aux), abs=1e-6)


# ---------------------------------------------------------------------------
# the prefill
# ---------------------------------------------------------------------------

def test_prefill_matches_the_reference(weights):
    """S=128: the reference's attention through the Pallas kernel, the
    port's through the kernel's plain version; logits and the summed aux
    loss."""
    b = make_batch(CFG, B, 128, seed=1, device="cpu")
    want, want_aux = _ref_forward(weights[0], jnp.asarray(b["tokens"].numpy()))
    got, aux = jamba.forward(CFG, weights[1], b["tokens"])
    assert got.shape == (B, 128, CFG.padded_vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert float(aux) == pytest.approx(want_aux, abs=ATOL)
    np.testing.assert_array_equal(registry.prefill(CFG, weights[1], b).numpy(), got.numpy())


def test_prefill_with_the_weights_as_drawn(drawn):
    p = convert.params_from_numpy(CFG, drawn, device="cpu")
    b = make_batch(CFG, B, 128, seed=1, device="cpu")
    got = registry.prefill(CFG, p, b).numpy()
    assert np.isfinite(got).all()
    want = _ref_forward(jax.tree.map(jnp.asarray, drawn), jnp.asarray(b["tokens"].numpy()))[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=AS_DRAWN_ATOL)


@pytest.mark.parametrize("S,want", [(128, 1), (96, 0)])
def test_eligible_attention_runs_once_per_block(weights, monkeypatch, S, want):
    """The flash kernel's wrapper is reached once a block (its attention
    sublayer) at S=128, never at S=96, and never by a decode step."""
    calls = []
    real = ops.flash_attention

    def counting(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    registry.prefill(CFG, weights[1], make_batch(CFG, B, S, device="cpu"))
    assert calls == [((B, S, 4, 64), (B, S, 2, 64), {"causal": True})] * want
    cache = registry.init_decode_cache(CFG, B, 4, device="cpu")
    registry.decode_step(CFG, weights[1], cache, torch.zeros(B, 1, dtype=torch.int32), 0)
    assert len(calls) == want


def test_prefill_refuses_a_batch_on_another_device():
    b = make_batch(CFG, B, 32, device="cpu")
    b["tokens"] = b["tokens"].to("meta")
    with pytest.raises(ValueError, match="tokens"):
        registry.prefill(CFG, {"embed": torch.zeros(1)}, b)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

_REF_STEP = jax.jit(functools.partial(jreg.decode_step, JCFG))


def _ref_decode(params, cache, toks, start=0):
    step = _REF_STEP
    outs = []
    for i in range(toks.shape[1]):
        lg, cache = step(params, cache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(start + i))
        outs.append(np.asarray(lg))
    return np.stack(outs, 1), cache


def _port_decode(cfg, p, cache, toks, start=0, device_pos=True):
    outs = []
    for i in range(toks.shape[1]):
        pos = torch.tensor(start + i) if device_pos else start + i
        lg, cache = registry.decode_step(cfg, p, cache, torch.from_numpy(toks[:, i:i + 1]), pos)
        outs.append(lg)
    return torch.stack(outs, 1).numpy(), cache


def test_decode_matches_the_reference_step_by_step(weights):
    """12 steps from zero caches: every step's logits and the final k, v,
    ssm and conv caches; then the reference's cache after 12 steps,
    carried across by ``cache_from_numpy``, continued 4 steps on each
    side."""
    toks = make_batch(CFG, B, 16, seed=3, device="cpu")["tokens"].numpy()
    jcache = jreg.init_decode_cache(JCFG, B, 16)
    want, jcache = _ref_decode(weights[0], jcache, toks[:, :12])
    cache = registry.init_decode_cache(CFG, B, 16, device="cpu")
    got, cache = _port_decode(CFG, weights[1], cache, toks[:, :12])
    assert got.shape == (B, 12, CFG.padded_vocab) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    for name, t in cache.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jcache[name]), rtol=CACHE_RTOL, atol=ATOL,
                                   err_msg=name)
    carried = convert.cache_from_numpy(CFG, jax.tree.map(np.asarray, jcache), device="cpu")
    want, _ = _ref_decode(weights[0], jcache, toks[:, 12:], start=12)
    got, _ = _port_decode(CFG, weights[1], carried, toks[:, 12:], start=12, device_pos=False)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_decode_matches_the_prefill(weights):
    """Teacher-forcing 64 tokens (two SSD chunks of the prefill)
    through ``decode_step`` gives the prefill's logits where the prefill
    drops no token."""
    cfg = dataclasses.replace(CFG, **NODROP)
    toks = make_batch(cfg, B, 64, seed=4, device="cpu")["tokens"]
    routing = []
    want, _ = jamba.forward(cfg, weights[1], toks, routing=routing)
    assert [int(r["dropped"]) for r in routing] == [0] * 4
    cache = registry.init_decode_cache(cfg, B, 64, device="cpu")
    got, cache = _port_decode(cfg, weights[1], cache, toks.numpy())
    np.testing.assert_allclose(got, want.numpy(), rtol=FORWARD_TOL, atol=FORWARD_TOL)
    assert cache["k"].abs().amin(dim=(0, 1, 3, 4)).gt(0).all()  # every row written


def test_cache_from_numpy_refuses_a_wrong_cache():
    cache = jax.tree.map(np.asarray, jreg.init_decode_cache(JCFG, B, 8))
    del cache["conv"]
    with pytest.raises(ValueError, match="conv"):
        convert.cache_from_numpy(CFG, cache, device="cpu")
    cache = jax.tree.map(np.asarray, jreg.init_decode_cache(JCFG, B, 8))
    cache["ssm"] = cache["ssm"][..., :-1]
    with pytest.raises(ValueError, match="ssm"):
        convert.cache_from_numpy(CFG, cache, device="cpu")
