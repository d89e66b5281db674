"""The port's decoder-only transformer (``repro_torch.models.transformer``:
the dense, MoE and VLM families) against the JAX package's, on the CPU.

The reduced configurations of granite-3-2b (dense GQA), gemma2-27b
(alternating 64-token local and global layers, attention and final
softcaps), grok-1-314b and kimi-k2-1t-a32b (MoE of 4 experts top-2, kimi
with a shared expert) and internvl2-26b (16 stub patch embeddings before
the tokens), float32, run through the reference's ``forward`` and
``decode_step`` under ``jax.jit`` (XLA's backend optimisation level 0)
and through the port's on the same
weights: drawn by the port, ``wq`` and ``wk`` scaled by QK_SCALE = 1/8
(see ``tests/test_torch_jamba.py``), carried across as numpy.  The
prefill takes 128 positions (the VLM's patches included), so the port's
layers without a softcap take the flash routing (the kernel's plain
version here); the reference's scanned windows are traced and never do.
Decode teacher-forces DECODE_S = 72 tokens from zero caches, past
gemma2's local window of 64.  Tolerances, float32: logits, aux losses
and each decode step's logits atol ATOL = 2e-5 (the port's jamba and
whisper parity bound); the final caches to CACHE_RTOL = 1e-5 of their
largest entry (the k projections reach ~25 on these weights).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jcreg
from repro.launch import specs as jspecs
from repro.models import registry as jreg
from repro.models import transformer as jtfm
from repro_torch.configs import registry as creg
from repro_torch.kernels import ops
from repro_torch.launch.specs import make_batch
from repro_torch.models import common as cm
from repro_torch.models import convert, registry, transformer

ATOL = 2e-5
CACHE_RTOL = 1e-5
QK_SCALE = np.float32(1 / 8)
DECODE_S = 72
B = 2
NAMES = ["granite-3-2b", "granite-3-8b", "phi4-mini-3.8b", "gemma2-27b", "grok-1-314b",
         "kimi-k2-1t-a32b", "internvl2-26b"]
REF_COMPILE = {"xla_backend_optimization_level": 0}
PARITY = ["granite-3-2b", "gemma2-27b", "grok-1-314b", "kimi-k2-1t-a32b", "internvl2-26b"]


def _jit(fn):
    """``jax.jit`` at XLA's backend optimisation level 0 (the reference's
    programs here are small and run briefly; their compiles are most of
    this module's time)."""
    return jax.jit(fn, compiler_options=REF_COMPILE)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _weights(name):
    """(port config, reference config, reference params, port params) of
    ``name`` reduced, the same tempered weights."""
    cfg, jcfg = creg.ARCHS[name].reduced(), jcreg.ARCHS[name].reduced()
    p = registry.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    for n in ("wq", "wk"):
        p["layers"][n] = p["layers"][n] * float(QK_SCALE)
    tree = cm.tree_map(lambda t: t.numpy(), p)
    return cfg, jcfg, jax.tree.map(jnp.asarray, tree), convert.params_from_numpy(cfg, tree,
                                                                                 device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_config_layout_and_windows_match_the_reference(name):
    """The configuration (full and reduced), every parameter's name,
    shape and dtype (from the reference's ``init`` traced abstractly),
    the per-layer windows, the cache layout and its logical axes."""
    for c, j in ((creg.ARCHS[name], jcreg.ARCHS[name]),
                 (creg.ARCHS[name].reduced(), jcreg.ARCHS[name].reduced())):
        assert dataclasses.asdict(c) == dataclasses.asdict(j)
        np.testing.assert_array_equal(transformer.layer_windows(c), jtfm.layer_windows(j))
    cfg, jcfg = creg.ARCHS[name].reduced(), jcreg.ARCHS[name].reduced()
    want = jax.eval_shape(lambda: jreg.init(jcfg, jax.random.PRNGKey(0))[0])
    got = registry.init(cfg, torch.Generator().manual_seed(0), device="meta")
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(jax.tree.leaves(got))
    for path, w in flat:
        t = got
        for key in path:
            t = t[key.key]
        assert (tuple(t.shape), str(t.dtype)[6:]) == (w.shape, str(w.dtype)), path
    cache = registry.init_decode_cache(cfg, B, 9, device="meta")
    want = jax.eval_shape(lambda: jreg.init_decode_cache(jcfg, B, 9))
    assert {n: (tuple(t.shape), str(t.dtype)[6:]) for n, t in cache.items()} == \
        {n: (a.shape, str(a.dtype)) for n, a in want.items()}
    for shape in ("", "long_500k"):
        assert registry.cache_axes(cfg, shape) == jreg.cache_axes(jcfg, shape)


def test_full_configs_have_the_published_widths():
    g = creg.get("granite-3-2b")
    assert (g.n_layers, g.d_model, g.n_heads, g.n_kv_heads, g.dh, g.d_ff, g.padded_vocab) == \
        (40, 2048, 32, 8, 64, 8192, 49408)
    specs = transformer.param_specs(g)
    n = sum(int(np.prod(s[0])) for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, tuple) and isinstance(x[0], tuple)))
    # the reference's analytic count leaves out the RMS norms' weights
    assert n == jcreg.ARCHS["granite-3-2b"].param_count() + (2 * g.n_layers + 1) * g.d_model
    assert n == 2_635_237_376
    assert transformer.layer_windows(creg.get("gemma2-27b"))[:4].tolist() == [4096, 0, 4096, 0]


def test_make_batch_has_the_references_patch_embeddings():
    cfg, jcfg = creg.ARCHS["internvl2-26b"].reduced(), jcreg.ARCHS["internvl2-26b"].reduced()
    got, want = make_batch(cfg, B, 40, seed=4, device="cpu"), jspecs.make_batch(jcfg, B, 40, seed=4)
    assert set(got) == {"tokens", "patch_embeds"}
    for n, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[n]))
    assert got["patch_embeds"].shape == (B, 16, cfg.d_model)


def _ref_forward(jcfg, jp, batch):
    fn = _jit(lambda p, t, e: jtfm.forward(jcfg, p, t, prefix_embeds=e))
    logits, aux = fn(jp, jnp.asarray(batch["tokens"].numpy()),
                     None if "patch_embeds" not in batch else
                     jnp.asarray(batch["patch_embeds"].numpy()))
    return np.asarray(logits), float(aux)


@pytest.mark.parametrize("name", PARITY)
def test_prefill_and_decode_match_the_reference(name):
    cfg, jcfg, jp, p = _weights(name)
    batch = make_batch(cfg, B, 128 - cfg.n_patches, seed=2, device="cpu")
    want, want_aux = _ref_forward(jcfg, jp, batch)
    ops.reset_launches()
    got = registry.prefill(cfg, p, batch)
    _, aux = transformer.forward(cfg, p, batch["tokens"], batch.get("patch_embeds"))
    assert got.shape == (B, 128, cfg.padded_vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert float(aux) == pytest.approx(want_aux, abs=ATOL) and (want_aux > 0) == bool(cfg.n_experts)

    tokens = batch["tokens"][:, :DECODE_S]
    step = _jit(lambda p, c, t, pos: jreg.decode_step(jcfg, p, c, t, pos))
    jcache = jreg.init_decode_cache(jcfg, B, DECODE_S)
    cache = registry.init_decode_cache(cfg, B, DECODE_S, device="cpu")
    for i in range(DECODE_S):
        tok = tokens[:, i:i + 1]
        pos = torch.tensor(i) if i % 2 else i  # a 0-d tensor or a Python int
        logits, cache = registry.decode_step(cfg, p, cache, tok, pos)
        jlogits, jcache = step(jp, jcache, jnp.asarray(tok.numpy()), jnp.int32(i))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL,
                                   err_msg=f"position {i}")
    for n in ("k", "v"):
        want = np.asarray(jcache[n])
        np.testing.assert_allclose(cache[n].numpy(), want, rtol=0,
                                   atol=CACHE_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("name,softcap,want", [
    ("granite-3-2b", None, [{}, {}]),
    ("gemma2-27b", None, []),                       # softcapped: the plain path
    ("gemma2-27b", 0.0, [{"window": 64}, {}]),      # local then global
    ("internvl2-26b", None, [{}, {}]),              # 16 patches + 112 tokens
])
def test_flash_routing_by_layer(monkeypatch, name, softcap, want):
    """Each layer meeting the routing's test calls the flash wrapper once
    with its window; a decode step never does."""
    cfg = creg.ARCHS[name].reduced()
    if softcap is not None:
        cfg = dataclasses.replace(cfg, attn_softcap=softcap)
    p = registry.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    calls = []
    real = ops.flash_attention

    def counting(q, k, v, **kw):
        calls.append({n: w for n, w in kw.items() if n != "causal"})
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    registry.prefill(cfg, p, make_batch(cfg, 1, 128 - cfg.n_patches, device="cpu"))
    assert calls == want
    cache = registry.init_decode_cache(cfg, 1, 4, device="cpu")
    registry.decode_step(cfg, p, cache, torch.zeros(1, 1, dtype=torch.int32), 0)
    assert calls == want


def test_decode_runs_against_the_prefill():
    """The port's own decode against its prefill at capacity for every
    token (kimi: MoE with a shared expert), rtol = atol = 5e-3, the
    reference's tolerance for the same check (``tests/test_models.py``)."""
    cfg, _, _, p = _weights("kimi-k2-1t-a32b")
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    tokens = make_batch(cfg, B, 16, seed=6, device="cpu")["tokens"]
    want = registry.prefill(cfg, p, {"tokens": tokens})
    cache = registry.init_decode_cache(cfg, B, 16, device="cpu")
    for i in range(16):
        logits, cache = registry.decode_step(cfg, p, cache, tokens[:, i:i + 1], i)
        np.testing.assert_allclose(logits.numpy(), want[:, i].numpy(), rtol=5e-3, atol=5e-3)
