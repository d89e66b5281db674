"""Whisper's KV-cache decode in the port against its own forward and
against the JAX package's ``decode_step``, on the CPU.

The configuration is the reference's own decode test's
(``tests/test_models.py``: 2 + 2 layers, d_model 64, 4 heads of 16,
vocab 200, 12 audio frames, float32).  Teacher-forcing the tokens
through ``decode_step`` gives the forward's logits at rtol = atol = 5e-3,
the reference's tolerance for the same check.  Against the reference's
``decode_step`` on the same weights and the same converted cache, every
step's logits and the final cache agree to DECODE_ATOL.  The weights are
``tests/test_torch_whisper.py``'s tempered ones (q and k projections
scaled by 1/8): as drawn, the attention scores are so peaked that the
same float32 operations in other orders move the logits by up to 6.0e-5;
tempered, by 7.2e-7 on logits up to 1.8, the self-attention values by
4.8e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import common as jcm
from repro.models import registry as jreg
from repro.models import whisper as jwhisper
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import convert, registry, whisper

F32 = dict(param_dtype="float32", compute_dtype="float32")
SMALL = dict(name="w", family="encdec", n_layers=2, n_encoder_layers=2, d_model=64,
             n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=200,
             encoder_len=12, **F32)
CFG, JCFG = ModelConfig(**SMALL), JModelConfig(**SMALL)
B, S = 2, 16
FORWARD_TOL = 5e-3
DECODE_ATOL = 2e-5
QK_SCALE = np.float32(1 / 8)


@pytest.fixture(scope="module")
def case():
    """(reference params, port params, tokens, audio) on the same numbers."""
    params, _ = jwhisper.init(JCFG, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.array, params)
    for part, names in (("encoder", ("wq", "wk")), ("decoder", ("wq", "wk", "xwq", "xwk"))):
        for n in names:
            tree[part][n] = tree[part][n] * QK_SCALE
    params = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)
    audio = rng.normal(size=(B, CFG.encoder_len, CFG.d_model)).astype(np.float32)
    return params, convert.params_from_numpy(CFG, tree, device="cpu"), toks, audio


def _port_decode(p, toks, audio, device_pos):
    enc = whisper.encode(CFG, p, torch.from_numpy(audio))
    cache = registry.init_decode_cache(CFG, B, S, device="cpu")
    cache["xk"], cache["xv"] = whisper.precompute_cross_kv(CFG, p, enc)
    outs = []
    for i in range(S):
        pos = torch.tensor(i) if device_pos else i
        lg, cache = registry.decode_step(CFG, p, cache, torch.from_numpy(toks[:, i:i + 1]), pos)
        outs.append(lg)
    return torch.stack(outs, 1).numpy(), cache


@pytest.mark.parametrize("device_pos", [False, True])
def test_decode_matches_the_forward(case, device_pos):
    _, p, toks, audio = case
    want, _ = whisper.forward(CFG, p, torch.from_numpy(toks).long(), torch.from_numpy(audio))
    got, cache = _port_decode(p, toks, audio, device_pos)
    assert got.shape == (B, S, CFG.padded_vocab) and got.dtype == np.float32
    np.testing.assert_allclose(got, want.numpy(), rtol=FORWARD_TOL, atol=FORWARD_TOL)
    assert cache["k"].abs().amin(dim=(0, 1, 3, 4)).gt(0).all()  # every row written


def test_decode_step_matches_the_reference(case):
    """Every step's logits and the final cache, the reference's
    ``decode_step`` against the port's from the same converted cache."""
    jp, p, toks, audio = case
    enc = jwhisper.encode(JCFG, jp, jnp.asarray(audio))
    jcache = jreg.init_decode_cache(JCFG, B, S)
    jcache["xk"], jcache["xv"] = jwhisper.precompute_cross_kv(JCFG, jp, enc)
    cache = convert.cache_from_numpy(CFG, jax.tree.map(np.asarray, jcache), device="cpu")
    for i in range(S):
        jlg, jcache = jreg.decode_step(JCFG, jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                                       jnp.int32(i))
        lg, cache = registry.decode_step(CFG, p, cache, torch.from_numpy(toks[:, i:i + 1]),
                                         torch.tensor(i, dtype=torch.int32))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0, atol=DECODE_ATOL)
    for name in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=0, atol=DECODE_ATOL)


def test_cache_layout_and_axes_are_the_reference():
    jcache = jreg.init_decode_cache(JCFG, 3, 7)
    cache = registry.init_decode_cache(CFG, 3, 7, device="cpu")
    assert {n: (tuple(t.shape), t.dtype) for n, t in cache.items()} == {
        n: (a.shape, torch.float32) for n, a in jcache.items()}
    assert not any(t.any() for t in cache.values())
    assert registry.cache_axes(CFG) == jreg.cache_axes(JCFG)
    bf16 = dataclasses.replace(CFG, param_dtype="bfloat16")
    assert registry.init_decode_cache(bf16, 1, 2, device="cpu")["xv"].dtype == torch.bfloat16


def test_cache_from_numpy_refuses_a_wrong_cache():
    tree = jax.tree.map(np.asarray, jreg.init_decode_cache(JCFG, 2, 5))
    del tree["xv"]
    with pytest.raises(ValueError, match="xv"):
        convert.cache_from_numpy(CFG, tree, device="cpu")
    tree = jax.tree.map(np.asarray, jreg.init_decode_cache(JCFG, 2, 5))
    tree["xk"] = tree["xk"][:, :, :-1]
    with pytest.raises(ValueError, match="xk"):
        convert.cache_from_numpy(CFG, tree, device="cpu")


@pytest.mark.parametrize("Sq,Sk,causal,q_offset,kv_len", [
    (1, 10, False, 5, 6),     # a decode step
    (4, 10, True, 3, 7),      # a chunk of queries at an offset
    (3, 8, True, 5, None),    # causal at an offset, every key valid
])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_attention_offsets_match_the_reference(Sq, Sk, causal, q_offset, kv_len, as_tensor):
    rng = np.random.default_rng(Sq * Sk)
    q = rng.normal(size=(2, Sq, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, Sk, 2, 16)).astype(np.float32) for _ in range(2))
    want = jcm.attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                         q_offset=q_offset, kv_len=kv_len)
    off, kl = q_offset, kv_len
    if as_tensor:
        off = torch.tensor(q_offset)
        kl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    got = cm.attention(*map(torch.from_numpy, (q, k, v)), causal=causal, q_offset=off,
                       kv_len=kl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_flash_eligible_refuses_a_kv_length_or_an_offset():
    q = torch.zeros(1, 128, 2, 64)
    assert cm.flash_eligible(q, q, True)
    assert not cm.flash_eligible(q, q, True, kv_len=128)
    assert not cm.flash_eligible(q, q, True, kv_len=torch.tensor(128))
    assert not cm.flash_eligible(q, q, True, q_offset=torch.tensor(0))
    assert not cm.flash_eligible(q, q, True, q_offset=1)


def test_decode_entry_points_check_devices(case, monkeypatch):
    _, p, toks, _ = case
    cache = registry.init_decode_cache(CFG, B, S, device="cpu")
    tok = torch.from_numpy(toks[:, :1])
    for bad in ("token", "cache", "pos"):
        args = dict(cache=dict(cache), token=tok, pos=torch.tensor(0))
        if bad == "cache":
            args["cache"]["xk"] = args["cache"]["xk"].to("meta")
        else:
            args[bad] = args[bad].to("meta")
        with pytest.raises(ValueError, match=bad):
            registry.decode_step(CFG, p, args["cache"], args["token"], args["pos"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.init_decode_cache(CFG, B, S)
