"""The port's whisper prefill against the JAX package's, on the CPU.

The reduced whisper-large-v3 configuration (2 + 2 layers, d_model 256,
4 heads of 64, vocab 512, float32) runs through
``repro.models.registry.prefill`` with ``ATTN_IMPL = "pallas"`` (the
flash kernel in interpret mode, as ``tests/test_kernels.py`` sets it)
and through ``repro_torch.models.registry.prefill`` on the same weights,
carried across by ``params_from_numpy``, and the same batch from
``make_batch``'s numpy seed.

Conditioning.  The reference's initialiser takes the fan-in of a
``(L, D, H, dh)`` projection as H, not D, so q and k entries have a
standard deviation near 8 and the attention scores near 64: a softmax so
peaked that near-ties turn float32 rounding (1e-7) into logits
differences of up to 0.09 between any two float32 implementations; each
of the reference's float32 paths is 0.04 off a float64 evaluation at
S=128.  The parity tests therefore scale the q and k projections of the
shared weights by 1/8 (scores of standard deviation near 1) before both
packages get them.  There the port agrees with the reference to 2.3e-6
on logits of magnitude up to 2.8; the tolerance is atol 2e-5.  The
weights as drawn are held at atol 0.2 (the conditioning above), which
catches only gross faults.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jarchs
from repro.configs import whisper_large_v3 as jconfig
from repro.launch import specs as jspecs
from repro.models import common as jcm
from repro.models import registry as jreg
from repro.models import whisper as jwhisper
from repro_torch.configs import registry as creg
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.whisper_large_v3 import CONFIG
from repro_torch.kernels import ops, runtime
from repro_torch.launch.specs import make_batch
from repro_torch.models import common as cm
from repro_torch.models import convert, registry, whisper

ATOL = 2e-5
AS_DRAWN_ATOL = 0.2
QK_SCALE = np.float32(1 / 8)
CFG = CONFIG.reduced()
JCFG = jconfig.CONFIG.reduced()


def _tempered(tree):
    """The numpy tree with the q and k projections scaled by 1/8."""
    tree = jax.tree.map(np.array, tree)
    for part, names in (("encoder", ("wq", "wk")),
                        ("decoder", ("wq", "wk", "xwq", "xwk"))):
        for n in names:
            tree[part][n] = tree[part][n] * QK_SCALE
    return tree


@pytest.fixture(scope="module")
def weights():
    """(reference params, port params), the same tempered weights."""
    params, _ = jreg.init(JCFG, jax.random.PRNGKey(0))
    tree = _tempered(params)
    return jax.tree.map(jnp.asarray, tree), convert.params_from_numpy(CFG, tree, device="cpu")


def _ref_prefill(params, batch, impl):
    try:
        jcm.ATTN_IMPL = impl
        return np.asarray(jreg.prefill(JCFG, params, batch))
    finally:
        jcm.ATTN_IMPL = "xla"


def _batches(S, seed=1):
    return (jspecs.make_batch(JCFG, 2, S, seed=seed),
            make_batch(CFG, 2, S, seed=seed, device="cpu"))


# ---------------------------------------------------------------------------
# configuration, inputs, parameters
# ---------------------------------------------------------------------------

def test_configs_match_the_reference():
    for c, j in ((CONFIG, jconfig.CONFIG), (CFG, JCFG)):
        assert dataclasses.asdict(c) == dataclasses.asdict(j)
        assert (c.dh, c.padded_vocab) == (j.dh, j.padded_vocab)
    assert CONFIG.padded_vocab == 51968
    assert creg.get("whisper-large-v3") is CONFIG


@pytest.mark.parametrize("name", sorted(jarchs.ARCHS))
def test_reduced_matches_the_reference_for_every_arch(name):
    """``ModelConfig`` is a copy: every reference configuration, and its
    reduced variant, has the same fields in the port."""
    j = jarchs.ARCHS[name]
    c = ModelConfig(**dataclasses.asdict(j))
    assert dataclasses.asdict(c.reduced()) == dataclasses.asdict(j.reduced())
    assert (c.reduced().dh, c.reduced().padded_vocab) == (j.reduced().dh,
                                                           j.reduced().padded_vocab)


def test_make_batch_matches_the_reference():
    jb, b = _batches(100, seed=5)
    assert set(b) == {"tokens", "audio_embeds"}
    for name in ("tokens", "audio_embeds"):
        np.testing.assert_array_equal(b[name].numpy(), np.asarray(jb[name]))


def test_param_shapes_match_the_reference():
    jshapes = jax.eval_shape(lambda: jwhisper.init(JCFG, jax.random.PRNGKey(0))[0])
    p = registry.init(CFG, torch.Generator().manual_seed(0), device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    assert len(flat) == len(jax.tree.leaves(p))
    for path, sd in flat:
        t = p
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == sd.shape and t.dtype == torch.float32, path


def test_init_keeps_the_reference_scales():
    """Norms start at zero; each normal parameter's spread is the
    reference's (fan-in = shape[-2], so H for a stacked projection),
    within 5 % sampling error."""
    params, _ = jreg.init(JCFG, jax.random.PRNGKey(0))
    p = registry.init(CFG, torch.Generator().manual_seed(0), device="cpu")
    for part in ("encoder", "decoder"):
        for name, w in p[part].items():
            ref = np.asarray(params[part][name])
            if name.startswith("ln"):
                assert not w.any() and not ref.any()
            else:
                assert w.std().item() == pytest.approx(ref.std(), rel=0.05), name
    assert p["decoder"]["wq"].std().item() == pytest.approx(1 / np.sqrt(CFG.n_heads), rel=0.05)
    assert not p["final_norm"].any()


def test_params_from_numpy_refuses_a_wrong_tree():
    params, _ = jreg.init(JCFG, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    del tree["decoder"]["xwq"]
    with pytest.raises(ValueError, match="xwq"):
        convert.params_from_numpy(CFG, tree, device="cpu")
    tree = jax.tree.map(np.asarray, params)
    tree["lm_head"] = tree["lm_head"][:-1]
    with pytest.raises(ValueError, match="lm_head"):
        convert.params_from_numpy(CFG, tree, device="cpu")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_rms_norm_and_mlp_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 256)).astype(np.float32)
    w = (rng.normal(size=(256,)) * 0.1).astype(np.float32)
    w_in = (rng.normal(size=(256, 512)) / 16).astype(np.float32)
    w_out = (rng.normal(size=(512, 256)) / 22).astype(np.float32)
    np.testing.assert_allclose(
        cm.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jcm.rms_norm(jnp.asarray(x), jnp.asarray(w))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        whisper._mlp(*map(torch.from_numpy, (x, w_in, w_out))).numpy(),
        np.asarray(jwhisper._mlp(*map(jnp.asarray, (x, w_in, w_out)))), rtol=0, atol=1e-5)


@pytest.mark.parametrize("Sq,Sk,causal,chunk_q", [
    (100, 64, False, 0),    # cross-attention shape
    (64, 64, False, 0),     # encoder self-attention
    (100, 100, True, 0),    # causal, not a multiple of 128: plain path
    (96, 96, True, 32),     # causal, in query chunks
])
def test_plain_attention_matches_the_reference(Sq, Sk, causal, chunk_q):
    rng = np.random.default_rng(Sq + Sk)
    q = rng.normal(size=(2, Sq, 4, 64)).astype(np.float32)
    k, v = (rng.normal(size=(2, Sk, 2, 64)).astype(np.float32) for _ in range(2))
    got = cm.attention(*map(torch.from_numpy, (q, k, v)), causal=causal, chunk_q=chunk_q)
    want = jcm.attention(*map(jnp.asarray, (q, k, v)), causal=causal, chunk_q=chunk_q)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the prefill
# ---------------------------------------------------------------------------

def test_reference_prefill_takes_the_pallas_kernel(weights):
    """The premise of the slice: at S=128 the reference's prefill under
    ATTN_IMPL="pallas" holds a pallas_call (the decoder's self-attention,
    inside the layer scan)."""
    jb, _ = _batches(128)
    try:
        jcm.ATTN_IMPL = "pallas"
        jaxpr = jax.make_jaxpr(lambda p, b: jreg.prefill(JCFG, p, b))(weights[0], jb)
    finally:
        jcm.ATTN_IMPL = "xla"
    assert str(jaxpr).count("pallas_call") >= 1


@pytest.mark.parametrize("S", [128, 100])
def test_prefill_matches_the_reference(weights, S):
    """S=128: the reference through the Pallas kernel, the port through
    the kernel's plain version.  S=100: no attention is eligible on
    either side."""
    jb, b = _batches(S)
    want = _ref_prefill(weights[0], jb, "pallas")
    got = registry.prefill(CFG, weights[1], b)
    assert got.shape == (2, S, CFG.padded_vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_prefill_with_the_weights_as_drawn():
    params, _ = jreg.init(JCFG, jax.random.PRNGKey(0))
    p = convert.params_from_numpy(CFG, jax.tree.map(np.asarray, params), device="cpu")
    jb, b = _batches(128)
    got = registry.prefill(CFG, p, b).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _ref_prefill(params, jb, "pallas"),
                               rtol=0, atol=AS_DRAWN_ATOL)


@pytest.mark.parametrize("S,want", [(128, CFG.n_layers), (100, 0)])
def test_eligible_attention_runs_once_per_decoder_layer(weights, monkeypatch, S, want):
    """The flash kernel's wrapper is reached once per decoder layer (the
    causal self-attention) at S=128, never from the encoder or the
    cross-attention, and not at all at S=100."""
    calls = []
    real = ops.flash_attention

    def counting(q, k, v, **kw):
        calls.append((tuple(q.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    registry.prefill(CFG, weights[1], _batches(S)[1])
    assert len(calls) == want
    assert all(kw == {"causal": True} for _, kw in calls)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.init(CFG, g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(CFG, 1, 128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy(CFG, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.resolve_device("cuda")


def test_unported_families_raise_naming_the_family():
    """The CNN's configuration is in the port's registry, as in the
    reference's; the model registry has no entry for its family and
    raises the reference's ValueError (``repro/models/registry.py``)."""
    cnn = creg.get("resnet20-cifar")
    assert (cnn.name, cnn.family) == ("resnet20-cifar", "resnet")
    with pytest.raises(ValueError, match="unknown family 'resnet' for resnet20-cifar"):
        registry.init(cnn, torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="unknown family 'resnet' for resnet-like"):
        registry.prefill(ModelConfig(name="resnet-like", family="resnet"), {}, {})


def test_prefill_refuses_a_batch_on_another_device(weights):
    b = _batches(100)[1]
    b["audio_embeds"] = b["audio_embeds"].to("meta")
    with pytest.raises(ValueError, match="audio_embeds"):
        registry.prefill(CFG, weights[1], b)


def test_params_from_numpy_carries_bf16_bits():
    jcfg = dataclasses.replace(JCFG, param_dtype="bfloat16")
    params, _ = jreg.init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    p = convert.params_from_numpy(dataclasses.replace(CFG, param_dtype="bfloat16"), tree,
                                  device="cpu")
    assert p["decoder"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["decoder"]["wq"].float().numpy(),
                                  tree["decoder"]["wq"].astype(np.float32))
