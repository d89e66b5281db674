"""The fused round kernel module (``repro_torch.kernels.round_kernel``)
against the JAX package's, on the CPU.

The Pallas kernel runs in interpret mode, as ``tests/test_round_kernel.py``
runs it; the port's wrapper takes its plain PyTorch version for CPU
tensors.  Inputs are made with numpy from fixed seeds and handed to both;
weights hold zero-weight clients and the ``K / n_part`` rescale the
SCARLET strategy applies.

Tolerances:

- probabilities (``sharpen=True``) at beta >= 1: atol 1e-6.  The two
  sides run the same float32 products, quotients, logs and exps but sum
  in other orders (the Pallas kernel in float32 over 128 padded lanes,
  the port in float64 rounded once), float32 rounding only;
- the linear moment (``sharpen=False``), a weighted sum of K values in
  [0, 1]: atol 2e-6 * sum|w|, since the rounding of a sum grows with its
  magnitude (each side within about log2(K) * 2^-24 of the exact sum);
- beta = 0.5: the Pallas kernel sharpens N padded to 128 lanes and leaks
  mass into the pad (ROADMAP Queue C); the port sharpens the N real
  classes, so it is held to the Pallas output renormalized over the real
  lanes, and the leak itself is pinned.  That comparison takes atol 1e-5
  (as the ERA kernel's padded comparison in ``test_torch_kernels.py``):
  below beta = 1 the sharpening lifts small classes, and a class that the
  delta codec's cancellation ``b + r`` leaves near 1e-5 carries float32
  rounding differences of order 1e-8, a relative error near 1e-3 that
  beta = 0.5 turns into about 1e-6 of the output.  At beta >= 1 small
  classes are damped instead, and atol 1e-6 holds.

Pallas compiles once per shape and static option (about 0.4 s here), so
the Pallas comparison covers every mode x bits x sharpen on nine shapes
that form an orthogonal array over K in {1, 3, 8}, m in {1, 5, 24} and
N in {2, 5, 10} (every pair of values of two of the three appears once);
``test_torch_round_kernel_oracle.py`` holds the full product of the three
to the package's jnp oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress.codecs import QuantCodec as JQuantCodec
from repro.compress.codecs import get_codec as jget_codec
from repro.fl.strategies.scarlet import EnhancedERAStrategy as JScarlet
from repro.kernels import round_kernel as jround
from repro_torch.compress import get_codec
from repro_torch.compress.codecs import QuantCodec
from repro_torch.fl.strategies import EnhancedERAStrategy
from repro_torch.kernels import ops, round_kernel

ATOL = 1e-6
LINEAR_RTOL = 2e-6
PADDED_ATOL = 1e-5

MODES = [("identity", None), ("quant", 1), ("quant", 4), ("quant", 8),
         ("delta", None), ("delta", 1), ("delta", 4), ("delta", 8)]
KS, MS, NS = (1, 3, 8), (1, 5, 24), (2, 5, 10)
# orthogonal array: row (i, j) takes K[i], m[j], N[(i + j) % 3]
SHAPES = [(KS[i], MS[j], NS[(i + j) % 3]) for i in range(3) for j in range(3)]
BETAS = (1.0, 1.5, 4.0)


def _probs(rng, shape):
    z = rng.dirichlet(np.ones(shape[-1]), size=int(np.prod(shape[:-1])))
    return z.astype(np.float32).reshape(shape)


def _inputs(seed, K, m, N, mode):
    """Soft-labels, participant weights ``part * K / n_part`` (about 40 %
    zero, at least one participant) and, in delta mode, a base."""
    rng = np.random.default_rng(seed)
    z = _probs(rng, (K, m, N))
    part = (rng.random(K) < 0.6).astype(np.float32)
    part[-1] = 1.0
    w = (part * np.float32(K / part.sum())).astype(np.float32)
    base = _probs(rng, (m, N)) if mode == "delta" else None
    return z, w, base


def _port(z, w, beta, base, **kw):
    t = None if base is None else torch.from_numpy(base)
    return round_kernel.fused_round(torch.from_numpy(z), torch.from_numpy(w), beta,
                                    t, **kw).numpy()


def _pallas(z, w, beta, base, **kw):
    b = None if base is None else jnp.asarray(base)
    return np.asarray(jround.fused_round(jnp.asarray(z), jnp.asarray(w), beta, b,
                                         interpret=True, **kw))


def _linear_atol(w):
    return LINEAR_RTOL * float(np.abs(w).sum())


# ---------------------------------------------------------------------------
# The plain version against the Pallas kernel and the jnp oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,m,N", SHAPES)
@pytest.mark.parametrize("sharpen", [True, False])
@pytest.mark.parametrize("mode,bits", MODES)
def test_fused_round_plain_matches_pallas(mode, bits, sharpen, K, m, N):
    z, w, base = _inputs(K * 100 + m * 10 + N, K, m, N, mode)
    kw = dict(mode=mode, bits=bits, sharpen=sharpen)
    if not sharpen:
        np.testing.assert_allclose(_port(z, w, None, base, **kw),
                                   _pallas(z, w, None, base, **kw),
                                   rtol=0, atol=_linear_atol(w))
        return
    for beta in BETAS:
        np.testing.assert_allclose(_port(z, w, beta, base, **kw),
                                   _pallas(z, w, beta, base, **kw),
                                   rtol=0, atol=ATOL)
    # beta < 1: the Pallas kernel's pad lanes keep mass; the port is Eq. 4
    # over the real classes, i.e. the Pallas output renormalized
    got = _port(z, w, 0.5, base, **kw)
    pallas = _pallas(z, w, 0.5, base, **kw)
    leak = 1.0 - pallas.sum(-1)
    assert (leak > 1e-6).all(), leak
    np.testing.assert_allclose(got, pallas / pallas.sum(-1, keepdims=True),
                               rtol=0, atol=PADDED_ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=ATOL)


def test_pallas_pad_lanes_take_mass_at_n1_and_on_zero_rows():
    """Pins the reference fault the port does not copy.  At N=1 Eq. 4 is
    exactly 1, but at beta=0.5 the 127 zero pad lanes keep
    127 * exp(0.5 * ln 1e-12) of the mass.  And a row whose weighted sum is
    0 everywhere (every weight 0) ties the real lanes with the pad lanes,
    so the Pallas kernel spreads it over 128 lanes (1/128 each, at any
    beta) where the port gives the uniform 1/N; the SCARLET strategy's
    outage guard replaces both with 1/N."""
    z = np.ones((2, 3, 1), np.float32)
    w = np.ones(2, np.float32)
    pallas = _pallas(z, w, 0.5, None, mode="identity")
    leak = 127 * np.exp(0.5 * np.log(1e-12))
    np.testing.assert_allclose(pallas, 1.0 / (1.0 + leak), rtol=1e-5)
    np.testing.assert_array_equal(_port(z, w, 0.5, None, mode="identity"), 1.0)

    z, _, base = _inputs(3, 4, 6, 10, "delta")
    w0 = np.zeros(4, np.float32)
    for beta in (0.5, 1.5):
        np.testing.assert_allclose(_pallas(z, w0, beta, base, mode="delta", bits=8),
                                   1.0 / 128, rtol=1e-6)
        np.testing.assert_allclose(_port(z, w0, beta, base, mode="delta", bits=8),
                                   0.1, rtol=1e-6)
    part = torch.zeros(4)
    for strat in (EnhancedERAStrategy(beta=1.5), JScarlet(beta=1.5)):
        if isinstance(strat, JScarlet):
            out = np.asarray(strat.aggregate_masked_fused(
                jnp.asarray(z), jnp.zeros(4), {"mode": "delta", "bits": 8},
                jnp.asarray(base), 1))
        else:
            out = strat.aggregate_masked_fused(
                torch.from_numpy(z), part, {"mode": "delta", "bits": 8},
                torch.from_numpy(base), 1).numpy()
        np.testing.assert_allclose(out, 0.1, rtol=1e-6)


def test_wrapper_checks_arguments_as_the_reference():
    z, w = torch.ones(4, 8, 10) / 10, torch.ones(4)
    with pytest.raises(ValueError, match="unknown mode"):
        round_kernel.fused_round(z, w, 1.5, mode="nope")
    with pytest.raises(ValueError, match="requires bits"):
        round_kernel.fused_round(z, w, 1.5, mode="quant")
    with pytest.raises(ValueError, match="requires beta"):
        round_kernel.fused_round(z, w, None, mode="identity", sharpen=True)
    with pytest.raises(ValueError, match="resolved base"):
        round_kernel.fused_round(z, w, 1.5, mode="delta")
    with pytest.raises(ValueError, match="weights"):
        round_kernel.fused_round(z, torch.ones(3), 1.5)
    with pytest.raises(ValueError, match="N >= 2"):
        round_kernel.fused_round(torch.ones(2, 3, 1), torch.ones(2), 1.5,
                                 torch.ones(3, 1), mode="delta")
    with pytest.raises(ValueError, match="at least 1 bit"):
        round_kernel.fused_round(z, w, 1.5, mode="quant", bits=0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    z, w, base = _inputs(9, 3, 5, 10, "delta")
    ops.reset_launches()
    args = (torch.from_numpy(z), torch.from_numpy(w), 1.5, torch.from_numpy(base))
    assert torch.equal(ops.fused_round(*args, mode="delta", bits=8),
                       round_kernel.fused_round_plain(*args, mode="delta", bits=8))
    assert ops.launches()["fused_round"] == 0


# ---------------------------------------------------------------------------
# Engine-facing plumbing against the reference
# ---------------------------------------------------------------------------

SPECS = ["identity", "quant1", "quant4", "quant8", "cache_delta",
         "cache_delta+quant1", "cache_delta+quant8", "cache_delta+identity",
         "cache_delta+cache_delta"]


@pytest.mark.parametrize("spec", SPECS)
def test_codec_kernel_spec_matches_reference(spec):
    assert (round_kernel.codec_kernel_spec(get_codec(spec))
            == jround.codec_kernel_spec(jget_codec(spec)))


def test_codec_kernel_spec_needs_renormalized_quant():
    assert round_kernel.codec_kernel_spec(QuantCodec(8, renormalize=False)) is None
    assert jround.codec_kernel_spec(JQuantCodec(8, renormalize=False)) is None


def test_resolve_delta_base_matches_reference():
    rng = np.random.default_rng(5)
    base = _probs(rng, (7, 10))
    present = rng.random(7) < 0.5
    got = round_kernel.resolve_delta_base(torch.from_numpy(base),
                                          torch.from_numpy(present), 7, 10)
    want = jround.resolve_delta_base(jnp.asarray(base), jnp.asarray(present), 7, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        round_kernel.resolve_delta_base(None, None, 7, 10).numpy(),
        np.asarray(jround.resolve_delta_base(None, None, 7, 10)))
    np.testing.assert_array_equal(
        round_kernel.resolve_delta_base(torch.from_numpy(base), None, 7, 10).numpy(),
        base)


# ---------------------------------------------------------------------------
# The strategy's fused path against its own per-op chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["identity", "quant8", "cache_delta",
                                  "cache_delta+quant8"])
def test_strategy_fused_matches_perop_chain(spec):
    """``aggregate_masked_fused`` against ``codec.roundtrip`` +
    ``aggregate_masked``, as the reference's test does: the same float32
    arithmetic with the sums in another order and precision, so atol 1e-6
    (the reference allows one quantization step)."""
    K, M, N = 6, 10, 10
    s = EnhancedERAStrategy(beta=1.5)
    codec = get_codec(spec)
    kspec = round_kernel.codec_kernel_spec(codec)
    rng = np.random.default_rng(11)
    z = torch.from_numpy(_probs(rng, (K, M, N)))
    part = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.float32)
    base = torch.from_numpy(_probs(rng, (M, N)))
    present = torch.from_numpy(rng.random(M) < 0.5)
    z_rt = z if codec.is_identity else codec.roundtrip(z, base=base, present=present)
    perop = s.aggregate_masked(z_rt, part, None, 1)
    fbase = (round_kernel.resolve_delta_base(base, present, M, N)
             if kspec["mode"] == "delta" else None)
    fused = s.aggregate_masked_fused(z, part, kspec, fbase, 1)
    np.testing.assert_allclose(fused.numpy(), perop.numpy(), rtol=0, atol=ATOL)

    # the linear phase: the fused moment against the per-op one, and the
    # reference's fused moment (Pallas, interpret mode)
    pf = s.partial_aggregate_fused(z, part, kspec, fbase, 1)
    pp = s.partial_aggregate(z_rt, part, None, 1)
    atol = LINEAR_RTOL * float(part.sum())
    np.testing.assert_allclose(pf["zsum"].numpy(), pp["zsum"].numpy(), rtol=0, atol=atol)
    assert float(pf["wsum"]) == float(pp["wsum"]) == 4.0
    jf = JScarlet(beta=1.5).partial_aggregate_fused(
        jnp.asarray(z.numpy()), jnp.asarray(part.numpy()), kspec,
        None if fbase is None else jnp.asarray(fbase.numpy()), 1)
    np.testing.assert_allclose(pf["zsum"].numpy(), np.asarray(jf["zsum"]),
                               rtol=0, atol=atol)
