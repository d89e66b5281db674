"""The port's flash attention module against the JAX package's Pallas
kernel and its oracle.

The Pallas kernel runs in interpret mode on the CPU, as
``tests/test_kernels.py`` runs it; the port's wrapper takes its plain
PyTorch version for CPU tensors.  Inputs are made with numpy from a
fixed seed and handed to both.

Tolerances:

- float32, against the oracle (``kernels/ref.py``): atol 1e-5.  The
  plain version is the oracle's order of operations (scores divided by
  sqrt(d), masked to -1e30, softmax, product with v); the two libraries'
  einsums and softmax round in other orders, about 1e-7 on outputs of
  magnitude up to ~3.
- float32, against the Pallas kernel: atol 1e-5.  It also scales q
  before the product and runs an online softmax over 128-key blocks,
  which differ from the oracle at float32 rounding.
- bfloat16: both sides compute in float32 and round once to bfloat16, so
  an output differs by at most one bfloat16 step where the two float32
  values straddle a rounding boundary: ``|a - b| <= 2**-7 * max(|b|, 1)``
  (one step is 2**-7 of the value's binade or less).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attn_kernel as jattn
from repro.kernels import ref as jref
from repro_torch.kernels import attn_kernel, ops

F32_ATOL = 1e-5
BF16_STEP = 2.0 ** -7

# (B, Sq, Sk, H, Hkv, d, causal, window, dtype): the reference's
# block-alignment regression shapes (tests/test_kernels.py), a GQA case
# and a bfloat16 case; then head dims between the port's kernel
# instantiations (96: D = 128 on tiles zero past d) and past them (136:
# column blocks), which the reference's kernel takes as any other d
CASES = [
    (1, 4, 4, 2, 1, 64, True, 0, "float32"),
    (1, 100, 100, 2, 1, 64, True, 7, "float32"),
    (1, 130, 130, 2, 1, 64, True, 0, "float32"),
    (1, 8, 20, 2, 1, 64, False, 0, "float32"),
    (2, 128, 128, 4, 2, 64, True, 0, "float32"),
    (1, 128, 128, 4, 2, 64, True, 0, "bfloat16"),
    (1, 130, 130, 4, 2, 96, True, 0, "float32"),
    (1, 100, 100, 2, 1, 136, True, 7, "float32"),
    (1, 64, 80, 2, 2, 136, False, 0, "bfloat16"),
]


def _qkv(seed, B, Sq, Sk, H, Hkv, d, dtype="float32"):
    """numpy float32 normals, rounded to ``dtype`` as both packages hold
    them."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, H, d), (B, Sk, Hkv, d), (B, Sk, Hkv, d))]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    j = [jnp.asarray(a, jnp.dtype(dtype)) for a in arrs]
    return t, j


def _assert_close(got: torch.Tensor, want, dtype: str) -> None:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    else:
        bound = BF16_STEP * np.maximum(np.abs(want), 1.0)
        assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,d,causal,window,dtype", CASES)
def test_plain_matches_oracle(B, Sq, Sk, H, Hkv, d, causal, window, dtype):
    (q, k, v), (jq, jk, jv) = _qkv(Sq * 7 + Sk, B, Sq, Sk, H, Hkv, d, dtype)
    got = attn_kernel.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype
    _assert_close(got, jref.flash_attention(jq, jk, jv, causal=causal, window=window),
                  dtype)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,d,causal,window,dtype", CASES)
def test_plain_matches_pallas_kernel(B, Sq, Sk, H, Hkv, d, causal, window, dtype):
    (q, k, v), (jq, jk, jv) = _qkv(Sq * 7 + Sk, B, Sq, Sk, H, Hkv, d, dtype)
    got = attn_kernel.flash_attention_plain(q, k, v, causal=causal, window=window)
    want = jattn.flash_attention(jq, jk, jv, causal=causal, window=window,
                                 interpret=True)
    _assert_close(got, want, dtype)


# The float32 kernel's arithmetic (csrc/flash_attn.cu, flash_fwd_tf32_kernel)
# emulated on the CPU: each factor split into tf32 parts, hi = tf32(x) and
# lo = tf32(x - hi) (tf32: x rounded to 10 explicit significand bits,
# ties away from zero, by an add and a mask on the bit pattern),
# each product taken as lo.hi + hi.lo + hi.hi with float32 sums, the scale
# folded into exp2.  Shapes: chip_smoke.py's
# FLASH_CASES at d = 64, 96 and 256.
SPLIT_CASES = [
    (2, 200, 200, 8, 2, 64, True, 64),   # GQA + window, ragged
    (2, 100, 300, 4, 4, 64, False, 0),   # non-causal Sq != Sk
    (1, 300, 100, 4, 2, 64, False, 16),  # rows left with no key
    (1, 4, 4, 2, 1, 64, True, 0),        # tiny
    (2, 200, 257, 4, 2, 64, False, 0),   # Sk one past 4 key tiles
    (1, 300, 300, 4, 2, 96, True, 0),
    (1, 300, 100, 2, 1, 256, False, 16),  # rows left with no key
    (2, 256, 256, 4, 2, 256, True, 0),   # GQA
]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest tf32 value, ties away from zero, as the
    kernel rounds: 0x1000 added to the sign-magnitude pattern, the low 13
    bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _emulated_flash(q, k, v, causal, window, passes):
    """The kernel's products with ``passes`` = 3 (3xTF32) or 1 (one tf32
    pass), its exp2 softmax, and the oracle's mean of v for rows with no
    valid key."""
    def split(x):
        hi = _tf32(x)
        return hi, _tf32(x - hi)

    def product(eq, a, b):
        (ah, al), (bh, bl) = split(a), split(b)
        if passes == 1:
            return torch.einsum(eq, ah, bh)
        return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)

    _B, Sq, H, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(H // Hkv, dim=2)
    vr = v.repeat_interleave(H // Hkv, dim=2)
    s = product("bqhd,bkhd->bhqk", q, kr)
    qpos = torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, -float("inf"))
    scale = torch.tensor(1.4426950408889634 / float(d) ** 0.5, dtype=torch.float32)
    m = s.amax(-1, keepdim=True)
    empty = m == -float("inf")
    p = torch.exp2(s * scale - torch.where(empty, 0.0, m) * scale)
    o = product("bhqk,bkhd->bqhd", p, vr) / p.sum(-1).permute(0, 2, 1)[..., None]
    mean_v = vr.mean(dim=1, keepdim=True).expand_as(o)
    return torch.where(empty.permute(0, 2, 1, 3), mean_v, o)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,d,causal,window", SPLIT_CASES)
def test_3xtf32_split_keeps_float32_tolerance(B, Sq, Sk, H, Hkv, d, causal, window):
    """The error budget of the float32 kernel's split, known before the
    card: within F32_ATOL of the plain version at every shape."""
    (q, k, v), _ = _qkv(Sq + 3 * Sk + d, B, Sq, Sk, H, Hkv, d)
    got = _emulated_flash(q, k, v, causal, window, passes=3)
    want = attn_kernel.flash_attention_plain(q, k, v, causal, window)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("d", [64, 256])
def test_one_tf32_pass_misses_float32_tolerance(d):
    """Why the kernel splits: one tf32 pass (11 significant bits a factor)
    is off the plain version by far more than F32_ATOL."""
    (q, k, v), _ = _qkv(d, 1, 128, 128, 2, 1, d)
    want = attn_kernel.flash_attention_plain(q, k, v, True, 0)
    err = float((_emulated_flash(q, k, v, True, 0, passes=1) - want).abs().max())
    assert err > 10 * F32_ATOL


def test_fully_masked_rows_take_the_oracles_mean_of_v():
    """Non-causal with a window and Sq > Sk + window: rows i >= Sk + w - 1
    have no key left.  The oracle's softmax of equal scores gives them the
    mean of v over all Sk keys; the plain version (and the kernel, on the
    card) gives the same."""
    B, Sq, Sk, H, Hkv, d, w = 1, 40, 16, 2, 1, 64, 4
    (q, k, v), (jq, jk, jv) = _qkv(11, B, Sq, Sk, H, Hkv, d)
    got = attn_kernel.flash_attention_plain(q, k, v, causal=False, window=w)
    _assert_close(got, jref.flash_attention(jq, jk, jv, causal=False, window=w),
                  "float32")
    empty = slice(Sk + w - 1, None)
    mean_v = v.mean(dim=1, keepdim=True).repeat_interleave(H // Hkv, dim=2)
    torch.testing.assert_close(got[:, empty], mean_v.expand_as(got[:, empty]),
                               rtol=0, atol=F32_ATOL)


def test_cpu_wrapper_is_the_plain_version_and_counts_no_launch():
    (q, k, v), _ = _qkv(3, 2, 128, 128, 4, 2, 64)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=True, window=16)
    assert torch.equal(got, attn_kernel.flash_attention_plain(q, k, v, True, 16))
    assert ops.launches()["flash_attention"] == 0


@pytest.mark.parametrize("shapes,kw,err", [
    (((1, 8, 4, 64), (1, 8, 3, 64), (1, 8, 3, 64)), {}, ValueError),  # H % Hkv
    (((1, 8, 4, 64), (1, 8, 2, 32), (1, 8, 2, 32)), {}, ValueError),  # head dims
    (((1, 8, 4, 64), (1, 8, 2, 64), (1, 9, 2, 64)), {}, ValueError),  # k vs v
    (((1, 8, 4, 64), (1, 0, 2, 64), (1, 0, 2, 64)), {}, ValueError),  # no key
    (((1, 8, 4, 64), (1, 8, 2, 64), (1, 8, 2, 64)), {"window": 2.0}, TypeError),
])
def test_wrapper_refuses_bad_operands(shapes, kw, err):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(err):
        ops.flash_attention(q, k, v, **kw)


def test_pallas_fully_masked_rows_divide_by_the_padded_length():
    """A reference fault the port does not copy: the Pallas kernel adds
    exp(0) to a fully masked row's sum for every visited key position,
    pad positions included, so such a row gets sum(v) / padded Sk (24 for
    Sk=20); the oracle, and the port, give sum(v) / Sk."""
    B, Sq, Sk, H, Hkv, d, w = 1, 40, 20, 2, 1, 64, 4
    (q, k, v), (jq, jk, jv) = _qkv(12, B, Sq, Sk, H, Hkv, d)
    pallas = np.asarray(jattn.flash_attention(jq, jk, jv, causal=False, window=w,
                                              interpret=True))
    got = attn_kernel.flash_attention_plain(q, k, v, causal=False, window=w).numpy()
    empty = slice(Sk + w - 1, None)
    vsum = v.sum(dim=1, keepdim=True).numpy()
    np.testing.assert_allclose(pallas[:, empty], np.broadcast_to(vsum / 24, pallas[:, empty].shape),
                               rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(got[:, empty], np.broadcast_to(vsum / Sk, got[:, empty].shape),
                               rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(got[:, :empty.start], pallas[:, :empty.start],
                               rtol=0, atol=F32_ATOL)
