"""The part of ``jax.random`` that the reference calls, on explicit keys, in
PyTorch.

The stream reproduced is jax 0.9.0's default: the ``threefry2x32``
implementation with ``jax_threefry_partitionable=True``.  Every function
here gives ``jax.random``'s bits for the same key, except :func:`normal`,
whose inverse error function is the same single-precision polynomial but
may round differently in its last bit.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words;
every function takes a batch of keys on its leading axes (what
``jax.vmap`` over a key gives the reference) and puts its result behind
them.  The one primitive is a counter hash: key ``(k0, k1)`` and a 64-bit
count ``j`` give :func:`threefry2x32` of ``(k0, k1)`` and ``(j >> 32, j &
0xFFFFFFFF)``.  With it:

- ``key(s)``           ``(0, s)``
- ``fold_in(k, d)``    the hash of ``k`` at count ``d``, both words
- ``split(k, n)[j]``   the hash of ``k`` at count ``j``, both words
- ``random_bits(k, shape)``  the xor of the two words over counts
  ``0 .. prod(shape) - 1``, row-major
- ``uniform``          ``(bits >> 9) | 0x3F800000`` read as a float32, minus 1
- ``permutation(k, n)`` ``ceil(3 ln n / ln(2^32 - 1))`` rounds of ``k, sk =
  split(k)`` and a stable sort of the running order by ``random_bits(sk,
  (n,))``; ``choice(k, n, m)`` (without replacement) its first m, for
  one key over many items by selection, a chunk of counts at a time.

The hash over a batch of keys and a run of counts goes through
:func:`repro_torch.kernels.prng_kernel.threefry` (``kernels.ops.threefry``):
one kernel launch for CUDA tensors, :func:`counter_hash` (built on
:func:`threefry2x32`) for CPU tensors.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.kernels import prng_kernel
from repro_torch.kernels.prng_kernel import BITS, PAIR, UNIFORM

__all__ = ["MASK", "PAIR", "BITS", "UNIFORM", "threefry2x32", "counter_hash", "key",
           "fold_in", "split", "random_bits", "uniform", "uniform_from_bits", "normal",
           "erfinv_f32", "permutation", "choice", "shuffle_rounds", "SELECT_MIN_N",
           "SELECT_CHUNK"]

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds: the pair ``(x0, x1)`` hashed under the
    key ``(k0, k1)``, all int64 tensors holding uint32 words, broadcast
    together -> ``(y0, y1)``.  Five groups of four rounds (add, rotate
    left, xor) with the rotations (13, 15, 26, 6) and (17, 29, 16, 24) in
    turn; after group g the key schedule ``(k0, k1, k0 ^ k1 ^ 0x1BD11BDA)``
    is injected, shifted by g + 1, with g + 1 added to the second word."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & MASK
    return x0, x1


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from 32 random bits: the top 23 as the mantissa of
    a float in [1, 2), minus 1 (``jax.random.uniform``)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def counter_hash(keys: torch.Tensor, start: int, count: int, mode: str) -> torch.Tensor:
    """The plain version of the counter hash: every key of ``keys`` (``(n,
    2)`` int64) hashed at counts ``start .. start + count - 1`` ->
    ``(n, count, 2)`` int64 (``PAIR``), ``(n, count)`` int64 (``BITS``: the
    words' xor) or ``(n, count)`` float32 (``UNIFORM``).  CPU tensors
    only: on the card the kernel computes it, and nothing falls back."""
    if keys.device.type != "cpu":
        raise ValueError(f"the plain counter hash takes CPU tensors, got {keys.device}")
    j = torch.arange(start, start + count, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, 0, None], keys[:, 1, None], j >> 32, j & MASK)
    if mode == PAIR:
        return torch.stack([y0, y1], dim=-1)
    if mode == BITS:
        return y0 ^ y1
    if mode == UNIFORM:
        return uniform_from_bits(y0 ^ y1)
    raise ValueError(f"unknown counter-hash mode {mode!r}")


def _hash(keys: torch.Tensor, start: int, count: int, mode: str) -> torch.Tensor:
    """The counter hash of a batch ``(..., 2)`` of keys, its outputs behind
    the batch axes, through the kernel wrapper (which checks the keys and
    the counts)."""
    out = prng_kernel.threefry(keys.reshape(-1, keys.shape[-1]), start, count, mode)
    return out.reshape(keys.shape[:-1] + out.shape[1:])


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``(seed >> 32, seed & 0xFFFFFFFF)``
    (``(0, seed)`` for a seed that fits 32 bits; a negative 32-bit seed
    keeps its two's-complement low word, as jax without x64 does)."""
    seed = int(seed)
    hi = 0 if -2 ** 31 <= seed < 2 ** 32 else (seed >> 32) & MASK
    return torch.tensor([hi, seed & MASK], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data: int, count: int = None) -> torch.Tensor:
    """``jax.random.fold_in(k, data)`` for every key -> ``(..., 2)``; with
    ``count``, the keys folded with ``data, data + 1, ..., data + count -
    1`` -> ``(..., count, 2)`` (one hash of the whole run)."""
    if int(data) < 0 or int(data) + (1 if count is None else count) > 2 ** 32:
        raise ValueError(f"fold_in data must be uint32, got {data} (+{count})")
    out = _hash(keys, int(data), 1 if count is None else count, PAIR)
    return out[..., 0, :] if count is None else out


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)`` for every key -> ``(..., num, 2)``."""
    return _hash(keys, 0, num, PAIR)


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(shape)


def random_bits(keys: torch.Tensor, shape: Union[int, Sequence[int]]) -> torch.Tensor:
    """32 random bits (``jax.random.bits``, uint32, as int64) for every key
    -> ``(..., *shape)``."""
    shape = _shape(shape)
    out = _hash(keys, 0, math.prod(shape), BITS)
    return out.reshape(keys.shape[:-1] + shape)


def uniform(keys: torch.Tensor, shape: Union[int, Sequence[int]]) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` (float32 in [0, 1)) for every key
    -> ``(..., *shape)``."""
    shape = _shape(shape)
    out = _hash(keys, 0, math.prod(shape), UNIFORM)
    return out.reshape(keys.shape[:-1] + shape)


# Giles' single-precision inverse error function, as XLA evaluates it: w =
# -log1p(-x^2); w < 5 ? w - 2.5 : sqrt(w) - 3; Horner over nine
# coefficients; times x; +-inf at +-1.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """The inverse error function of float32 ``x`` in float32, by the
    polynomial XLA uses for ``lax.erf_inv``.  Each Horner step ``c + p *
    w`` is rounded once to float32 from float64, as XLA's fused
    multiply-add rounds it (about 99 % of ``jax.random.normal``'s values
    come out bit for bit, within 4.8e-7; two roundings a step give about
    95 %).  The square root is taken in float64 and rounded once, IEEE's
    float32 root: PyTorch's CPU float32 ``sqrt`` has been seen to return
    values 1e-4 off on its first call in a process.  ``log1p`` is the
    device's float32 one, so the card's and the CPU's values may differ
    in their last bit."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    root = torch.sqrt(w.double()).float()
    w = torch.where(small, w - 2.5, root - 3.0).double()
    f64 = dict(dtype=torch.float64, device=x.device)
    coef = [torch.where(small, torch.full((), a, **f64), torch.full((), b, **f64))
            for a, b in zip(np.float32(_ERFINV_SMALL), np.float32(_ERFINV_LARGE))]
    p = coef[0].float()
    for c in coef[1:]:
        p = torch.addcmul(c, p.double(), w).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


# jax.random.normal draws uniform(k, shape, lo, 1) with lo the float32 after -1
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_SPAN = float(np.float32(1.0) - np.float32(_NORMAL_LO))  # 2.0 in float32
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(keys: torch.Tensor, shape: Union[int, Sequence[int]]) -> torch.Tensor:
    """``jax.random.normal(k, shape)`` (float32) for every key: ``sqrt(2) *
    erfinv(u)`` with ``u`` uniform in ``(-1, 1)``."""
    u = uniform(keys, shape) * _NORMAL_SPAN + _NORMAL_LO
    return _SQRT2 * erfinv_f32(torch.clamp_min(u, _NORMAL_LO))


def shuffle_rounds(n: int) -> int:
    """Sort rounds of ``jax.random.permutation`` over n items (jax's
    ``_shuffle``: 1 at n = 60 and 100, 2 at 10^4, 0 at n = 1)."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(k, n)`` for every key -> ``(..., n)`` int64."""
    x = torch.arange(n, dtype=torch.int64, device=keys.device).expand(keys.shape[:-1] + (n,))
    for _ in range(shuffle_rounds(n)):
        pair = split(keys)
        keys = pair[..., 0, :]
        order = torch.sort(random_bits(pair[..., 1, :], (n,)), dim=-1, stable=True).indices
        x = x.gather(-1, order)
    return x


# choice over SELECT_MIN_N items or more, for one key, selects its m items
# in chunks of SELECT_CHUNK counts instead of sorting all n; the counts'
# bits are bucketed by their top SELECT_BUCKET_BITS bits
SELECT_MIN_N = 1 << 17
SELECT_CHUNK = 1 << 18
SELECT_BUCKET_BITS = 16


def _select(key: torch.Tensor, n: int, ranks: torch.Tensor) -> torch.Tensor:
    """``torch.sort(random_bits(key, (n,)), stable=True).indices[ranks]``
    for one ``(2,)`` key, in memory of a chunk and of the candidates: a
    pass counts the bits in each bucket (their top bits), a second collects
    every position whose bucket holds a wanted rank, and a stable sort of
    those few, in position order, ranks them.  Reads the counts back to
    the host (``nonzero``)."""
    shift, nb = 32 - SELECT_BUCKET_BITS, 1 << SELECT_BUCKET_BITS
    keys = key.reshape(1, 2)
    chunks = [(s, min(SELECT_CHUNK, n - s)) for s in range(0, n, SELECT_CHUNK)]
    counts = torch.zeros(nb, dtype=torch.int64, device=key.device)
    for s, c in chunks:
        counts += torch.bincount(_hash(keys, s, c, BITS)[0] >> shift, minlength=nb)
    ends = torch.cumsum(counts, 0)
    bucket = torch.searchsorted(ends, ranks, right=True)
    within = ranks - (ends[bucket] - counts[bucket])  # the rank inside its bucket
    wanted = torch.zeros(nb, dtype=torch.bool, device=key.device)
    wanted[bucket] = True
    pos, bits = [], []
    for s, c in chunks:
        b = _hash(keys, s, c, BITS)[0]
        at = torch.nonzero(wanted[b >> shift]).squeeze(1)
        pos.append(at + s)
        bits.append(b[at])
    bits, order = torch.sort(torch.cat(bits), stable=True)
    first = torch.searchsorted(bits >> shift, bucket)  # each bucket's first candidate
    return torch.cat(pos)[order[first + within]]


def choice(keys: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """``jax.random.choice(k, n, (m,), replace=False)`` for every key ->
    ``(..., m)`` int64: the first m of :func:`permutation`.  For one key
    over SELECT_MIN_N items or more, the same m by selection: the last
    sort round's first m ranks are positions in the round before it, whose
    ranks those are, and so on back to ``arange(n)`` (:func:`_select` a
    round), so the device holds a chunk, not n sort keys."""
    if not 0 <= m <= n:
        raise ValueError(f"cannot take {m} of {n} without replacement")
    lead = keys.shape[:-1]
    if n < SELECT_MIN_N or math.prod(lead) != 1:
        return permutation(keys, n)[..., :m]
    key, subkeys = keys.reshape(2), []
    for _ in range(shuffle_rounds(n)):
        pair = split(key)
        key = pair[0]
        subkeys.append(pair[1])
    at = torch.arange(m, dtype=torch.int64, device=keys.device)
    for sk in reversed(subkeys):
        at = _select(sk, n, at)
    return at.reshape(lead + (m,))
