"""The counter hash of ``jax.random``'s threefry2x32 stream: CUDA kernel and
its plain PyTorch version.

No Pallas kernel of the reference stands behind it: the reference's
``jax.random`` calls lower to XLA's threefry2x32.  The kernel source is
``csrc/threefry.cu``.  :func:`threefry` hashes a batch of keys at a run of
counts, ``(key_i, start + j)`` for every key and every ``j < count``, in
one launch; :mod:`repro_torch.core.prng` builds ``fold_in``, ``split``,
``random_bits``, ``uniform``, ``normal`` and ``permutation`` on it.  The
wrapper takes the plain version (:func:`repro_torch.core.prng.counter_hash`)
for a CPU tensor and launches the kernel for a CUDA tensor; there is no
other path.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import runtime

__all__ = ["threefry", "layout", "launch_plan", "analysis_cases", "THREADS", "MODES",
           "PAIR", "BITS", "UNIFORM"]

THREADS = 256
# count chunks along the grid's y axis, and blocks in all, at most: the
# kernel strides over what is past them
MAX_GRID_Y = 1024
MAX_BLOCKS = 8192
# what the hash writes for each count: both words, their xor, or the xor
# turned into a float32 uniform in [0, 1); mode -> (kernel instantiation
# code, output dtype, words a count)
PAIR, BITS, UNIFORM = "pair", "bits", "uniform"
MODES = {PAIR: (0, torch.int64, 2), BITS: (1, torch.int64, 1), UNIFORM: (2, torch.float32, 1)}


def layout(n_keys: int, count: int) -> Tuple[int, int, int]:
    """(lanes_log2, grid x, grid y) of ``csrc/threefry.cu`` for ``n_keys``
    keys of ``count`` counts each: 2^lanes_log2 threads a key (the power
    of two at or above the count, at most a block), the block's other
    threads on the next keys; grid y over chunks of 2^lanes_log2 counts
    (at most MAX_GRID_Y), grid x over groups of keys (at most MAX_BLOCKS
    blocks in all)."""
    lanes_log2 = min(max(count - 1, 0).bit_length(), THREADS.bit_length() - 1)
    lanes = 1 << lanes_log2
    gy = max(1, min(runtime.cdiv(count, lanes), MAX_GRID_Y))
    gx = max(1, min(runtime.cdiv(n_keys, THREADS // lanes), MAX_BLOCKS // gy))
    return lanes_log2, gx, gy


def launch_plan(keys: torch.Tensor, out: torch.Tensor, count: int,
                mode: str) -> runtime.LaunchPlan:
    """The launch of ``csrc/threefry.cu`` over the contiguous ``(n, 2)``
    int64 keys into ``out`` (``(n, count, 2)`` int64 for ``PAIR``, written
    16 bytes a count; ``(n, count)`` int64 or float32 otherwise), in
    blocks of THREADS by :func:`layout`."""
    code, _, words = MODES[mode]
    _, gx, gy = layout(keys.shape[0], count)
    return runtime.LaunchPlan(
        f"threefry_kernel<{code}>", grid=(gx, gy, 1), block=(THREADS, 1, 1),
        operands=(runtime.ptr("keys", keys), runtime.ptr("out", out, 8 * words),
                  runtime.value("n_keys", ctypes.c_longlong),
                  runtime.value("count", ctypes.c_longlong),
                  runtime.value("start", ctypes.c_ulonglong),
                  runtime.value("mode", ctypes.c_int), runtime.value("lanes_log2", ctypes.c_int)))


def threefry(keys: torch.Tensor, start: int, count: int, mode: str) -> torch.Tensor:
    """Every key of the ``(n, 2)`` int64 ``keys`` hashed at counts ``start ..
    start + count - 1`` -> ``(n, count, 2)`` int64 (``PAIR``: both words),
    ``(n, count)`` int64 (``BITS``: their xor) or ``(n, count)`` float32
    (``UNIFORM``: the xor as a uniform in [0, 1))."""
    if mode not in MODES:
        raise ValueError(f"unknown counter-hash mode {mode!r}")
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError(f"keys must be (n, 2) int64, got {tuple(keys.shape)} {keys.dtype}")
    if start < 0 or count < 0 or start + count > 2 ** 64:
        raise ValueError(f"counts {start} .. {start + count} outside [0, 2^64)")
    if keys.device.type == "cpu":
        # core.prng imports this module: not at the top
        from repro_torch.core import prng

        return prng.counter_hash(keys, start, count, mode)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    code, dtype, words = MODES[mode]
    n = keys.shape[0]
    keys = keys.contiguous()
    out = torch.empty((n, count) + ((2,) if words == 2 else ()), dtype=dtype,
                      device=keys.device)
    if n == 0 or count == 0:
        return out
    lanes_log2, _, _ = layout(n, count)
    runtime.launch("threefry", "threefry_launch", launch_plan(keys, out, count, mode), keys,
                   out, ctypes.c_longlong(n), ctypes.c_longlong(count), ctypes.c_ulonglong(start),
                   ctypes.c_int(code), ctypes.c_int(lanes_log2))
    threefry.launches += 1
    return out


threefry.launches = 0


def analysis_cases():
    """(label, fn, args) triples for the launch-plan lint
    (:mod:`repro_torch.analysis.launch_checks`) at the shapes the FL path
    launches: a leg of 300 round keys folded in (one key, 300 counts) and
    split; the leg's sort bits over |P| = 10^4 (300 keys); the slice's 100
    clients' uniforms for a fraction draw; the expiry uniforms (300 keys of
    m = 1000); the clients' keys ``split(key(seed), K + 1)`` of the active
    engine at K = 10^6, and one chunk of its participation's bits there
    (``core.prng.choice`` by selection).  ``args`` are (shape, dtype)
    pairs; the lint makes them on the fake card."""
    i64 = torch.int64
    return [
        ("threefry/fold-1x300", lambda k: threefry(k, 1, 300, "pair"), (((1, 2), i64),)),
        ("threefry/split-300x2", lambda k: threefry(k, 0, 2, "pair"), (((300, 2), i64),)),
        ("threefry/bits-300x10000", lambda k: threefry(k, 0, 10000, "bits"),
         (((300, 2), i64),)),
        ("threefry/bits-300x100", lambda k: threefry(k, 0, 100, "bits"), (((300, 2), i64),)),
        ("threefry/uniform-300x1000", lambda k: threefry(k, 0, 1000, "uniform"),
         (((300, 2), i64),)),
        ("threefry/split-1x1000001", lambda k: threefry(k, 0, 10 ** 6 + 1, "pair"),
         (((1, 2), i64),)),
        ("threefry/bits-1x262144", lambda k: threefry(k, 0, 1 << 18, "bits"),
         (((1, 2), i64),)),
    ]
