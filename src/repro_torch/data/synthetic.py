"""Synthetic data substrate for the FL experiments.

A copy of ``repro.data.synthetic`` (pure numpy), kept in the port so that
it never imports the reference package; ``tests/test_torch_modules.py``
pins its arrays equal to the reference's.

The paper uses disjoint private/public image datasets (CIFAR-10 private vs
CIFAR-100 public, etc.).  Offline we synthesize the same *structure*: a
labeled private dataset drawn from N gaussian class clusters, and an
unlabeled public dataset drawn from a *shifted/overlapping* mixture
(related but non-identical distribution — the paper's key realism point),
plus Dirichlet non-IID partitioning over clients (Hsu et al. 2019).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def make_classification_data(
    n_samples: int,
    n_classes: int,
    dim: int,
    seed: int = 0,
    cluster_scale: float = 3.0,
    noise: float = 1.0,
    centers: np.ndarray | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gaussian-mixture classification data. Returns (x, y, centers)."""
    rng = np.random.default_rng(seed)
    if centers is None:
        centers = rng.normal(size=(n_classes, dim)) * cluster_scale
    y = rng.integers(0, n_classes, size=n_samples)
    x = centers[y] + rng.normal(size=(n_samples, dim)) * noise
    return x.astype(np.float32), y.astype(np.int32), centers


def make_public_private(
    n_private: int,
    n_public: int,
    n_classes: int,
    dim: int,
    seed: int = 0,
    public_shift: float = 1.0,
    cluster_scale: float = 3.0,
    noise: float = 1.0,
) -> Dict[str, np.ndarray]:
    """Private labeled + public unlabeled sets from *related but distinct*
    distributions (public centers = private centers + shift), mirroring the
    paper's CIFAR-10-private / CIFAR-100-public setup."""
    rng = np.random.default_rng(seed)
    xp, yp, centers = make_classification_data(
        n_private, n_classes, dim, seed=seed,
        cluster_scale=cluster_scale, noise=noise)
    pub_centers = centers + rng.normal(size=centers.shape) * public_shift
    xu, yu, _ = make_classification_data(
        n_public, n_classes, dim, seed=seed + 1, centers=pub_centers, noise=noise)
    # held-out test set from the private distribution
    xt, yt, _ = make_classification_data(
        max(n_private // 5, 200), n_classes, dim, seed=seed + 2,
        centers=centers, noise=noise)
    return {
        "x_private": xp, "y_private": yp,
        "x_public": xu, "y_public_true": yu,  # true labels never used in training
        "x_test": xt, "y_test": yt,
        "centers": centers,
    }


def dirichlet_partition(
    labels: np.ndarray,
    n_clients: int,
    alpha: float,
    seed: int = 0,
    min_per_client: int = 2,
) -> list[np.ndarray]:
    """Dirichlet non-IID split (Hsu et al., 2019). Smaller alpha => more skew."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    client_idx: list[list[int]] = [[] for _ in range(n_clients)]
    for c, idx in enumerate(idx_by_class):
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx, cuts)):
            client_idx[k].extend(part.tolist())
    # ensure every client has a floor of samples (move from the largest)
    sizes = [len(ci) for ci in client_idx]
    for k in range(n_clients):
        while len(client_idx[k]) < min_per_client:
            donor = int(np.argmax([len(ci) for ci in client_idx]))
            client_idx[k].append(client_idx[donor].pop())
    out = [np.array(sorted(ci), dtype=np.int64) for ci in client_idx]
    return out


def uniform_client_shards(
    x: np.ndarray, y: np.ndarray, n_clients: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Round-robin split straight into the dense ``(K, n_max, ...)``
    layout — sample ``i`` goes to client ``i % K``, slot ``i // K``.

    Fully vectorized (one pad + reshape, no Python loop over clients),
    which is what makes it tractable at the active-set engine's
    K = 10^6 benchmark scale where :func:`dirichlet_partition` +
    :func:`pad_client_shards`'s per-client loops are not.  Returns the
    same ``(xs, ys, mask)`` triple as :func:`pad_client_shards`.
    """
    n = len(y)
    n_max = -(-n // n_clients)  # ceil
    total = n_clients * n_max
    xs = np.zeros((total,) + x.shape[1:], x.dtype)
    ys = np.zeros((total,), y.dtype)
    mask = np.zeros((total,), bool)
    xs[:n], ys[:n], mask[:n] = x, y, True
    # (slot, client, ...) -> (client, slot, ...): client k's slot j holds
    # global sample j*K + k
    perm = (1, 0) + tuple(range(2, xs.ndim + 1))
    xs = xs.reshape((n_max, n_clients) + x.shape[1:]).transpose(perm)
    ys = ys.reshape(n_max, n_clients).T
    mask = mask.reshape(n_max, n_clients).T
    return np.ascontiguousarray(xs), np.ascontiguousarray(ys), \
        np.ascontiguousarray(mask)


def pad_client_shards(
    x: np.ndarray, y: np.ndarray, parts: list[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack ragged client shards into dense (K, n_max, ...) arrays with a
    boolean validity mask — the layout consumed by the vmapped FL engine."""
    K = len(parts)
    n_max = max(len(p) for p in parts)
    xs = np.zeros((K, n_max) + x.shape[1:], x.dtype)
    ys = np.zeros((K, n_max), y.dtype)
    mask = np.zeros((K, n_max), bool)
    for k, p in enumerate(parts):
        xs[k, : len(p)] = x[p]
        ys[k, : len(p)] = y[p]
        mask[k, : len(p)] = True
    return xs, ys, mask
