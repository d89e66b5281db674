"""Host-side client parameter store of the active-set engine (counterpart of
``repro.checkpoint.store``).

The dense engines keep every client's parameters on the device, one
``(size_c, ...)`` stack a leaf per cohort, so the device's memory bounds
the population K.  :class:`ClientParamStore` keeps the same per-cohort
stacks on the **host** (numpy arrays, or ``np.lib.format.open_memmap``
files under a directory for a population past the host's RAM) and moves
only the rows a round needs:

- :meth:`gather` copies the selected rows of one cohort into a fresh
  ``(len(rows), ...)`` tensor dict on the device;
- :meth:`scatter` writes updated rows back.

The store holds exactly what the dense engines draw: each client's
parameters from its own key of the reference's key stream, through the
same :func:`repro_torch.models.resnet.init_mlp` that
:meth:`repro_torch.fl.cohorts.ClientModels.init_params` runs, in chunks of
``init_chunk`` clients on the store's device.  The stream is
counter-based, so a client's numbers do not depend on the chunk it was
drawn in (the reference's docstring says the same of ``jax.random``).
:meth:`as_param_list` rebuilds the dense engines' ``client_params``
structure (numpy leaves), so the shared ``state_dict`` plumbing, and
checkpoints, interchange with the other engines.

Persistence goes through :mod:`repro_torch.checkpoint.io`: :meth:`save`
writes one npz; :meth:`save_sharded` one npz per ``clients_per_shard``
row block of each cohort, under the reference's file names
(``cohort0_clients_00000000_00000512.npz``, ...), so a million-client
store never becomes one file.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.io import CheckpointKeyError, load_pytree, save_pytree
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.resnet import init_mlp

__all__ = ["ClientParamStore"]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class ClientParamStore:
    """Per-cohort host stacks of client parameters.

    Parameters
    ----------
    models:
        A :class:`repro_torch.fl.cohorts.ClientModels` (the cohorts' sizes
        and architectures).
    keys:
        ``(K, 2)`` int64 keys of the reference's key stream, one a client
        in global client order (the dense engines' ``init_params`` keys),
        on any device.
    backing:
        ``"ram"`` (numpy arrays) or ``"memmap"`` (``open_memmap`` files
        under ``directory``).
    directory:
        Required for ``backing="memmap"``; created if absent.
    init_chunk:
        Clients drawn a call (the draws do not depend on it).
    device:
        Where :meth:`gather` puts the rows: the card by default, as at
        every entry point of the port (no CUDA device raises); ``"cpu"``
        runs on the host.
    """

    def __init__(self, models, keys: torch.Tensor, *, backing: str = "ram",
                 directory: Optional[str] = None, init_chunk: int = 4096,
                 device="cuda"):
        if backing not in ("ram", "memmap"):
            raise ValueError(f"unknown backing {backing!r}")
        if backing == "memmap" and directory is None:
            raise ValueError("backing='memmap' requires a directory")
        self.models = models
        self.backing = backing
        self.directory = directory
        self.device = resolve_device(device)
        self._cohorts: List[Dict[str, np.ndarray]] = []
        if backing == "memmap":
            os.makedirs(directory, exist_ok=True)
        for c, (spec, sl) in enumerate(zip(models.cohorts, models.slices)):
            arrays: Dict[str, np.ndarray] = {}
            for lo in range(sl.start, sl.stop, init_chunk):
                hi = min(lo + init_chunk, sl.stop)
                chunk = init_mlp(keys[lo:hi].to(self.device), models.dim, models.n_classes,
                                 spec.hidden, spec.depth)
                for name, v in chunk.items():
                    if name not in arrays:
                        arrays[name] = self._alloc(c, name, (sl.stop - sl.start,) + v.shape[1:])
                    arrays[name][lo - sl.start:hi - sl.start] = v.cpu().numpy()
            self._cohorts.append(arrays)

    def _alloc(self, c: int, name: str, shape) -> np.ndarray:
        if self.backing == "ram":
            return np.empty(shape, np.float32)
        return np.lib.format.open_memmap(
            os.path.join(self.directory, f"cohort{c}_{name}.npy"), mode="w+",
            dtype=np.float32, shape=shape)

    # -- shape/bookkeeping ------------------------------------------------
    @property
    def n_cohorts(self) -> int:
        return len(self._cohorts)

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for c in self._cohorts for a in c.values())

    def leaf_names(self, c: int) -> List[str]:
        return list(self._cohorts[c])

    # -- the data path ----------------------------------------------------
    def gather(self, c: int, rows) -> Dict[str, torch.Tensor]:
        """Cohort ``c``'s selected rows (an index array or a slice) as a
        fresh ``(len(rows), ...)`` tensor dict on the store's device."""
        return {n: torch.tensor(a[rows], device=self.device)
                for n, a in self._cohorts[c].items()}

    def scatter(self, c: int, rows, updated) -> None:
        """Write an updated ``(len(rows), ...)`` stack (tensors or numpy
        arrays, keyed as the store's leaves) back into cohort ``c``."""
        for name, a in self._cohorts[c].items():
            a[rows] = _host(updated[name])

    # -- state_dict interchange -------------------------------------------
    def as_param_list(self) -> List[Dict[str, np.ndarray]]:
        """The dense engines' ``client_params`` structure, numpy leaves."""
        return [dict(arrs) for arrs in self._cohorts]

    def ingest_param_list(self, params: Sequence) -> None:
        """Overwrite the store from a dense ``client_params`` list (numpy
        arrays or tensors on any device)."""
        if len(params) != self.n_cohorts:
            raise ValueError(f"expected {self.n_cohorts} cohort stacks, got {len(params)}")
        for c, stack in enumerate(params):
            arrs = self._cohorts[c]
            if sorted(stack) != sorted(arrs):
                raise ValueError(f"cohort {c}: leaves {sorted(stack)} != store leaves "
                                 f"{sorted(arrs)}")
            for name, a in arrs.items():
                if a.shape != tuple(stack[name].shape):
                    raise ValueError(
                        f"cohort {c} leaf {name}: stack shape {tuple(stack[name].shape)} "
                        f"!= store shape {a.shape}")
            for name, a in arrs.items():
                a[...] = _host(stack[name])

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        save_pytree(path, self.as_param_list())

    def load(self, path: str) -> None:
        self.ingest_param_list(load_pytree(path, self.as_param_list()))

    def _shard_path(self, directory: str, c: int, lo: int, hi: int) -> str:
        return os.path.join(directory, f"cohort{c}_clients_{lo:08d}_{hi:08d}.npz")

    def _blocks(self, clients_per_shard: int):
        for c, arrs in enumerate(self._cohorts):
            size = self.models.sizes[c]
            for lo in range(0, size, clients_per_shard):
                hi = min(lo + clients_per_shard, size)
                yield c, lo, hi, {n: a[lo:hi] for n, a in arrs.items()}

    def save_sharded(self, directory: str, clients_per_shard: int) -> None:
        """One npz per ``clients_per_shard`` row block of every cohort."""
        os.makedirs(directory, exist_ok=True)
        for c, lo, hi, block in self._blocks(clients_per_shard):
            save_pytree(self._shard_path(directory, c, lo, hi), block)

    def load_sharded(self, directory: str, clients_per_shard: int) -> None:
        for c, lo, hi, block in self._blocks(clients_per_shard):
            fn = self._shard_path(directory, c, lo, hi)
            if not os.path.exists(fn):
                raise CheckpointKeyError(f"missing store shard {fn}")
            for name, leaf in load_pytree(fn, block).items():
                self._cohorts[c][name][lo:hi] = leaf
