"""Device meshes over ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

A JAX mesh names the devices of one program.  Here a mesh names the
ranks of a process group: rank ``r`` sits at the row-major coordinates
``unravel_index(r, shape)`` and drives ``cuda:(r % device_count)``.  A
:class:`Mesh` carries the process group of this rank's ``"data"`` axis
(the ranks that differ from it in the ``"data"`` coordinate alone: the
sharded engine partitions clients over it, the all-to-all MoE its
tokens and experts) and of its ``"model"`` axis (the all-to-all MoE's
tensor-parallel split of the expert FFN).  Ranks that differ along any
other axis (``"pod"``) hold the same data and compute the same thing.

The constructors read the default process group, which must be
initialised; a mesh whose size differs from its world size raises
``ValueError``, so do the production meshes (16x16 = 256 ranks, 2x16x16
= 512) on a smaller world.  :func:`all_reduce_sum` (in place, no
gradient), :func:`psum` and :func:`all_to_all` are the collectives the
port makes over an axis; the last two carry gradients (their backward is
their transpose, made over the same group).
:func:`run_world` starts a world of ``n`` ranks on this machine (tests,
``chip_smoke.py``); :func:`world_of_one` makes the calling process a
world of one.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import pickle
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.multiprocessing.spawn import ProcessException

__all__ = ["CLIENT_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "make_test_mesh",
           "make_production_mesh", "mesh_axis_sizes", "rank_device", "all_reduce_sum",
           "psum", "all_to_all", "run_world", "world_of_one"]

CLIENT_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """A mesh over the default process group: its shape and axis names,
    this rank's coordinates, and the process groups of this rank's
    ``"data"`` axis (``group``, None for a mesh without one) and
    ``"model"`` axis (``model_group``, None unless that axis has more than
    one rank)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    coords: Tuple[int, ...]
    group: Any = None
    model_group: Any = None

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along ``name``."""
        return self.coords[self.axis_names.index(name)]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """The mesh of ``shape`` over the default process group, whose world
    size must be ``prod(shape)``.  Every rank must call it (the axes'
    groups are created collectively, in the same order on every rank)."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised torch.distributed process group")
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs {int(np.prod(shape))} "
                         f"ranks, but the process group has {world}")
    rank = dist.get_rank()
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    group = _axis_group(shape, axis_names.index(CLIENT_AXIS), rank) \
        if CLIENT_AXIS in axis_names else None
    # only the tensor-parallel MoE reads the model group, and only when it
    # spans more than one rank
    model_group = _axis_group(shape, axis_names.index(MODEL_AXIS), rank) \
        if MODEL_AXIS in axis_names and shape[axis_names.index(MODEL_AXIS)] > 1 else None
    return Mesh(shape, axis_names, coords, group, model_group)


def _axis_group(shape: Tuple[int, ...], a: int, rank: int):
    """The process group of ``rank``'s axis ``a``: the world where the
    axis spans it, else one group per coordinate of the other axes,
    created by every rank (a group's ranks in the axis's order)."""
    if shape[a] == int(np.prod(shape)):
        return dist.group.WORLD
    mine = None
    others = [range(s) for i, s in enumerate(shape) if i != a]
    for rest in itertools.product(*others):
        ranks = [int(np.ravel_multi_index(rest[:a] + (d,) + rest[a:], shape))
                 for d in range(shape[a])]
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production pod's 16x16 mesh ("data", "model"), or 2x16x16
    ("pod", "data", "model") across two pods."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_test_mesh(data: int = 2, model: int = 4) -> Mesh:
    """A small ("data", "model") mesh for tests."""
    return make_mesh((data, model), ("data", "model"))


def mesh_axis_sizes(mesh: Mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def rank_device(device) -> torch.device:
    """``device`` for this rank: a bare ``"cuda"`` becomes ``cuda:(rank %
    device_count)``; anything else is returned as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return dev


@contextlib.contextmanager
def _gloo_sync_guard(t: torch.Tensor, group):
    """CUDA's sync debug mode off for the block when ``t`` is a CUDA
    tensor and ``group`` runs on gloo: gloo takes a CUDA tensor by staging
    it through host memory and waiting for the copies on its own thread,
    and that wait is the collective's (a device engine's rounds run at
    "error").  NCCL keeps the mode."""
    if not (t.is_cuda and dist.get_backend(group) == "gloo"):
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def all_reduce_sum(flat: torch.Tensor, group) -> torch.Tensor:
    """Sum ``flat`` over ``group`` in place and return it (on gloo with a
    CUDA tensor under :func:`_gloo_sync_guard`).  No gradient: see
    :func:`psum`."""
    with _gloo_sync_guard(flat, group):
        dist.all_reduce(flat, group=group)
    return flat


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    with _gloo_sync_guard(x, group):
        dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _Psum(torch.autograd.Function):
    """The sum over a group and its transpose, the sum of the gradients
    over the same group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(memory_format=torch.contiguous_format), ctx.group), None


class _AllToAll(torch.autograd.Function):
    """The all-to-all and its transpose, which is the same exchange: the
    gradient of block j of the result goes back to rank j."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, a new tensor (``jax.lax.psum``).  Its
    backward sums the gradients over the group: backward on every rank
    gives each rank the gradient of the sum of the ranks' losses with
    respect to its own ``x``."""
    return _Psum.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """The all-to-all over ``group`` (``jax.lax.all_to_all`` with split
    and concat axis 0, untiled): ``x``'s first axis, of the group's size,
    holds one block a rank; block i goes to the group's rank i, and block
    j of the result is what rank j sent.  A new tensor of ``x``'s shape;
    on gloo with a CUDA tensor under :func:`_gloo_sync_guard`.  Its
    backward is the same exchange of the gradients, so every rank of the
    group must run it."""
    n = dist.get_world_size(group)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all: first axis {x.shape[0]}, the group has {n} ranks")
    return _AllToAll.apply(x, group)


@contextlib.contextmanager
def world_of_one(backend: str):
    """Make this process a world of one over ``backend`` ("nccl" or
    "gloo") for the block, rendezvous through a file in a temporary
    directory; the group is destroyed after."""
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    try:
        dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank: int, n: int, backend: str, tmp: str, threads: Optional[int],
               fn: Callable, args: tuple) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=n)
    try:
        out = fn(*args)
    except BaseException as e:
        # stamped before the teardown below: a failing rank's teardown is
        # what makes its peers' collectives fail after it
        stamp = time.monotonic()
        with open(os.path.join(tmp, f"error{rank}.pkl"), "wb") as f:
            pickle.dump((stamp, f"{type(e).__name__}: {e}", traceback.format_exc()), f)
        raise
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"result{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _first_error(tmp: str, n: int, joined: ProcessException) -> ProcessException:
    """The error of the rank that raised first (the earliest monotonic
    stamp of the ranks' records), naming that rank and carrying its
    message and traceback; ``joined`` (the error the join saw) when no
    rank left a record, as for a rank that died without raising."""
    records = []
    for r in range(n):
        path = os.path.join(tmp, f"error{r}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                records.append((*pickle.load(f), r))
    if not records:
        return joined
    _, message, trace, rank = min(records)
    later = sorted(r for *_, r in records if r != rank)
    return torch.multiprocessing.ProcessRaisedException(
        f"rank {rank} of {n} raised first ({message}); ranks that raised after it: "
        f"{later}\n\n-- rank {rank}'s traceback:\n{trace}", rank, joined.error_pid)


def run_world(n: int, fn: Callable, *args, backend: str = "gloo",
              threads: Optional[int] = 1, during: Optional[Callable[[], Any]] = None,
              timeout: float = 300.0):
    """Run ``fn(*args)`` on each rank of a new world of ``n`` processes
    (the ``spawn`` start method; ``backend`` over a ``file://``
    rendezvous in a fresh temporary directory, so concurrent worlds never
    share a port) and return the ranks' results, rank 0 first.  ``fn``
    and its results must pickle; each rank runs ``torch.set_num_threads(
    threads)`` first.  ``during()``, if given, runs in this process while
    the ranks run, and its result is returned second.  A rank that raises
    fails the call (the others are stopped) with a
    ``ProcessRaisedException`` that names the rank that raised first by
    the monotonic clock and carries its message and traceback, whichever
    rank the join saw fail first (peers waiting in a collective fail after
    it, in any order); the join's exception is its cause.  A world still
    running ``timeout`` seconds after it started raises ``TimeoutError``,
    every rank stopped."""
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    try:
        deadline = time.monotonic() + timeout
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(n, backend, tmp, threads, fn, args), nprocs=n, join=False,
            start_method="spawn")
        try:
            side = during() if during is not None else None
        finally:
            try:
                while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                    if time.monotonic() >= deadline:
                        for p in ctx.processes:
                            p.kill()
                            p.join()
                        raise TimeoutError(f"a world of {n} ranks ran past {timeout} s")
            except ProcessException as joined:
                raise _first_error(tmp, n, joined) from joined
        results = []
        for r in range(n):
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return (results, side) if during is not None else results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
