"""A fake world for the dry run: the one module of ``launch`` that reaches
PyTorch's private API (as ``analysis/traceutil.py`` is the analyzer's).

- :func:`fake_world` makes this process rank 0 of a ``"fake"`` process
  group of any size (``torch.testing._internal.distributed.fake_pg``:
  every collective returns at once and moves nothing) and gives a
  ``DeviceMesh`` over it with the reference's axis names; it refuses
  when a process group is already initialised and tears its own down.
- :func:`fake_mode` is ``FakeTensorMode``: tensors with shapes, strides,
  dtypes and a device but no storage behind them, so nothing is
  allocated and no kernel runs.  :func:`in_shape_inference` and
  :func:`active_fake_mode` tell the trace's own ops from those DTensor's
  sharding propagation runs to infer output shapes (on fake tensors of
  the global shape, under the active fake mode or one of its own).
- :func:`is_strided_shard` tells a ``_StridedShard`` placement;
  :func:`spec_of` and :func:`set_spec` read and put back a DTensor's
  sharding spec.
- :class:`DispatchMode` is ``TorchDispatchMode``.
"""
from __future__ import annotations

import contextlib
import functools
import logging
import warnings
from typing import Iterator, Sequence

import torch.distributed as dist
from torch._guards import active_fake_mode  # noqa: F401  (re-exported)
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode as DispatchMode  # noqa: F401

__all__ = ["fake_world", "fake_mode", "active_fake_mode", "in_shape_inference",
           "is_strided_shard", "spec_of", "set_spec", "DispatchMode"]


def spec_of(t):
    """A DTensor's sharding spec (its private ``_spec``), None for any
    other value."""
    return getattr(t, "_spec", None)


def set_spec(t, spec) -> None:
    """Put a DTensor's sharding spec back (``spec_of``'s inverse)."""
    t._spec = spec


def is_strided_shard(placement) -> bool:
    """Whether ``placement`` is a ``_StridedShard``: a dim sharded after
    a view merged it into an outer dim."""
    return type(placement).__name__ == "_StridedShard"


_INFERRING = [0]


def _flag_shape_inference() -> None:
    """Count DTensor's output-shape inference (it runs the op on fake
    tensors of the global shape, under the active fake mode) so that
    :func:`in_shape_inference` can tell its ops from the step's."""
    from torch.distributed.tensor import DTensor

    cls = type(DTensor._op_dispatcher.sharding_propagator)
    orig = getattr(cls, "_propagate_tensor_meta_non_cached", None)
    if orig is None or getattr(orig, "_flagged", False):
        return

    @functools.wraps(orig)
    def flagged(self, *args, **kwargs):
        _INFERRING[0] += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            _INFERRING[0] -= 1

    flagged._flagged = True
    cls._propagate_tensor_meta_non_cached = flagged


def in_shape_inference() -> bool:
    """Whether DTensor is inferring an op's output shape (its ops are not
    the step's)."""
    return _INFERRING[0] > 0


@contextlib.contextmanager
def fake_world(mesh_shape: Sequence[int], axis_names: Sequence[str],
               device_type: str) -> Iterator[object]:
    """A ``DeviceMesh`` of ``mesh_shape`` named ``axis_names`` over a
    fake process group of ``prod(mesh_shape)`` ranks, this process its
    rank 0, on ``device_type`` ("cuda" or "cpu"); the group is destroyed
    after the block.  Raises ``RuntimeError`` when a process group is
    already initialised (a fake world would replace it)."""
    import torch.distributed._tools.fake_collectives  # noqa: F401  (fake c10d kernels)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the dry run starts a "
                           "fake world of its own and needs none")
    _flag_shape_inference()
    n = 1
    for s in mesh_shape:
        n *= int(s)
    # DTensor's advice on redistribution orders and gloo's all-to-all
    # fallback, once per op and shape: the trace's counts say what moved
    quiet = logging.getLogger("torch.distributed")
    level = quiet.level
    quiet.setLevel(logging.ERROR)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="Found a non-scalar tensor")
            yield init_device_mesh(device_type, tuple(int(s) for s in mesh_shape),
                                   mesh_dim_names=tuple(axis_names))
    finally:
        dist.destroy_process_group()
        quiet.setLevel(level)


def fake_mode() -> FakeTensorMode:
    """A new ``FakeTensorMode``."""
    return FakeTensorMode()
