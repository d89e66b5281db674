"""Logical-axis -> mesh-axis sharding rules (the port of
``repro.launch.sharding``).

Model code names every parameter dim logically ("vocab", "ffn",
"heads", "kv", "experts", "embed", "layers", ...:
``models.registry.param_axes``).  This module turns those names into
the reference's PartitionSpec entries for a concrete mesh under a named
scheme, and those entries into DTensor placements:

- ``ep``   tp + experts sharded over "data" (pairs with the all-to-all
  dispatch, ``models/moe_a2a.py``).
- ``tp``   Megatron-style tensor parallelism on the "model" axis
  (vocab/ffn/heads/kv; the expert FFN's inner dim), parameters
  replicated over the "data"/"pod" axes (pure data parallelism).
- ``fsdp`` additionally shards a suitable param dim over "data"
  (experts first, then embed/vocab rows), which also shards gradients
  and optimizer state (same specs), cutting per-rank state by the data
  axis's size.

Divisibility fallbacks are the reference's: a dim that does not divide
evenly is left replicated (kv_heads=8 on model=16 => replicated KV, GQA
tensor parallelism's usual practice; whisper's heads=20 => attention
stays replicated and only the FFN is split).

A spec is a tuple with one entry a tensor dim: None (replicated), a mesh
axis name, or a tuple of two or more names (that dim split over several
mesh axes, the first the major one) -- the entries of the reference's
``PartitionSpec``.  The functions take anything that names its axes and
their sizes: the port's ``launch.mesh.Mesh``, a ``DeviceMesh`` with
``mesh_dim_names``, or a duck type with ``axis_names`` and
``devices.shape`` (the reference's tests' stand-in).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["axis_sizes", "spec_for_param", "batch_spec", "spec_for_activation", "placements",
           "param_shardings", "cache_shardings", "opt_state_shardings", "local_shape"]

Spec = Tuple[Any, ...]

# candidates for the "model" (TP) axis, in priority order
_MODEL_CANDIDATES = ("vocab", "ffn", "heads", "kv")
# candidates for the "data" (FSDP) axis, in priority order
_DATA_CANDIDATES = ("experts", "embed", "vocab", "ffn")


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh, the port's Mesh or a duck
    type with ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    devices = getattr(mesh, "devices", None)
    shape = devices.shape if devices is not None else mesh.shape
    return dict(zip(mesh.axis_names, tuple(shape)))


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def spec_for_param(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...], mesh,
                   scheme: str = "tp") -> Spec:
    """The spec of one parameter from its logical dim names."""
    msize = _axis_size(mesh, "model")
    dsize = _axis_size(mesh, "data")
    assign: List[Any] = [None] * len(axes)

    def place(mesh_axis: str, size: int, candidates) -> None:
        for cand in candidates:
            for i, name in enumerate(axes):
                if name == cand and assign[i] is None and shape[i] % size == 0 and size > 1:
                    assign[i] = mesh_axis
                    return

    place("model", msize, _MODEL_CANDIDATES)
    if scheme == "fsdp":
        place("data", dsize, _DATA_CANDIDATES)
    elif scheme == "ep":
        # expert parallelism only: the expert dim over data; dense
        # parameters stay replicated over data
        place("data", dsize, ("experts",))
    elif scheme != "tp":
        raise ValueError(f"unknown scheme {scheme!r}")
    return tuple(assign)


def _batch_axes(mesh) -> List[str]:
    return [n for n in ("pod", "data") if _axis_size(mesh, n) > 1]


def _entry(names: List[str]):
    """A spec entry of mesh axes: None, a name, or a tuple of names (a
    one-name tuple is the name, as PartitionSpec keeps it)."""
    if not names:
        return None
    return names[0] if len(names) == 1 else tuple(names)


def batch_spec(mesh) -> Spec:
    """The global batch's spec: its first dim over (pod, data)."""
    return (_entry(_batch_axes(mesh)),)


def spec_for_activation(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                        mesh) -> Spec:
    """Cache / activation specs: 'batch' -> (pod, data); 'ctx' -> data
    (context-parallel long decode); 'kv'/'heads'/'ffn' -> model."""
    assign: List[Any] = [None] * len(axes)
    msize = _axis_size(mesh, "model")
    for i, name in enumerate(axes):
        if name == "batch":
            bnames = _batch_axes(mesh)
            total = math.prod(_axis_size(mesh, n) for n in bnames) if bnames else 1
            if bnames and shape[i] % total == 0:
                assign[i] = _entry(bnames)
        elif name == "ctx" and shape[i] % _axis_size(mesh, "data") == 0:
            assign[i] = "data"
        elif name in ("kv", "heads", "ffn") and shape[i] % msize == 0 and msize > 1:
            assign[i] = "model"
    return tuple(assign)


def placements(spec: Spec, device_mesh) -> list:
    """The DTensor placements of ``spec`` on ``device_mesh`` (a
    ``DeviceMesh`` with named dims): ``Shard(i)`` on each mesh dim that
    entry i names, ``Replicate()`` on the others.  An entry naming
    several axes, ("pod", "data"), shards its tensor dim over those mesh
    dims in that order, the first the major one (the reference's
    PartitionSpec order); a mesh axis the spec names that the mesh lacks
    raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for n in (entry if isinstance(entry, tuple) else (entry,)):
            if n not in names:
                raise ValueError(f"spec {spec} names mesh axis {n!r}, the mesh has {names}")
            out[names.index(n)] = Shard(i)
    return out


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """A rank's shape of a tensor of ``shape`` under ``spec`` on
    ``mesh``: each sharded dim divided by the product of its axes' sizes
    (every rule above shards only a dim that divides)."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is not None:
            for n in (entry if isinstance(entry, tuple) else (entry,)):
                out[i] //= _axis_size(mesh, n)
    return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _map(fn, axes_tree, shapes_tree):
    if _is_axes(axes_tree):
        return fn(axes_tree, shapes_tree)
    return {k: _map(fn, axes_tree[k], shapes_tree[k]) for k in axes_tree}


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf[0])


def param_shardings(axes_tree: Any, shapes_tree: Any, mesh, scheme: str = "tp") -> Any:
    """The spec of every parameter: a tree of ``axes_tree``'s structure.
    ``shapes_tree`` holds tensors or ``(shape, dtype)`` specs."""
    return _map(lambda ax, sh: spec_for_param(ax, _shape(sh), mesh, scheme),
                axes_tree, shapes_tree)


def cache_shardings(cache_axes_tree: Any, shapes_tree: Any, mesh) -> Any:
    """The spec of every decode-cache entry (:func:`spec_for_activation`)."""
    return _map(lambda ax, sh: spec_for_activation(ax, _shape(sh), mesh),
                cache_axes_tree, shapes_tree)


def opt_state_shardings(param_shardings_tree: Any, opt_state_shapes: Any, mesh) -> Any:
    """AdamW's m and v mirror the parameters' specs and its step count is
    replicated; momentum's state mirrors the parameters; SGD has none."""
    if isinstance(opt_state_shapes, dict) and set(opt_state_shapes) == {"m", "v", "t"}:
        return {"m": param_shardings_tree, "v": param_shardings_tree, "t": ()}
    if isinstance(opt_state_shapes, tuple) and opt_state_shapes == ():
        return ()
    return param_shardings_tree
