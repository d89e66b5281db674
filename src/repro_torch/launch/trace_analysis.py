"""What one rank of a sharded step does, counted on a trace over fake
tensors (the port's counterpart of ``repro.launch.hlo_analysis``, which
reads XLA's compiled per-device program).

The port has no compiled program: it runs eager, op by op.  So the
counts come from the ops themselves.  :func:`trace` runs a step under
two dispatch modes.  The counter sits below DTensor: for an op on
DTensors it steps aside, DTensor picks the shardings and runs the op on
each rank's local tensors, and the counter sees those local ops and the
collectives DTensor issues to move shards between them.  Every count is
therefore a rank's own:

- **dot FLOPs**: the matrix products and convolutions
  (``torch.utils.flop_counter``'s formulas: ``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, convolutions and their backward), plus each recorded flash
  attention launch at its own shapes, 4 B H d FLOPs a (query, key) pair
  it attends (the causal triangle where it is causal);
- **bytes accessed**: each op's inputs read once and outputs written once,
  views free.  That is unfused eager, which is what the port runs; a
  fused program would move fewer;
- **collectives** by kind and count, with the reference's conventions
  (``hlo_analysis.py:1-20``): an all-reduce moves twice its input, an
  all-gather its output, a reduce-scatter its input, an all-to-all its
  size; and counted by kind and shapes (what moved: a parameter
  gathered whole shows as its shard's shape in, its whole shape out);
- **the memory plan**: every storage an op makes, from its birth to its
  death (weak references), against the arguments' storages: the output
  bytes (the result's storages that are not arguments'), the temporary
  peak (the most bytes alive at once that are neither arguments nor
  outputs), the alias bytes (argument storages written in place) and the
  peak of everything alive, and at the temporaries' peak the bytes alive
  by the op that made them.  On CUDA each allocation is rounded up to
  the caching allocator's 512-byte blocks.  A storage dies with its last
  reference; one held in a reference cycle (DTensor's own caught
  exceptions make some) dies at a collection, which the trace runs at
  points its ops fix (``GC_EVERY``) with the automatic collector off, so
  the plan does not depend on what the process ran before.

The other mode sits above DTensor: where DTensor refuses an op (no
sharding rule for it, a rule that refuses the placements it is given, an
in-place op on a plain tensor with a DTensor operand), it redistributes
the op's DTensor arguments to ``Replicate`` explicitly, runs the op on
the full values and hands its results on as replicated DTensors, as
GSPMD does with an op it cannot shard; the all-gathers are counted, and
the op is listed in :attr:`TraceSummary.fallbacks`.  An in-place op so
run writes its result back into its own placements (and one that DTensor
resharded without moving its data is undone and so run).  ``copy_``,
``index_copy_`` and ``index_add_`` into a DTensor write each rank's shard
where the target is not sharded along the indexed dim (a decode cache's
row, a replicated buffer), the source brought to the target's
placements.  A view that would
merge a sharded dim into an outer dim (a ``_StridedShard`` placement,
whose redistribution PyTorch cannot do on fake tensors) runs instead on
its input replicated along those mesh dims, listed as "(strided shard)".

Ops that DTensor's sharding propagation runs to infer output shapes (on
fake tensors of the global shape) are not the step's and are not counted.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import gc
import traceback
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map_only
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import runtime
from repro_torch.launch.fake import (DispatchMode, active_fake_mode, in_shape_inference,
                                     is_strided_shard, set_spec, spec_of)

__all__ = ["TraceSummary", "Launch", "collective_bytes", "attended_pairs", "flash_flops",
           "sharded_ops", "trace", "local_tensors"]

_c10d = torch.ops._c10d_functional
_legacy = torch.ops.c10d
# op -> (kind); the reference's kinds
_COLLECTIVES: Dict[Any, str] = {
    _c10d.all_reduce.default: "all-reduce",
    _c10d.all_reduce_.default: "all-reduce",
    _c10d.all_gather_into_tensor.default: "all-gather",
    _c10d.reduce_scatter_tensor.default: "reduce-scatter",
    _c10d.all_to_all_single.default: "all-to-all",
    _c10d.broadcast.default: "collective-permute",
    _legacy.allreduce_.default: "all-reduce",
    _legacy.allgather_.default: "all-gather",
    _legacy._allgather_base_.default: "all-gather",
    _legacy.reduce_scatter_.default: "reduce-scatter",
    _legacy._reduce_scatter_base_.default: "reduce-scatter",
    _legacy.alltoall_base_.default: "all-to-all",
    _legacy.alltoall_.default: "all-to-all",
    _legacy.broadcast_.default: "collective-permute",
}
# ops that move no bytes of their own
_FREE = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
         torch.ops.aten.empty_like.default, torch.ops.aten._local_scalar_dense.default,
         _c10d.wait_tensor.default}
_TRANSCENDENTAL = {torch.ops.aten.exp, torch.ops.aten.tanh, torch.ops.aten.log,
                   torch.ops.aten.rsqrt, torch.ops.aten.pow, torch.ops.aten.sigmoid,
                   torch.ops.aten.sin, torch.ops.aten.cos, torch.ops.aten.silu,
                   torch.ops.aten.softplus, torch.ops.aten._softmax,
                   torch.ops.aten._log_softmax, torch.ops.aten.logsumexp}
_ALLOC_BLOCK = {"cuda": 512}
# ops between the trace's collections of cyclic garbage: the youngest
# generation each time, the middle one every 10th, all every 100th, as
# CPython's collector runs by allocations (see module doc)
GC_EVERY = 100


@dataclass
class Launch:
    """A kernel launch the trace recorded instead of making."""

    lib: str
    fn: str
    plan: runtime.LaunchPlan
    flops: float
    bytes: float


@dataclass
class TraceSummary:
    """A rank's counts (``HloSummary``'s fields first, so
    ``roofline.compute_roofline_from_summary`` takes it as it is)."""

    dot_flops: float = 0.0                  # matrix products + kernel launches
    transcendental_elems: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)
    # (kind, first input's shape, first output's shape) -> count
    collective_shapes: Dict[Tuple[str, tuple, tuple], int] = field(default_factory=dict)
    residual_while_loops: int = 0           # the port's layers are a Python loop
    kernel_flops: float = 0.0               # of dot_flops, the kernel launches'
    bytes_accessed: float = 0.0             # unfused eager: each op's in + out
    launches: List[Launch] = field(default_factory=list)
    fallbacks: Dict[str, int] = field(default_factory=dict)
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    temp_bytes: float = 0.0
    alias_bytes: float = 0.0
    peak_bytes: float = 0.0                 # the most alive at once, arguments included
    temp_by_op: Dict[str, float] = field(default_factory=dict)  # at the temp peak, top 8
    n_ops: int = 0

    @property
    def bytes_per_device(self) -> float:
        """argument + temp + output, the reference's sum (``dryrun.py:212-214``)."""
        return self.argument_bytes + self.temp_bytes + self.output_bytes


def collective_bytes(kind: str, in_bytes: float, out_bytes: float) -> float:
    """A rank's bytes of one collective by the reference's conventions."""
    if kind == "all-reduce":
        return 2.0 * max(in_bytes, out_bytes)
    if kind == "all-gather":
        return out_bytes
    return max(in_bytes, out_bytes)


def attended_pairs(sq: int, sk: int, causal: bool, window: int = 0) -> int:
    """The (query, key) pairs an attention keeps: query i against keys
    j <= i if causal, j > i - window for a nonzero window."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i + 1, sk) if causal else np.full(sq, sk, np.int64)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_flops(batch: int, heads: int, d: int, sq: int, sk: int, causal: bool,
                window: int = 0) -> float:
    """The two products of one flash attention launch: 2 d FLOPs a kept
    pair for the scores and 2 d for the weighted sum of the values."""
    return 4.0 * batch * heads * d * attended_pairs(sq, sk, causal, window)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_tensors(tree) -> List[torch.Tensor]:
    """Every tensor of ``tree``, a DTensor as its rank's local tensor."""
    from torch.distributed.tensor import DTensor

    leaves, _ = tree_flatten(tree)
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in leaves if isinstance(t, torch.Tensor)]


def _launch_cost(fn: str, plan: runtime.LaunchPlan, args) -> Tuple[float, float]:
    """(FLOPs, bytes) of a recorded launch: its tensor operands read or
    written once; FLOPs for flash attention alone."""
    tensors = [op for op in plan.operands if op.kind == "ptr" and op.shape is not None]
    nbytes = float(sum(int(np.prod(op.shape)) * op.itemsize for op in tensors))
    if fn != "flash_attn_launch":
        return 0.0, nbytes
    ints = [a.value for a in args if hasattr(a, "value")]
    _dtype, d, b, sq, sk, h, _hkv, causal, window = ints[:9]
    return flash_flops(b, h, d, sq, sk, bool(causal), window), nbytes


class _Counter(DispatchMode):
    """The rank's counts (see module doc)."""

    def __init__(self, device_type: str):
        super().__init__()
        self.entry_fake = active_fake_mode()
        self.block = _ALLOC_BLOCK.get(device_type, 1)
        self.s = TraceSummary()
        self.by_kind: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self.shapes: Dict[Tuple[str, tuple, tuple], int] = collections.defaultdict(int)
        self.args: Dict[int, Tuple[Any, int]] = {}        # id -> (storage, bytes)
        self.live: Dict[int, Tuple[Any, int, int]] = {}   # id -> (weakref, bytes, serial)
        self.events: List[Tuple[int, int]] = []           # (serial, +bytes | -bytes)
        self.made_by: List[str] = []                      # serial -> the op that made it
        self.alias: Dict[int, int] = {}

    # -- memory -----------------------------------------------------------------
    def _size(self, st) -> int:
        n = st.nbytes()
        return -(-n // self.block) * self.block

    def add_argument(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        self.args.setdefault(id(st), (st, self._size(st)))

    def _freed(self, key: int, _ref) -> None:
        ent = self.live.pop(key, None)
        if ent is not None:
            self.events.append((ent[2], -ent[1]))

    def _track(self, t: torch.Tensor, op: str) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.args or key in self.live:
            return
        n = self._size(st)
        serial = len(self.made_by)
        self.made_by.append(op)
        self.live[key] = (weakref.ref(st, functools.partial(self._freed, key)), n, serial)
        self.events.append((serial, n))

    def plan(self, result) -> None:
        """Fill the memory plan from the events, ``result`` the step's
        output."""
        s = self.s
        s.argument_bytes = float(sum(n for _, n in self.args.values()))
        outs = {}
        for t in local_tensors(result):
            ent = self.live.get(id(t.untyped_storage()))
            if ent is not None:
                outs[ent[2]] = ent[1]
        s.output_bytes = float(sum(outs.values()))
        temp = total = peak_temp = peak_total = 0
        at = 0
        for i, (serial, n) in enumerate(self.events):
            total += n
            peak_total = max(peak_total, total)
            if serial not in outs:
                temp += n
                if temp > peak_temp:
                    peak_temp, at = temp, i + 1
        s.temp_bytes = float(peak_temp)
        s.peak_bytes = s.argument_bytes + float(peak_total)
        s.alias_bytes = float(sum(self.alias.values()))
        alive: Dict[int, int] = {}
        for serial, n in self.events[:at]:
            if serial not in outs:
                if n > 0:
                    alive[serial] = n
                else:
                    alive.pop(serial, None)
        by_op: Dict[str, float] = collections.defaultdict(float)
        for serial, n in alive.items():
            by_op[self.made_by[serial]] += n
        s.temp_by_op = dict(sorted(by_op.items(), key=lambda kv: -kv[1])[:8])

    # -- dispatch ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is _c10d.wait_tensor.default and active_fake_mode() is not None:
            # the wait returns its input on a device; the fake kernel would
            # make a new tensor (and a second copy of the collective's result)
            return args[0]
        out = func(*args, **kwargs)
        if in_shape_inference() or active_fake_mode() is not self.entry_fake:
            return out  # DTensor's shape inference, not the step's
        s = self.s
        s.n_ops += 1
        if s.n_ops % GC_EVERY == 0:
            k = s.n_ops // GC_EVERY
            gc.collect(2 if k % 100 == 0 else 1 if k % 10 == 0 else 0)
        packet = func._overloadpacket
        kind = _COLLECTIVES.get(func)
        ins = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        if kind is not None:
            b = collective_bytes(kind, float(sum(_nbytes(t) for t in ins[:1])),
                                 float(sum(_nbytes(t) for t in outs[:1])))
            self.by_kind[kind] += b
            self.counts[kind] += 1
            self.shapes[(kind, tuple(ins[0].shape) if ins else (),
                         tuple(outs[0].shape) if outs else ())] += 1
        elif func not in _FREE and not func.is_view:
            if packet in flop_registry:
                s.dot_flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
            if packet in _TRANSCENDENTAL:
                s.transcendental_elems += float(sum(o.numel() for o in outs))
            s.bytes_accessed += float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))
        if func._schema.is_mutable:
            for arg, val in zip(func._schema.arguments, args):
                if (arg.alias_info is not None and arg.alias_info.is_write
                        and isinstance(val, torch.Tensor)):
                    key = id(val.untyped_storage())
                    if key in self.args:
                        self.alias[key] = self.args[key][1]
        if func is not _c10d.wait_tensor.default:
            for o in outs:
                self._track(o, str(func))
        return out


_LOCAL_WRITES = {torch.ops.aten.copy_.default, torch.ops.aten.index_copy_.default,
                 torch.ops.aten.index_add_.default}


def _local_write(func, args, kwargs):
    """An in-place write into a DTensor run on each rank's shard: ``copy_``
    with its source brought to the target's placements; ``index_copy_``
    and ``index_add_`` along a dim the target does not shard, with the
    index replicated and the source brought to the target's placements.
    None where the target is sharded along the indexed dim."""
    from torch.distributed.tensor import DTensor, Replicate

    self = args[0]
    mesh, pl = self.device_mesh, self.placements

    def local(t, placements):
        if not isinstance(t, DTensor):
            return t
        return t.redistribute(mesh, placements).to_local()

    if func is torch.ops.aten.copy_.default:
        self.to_local().copy_(local(args[1], pl), **kwargs)
        return self
    dim = args[1] % self.ndim
    if any(getattr(p, "dim", None) == dim for p in pl):
        return None
    index = local(args[2], [Replicate()] * mesh.ndim)
    func(self.to_local(), args[1], index, local(args[3], pl), *args[4:], **kwargs)
    return self


def _release(error) -> None:
    """Clear the frames of a refusal's tracebacks (and of the exceptions
    it chains): their locals hold the op's inputs and DTensor's
    intermediates in reference cycles that only the garbage collector
    would free, at a time that depends on what ran before."""
    seen = set()
    while error is not None and id(error) not in seen:
        seen.add(id(error))
        traceback.clear_frames(error.__traceback__)
        error = error.__cause__ or error.__context__


def _leading_only(func, args, out) -> bool:
    """Whether ``func`` is a view whose one DTensor input is sharded along
    dim 0 alone and whose output's strided shards are of dim 0 too."""
    from torch.distributed.tensor import DTensor

    ins = [a for a in args if isinstance(a, DTensor)]
    return ((func.is_view or func is torch.ops.aten._unsafe_view.default) and len(ins) == 1
            and all(getattr(p, "dim", 0) == 0 for p in ins[0].placements if p.is_shard())
            and all(getattr(p, "dim", None) == 0 for p in out.placements
                    if is_strided_shard(p)))


class _ReplicateFallback(DispatchMode):
    """Runs an op that DTensor refuses on the full, replicated values of
    its DTensor arguments (see module doc)."""

    def __init__(self):
        super().__init__()
        self.ops: Dict[str, int] = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        if func in _LOCAL_WRITES and isinstance(args[0], DTensor):
            done = _local_write(func, args, kwargs)
            if done is not None:
                return done
        self_spec = spec_of(args[0]) if func._schema.is_mutable and args else None
        error = None
        try:
            out = func(*args, **kwargs)
        except Exception as refused:  # noqa: BLE001 — retried replicated below
            error = refused
        else:
            if self_spec is None or spec_of(args[0]) == self_spec:
                strided = [i for i, p in enumerate(getattr(out, "placements", ()))
                           if is_strided_shard(p)]
                if not strided:
                    return out
                if _leading_only(func, args, out):
                    # the batch dim, sharded over several mesh dims, merged
                    # with the dims after it: each rank's rows are one
                    # block of the merged dim, in the mesh dims' order
                    return DTensor.from_local(
                        out.to_local(), out.device_mesh,
                        [Shard(0) if i in strided else p for i, p in enumerate(out.placements)],
                        run_check=False, shape=out.shape, stride=out.stride())
                # a view that merged a sharded dim into an outer one:
                # replicate the inputs on those mesh dims instead
                self.ops[f"{func} (strided shard)"] += 1

                def unstride(t):
                    pl = [Replicate() if i in strided else p for i, p in enumerate(t.placements)]
                    return t.redistribute(t.device_mesh, pl)

                rargs, rkwargs = tree_map_only(DTensor, unstride, (args, kwargs))
                return func(*rargs, **rkwargs)
            # an in-place op that resharded its self without moving its data:
            # undone, and run replicated below
            set_spec(args[0], self_spec)
        self.ops[str(func)] += 1
        mesh = next(a for a in tree_flatten((args, kwargs))[0]
                    if isinstance(a, DTensor)).device_mesh
        full = [Replicate()] * mesh.ndim

        def replicate(t):
            return t.redistribute(t.device_mesh, full).to_local()

        largs, lkwargs = tree_map_only(DTensor, replicate, (args, kwargs))
        try:
            out = func(*largs, **lkwargs)
        except Exception:  # noqa: BLE001 — the op's own error, not a sharding one
            if error is None:
                raise
            raise error
        _release(error)
        error = None
        if func._schema.is_mutable:
            for i, arg in enumerate(func._schema.arguments[:len(args)]):
                if arg.alias_info is not None and arg.alias_info.is_write:
                    if isinstance(args[i], DTensor):
                        mine = args[i].to_local()
                        if mine.untyped_storage() is not largs[i].untyped_storage():
                            whole = DTensor.from_local(largs[i], mesh, full, run_check=False)
                            mine.copy_(whole.redistribute(mesh, args[i].placements).to_local())
                    return args[i]
        return tree_map_only(
            torch.Tensor, lambda t: DTensor.from_local(t, mesh, full, run_check=False), out)


@contextlib.contextmanager
def _recorded_launches(record: List[Launch]):
    """``runtime.launch`` replaced by a recorder (operands checked as a
    launch checks them), every wrapper's launch count restored after: a
    trace makes no launch (``analysis/traceutil._record_launches``)."""
    counts = [(fn, fn.launches) for fn in kernel_ops.KERNELS]
    orig = runtime.launch

    def recorder(lib, fn, plan, *args):
        runtime.check_operands(fn, plan, args)
        record.append(Launch(lib, fn, plan, *_launch_cost(fn, plan, args)))

    runtime.launch = recorder
    try:
        yield
    finally:
        runtime.launch = orig
        for fn, n in counts:
            fn.launches = n


@contextlib.contextmanager
def sharded_ops():
    """Run the model code on DTensors: plain tensors meeting DTensors
    count as replicated (``implicit_replication``) and an op DTensor
    refuses runs replicated (see module doc).  Yields the fallback, whose
    ``ops`` names each op so run and how often.  :func:`trace` runs under
    it; so does a real sharded run (real tensors on a real world)."""
    from torch.distributed.tensor.experimental import implicit_replication

    fallback = _ReplicateFallback()
    with fallback, implicit_replication():
        yield fallback


def trace(fn: Callable[[], Any], arguments: Any, device_type: str) -> Tuple[Any, TraceSummary]:
    """Run ``fn()`` under the counter and the replicate fallback, with
    every tensor of ``arguments`` (DTensors by their local tensors) taken
    as the step's arguments, and return its result and the rank's
    :class:`TraceSummary`.  Call it inside the fake mode the arguments
    were made in; kernel launches are recorded, not made."""
    counter = _Counter(device_type)
    for t in local_tensors(arguments):
        counter.add_argument(t)
    launches: List[Launch] = []
    collecting = gc.isenabled()
    gc.disable()  # the counter collects, at points the step's ops fix
    gc.collect()
    try:
        with _recorded_launches(launches), counter, sharded_ops() as fallback:
            out = fn()
    finally:
        if collecting:
            gc.enable()
    s = counter.s
    counter.plan(out)
    for launch in launches:
        s.dot_flops += launch.flops
        s.kernel_flops += launch.flops
        s.bytes_accessed += launch.bytes
    s.launches = launches
    s.collective_by_kind = dict(counter.by_kind)
    s.collective_counts = dict(counter.counts)
    s.collective_shapes = dict(counter.shapes)
    s.collective_bytes = float(sum(counter.by_kind.values()))
    s.fallbacks = dict(fallback.ops)
    return out, s
