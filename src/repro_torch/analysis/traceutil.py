"""Shared tracing machinery for the static analyzer (counterpart of
``repro.analysis.traceutil``).

:func:`trace` runs a function on fake CUDA tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``): tensors with shapes,
strides, dtypes and a ``"cuda"`` device but no data, so the kernel
wrappers take their CUDA branch and nothing executes, on a machine with
or without a card.  While it runs, spies record what a trace of a jaxpr
would show or lose:

- each host read of a device value (``aten._local_scalar_dense``:
  ``.item()``, ``float()``, ``bool()``), which then returns a stand-in so
  the trace goes on;
- each device-to-host copy (``.cpu()``, ``.to("cpu")``, a ``copy_`` into a
  CPU tensor), which fake mode would let pass silently;
- each host numpy RNG constructed (the reference's spy);
- each kernel launch, with its :class:`~repro_torch.kernels.runtime.LaunchPlan`
  (``runtime.launch`` is replaced for the trace, so nothing is built or
  launched, and no launch count moves).

``.numpy()`` on a fake tensor fails, and so fails the trace.

On a build without CUDA, gradients are not traced: such a build cannot
run autograd on fake CUDA tensors (its graph needs the CUDA device guard
and aborts the process).  There the trace runs with grad mode off,
``torch.enable_grad`` turned into a no-op and ``torch.autograd.grad``
answering zeros of its inputs' shapes: the losses' forward code and the
updates run on fake tensors; the backward is autograd's own code, with
no user code in it (the port defines no ``autograd.Function``) and so no
host read.  Where a CUDA device is present the real backward is traced.

``FakeTensorMode`` is private PyTorch API: this module is the one place
that imports it.  On a build without CUDA its device guard does not cover
the Python bindings that take a device guard of their own: indexing runs
here on a fake CPU twin of the tensor with the same sizes, strides and
storage offset, the result mapped back onto the fake CUDA tensor;
``contiguous`` is a ``clone`` where it copies; ``~x`` is
``torch.bitwise_not(x)``; a scalar conversion calls
``aten._local_scalar_dense`` itself.
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterator, List, NamedTuple, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops, runtime

__all__ = ["Launch", "TraceResult", "trace", "tensor_spec", "record_host_rng"]


class Launch(NamedTuple):
    """One kernel launch a trace recorded."""

    lib: str
    fn: str
    plan: runtime.LaunchPlan


def tensor_spec(shape, dtype=torch.float32):
    """An argument of :func:`trace` that becomes a fake CUDA tensor (the
    counterpart of ``jax.ShapeDtypeStruct``)."""
    return (tuple(shape), dtype)


def _is_spec(a) -> bool:
    return (isinstance(a, tuple) and len(a) == 2 and isinstance(a[0], tuple)
            and isinstance(a[1], torch.dtype))


@contextlib.contextmanager
def record_host_rng(record: List[str]):
    """Monkeypatch the ``np.random`` constructors for the duration of a
    trace: a host RNG draw leaves no trace in the tensors (numpy runs on
    the host and bakes a constant in), so the only reliable static
    detector is catching the constructor call itself."""
    orig_rng, orig_rs = np.random.default_rng, np.random.RandomState

    def spy_rng(*a, **k):
        record.append("np.random.default_rng")
        return orig_rng(*a, **k)

    def spy_rs(*a, **k):
        record.append("np.random.RandomState")
        return orig_rs(*a, **k)

    np.random.default_rng, np.random.RandomState = spy_rng, spy_rs
    try:
        yield record
    finally:
        np.random.default_rng, np.random.RandomState = orig_rng, orig_rs


@contextlib.contextmanager
def _stub_autograd() -> Iterator[None]:
    """Grad mode off and gradients as zeros for the trace, on a build
    without a CUDA device only (see module doc)."""
    if torch.cuda.is_available():
        yield
        return
    orig_grad, orig_enable = torch.autograd.grad, torch.enable_grad

    def grad(outputs, inputs, *args, **kwargs):
        seq = [inputs] if isinstance(inputs, torch.Tensor) else list(inputs)
        return tuple(torch.zeros_like(x) for x in seq)

    class enable_grad(contextlib.ContextDecorator):  # noqa: N801 — torch's name
        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    torch.autograd.grad, torch.enable_grad = grad, enable_grad
    try:
        with torch.no_grad():
            yield
    finally:
        torch.autograd.grad, torch.enable_grad = orig_grad, orig_enable


@contextlib.contextmanager
def _record_launches(record: List[Launch]) -> Iterator[None]:
    """Replace ``runtime.launch`` with a recorder (the operands are checked
    as a launch checks them) and restore every wrapper's launch count
    after: what a trace records is no launch."""
    counts = [(fn, fn.launches) for fn in ops.KERNELS]
    orig = runtime.launch

    def recorder(lib, fn, plan, *args):
        runtime.check_operands(fn, plan, args)
        record.append(Launch(lib, fn, plan))

    runtime.launch = recorder
    try:
        yield
    finally:
        runtime.launch = orig
        for fn, n in counts:
            fn.launches = n


class _HostSpy(TorchDispatchMode):
    """Records host reads and device-to-host copies (see module doc)."""

    def __init__(self):
        super().__init__()
        self.host_reads: List[str] = []
        self.to_host: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default and args[0].device.type == "cuda":
            x = args[0]
            self.host_reads.append(f"{tuple(x.shape)} {str(x.dtype)[6:]}")
            if x.dtype == torch.bool:
                return True
            return 1.0 if x.dtype.is_floating_point else 1
        if func is torch.ops.aten._to_copy.default:
            dst = kwargs.get("device")
            if (args[0].device.type == "cuda" and dst is not None
                    and torch.device(dst).type == "cpu"):
                self.to_host.append(f"{tuple(args[0].shape)} to the host")
        if func is torch.ops.aten.copy_.default:
            if args[0].device.type == "cpu" and args[1].device.type == "cuda":
                self.to_host.append(f"{tuple(args[1].shape)} copied into a host tensor")
        return func(*args, **kwargs)


def _cpu_twin(x: torch.Tensor):
    """(root, view): a fake CPU tensor with ``x``'s sizes, strides and
    storage offset, and the storage-sized tensor it views."""
    span = x.storage_offset() + 1 + sum((n - 1) * st for n, st in zip(x.shape, x.stride())
                                        if n > 0)
    root = torch.empty(span, dtype=x.dtype, device="cpu")
    return root, root.as_strided(x.shape, x.stride(), x.storage_offset())


def _index_on_twin(index):
    """``index`` with every CUDA tensor in it replaced by a CPU one of the
    same shape and dtype."""
    def one(i):
        if isinstance(i, torch.Tensor) and i.device.type == "cuda":
            return torch.empty(i.shape, dtype=i.dtype, device="cpu")
        return i
    return tuple(one(i) for i in index) if isinstance(index, tuple) else one(index)


def _getitem(x: torch.Tensor, index):
    root, twin = _cpu_twin(x)
    y = twin[_index_on_twin(index)]
    if y._base is root:  # a view: the same view of x
        return x.as_strided(y.shape, y.stride(), y.storage_offset())
    return torch.empty_strided(y.shape, y.stride(), dtype=y.dtype, device=x.device)


_TO_PYTHON = {torch.Tensor.__float__: float, torch.Tensor.__int__: int,
              torch.Tensor.__bool__: bool, torch.Tensor.__index__: int,
              torch.Tensor.item: lambda v: v}


class _CudaBindings(TorchFunctionMode):
    """Python indexing, ``contiguous``, ``~`` and the scalar conversions
    (``float()``, ``int()``, ``bool()``, ``.item()``) of fake CUDA tensors
    (see module doc).  A conversion goes through
    ``aten._local_scalar_dense``, where the host spy records it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if args and isinstance(args[0], torch.Tensor) and args[0].device.type == "cuda":
            x = args[0]
            if func in _TO_PYTHON:
                return _TO_PYTHON[func](torch.ops.aten._local_scalar_dense.default(x))
            if func is torch.Tensor.__getitem__:
                return _getitem(x, args[1])
            if func is torch.Tensor.__setitem__:
                _getitem(x, args[1])  # the index must be valid; no data to write
                return None
            if func is torch.Tensor.__invert__:
                return torch.bitwise_not(x)
            if func is torch.Tensor.contiguous:
                fmt = kwargs.get("memory_format", args[1] if len(args) > 1
                                 else torch.contiguous_format)
                return x if x.is_contiguous(memory_format=fmt) else x.clone(memory_format=fmt)
        return func(*args, **kwargs)


class TraceResult:
    """Outcome of one trace: the function's output (or the exception) plus
    what the spies observed."""

    def __init__(self, output: Any, error: Optional[BaseException], host_reads: List[str],
                 to_host: List[str], host_rng: List[str], launches: List[Launch]):
        self.output = output
        self.error = error
        self.host_reads = host_reads
        self.to_host = to_host
        self.host_rng = host_rng
        self.launches = launches

    @property
    def ok(self) -> bool:
        return self.error is None

    def launched(self, lib: str) -> bool:
        return any(launch.lib == lib for launch in self.launches)

    def scan_safety_violations(self) -> List[str]:
        """Why this trace is NOT safe inside the device engine's rounds,
        which run without a host sync (empty list = safe)."""
        out = []
        if self.error is not None:
            out.append(f"trace failed: {type(self.error).__name__}: "
                       f"{_first_line(self.error)}")
        if self.host_reads:
            out.append(f"host reads of device values: {self.host_reads[:3]}")
        if self.to_host:
            out.append(f"device-to-host copies: {self.to_host[:3]}")
        if self.host_rng:
            out.append(f"host numpy RNG constructed during trace: "
                       f"{sorted(set(self.host_rng))}")
        return out


def _first_line(exc: BaseException) -> str:
    return str(exc).strip().splitlines()[0][:200] if str(exc) else ""


def trace(fn, *args) -> TraceResult:
    """Run ``fn`` on fake CUDA tensors, capturing failure, host reads,
    device-to-host copies, host RNG and launches.  Each argument made by
    :func:`tensor_spec` (a ``(shape, dtype)`` pair) becomes a fake CUDA
    tensor; any other argument is passed as it is."""
    rng: List[str] = []
    launches: List[Launch] = []
    spy = _HostSpy()
    with record_host_rng(rng), _record_launches(launches), FakeTensorMode(), _stub_autograd():
        fake = [torch.empty(a[0], dtype=a[1], device="cuda") if _is_spec(a) else a
                for a in args]
        try:
            with spy, _CudaBindings():
                out = fn(*fake)
        except Exception as e:  # noqa: BLE001 — any trace failure is data
            return TraceResult(None, e, spy.host_reads, spy.to_host, rng, launches)
    return TraceResult(out, None, spy.host_reads, spy.to_host, rng, launches)
