"""Build, load and launch support for the port's hand-written CUDA kernels.

Every kernel lives in one ``csrc/<name>.cu`` file with a plain C launch
function.  :func:`build` compiles each source with ``nvcc`` for
``sm_90a`` into its own shared library under ``_build/`` (listed in
``.gitignore``), one ``nvcc`` process per source, all started together;
:func:`load` opens a library with ``ctypes``, building it first if it is
missing.  A library's file name carries a hash of its source, the
headers under ``csrc/`` and its flags, so an edited source never loads a
stale build.

Every wrapper launches through :func:`launch` with a :class:`LaunchPlan`
it computed in Python from shapes, strides, storage offsets and dtypes:
the grid, the block, the dynamic shared memory, and one :class:`Operand`
per argument of the C launcher.  The C launchers take the plan as it is
(``csrc/plan.cuh``), so the static lint
(:mod:`repro_torch.analysis.launch_checks`) holds on the CPU exactly what
the card launches, against :data:`HOPPER`.

Nothing here runs when the module is imported: the CPU tests import
every module of the port on a machine with neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "nvcc_flags", "build", "load",
           "check", "resolve_device", "divide", "forward_only", "cdiv",
           "Operand", "LaunchPlan", "ptr", "value", "host_value", "check_operands", "launch",
           "Limits", "HOPPER", "DEVICE_LIMITS", "device_limits", "kernel_names",
           "func_attrs"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# kernel library name -> source file under csrc/
SOURCES = {"era_fused": "era_fused.cu", "qdq": "qdq.cu",
           "fused_round": "fused_round.cu", "flash_attn": "flash_attn.cu",
           "era_rows": "era_rows.cu", "distill": "distill.cu",
           "fixtures": "fixtures.cu", "threefry": "threefry.cu"}

# -fmad=false: no fused multiply-add contraction, so each product and sum
# rounds as in the reference; no --use_fast_math, so logf/expf and
# division are the precise versions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# Sources built with nvcc's default contraction (-fmad=true) instead.
# Attention's scores and outputs are sums of d and Sk products with no
# bit-for-bit contract with the reference (its tolerance is stated with
# the tests), and a fused multiply-add rounds once where a multiply and
# an add round twice, with half the instructions.
FMAD_SOURCES = ("flash_attn",)

_LIBS: Dict[str, ctypes.CDLL] = {}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of
    every entry point) raises when no CUDA device is present: the port
    never falls back to the CPU on its own; pass ``device="cpu"`` to run
    the plain PyTorch versions there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' to run the port's plain PyTorch path")
    return dev


def divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE division on every device.  PyTorch's CUDA
    kernels compute ``tensor / python_number`` as a multiply by the
    reciprocal, which can differ by an ulp from the division that the
    reference and the CUDA kernels perform; a divisor on ``x``'s device
    (a fill, no host-to-device copy) keeps the division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def forward_only(what: str, *inputs,
                 hint: str = "use impl='torch' for a differentiable result") -> None:
    """Raise if autograd would need a gradient through kernel ``what``.
    The kernel has no backward, as the reference's Pallas kernel has none
    (``jax.grad`` through it fails); a result silently detached from the
    graph would give wrong gradients instead.  ``hint`` names the
    differentiable way in the message."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{what}: the kernel has no backward; call it under torch.no_grad() or {hint}")


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc`` or ``nvcc`` on
    ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def nvcc_flags(name: str) -> tuple:
    """The ``nvcc`` flags of kernel library ``name``."""
    if name in FMAD_SOURCES:
        return tuple("-fmad=true" if f == "-fmad=false" else f for f in NVCC_FLAGS)
    return NVCC_FLAGS


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernel libraries (default: all) that are not
    built yet, in parallel.  Returns ``{name: compiler output}`` for the
    ones compiled now (``ptxas`` register and spill report included);
    raises with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    procs = {}
    for n in todo:
        tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [cc, *nvcc_flags(n), "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        logs[n] = out
        if p.returncode != 0:
            failed.append(n)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(n))  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ``ctypes`` handle of kernel library ``name``, built on first
    use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function
    (a refused launch never runs and ``synchronize`` would not report
    it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def cdiv(a: int, b: int) -> int:
    """``ceil(a / b)`` for non-negative ints."""
    return -(-a // b)


# ---------------------------------------------------------------------------
# Launch plans
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Operand:
    """One argument of a C launcher, as the lint sees it.

    ``kind="ptr"``: a device pointer to a tensor's data (``dtype``,
    ``shape``, element ``strides`` and ``storage_offset`` of the tensor;
    ``vector_bytes``, the widest access the kernel makes at once, which
    the start and every outer stride must be a multiple of), or a null
    pointer (``source="null"``, no shape).  ``kind="value"``: a number or
    host array passed by value (``dtype`` its C type); ``source`` says
    where it came from: ``"python"``, ``"cpu tensor"``, or ``"cuda
    tensor"`` when it was read from the card to the host before the
    launch (a host sync)."""

    name: str
    kind: str
    dtype: Optional[str] = None
    shape: Optional[Tuple[int, ...]] = None
    strides: Optional[Tuple[int, ...]] = None
    storage_offset: int = 0
    vector_bytes: int = 0
    source: str = "python"
    itemsize: int = 0


@dataclass(frozen=True)
class LaunchPlan:
    """A kernel launch, computed in Python: ``kernel`` names the compiled
    function (as its library's kernel table does), ``grid`` and ``block``
    are 3-tuples, ``dyn_smem`` the dynamic shared memory in bytes, raised
    past the 48 KB default first when ``smem_optin``; ``operands`` the C
    launcher's arguments after the plan, in order; ``cluster`` the blocks
    of a thread-block cluster along each axis ((1, 1, 1): none), each
    cluster's blocks scheduled together and reading each other's shared
    memory."""

    kernel: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    dyn_smem: int = 0
    smem_optin: bool = False
    operands: Tuple[Operand, ...] = ()
    cluster: Tuple[int, int, int] = (1, 1, 1)

    @property
    def threads(self) -> int:
        return self.block[0] * self.block[1] * self.block[2]


def ptr(name: str, t: Optional[torch.Tensor], vector_bytes: Optional[int] = None) -> Operand:
    """The operand of a device pointer to ``t``'s data (``None``: a null
    pointer).  ``vector_bytes`` defaults to one element.  Alignment is
    taken from ``t.storage_offset()``, never from ``data_ptr()``: a trace
    has no data, and a storage from PyTorch's caching allocator starts on
    a boundary of at least 256 bytes, wider than any access here."""
    if t is None:
        return Operand(name, "ptr", source="null")
    return Operand(name, "ptr", dtype=str(t.dtype).replace("torch.", ""),
                   shape=tuple(t.shape), strides=tuple(t.stride()),
                   storage_offset=int(t.storage_offset()),
                   vector_bytes=vector_bytes or t.element_size(),
                   source=f"{t.device.type} tensor", itemsize=t.element_size())


def value(name: str, ctype: type, source: str = "python") -> Operand:
    """The operand of a number (or host array) passed by value, of
    ``ctypes`` type ``ctype``."""
    return Operand(name, "value", dtype=ctype.__name__, source=source)


def host_value(x) -> Tuple[float, str]:
    """(float value, source) of a scalar a kernel takes by value.  A tensor
    is read to the host here, and the source names its device: read from
    the card, that is a host sync before the launch, which the lint
    reports as an error."""
    if isinstance(x, torch.Tensor):
        return float(x), f"{x.device.type} tensor"
    return float(x), "python"


class _CPlan(ctypes.Structure):
    """``plan::Plan`` of ``csrc/plan.cuh``, field for field."""

    _fields_ = [("grid", ctypes.c_longlong * 3), ("block", ctypes.c_longlong * 3),
                ("smem", ctypes.c_longlong), ("smem_optin", ctypes.c_longlong),
                ("cluster", ctypes.c_longlong * 3)]


def _c_plan(plan: LaunchPlan) -> _CPlan:
    return _CPlan((ctypes.c_longlong * 3)(*plan.grid), (ctypes.c_longlong * 3)(*plan.block),
                  plan.dyn_smem, int(plan.smem_optin), (ctypes.c_longlong * 3)(*plan.cluster))


def check_operands(fn: str, plan: LaunchPlan, args) -> torch.device:
    """Raise unless ``args`` match ``plan.operands`` one for one (a tensor
    or ``None`` for a ``ptr``, a ``ctypes`` number or array for a
    ``value``); the device of the first tensor.  Reads no data."""
    if len(args) != len(plan.operands):
        raise ValueError(f"{fn}: {len(args)} arguments for {len(plan.operands)} operands")
    device = None
    for op, a in zip(plan.operands, args):
        if op.kind == "ptr":
            if a is not None and not isinstance(a, torch.Tensor):
                raise TypeError(f"{fn}: operand {op.name} takes a tensor, got {type(a)}")
            if a is not None and device is None:
                device = a.device
        elif not isinstance(a, (ctypes.Array, ctypes._SimpleCData)):
            raise TypeError(f"{fn}: operand {op.name} takes a ctypes value, got {type(a)}")
    if device is None or device.type != "cuda":
        raise ValueError(f"{fn}: no tensor argument on a CUDA device")
    return device


def launch(lib: str, fn: str, plan: LaunchPlan, *args) -> None:
    """Launch ``fn`` of kernel library ``lib`` with ``plan``, on PyTorch's
    current stream of the card the tensor arguments lie on.  ``args`` are
    the launcher's arguments after the plan, one per operand of the plan
    (:func:`check_operands`).  Every wrapper launches through here, and
    nothing else passes a grid, a block or shared memory to the card.
    Raises if the launch was refused."""
    device = check_operands(fn, plan, args)
    cargs, argtypes = [], [ctypes.POINTER(_CPlan)]
    for op, a in zip(plan.operands, args):
        if op.kind == "ptr":
            cargs.append(ctypes.c_void_p(None if a is None else a.data_ptr()))
            argtypes.append(ctypes.c_void_p)
        else:
            cargs.append(a)
            argtypes.append(ctypes.POINTER(a._type_) if isinstance(a, ctypes.Array) else type(a))
    f = getattr(load(lib), fn)
    f.argtypes = argtypes + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    c_plan = _c_plan(plan)
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        err = f(ctypes.byref(c_plan), *cargs, stream)
    check(err, f"{lib} ({plan.kernel})")


# ---------------------------------------------------------------------------
# The card's limits and the compiled kernels' attributes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Limits:
    """Per-block and per-multiprocessor limits of a CUDA card."""

    max_threads_per_block: int
    max_block: Tuple[int, int, int]
    max_grid: Tuple[int, int, int]
    smem_per_block: int          # dynamic shared memory without opting in
    smem_per_block_optin: int    # ... with cudaFuncAttributeMaxDynamicSharedMemorySize
    smem_per_sm: int
    regs_per_block: int
    regs_per_sm: int
    max_regs_per_thread: int
    warp_size: int
    max_cluster_blocks: int = 8  # blocks a thread-block cluster (no device attribute)


# sm_90 (H100), from the CUDA C++ Programming Guide's table of technical
# specifications per compute capability, column 9.0: 1024 threads a block;
# block dimensions (1024, 1024, 64); grid x up to 2^31 - 1 and y, z up to
# 65535; 48 KB of shared memory a block without opting in and 227 KB
# (232448 bytes) with it; 228 KB a multiprocessor; 64K 32-bit registers a
# block and a multiprocessor; 255 registers a thread.  Its section on
# thread-block clusters: 8 blocks a cluster is the portable maximum.
HOPPER = Limits(max_threads_per_block=1024, max_block=(1024, 1024, 64),
                max_grid=(2 ** 31 - 1, 65535, 65535), smem_per_block=48 * 1024,
                smem_per_block_optin=232448, smem_per_sm=228 * 1024,
                regs_per_block=65536, regs_per_sm=65536, max_regs_per_thread=255,
                warp_size=32, max_cluster_blocks=8)

# The order in which fixtures_device_limits (csrc/fixtures.cu) writes the
# card's cudaDeviceGetAttribute values.
DEVICE_LIMITS = ("max_threads_per_block", "max_block_x", "max_block_y", "max_block_z",
                 "max_grid_x", "max_grid_y", "max_grid_z", "smem_per_block",
                 "smem_per_block_optin", "smem_per_sm", "regs_per_block", "regs_per_sm",
                 "warp_size")


def device_limits(device: int = 0) -> Limits:
    """The card's own :class:`Limits`, read with ``cudaDeviceGetAttribute``
    (the registers a thread may use are no device attribute: that field
    is :data:`HOPPER`'s)."""
    fn = load("fixtures").fixtures_device_limits
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(DEVICE_LIMITS))()
    check(fn(device, out), "cudaDeviceGetAttribute")
    v = dict(zip(DEVICE_LIMITS, out))
    return Limits(max_threads_per_block=v["max_threads_per_block"],
                  max_block=(v["max_block_x"], v["max_block_y"], v["max_block_z"]),
                  max_grid=(v["max_grid_x"], v["max_grid_y"], v["max_grid_z"]),
                  smem_per_block=v["smem_per_block"],
                  smem_per_block_optin=v["smem_per_block_optin"],
                  smem_per_sm=v["smem_per_sm"], regs_per_block=v["regs_per_block"],
                  regs_per_sm=v["regs_per_sm"],
                  max_regs_per_thread=HOPPER.max_regs_per_thread,
                  warp_size=v["warp_size"])


def kernel_names(lib: str) -> Tuple[str, ...]:
    """The kernels library ``lib`` exports attributes of, by the names
    launch plans give them."""
    h = load(lib)
    count = getattr(h, f"{lib}_kernel_count")
    count.restype = ctypes.c_int
    name = getattr(h, f"{lib}_kernel_name")
    name.argtypes = [ctypes.c_int]
    name.restype = ctypes.c_char_p
    return tuple(name(i).decode() for i in range(count()))


def func_attrs(lib: str, which: str) -> Dict[str, int]:
    """``cudaFuncAttributes`` of kernel ``which`` of library ``lib``:
    ``numRegs``, ``localSizeBytes`` (spills and stack), ``sharedSizeBytes``
    (static shared memory) and ``maxThreadsPerBlock``."""
    names = kernel_names(lib)
    if which not in names:
        raise KeyError(f"library {lib!r} has no kernel {which!r} (it has {names})")
    fn = getattr(load(lib), f"{lib}_func_attrs")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 4)()
    check(fn(names.index(which), out), f"cudaFuncGetAttributes({which})")
    return dict(zip(("numRegs", "localSizeBytes", "sharedSizeBytes", "maxThreadsPerBlock"),
                    out))
