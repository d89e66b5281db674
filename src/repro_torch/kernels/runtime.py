"""Build, load and launch support for the port's hand-written CUDA kernels.

Every kernel lives in one ``csrc/<name>.cu`` file with a plain C launch
function.  :func:`build` compiles each source with ``nvcc`` for
``sm_90a`` into its own shared library under ``_build/`` (listed in
``.gitignore``), one ``nvcc`` process per source, all started together;
:func:`load` opens a library with ``ctypes``, building it first if it is
missing.  A library's file name carries a hash of its source and flags,
so an edited source never loads a stale build.

Nothing here runs when the module is imported: the CPU tests import
every module of the port on a machine with neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "nvcc_flags", "build", "load",
           "check", "resolve_device", "launch_args", "divide", "forward_only"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# kernel library name -> source file under csrc/
SOURCES = {"era_fused": "era_fused.cu", "qdq": "qdq.cu",
           "fused_round": "fused_round.cu", "flash_attn": "flash_attn.cu",
           "era_rows": "era_rows.cu", "distill": "distill.cu"}

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


def forward_only(what: str, *inputs) -> None:
    """Raise if autograd would need a gradient through kernel ``what``.
    The kernel has no backward, as the reference's Pallas kernel has none
    (``jax.grad`` through it fails); a result silently detached from the
    graph would give wrong gradients instead."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{what}: the kernel has no backward; call it under torch.no_grad() "
            "or use impl='torch' for a differentiable result")


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


def launch_args(t: torch.Tensor):
    """(device guard, current stream handle) for launching on ``t``'s
    card: kernels run on PyTorch's current stream of that device."""
    guard = torch.cuda.device(t.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
    return guard, stream
