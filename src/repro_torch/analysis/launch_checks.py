"""Static lint of the kernels' launch plans against the card's limits
(counterpart of ``repro.analysis.pallas_checks``).

Each kernel module exports ``analysis_cases()``: (label, fn, args) at the
reference's shapes and at the full-width shapes the main path launches,
and, as a fourth element, an exception the wrapper must raise where the
case is one it refuses.  Each case is traced on fake CUDA tensors
(:func:`repro_torch.analysis.traceutil.trace`), so nothing executes, and
each :class:`~repro_torch.kernels.runtime.LaunchPlan` it records (and
each plan the contract pass recorded) is held against
:data:`~repro_torch.kernels.runtime.HOPPER`:

- **block and grid** (error): more than 1024 threads a block, a block
  dimension past (1024, 1024, 64), a grid past (2^31 - 1, 65535, 65535);
  (warn) threads not a multiple of the 32-thread warp;
- **clusters** (error): a thread-block cluster of more than the portable 8
  blocks, a cluster dimension below 1, or a grid that is not whole
  clusters along each axis (the card refuses such a launch);
- **shared memory** (error): dynamic shared memory over 48 KB without
  opting in, or over 227 KB with it; (warn) over half a multiprocessor's
  228 KB, which leaves no room for a second resident block (the
  counterpart of the Pallas lint's VMEM warn threshold);
- **alignment** (error): a pointer operand whose start or outer stride is
  not a multiple of the widest access the kernel makes to it (a float4
  copy's 16 bytes, attention's bfloat16 pairs): the misaligned-block
  class; the card stops such a kernel (``cudaErrorMisalignedAddress``);
- **scalars** (error): a value operand read from the card to the host
  before the launch, a host sync each launch: the counterpart of a scalar
  in VMEM.  A scalar stays on the card and goes by pointer.

With the card (``attrs=runtime.func_attrs``), each plan is also held
against its compiled function's ``cudaFuncAttributes``: registers times threads
within a block's 65536, threads within ``maxThreadsPerBlock``, static
plus dynamic shared memory within the limit, and (warn) any local memory
(``localSizeBytes``: spills or a stack).
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.report import Finding
from repro_torch.analysis.traceutil import Launch, trace
from repro_torch.kernels import runtime
from repro_torch.kernels.runtime import HOPPER, LaunchPlan

__all__ = ["KERNEL_MODULES", "iter_cases", "check_plan", "check_case", "check_launches",
           "run"]

KERNEL_MODULES = (
    "repro_torch.kernels.era_kernel",
    "repro_torch.kernels.quant_kernel",
    "repro_torch.kernels.round_kernel",
    "repro_torch.kernels.distill_kernel",
    "repro_torch.kernels.attn_kernel",
    "repro_torch.kernels.prng_kernel",
)

AttrsFn = Callable[[str, str], Dict[str, int]]


def iter_cases(modules: Iterable[str] = KERNEL_MODULES):
    """(label, fn, args) of every case."""
    for modname in modules:
        yield from importlib.import_module(modname).analysis_cases()


def _alignment(op: runtime.Operand) -> Optional[str]:
    """Why the ``ptr`` operand ``op`` is misaligned for its accesses, or
    None."""
    if op.shape is None:  # a null pointer
        return None
    vb, isz = op.vector_bytes, op.itemsize
    if op.storage_offset * isz % vb:
        return (f"starts {op.storage_offset * isz} bytes into its storage, not a multiple "
                f"of its {vb}-byte accesses")
    live = [(n, st) for n, st in zip(op.shape, op.strides) if n > 1]
    if vb > isz and op.shape:
        if op.strides[-1] != 1 and op.shape[-1] > 1:
            return f"innermost stride {op.strides[-1]}: {vb}-byte accesses need it to be 1"
        if op.shape[-1] * isz % vb:
            return f"rows of {op.shape[-1] * isz} bytes are not whole {vb}-byte accesses"
        live = live[:-1] if op.shape[-1] > 1 else live
    for n, st in live:
        if st * isz % vb:
            return f"stride of {st * isz} bytes is not a multiple of its {vb}-byte accesses"
    return None


def check_plan(label: str, plan: LaunchPlan,
               attrs: Optional[Dict[str, int]] = None) -> List[Finding]:
    """Findings for one plan against :data:`HOPPER` (empty when it passes
    every check); ``attrs`` are the compiled kernel's
    ``cudaFuncAttributes`` where read."""
    limits = HOPPER
    out: List[Finding] = []

    def err(msg):
        out.append(Finding("error", "launch", label, f"{plan.kernel}: {msg}"))

    def warn(msg):
        out.append(Finding("warn", "launch", label, f"{plan.kernel}: {msg}"))

    threads = plan.threads
    if any(d < 1 for d in plan.grid + plan.block):
        err(f"grid {plan.grid} or block {plan.block} has a dimension below 1")
    if threads > limits.max_threads_per_block:
        err(f"{threads} threads a block, over the card's {limits.max_threads_per_block}")
    for axis, d, cap in zip("xyz", plan.block, limits.max_block):
        if d > cap:
            err(f"block {axis} = {d} over the card's {cap}")
    for axis, d, cap in zip("xyz", plan.grid, limits.max_grid):
        if d > cap:
            err(f"grid {axis} = {d} over the card's {cap}")
    if threads % limits.warp_size:
        warn(f"{threads} threads a block, not a multiple of the {limits.warp_size}-thread warp")
    blocks = plan.cluster[0] * plan.cluster[1] * plan.cluster[2]
    if any(c < 1 for c in plan.cluster):
        err(f"cluster {plan.cluster} has a dimension below 1")
    elif blocks > limits.max_cluster_blocks:
        err(f"cluster {plan.cluster} of {blocks} blocks, over the portable "
            f"{limits.max_cluster_blocks}")
    elif any(g % c for g, c in zip(plan.grid, plan.cluster)):
        err(f"grid {plan.grid} is not whole clusters of {plan.cluster}")

    static = attrs["sharedSizeBytes"] if attrs else 0
    smem = plan.dyn_smem + static
    cap = limits.smem_per_block_optin if plan.smem_optin else limits.smem_per_block
    if smem > cap:
        err(f"{smem} bytes of shared memory a block over the {cap} "
            f"{'with' if plan.smem_optin else 'without'} opting in")
    elif smem > limits.smem_per_sm // 2:
        warn(f"{smem} bytes of shared memory a block: over half a multiprocessor's "
             f"{limits.smem_per_sm}, no room for a second resident block")

    for op in plan.operands:
        if op.kind == "ptr":
            why = _alignment(op)
            if why:
                err(f"operand {op.name} {op.shape} {op.dtype}: {why} (misaligned; the card "
                    "stops the kernel with cudaErrorMisalignedAddress)")
        elif op.source == "cuda tensor":
            err(f"operand {op.name} passed by value was read from the card to the host "
                "before the launch (a host sync each launch): keep it on the card and pass "
                "a pointer")

    if attrs:
        regs = attrs["numRegs"] * threads
        if regs > limits.regs_per_block:
            err(f"{attrs['numRegs']} registers x {threads} threads = {regs}, over a block's "
                f"{limits.regs_per_block}")
        if threads > attrs["maxThreadsPerBlock"]:
            err(f"{threads} threads, over the compiled kernel's {attrs['maxThreadsPerBlock']}")
        if attrs["localSizeBytes"] > 0:
            warn(f"{attrs['localSizeBytes']} bytes of local memory a thread (spills or stack)")
    return out


def _summary(plan: LaunchPlan, attrs: Optional[Dict[str, int]]) -> str:
    s = (f"{plan.kernel} grid {plan.grid} block {plan.block} smem {plan.dyn_smem}"
         f"{' (opt-in)' if plan.smem_optin else ''}"
         f"{f' cluster {plan.cluster}' if plan.cluster != (1, 1, 1) else ''}")
    if attrs:
        s += (f"; {attrs['numRegs']} registers, {attrs['localSizeBytes']} B local, "
              f"{attrs['sharedSizeBytes']} B static shared")
    return s


def check_launches(launches: Iterable[Tuple[str, Launch]],
                   attrs: Optional[AttrsFn] = None) -> List[Finding]:
    """Findings for recorded (label, Launch) pairs: one ``ok`` for each
    plan that passes, the errors and warnings of each that does not."""
    findings: List[Finding] = []
    for label, launch in launches:
        a = attrs(launch.lib, launch.plan.kernel) if attrs else None
        got = check_plan(label, launch.plan, a)
        findings.extend(got or [Finding("ok", "launch", label,
                                        "plan within the card's limits: "
                                        + _summary(launch.plan, a))])
    return findings


def check_case(label: str, fn, args, attrs: Optional[AttrsFn] = None) -> List[Finding]:
    """Trace one case and lint every plan it records."""
    tr = trace(fn, *args)
    if not tr.ok:
        return [Finding("error", "launch", label,
                        f"case failed to trace: {type(tr.error).__name__}: {tr.error}")]
    if not tr.launches:
        return [Finding("warn", "launch", label, "no launch recorded — nothing to lint")]
    many = len(tr.launches) > 1
    return check_launches(((f"{label}#{i}" if many else label, launch)
                           for i, launch in enumerate(tr.launches)), attrs)


def run(modules: Iterable[str] = KERNEL_MODULES,
        attrs: Optional[AttrsFn] = None) -> List[Finding]:
    findings: List[Finding] = []
    for label, fn, args in iter_cases(modules):
        findings.extend(check_case(label, fn, args, attrs))
    return findings

