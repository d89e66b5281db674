"""Static contract analyzer for the port: prove declared invariants by
tracing, before anything runs (counterpart of ``repro.analysis``).

Two passes, one CLI (``python -m repro_torch.analysis``):

``contract_checks``
    runs every registered strategy hook and codec ``roundtrip`` on fake
    CUDA tensors (nothing executes) and diffs what they do against the
    declared flags (``scan_safe``, ``supports_fused_round``,
    ``codec_kernel_spec``): a host read, a device-to-host copy or a host
    RNG inside a hook the device engine calls in its rounds is an error.

``launch_checks``
    lints every kernel's launch plan (each kernel module's
    ``analysis_cases()``, and each launch the contract pass recorded)
    against the card's limits (``runtime.HOPPER``): block and grid sizes,
    shared memory, operand alignment, scalars read to the host; with a
    card, also against each compiled kernel's registers and spills.

The reference's telemetry, replication, active-set and async passes wait
for the engines they check.
"""
from __future__ import annotations

from repro_torch.analysis.report import Finding, Report

__all__ = ["Finding", "Report"]
