"""Static contract analyzer for the port: prove declared invariants by
tracing, before anything runs (counterpart of ``repro.analysis``).

Three passes, one CLI (``python -m repro_torch.analysis``):

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

``obs_checks``
    traces the device engine's telemetry round code (the row, the
    strategy's ``sharpen_gauge``, any ``telemetry_hook``) on fake CUDA
    tensors, and runs one round of a tiny engine with telemetry off and on
    from the same state: the two differ by the telemetry entry alone.

The reference's replication, active-set and async passes wait for the
engines they check.
"""
from __future__ import annotations

from repro_torch.analysis.report import Finding, Report

__all__ = ["Finding", "Report"]
