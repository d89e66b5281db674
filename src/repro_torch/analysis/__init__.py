"""Static contract analyzer for the port: prove declared invariants by
tracing, before anything runs (counterpart of ``repro.analysis``).

Six passes, one CLI (``python -m repro_torch.analysis``):

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

``active_checks``
    the active-set engine's O(m)/O(K) split: both round steps traced on
    fake CUDA tensors (no host sync), and each run once on the CPU at a
    prime K = 193 under a shape recorder: the gathered client step must
    hold no K-sized tensor, the bookkeeping step must hold one.

``async_checks``
    the async engine's flight bookkeeping and staleness hook, traced on
    fake CUDA tensors: no host sync, and the hook on the traced path.

``replication_checks``
    the client-sharded engine's replicated state: one real round on each
    rank of a gloo world of two under a taint-carrying dispatch mode
    (shard-local leaves tainted, all-reduces clearing), every replicated
    leaf untainted and equal on both ranks bit for bit.
"""
from __future__ import annotations

from repro_torch.analysis.report import Finding, Report

__all__ = ["Finding", "Report"]
