"""Deliberately broken components for the analyzer's selftest
(counterpart of ``repro.analysis.fixtures``, as far as the ported passes
reach).

Never registered anywhere: they exist so ``python -m repro_torch.analysis
--selftest`` (and ``tests/test_torch_analysis.py``) can prove each pass
fires; a silent analyzer that flags nothing is indistinguishable from a
working one on a healthy repo.  One fixture per bug class:

- :class:`CallbackSmugglerStrategy`: claims ``scan_safe`` while its
  ``aggregate_masked`` leaves the card (``.cpu()``, then ``.numpy()``);
- :class:`HostRNGStrategy`: claims ``scan_safe`` while constructing a
  host numpy Generator in ``transmit`` (the draw becomes a constant; only
  the constructor spy sees it);
- :class:`StaleFlagStrategy`: plain tensor code that declares
  ``scan_safe=False`` (the stale-conservative-flag warning);
- :class:`FalseFusedStrategy`: advertises ``supports_fused_round``
  without the fused hooks;
- :func:`broken_kernel_cases`: the three fixture kernels of
  ``repro_torch.kernels.fixture_kernel`` on their broken plans (a float4
  copy of a misaligned view, a scalar read to the host and passed by
  value, a 32 MiB shared-memory tile), and :func:`valid_kernel_cases`, the
  same kernels on their valid plans;
- :func:`telemetry_callback_engine`: a telemetry-on device engine whose
  ``telemetry_hook`` reads the card on the host;
- :func:`leaky_active_engine`: an active-set engine whose O(m) client
  step reads the O(K) ``last_sync`` mirror;
- :func:`async_staleness_callback_engine`: an async engine whose
  ``staleness_weight`` computes the right weights on the host;
- :func:`broken_carry_fn`: a replicated carry update keyed on a
  shard-local slice, and :func:`fixed_carry_fn`, its twin that sums over
  the data axis first.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.fl.strategies.base import Strategy
from repro_torch.kernels import fixture_kernel

__all__ = ["CallbackSmugglerStrategy", "HostRNGStrategy", "StaleFlagStrategy",
           "FalseFusedStrategy", "BROKEN_STRATEGIES", "EXPECTED_STRATEGY_LEVEL",
           "broken_kernel_cases", "valid_kernel_cases", "analysis_cases",
           "telemetry_callback_engine", "leaky_active_engine",
           "async_staleness_callback_engine", "broken_carry_fn", "fixed_carry_fn"]


class CallbackSmugglerStrategy(Strategy):
    name = "fixture_callback_smuggler"
    scan_safe = True  # LIE: aggregate_masked leaves the card

    def aggregate(self, z, um, t):
        return torch.mean(z, dim=0), None

    def aggregate_masked(self, z, part, um, t):
        mean = z.cpu().numpy().mean(axis=0)
        return torch.from_numpy(mean).to(z.device)


class HostRNGStrategy(Strategy):
    name = "fixture_host_rng"
    scan_safe = True  # LIE: transmit draws from host numpy RNG

    def transmit(self, z, key=None):
        # the draw is a host float, so the TRACE SUCCEEDS and the tensors
        # look pure: the one draw is baked in and every round reuses it
        noise = np.random.default_rng(0).normal(0.0, 1e-3, (1,))
        return z + float(noise[0])

    def aggregate(self, z, um, t):
        return torch.mean(z, dim=0), None


class StaleFlagStrategy(Strategy):
    name = "fixture_stale_flag"
    scan_safe = False  # stale: everything below is plain tensor code

    def aggregate(self, z, um, t):
        return torch.mean(z, dim=0), None


class FalseFusedStrategy(Strategy):
    name = "fixture_false_fused"
    scan_safe = True
    supports_fused_round = True  # LIE: the fused hooks are not implemented

    def aggregate(self, z, um, t):
        return torch.mean(z, dim=0), None


BROKEN_STRATEGIES = {
    "fixture_callback_smuggler": CallbackSmugglerStrategy,
    "fixture_host_rng": HostRNGStrategy,
    "fixture_stale_flag": StaleFlagStrategy,
    "fixture_false_fused": FalseFusedStrategy,
}

# level the contract pass must emit for each broken strategy
EXPECTED_STRATEGY_LEVEL = {
    "fixture_callback_smuggler": "error",
    "fixture_host_rng": "error",
    "fixture_stale_flag": "warn",
    "fixture_false_fused": "error",
}


# ---------------------------------------------------------------------------
# Kernel fixtures
# ---------------------------------------------------------------------------

_F32 = torch.float32
# (100, 128) float32 as the reference's _misaligned copies it, here one
# float past the start of a (12801,) storage: 4 bytes off the float4's 16
_MISALIGNED_STORAGE = (100 * 128 + 1,)


def _misaligned_copy(storage):
    return fixture_kernel.copy_vec4(storage.narrow(0, 1, 100 * 128).view(100, 128))


def broken_kernel_cases():
    """(label, fn, args, expected level) for the launch-plan lint, ``args``
    as (shape, dtype) pairs made on the fake card."""
    return [
        ("fixture/misaligned-vec4", _misaligned_copy, ((_MISALIGNED_STORAGE, _F32),), "error"),
        ("fixture/scalar-by-value", lambda x, s: fixture_kernel.scale(x, s, sync=True),
         (((16, 128), _F32), ((1,), _F32)), "error"),
        ("fixture/smem-hog", lambda x: fixture_kernel.copy_smem(x, fixture_kernel.HOG_TILE),
         (((4096, 1024), _F32),), "error"),
    ]


def valid_kernel_cases():
    """(label, fn, args) of the same kernels on their valid plans: the
    lint must call each clean."""
    return [
        ("fixture/aligned-vec4", fixture_kernel.copy_vec4, (((100, 128), _F32),)),
        ("fixture/scalar-by-pointer", fixture_kernel.scale, (((16, 128), _F32), ((1,), _F32))),
        ("fixture/smem-tiles", fixture_kernel.copy_smem, (((4096, 1024), _F32),)),
    ]


def analysis_cases():
    """The broken cases without the expectation, matching the
    kernel-module protocol so this file can be linted like a module."""
    return [(label, fn, args) for label, fn, args, _ in broken_kernel_cases()]


# ---------------------------------------------------------------------------
# Telemetry fixture
# ---------------------------------------------------------------------------

def telemetry_callback_engine():
    """A telemetry-on device engine (on the CPU) whose hook leaves the card.

    The hook looks innocent — it returns the row unchanged — but its
    ``.item()`` reads a device value on the host inside every round.
    ``repro_torch.analysis.obs_checks.check_round_body`` must flag it as an
    error (on the card, the engine's sync guard raises there).
    """
    from repro_torch.analysis.obs_checks import build_engine

    eng = build_engine("mean", {}, {}, "identity", telemetry=True)

    def leaky_hook(tel, t):
        tel.cache_hits.item()
        return tel

    eng.telemetry_hook = leaky_hook
    return eng


# ---------------------------------------------------------------------------
# Active-set fixture
# ---------------------------------------------------------------------------

def leaky_active_engine():
    """An active-set engine (on the CPU) whose O(m) client step touches
    O(K) state.

    The leak is numerically invisible (``0.0 * sum(last_sync)``), so every
    conformance cell still passes bit for bit, but the client step now
    reads a ``(K,)`` tensor and its device cost grows with the population
    again.  ``repro_torch.analysis.active_checks.check_engine`` must flag it
    as an error for its K-sized shape.
    """
    from repro_torch.analysis.active_checks import analysis_config
    from repro_torch.fl.active_engine import ActiveSetFederatedDistillation
    from repro_torch.fl.scenarios import Scenario, bernoulli_participation
    from repro_torch.fl.strategies import STRATEGIES

    class LeakyActiveEngine(ActiveSetFederatedDistillation):
        def _client_step(self, args):
            out = super()._client_step(args)
            out["uplink"] = out["uplink"] + 0.0 * self._get_last_sync_dev().to(
                torch.float32).sum()
            return out

    return LeakyActiveEngine(
        analysis_config(), STRATEGIES["scarlet"](), cache_duration=2,
        scenario=Scenario(participation=bernoulli_participation(0.3)), device="cpu")


# ---------------------------------------------------------------------------
# Async fixture
# ---------------------------------------------------------------------------

def async_staleness_callback_engine():
    """An async engine (on the CPU, decay 0.5) whose staleness hook leaves
    the card.

    The weights are the default policy's, ``0.5 ** s`` in float32 (exact
    powers of two), computed in numpy on a host copy of the staleness:
    every run still passes, but each round copies to the host and waits
    for the card.  ``repro_torch.analysis.async_checks.check_engine`` must
    flag it as an error.
    """
    from repro_torch.analysis.async_checks import build_engine

    eng = build_engine("scarlet", {"staleness_decay": 0.5}, {"cache_duration": 2},
                       "identity")

    def host_weight(staleness):
        s = staleness.cpu().numpy().astype(np.float32)
        return torch.from_numpy(np.float32(0.5) ** s).to(staleness.device)

    eng.strategy.staleness_weight = host_weight
    return eng


# ---------------------------------------------------------------------------
# Replication fixtures
# ---------------------------------------------------------------------------

def broken_carry_fn():
    """The reference's old ``last_sync`` bug, distilled: a carry update
    ``(last_sync, t, six, group) -> last_sync`` for state declared
    replicated, keyed on a shard-local participation slice (``six`` is the
    rank's data coordinate), so the ranks disagree after one round.
    ``repro_torch.analysis.replication_checks`` must flag it."""

    def body(last_sync, t, six, group):
        kloc = last_sync.shape[0]
        part_local = (torch.arange(kloc) + t + six) % 2 > 0  # shard-varying
        return torch.where(part_local, t, last_sync)

    return body


def fixed_carry_fn():
    """The repaired twin: the shard-varying signal is summed over the data
    axis before it touches the replicated carry."""
    from repro_torch.launch.mesh import all_reduce_sum

    def body(last_sync, t, six, group):
        kloc = last_sync.shape[0]
        part_local = (torch.arange(kloc) + t + six) % 2 > 0
        # reduce to a replicated global view before the carry update
        part_global = all_reduce_sum(part_local.to(torch.int32), group) > 0
        return torch.where(part_global, t, last_sync)

    return body
