"""Device-resident round engine (counterpart of ``repro.fl.scan_engine``,
``engine="scan"``).

The reference compiles the whole run into one ``lax.scan``.  PyTorch has
no scan, so here the run is a Python loop over rounds whose body has
fixed shapes and never waits for the card: every client trains, predicts
and is aggregated every round under a float participation vector, every
update is gated with ``torch.where`` instead of a Python branch on a
device value, the byte ledger is float32 arithmetic on the device
(:func:`repro_torch.core.comm.distillation_round_cost_device`), and the
per-round results stay on the device until :meth:`_finish_run` reads them
back once at the end of the leg.  On a CUDA device the rounds run under
``torch.cuda.set_sync_debug_mode("error")``, so an operation that would
make the host wait for the card raises instead.

Draws.  Before the loop, :meth:`run` makes the whole leg's ``(T, K)``
participation masks and ``(T, m)`` public subsets P^t on the device.
Under ``rng_backend="jax"`` (the default, as in the reference) they come
from the reference's key stream in one batch over the leg's T round keys
(:meth:`FederatedDistillation._round_keys`, ``_subsets`` and
``Scenario.participation_mask_device``: seven launches of the threefry
kernel a leg at |P| = 10^4 whatever T, two more a sort round of a
fraction draw), with the leg's transmit keys; under
``"numpy"`` the host draws them round by round from the numpy Generators
(``_draw_round``, as the host loop does) and uploads the stacks once.
Either way the device engine and the host loop of the same configuration
and backend see the same draws.  ``run(draws=(part, idx))`` takes the
stacks from the caller instead.  Under probabilistic expiry the leg's
``(T, m)`` expiry uniforms are drawn with them (two launches), or given
as ``run(expiry_uniforms=...)``.  Heterogeneous schedules run as on the
host loop: the per-client rates and step counts sit on the device from
construction, and the round's decay is a host float.

``FLConfig.fused_round`` replaces the uplink codec round trip and the
SCARLET aggregation with one :func:`repro_torch.kernels.ops.fused_round`
kernel a round.

Telemetry (``FLConfig.telemetry``): each round computes its
:class:`repro_torch.obs.device.RoundTelemetry` row on the device, gated
to zeros on a total outage, and keeps it with the round's results; the
running totals ride in the state.  The rows come back inside the leg's
one read-back.  Neither is part of ``state_dict``.  The fused path never
materialises the server's decoded view, so with a lossy uplink codec
telemetry round-trips the transmitted stack itself (one more qdq launch
a round under ``cache_delta+quantB``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import cache as cache_lib
from repro_torch.core import comm as comm_lib
from repro_torch.core import prng
from repro_torch.fl.rounds import FederatedDistillation, History, _select_cohorts, distill
from repro_torch.fl.strategies.base import TRANSMIT_SALT
from repro_torch.kernels import round_kernel
from repro_torch.models.resnet import Params
from repro_torch.obs import device as obs_device

__all__ = ["ScannedFederatedDistillation"]


@dataclass
class _Leg:
    """One ``run()``: its rounds, the draws on the device, the engine
    state the rounds thread through, and their results (device tensors)."""

    t0: int
    ts: List[int]
    part: torch.Tensor          # (T, K) bool
    idx: torch.Tensor           # (T, m) int64
    u: Optional[torch.Tensor]   # (T, m) float32 expiry uniforms, or None
    do_eval: List[bool]
    state: Dict[str, Any]
    tkeys: Optional[torch.Tensor] = None  # (T, 2) transmit keys (jax stream)
    outputs: List[Dict[str, torch.Tensor]] = field(default_factory=list)

    def round_kw(self, i: int) -> Dict[str, torch.Tensor]:
        """Round ``i``'s expiry uniforms and transmit key, where the leg has
        them, as keywords of ``_round_device``."""
        kw = {} if self.u is None else {"u": self.u[i]}
        if self.tkeys is not None:
            kw["tkey"] = self.tkeys[i]
        return kw


class ScannedFederatedDistillation(FederatedDistillation):
    """Device-resident twin of :class:`FederatedDistillation`: the same
    constructor, with ``rng_backend="jax"`` the default (the reference's
    device engines require it; the port's take ``"numpy"`` too), and
    ``run()`` returns the same :class:`History`, with one ledger entry per
    round (total outages included, at zero) and eval rows on the
    ``eval_every`` schedule."""

    def __init__(self, cfg, strategy, cache_duration: int = 0,
                 use_cache: Optional[bool] = None,
                 probabilistic_expiry: bool = False, scenario=None,
                 track_local_caches: bool = False,
                 rng_backend: str = "jax", device="cuda"):
        if track_local_caches:
            raise ValueError(
                "track_local_caches builds dynamically-sized catch-up "
                "packages; use the host-loop engine for that mode")
        super().__init__(cfg, strategy, cache_duration=cache_duration,
                         use_cache=use_cache,
                         probabilistic_expiry=probabilistic_expiry,
                         scenario=scenario, rng_backend=rng_backend,
                         device=device)
        if not self.strategy.scan_safe:
            raise ValueError(
                f"strategy {self.strategy.name!r} is not scan-safe "
                "(host-side state or dynamic shapes); use the host loop")
        for codec in (self.codec_up, self.codec_down):
            if not codec.scan_safe:
                raise ValueError(f"codec {codec.name!r} is not scan-safe; "
                                 "use the host loop")
        # the fused round path, validated here so a bad combination fails
        # at construction and not inside a run
        self._fused_spec = None
        if self.cfg.fused_round:
            if not self.strategy.supports_fused_round:
                raise ValueError(
                    f"fused_round: strategy {self.strategy.name!r} has no "
                    "fused round path (adaptive beta needs the per-op chain)")
            self._fused_spec = round_kernel.codec_kernel_spec(self.codec_up)
            if self._fused_spec is None:
                raise ValueError(
                    f"fused_round: uplink codec {self.codec_up.name!r} has "
                    "no kernel form (supported: identity, quantB, "
                    "cache_delta[+quantB])")

    # ------------------------------------------------------------------
    def run(self, rounds: Optional[int] = None, *,
            draws: Optional[Tuple[np.ndarray, np.ndarray]] = None,
            expiry_uniforms: Optional[np.ndarray] = None) -> History:
        """Run ``rounds`` more rounds (default: the configured count),
        numbered on from ``t_done``; returns a fresh :class:`History` for
        this leg.  ``draws=(part, idx)`` gives the leg's ``(T, K)`` bool
        participation masks and ``(T, m)`` P^t indices in place of the
        engine's own (its numpy Generators are then not advanced; the jax
        stream's transmit keys are still the rounds' own);
        ``expiry_uniforms`` the leg's ``(T, m)`` float32 expiry uniforms
        (probabilistic expiry), as on the host loop."""
        leg = self._start_leg(rounds, draws, expiry_uniforms)
        self._run_rounds(leg)
        return self._finish_run(leg)

    def _start_leg(self, rounds: Optional[int], draws, expiry_uniforms=None) -> _Leg:
        """Draw (or check) the leg's draws on the host and upload them,
        with the initial state, before any round runs."""
        c = self.cfg
        T = c.rounds if rounds is None else rounds
        t0 = self.t_done
        ts = list(range(t0 + 1, t0 + T + 1))
        part, idx, tkeys = self._leg_draws(T, draws)
        u = self._leg_uniforms(T, expiry_uniforms)
        state = self._leg_state()
        del state["t_done"]
        state["prev_idx"] = state["prev_idx"].to(torch.int64)
        if self._telemetry:  # the leg's running totals
            state["telemetry"] = obs_device.zeros(self.models.n_cohorts, self.device)
        return _Leg(t0=t0, ts=ts, part=part, idx=idx, u=u,
                    do_eval=[t % c.eval_every == 0 or t == t0 + T for t in ts],
                    state=state, tkeys=tkeys)

    def _leg_state(self) -> Dict[str, Any]:
        """The state a leg's rounds start from: :meth:`state_dict` (the
        sharded engine's keeps its shard's clients, where its
        ``state_dict`` gathers every client)."""
        return self.state_dict()

    def _leg_draws(self, T: int, draws):
        """The leg's ``(T, K)`` bool participation masks, ``(T, m)`` int64
        P^t indices and ``(T, 2)`` transmit keys (None under numpy), on the
        device: from the jax stream in one batch, drawn round by round from
        the numpy Generators, or ``draws`` (:meth:`_checked_draws`)."""
        c = self.cfg
        t0 = self.t_done
        K, m = c.n_clients, c.public_per_round
        tkeys = kt = None
        if self.rng_backend == "jax":
            kt = self._round_keys(t0, T, self.device)
            tkeys = prng.fold_in(kt, TRANSMIT_SALT)
        if draws is None and kt is not None:
            idx, k_part = self._subsets(kt)
            offline = self._tensor(self.scenario.offline_masks(T, K, start=t0 + 1))
            return self.scenario.participation_mask_device(k_part, offline), idx, tkeys
        if draws is None:
            rounds = [self._draw_round(t) for t in range(t0 + 1, t0 + T + 1)]
            part = np.array([r[0] for r in rounds], bool).reshape(T, K)
            idx = np.array([r[1] for r in rounds], np.int64).reshape(T, m)
            return self._tensor(part), self._tensor(idx), tkeys
        part, idx = self._checked_draws(T, draws)
        return self._tensor(part), self._tensor(idx, torch.int64), tkeys

    def _checked_draws(self, T: int, draws):
        """The caller's ``draws`` of the next ``T`` rounds as host arrays,
        ``(T, K)`` bool and ``(T, m)``, checked: no offline client takes
        part; each P^t holds distinct public indices."""
        c = self.cfg
        K, m = c.n_clients, c.public_per_round
        part, idx = np.asarray(draws[0]).astype(bool), np.asarray(draws[1])
        if part.shape != (T, K) or idx.shape != (T, m):
            raise ValueError(f"draws must be ({T}, {K}) and ({T}, {m}), "
                             f"got {part.shape} and {idx.shape}")
        if (part & self.scenario.offline_masks(T, K, start=self.t_done + 1)).any():
            raise ValueError("draws let an offline client participate")
        srt = np.sort(idx, axis=1)
        if T and (srt[:, 0].min() < 0 or srt[:, -1].max() >= c.public_size
                  or (np.diff(srt, axis=1) <= 0).any()):
            raise ValueError("each round's P^t must hold distinct public "
                             f"indices in [0, {c.public_size})")
        return part, idx

    @contextlib.contextmanager
    def _sync_guard(self):
        """On a CUDA device, ``torch.cuda.set_sync_debug_mode("error")``
        for the block, the previous mode restored after: any host sync
        inside raises."""
        prev = torch.cuda.get_sync_debug_mode() if self.device.type == "cuda" else None
        if prev is not None:
            torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            if prev is not None:
                torch.cuda.set_sync_debug_mode(prev)

    def _run_rounds(self, leg: _Leg) -> None:
        """The leg's rounds, on the device; on a CUDA device any host sync
        inside them raises."""
        with self._sync_guard():
            st = leg.state
            for i, t in enumerate(leg.ts):
                st, out = self._round_device(st, t, leg.part[i], leg.idx[i],
                                             leg.do_eval[i], **leg.round_kw(i))
                leg.outputs.append(out)
            leg.state = st

    # ------------------------------------------------------------------
    def _round_device(self, st: Dict[str, Any], t: int, part: torch.Tensor,
                      idx: torch.Tensor, do_eval: bool,
                      u: Optional[torch.Tensor] = None,
                      tkey: Optional[torch.Tensor] = None):
        """One round on the device (reference ``_round_device``): the
        state in, the state out and this round's results.  ``t`` and
        ``do_eval`` are host values; ``u`` is the round's row of expiry
        uniforms (probabilistic expiry), ``tkey`` its transmit key (jax
        stream); nothing here reads the device."""
        part_f = part.to(torch.float32)
        any_p = part_f.sum() > 0

        def gate(new, old):
            """Keep ``old`` wholesale on a total-outage round."""
            return torch.where(any_p, new, old)

        # --- clients: distill on the previous teacher, then train ---------
        cp = st["client_params"]
        upd = self._distill_all(cp, self.x_pub[st["prev_idx"]],
                                st["prev_teacher"])
        cp = _select_cohorts(upd, cp, self.models.split(part & st["have_prev"]))
        cp = _select_cohorts(self._local_train_all(cp, t), cp,
                             self.models.split(part))

        # --- the server's side, then the outage gate ----------------------
        catch_up = 0.0
        if self.use_cache:
            catch_up = cache_lib.catch_up_bytes_device(
                st["cache"], st["last_sync"], part, t)
        r = self._server_round(cp, part_f, idx, t, x_pub=self.x_pub,
                               cache_prev=st["cache"],
                               server_params=st["server_params"], u=u, tkey=tkey)
        uplink, downlink = self._round_bytes(r, part_f, catch_up)
        cache = st["cache"]
        if self.use_cache:
            cache = cache_lib.CacheState(
                *(gate(a, b) for a, b in zip(r["cache"], st["cache"])))
        server_params = {k: gate(v, st["server_params"][k])
                         for k, v in r["server_params"].items()}
        # App.-D proxy teacher
        zv = self._predict_all(cp, self.x_pub[self.pub_val_idx])
        teacher_val = gate(zv.mean(0), st["teacher_val"])
        new_st = dict(
            client_params=cp,
            server_params=server_params,
            cache=cache,
            prev_idx=gate(idx, st["prev_idx"]),
            prev_teacher=gate(r["teacher"], st["prev_teacher"]),
            have_prev=st["have_prev"] | any_p,
            teacher_val=teacher_val,
            have_tv=st["have_tv"] | any_p,
            last_sync=torch.where(part, t, st["last_sync"]),
        )
        out = dict(uplink=torch.where(any_p, uplink, 0.0),
                   downlink=torch.where(any_p, downlink, 0.0),
                   have_tv=new_st["have_tv"])
        if self._telemetry:  # from the pre-update last_sync
            out["telemetry"], new_st["telemetry"] = self._telemetry_device(
                st["telemetry"], t, part, any_p, miss=r["miss"], base=r["base"],
                base_present=r["base_present"], z_tx=r["z_tx"], z_all=r["z_all"],
                fresh=r["fresh"], last_sync=st["last_sync"], uplink=out["uplink"],
                downlink=out["downlink"], catch_up=catch_up)
        if do_eval:  # the schedule is known on the host
            out.update(self._eval_metrics(cp, server_params, teacher_val))
        return new_st, out

    def _request_list(self, cache_prev, idx: torch.Tensor, t: int, u=None) -> torch.Tensor:
        """Round ``t``'s ``(m,)`` bool request list over ``idx`` against the
        pre-round cache (every entry with the cache off)."""
        if self.use_cache:
            return cache_lib.miss_mask(cache_prev, idx, t, self.D,
                                       probabilistic=self.probabilistic_expiry, u=u)
        return torch.ones(self.cfg.public_per_round, dtype=torch.bool, device=idx.device)

    def _server_round(self, params: List[Params], w: torch.Tensor,
                      idx: torch.Tensor, t: int, *, x_pub, cache_prev,
                      server_params, u=None, tkey=None, reduce=None) -> Dict[str, Any]:
        """The round from the clients' trained parameters to the server's,
        shared by this engine (the full stacks, ``w`` the float32
        participation vector), the active-set engine (the gathered stack,
        ``w`` its valid rows) and the async engine (``w`` the arrivals'
        staleness weights): the request list, the uplink codec or the fused
        kernel, the ``w``-weighted aggregation, the downlink codec, the
        teacher, the cache update and server distillation.  Nothing is
        gated on a total outage (the caller gates), and the bytes are the
        caller's (:meth:`_round_bytes`).  Returns the pieces the callers
        and telemetry read: ``miss``, ``miss_f``, ``n_req``, ``um`` (the
        upload mask or None), ``base``, ``base_present``, ``z_tx`` (as
        transmitted), ``z_all`` (the server's view; the transmitted stack
        on the fused path), ``fresh``, ``teacher``, ``cache`` and
        ``server_params``.  ``t`` is a host int; nothing here reads the
        device.

        ``reduce`` (the sharded engine's) splits the aggregation in its
        two phases: the strategy's linear moments of ``params``' stack,
        one shard of the clients with ``w`` its 0/1 participation, go
        through ``reduce`` (a dict of tensors in, their sums over the
        shards out) before ``finalize_aggregate``.  With an upload mask
        the shard's uploaded-entry count rides along, and ``r`` holds the
        sum as ``uploaded``."""
        c, s = self.cfg, self.strategy
        m, N = c.public_per_round, c.n_classes

        # --- request list (cache) ------------------------------------------
        miss = self._request_list(cache_prev, idx, t, u)
        miss_f = miss.to(torch.float32)
        # shared delta-coding base: the synchronized cache at P^t (pre-update)
        base, base_present = cache_lib.cached_at(cache_prev, idx)

        # --- uplink + aggregation (fixed shapes, weighted by w) ------------
        x_round = x_pub[idx]
        z_all = s.transmit(self._predict_all(params, x_round), tkey)  # (rows, m, N)
        z_tx = z_all  # as transmitted: telemetry's codec-error reference
        uploaded = None
        if self._fused_spec is not None:
            um = s.upload_mask(z_all)
            fbase = (round_kernel.resolve_delta_base(base, base_present, m, N)
                     if self._fused_spec["mode"] == "delta" else None)
            if reduce is None:
                fresh = s.aggregate_masked_fused(z_all, w, self._fused_spec, fbase, t)
            else:
                partials = s.partial_aggregate_fused(z_all, w, self._fused_spec, fbase, t)
        else:
            if not self.codec_up.is_identity:  # lossy wire: the server's view
                z_all = self.codec_up.roundtrip(z_all, base=base,
                                                present=base_present)
            um = s.upload_mask(z_all)
            if reduce is None:
                fresh = s.aggregate_masked(z_all, w, um, t)
            else:
                partials = s.partial_aggregate(z_all, w, um, t)
        if reduce is not None:  # two phases: the shards' moments summed, then finalized
            if um is not None:
                partials["uploaded"] = self._uploaded(um, w, miss_f)
            partials = reduce(partials)
            uploaded = partials.pop("uploaded", None)
            fresh = s.finalize_aggregate(partials, t)
        if not self.codec_down.is_identity:  # decoded broadcast (see rounds.py)
            fresh = self.codec_down.roundtrip(fresh, base=base,
                                              present=base_present)

        # --- assemble teacher + cache update ------------------------------
        cache = cache_prev
        if self.use_cache:
            teacher = cache_lib.assemble_teacher(cache_prev, idx, fresh, miss)
            cache, _ = cache_lib.update_global_cache(cache_prev, idx, teacher,
                                                     miss, t)
        else:
            teacher = fresh

        # --- server distillation ------------------------------------------
        sp = distill(server_params, x_round, teacher, c.lr_dist, c.distill_steps)
        return dict(miss=miss, miss_f=miss_f, n_req=miss_f.sum(), um=um, base=base,
                    base_present=base_present, z_tx=z_tx, z_all=z_all, fresh=fresh,
                    teacher=teacher, cache=cache, server_params=sp, uploaded=uploaded)

    @staticmethod
    def _uploaded(um: torch.Tensor, count: torch.Tensor, miss_f: torch.Tensor) -> torch.Tensor:
        """The entries the reporting clients (``count``, float32 0/1) upload
        among the requested samples (``miss_f``) under upload mask ``um``."""
        return (um.to(torch.float32) * count[:, None] * miss_f[None, :]).sum()

    def _round_bytes(self, r: Dict[str, Any], count: torch.Tensor, catch_up,
                     n_up=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(uplink, downlink) of a round, float32 on the device, from
        :meth:`_server_round`'s ``r``: ``count`` the float32 0/1 vector of
        the clients that report (the participants; the async engine's
        arrivals, never their staleness weights), ``catch_up`` the
        catch-up bytes, ``n_up`` each reporter's requested samples (default
        this round's request count; the async engine's dispatch-time
        mean).  An upload mask (Selective-FD) gates the uplink only; the
        uploaded count is ``r["uploaded"]`` where the round summed it over
        shards."""
        c, s = self.cfg, self.strategy
        n_clients = count.sum()
        if n_up is None:
            n_up = r["n_req"]
        if r["um"] is not None:  # Selective-FD: the mask gates the uplink only
            uploaded = r["uploaded"]
            if uploaded is None:
                uploaded = self._uploaded(r["um"], count, r["miss_f"])
            n_up = uploaded / torch.clamp_min(n_clients, 1.0)
        return comm_lib.distillation_round_cost_device(
            n_clients=n_clients,
            n_selected=float(c.public_per_round),
            n_up_samples=n_up,
            n_down_samples=r["n_req"],
            n_classes=c.n_classes,
            uplink_bits=s.uplink_bits,
            downlink_bits=s.downlink_bits,
            with_cache_signals=self.use_cache,
            catch_up_down=catch_up,
            bytes_index=c.index_bytes,
            uplink_codec=self.codec_up,
            downlink_codec=self.codec_down,
        )

    def _server_view(self, z_tx, z_all, base, base_present) -> torch.Tensor:
        """The server's decoded view of the uplink, for telemetry's gauges:
        ``z_all``, except on the fused path with a lossy uplink codec,
        which never materialises it; there the uplink codec's round trip
        of the transmitted ``z_tx`` (one more qdq launch a round)."""
        if self._fused_spec is not None and not self.codec_up.is_identity:
            return self.codec_up.roundtrip(z_tx, base=base, present=base_present)
        return z_all

    def _telemetry_device(self, totals: obs_device.RoundTelemetry, t: int,
                          part: torch.Tensor, any_p: torch.Tensor, *, miss, base,
                          base_present, z_tx, z_all, fresh, last_sync, uplink,
                          downlink, catch_up, w=None, group=None):
        """(the round's telemetry row, the leg's running totals): the row of
        :meth:`_telemetry_row` (with ``telemetry_hook``), zeroed unless
        ``any_p``, as the host loop's total-outage row is.  What the
        analyzer's obs pass traces on fake CUDA tensors.  ``part`` is the
        full-width participation; the sharded engine passes its shard's
        weights ``w`` (the rows of ``z_tx``/``z_all``) and ``group``."""
        part_f = part.to(torch.float32)
        gauges = self._telemetry_gauges(
            t, part_f if w is None else w, miss=miss, base_present=base_present,
            z_tx=z_tx, z_srv=self._server_view(z_tx, z_all, base, base_present),
            fresh=fresh, n_part=part_f.sum(), group=group)
        tel = obs_device.gate(self._telemetry_row(
            t, self._telemetry_counters(t, part, last_sync), gauges,
            uplink=uplink, downlink=downlink, catch_up=catch_up), any_p)
        return tel, obs_device.accumulate(totals, tel)

    # ------------------------------------------------------------------
    def _finish_run(self, leg: _Leg) -> History:
        """Persist the final state and rebuild the host-visible History
        from the leg's results, read back from the device in one copy
        (plus one for ``last_sync``); telemetry rows ride in that copy as
        float32 (every counter is an exact small integer)."""
        st = leg.state
        st.pop("telemetry", None)
        tel_rows = [o.pop("telemetry") for o in leg.outputs if "telemetry" in o]
        self.client_params = st["client_params"]
        self.server_params = st["server_params"]
        self.cache_g = st["cache"]
        self.t_done = leg.t0 + len(leg.ts)

        outs = leg.outputs
        evals = [o for o in outs if "server_acc" in o]
        n_coh = self.models.n_cohorts
        f32 = dict(dtype=torch.float32, device=self.device)
        rows = [torch.stack([o["uplink"], o["downlink"],
                             o["have_tv"].to(torch.float32)]) for o in outs]
        erows = [torch.cat([torch.stack([o["server_acc"], o["client_acc"],
                                         o["server_val"], o["client_val"]]),
                            o["cohort_acc"]]) for o in evals]
        trows = [torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in r])
                 for r in tel_rows]
        flat = torch.cat([torch.stack(rows).flatten() if rows else torch.zeros(0, **f32),
                          torch.stack(erows).flatten() if erows else torch.zeros(0, **f32),
                          torch.stack(trows).flatten() if trows else torch.zeros(0, **f32),
                          torch.stack([st["have_prev"], st["have_tv"]]).to(torch.float32)])
        flat = flat.cpu().numpy()
        self.last_sync = st["last_sync"].cpu().numpy().astype(np.int64)
        T, E = len(outs), len(evals)
        per_round = flat[:3 * T].reshape(T, 3)
        per_eval = flat[3 * T:3 * T + (4 + n_coh) * E].reshape(E, 4 + n_coh)
        tel_flat = flat[3 * T + (4 + n_coh) * E:-2]
        have_prev, have_tv = flat[-2:] > 0
        if have_prev:
            self.prev_teacher = (st["prev_idx"], st["prev_teacher"])
        if have_tv:
            self.last_teacher_val = st["teacher_val"]

        # --- the History, as the reference's _finish_run builds it --------
        up = per_round[:, 0].astype(np.float64)
        down = per_round[:, 1].astype(np.float64)
        cum = np.cumsum(up + down)
        hist = History()
        for u, d in zip(up, down):
            hist.ledger.record(comm_lib.RoundCost(float(u), float(d)))
        eval_rounds = [i for i, e in enumerate(leg.do_eval) if e]
        for i, row in zip(eval_rounds, per_eval):
            hist.rounds.append(leg.ts[i])
            hist.server_acc.append(float(row[0]))
            hist.client_acc.append(float(row[1]))
            hist.cohort_client_acc.append([float(x) for x in row[4:]])
            hist.cumulative_mb.append(float(cum[i]) / 1e6)
            if per_round[i, 2] > 0:
                hist.server_val_loss.append(float(row[2]))
            hist.client_val_loss.append(float(row[3]))
        hist.final_server_acc = hist.server_acc[-1] if hist.server_acc else None
        hist.final_client_acc = hist.client_acc[-1] if hist.client_acc else None
        if self._telemetry:
            hist.telemetry = self._telemetry_log(tel_flat, T)
        return hist

    def _telemetry_log(self, flat: np.ndarray, T: int) -> obs_device.TelemetryLog:
        """The leg's ``(T, width)`` float32 telemetry rows, read back flat,
        split into the row's fields, counters cast back to int32."""
        like = obs_device.zeros(self.models.n_cohorts)
        sizes = [leaf.numel() for leaf in like]
        rows = flat.reshape(T, sum(sizes))
        cols = np.split(rows, np.cumsum(sizes)[:-1], axis=1)
        return obs_device.TelemetryLog.from_stacked(obs_device.RoundTelemetry(*(
            c.reshape((T,) + tuple(leaf.shape)).astype(leaf.numpy().dtype)
            for c, leaf in zip(cols, like))))
