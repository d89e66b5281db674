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

Draws.  The round's participation mask and public subset P^t are not
drawn on the device: before the loop, :meth:`run` draws the whole leg on
the host with the engine's numpy Generators (``_draw_round``, round by
round, exactly as the host loop draws them) and uploads the ``(T, K)``
and ``(T, m)`` stacks once.  So the device engine and the host loop of
the same configuration see the same draws.  ``run(draws=(part, idx))``
takes the stacks from the caller instead, e.g. the reference's jax-stream
draws, to hold a run against the reference's scan engine.  Under
probabilistic expiry the leg's ``(T, m)`` expiry uniforms are uploaded
with the draws, from the host loop's default stream or from
``run(expiry_uniforms=...)``.  Heterogeneous schedules run as on the host
loop: the per-client rates and step counts sit on the device from
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

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import cache as cache_lib
from repro_torch.core import comm as comm_lib
from repro_torch.fl.rounds import FederatedDistillation, History, _select_cohorts, distill
from repro_torch.kernels import round_kernel
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
    outputs: List[Dict[str, torch.Tensor]] = field(default_factory=list)


class ScannedFederatedDistillation(FederatedDistillation):
    """Device-resident twin of :class:`FederatedDistillation`: the same
    constructor, and ``run()`` returns the same :class:`History`, with one
    ledger entry per round (total outages included, at zero) and eval rows
    on the ``eval_every`` schedule."""

    def __init__(self, cfg, strategy, cache_duration: int = 0,
                 use_cache: Optional[bool] = None,
                 probabilistic_expiry: bool = False, scenario=None,
                 track_local_caches: bool = False,
                 rng_backend: str = "numpy", device="cuda"):
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
        engine's own (its numpy Generators are then not advanced);
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
        K, m = c.n_clients, c.public_per_round
        if draws is None:
            pairs = [self._draw_round(t) for t in ts]
            part = np.array([p for p, _ in pairs], bool).reshape(T, K)
            idx = np.array([i for _, i in pairs], np.int64).reshape(T, m)
        else:
            part, idx = np.asarray(draws[0]).astype(bool), np.asarray(draws[1])
            if part.shape != (T, K) or idx.shape != (T, m):
                raise ValueError(f"draws must be ({T}, {K}) and ({T}, {m}), "
                                 f"got {part.shape} and {idx.shape}")
            if (part & self.scenario.offline_masks(T, K, start=t0 + 1)).any():
                raise ValueError("draws let an offline client participate")
            srt = np.sort(idx, axis=1)
            if T and (srt[:, 0].min() < 0 or srt[:, -1].max() >= c.public_size
                      or (np.diff(srt, axis=1) <= 0).any()):
                raise ValueError("each round's P^t must hold distinct public "
                                 f"indices in [0, {c.public_size})")
        u = self._leg_uniforms(T, expiry_uniforms)
        state = self.state_dict()
        del state["t_done"]
        state["prev_idx"] = state["prev_idx"].to(torch.int64)
        if self._telemetry:  # the leg's running totals
            state["telemetry"] = obs_device.zeros(self.models.n_cohorts, self.device)
        return _Leg(t0=t0, ts=ts, part=self._tensor(part),
                    idx=self._tensor(idx, torch.int64),
                    u=None if u is None else self._tensor(u),
                    do_eval=[t % c.eval_every == 0 or t == t0 + T for t in ts],
                    state=state)

    def _run_rounds(self, leg: _Leg) -> None:
        """The leg's rounds, on the device; on a CUDA device any host sync
        inside them raises."""
        prev = torch.cuda.get_sync_debug_mode() if self.device.type == "cuda" else None
        if prev is not None:
            torch.cuda.set_sync_debug_mode("error")
        try:
            st = leg.state
            for i, t in enumerate(leg.ts):
                kw = {} if leg.u is None else {"u": leg.u[i]}
                st, out = self._round_device(st, t, leg.part[i], leg.idx[i],
                                             leg.do_eval[i], **kw)
                leg.outputs.append(out)
            leg.state = st
        finally:
            if prev is not None:
                torch.cuda.set_sync_debug_mode(prev)

    # ------------------------------------------------------------------
    def _round_device(self, st: Dict[str, Any], t: int, part: torch.Tensor,
                      idx: torch.Tensor, do_eval: bool,
                      u: Optional[torch.Tensor] = None):
        """One round on the device (reference ``_round_device``): the
        state in, the state out and this round's results.  ``t`` and
        ``do_eval`` are host values; ``u`` is the round's row of expiry
        uniforms (probabilistic expiry); nothing here reads the device."""
        c, s = self.cfg, self.strategy
        m, N = c.public_per_round, c.n_classes
        part_f = part.to(torch.float32)
        n_part = part_f.sum()
        any_p = n_part > 0

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

        # --- request list (cache) ------------------------------------------
        cache_prev = st["cache"]
        if self.use_cache:
            miss = cache_lib.miss_mask(cache_prev, idx, t, self.D,
                                       probabilistic=self.probabilistic_expiry, u=u)
        else:
            miss = torch.ones(m, dtype=torch.bool, device=self.device)
        miss_f = miss.to(torch.float32)
        n_req = miss_f.sum()
        # shared delta-coding base: the synchronized cache at P^t (pre-update)
        base, base_present = cache_lib.cached_at(cache_prev, idx)

        # --- uplink + aggregation (fixed shapes, participation-weighted) ---
        x_round = self.x_pub[idx]
        z_all = s.transmit(self._predict_all(cp, x_round))     # (K, m, N)
        z_tx = z_all  # as transmitted: telemetry's codec-error reference
        if self._fused_spec is not None:
            um = s.upload_mask(z_all)
            fbase = (round_kernel.resolve_delta_base(base, base_present, m, N)
                     if self._fused_spec["mode"] == "delta" else None)
            fresh = s.aggregate_masked_fused(z_all, part_f, self._fused_spec,
                                             fbase, t)
        else:
            if not self.codec_up.is_identity:  # lossy wire: the server's view
                z_all = self.codec_up.roundtrip(z_all, base=base,
                                                present=base_present)
            um = s.upload_mask(z_all)
            fresh = s.aggregate_masked(z_all, part_f, um, t)
        if not self.codec_down.is_identity:  # decoded broadcast (see rounds.py)
            fresh = self.codec_down.roundtrip(fresh, base=base,
                                              present=base_present)

        # --- assemble teacher + cache update ------------------------------
        cache = cache_prev
        if self.use_cache:
            teacher = cache_lib.assemble_teacher(cache_prev, idx, fresh, miss)
            new_cache, _ = cache_lib.update_global_cache(cache_prev, idx,
                                                         teacher, miss, t)
            cache = cache_lib.CacheState(
                *(gate(a, b) for a, b in zip(new_cache, cache_prev)))
        else:
            teacher = fresh

        # --- server distillation + App.-D proxy teacher -------------------
        sp = distill(st["server_params"], x_round, teacher, c.lr_dist,
                     c.distill_steps)
        server_params = {k: gate(v, st["server_params"][k])
                         for k, v in sp.items()}
        zv = self._predict_all(cp, self.x_pub[self.pub_val_idx])
        teacher_val = gate(zv.mean(0), st["teacher_val"])

        # --- communication accounting (float32, on the device) ------------
        catch_up = 0.0
        if self.use_cache:
            catch_up = cache_lib.catch_up_bytes_device(
                cache_prev, st["last_sync"], part, t)
        n_up = n_req
        if um is not None:  # Selective-FD: the mask gates the uplink only
            uploaded = (um.to(torch.float32) * part_f[:, None]
                        * miss_f[None, :]).sum()
            n_up = uploaded / torch.clamp_min(n_part, 1.0)
        uplink, downlink = comm_lib.distillation_round_cost_device(
            n_clients=n_part,
            n_selected=float(m),
            n_up_samples=n_up,
            n_down_samples=n_req,
            n_classes=N,
            uplink_bits=s.uplink_bits,
            downlink_bits=s.downlink_bits,
            with_cache_signals=self.use_cache,
            catch_up_down=catch_up,
            bytes_index=c.index_bytes,
            uplink_codec=self.codec_up,
            downlink_codec=self.codec_down,
        )
        new_st = dict(
            client_params=cp,
            server_params=server_params,
            cache=cache,
            prev_idx=gate(idx, st["prev_idx"]),
            prev_teacher=gate(teacher, st["prev_teacher"]),
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
                st["telemetry"], t, part, any_p, miss=miss, base=base,
                base_present=base_present, z_tx=z_tx, z_all=z_all, fresh=fresh,
                last_sync=st["last_sync"], uplink=out["uplink"],
                downlink=out["downlink"], catch_up=catch_up)
        if do_eval:  # the schedule is known on the host
            out.update(self._eval_metrics(cp, server_params, teacher_val))
        return new_st, out

    def _telemetry_device(self, totals: obs_device.RoundTelemetry, t: int,
                          part: torch.Tensor, any_p: torch.Tensor, *, miss, base,
                          base_present, z_tx, z_all, fresh, last_sync, uplink,
                          downlink, catch_up):
        """(the round's telemetry row, the leg's running totals): the row of
        :meth:`_telemetry_row` (with ``telemetry_hook``), zeroed unless
        ``any_p``, as the host loop's total-outage row is.  On the fused
        path ``z_all`` is the transmitted stack; the server's view comes
        from the uplink codec's round trip here.  What the analyzer's obs
        pass traces on fake CUDA tensors."""
        z_srv = z_all
        if self._fused_spec is not None and not self.codec_up.is_identity:
            z_srv = self.codec_up.roundtrip(z_tx, base=base, present=base_present)
        tel = obs_device.gate(self._telemetry_row(
            t=t, part=part, miss=miss, base_present=base_present, z_tx=z_tx,
            z_srv=z_srv, fresh=fresh, last_sync=last_sync, uplink=uplink,
            downlink=downlink, catch_up=catch_up), any_p)
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
