"""Async engine: dispatch now, aggregate what arrived (counterpart of
``repro.fl.async_engine``, ``engine="async"``).

Every other engine is synchronous: the clients drawn in round ``t`` train,
upload and are aggregated in round ``t``.  Here clients arrive on their own
schedule (:mod:`repro_torch.fl.traffic`), train against the cache they were
handed, and report late.  One round is one aggregation window:

- **dispatch**: the usual participation draw, over the clients that are
  reachable this window (traffic availability and churn), not offline and
  not already in flight.  A dispatched client distills on the previous
  teacher, trains locally and starts its report; its parameters then stay
  frozen until the report lands (an in-flight client is never drawn).
- **arrival**: the reports dispatched ``d`` rounds ago land, with this
  window's zero-delay dispatches.  The server aggregates whatever arrived
  through the device engine's round (:meth:`ScannedFederatedDistillation.
  _server_round`), each report weighted by the arrival mask times
  :meth:`Strategy.staleness_weight` of its staleness (skipped at the
  default unit decay).  Teacher, cache, server distillation, the broadcast
  and the proxy teacher move only on a round where something arrives.

Ledger (the reference's rule): a report's **uplink** is charged at its
dispatch-time request count (``flight_nreq``), over the arriving clients
(their count, never their weights); **catch-up** is charged on both sides,
:func:`repro_torch.core.cache.catch_up_bytes_async`; a round where nothing
arrives is charged the dispatch side's catch-up only.  ``last_sync`` is
``t - 1`` on dispatch and ``t`` on arrival.  Under the default traffic
model (always reachable, zero latency) the draws, the masks and every
ledger term reduce to the device engine's, so its ledger equals
``engine="scan"``'s bit for bit; staleness weights never change the ledger.

Planning on the host.  Dispatch depends on what is in flight, and flight
on the dispatches and the traffic's delays, never on a device value.  So
before a leg's rounds run, :meth:`AsyncFederatedDistillation.plan_flight`
replays the leg on the host round by round (the traffic compiled for its
rounds, the draws with the blocked clients folded in, or the caller's
``draws(t, blocked)``) and the ``(T, K)`` dispatch and arrival masks are
uploaded once with P^t.  Which draws run where: under the jax stream (the
default) the leg's round keys and P^t come from the threefry kernel on
the device in one batch, as on the device engine, and are copied to the
host; each round's dispatch draw, which depends on the rounds before it,
runs on the host from the participation keys by the stream's plain
version on CPU tensors.  Under the numpy stream both come from the numpy
Generators on the host.  The rounds then run under the device
engine's sync guard with no read of the card; whether a round dispatches
or receives anything is a host bool, so a round with no arrival skips the
server's side instead of computing and discarding it.  Only
``flight_nreq``, ``last_sync`` and the cache live on the device; the
flight state (``in_flight``, ``flight_arrival``) is host numpy, and
``state_dict`` carries all three under the reference's keys and dtypes.

Telemetry rows use the arrival mask as the participants and the pre-round
``last_sync``, so a delayed report's staleness bucket is its delay; a
round with no arrival records the zero row.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import cache as cache_lib
from repro_torch.fl.rounds import History, _select_cohorts
from repro_torch.fl.scan_engine import ScannedFederatedDistillation, _Leg
from repro_torch.fl.traffic import TrafficModel
from repro_torch.obs import device as obs_device

__all__ = ["AsyncFederatedDistillation", "FlightPlan"]

# draws(t, blocked) -> (dispatch (K,) bool, sorted P^t (m,))
DrawFn = Callable[[int, np.ndarray], Tuple[np.ndarray, np.ndarray]]


@dataclass
class FlightPlan:
    """A leg's dispatches and arrivals, planned on the host: ``(T, K)``
    bool ``dispatch`` and ``arrive``, the traffic's ``(T, K)`` int32
    ``delay`` and ``(T, K)`` bool ``available``, the ``(T, m)`` P^t
    ``idx``, and the flight state after the leg (``in_flight`` (K,) bool,
    ``flight_arrival`` (K,) int32)."""

    dispatch: np.ndarray
    arrive: np.ndarray
    delay: np.ndarray
    available: np.ndarray
    idx: np.ndarray
    in_flight: np.ndarray
    flight_arrival: np.ndarray


@dataclass
class _AsyncLeg(_Leg):
    plan: Optional[FlightPlan] = None
    arrive: Optional[torch.Tensor] = None  # (T, K) bool, on the device


class AsyncFederatedDistillation(ScannedFederatedDistillation):
    """The device engine's constructor plus ``traffic`` (a
    :class:`repro_torch.fl.traffic.TrafficModel`; the default is the
    synchronous regime).  The staleness decay rides on the strategy:
    ``STRATEGIES[...](..., staleness_decay=0.5)``.  ``last_plan`` holds the
    last leg's :class:`FlightPlan`."""

    def __init__(self, *args, traffic: Optional[TrafficModel] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.traffic = traffic if traffic is not None else TrafficModel()
        K = self.cfg.n_clients
        # flight state: who is mid-report, the round each report lands, and
        # the dispatch-time request count its uplink is charged for
        self.in_flight = np.zeros(K, bool)
        self.flight_arrival = np.zeros(K, np.int32)
        self.flight_nreq = torch.zeros(K, dtype=torch.float32, device=self.device)
        # at unit decay the weights are the arrival mask itself (no "x * 1.0")
        self._unit_staleness = float(self.strategy.opts.get("staleness_decay", 1.0)) == 1.0
        self.last_plan: Optional[FlightPlan] = None

    def run(self, rounds: Optional[int] = None, *, draws: Optional[DrawFn] = None,
            expiry_uniforms: Optional[np.ndarray] = None) -> History:
        """Run ``rounds`` more rounds (default: the configured count),
        numbered on from ``t_done``.  ``draws(t, blocked)`` gives round
        ``t``'s dispatch mask and P^t in place of the engine's stream (the
        numpy Generators are then not advanced); ``blocked`` is the round's (K,) bool
        mask of offline, unreachable and in-flight clients, and a draw that
        dispatches one of them raises.  ``expiry_uniforms`` as on the device
        engine."""
        return super().run(rounds, draws=draws, expiry_uniforms=expiry_uniforms)

    # ------------------------------------------------------------------
    def plan_flight(self, T: int, draws: Optional[DrawFn] = None) -> FlightPlan:
        """The next ``T`` rounds' dispatches and arrivals, replayed on the
        host from the flight state, the traffic (compiled from round
        ``t_done + 1``) and the draws (the jax stream, the numpy
        Generators, advanced as the rounds would, or ``draws``)."""
        c = self.cfg
        K, m, t0 = c.n_clients, c.public_per_round, self.t_done
        traffic = self.traffic.compile(T, K, start=t0 + 1)
        in_flight, arrival = self.in_flight.copy(), self.flight_arrival.copy()
        dispatch = np.zeros((T, K), bool)
        arrive = np.zeros((T, K), bool)
        idx = np.zeros((T, m), np.int64)
        if draws is None and self.rng_backend == "jax":  # the leg's P^t on the device
            leg_idx, k_part = self._subsets(self._round_keys(t0, T, self.device))
            leg_idx, k_part = leg_idx.cpu().numpy(), k_part.cpu()
        for i, t in enumerate(range(t0 + 1, t0 + T + 1)):
            blocked = (self.scenario.offline_mask(t, K) | ~traffic.available[i]
                       | in_flight)
            if draws is not None:
                d, ix = draws(t, blocked.copy())
            elif self.rng_backend == "jax":
                d = self.scenario.participation_mask_device(
                    k_part[i], torch.from_numpy(blocked)).numpy()
                ix = leg_idx[i]
            else:
                d, ix, _ = self._draw_round(t, blocked)
            d = np.asarray(d).astype(bool)
            if d.shape != (K,) or np.shape(ix) != (m,):
                raise ValueError(f"round {t}: draws must give ({K},) and ({m},), got "
                                 f"{d.shape} and {np.shape(ix)}")
            if (d & blocked).any():
                raise ValueError(f"round {t}: the draws dispatch blocked clients "
                                 f"{np.nonzero(d & blocked)[0].tolist()} (offline, "
                                 "unreachable or in flight)")
            delay = traffic.delay[i]
            arr = (in_flight & (arrival == t)) | (d & (delay == 0))
            in_flight = (in_flight & ~arr) | (d & (delay > 0))
            arrival = np.where(d, t + delay, arrival).astype(np.int32)
            dispatch[i], arrive[i], idx[i] = d, arr, ix
        return FlightPlan(dispatch=dispatch, arrive=arrive, delay=traffic.delay,
                          available=traffic.available, idx=idx, in_flight=in_flight,
                          flight_arrival=arrival)

    def _start_leg(self, rounds: Optional[int], draws, expiry_uniforms=None) -> _AsyncLeg:
        T = self.cfg.rounds if rounds is None else rounds
        plan = self.plan_flight(T, draws)
        leg = super()._start_leg(T, (plan.dispatch, plan.idx), expiry_uniforms)
        for key in ("in_flight", "flight_arrival"):  # host-planned, not round state
            del leg.state[key]
        return _AsyncLeg(**{f.name: getattr(leg, f.name) for f in dataclasses.fields(_Leg)},
                         plan=plan, arrive=self._tensor(plan.arrive))

    def _run_rounds(self, leg: _AsyncLeg) -> None:
        plan = leg.plan
        with self._sync_guard():
            st = leg.state
            for i, t in enumerate(leg.ts):
                st, out = self._round_device(
                    st, t, leg.part[i], leg.idx[i], leg.do_eval[i], arrive=leg.arrive[i],
                    any_disp=bool(plan.dispatch[i].any()),
                    any_arr=bool(plan.arrive[i].any()), **leg.round_kw(i))
                leg.outputs.append(out)
            leg.state = st

    # ------------------------------------------------------------------
    def _flight_books(self, cache: cache_lib.CacheState, last_sync: torch.Tensor,
                      dispatch: torch.Tensor, arrive: torch.Tensor,
                      t: int) -> Dict[str, torch.Tensor]:
        """The round's flight bookkeeping before the server's side, a
        function of tensors (what the analyzer's async pass traces): the
        arrivals' aggregation weights ``w`` (``arrive_f``, times
        ``staleness_weight(t - 1 - ls_mid)`` unless the decay is 1, with
        ``ls_mid`` the dispatch-updated sync points), both sides' catch-up
        bytes (``catch_up`` the total, ``catch_disp`` the dispatch side)
        and the new ``last_sync``."""
        ls_mid = torch.where(dispatch, t - 1, last_sync)
        arrive_f = arrive.to(torch.float32)
        w = (arrive_f if self._unit_staleness
             else arrive_f * self.strategy.staleness_weight(t - 1 - ls_mid))
        catch_up = catch_disp = torch.zeros((), dtype=torch.float32, device=arrive.device)
        if self.use_cache:
            catch_up, catch_disp = cache_lib.catch_up_bytes_async(
                cache, last_sync, dispatch, arrive, t)
        return dict(arrive_f=arrive_f, w=w, catch_up=catch_up, catch_disp=catch_disp,
                    last_sync=torch.where(arrive, t, ls_mid))

    @staticmethod
    def _uplink_books(flight_nreq: torch.Tensor, dispatch: torch.Tensor,
                      arrive_f: torch.Tensor, n_req: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the new ``flight_nreq``, the arrivals' mean dispatch-time request
        count): a dispatched client is charged this round's ``n_req`` when
        its report lands.  When everything arrives in its own round the
        mean is ``(n * n_req) / n``, exactly ``n_req``."""
        flight_nreq = torch.where(dispatch, n_req, flight_nreq)
        n_up = (arrive_f * flight_nreq).sum() / torch.clamp_min(arrive_f.sum(), 1.0)
        return flight_nreq, n_up

    def _round_device(self, st: Dict[str, Any], t: int, dispatch: torch.Tensor,
                      idx: torch.Tensor, do_eval: bool, u: Optional[torch.Tensor] = None,
                      tkey: Optional[torch.Tensor] = None, *, arrive: torch.Tensor,
                      any_disp: bool, any_arr: bool):
        """One async round (reference ``_round_device``): ``dispatch`` and
        ``arrive`` are the planned (K,) masks on the device, ``any_disp``
        and ``any_arr`` their host-known ``any()``.  Nothing here reads the
        device."""
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        cp = st["client_params"]
        if any_disp:  # dispatched clients distill on the teacher they were handed
            upd = self._distill_all(cp, self.x_pub[st["prev_idx"]], st["prev_teacher"])
            cp = _select_cohorts(upd, cp, self.models.split(dispatch & st["have_prev"]))
            cp = _select_cohorts(self._local_train_all(cp, t), cp,
                                 self.models.split(dispatch))
        book = self._flight_books(st["cache"], st["last_sync"], dispatch, arrive, t)
        new_st = dict(st, client_params=cp, last_sync=book["last_sync"])
        # a round with no arrival: the dispatch side's catch-up flows alone
        out = dict(uplink=zero, downlink=book["catch_disp"] if any_disp else zero,
                   have_tv=st["have_tv"])
        if any_arr:
            r = self._server_round(cp, book["w"], idx, t, x_pub=self.x_pub,
                                   cache_prev=st["cache"],
                                   server_params=st["server_params"], u=u, tkey=tkey)
            new_st["flight_nreq"], n_up = self._uplink_books(
                st["flight_nreq"], dispatch, book["arrive_f"], r["n_req"])
            uplink, downlink = self._round_bytes(r, book["arrive_f"], book["catch_up"],
                                                 n_up=n_up)
            on = torch.ones_like(st["have_prev"])
            zv = self._predict_all(cp, self.x_pub[self.pub_val_idx])  # App.-D proxy
            new_st.update(server_params=r["server_params"], cache=r["cache"], prev_idx=idx,
                          prev_teacher=r["teacher"], have_prev=on, teacher_val=zv.mean(0),
                          have_tv=on)
            out.update(uplink=uplink, downlink=downlink, have_tv=on)
            if self._telemetry:  # arrivals are the participants; pre-round last_sync
                out["telemetry"], new_st["telemetry"] = self._telemetry_device(
                    st["telemetry"], t, arrive, arrive.any(), miss=r["miss"],
                    base=r["base"], base_present=r["base_present"], z_tx=r["z_tx"],
                    z_all=r["z_all"], fresh=r["fresh"], last_sync=st["last_sync"],
                    uplink=uplink, downlink=downlink, catch_up=book["catch_up"])
        else:
            if any_disp:
                n_req = self._request_list(st["cache"], idx, t, u).to(torch.float32).sum()
                new_st["flight_nreq"], _ = self._uplink_books(
                    st["flight_nreq"], dispatch, book["arrive_f"], n_req)
            if self._telemetry:
                out["telemetry"] = obs_device.zeros(self.models.n_cohorts, self.device)
        if do_eval:
            out.update(self._eval_metrics(cp, new_st["server_params"], new_st["teacher_val"]))
        return new_st, out

    # ------------------------------------------------------------------
    def _finish_run(self, leg: _AsyncLeg) -> History:
        self.flight_nreq = leg.state.pop("flight_nreq")
        self.in_flight = leg.plan.in_flight
        self.flight_arrival = leg.plan.flight_arrival
        self.last_plan = leg.plan
        return super()._finish_run(leg)

    # the flight state joins the checkpointable state next to last_sync,
    # under the reference's keys and dtypes
    def state_dict(self) -> Dict[str, Any]:
        state = super().state_dict()
        state["in_flight"] = self._tensor(self.in_flight, torch.bool)
        state["flight_arrival"] = self._tensor(self.flight_arrival, torch.int32)
        state["flight_nreq"] = self.flight_nreq
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        host = lambda v: np.asarray(torch.as_tensor(v).cpu())  # noqa: E731
        self.in_flight = host(state["in_flight"]).astype(bool)
        self.flight_arrival = host(state["flight_arrival"]).astype(np.int32)
        self.flight_nreq = torch.as_tensor(state["flight_nreq"]).to(self.device, torch.float32)
