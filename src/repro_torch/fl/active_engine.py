"""Active-set engine: million-client populations, O(m) device compute
(counterpart of ``repro.fl.active_engine``, ``engine="active"``).

The dense engines keep a ``(K, ...)`` parameter stack of every client on
the device, so the device's memory bounds the population, while a round
of SCARLET or DS-FL trains only its m participants.  This engine removes
that bound:

- **client state lives on the host**: the parameters in a
  :class:`repro_torch.checkpoint.ClientParamStore` (numpy arrays or
  memory-mapped files), the private and test shards, the masks and the
  per-client schedules as numpy arrays, through the placement hooks of
  :class:`repro_torch.fl.rounds.FederatedDistillation`;
- **each round draws over all K clients**, as the host loop draws
  (``_draw_round``): from the jax key stream on the device (the default,
  the reference's; P^t and the participation over K copied to the host
  before the round's steps, the transmit key left on the device; a
  fraction of a large K is chosen a chunk of clients at a time,
  ``core.prng.choice``), from the numpy Generators, or the caller's
  ``run(draws=...)``, checked on the host;
- **only the m participants are gathered** into a device stack per cohort,
  padded to the next power of two with copies of the cohort's first active
  row (weight exactly 0 in every reduction); the device engine's round
  body runs on that stack and the valid rows scatter back to the store;
- **the O(K) bookkeeping stays on the device** as one small step over
  ``(K,)`` integer tensors: ``last_sync``, the telemetry's participation
  counters, and the catch-up bytes by
  ``cache.catch_up_bytes_device(method="sorted")``, which never builds the
  device engine's ``(K, |P|)`` comparison mask.

Each round runs its two steps under ``torch.cuda.set_sync_debug_mode(
"error")`` on a CUDA device: the uploads of the gathered rows come before
them, and one device-to-host copy after them brings back the updated rows,
the round's ledger pair and its telemetry row together.  ``t`` stays a
host int inside the steps.

Parity contract: every ledger input is an exact small-integer count (the
participants, the requests, the catch-up entries) and goes through the
device engine's ``comm.distillation_round_cost_device`` expression, so the
ledger equals the device engine's bit for bit and the host loop's to
float32.  Caches, parameters and metrics agree to float reduction order
(the gathered stack sums m rows where the dense engines sum K rows, most
of them weighted 0).  Selective-FD's ledger is allclose only: its
per-client upload average is a float reduction over the stack.

The eval schedule's passes over all K clients (accuracies, the proxy
validation losses and the App.-D proxy teacher, which the dense engines
recompute every round and this engine on eval and ``state_dict`` only)
run in chunks of ``eval_chunk`` clients through the store.  Restore then
continue is bit for bit: ``state_dict`` rebuilds the dense engines'
``client_params`` from the store, rounds are numbered absolutely, and
``load_state_dict`` restores as the other engines' does (replaying the
numpy draws under that stream).

:mod:`repro_torch.analysis.active_checks` checks the split: the client
step must hold no tensor with a K-sized dimension, and both steps must be
free of host syncs.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.store import ClientParamStore
from repro_torch.core import cache as cache_lib
from repro_torch.core import comm as comm_lib
from repro_torch.core import prng
from repro_torch.fl.rounds import (
    History,
    accuracy,
    distill,
    local_train,
    local_train_masked,
    predict_soft,
    val_loss_hard,
    val_loss_soft,
)
from repro_torch.fl.scan_engine import ScannedFederatedDistillation
from repro_torch.fl.strategies.base import TRANSMIT_SALT
from repro_torch.models.resnet import apply_mlp
from repro_torch.obs import device as obs_device

__all__ = ["ActiveSetFederatedDistillation"]

# rows of the server's test set evaluated a device call
_TEST_CHUNK = 65536


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


def _host_array(a, dtype=None) -> np.ndarray:
    return torch.as_tensor(np.asarray(a), dtype=dtype).numpy()


class ActiveSetFederatedDistillation(ScannedFederatedDistillation):
    """Active-set twin of the device engine: host-resident client store,
    O(m) gathered device compute, the O(K) ledger bookkeeping exact.

    The device engine's constructor, plus the store's: ``store_backing``
    (``"ram"`` | ``"memmap"``), ``store_dir`` (the memmap files'
    directory), ``init_chunk`` (clients drawn a call at construction; the
    store's default when None; the draws do not depend on it) and
    ``eval_chunk`` (clients evaluated a device call on eval rounds).
    """

    def __init__(self, *args, store_backing: str = "ram",
                 store_dir: Optional[str] = None, init_chunk: Optional[int] = None,
                 eval_chunk: int = 4096, **kwargs):
        self._store_backing = store_backing
        self._store_dir = store_dir
        self._init_chunk = init_chunk
        self._eval_chunk = eval_chunk
        self._last_sync_dev = None
        super().__init__(*args, **kwargs)

    # ------------------------------------------------------------------
    # Placement hooks: per-client state stays host numpy.
    def _client_array(self, a, dtype=None):
        return _host_array(a, dtype)

    def _eval_array(self, a, dtype=None):
        return _host_array(a, dtype)

    def _init_client_params(self, keys: torch.Tensor) -> None:
        kw = {} if self._init_chunk is None else {"init_chunk": self._init_chunk}
        self._store = ClientParamStore(
            self.models, keys, backing=self._store_backing,
            directory=self._store_dir, device=self.device, **kw)

    def _restore_client_params(self, stacks) -> None:
        self._store.ingest_param_list(stacks)

    # client_params stays the dense engines' per-cohort list (numpy leaves),
    # read from and written to the store: the shared state_dict and
    # load_state_dict work unchanged
    @property
    def client_params(self) -> List[Dict[str, np.ndarray]]:
        return self._store.as_param_list()

    @client_params.setter
    def client_params(self, value) -> None:
        self._store.ingest_param_list(value)

    @property
    def store(self) -> ClientParamStore:
        return self._store

    # ------------------------------------------------------------------
    def run(self, rounds: Optional[int] = None, *,
            draws: Optional[Tuple[np.ndarray, np.ndarray]] = None,
            expiry_uniforms: Optional[np.ndarray] = None) -> History:
        """Run ``rounds`` more rounds (default: the configured count),
        numbered on from ``t_done``, a host loop of gathered device rounds;
        returns a fresh :class:`History` for this leg.  ``draws`` and
        ``expiry_uniforms`` as on the device engine (checked alike; with
        ``draws`` the Generators are not advanced)."""
        c = self.cfg
        T = c.rounds if rounds is None else rounds
        t0 = self.t_done
        tkeys = None
        if draws is not None:
            draws = self._checked_draws(T, draws)
            if self.rng_backend == "jax":  # the rounds' own transmit keys
                tkeys = prng.fold_in(self._round_keys(t0, T, self.device), TRANSMIT_SALT)
        u = self._leg_uniforms(T, expiry_uniforms)
        hist = History()
        if self._telemetry:
            hist.telemetry = obs_device.TelemetryLog()
        for i, t in enumerate(range(t0 + 1, t0 + T + 1)):
            # the round's own draws, one round at a time: a (T, K) stack at
            # K = 10^6 would hold a megabyte a round
            part, idx, tkey = (self._draw_round(t) if draws is None else
                               (draws[0][i], draws[1][i], None if tkeys is None else tkeys[i]))
            self._round(t, hist, part, idx, None if u is None else u[i], tkey)
            if t % c.eval_every == 0 or t == t0 + T:
                self._eval(t, hist)
        self.t_done = t0 + T
        hist.final_server_acc = hist.server_acc[-1] if hist.server_acc else None
        hist.final_client_acc = hist.client_acc[-1] if hist.client_acc else None
        return hist

    def _get_last_sync_dev(self) -> torch.Tensor:
        """The device mirror of ``last_sync``, int32 (the cache's
        timestamps' dtype, as the sorted count needs)."""
        if self._last_sync_dev is None:
            self._last_sync_dev = self._tensor(self.last_sync, torch.int32)
        return self._last_sync_dev

    # ------------------------------------------------------------------
    # The O(K) bookkeeping step: small integer tensors.
    def _bookkeeping_step(self, cache_prev: cache_lib.CacheState,
                          last_sync: torch.Tensor, part: torch.Tensor,
                          t: int) -> Dict[str, Any]:
        """The round's catch-up bytes (the sorted count: the same integer
        counts, and so the same float32 total, as the device engine's
        ``(K, |P|)`` mask), the new ``last_sync`` and, with telemetry on,
        the counters read from the full-width participation."""
        catch_up = 0.0
        if self.use_cache:
            catch_up = cache_lib.catch_up_bytes_device(cache_prev, last_sync, part, t,
                                                       method="sorted")
        out = dict(catch_up=catch_up, last_sync=torch.where(part, t, last_sync))
        if self._telemetry:
            out["telemetry"] = self._telemetry_counters(t, part, last_sync)
        return out

    # ------------------------------------------------------------------
    # The gather plan: per cohort, its active rows in ascending order (so
    # the stack is in the global client order the dense engines use),
    # padded to the next power of two with copies of the first active row.
    # Padding rows weigh exactly 0, train to no purpose, and are dropped
    # at the scatter.
    def _gather_plan(self, part: np.ndarray) -> List[Tuple[int, np.ndarray, np.ndarray]]:
        plan = []
        for ci, sl in enumerate(self.models.slices):
            rows = np.nonzero(part[sl])[0]
            if len(rows) == 0:
                continue
            cap = _next_pow2(len(rows))
            pad = np.concatenate([rows, np.full(cap - len(rows), rows[0], rows.dtype)])
            plan.append((ci, rows, pad))
        return plan

    def _build_step_args(self, t: int, idx: np.ndarray, plan, catch_up,
                         u: Optional[torch.Tensor] = None,
                         tkey: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """The client step's inputs, uploaded (host-to-device copies: made
        before the step, outside the sync guard).  Everything the step
        reads comes through here, so the analyzer can trace it on fake
        tensors."""
        args: Dict[str, Any] = dict(
            t=t, idx=self._tensor(idx, torch.int64), catch_up=catch_up,
            x_pub=self.x_pub, server_params=self.server_params, cache=self.cache_g,
            params=[], xs=[], ys=[], train_mask=[], pv=[])
        het = self.scenario.heterogeneity is not None
        if het:
            args["lr_k"], args["steps_k"] = [], []
            args["decay"] = float(self._lr_decay ** (np.float32(t) - np.float32(1.0)))
        for ci, rows, pad in plan:
            args["params"].append(self._store.gather(ci, pad))
            args["xs"].append(self._tensor(self.xs_c[ci][pad]))
            args["ys"].append(self._tensor(self.ys_c[ci][pad]))
            args["train_mask"].append(self._tensor(self.train_mask_c[ci][pad]))
            pv = np.zeros(len(pad), bool)
            pv[:len(rows)] = True
            args["pv"].append(self._tensor(pv))
            if het:
                args["lr_k"].append(self._tensor(self._lr_k_c[ci][pad]))
                args["steps_k"].append(self._tensor(self._steps_k_c[ci][pad]))
        if self.prev_teacher is not None:
            args["prev_idx"], args["prev_teacher"] = self.prev_teacher
        if u is not None:
            args["u"] = self._tensor(u)
        if tkey is not None:
            args["tkey"] = tkey
        return args

    # ------------------------------------------------------------------
    # The O(m) client step: the device engine's round body on the gathered
    # stack.  Every row with pv set takes part, so nothing is selected;
    # padding rows weigh 0 in every reduction and never scatter back.
    def _client_step(self, args: Dict[str, Any]) -> Dict[str, Any]:
        c = self.cfg
        t, idx, x_pub = args["t"], args["idx"], args["x_pub"]
        params = args["params"]

        # --- clients: distill on the previous teacher, then train ---------
        if "prev_teacher" in args:
            x_prev = x_pub[args["prev_idx"]]
            params = [distill(p, x_prev, args["prev_teacher"], c.lr_dist, c.distill_steps)
                      for p in params]
        if self.scenario.heterogeneity is None:
            params = [local_train(p, x, y, msk, c.lr, c.local_steps)
                      for p, x, y, msk in zip(params, args["xs"], args["ys"],
                                              args["train_mask"])]
        else:
            params = [local_train_masked(p, x, y, msk, lr * args["decay"], st, self._max_steps)
                      for p, x, y, msk, lr, st in zip(params, args["xs"], args["ys"],
                                                      args["train_mask"], args["lr_k"],
                                                      args["steps_k"])]

        # --- the server's side: the device engine's, on the gathered stack -
        pv_f = self.models.concat(args["pv"]).to(torch.float32)
        r = self._server_round(params, pv_f, idx, t, x_pub=x_pub,
                               cache_prev=args["cache"],
                               server_params=args["server_params"], u=args.get("u"),
                               tkey=args.get("tkey"))
        uplink, downlink = self._round_bytes(r, pv_f, args["catch_up"])
        out = dict(client_params=params, server_params=r["server_params"],
                   cache=r["cache"], teacher=r["teacher"], uplink=uplink,
                   downlink=downlink)
        if self._telemetry:
            out["telemetry"] = self._telemetry_gauges(
                t, pv_f, miss=r["miss"], base_present=r["base_present"], z_tx=r["z_tx"],
                z_srv=self._server_view(r["z_tx"], r["z_all"], r["base"],
                                        r["base_present"]),
                fresh=r["fresh"])
        return out

    # ------------------------------------------------------------------
    def _round(self, t: int, hist: History, part: np.ndarray, idx: np.ndarray,
               u: Optional[torch.Tensor], tkey: Optional[torch.Tensor]) -> None:
        if not part.any():  # total outage: nothing moves, the cache ages
            hist.ledger.record(comm_lib.RoundCost(0.0, 0.0))
            if self._telemetry:
                hist.telemetry.append(obs_device.zeros(self.models.n_cohorts))
            return
        part_dev, last_sync = self._tensor(part), self._get_last_sync_dev()
        plan = self._gather_plan(part)
        args = self._build_step_args(t, idx, plan, None, u, tkey)
        with self._sync_guard():
            book = self._bookkeeping_step(self.cache_g, last_sync, part_dev, t)
            args["catch_up"] = book["catch_up"]
            out = self._client_step(args)
            tel = None
            if self._telemetry:
                tel = self._telemetry_row(t, book["telemetry"], out["telemetry"],
                                          uplink=out["uplink"], downlink=out["downlink"],
                                          catch_up=book["catch_up"])

        # one read-back: the valid rows, the ledger pair, the telemetry row
        pieces = [p[name][:len(rows)].reshape(-1)
                  for (ci, rows, _), p in zip(plan, out["client_params"])
                  for name in self._store.leaf_names(ci)]
        pieces += [out["uplink"].reshape(1), out["downlink"].reshape(1)]
        if tel is not None:
            pieces += [leaf.reshape(-1).to(torch.float32) for leaf in tel]
        flat = torch.cat(pieces).cpu().numpy()
        pos = 0
        for (ci, rows, _), p in zip(plan, out["client_params"]):
            rows_new = {}
            for name in self._store.leaf_names(ci):
                shape = (len(rows),) + tuple(p[name].shape[1:])
                n = int(np.prod(shape))
                rows_new[name] = flat[pos:pos + n].reshape(shape)
                pos += n
            self._store.scatter(ci, rows, rows_new)
        hist.ledger.record(comm_lib.RoundCost(float(flat[pos]), float(flat[pos + 1])))
        pos += 2
        if tel is not None:  # counters back to int32 (exact small integers)
            row = []
            for leaf in obs_device.zeros(self.models.n_cohorts):
                n = leaf.numel()
                row.append(flat[pos:pos + n].reshape(tuple(leaf.shape))
                           .astype(leaf.numpy().dtype))
                pos += n
            hist.telemetry.append(obs_device.RoundTelemetry(*row))

        self.server_params = out["server_params"]
        self.cache_g = out["cache"]
        self.prev_teacher = (args["idx"], out["teacher"])
        self._last_sync_dev = book["last_sync"]
        self.last_sync[part] = t

    # ------------------------------------------------------------------
    # Eval and the App.-D proxy teacher: the remaining O(K) compute, in
    # chunks through the store, on the eval schedule only.
    def _iter_chunks(self):
        for ci in range(self.models.n_cohorts):
            size = self.models.sizes[ci]
            for lo in range(0, size, self._eval_chunk):
                rows = slice(lo, min(lo + self._eval_chunk, size))
                yield ci, rows, self._store.gather(ci, rows)

    def _teacher_val_full(self) -> torch.Tensor:
        """The population-mean soft labels on the public validation split:
        the dense engines' ``last_teacher_val``, recomputed from the current
        parameters (it is a function of them) in one chunked pass."""
        x_val = self.x_pub[self.pub_val_idx]
        total = torch.zeros((len(self.pub_val_idx), self.cfg.n_classes), device=self.device)
        for _ci, _rows, p in self._iter_chunks():
            total = total + predict_soft(p, x_val).sum(0)
        return total / self.cfg.n_clients

    @torch.no_grad()
    def _eval(self, t: int, hist: History) -> None:
        """Accuracies and proxies as the dense engines record them; the
        sums stay on the device and come back in one copy."""
        f64 = dict(dtype=torch.float64, device=self.device)
        n_test = len(self.y_test)
        correct = torch.zeros((), **f64)
        for lo in range(0, n_test, _TEST_CHUNK):
            hi = min(lo + _TEST_CHUNK, n_test)
            pred = torch.argmax(apply_mlp(self.server_params,
                                          self._tensor(self.x_test[lo:hi])), dim=-1)
            correct = correct + (pred == self._tensor(self.y_test[lo:hi])).sum()
        acc_sum = [torch.zeros((), **f64) for _ in range(self.models.n_cohorts)]
        vl_sum = torch.zeros((), **f64)
        for ci, rows, p in self._iter_chunks():
            acc_sum[ci] = acc_sum[ci] + accuracy(
                p, self._tensor(self.xts_c[ci][rows]), self._tensor(self.yts_c[ci][rows]),
                self._tensor(self.tmask_c[ci][rows])).to(torch.float64).sum()
            vl_sum = vl_sum + val_loss_hard(
                p, self._tensor(self.xs_c[ci][rows]), self._tensor(self.ys_c[ci][rows]),
                self._tensor(self.val_mask_c[ci][rows])).to(torch.float64).sum()
        vals = [correct, vl_sum] + acc_sum
        if self.prev_teacher is not None:
            self.last_teacher_val = self._teacher_val_full()
            vals.append(val_loss_soft(self.server_params, self.x_pub[self.pub_val_idx],
                                      self.last_teacher_val).to(torch.float64))
        got = torch.stack(vals).cpu().numpy()
        sizes = self.models.sizes
        hist.rounds.append(t)
        hist.server_acc.append(float(got[0] / n_test))
        hist.client_acc.append(float(got[2:2 + len(sizes)].sum() / self.cfg.n_clients))
        hist.cohort_client_acc.append([float(a / n) for a, n in zip(got[2:], sizes)])
        hist.cumulative_mb.append(hist.ledger.cumulative_total / 1e6)
        if self.prev_teacher is not None:
            hist.server_val_loss.append(float(got[-1]))
        hist.client_val_loss.append(float(got[1] / self.cfg.n_clients))

    # ------------------------------------------------------------------
    # Checkpoints: the shared plumbing over the store-backed client_params;
    # the proxy teacher is recomputed at save time.
    def state_dict(self) -> Dict[str, Any]:
        self.last_teacher_val = (self._teacher_val_full()
                                 if self.prev_teacher is not None else None)
        return super().state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        self._last_sync_dev = self._tensor(self.last_sync, torch.int32)

    # ------------------------------------------------------------------
    # The analyzer's entry (repro_torch.analysis.active_checks).
    def active_round_fns(self):
        """``[(label, fn, args), ...]`` for the bookkeeping and the client
        step, with real example arguments of round 1 (the Generators are
        left as they were).  The client step's args carry a zero previous
        teacher, so its distillation branch is in the traced code."""
        c = self.cfg
        saved_rng = (self.rng_idx.bit_generator.state, self.rng_part.bit_generator.state)
        try:
            part, idx, tkey = self._draw_round(1)
        finally:
            self.rng_idx.bit_generator.state, self.rng_part.bit_generator.state = saved_rng
        if not part.any():
            part = part.copy()
            part[:min(2, len(part))] = True
        book_args = (self.cache_g, self._get_last_sync_dev(), self._tensor(part), 1)
        u = (np.zeros(c.public_per_round, np.float32)
             if self.use_cache and self.probabilistic_expiry else None)
        saved = self.prev_teacher
        self.prev_teacher = (torch.zeros(c.public_per_round, dtype=torch.int64,
                                         device=self.device),
                             torch.zeros((c.public_per_round, c.n_classes),
                                         device=self.device))
        try:
            step_args = self._build_step_args(
                1, idx, self._gather_plan(part),
                torch.zeros((), dtype=torch.float32, device=self.device), u, tkey)
        finally:
            self.prev_teacher = saved
        return [("bookkeeping", self._bookkeeping_step, book_args),
                ("client-step", self._client_step, (step_args,))]
