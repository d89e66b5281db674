"""The host round loop and its client primitives (counterpart of
``repro.fl.rounds``, ``engine="host"``).

Client parameters are a list with one stacked ``(n, a, c)`` dict per
cohort; every primitive runs a whole cohort at once with batched matrix
products, and ``torch.autograd`` takes the per-client gradients (the
gradient of the sum of the clients' losses is each client's own gradient,
since no parameter is shared).

Workflow per round t (SCARLET Alg. 1, any participation scenario):
  1. draw P^t and the participation mask from the numpy Generators
     (bit-identical to the reference's ``rng_backend="numpy"`` stream);
  2. participating clients distill on the previous round's teacher, then
     train locally on their private shard;
  3. clients emit soft-labels on P^t; the strategy's ``transmit`` (CFD:
     the quantize-dequantize kernel) and the uplink codec's round trip
     give what the server sees, and the strategy's upload mask what each
     client sends (Selective-FD);
  4. the strategy aggregates the participants' stack (SCARLET: the fused
     ERA kernel); the teacher is assembled from fresh and cached entries,
     the global cache updated, the server model distilled;
  5. the ledger records exact bytes, catch-up packages included.

Entry points run on ``device="cuda"`` by default and raise when there is
no CUDA device; ``device="cpu"`` runs every kernel's plain version.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.compress import get_codec
from repro_torch.core import cache as cache_lib
from repro_torch.core import comm as comm_lib
from repro_torch.data.synthetic import (
    dirichlet_partition,
    make_public_private,
    pad_client_shards,
    uniform_client_shards,
)
from repro_torch.fl.cohorts import ClientModels, resolve_cohorts
from repro_torch.fl.config import FLConfig
from repro_torch.fl.convert import params_from_numpy
from repro_torch.fl.scenarios import Scenario
from repro_torch.fl.strategies.base import Strategy
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.resnet import Params, apply_mlp, init_mlp

__all__ = ["local_train", "distill", "predict_soft", "accuracy",
           "val_loss_soft", "val_loss_hard", "History",
           "FederatedDistillation"]


# ---------------------------------------------------------------------------
# Client primitives.  Each takes one model (``w`` of shape (a, c)) or a
# stack of K models (``(K, a, c)``) and returns one value per model.
# ---------------------------------------------------------------------------

def _ce(params: Params, x, y, mask) -> torch.Tensor:
    """Masked mean cross-entropy per model."""
    logp = torch.log_softmax(apply_mlp(params, x), dim=-1)
    nll = -logp.gather(-1, y.unsqueeze(-1)).squeeze(-1)
    return (nll * mask).sum(-1) / torch.clamp_min(mask.sum(-1), 1.0)


def _kl(params: Params, x, teacher) -> torch.Tensor:
    """Mean KL(teacher || student) per model; ``teacher`` is (m, N)
    shared or (K, m, N) per client."""
    logp = torch.log_softmax(apply_mlp(params, x), dim=-1)
    t = torch.clamp(teacher, 1e-12, 1.0)
    return (t * (torch.log(t) - logp)).sum(-1).mean(-1)


def _sgd(loss: Callable[[Params], torch.Tensor], params: Params,
         lr: float, steps: int) -> Params:
    with torch.enable_grad():
        for _ in range(steps):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            grads = torch.autograd.grad(loss(leaves).sum(),
                                        list(leaves.values()))
            params = {k: v.detach() - lr * g
                      for (k, v), g in zip(leaves.items(), grads)}
    return params


def local_train(params: Params, x, y, mask, lr: float, steps: int) -> Params:
    """``steps`` full-batch SGD steps on the masked private CE."""
    return _sgd(lambda p: _ce(p, x, y, mask), params, lr, steps)


def distill(params: Params, x, teacher, lr: float, steps: int) -> Params:
    """``steps`` SGD steps on KL(teacher || model) over the public rows."""
    return _sgd(lambda p: _kl(p, x, teacher), params, lr, steps)


@torch.no_grad()
def predict_soft(params: Params, x) -> torch.Tensor:
    return torch.softmax(apply_mlp(params, x), dim=-1)


@torch.no_grad()
def val_loss_soft(params: Params, x, teacher) -> torch.Tensor:
    """Server-side proxy metric (App. D): distillation loss on a held-out
    public validation split."""
    return _kl(params, x, teacher)


@torch.no_grad()
def val_loss_hard(params: Params, x, y, mask) -> torch.Tensor:
    """Client-side proxy metric (App. D): CE on a held-out private
    validation split."""
    return _ce(params, x, y, mask)


@torch.no_grad()
def accuracy(params: Params, x, y, mask) -> torch.Tensor:
    pred = torch.argmax(apply_mlp(params, x), dim=-1)
    ok = (pred == y).to(torch.float32) * mask
    return ok.sum(-1) / torch.clamp_min(mask.sum(-1), 1.0)


def _select(new: Params, old: Params, keep: torch.Tensor) -> Params:
    """Per-client update gating (partial participation)."""
    return {k: torch.where(keep.view((-1,) + (1,) * (v.dim() - 1)), v, old[k])
            for k, v in new.items()}


def _select_cohorts(new: List[Params], old: List[Params],
                    masks: List[torch.Tensor]) -> List[Params]:
    """``_select`` over per-cohort param lists (masks pre-split)."""
    return [_select(n, o, m) for n, o, m in zip(new, old, masks)]


# ---------------------------------------------------------------------------
# History
# ---------------------------------------------------------------------------

@dataclass
class History:
    rounds: List[int] = field(default_factory=list)
    server_acc: List[float] = field(default_factory=list)
    client_acc: List[float] = field(default_factory=list)
    cumulative_mb: List[float] = field(default_factory=list)
    # Appendix-D proxy metrics (no test labels required in deployment)
    server_val_loss: List[float] = field(default_factory=list)
    client_val_loss: List[float] = field(default_factory=list)
    # per-cohort mean client accuracy, one row per eval round
    cohort_client_acc: List[List[float]] = field(default_factory=list)
    ledger: comm_lib.CommLedger = field(default_factory=comm_lib.CommLedger)
    # None when the leg never evaluated that model (a zero-round leg)
    final_server_acc: Optional[float] = None
    final_client_acc: Optional[float] = None

    def as_dict(self) -> Dict[str, Any]:
        return {
            "rounds": self.rounds,
            "server_acc": self.server_acc,
            "client_acc": self.client_acc,
            "cumulative_mb": self.cumulative_mb,
            "server_val_loss": self.server_val_loss,
            "client_val_loss": self.client_val_loss,
            "cohort_client_acc": self.cohort_client_acc,
            "comm": self.ledger.summary(),
            "final_server_acc": self.final_server_acc,
            "final_client_acc": self.final_client_acc,
        }


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class FederatedDistillation:
    """Distillation-based FL run (any ported strategy) with optional
    soft-label caching and participation/outage scenarios, on one
    device.

    P^t and participation come from two numpy Generators seeded as the
    reference's host loop seeds them, so a port run and a reference run
    with ``rng_backend="numpy"`` see identical draws, and their ledgers
    are byte-identical.  Initial parameters come from a CPU
    ``torch.Generator`` seeded with ``cfg.seed`` (the same numbers on
    every device); :meth:`load_params` installs the reference's instead.
    """

    def __init__(self, cfg: FLConfig, strategy: Strategy,
                 cache_duration: int = 0, use_cache: Optional[bool] = None,
                 probabilistic_expiry: bool = False,
                 scenario: Optional[Scenario] = None,
                 track_local_caches: bool = False,
                 rng_backend: str = "numpy",
                 device="cuda"):
        if rng_backend == "jax":
            raise NotImplementedError("rng_backend='jax' is not yet ported")
        if rng_backend != "numpy":
            raise ValueError(f"unknown rng_backend: {rng_backend!r}")
        if track_local_caches:
            raise NotImplementedError("track_local_caches is not yet ported")
        if probabilistic_expiry:
            raise NotImplementedError("probabilistic expiry is not yet ported")
        if cfg.telemetry:
            raise NotImplementedError("telemetry is not yet ported")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.strategy = strategy
        self.D = cache_lib.normalize_cache_duration(cache_duration)
        self.use_cache = strategy.uses_cache if use_cache is None else use_cache
        if self.D == 0:
            self.use_cache = False
        self.scenario = scenario or Scenario.from_participation_rate(cfg.participation)
        self.codec_up = get_codec(cfg.uplink_codec)
        self.codec_down = get_codec(cfg.downlink_codec)
        self.rng_idx = np.random.default_rng([cfg.seed, 17])
        self.rng_part = np.random.default_rng([cfg.seed, 29])
        self._setup()

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def _partition_clients(self, x, y, seed: int):
        """Per-client shards in the dense ``(xs, ys, mask)`` layout."""
        c = self.cfg
        if c.partition == "uniform":
            return uniform_client_shards(x, y, c.n_clients)
        if c.partition != "dirichlet":
            raise ValueError(f"unknown partition {c.partition!r} "
                             "(want 'dirichlet' or 'uniform')")
        parts = dirichlet_partition(y, c.n_clients, c.alpha, seed=seed)
        return pad_client_shards(x, y, parts)

    def _setup(self) -> None:
        c = self.cfg
        data = make_public_private(c.private_size, c.public_size, c.n_classes,
                                   c.dim, seed=c.seed,
                                   cluster_scale=c.cluster_scale, noise=c.noise)
        self.data = data
        xs, ys, mask = self._partition_clients(
            data["x_private"], data["y_private"], seed=c.seed)
        xts, yts, tmask = self._partition_clients(
            data["x_test"], data["y_test"], seed=c.seed + 7)
        self.x_pub = self._tensor(data["x_public"])
        self.x_test = self._tensor(data["x_test"])
        self.y_test = self._tensor(data["y_test"], torch.int64)

        self.models = ClientModels(resolve_cohorts(c), c.dim, c.n_classes)
        gen = torch.Generator().manual_seed(c.seed)
        clients = self.models.init_params(gen)
        server = init_mlp(gen, c.dim, c.n_classes, c.hidden, c.mlp_depth)
        self.client_params = [{k: self._tensor(v) for k, v in p.items()}
                              for p in clients]
        self.server_params = {k: self._tensor(v) for k, v in server.items()}

        # Appendix-D validation splits: 10% of public for the server proxy,
        # the last 10% of each client's private shard for the client proxy
        # (the cut computed in float32, as the reference computes it)
        n_pub_val = max(c.public_size // 10, 10)
        self.pub_val_idx = self._tensor(
            np.random.default_rng(c.seed + 99).choice(
                c.public_size, n_pub_val, replace=False), torch.int64)
        counts = mask.sum(1).astype(np.float32)
        val_cut = np.maximum((counts * np.float32(0.9)).astype(np.int32), 1)
        pos = np.arange(mask.shape[1])[None, :]
        val_mask = mask & (pos >= val_cut[:, None])
        train_mask = mask & (pos < val_cut[:, None])
        m = self.models
        f32 = torch.float32
        self.xs_c = m.split(self._tensor(xs))
        self.ys_c = m.split(self._tensor(ys, torch.int64))
        self.train_mask_c = m.split(self._tensor(train_mask, f32))
        self.val_mask_c = m.split(self._tensor(val_mask, f32))
        self.xts_c = m.split(self._tensor(xts))
        self.yts_c = m.split(self._tensor(yts, torch.int64))
        self.tmask_c = m.split(self._tensor(tmask, f32))
        self.last_teacher_val: Optional[torch.Tensor] = None

        self.cache_g = cache_lib.init_cache(c.public_size, c.n_classes,
                                            device=self.device)
        self.prev_teacher = None  # (idx tensor, (m, N) teacher)
        self.last_sync = np.zeros(c.n_clients, np.int64)  # last participated round
        self.t_done = 0  # rounds completed so far (run() continues from here)

    def load_params(self, client_params, server_params) -> None:
        """Install given initial parameters (numpy dicts, e.g. the
        reference's) in place of the port's own; see
        :func:`repro_torch.fl.convert.params_from_numpy`."""
        clients, server = params_from_numpy(client_params, server_params,
                                            self.device)
        for new, old in zip(clients + [server],
                            self.client_params + [self.server_params]):
            got = {k: tuple(v.shape) for k, v in new.items()}
            want = {k: tuple(v.shape) for k, v in old.items()}
            if got != want:
                raise ValueError(f"parameter shapes {got} do not match the "
                                 f"configured model {want}")
        if len(clients) != len(self.client_params):
            raise ValueError(f"{len(clients)} cohorts given, "
                             f"{len(self.client_params)} configured")
        self.client_params, self.server_params = clients, server

    # ------------------------------------------------------------------
    def run(self, rounds: Optional[int] = None) -> History:
        """Run ``rounds`` more rounds (default: the configured count),
        numbered on from ``t_done``; returns a fresh :class:`History`
        covering only this leg."""
        c = self.cfg
        hist = History()
        T = c.rounds if rounds is None else rounds
        t_end = self.t_done + T
        for t in range(self.t_done + 1, t_end + 1):
            self._round(t, hist)
            if t % c.eval_every == 0 or t == t_end:
                self._eval(t, hist)
        self.t_done = t_end
        hist.final_server_acc = hist.server_acc[-1] if hist.server_acc else None
        hist.final_client_acc = hist.client_acc[-1] if hist.client_acc else None
        return hist

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """All cross-round simulation state, in a fixed structure: absent
        optionals are zero placeholders with ``have_*`` flags, as in the
        reference.  The device engine runs its rounds on this dict.  The
        stateful numpy Generators are not part of it."""
        c = self.cfg
        if self.prev_teacher is not None:
            prev_idx, prev_teacher = self.prev_teacher
            have_prev = True
        else:
            prev_idx = torch.zeros(c.public_per_round, dtype=torch.int64,
                                   device=self.device)
            prev_teacher = torch.zeros((c.public_per_round, c.n_classes),
                                       device=self.device)
            have_prev = False
        if self.last_teacher_val is not None:
            teacher_val, have_tv = self.last_teacher_val, True
        else:
            teacher_val = torch.zeros((len(self.pub_val_idx), c.n_classes),
                                      device=self.device)
            have_tv = False
        flag = lambda b: torch.full((), b, device=self.device)  # noqa: E731
        return dict(
            t_done=torch.tensor(self.t_done, dtype=torch.int32),
            client_params=self.client_params,
            server_params=self.server_params,
            cache=self.cache_g,
            prev_idx=prev_idx,
            prev_teacher=prev_teacher,
            have_prev=flag(have_prev),
            teacher_val=teacher_val,
            have_tv=flag(have_tv),
            last_sync=self._tensor(self.last_sync, torch.int32),
        )

    # ------------------------------------------------------------------
    # Per-cohort client steps, shared by the host loop and the device
    # engine.
    def _distill_all(self, params: List[Params], x_prev,
                     pteach) -> List[Params]:
        """Every cohort distilled on the shared ``(m, N)`` teacher."""
        c = self.cfg
        return [distill(p, x_prev, pteach, c.lr_dist, c.distill_steps)
                for p in params]

    def _local_train_all(self, params: List[Params]) -> List[Params]:
        """Every cohort's local training on its private shards."""
        c = self.cfg
        return [local_train(p, self.xs_c[i], self.ys_c[i],
                            self.train_mask_c[i], c.lr, c.local_steps)
                for i, p in enumerate(params)]

    def _predict_all(self, params: List[Params], x) -> torch.Tensor:
        """``(K, |x|, N)`` soft predictions in global client order."""
        return self.models.concat([predict_soft(p, x) for p in params])

    def _draw_round(self, t: int):
        """(participation mask, sorted P^t indices) for round ``t`` from
        the two numpy Generators (the reference's numpy stream)."""
        c = self.cfg
        part = self.scenario.participation_mask(t, c.n_clients, self.rng_part)
        # P^t is drawn from its own stream *before* any participation
        # branching so every scenario sees the identical subset sequence.
        idx = np.sort(self.rng_idx.choice(c.public_size, c.public_per_round,
                                          replace=False))
        return part, idx

    def _round(self, t: int, hist: History) -> None:
        c, s = self.cfg, self.strategy
        K = c.n_clients
        part, idx = self._draw_round(t)
        n_part = int(part.sum())
        if n_part == 0:  # total outage: nothing moves, the cache ages
            hist.ledger.record(comm_lib.RoundCost(0.0, 0.0))
            return
        idx_t = self._tensor(idx, torch.int64)
        part_t = self._tensor(part)
        part_c = self.models.split(part_t)

        # --- clients: distill on previous teacher, then local training ----
        params = self.client_params
        if self.prev_teacher is not None:
            pidx, pteach = self.prev_teacher
            params = _select_cohorts(
                self._distill_all(params, self.x_pub[pidx], pteach),
                params, part_c)
        self.client_params = _select_cohorts(
            self._local_train_all(params), params, part_c)

        # --- request list (cache) ----------------------------------------
        if self.use_cache:
            miss = cache_lib.miss_mask(self.cache_g, idx_t, t, self.D)
        else:
            miss = torch.ones(len(idx), dtype=torch.bool, device=self.device)
        n_req = int(miss.sum())
        # shared delta-coding base: the synchronized cache at P^t (pre-update)
        base, base_present = cache_lib.cached_at(self.cache_g, idx_t)

        # --- uplink: soft-labels on requested samples ---------------------
        x_round = self.x_pub[idx_t]
        z_all = self._predict_all(self.client_params, x_round)  # (K, m, N)
        z_all = s.transmit(z_all)  # the method's uplink transform (CFD)
        if not self.codec_up.is_identity:  # lossy wire: what the server sees
            z_all = self.codec_up.roundtrip(z_all, base=base,
                                            present=base_present)
        um = s.upload_mask(z_all)  # (K, m) or None (Selective-FD)
        # only participating clients contribute
        zsel = z_all[part_t] if n_part < K else z_all
        umsel = None if um is None else (um[part_t] if n_part < K else um)
        fresh, per_client = s.aggregate(zsel, umsel, t)
        if per_client is not None:
            raise NotImplementedError(
                "per-client teachers (COMET) are not yet ported")
        if not self.codec_down.is_identity:
            # clients receive (and cache) the decoded broadcast; the server
            # uses the same decoded teacher so both caches stay identical
            fresh = self.codec_down.roundtrip(fresh, base=base,
                                              present=base_present)

        # --- assemble teacher + cache update ------------------------------
        cache_prev = self.cache_g  # pre-round state: catch-up covers <= t-1
        if self.use_cache:
            teacher = cache_lib.assemble_teacher(self.cache_g, idx_t, fresh, miss)
            self.cache_g, _ = cache_lib.update_global_cache(
                self.cache_g, idx_t, teacher, miss, t)
        else:
            teacher = fresh

        # --- server distillation ------------------------------------------
        self.server_params = distill(self.server_params, x_round, teacher,
                                     c.lr_dist, c.distill_steps)
        # App.-D proxy teacher on the public validation split
        zv = self._predict_all(self.client_params, self.x_pub[self.pub_val_idx])
        self.last_teacher_val = zv.mean(0)
        self.prev_teacher = (idx_t, teacher)

        # --- catch-up packages for returning stragglers --------------------
        catch_up = 0.0
        if self.use_cache:
            for k in np.nonzero(part)[0]:
                if self.last_sync[k] < t - 1:
                    pkg = cache_lib.make_catch_up(cache_prev, int(self.last_sync[k]))
                    catch_up += cache_lib.catch_up_bytes(pkg)

        # --- communication accounting --------------------------------------
        # an upload mask gates the uplink only: each participant sends its
        # uploaded entries among the requested samples (a per-client mean,
        # possibly fractional), while the downlink still carries every
        # requested sample
        n_up = float(n_req)
        if umsel is not None:
            uploaded = float((umsel.to(torch.float32)
                              * miss.to(torch.float32)[None, :]).sum())
            n_up = uploaded / max(n_part, 1)
        cost = comm_lib.distillation_round_cost(
            n_clients=n_part,
            n_selected=len(idx),
            n_up_samples=n_up,
            n_down_samples=n_req,
            n_classes=c.n_classes,
            uplink_bits=s.uplink_bits,
            downlink_bits=s.downlink_bits,
            with_cache_signals=self.use_cache,
            catch_up_down=catch_up,
            bytes_index=c.index_bytes,
            uplink_codec=self.codec_up,
            downlink_codec=self.codec_down,
        )
        hist.ledger.record(cost)
        self.last_sync[part] = t

    # ------------------------------------------------------------------
    def _eval_metrics(self, client_params: List[Params], server_params: Params,
                      teacher_val: Optional[torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """Eval metrics as 0-dim device tensors (``cohort_acc``: one per
        cohort): accuracies on the test shards and the Appendix-D proxies,
        computable in deployment without test labels (``server_val`` is
        None without a proxy teacher)."""
        sa = accuracy(server_params, self.x_test, self.y_test,
                      torch.ones(len(self.y_test), device=self.device))
        accs = [accuracy(p, self.xts_c[i], self.yts_c[i], self.tmask_c[i])
                for i, p in enumerate(client_params)]
        sv = (None if teacher_val is None else
              val_loss_soft(server_params, self.x_pub[self.pub_val_idx],
                            teacher_val))
        cv = torch.mean(self.models.concat(
            [val_loss_hard(p, self.xs_c[i], self.ys_c[i], self.val_mask_c[i])
             for i, p in enumerate(client_params)]))
        return dict(server_acc=sa,
                    client_acc=torch.mean(self.models.concat(accs)),
                    cohort_acc=torch.stack([torch.mean(a) for a in accs]),
                    server_val=sv, client_val=cv)

    def _eval(self, t: int, hist: History) -> None:
        e = self._eval_metrics(self.client_params, self.server_params,
                               self.last_teacher_val)
        hist.rounds.append(t)
        hist.server_acc.append(float(e["server_acc"]))
        hist.client_acc.append(float(e["client_acc"]))
        hist.cohort_client_acc.append([float(a) for a in e["cohort_acc"]])
        hist.cumulative_mb.append(hist.ledger.cumulative_total / 1e6)
        if e["server_val"] is not None:
            hist.server_val_loss.append(float(e["server_val"]))
        hist.client_val_loss.append(float(e["client_val"]))
