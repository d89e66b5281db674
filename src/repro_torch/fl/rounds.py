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
     train locally on their private shard (under a ``Heterogeneity``
     every client runs the longest schedule's step count and applies only
     its own first E_k steps, at its own rate, as the reference's
     ``local_train_masked`` does);
  3. clients emit soft-labels on P^t; the strategy's ``transmit`` (CFD:
     the quantize-dequantize kernel) and the uplink codec's round trip
     give what the server sees, and the strategy's upload mask what each
     client sends (Selective-FD);
  4. the strategy aggregates the participants' stack (SCARLET: the fused
     ERA kernel; COMET: per-cluster teachers, which the clients distill on
     next round, through the downlink codec like the shared teacher); the
     teacher is assembled from fresh and cached entries, the global cache
     updated, the server model distilled;
  5. the ledger records exact bytes, catch-up packages included.

Telemetry (``FLConfig.telemetry``) appends one
:class:`repro_torch.obs.device.RoundTelemetry` row a round to
``History.telemetry`` (:meth:`FederatedDistillation._telemetry_row`,
shared with the device engine): an observation that leaves the run bit
for bit as it is without it.

Probabilistic expiry (``probabilistic_expiry=True``) tests each request
against a uniform of the round.  The reference draws them from its jax
key ``fold_in(PRNGKey(seed), t)``; the port, which has no jax stream,
draws them from the stateless numpy stream
``default_rng([seed, EXPIRY_SALT, t])`` or takes the leg's ``(T, m)``
stack from ``run(expiry_uniforms=...)`` (e.g. the reference's).

Entry points run on ``device="cuda"`` by default and raise when there is
no CUDA device; ``device="cpu"`` runs every kernel's plain version.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

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
from repro_torch.obs import device as obs_device

__all__ = ["local_train", "local_train_masked", "distill", "predict_soft",
           "accuracy", "val_loss_soft", "val_loss_hard", "History",
           "FederatedDistillation", "EXPIRY_SALT"]

# the default expiry uniforms of round t: default_rng([seed, EXPIRY_SALT, t])
EXPIRY_SALT = 71


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
         rates: Iterable) -> Params:
    """One SGD step for each rate in ``rates``: a float, or a ``(K,)``
    tensor of per-model rates for a stack of K models."""
    with torch.enable_grad():
        for lr in rates:
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            grads = torch.autograd.grad(loss(leaves).sum(),
                                        list(leaves.values()))
            params = {k: v.detach() - _per_model(lr, v) * g
                      for (k, v), g in zip(leaves.items(), grads)}
    return params


def _per_model(lr, v: torch.Tensor):
    """A ``(K,)`` rate laid along the model axis of a ``(K, ...)`` leaf."""
    if isinstance(lr, torch.Tensor):
        return lr.view((-1,) + (1,) * (v.dim() - 1))
    return lr


def local_train(params: Params, x, y, mask, lr: float, steps: int) -> Params:
    """``steps`` full-batch SGD steps on the masked private CE."""
    return _sgd(lambda p: _ce(p, x, y, mask), params, [lr] * steps)


def local_train_masked(params: Params, x, y, mask, lr: torch.Tensor,
                       n_steps: torch.Tensor, max_steps: int) -> Params:
    """Heterogeneous schedules over a stack of K models (reference
    ``local_train_masked``): ``max_steps`` gradient steps, of which model
    k applies the first ``n_steps[k]`` at rate ``lr[k]`` and the rest at
    rate 0 (both ``(K,)`` tensors on the models' device), so a model with
    ``n_steps[k] == 0`` leaves local training bit for bit unchanged."""
    rates = (torch.where(n_steps > i, lr, 0.0) for i in range(max_steps))
    return _sgd(lambda p: _ce(p, x, y, mask), params, rates)


def distill(params: Params, x, teacher, lr: float, steps: int) -> Params:
    """``steps`` SGD steps on KL(teacher || model) over the public rows."""
    return _sgd(lambda p: _kl(p, x, teacher), params, [lr] * steps)


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
    # per-round telemetry when the run had FLConfig.telemetry on; None
    # otherwise.  Not part of state_dict: an observation of one leg, like
    # the ledger.
    telemetry: Optional[obs_device.TelemetryLog] = None

    def as_dict(self) -> Dict[str, Any]:
        out = {
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
        if self.telemetry is not None:
            out["telemetry"] = self.telemetry.as_dict()
        return out


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

    ``track_local_caches=True`` (host loop only) mirrors each client's
    local cache, updated from the broadcast queue and the signals as
    Alg. 2 has the client do it, catch-up packages applied on return, in
    ``local_caches``: a check that the synchronized caches stay equal to
    the global one.

    ``cfg.telemetry`` turns on the per-round telemetry rows;
    ``telemetry_hook``, if set, is a pure tensor transform ``(tel, t) ->
    tel`` applied to each row inside the round (on the device engine it
    must not read the card: its rounds run under the sync guard).
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
        self.device = resolve_device(device)
        self.cfg = cfg
        self.strategy = strategy
        self.D = cache_lib.normalize_cache_duration(cache_duration)
        self.use_cache = strategy.uses_cache if use_cache is None else use_cache
        if self.D == 0:
            self.use_cache = False
        self.probabilistic_expiry = probabilistic_expiry
        self.track_local_caches = track_local_caches
        self.scenario = scenario or Scenario.from_participation_rate(cfg.participation)
        self.codec_up = get_codec(cfg.uplink_codec, index_bytes=cfg.index_bytes)
        self.codec_down = get_codec(cfg.downlink_codec, index_bytes=cfg.index_bytes)
        self._telemetry = bool(cfg.telemetry)
        self.telemetry_hook = None
        self._seed_generators()
        self._setup()

    def _seed_generators(self) -> None:
        """The two numpy Generators of the draws, as the reference seeds
        them (P^t, participation)."""
        self.rng_idx = np.random.default_rng([self.cfg.seed, 17])
        self.rng_part = np.random.default_rng([self.cfg.seed, 29])

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
        self.n_params = sum(v.numel() for v in self.server_params.values())

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
        # the whole private shards and test shards (the baselines train
        # and test on these), and their per-cohort views
        self.xs, self.ys = self._tensor(xs), self._tensor(ys, torch.int64)
        self.mask = self._tensor(mask, f32)
        self.xts, self.yts = self._tensor(xts), self._tensor(yts, torch.int64)
        self.tmask = self._tensor(tmask, f32)
        self.xs_c, self.ys_c = m.split(self.xs), m.split(self.ys)
        self.train_mask_c = m.split(self._tensor(train_mask, f32))
        self.val_mask_c = m.split(self._tensor(val_mask, f32))
        self.xts_c, self.yts_c = m.split(self.xts), m.split(self.yts)
        self.tmask_c = m.split(self.tmask)
        self.last_teacher_val: Optional[torch.Tensor] = None

        self.cache_g = cache_lib.init_cache(c.public_size, c.n_classes,
                                            device=self.device)
        self.local_caches: List[cache_lib.CacheState] = [
            cache_lib.init_cache(c.public_size, c.n_classes, device=self.device)
            for _ in range(c.n_clients)] if self.track_local_caches else []
        self.prev_teacher = None  # (idx tensor, (m, N) or per-client (K, m, N) teacher)
        self.last_sync = np.zeros(c.n_clients, np.int64)  # last participated round
        self.t_done = 0  # rounds completed so far (run() continues from here)

        # heterogeneous schedules, resolved once on the host and uploaded
        # per cohort: no round reads them back
        het = self.scenario.heterogeneity
        if het is not None:
            lr_k, steps_k, self._max_steps = het.resolve(c.n_clients, c.lr,
                                                         c.local_steps)
            self._lr_k_c = m.split(self._tensor(lr_k, torch.float32))
            self._steps_k_c = m.split(self._tensor(steps_k, torch.int32))
            self._lr_decay = np.float32(het.lr_decay)

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
    def run(self, rounds: Optional[int] = None, *,
            expiry_uniforms: Optional[np.ndarray] = None) -> History:
        """Run ``rounds`` more rounds (default: the configured count),
        numbered on from ``t_done``; returns a fresh :class:`History`
        covering only this leg.  ``expiry_uniforms`` (probabilistic expiry
        only): the leg's ``(T, m)`` float32 uniforms, row ``i`` for round
        ``t_done + 1 + i``, in place of the default stream's."""
        c = self.cfg
        hist = History()
        if self._telemetry:
            hist.telemetry = obs_device.TelemetryLog()
        T = c.rounds if rounds is None else rounds
        t_end = self.t_done + T
        u = self._leg_uniforms(T, expiry_uniforms)
        for i, t in enumerate(range(self.t_done + 1, t_end + 1)):
            self._round(t, hist, None if u is None else u[i])
            if t % c.eval_every == 0 or t == t_end:
                self._eval(t, hist)
        self.t_done = t_end
        hist.final_server_acc = hist.server_acc[-1] if hist.server_acc else None
        hist.final_client_acc = hist.client_acc[-1] if hist.client_acc else None
        return hist

    def expiry_uniforms(self, t: int) -> np.ndarray:
        """Round ``t``'s default expiry uniforms, ``(m,)`` float32 in [0, 1):
        a stateless stream keyed by (seed, ``EXPIRY_SALT``, t), as the
        reference's key ``fold_in(PRNGKey(seed), t)`` is, so a restored
        or split run draws the same ones."""
        rng = np.random.default_rng([self.cfg.seed, EXPIRY_SALT, t])
        return rng.random(self.cfg.public_per_round, dtype=np.float32)

    def _leg_uniforms(self, T: int, given) -> Optional[np.ndarray]:
        """The leg's ``(T, m)`` expiry uniforms: ``given`` (checked) or the
        default stream's; None when expiry is deterministic."""
        if not (self.use_cache and self.probabilistic_expiry):
            if given is not None:
                raise ValueError("expiry_uniforms apply to probabilistic expiry "
                                 "with the cache on")
            return None
        m = self.cfg.public_per_round
        if given is None:
            ts = range(self.t_done + 1, self.t_done + T + 1)
            return np.stack([self.expiry_uniforms(t) for t in ts]).reshape(T, m)
        u = np.asarray(given)
        if u.shape != (T, m) or u.dtype != np.float32:
            raise ValueError(f"expiry_uniforms must be ({T}, {m}) float32, got "
                             f"{u.shape} {u.dtype}")
        return u

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """All cross-round simulation state, in a fixed structure: absent
        optionals are zero placeholders with ``have_*`` flags, with the
        reference's keys and dtypes, so :mod:`repro_torch.checkpoint`
        files move between the two packages.  The device engine runs its
        rounds on this dict.  The numpy Generators and the mirrored local
        caches are not part of it (see :meth:`load_state_dict`)."""
        c = self.cfg
        if self.prev_teacher is not None:
            prev_idx, prev_teacher = self.prev_teacher
            if prev_teacher.dim() == 3:
                # per-client (K, m, N) teachers (COMET) do not fit the
                # fixed (m, N) slot of a fresh engine's like-tree
                raise ValueError(
                    "per-client prev_teacher stacks (COMET) are not "
                    "checkpointable; state_dict supports shared-teacher "
                    "strategies only")
            prev_idx = prev_idx.to(torch.int32)
            have_prev = True
        else:
            prev_idx = torch.zeros(c.public_per_round, dtype=torch.int32,
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

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore a :meth:`state_dict` snapshot (the port's or, through
        :func:`repro_torch.checkpoint.load_pytree`, the reference's); the
        next ``run()`` continues as the uninterrupted run would.

        One deliberate difference from the reference, which restores only
        under its stateless jax key stream and refuses the numpy one: the
        port has only the numpy stream, so the restore re-seeds both
        Generators as the constructor does and replays the draws of
        rounds 1..``t_done`` (``_draw_round``; a few host draws a round).
        A restored engine then continues exactly as one whose legs drew
        their own draws.  A leg run with injected ``draws=`` (device
        engine) does not advance the Generators, so its continuation must
        be given ``draws=`` too.  The default expiry uniforms are
        stateless and need no replay.  The snapshot's keys stay the
        reference's."""
        if self.track_local_caches:
            # mirrored per-client caches are not captured: a restored
            # engine would check cold mirrors against a warm global cache
            raise ValueError(
                "track_local_caches state is not checkpointed; restore "
                "into an engine with track_local_caches=False")
        on = lambda v: torch.as_tensor(v).to(self.device)  # noqa: E731
        self.t_done = int(state["t_done"])
        self.client_params = [{k: on(v) for k, v in p.items()}
                              for p in state["client_params"]]
        self.server_params = {k: on(v) for k, v in state["server_params"].items()}
        self.cache_g = cache_lib.CacheState(*(on(a) for a in state["cache"]))
        self.prev_teacher = ((on(state["prev_idx"]).to(torch.int64),
                              on(state["prev_teacher"]))
                             if bool(state["have_prev"]) else None)
        self.last_teacher_val = (on(state["teacher_val"])
                                 if bool(state["have_tv"]) else None)
        self.last_sync = np.asarray(torch.as_tensor(state["last_sync"]).cpu()
                                    ).astype(np.int64)
        self._seed_generators()
        for t in range(1, self.t_done + 1):
            self._draw_round(t)

    # ------------------------------------------------------------------
    # Per-cohort client steps, shared by the host loop and the device
    # engine.
    def _distill_all(self, params: List[Params], x_prev,
                     pteach) -> List[Params]:
        """Every cohort distilled on the shared ``(m, N)`` teacher or on
        its clients' rows of a per-client ``(K, m, N)`` stack (COMET)."""
        c = self.cfg
        teach_c = (self.models.split(pteach) if pteach.dim() == 3
                   else [pteach] * len(params))
        return [distill(p, x_prev, teach_c[i], c.lr_dist, c.distill_steps)
                for i, p in enumerate(params)]

    def _local_train_all(self, params: List[Params], t: int) -> List[Params]:
        """Every cohort's local training on its private shards in round
        ``t``; under a ``Heterogeneity`` each client's own schedule at
        ``lr_k * lr_decay ** (t - 1)`` (float32, on the host)."""
        c = self.cfg
        if self.scenario.heterogeneity is None:
            return [local_train(p, self.xs_c[i], self.ys_c[i],
                                self.train_mask_c[i], c.lr, c.local_steps)
                    for i, p in enumerate(params)]
        decay = float(self._lr_decay ** (np.float32(t) - np.float32(1.0)))
        return [local_train_masked(p, self.xs_c[i], self.ys_c[i],
                                   self.train_mask_c[i], self._lr_k_c[i] * decay,
                                   self._steps_k_c[i], self._max_steps)
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

    def _telemetry_row(self, *, t: int, part, miss, base_present, z_tx, z_srv,
                       fresh, last_sync, uplink, downlink,
                       catch_up) -> obs_device.RoundTelemetry:
        """One :class:`repro_torch.obs.device.RoundTelemetry` row (reference
        ``_telemetry_row``), shared by both engines: the one expression is
        what makes their counter stacks equal.  Counters come from the
        full-width ``part`` and the pre-update ``miss``, ``base_present``
        and ``last_sync``; ``z_tx`` is the (K, m, N) stack as transmitted,
        ``z_srv`` the server's post-uplink-codec view, ``fresh`` the
        aggregated teacher after sharpening and the downlink codec.  The
        byte counts are host floats (host loop) or float32 device scalars
        (device engine).  ``t`` is a host int; nothing here reads the
        device."""
        part_f = part.to(torch.float32)
        n_part = part_f.sum()
        hits, new, expired = obs_device.cache_signal_counts(base_present, miss)
        cerr = (obs_device.as_f32(0.0, part) if self.codec_up.is_identity else
                obs_device.codec_error_mean(z_srv, z_tx, part_f, n_part))
        zbar = obs_device.participant_mean(z_srv, part_f, n_part)
        tel = obs_device.RoundTelemetry(
            participants=obs_device.participants_per_cohort(
                part, self.models.offsets, self.models.sizes),
            cache_hits=hits, cache_miss_new=new, cache_expired=expired,
            catch_up_clients=obs_device.returning_client_count(part, last_sync, t),
            staleness_hist=obs_device.staleness_histogram(part, last_sync, t),
            uplink_bytes=obs_device.as_f32(uplink, part),
            downlink_bytes=obs_device.as_f32(downlink, part),
            catch_up_bytes=obs_device.as_f32(catch_up, part),
            teacher_entropy_pre=obs_device.mean_entropy(zbar),
            teacher_entropy_post=obs_device.mean_entropy(fresh),
            beta=self.strategy.sharpen_gauge(zbar, t).to(torch.float32),
            codec_quant_error=cerr)
        if self.telemetry_hook is not None:
            tel = self.telemetry_hook(tel, t)
        return tel

    def _round(self, t: int, hist: History, u: Optional[np.ndarray]) -> None:
        c, s = self.cfg, self.strategy
        K = c.n_clients
        part, idx = self._draw_round(t)
        n_part = int(part.sum())
        if n_part == 0:  # total outage: nothing moves, the cache ages
            hist.ledger.record(comm_lib.RoundCost(0.0, 0.0))
            if self._telemetry:  # the zero row, as the device engine's gate gives
                hist.telemetry.append(obs_device.zeros(self.models.n_cohorts,
                                                       self.device))
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
            self._local_train_all(params, t), params, part_c)

        # --- request list (cache) ----------------------------------------
        if self.use_cache:
            miss = cache_lib.miss_mask(
                self.cache_g, idx_t, t, self.D,
                probabilistic=self.probabilistic_expiry,
                u=None if u is None else self._tensor(u))
        else:
            miss = torch.ones(len(idx), dtype=torch.bool, device=self.device)
        n_req = int(miss.sum())
        # shared delta-coding base: the synchronized cache at P^t (pre-update)
        base, base_present = cache_lib.cached_at(self.cache_g, idx_t)

        # --- uplink: soft-labels on requested samples ---------------------
        x_round = self.x_pub[idx_t]
        z_all = self._predict_all(self.client_params, x_round)  # (K, m, N)
        z_all = s.transmit(z_all)  # the method's uplink transform (CFD)
        z_tx = z_all  # as transmitted: telemetry's codec-error reference
        if not self.codec_up.is_identity:  # lossy wire: what the server sees
            z_all = self.codec_up.roundtrip(z_all, base=base,
                                            present=base_present)
        um = s.upload_mask(z_all)  # (K, m) or None (Selective-FD)
        # only participating clients contribute
        zsel = z_all[part_t] if n_part < K else z_all
        umsel = None if um is None else (um[part_t] if n_part < K else um)
        fresh, per_client = s.aggregate(zsel, umsel, t)
        if not self.codec_down.is_identity:
            # clients receive (and cache) the decoded broadcast; the server
            # uses the same decoded teacher so both caches stay identical
            fresh = self.codec_down.roundtrip(fresh, base=base,
                                              present=base_present)
            if per_client is not None:
                per_client = self.codec_down.roundtrip(
                    per_client, base=base, present=base_present)

        # --- assemble teacher + cache update ------------------------------
        cache_prev = self.cache_g  # pre-round state: catch-up covers <= t-1
        if self.use_cache:
            teacher = cache_lib.assemble_teacher(self.cache_g, idx_t, fresh, miss)
            self.cache_g, signals = cache_lib.update_global_cache(
                self.cache_g, idx_t, teacher, miss, t)
        else:
            teacher = fresh

        # --- server distillation ------------------------------------------
        self.server_params = distill(self.server_params, x_round, teacher,
                                     c.lr_dist, c.distill_steps)
        # App.-D proxy teacher on the public validation split
        zv = self._predict_all(self.client_params, self.x_pub[self.pub_val_idx])
        self.last_teacher_val = zv.mean(0)
        teach_next = teacher
        if per_client is not None:  # COMET: personalized teachers
            teach_next = per_client
            if per_client.shape[0] != K:  # partial participation: clients
                # without a cluster this round fall back to the round's teacher
                teach_next = teacher.expand((K,) + teacher.shape).clone()
                teach_next[self._tensor(np.nonzero(part)[0])] = per_client
        self.prev_teacher = (idx_t, teach_next)

        # --- catch-up packages for returning stragglers --------------------
        catch_up = 0.0
        catch_up_pkgs = {}
        if self.use_cache:
            for k in np.nonzero(part)[0]:
                if self.last_sync[k] < t - 1:
                    pkg = cache_lib.make_catch_up(cache_prev, int(self.last_sync[k]))
                    catch_up_pkgs[k] = pkg
                    catch_up += cache_lib.catch_up_bytes(pkg)

        # --- mirrored local caches (track_local_caches) --------------------
        if self.track_local_caches and self.use_cache:
            queue = cache_lib.pack_queue(teacher, miss)
            dense = cache_lib.unpack_queue(queue, miss, c.n_classes)
            for k in np.nonzero(part)[0]:
                ck = self.local_caches[k]
                if k in catch_up_pkgs:  # returning straggler
                    ck = cache_lib.apply_catch_up(ck, catch_up_pkgs[k])
                self.local_caches[k], _ = cache_lib.update_local_cache(
                    ck, idx_t, signals, dense, t)

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
        if self._telemetry:  # before last_sync moves: the row reads the old one
            hist.telemetry.append(self._telemetry_row(
                t=t, part=part_t, miss=miss, base_present=base_present,
                z_tx=z_tx, z_srv=z_all, fresh=fresh,
                last_sync=self._tensor(self.last_sync, torch.int32),
                uplink=cost.uplink, downlink=cost.downlink, catch_up=catch_up))
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
