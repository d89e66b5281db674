"""Client-sharded device engine over ``torch.distributed`` (counterpart of
``repro.fl.shard_engine``, ``engine="shard"``).

The device engine (:mod:`repro_torch.fl.scan_engine`) keeps every client
on one card, so the client count K is capped by one device's memory.
This engine partitions the clients over the ``"data"`` axis of a mesh of
ranks (:mod:`repro_torch.launch.mesh`): each rank of the process group is
one shard and holds ``K / n_shards`` clients of every cohort (cohort c's
shard-s clients are ``offset_c + s * kloc_c .. offset_c + (s + 1) *
kloc_c``): their parameters, private and eval shards and schedules.  Only
those go to the card, so a rank's device memory for client state is
O(K / n).  Ranks along any other mesh axis hold the same clients and
compute the same thing.  What a rank holds beside them does not depend
on K: the replicated server state below, and its process's cuBLAS
workspaces (32 MiB a thread that multiplies on Hopper: the rank's own and
autograd's backward thread), which its first matrix products allocate.

Everything server-side (the cache, the teacher, the server's parameters,
the public data, ``last_sync`` and the round's full-width participation)
is replicated: every rank computes it from the same inputs, bit for bit,
with no communication.  What crosses shards is the strategy's linear
aggregation moments and a few sums, in one ``all_reduce(SUM)`` a round
over the data axis's process group (the reference's ``psum``):

- aggregation is the strategy's two-phase contract:
  ``partial_aggregate`` (or ``partial_aggregate_fused``, the
  ``fused_round`` kernel with ``sharpen=False``) on the shard, the sum,
  then ``finalize_aggregate`` once on the replicated sum;
- beside the moments ride Selective-FD's uploaded-entry count, the
  shard's summed validation predictions (the App.-D proxy teacher) and,
  on an eval round, its per-cohort accuracy and validation-loss sums:
  all of them depend on the clients' parameters alone, so they are ready
  before the aggregation and share its collective;
- bytes come from the replicated full-width participation and request
  list, the expression the device engine evaluates, so the ledger is the
  device engine's bit for bit; telemetry's participant gauges all-reduce
  their sums (two more collectives a round, with telemetry on).

Draws, as on the device engine: the leg's participation and P^t come
from the jax key stream on every rank's device (or the numpy Generators
on its host, or ``run(draws=)``), over the full client axis, then are
sliced to the shard on the device
(:meth:`ShardedFederatedDistillation._shard_local`).  Each rank draws the
initial parameters of its own clients alone, from their keys of the same
``split(key(seed), K + 1)``, so every shard's clients start bit for bit
where ``engine="scan"``'s do.

Parity: a sharded run's per-round ledger equals ``engine="scan"``'s bit
for bit on the same draws.  States and metrics are allclose: the moments
are summed in another order, and SCARLET's per-op path sharpens the
reduced mean with the plain Enhanced ERA where the device engine runs
the fused ERA kernel over the weighted stack.

The engine needs an initialised default process group;
``run_method(engine="shard")`` starts a world of one when there is none.
``state_dict`` gathers every client's parameters (every rank takes part;
the reference's npz format, written by one rank), ``load_state_dict``
slices them.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import cache as cache_lib
from repro_torch.fl.cohorts import ClientModels, resolve_cohorts
from repro_torch.fl.rounds import _select_cohorts, accuracy, val_loss_hard, val_loss_soft
from repro_torch.fl.scan_engine import ScannedFederatedDistillation
from repro_torch.kernels.runtime import divide, resolve_device
from repro_torch.launch.mesh import (
    CLIENT_AXIS,
    Mesh,
    all_reduce_sum,
    make_production_mesh,
    make_test_mesh,
    mesh_axis_sizes,
    rank_device,
)
from repro_torch.models.resnet import Params

__all__ = ["ShardedFederatedDistillation", "resolve_mesh", "best_data_axis", "CLIENT_AXIS"]

_SPEC_RE = re.compile(r"^(\d+)(?:x(\d+))?$")


def resolve_mesh(spec: Union[str, Mesh]) -> Mesh:
    """Mesh from a concrete ``FLConfig.mesh_spec`` (or a Mesh, as it is).

    ``"DATA"`` or ``"DATAxMODEL"`` (e.g. ``"8"``, ``"2x4"``): a
    :func:`repro_torch.launch.mesh.make_test_mesh` of that shape.
    ``"production"`` / ``"production_multipod"``: the 16x16 (2x16x16)
    meshes.  Each must cover the process group's world exactly.

    ``"auto"`` is resolved before this function by the engine's
    constructor (through :func:`best_data_axis`, which needs the client
    count) and is refused here, so the spelling has one meaning."""
    if isinstance(spec, Mesh):
        return spec
    if spec == "production":
        return make_production_mesh()
    if spec == "production_multipod":
        return make_production_mesh(multi_pod=True)
    m = _SPEC_RE.match(spec) if isinstance(spec, str) else None
    if m is None:
        raise ValueError(
            f"unknown mesh_spec {spec!r} (want 'DATA', 'DATAxMODEL', "
            "'production', or 'production_multipod'; 'auto' is only valid "
            "through the engine constructor / FLConfig.mesh_spec)")
    return make_test_mesh(int(m.group(1)), int(m.group(2) or 1))


def best_data_axis(n_clients: int, n_devices: Optional[int] = None) -> int:
    """Largest count <= ``n_devices`` (default: the process group's world
    size, 1 without one) that divides ``n_clients`` evenly: the widest
    legal client partition."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    d = min(n_clients, n_devices)
    while n_clients % d:
        d -= 1
    return d


class ShardedFederatedDistillation(ScannedFederatedDistillation):
    """Client-sharded twin of :class:`ScannedFederatedDistillation`.

    The same constructor plus ``mesh``: a :class:`repro_torch.launch.mesh.Mesh`,
    a spec string (see :func:`resolve_mesh`), or None for
    ``cfg.mesh_spec``.  ``"auto"`` takes the widest data axis that splits
    every cohort and the world evenly (:func:`best_data_axis` of the gcd
    of the cohort sizes and the world size), the rest of the world as
    replicas along ``"model"``.  ``cfg.n_clients`` and every cohort must
    divide by the data axis.  ``device="cuda"`` runs rank r on ``cuda:(r %
    device_count)``.  Every restriction of the device engine applies."""

    def __init__(self, cfg, strategy, *args, mesh: Union[str, Mesh, None] = None,
                 device="cuda", **kwargs):
        if not dist.is_initialized():
            raise RuntimeError(
                "the sharded engine needs an initialised torch.distributed process "
                "group (run_method(engine='shard') starts a world of one)")
        models = ClientModels(resolve_cohorts(cfg), cfg.dim, cfg.n_classes)
        spec = mesh if mesh is not None else cfg.mesh_spec
        if spec is None or spec in ("", "auto"):
            world = dist.get_world_size()
            d = best_data_axis(math.gcd(*models.sizes, world), world)
            spec = f"{d}x{world // d}"
        self.mesh = resolve_mesh(spec)
        if CLIENT_AXIS not in self.mesh.axis_names:
            raise ValueError(
                f"mesh {self.mesh.axis_names} has no {CLIENT_AXIS!r} axis "
                "to partition clients over")
        self.n_shards = mesh_axis_sizes(self.mesh)[CLIENT_AXIS]
        if cfg.n_clients % self.n_shards:
            raise ValueError(
                f"n_clients={cfg.n_clients} does not divide evenly over "
                f"the {self.n_shards}-way {CLIENT_AXIS!r} axis "
                "(pick a divisible client count or a narrower mesh)")
        # every cohort's block is sharded on its own, so each cohort size
        # must split evenly too (an equal composition on every shard)
        self.kloc_c = models.shard_sizes(self.n_shards)
        s = self.shard = self.mesh.axis_index(CLIENT_AXIS)
        self._held = ClientModels([dataclasses.replace(c, n_clients=k)
                                   for c, k in zip(models.cohorts, self.kloc_c)],
                                  cfg.dim, cfg.n_classes)
        # the shard's rows of a full-width per-client array, cohort by cohort
        self._blocks = [(off + s * k, off + (s + 1) * k)
                        for off, k in zip(models.offsets, self.kloc_c)]
        super().__init__(cfg, strategy, *args,
                         device=rank_device(resolve_device(device)), **kwargs)
        self._cohort_sizes = self._tensor(np.asarray(models.sizes, np.float32))
        # the group's first collective, outside any round (NCCL sets up its
        # communicator here), checks that it spans the data axis
        n = self._all_reduce({"n": torch.ones((), device=self.device)})[0]["n"]
        if int(n) != self.n_shards:
            raise RuntimeError(f"the data axis's process group summed {int(n)} "
                               f"ranks, not {self.n_shards}")

    # ------------------------------------------------------------------
    # placement: the shard's clients only
    @property
    def held(self) -> ClientModels:
        return self._held

    def _shard_local(self, x):
        """The shard's rows of a full-width ``(K, ...)`` per-client array
        (numpy or tensor): the one place a rank's data depends on its
        position on the data axis (the analyzer's replication pass taints
        what it returns)."""
        parts = [x[a:b] for a, b in self._blocks]
        if len(parts) == 1:
            return parts[0]
        return torch.cat(parts) if isinstance(x, torch.Tensor) else np.concatenate(parts)

    def _client_array(self, a, dtype=None):
        return self._tensor(self._shard_local(np.asarray(a)), dtype)

    def _init_client_params(self, keys: torch.Tensor) -> None:
        """The shard's clients' parameters from their rows of the ``(K, 2)``
        keys."""
        self.client_params = self.held.init_params(self._shard_local(keys))

    def _restore_client_params(self, stacks) -> None:
        """Install the shard's block of every cohort's full stack."""
        s = self.shard
        self.client_params = [
            {key: torch.as_tensor(v[s * k:(s + 1) * k]).to(self.device, copy=True)
             for key, v in p.items()}
            for p, k in zip(stacks, self.kloc_c)]

    def shard_local_leaves(self) -> Dict[str, Any]:
        """The state and arrays that differ from shard to shard (the
        reference's ``P("data")`` specs): the clients' parameters and their
        private, eval and schedule arrays.  Everything else the rounds
        read or write is replicated."""
        leaves = dict(client_params=self.client_params, xs=self.xs_c, ys=self.ys_c,
                      train_mask=self.train_mask_c, val_mask=self.val_mask_c,
                      xts=self.xts_c, yts=self.yts_c, tmask=self.tmask_c)
        if self.scenario.heterogeneity is not None:
            leaves.update(lr_k=self._lr_k_c, steps_k=self._steps_k_c)
        return leaves

    # ------------------------------------------------------------------
    def _all_reduce(self, *groups: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], ...]:
        """Every float32 tensor of ``groups`` (dicts) summed over the data
        axis in ONE all-reduce of a packed buffer; the dicts come back in
        their shapes."""
        items = [(i, k, v) for i, g in enumerate(groups) for k, v in g.items()]
        flat = torch.cat([v.to(torch.float32).reshape(-1) for _, _, v in items])
        flat = all_reduce_sum(flat, self.mesh.group)
        out = tuple({} for _ in groups)
        pieces = torch.split(flat, [v.numel() for _, _, v in items])
        for (i, k, v), p in zip(items, pieces):
            out[i][k] = p.reshape(v.shape)
        return out

    def _eval_sums(self, cp: List[Params]) -> Dict[str, torch.Tensor]:
        """The shard's per-cohort client-accuracy sums and its summed
        client validation losses."""
        acc = torch.stack([accuracy(p, self.xts_c[i], self.yts_c[i], self.tmask_c[i]).sum()
                           for i, p in enumerate(cp)])
        cv = sum(val_loss_hard(p, self.xs_c[i], self.ys_c[i], self.val_mask_c[i]).sum()
                 for i, p in enumerate(cp))
        return dict(acc=acc, cv=cv)

    def _round_device(self, st: Dict[str, Any], t: int, part: torch.Tensor,
                      idx: torch.Tensor, do_eval: bool,
                      u: Optional[torch.Tensor] = None,
                      tkey: Optional[torch.Tensor] = None):
        """One round on one shard (reference ``_round_device_sharded``):
        the device engine's round with the clients shard-local and every
        cross-client sum all-reduced.  ``part`` is the full-width
        participation; nothing here reads the device."""
        K = self.cfg.n_clients
        part_f = part.to(torch.float32)
        any_p = part_f.sum() > 0
        part_l = self._shard_local(part)
        w = part_l.to(torch.float32)

        def gate(new, old):
            """Keep ``old`` wholesale on a total-outage round."""
            return torch.where(any_p, new, old)

        # --- the shard's clients: distill on the previous teacher, train --
        cp = st["client_params"]
        upd = self._distill_all(cp, self.x_pub[st["prev_idx"]], st["prev_teacher"])
        cp = _select_cohorts(upd, cp, self.held.split(part_l & st["have_prev"]))
        cp = _select_cohorts(self._local_train_all(cp, t), cp, self.held.split(part_l))

        # --- sums of the shard that ride with the aggregation's moments ---
        sums = {"zv": self._predict_all(cp, self.x_pub[self.pub_val_idx]).sum(0)}
        if do_eval:
            sums.update(self._eval_sums(cp))
        reduced = {}

        def reduce(partials):
            partials, reduced["sums"] = self._all_reduce(partials, sums)
            return partials

        # --- the server's side (replicated), then the outage gate ---------
        catch_up = 0.0
        if self.use_cache:  # from the replicated last_sync and full-width draw
            catch_up = cache_lib.catch_up_bytes_device(
                st["cache"], st["last_sync"], part, t)
        r = self._server_round(cp, w, idx, t, x_pub=self.x_pub, cache_prev=st["cache"],
                               server_params=st["server_params"], u=u, tkey=tkey,
                               reduce=reduce)
        sums = reduced["sums"]
        uplink, downlink = self._round_bytes(r, part_f, catch_up)
        cache = st["cache"]
        if self.use_cache:
            cache = cache_lib.CacheState(
                *(gate(a, b) for a, b in zip(r["cache"], st["cache"])))
        server_params = {k: gate(v, st["server_params"][k])
                         for k, v in r["server_params"].items()}
        teacher_val = gate(divide(sums["zv"], float(K)), st["teacher_val"])
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
        if self._telemetry:  # counters full width; gauges the shard's, summed
            out["telemetry"], new_st["telemetry"] = self._telemetry_device(
                st["telemetry"], t, part, any_p, miss=r["miss"], base=r["base"],
                base_present=r["base_present"], z_tx=r["z_tx"], z_all=r["z_all"],
                fresh=r["fresh"], last_sync=st["last_sync"], uplink=out["uplink"],
                downlink=out["downlink"], catch_up=catch_up, w=w, group=self.mesh.group)
        if do_eval:  # the schedule is known on the host
            out.update(
                server_acc=accuracy(server_params, self.x_test, self.y_test,
                                    torch.ones(len(self.y_test), device=self.device)),
                client_acc=divide(sums["acc"].sum(), float(K)),
                cohort_acc=sums["acc"] / self._cohort_sizes,
                server_val=val_loss_soft(server_params, self.x_pub[self.pub_val_idx],
                                         teacher_val),
                client_val=divide(sums["cv"], float(K)))
        return new_st, out

    # ------------------------------------------------------------------
    # checkpoints: the reference's format, every client
    def _leg_state(self) -> Dict[str, Any]:
        return super().state_dict()  # the shard's clients

    def state_dict(self) -> Dict[str, Any]:
        """The device engine's snapshot with every client's parameters,
        gathered over the data axis (every rank must call it); any one
        rank's copy is the whole state."""
        state = super().state_dict()
        state["client_params"] = [{k: self._gather(v) for k, v in p.items()}
                                  for p in state["client_params"]]
        return state

    def _gather(self, v: torch.Tensor) -> torch.Tensor:
        """The shards' blocks of one cohort leaf, concatenated in shard
        order."""
        parts = [torch.empty_like(v) for _ in range(self.n_shards)]
        dist.all_gather(parts, v.contiguous(), group=self.mesh.group)
        return torch.cat(parts)
