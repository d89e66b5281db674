"""Parameter-sharing and no-collaboration baselines (FedAvg, Individual):
counterpart of ``repro.fl.baselines``.

Each baseline takes its data and initial parameters from a
:class:`~repro_torch.fl.rounds.FederatedDistillation` built for the same
configuration, and trains its clients on their whole private shards (not
the distillation loop's 90 % training split).  Participation scenarios do
not apply: every client trains every round, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import comm as comm_lib
from repro_torch.fl.config import FLConfig
from repro_torch.fl.rounds import FederatedDistillation, History, accuracy, local_train
from repro_torch.fl.strategies.mean import MeanStrategy

__all__ = ["FedAvg", "Individual"]


def _homogeneous_params(fd: FederatedDistillation):
    """The single stacked parameter dict of a homogeneous run: the
    baselines average or train one architecture across all clients, so
    client-model cohorts do not apply to them."""
    if len(fd.client_params) != 1:
        raise ValueError(
            "baselines assume the homogeneous (hidden, mlp_depth) model; "
            "client-model cohorts only apply to distillation-based methods")
    return fd.client_params[0]


class _Baseline:
    """The data, parameters and evaluation the two baselines share."""

    def __init__(self, cfg: FLConfig, device="cuda"):
        self.cfg = cfg
        self.fd = FederatedDistillation(cfg, MeanStrategy(), device=device)
        self.device = self.fd.device
        self.client_params = _homogeneous_params(self.fd)
        self.server_params = self.fd.server_params

    def load_params(self, client_params, server_params) -> None:
        """Install given initial parameters (numpy dicts, e.g. the
        reference's); see :meth:`FederatedDistillation.load_params`."""
        self.fd.load_params(client_params, server_params)
        self.client_params = _homogeneous_params(self.fd)
        self.server_params = self.fd.server_params

    def _local_train(self, params):
        c, fd = self.cfg, self.fd
        return local_train(params, fd.xs, fd.ys, fd.mask, c.lr, c.local_steps)

    def _client_acc(self) -> float:
        fd = self.fd
        return float(torch.mean(accuracy(self.client_params, fd.xts, fd.yts, fd.tmask)))


class FedAvg(_Baseline):
    """FedAvg: every round each client trains the server model on its
    shard, and the server averages the results weighted by shard size."""

    def run(self, rounds: Optional[int] = None) -> History:
        c, fd = self.cfg, self.fd
        hist = History()
        sizes = fd.mask.sum(1)
        w = sizes / sizes.sum()
        T = c.rounds if rounds is None else rounds
        for t in range(1, T + 1):
            bcast = {k: v.expand((c.n_clients,) + tuple(v.shape)).clone()
                     for k, v in self.server_params.items()}
            trained = self._local_train(bcast)
            self.server_params = {k: torch.tensordot(w, p, dims=([0], [0]))
                                  for k, p in trained.items()}
            self.client_params = trained
            hist.ledger.record(comm_lib.fedavg_round_cost(
                n_clients=c.n_clients, n_params=fd.n_params))
            if t % c.eval_every == 0 or t == T:
                sa = float(accuracy(self.server_params, fd.x_test, fd.y_test,
                                    torch.ones(len(fd.y_test), device=self.device)))
                hist.rounds.append(t)
                hist.server_acc.append(sa)
                hist.client_acc.append(self._client_acc())
                hist.cumulative_mb.append(hist.ledger.cumulative_total / 1e6)
        hist.final_server_acc = hist.server_acc[-1] if hist.server_acc else None
        hist.final_client_acc = hist.client_acc[-1] if hist.client_acc else None
        return hist


class Individual(_Baseline):
    """Isolated client training: the paper's no-collaboration baseline."""

    def run(self, rounds: Optional[int] = None) -> History:
        c = self.cfg
        hist = History()
        T = c.rounds if rounds is None else rounds
        for t in range(1, T + 1):
            self.client_params = self._local_train(self.client_params)
            hist.ledger.record(comm_lib.RoundCost(0.0, 0.0))
            if t % c.eval_every == 0 or t == T:
                hist.rounds.append(t)
                hist.server_acc.append(0.0)
                hist.client_acc.append(self._client_acc())
                hist.cumulative_mb.append(0.0)
        # no server model exists in this baseline, so its accuracy was
        # never measured: None, not a phantom zero
        hist.final_server_acc = None
        hist.final_client_acc = hist.client_acc[-1] if hist.client_acc else None
        return hist
