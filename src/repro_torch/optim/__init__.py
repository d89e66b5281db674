"""Optimizers over the port's parameter dicts: SGD, momentum and AdamW
(the port of ``repro.optim``)."""
from repro_torch.optim.optimizers import Optimizer, adamw, get, momentum, sgd  # noqa: F401
