"""Parameter carry-over from the JAX package.

The reference draws initial parameters from ``jax.random``, whose
numbers the port does not reproduce.  To hold a port run against a
reference run, the reference's parameters are handed over as numpy
arrays (``np.asarray`` of each leaf) and turned into the port's tensors
here; nothing of JAX is imported.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.resnet import Params

__all__ = ["params_from_numpy"]


def _dict_to(d: Mapping[str, np.ndarray], device) -> Params:
    out: Dict[str, torch.Tensor] = {}
    for k, v in d.items():
        a = np.asarray(v)
        if a.dtype != np.float32:
            raise TypeError(f"parameter {k!r} is {a.dtype}, expected float32 "
                            "(no silent casts)")
        out[k] = torch.tensor(a, device=device)  # a copy: the source may be read-only
    return out


def params_from_numpy(client_params: Sequence[Mapping[str, np.ndarray]],
                      server_params: Mapping[str, np.ndarray],
                      device) -> Tuple[List[Params], Params]:
    """Per-cohort stacked client params (a list with one ``{w{i}: (n, a, c),
    b{i}: (n, c)}`` dict per cohort, as the reference engine's
    ``client_params``) and the server's ``{w{i}: (a, c), b{i}: (c,)}``
    -> the same structure as float32 tensors on ``device``."""
    return ([_dict_to(p, device) for p in client_params],
            _dict_to(server_params, device))
