"""SGD, momentum and AdamW as (init, update) pairs over nested dicts of
tensors (the port of ``repro.optim.optimizers``).

``init(params)`` returns the optimizer's state; ``update(grads, state,
params, lr)`` returns ``(new params, new state)``.  As in the reference,
an update makes new tensors and changes none of its arguments; it runs
under ``torch.no_grad()``.  AdamW keeps its step count ``t`` as an int32
0-d tensor on the parameters' device and computes its bias corrections
there, so a step reads nothing back to the host.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.common import first_leaf, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params, lr)


def sgd() -> Optimizer:
    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params, lr):
        return tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads), state

    return Optimizer(init, update)


def momentum(beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def update(grads, state, params, lr):
        state = tree_map(lambda m, g: beta * m + g.to(m.dtype), state, grads)
        return tree_map(lambda p, m: p - lr * m.to(p.dtype), params, state), state

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, state_dtype: Optional[str] = None) -> Optimizer:
    """AdamW; the moments in ``state_dtype`` (e.g. "bfloat16") if given,
    else in each parameter's dtype.  The update's arithmetic is float32,
    each result cast back to its tensor's dtype."""

    def init(params):
        def z(p):
            return torch.zeros(p.shape, device=p.device,
                               dtype=getattr(torch, state_dtype) if state_dtype else p.dtype)

        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "t": torch.zeros((), dtype=torch.int32, device=first_leaf(params).device)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        t = state["t"] + 1
        c1 = 1.0 - b1 ** t.float()
        c2 = 1.0 - b2 ** t.float()

        def upd(p, g, m, v):
            g32 = g.float()
            m_n = b1 * m.float() + (1 - b1) * g32
            v_n = b2 * v.float() + (1 - b2) * g32 * g32
            step = lr * (m_n / c1) / (torch.sqrt(v_n / c2) + eps)
            if weight_decay:
                step = step + lr * weight_decay * p.float()
            return (p.float() - step).to(p.dtype), m_n.to(m.dtype), v_n.to(v.dtype)

        out = tree_map(upd, params, grads, state["m"], state["v"])
        pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
        return pick(0), {"m": pick(1), "v": pick(2), "t": t}

    return Optimizer(init, update)


def get(name: str, **kw) -> Optimizer:
    if name == "sgd":
        return sgd()
    if name == "momentum":
        return momentum(**kw)
    if name == "adamw":
        return adamw(**kw)
    raise ValueError(f"unknown optimizer {name!r}")
