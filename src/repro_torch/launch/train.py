"""Single-host LM training driver (the port of ``repro.launch.train``):
a synthetic token pipeline, a model of the registry, AdamW and
checkpointing.  It trains a reduced configuration of an assigned
architecture for a few hundred steps, or with ``--full-config`` the
published one, on ``--device`` (``cuda`` by default, which raises
without a card; ``--device cpu`` runs the plain PyTorch path).

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --steps 200 --batch 8 --seq 128

The flags, defaults and output lines are the reference's, plus
``--device``.  A step is :func:`train_step`: the loss without
activation checkpointing, ``backward()``, then the optimizer's update.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.configs.registry import ARCHS, ASSIGNED
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.specs import stub_shape
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.obs.trace import now as _now
from repro_torch.optim import Optimizer
from repro_torch.optim import get as get_opt


def token_stream(vocab: int, batch: int, seq: int, seed: int, device="cuda"):
    """Synthetic Zipf-ish token pipeline with a learnable bigram structure
    (so the loss has signal to descend): batches of ``tokens`` and
    ``labels`` (the same (batch, seq) int32 tensor) on ``device``, drawn
    from ``np.random.default_rng(seed)`` in the reference's order, so the
    tokens are the reference's bit for bit.  The bigram table and its
    cumulative sums are two (vocab, vocab) float64 arrays on the host."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.full(vocab, 0.05), size=vocab)  # bigram table
    cum = np.cumsum(trans, axis=1)
    while True:
        toks = np.empty((batch, seq), np.int32)
        toks[:, 0] = rng.integers(0, vocab, batch)
        u = rng.random((batch, seq))
        for t in range(1, seq):
            toks[:, t] = np.array(
                [np.searchsorted(cum[toks[b, t - 1]], u[b, t]) for b in range(batch)],
                np.int32).clip(0, vocab - 1)
        tokens = torch.from_numpy(toks).to(dev)
        yield {"tokens": tokens, "labels": tokens}


def train_step(cfg, opt: Optimizer, params: cm.Params, opt_state, batch, lr: float,
               remat: bool = False):
    """One training step: ``registry.loss_fn`` (no activation
    checkpointing unless ``remat``), ``backward()``, ``opt.update`` ->
    (the loss, a detached float32 0-d tensor; the new parameters; the new
    optimizer state).  ``params`` are read, not changed; a parameter that
    no gradient reaches gets a zero one, as ``jax.grad`` gives it."""
    leaves = cm.tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = registry.loss_fn(cfg, leaves, batch, remat=remat)
        loss.backward()
    grads = cm.tree_map(lambda t: torch.zeros_like(t) if t.grad is None else t.grad, leaves)
    params, opt_state = opt.update(grads, opt_state, leaves, lr)
    return loss.detach(), params, opt_state


def stub_inputs(cfg, batch: int, device) -> dict:
    """The VLM's patch embeddings or the encoder-decoder's audio
    embeddings as zeros in the compute dtype (the launcher's stubs); {} for
    the other families."""
    stub = stub_shape(cfg, batch)
    if stub is None:
        return {}
    return {stub[0]: torch.zeros(stub[1], dtype=cm.dtype_of(cfg.compute_dtype), device=device)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ASSIGNED), default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full-config", action="store_true",
                    help="use the FULL assigned config (needs the card's memory)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch] if args.full_config else ARCHS[args.arch].reduced()
    print(f"training {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size} family={cfg.family}")
    params = registry.init(cfg, torch.Generator().manual_seed(0), device=dev)
    print(f"params: {cm.n_params(params)/1e6:.1f}M")

    opt = get_opt("adamw", weight_decay=0.01)
    opt_state = opt.init(params)
    stream = token_stream(cfg.vocab_size, args.batch, args.seq, seed=1, device=dev)
    stubs = stub_inputs(cfg, args.batch, dev)
    losses = []
    t0 = _now()
    for step in range(args.steps):
        batch = dict(next(stream), **stubs)
        loss, params, opt_state = train_step(cfg, opt, params, opt_state, batch, args.lr)
        losses.append(float(loss))
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq * (step + 1) / (_now() - t0)
            print(f"step {step:5d}  loss {losses[-1]:.4f}  {tok_s:.0f} tok/s")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    if args.ckpt:
        save_pytree(args.ckpt, {"params": params, "opt": opt_state})
        print(f"checkpoint -> {args.ckpt}")


if __name__ == "__main__":
    main()
