"""Optimizers: AdamW and SGD with global-norm clipping and accumulation
(port of ``llm_in_practise_tpu/train/optim.py``).

The JAX package builds optax chains; the port writes the same update
rules out, with optax's hyper-parameters and order of operations: clip
by global norm, then the optimizer, then ``-lr`` (``lr`` may be a
schedule of the update count, as in optax). Parameters are updated in
place (the PyTorch idiom; JAX returns new arrays).

    tx = adamw(1e-4)
    state = tx.init(params)          # params: list of tensors
    tx.step(params, grads, state)    # one update, in place
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

LearningRate = float | Callable[[int], float]


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def clip_by_global_norm(grads, max_norm: float):
    """optax ``clip_by_global_norm``: unchanged below ``max_norm``, else
    scaled by ``max_norm / norm``."""
    norm = global_norm(grads)
    if float(norm) < max_norm:
        return list(grads)
    return [g / norm.to(g.dtype) * max_norm for g in grads]


def _lr(learning_rate: LearningRate, count: int) -> float:
    return learning_rate(count) if callable(learning_rate) else learning_rate


@dataclasses.dataclass
class AdamW:
    """optax ``adamw`` (``eps_root=0``, decoupled weight decay on every
    parameter), after an optional global-norm clip, every
    ``grad_accum_steps`` calls (optax ``MultiSteps``: the mean of the
    accumulated gradients; the calls in between leave the parameters as
    they are)."""

    learning_rate: LearningRate
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip_norm: float | None = 1.0
    grad_accum_steps: int = 1

    def init(self, params) -> dict:
        return {"count": 0, "mini_step": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params],
                "acc": ([torch.zeros_like(p) for p in params]
                        if self.grad_accum_steps > 1 else None)}

    @torch.no_grad()
    def step(self, params, grads, state: dict) -> None:
        grads = _accumulate(grads, state, self.grad_accum_steps)
        if grads is None:
            return
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm)
        state["count"] += 1
        t = state["count"]
        lr = _lr(self.learning_rate, t - 1)
        bc1 = 1 - self.b1 ** t
        bc2 = 1 - self.b2 ** t
        # the per-parameter update as multi-tensor ops: each line is the
        # same elementwise op over every parameter (one launch per dtype
        # group on the card, not one per parameter)
        params, mus, nus = list(params), state["mu"], state["nu"]
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_add_(nus, torch._foreach_mul(grads, grads),
                            alpha=1 - self.b2)
        update = torch._foreach_div(mus, bc1)
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, torch._foreach_mul(params,
                                                       self.weight_decay))
        torch._foreach_add_(params, update, alpha=-lr)


@dataclasses.dataclass
class SGD:
    """optax ``sgd`` (heavy-ball trace ``t = g + momentum * t``), after an
    optional global-norm clip."""

    learning_rate: LearningRate
    momentum: float = 0.0
    clip_norm: float | None = None

    def init(self, params) -> dict:
        return {"count": 0,
                "trace": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def step(self, params, grads, state: dict) -> None:
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm)
        lr = _lr(self.learning_rate, state["count"])
        state["count"] += 1
        for p, g, tr in zip(params, grads, state["trace"]):
            if self.momentum:
                tr.mul_(self.momentum).add_(g)
                g = tr
            p.add_(g, alpha=-lr)


def _accumulate(grads, state: dict, k: int):
    """optax ``MultiSteps``: None until the k-th call, then the mean."""
    if k <= 1:
        return list(grads)
    for acc, g in zip(state["acc"], grads):
        acc.add_(g)
    state["mini_step"] += 1
    if state["mini_step"] < k:
        return None
    mean = [acc / k for acc in state["acc"]]
    for acc in state["acc"]:
        acc.zero_()
    state["mini_step"] = 0
    return mean


def adamw(learning_rate: LearningRate, *, weight_decay: float = 0.01,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          clip_norm: float | None = 1.0, grad_accum_steps: int = 1) -> AdamW:
    """AdamW: [clip] -> adamw [-> accumulate], the JAX package's chain."""
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got "
                         f"{grad_accum_steps}")
    return AdamW(learning_rate, weight_decay, b1, b2, eps, clip_norm,
                 grad_accum_steps)


def sgd(learning_rate: LearningRate, *, momentum: float = 0.0,
        clip_norm: float | None = None) -> SGD:
    return SGD(learning_rate, momentum, clip_norm)
