"""Train and eval steps: loss -> backward -> clip -> optimizer update
(port of ``llm_in_practise_tpu/train/step.py:35-140``).

The JAX package compiles the step with ``jax.jit``; the port runs it
eagerly. The model holds its parameters (frozen ones with
``requires_grad=False``); the step differentiates the trainable ones and
updates them in place.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable

import torch

from llm_in_practise_tpu_torch.train.losses import (
    cross_entropy,
    fused_linear_cross_entropy,
)
from llm_in_practise_tpu_torch.train.optim import global_norm


@dataclasses.dataclass
class TrainState:
    """The model, its trainable parameters, the optimizer and its state."""

    model: torch.nn.Module
    params: list[torch.Tensor]
    tx: Any
    opt_state: dict
    step: int = 0


def create_train_state(model: torch.nn.Module, tx,
                       params: list[torch.Tensor] | None = None) -> TrainState:
    """``params`` defaults to every parameter of ``model`` that requires
    grad (for a :class:`~..peft.fused.QLoRAModel`, its LoRA factors)."""
    if params is None:
        params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError("the model has no trainable parameters")
    return TrainState(model, list(params), tx, tx.init(params))


def head_weight(model) -> tuple[torch.Tensor, bool, torch.Tensor | None]:
    """(LM-head weight, transpose?, bias): ``lm_head.kernel`` (dim, vocab)
    and its bias (an untied GPT head has one, Qwen3's has none) when
    untied, else the tied ``tok_embed.weight`` (vocab, dim) and no bias."""
    head = getattr(model, "lm_head", None)
    if head is not None:
        return head.kernel, False, getattr(head, "bias", None)
    return model.tok_embed.weight, True, None


def make_fused_ce_loss(*, chunk: int = 4096,
                       vocab_chunk: int | None = None) -> Callable:
    """Next-token loss with the LM-head projection fused into the CE
    (:func:`..train.losses.fused_linear_cross_entropy`, bf16 operands and
    f32 logits): the full ``(batch, seq, vocab)`` logits never exist. Pass
    as ``make_train_step(loss_fn=...)``."""

    def loss(model, batch):
        x, y = batch
        hidden = model(x, return_hidden=True)
        w, transpose, bias = head_weight(model)
        loss_val, n_valid = fused_linear_cross_entropy(
            hidden, w, y, transpose_weight=transpose, bias=bias, chunk=chunk,
            vocab_chunk=vocab_chunk)
        return loss_val, {"n_valid": n_valid}

    return loss


def default_loss(model, batch):
    """Next-token cross-entropy over the full logits."""
    x, y = batch
    loss, n_valid = cross_entropy(model(x), y)
    return loss, {"n_valid": n_valid}


def make_dropout_loss(generator: torch.Generator | None = None) -> Callable:
    """Next-token cross-entropy over the full logits with the model in
    training mode (JAX ``make_train_step``'s default loss, which applies
    ``deterministic=False``): a model whose forward takes
    ``deterministic`` (the GPT family) runs with its dropout on, the masks
    drawn from ``generator``; any other runs as it is."""

    def loss(model, batch):
        x, y = batch
        kw = {}
        if "deterministic" in inspect.signature(model.forward).parameters:
            kw = dict(deterministic=False, generator=generator)
        loss_val, n_valid = cross_entropy(model(x, **kw), y)
        return loss_val, {"n_valid": n_valid}

    return loss


def make_train_step(*, loss_fn: Callable | None = None,
                    offload_opt: bool = False) -> Callable:
    """``step(state, batch) -> (state, metrics)``; metrics are ``loss``,
    ``grad_norm`` (before clipping) and the loss's aux (``n_valid``), as
    device tensors. ``loss_fn(model, batch) -> (loss, aux)``; default
    next-token cross-entropy."""
    if offload_opt:
        raise NotImplementedError(
            "offload_opt (optimizer state in host memory) is not ported "
            "(ROADMAP.md queue A item 13)")
    loss_fn = loss_fn or default_loss

    def step(state: TrainState, batch):
        loss, aux = loss_fn(state.model, batch)
        grads = torch.autograd.grad(loss, state.params)
        metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads),
                   **aux}
        state.tx.step(state.params, grads, state.opt_state)
        state.step += 1
        return state, metrics

    return step



def make_eval_step(*, loss_fn: Callable | None = None) -> Callable:
    """``step(state, batch) -> {"loss", "n_valid"}`` under
    ``torch.no_grad()``: the loss of the model as it stands, no update.
    ``loss_fn(model, batch) -> (loss, aux)`` as for
    :func:`make_train_step`; default next-token cross-entropy over the
    full logits (JAX ``make_eval_step``'s default)."""
    loss_fn = loss_fn or default_loss

    def step(state: TrainState, batch):
        with torch.no_grad():
            loss, aux = loss_fn(state.model, batch)
        return {"loss": loss.detach(), "n_valid": aux["n_valid"]}

    return step
