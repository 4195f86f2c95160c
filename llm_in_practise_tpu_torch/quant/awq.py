"""AWQ: activation-aware weight quantization (scale search and format).

Port of ``llm_in_practise_tpu/quant/awq.py`` (the reference runs
llm-compressor's ``AWQModifier(targets="Linear", scheme="W4A16",
ignore=["lm_head"])``). Salient weight channels are the ones multiplied
by large activations; scaling them up before int4 rounding, and folding
the inverse into the weight's input side, preserves them. Per kernel:

1. channel importance ``s_x = mean|x|`` over the calibration inputs;
2. a grid search over ``alpha`` in [0, 1] (``n_grid`` points): the scale
   ``s = s_x^alpha`` (normalized), RTN int4 groups of ``W * s``, and the
   error ``||X W - (X / s) (sW)_q||^2``, taken from the streaming stats as
   ``tr(A^T G A)`` with ``A = W - (sW)_q / s`` and ``G = X^T X``;
3. the best alpha's codes of ``W * s`` and ``inv_scale = 1 / s``.

An :class:`AWQTensor` stores those, so ``W ~ diag(inv_scale) @ decode(q)``
and a layer computes ``(x * inv_scale) @ decode(q)`` with its calling
convention unchanged. Alpha 0 gives ``s = 1``: the RTN codes. The stats
are :func:`~.gptq.accumulate_dense_stats`'; every f32 product runs with
TF32 off.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from llm_in_practise_tpu_torch.core.device import exact_f32
from llm_in_practise_tpu_torch.quant import int4, int8
from llm_in_practise_tpu_torch.quant.int4 import Int4Tensor
from llm_in_practise_tpu_torch.quant.int8 import Int8Tensor


@dataclasses.dataclass(frozen=True)
class AWQConfig:
    group_size: int = 128
    sym: bool = True
    n_grid: int = 20  # alpha grid resolution over [0, 1]


@dataclasses.dataclass
class AWQTensor:
    q: Int4Tensor
    inv_scale: torch.Tensor  # (in,) f32: multiplies the rows after decode

    @property
    def shape(self):
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.inv_scale.nbytes

    def to(self, device) -> "AWQTensor":
        return AWQTensor(self.q.to(device), self.inv_scale.to(device))


def decode(t: AWQTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (t.inv_scale[:, None] * int4.decode(t.q, torch.float32)).to(dtype)


def _rtn_values(w: torch.Tensor, group_size: int, sym: bool) -> torch.Tensor:
    """RTN-quantized *values* of ``w`` (in, out), on int4.encode's grid."""
    d_in, d_out = w.shape
    gs = min(group_size, d_in)
    groups = w.reshape(-1, gs, d_out)
    scales, zeros = int4.quant_params_for_group(groups, sym=sym)
    code = torch.clamp(torch.round(groups / scales[:, None]
                                   + zeros[:, None]), 0, 15)
    return ((code - zeros[:, None]) * scales[:, None]).reshape(d_in, d_out)


def _scale(s_x: torch.Tensor, alpha) -> torch.Tensor:
    s = s_x ** alpha
    s = s / torch.sqrt(torch.max(s) * torch.min(s))  # normalized (AWQ's)
    return torch.clamp(s, min=1e-6)


def awq_losses(w: torch.Tensor, gram: torch.Tensor, mean_abs: torch.Tensor,
               cfg: AWQConfig = AWQConfig()
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(alphas, losses)``: the grid and each alpha's summed squared
    reconstruction error ``tr(A^T G A)``, on ``w``'s device."""
    w = w.to(torch.float32)
    gram = gram.to(w.device, torch.float32)
    s_x = torch.clamp(mean_abs.to(w.device, torch.float32), min=1e-8)
    alphas = torch.linspace(0.0, 1.0, cfg.n_grid, device=w.device)
    losses = torch.empty(cfg.n_grid, dtype=torch.float32, device=w.device)
    with exact_f32():
        for j in range(cfg.n_grid):
            s = _scale(s_x, alphas[j])
            wq = _rtn_values(w * s[:, None], cfg.group_size, cfg.sym)
            a = w - wq / s[:, None]
            losses[j] = torch.sum(a * (gram @ a))
    return alphas, losses


def awq_search_from_stats(w: torch.Tensor, gram: torch.Tensor,
                          mean_abs: torch.Tensor,
                          cfg: AWQConfig = AWQConfig()
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The scale search from streaming stats (``gram = sum X^T X``,
    ``mean_abs = mean |x|``): ``(best_scale (in,), best summed squared
    error)``."""
    alphas, losses = awq_losses(w, gram, mean_abs, cfg)
    best = torch.argmin(losses)
    s_x = torch.clamp(mean_abs.to(w.device, torch.float32), min=1e-8)
    return _scale(s_x, alphas[best]), losses[best]


def awq_search_matrix(w: torch.Tensor, x: torch.Tensor,
                      cfg: AWQConfig = AWQConfig()
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The search from calibration inputs ``x`` (n, in): ``(best_scale,
    best error as a mean squared error over n x out)``."""
    x = x.reshape(-1, x.shape[-1]).to(torch.float32)
    with exact_f32():
        gram = x.T @ x
    scale, err = awq_search_from_stats(w, gram, torch.mean(torch.abs(x), 0),
                                       cfg)
    return scale, err / (x.shape[0] * w.shape[1])


def awq_quantize_from_stats(w: torch.Tensor, gram: torch.Tensor,
                            mean_abs: torch.Tensor,
                            cfg: AWQConfig = AWQConfig()) -> AWQTensor:
    scale, _ = awq_search_from_stats(w, gram, mean_abs, cfg)
    q = int4.rtn_quantize(w.to(torch.float32) * scale[:, None],
                          group_size=min(cfg.group_size, w.shape[0]),
                          sym=cfg.sym)
    return AWQTensor(q, 1.0 / scale)


def awq_quantize_matrix(w: torch.Tensor, x: torch.Tensor,
                        cfg: AWQConfig = AWQConfig()) -> AWQTensor:
    x = x.reshape(-1, x.shape[-1]).to(torch.float32)
    with exact_f32():
        gram = x.T @ x
    return awq_quantize_from_stats(w, gram, torch.mean(torch.abs(x), 0), cfg)


def quantize_model_awq(model, params, calib_batches,
                       cfg: AWQConfig = AWQConfig(), *,
                       target: Callable[[str], bool] | None = None,
                       stats: dict | None = None,
                       timings: dict | None = None) -> dict:
    """AWQ-quantize every captured Dense kernel of the flat state
    ``params`` (default target: all but ``lm_head``, as the reference
    ignores it); other entries pass through. ``stats``: ones already
    accumulated over ``calib_batches``. ``timings``: filled with each
    kernel's seconds by flax path (the device synchronized around each).
    """
    # models.convert imports this module's AWQTensor; gptq imports
    # models.qwen3, which imports models.convert
    from llm_in_practise_tpu_torch.models.convert import port_name
    from llm_in_practise_tpu_torch.quant.gptq import (
        accumulate_dense_stats,
        sync_clock,
    )

    if target is None:
        target = lambda key: "lm_head" not in key  # noqa: E731
    if stats is None:
        stats = accumulate_dense_stats(model, params, calib_batches,
                                       target=target)
    out = dict(params)
    for key, st in stats.items():
        name = port_name(key)
        leaf = params.get(name)
        if getattr(leaf, "ndim", 0) != 2:
            continue
        if leaf.shape[0] % min(cfg.group_size, leaf.shape[0]) == 0:
            t0 = sync_clock(leaf)
            out[name] = awq_quantize_from_stats(leaf, st.gram, st.mean_abs,
                                                cfg)
            if timings is not None:
                timings[key] = sync_clock(leaf) - t0
    return out


def dequantize_tree(state: dict, dtype=torch.bfloat16) -> dict:
    """Materialize the AWQ, int4 and int8 leaves of a flat state."""
    def leaf(x):
        if isinstance(x, AWQTensor):
            return decode(x, dtype)
        if isinstance(x, Int4Tensor):
            return int4.decode(x, dtype)
        if isinstance(x, Int8Tensor):
            return int8.decode(x, dtype)
        return x

    return {name: leaf(v) for name, v in state.items()}
