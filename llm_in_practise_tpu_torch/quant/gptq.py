"""GPTQ: Hessian-compensated 4-bit post-training quantization.

Port of ``llm_in_practise_tpu/quant/gptq.py`` (the reference quantizes
Qwen3 with GPTQModel's ``QuantizeConfig(bits=4, group_size=128)`` and
llm-compressor's ``GPTQModifier(scheme="W4A16")``):

- **Hessian** ``H = 2 X^T X`` from calibration activations.
- **Column-sequential OBQ**: each input row of the ``(in, out)`` kernel
  is snapped to its int4 grid and its rounding error is spread into the
  rows not yet quantized through the upper Cholesky factor of ``H^-1``.
  The JAX package runs the sweep as one ``lax.fori_loop``; eager PyTorch
  pays a few launches per row, so the port takes the GPTQ paper's lazy
  batch update: a block of ``group_size`` rows is swept with updates
  inside the block only, then one matmul carries the block's errors into
  every later row. In exact arithmetic that is the same sweep, and the
  group's scales still come from fully updated weights (each block is one
  group, and the block starts where JAX takes a group's scales).
- Output is the shared :class:`~.int4.Int4Tensor` W4A16 format.

Model level: a forward pre-hook on every :class:`~..models.qwen3.Dense`
reduces its input (the input as the layer receives it, before the cast
to the compute dtype, in f32) to ``X^T X`` and ``sum |x|`` per batch.
Keys are flax paths (``block_0/attn/q_proj/kernel``, ``lm_head/kernel``;
:func:`~..models.convert.flax_path`), so a JAX ``target`` predicate
applies unchanged. Kernels fed the same tensor (q/k/v; gate/up) share
one Gram matrix: the values are those of one Gram per kernel.

Every f32 product here runs with TF32 off
(:func:`~..core.device.exact_f32`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from llm_in_practise_tpu_torch.core.device import exact_f32
from llm_in_practise_tpu_torch.models.convert import flax_path, port_name
from llm_in_practise_tpu_torch.models.qwen3 import Dense
from llm_in_practise_tpu_torch.quant import int4


@dataclasses.dataclass(frozen=True)
class GPTQConfig:
    """GPTQModel's ``QuantizeConfig`` knobs (bits fixed at 4)."""

    group_size: int = 128
    sym: bool = True
    damp: float = 0.01  # percdamp: damping as a fraction of mean(diag(H))


def hessian(x: torch.Tensor) -> torch.Tensor:
    """``2 X^T X`` from calibration activations ``(..., in)``."""
    x = x.reshape(-1, x.shape[-1]).to(torch.float32)
    with exact_f32():
        return 2.0 * (x.T @ x)


def _cholesky_inv_upper(h: torch.Tensor, damp: float) -> torch.Tensor:
    """Upper Cholesky factor U of the damped ``H^-1`` (``H^-1 = U^T U``).
    Dead input channels (zero diagonal) get the mean diagonal, so H stays
    positive definite. ``H^-1`` is symmetrized before the factorization,
    as ``jnp.linalg.cholesky`` does."""
    h = h.to(torch.float32)
    d = torch.diagonal(h)
    mean_d = torch.mean(torch.where(d > 0, d, 0.0)) + 1e-8
    h = h + torch.diag(torch.where(d > 0, 0.0, mean_d))
    h = h + damp * mean_d * torch.eye(h.shape[0], dtype=h.dtype,
                                      device=h.device)
    with exact_f32():
        hinv = torch.linalg.inv(h)
        hinv = (hinv + hinv.mT) / 2
        return torch.linalg.cholesky(hinv).mT


def gptq_quantize_matrix(w: torch.Tensor, h: torch.Tensor,
                         cfg: GPTQConfig = GPTQConfig()) -> int4.Int4Tensor:
    """Quantize one kernel ``w`` (in, out) against its Hessian ``h``
    (in, in), on ``w``'s device."""
    d_in, d_out = w.shape
    gs = min(cfg.group_size, d_in)
    if d_in % gs:
        raise ValueError(f"in_features {d_in} not divisible by group_size "
                         f"{gs}")
    n_groups = d_in // gs
    u = _cholesky_inv_upper(h.to(w.device), cfg.damp)
    w = w.to(torch.float32).clone()       # the working copy, updated
    wq = torch.empty_like(w)
    scales = torch.empty((n_groups, d_out), dtype=torch.float32,
                         device=w.device)
    zeros = torch.empty_like(scales)
    diag = torch.clamp(torch.diagonal(u), min=1e-12)
    err = torch.empty((gs, d_out), dtype=torch.float32, device=w.device)
    with exact_f32():
        for g in range(n_groups):
            b0, b1 = g * gs, (g + 1) * gs
            s, z = int4.quant_params_for_group(w[b0:b1], sym=cfg.sym)
            scales[g], zeros[g] = s, z
            for i in range(b0, b1):
                col = w[i]
                q = int4.quantize_column(col, s, z)
                wq[i] = q
                e = err[i - b0]
                torch.div(col - q, diag[i], out=e)
                if i + 1 < b1:
                    w[i + 1:b1].sub_(u[i, i + 1:b1, None] * e[None, :])
            if b1 < d_in:
                # the lazy batch update: the block's errors into every
                # later row at once
                w[b1:].sub_(u[b0:b1, b1:].mT @ err)
    return int4.encode(wq, scales, zeros, gs)


# --- model level: stream Dense-input stats, quantize matching kernels ----


@dataclasses.dataclass
class DenseStats:
    """Streaming calibration statistics of one Dense layer's input:
    ``(in, in)`` and ``(in,)`` whatever the calibration size."""

    gram: torch.Tensor      # sum X^T X, (in, in) f32
    abs_sum: torch.Tensor   # sum |x| over rows, (in,) f32
    count: int              # rows accumulated

    @property
    def hessian(self) -> torch.Tensor:
        return 2.0 * self.gram

    @property
    def mean_abs(self) -> torch.Tensor:
        return self.abs_sum / max(self.count, 1)


def _dense_modules(model) -> dict[str, Dense]:
    """``{flax path of the kernel: Dense}`` of a model."""
    return {flax_path(f"{name}.kernel"): mod
            for name, mod in model.named_modules() if isinstance(mod, Dense)}


def accumulate_dense_stats(model, params, batches, *,
                           target: Callable[[str], bool] | None = None
                           ) -> dict[str, DenseStats]:
    """Run the calibration batches through ``model.apply(params, batch)``
    (``params`` a flat state, :meth:`~..models.qwen3.Qwen3.apply`),
    reducing every Dense input on the fly.

    Returns ``{flax path of the kernel: DenseStats}`` for the kernels
    ``target`` accepts (default all). Kernels fed the same tensor share
    their ``gram`` and ``abs_sum`` tensors."""
    accs: dict[str, list] = {}     # key -> [gram, abs_sum, count]
    last = {"x": None, "acc": None}

    def hook_for(key):
        def hook(_mod, args):
            x = args[0]
            if x is last["x"]:
                acc = accs.setdefault(key, last["acc"])
                if acc is last["acc"]:
                    return None      # this batch's rows are already in
            else:
                acc = accs.get(key)
            xf = x.detach().to(torch.float32).reshape(-1, x.shape[-1])
            with exact_f32():
                g = xf.T @ xf
            a = torch.sum(torch.abs(xf), dim=0)
            if acc is None:
                acc = accs[key] = [g, a, xf.shape[0]]
            else:
                acc[0].add_(g)
                acc[1].add_(a)
                acc[2] += xf.shape[0]
            last["x"], last["acc"] = x, acc
            return None
        return hook

    handles = [mod.register_forward_pre_hook(hook_for(key))
               for key, mod in _dense_modules(model).items()
               if target is None or target(key)]
    try:
        with torch.no_grad():
            for batch in batches:
                model.apply(params, batch)
                last["x"] = last["acc"] = None
    finally:
        for h in handles:
            h.remove()
    return {key: DenseStats(*acc) for key, acc in accs.items()}


def stats_nbytes(stats: dict[str, DenseStats]) -> int:
    """Bytes the stats hold, each shared tensor once."""
    seen = {}
    for st in stats.values():
        for t in (st.gram, st.abs_sum):
            seen[id(t)] = t.numel() * t.element_size()
    return sum(seen.values())


def sync_clock(t: torch.Tensor) -> float:
    """The host clock after ``t``'s device has finished its queued work."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


def quantize_model_gptq(model, params, calib_batches,
                        cfg: GPTQConfig = GPTQConfig(), *,
                        target: Callable[[str], bool] | None = None,
                        stats: dict[str, DenseStats] | None = None,
                        timings: dict | None = None) -> dict:
    """GPTQ-quantize every captured Dense kernel of the flat state
    ``params`` whose rows divide into groups; other entries pass through.
    ``target`` filters kernels by flax path (the reference's recipes
    ignore ``lm_head``: pass a target for that). ``stats``: ones already
    accumulated over ``calib_batches``. ``timings``: filled with each
    kernel's seconds by flax path (the device synchronized around each).
    """
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
            out[name] = gptq_quantize_matrix(leaf, st.hessian, cfg)
            if timings is not None:
                timings[key] = sync_clock(leaf) - t0
    return out
