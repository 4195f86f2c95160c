"""W8A16 per-channel int8 storage.

Port of ``llm_in_practise_tpu/quant/int8.py``: symmetric
per-output-channel quantization, ``q`` in the ``(in, out)`` kernel layout
as plain int8 and ``scale = absmax(column) / 127``, so packed exports
written by the JAX package load here byte for byte (:mod:`.io`). Column
scaling commutes with the contraction (``x @ (q * s) == (x @ q) * s``),
which is what the fused kernel
(:mod:`llm_in_practise_tpu_torch.ops.int8_matmul`) uses: one multiply
per output element, after the sum.

This module is a codec written in plain tensor ops; it runs on whatever
device its inputs lie on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Int8Tensor:
    """``w ~ q.float() * scale[..., None, :]`` with ``q`` in [-127, 127].
    2-D ``(in, out)`` kernels carry an ``(out,)`` scale; 3-D stacked
    kernels ``(n_layer, in, out)`` carry ``(n_layer, out)``."""

    q: torch.Tensor       # (..., in, out) int8
    scale: torch.Tensor   # (..., out) f32
    shape: tuple[int, ...]

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.scale.nbytes

    def to(self, device) -> "Int8Tensor":
        return Int8Tensor(self.q.to(device), self.scale.to(device),
                          tuple(self.shape))


def quantize(w: torch.Tensor | np.ndarray) -> Int8Tensor:
    """Symmetric per-out-channel RTN of a 2-D or 3-D kernel; the scale
    reduces over the ``in`` axis. Runs on ``w``'s device."""
    w = torch.as_tensor(w).to(torch.float32)
    if w.ndim not in (2, 3):
        raise ValueError(f"Int8Tensor stores 2-D/3-D kernels, got "
                         f"{tuple(w.shape)}")
    scale = torch.clamp(torch.amax(torch.abs(w), dim=-2) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w / scale[..., None, :]), -127, 127).to(
        torch.int8)
    return Int8Tensor(q, scale, tuple(w.shape))


def decode(t: Int8Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """The dense weight: ``q * scale`` in f32, rounded once to ``dtype``."""
    return (t.q.to(torch.float32) * t.scale[..., None, :]).to(dtype)


def dequant_matmul(x: torch.Tensor, t: Int8Tensor) -> torch.Tensor:
    """``x @ W`` in x's dtype with the scale applied after the contraction
    (a 3-D leaf goes through the materialized weight)."""
    if t.q.ndim != 2:
        return x @ decode(t, x.dtype)
    return (x @ t.q.to(x.dtype)) * t.scale.to(x.dtype)


def quantize_tree(state: dict, predicate=None) -> dict:
    """Quantize every 2-D tensor of a flat state ``{name: tensor}`` (or
    those where ``predicate(name, tensor)`` holds) to int8; other entries
    pass through (the counterpart of :func:`.nf4.quantize_tree`)."""
    def is_target(name, leaf):
        if predicate is not None:
            return predicate(name, leaf)
        return getattr(leaf, "ndim", 0) == 2

    return {name: quantize(leaf) if is_target(name, leaf) else leaf
            for name, leaf in state.items()}
