"""W4A16 packed integer-4 storage: the export format GPTQ and AWQ share.

Port of ``llm_in_practise_tpu/quant/int4.py``: group-wise affine int4
codes packed two per byte, with per-(group, out-channel) scales and
zero-points, in the same byte layout, so packed exports written by the
JAX package load here byte for byte (:mod:`.io`).

Convention: weights are ``(in_features, out_features)`` (flax kernel
layout); groups run along the *input* dimension (GPTQ/AWQ
``group_size``); ``packed[i, n]`` holds the codes of input rows ``2i``
(high nibble) and ``2i + 1`` (low nibble) of column ``n``.

This module is a codec written in plain tensor ops; it runs on whatever
device its inputs lie on. The fused dequant-matmul kernel that consumes
the packed bytes is :mod:`llm_in_practise_tpu_torch.ops.int4_matmul`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Int4Tensor:
    """Group-quantized int4 weight: ``w = (code - zero) * scale`` with
    per-group, per-column scale and zero (zeros may be fractional)."""

    packed: torch.Tensor   # (ceil(in/2), out) uint8
    scales: torch.Tensor   # (n_groups, out) f32
    zeros: torch.Tensor    # (n_groups, out) f32
    group_size: int
    shape: tuple[int, ...]  # (in, out)

    @property
    def nbytes(self) -> int:
        return self.packed.nbytes + self.scales.nbytes + self.zeros.nbytes

    def to(self, device) -> "Int4Tensor":
        return Int4Tensor(self.packed.to(device), self.scales.to(device),
                          self.zeros.to(device), self.group_size,
                          tuple(self.shape))


def quant_params_for_group(w_group: torch.Tensor, *, sym: bool
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-column (scale, zero) for one ``(group_size, out)`` block, or
    for each block of a ``(n_groups, group_size, out)`` stack."""
    if sym:
        absmax = torch.amax(torch.abs(w_group), dim=-2)
        scale = torch.clamp(absmax / 7.0, min=1e-12)
        zero = torch.full_like(scale, 8.0)
    else:
        lo = torch.clamp(torch.amin(w_group, dim=-2), max=0.0)
        hi = torch.clamp(torch.amax(w_group, dim=-2), min=0.0)
        scale = torch.clamp((hi - lo) / 15.0, min=1e-12)
        zero = torch.round(-lo / scale)
    return scale, zero


def quantize_column(w: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor) -> torch.Tensor:
    """Snap one weight column (out,) to its int4 grid, returning *values*."""
    code = torch.clamp(torch.round(w / scale + zero), 0, 15)
    return (code - zero) * scale


def _group_index(n_groups: int, group_size: int, rows: int, device
                 ) -> torch.Tensor:
    return torch.arange(n_groups, device=device).repeat_interleave(
        group_size)[:rows]


def encode(w: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
           group_size: int) -> Int4Tensor:
    """Quantize ``w`` (in, out) to packed codes given per-group params."""
    w = torch.as_tensor(w).to(torch.float32)
    d_in, d_out = w.shape
    g = _group_index(scales.shape[0], group_size, d_in, w.device)
    code = torch.clamp(torch.round(w / scales[g] + zeros[g]), 0, 15).to(
        torch.uint8)
    if d_in % 2:
        code = torch.nn.functional.pad(code, (0, 0, 0, 1))
    packed = (code[0::2] << 4) | code[1::2]
    return Int4Tensor(packed.contiguous(), scales, zeros, group_size,
                      (d_in, d_out))


def decode(t: Int4Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Unpack to dense ``(in, out)`` weights: ``(code - zero) * scale`` in
    f32, rounded once to ``dtype``."""
    hi = (t.packed >> 4).to(torch.float32)
    lo = (t.packed & 0xF).to(torch.float32)
    code = torch.stack([hi, lo], dim=1).reshape(-1, t.shape[1])[: t.shape[0]]
    g = _group_index(t.scales.shape[0], t.group_size, t.shape[0],
                     t.packed.device)
    return ((code - t.zeros[g]) * t.scales[g]).to(dtype)


def rtn_quantize(w: torch.Tensor | np.ndarray, *, group_size: int = 128,
                 sym: bool = True) -> Int4Tensor:
    """Round-to-nearest (no Hessian compensation): GPTQModel's storage
    (``bits=4, group_size=128``) with RTN codes. Runs on ``w``'s device
    (a numpy input is quantized on the CPU)."""
    w = torch.as_tensor(w).to(torch.float32)
    d_in, d_out = w.shape
    pad = (-d_in) % group_size
    wp = torch.nn.functional.pad(w, (0, 0, 0, pad)) if pad else w
    scales, zeros = quant_params_for_group(
        wp.reshape(-1, group_size, d_out), sym=sym)
    return encode(w, scales, zeros, group_size)


def dequant_matmul(x: torch.Tensor, t: Int4Tensor) -> torch.Tensor:
    """``x @ W`` through the materialized weight, in x's dtype."""
    return x @ decode(t, x.dtype)
