"""NF4 blockwise quantization with double quantization (bitsandbytes parity).

Port of ``llm_in_practise_tpu/quant/nf4.py``: the same codebook, the same
two layouts and the same byte layout, so packed exports written by the
JAX package load here byte for byte (:mod:`.io`).

- **NF4 codebook**: the 16 normal-float quantile values of QLoRA.
- **Blockwise absmax scaling** (block 64); two 4-bit codes per byte.
- **Double quantization**: the f32 absmax stream is itself quantized to
  8 bits in blocks of 256, with an f32 scale per block and one f32 mean
  offset (~4.13 bits per parameter in all).

This module is a codec written in plain tensor ops; it runs on whatever
device its inputs lie on. The fused dequant-matmul kernel that consumes
the ``"kblock"`` layout is :mod:`llm_in_practise_tpu_torch.ops.nf4_matmul`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# QLoRA NF4 data type: quantiles of N(0,1), asymmetric around the exact zero.
NF4_VALUES = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)
NF4_CODE = torch.tensor(NF4_VALUES, dtype=torch.float32)

BLOCK = 64          # weights per absmax block (bnb default)
SCALE_BLOCK = 256   # absmax values per double-quant block


@dataclasses.dataclass
class NF4Tensor:
    """Packed NF4 storage for one weight tensor.

    - ``"kblock"`` (2-D ``(K, N)`` kernels with ``K % 64 == 0`` and ``N``
      even): absmax blocks run along K; ``packed[k, i]`` holds
      ``code[k, i]`` in the high nibble and ``code[k, N//2 + i]`` in the
      low nibble; the absmax stream is ``(K//64, N)`` flattened.
    - ``"flat"`` (everything else): row-major flat blocks of 64, adjacent
      nibbles per byte.
    """

    packed: torch.Tensor         # uint8, two 4-bit codes per byte
    absmax_q: torch.Tensor       # uint8, double-quantized absmax (flat)
    absmax_scale: torch.Tensor   # (n_scale_blocks,) f32
    absmax_offset: torch.Tensor  # () f32, mean of absmax before quantization
    shape: tuple[int, ...]
    layout: str = "flat"

    def to(self, device) -> "NF4Tensor":
        return NF4Tensor(
            self.packed.to(device), self.absmax_q.to(device),
            self.absmax_scale.to(device), self.absmax_offset.to(device),
            tuple(self.shape), self.layout)


def _code(device) -> torch.Tensor:
    return NF4_CODE.to(device)


def _nearest_codes(scaled: torch.Tensor) -> torch.Tensor:
    # nearest codebook entry by searchsorted on the 15 midpoints
    code = _code(scaled.device)
    midpoints = (code[1:] + code[:-1]) / 2.0
    return torch.searchsorted(midpoints, scaled.contiguous()).to(torch.uint8)


def _double_quant(absmax: torch.Tensor):
    """8-bit blockwise quantization of the (flat) absmax stream."""
    offset = torch.mean(absmax)
    centered = absmax - offset
    s_pad = (-centered.numel()) % SCALE_BLOCK
    if s_pad:
        centered = torch.nn.functional.pad(centered, (0, s_pad))
    s_blocks = centered.reshape(-1, SCALE_BLOCK)
    s_scale = torch.amax(torch.abs(s_blocks), dim=1) / 127.0
    q = torch.round(s_blocks / torch.clamp(s_scale, min=1e-12)[:, None])
    absmax_q = (q + 128).to(torch.uint8).reshape(-1)[: absmax.numel()]
    return absmax_q.contiguous(), s_scale, offset


def _double_dequant(t: NF4Tensor) -> torch.Tensor:
    nb = t.absmax_q.shape[0]
    aq = t.absmax_q.to(torch.float32) - 128.0
    s_pad = (-nb) % SCALE_BLOCK
    if s_pad:
        aq = torch.nn.functional.pad(aq, (0, s_pad))
    return (aq.reshape(-1, SCALE_BLOCK) * t.absmax_scale[:, None]
            ).reshape(-1)[:nb] + t.absmax_offset


def quantize(w: torch.Tensor | np.ndarray) -> NF4Tensor:
    """Blockwise NF4 quantization with double-quantized absmax. Runs on
    ``w``'s device (a numpy input is quantized on the CPU)."""
    w = torch.as_tensor(w).to(torch.float32)
    shape = tuple(w.shape)
    if len(shape) == 2 and shape[0] % BLOCK == 0 and shape[1] % 2 == 0:
        k, n = shape
        blocks = w.reshape(k // BLOCK, BLOCK, n)
        absmax = torch.amax(torch.abs(blocks), dim=1)             # (K/64, N)
        scaled = blocks / torch.clamp(absmax, min=1e-12)[:, None, :]
        codes = _nearest_codes(scaled).reshape(k, n)
        packed = (codes[:, : n // 2] << 4) | codes[:, n // 2:]    # (K, N/2)
        absmax_q, s_scale, offset = _double_quant(absmax.reshape(-1))
        return NF4Tensor(packed.contiguous(), absmax_q, s_scale, offset,
                         shape, "kblock")

    flat = w.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    absmax = torch.amax(torch.abs(blocks), dim=1)
    scaled = blocks / torch.clamp(absmax, min=1e-12)[:, None]
    codes = _nearest_codes(scaled).reshape(-1)
    packed = (codes[0::2] << 4) | codes[1::2]
    absmax_q, s_scale, offset = _double_quant(absmax)
    return NF4Tensor(packed.contiguous(), absmax_q, s_scale, offset,
                     shape, "flat")


def kblock_arrays(t: NF4Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(packed (K, N//2) uint8, absmax (K//64, N) f32) of a kblock tensor."""
    if t.layout != "kblock":
        raise ValueError("not a kblock tensor")
    k, n = t.shape
    return t.packed, _double_dequant(t).reshape(k // BLOCK, n)


def dequantize(t: NF4Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Unpack nibbles, look up the codebook, scale by the block absmax.
    The product is taken in f32 and rounded to ``dtype`` once."""
    code = _code(t.packed.device)
    if t.layout == "kblock":
        k, n = t.shape
        p = t.packed.to(torch.int32)
        codes = torch.cat([(p >> 4) & 0xF, p & 0xF], dim=1)        # (K, N)
        vals = code[codes]
        absmax = _double_dequant(t).reshape(k // BLOCK, 1, n)
        w = (vals.reshape(k // BLOCK, BLOCK, n) * absmax).reshape(k, n)
        return w.to(dtype)
    hi = (t.packed >> 4).to(torch.int64)
    lo = (t.packed & 0xF).to(torch.int64)
    codes = torch.stack([hi, lo], dim=1).reshape(-1)
    vals = code[codes]
    absmax = _double_dequant(t)
    w = (vals.reshape(-1, BLOCK) * absmax[:, None]).reshape(-1)
    n = int(np.prod(t.shape))
    return w[:n].reshape(t.shape).to(dtype)
