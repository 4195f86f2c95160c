"""Fused NF4 dequant-matmul: ``x @ dequant(W)`` with W streamed in 4 bits.

Port of ``llm_in_practise_tpu/ops/nf4_matmul.py`` (forward). On a CUDA
tensor :func:`nf4_matmul` launches the hand-written Hopper kernel in
``csrc/nf4_matmul.cu`` or raises; on a CPU tensor it runs the plain
version :func:`nf4_matmul_reference`, which does the same arithmetic
(bf16 operands, f32 sums) in plain tensor ops. There is no fallback from
the kernel to the plain version.

``nf4_matmul.launches`` counts the wrapper's kernel launches.
"""

from __future__ import annotations

import functools
import math

import torch

from llm_in_practise_tpu_torch.ops import _build
from llm_in_practise_tpu_torch.quant import nf4
from llm_in_practise_tpu_torch.quant.nf4 import NF4Tensor

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_BK = 64    # K rows per kernel chunk (one absmax block)
_BNH = 32   # packed byte columns per kernel block


def nf4_matmul_reference(x: torch.Tensor, t: NF4Tensor,
                         out_dtype=None) -> torch.Tensor:
    """Plain version: bf16 operands, f32 products and sums."""
    out_dtype = out_dtype or x.dtype
    w = nf4.dequantize(t, torch.bfloat16).float()
    return (x.to(torch.bfloat16).float() @ w).to(out_dtype)


def split_k_for(m: int, k: int, n: int, sm_count: int) -> int:
    """How many K splits the kernel's grid takes: enough blocks for about
    four per SM, with at least four 64-row chunks in each split."""
    blocks = math.ceil(n // 2 / _BNH) * math.ceil(m / (16 if m <= 16 else 64))
    target = 4 * sm_count
    if blocks >= target:
        return 1
    return max(1, min(math.ceil(target / blocks), (k // _BK) // 4))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x: torch.Tensor, t: NF4Tensor) -> tuple[int, int]:
    if t.layout != "kblock":
        raise ValueError(
            "the CUDA nf4_matmul takes kblock-layout weights only; got "
            f"layout {t.layout!r} for shape {t.shape}")
    k, n = t.shape
    if x.shape[-1] != k:
        raise ValueError(f"x has K={x.shape[-1]}, weight has K={k}")
    if k % _BK or n % 2:
        raise ValueError(f"kernel needs K % 64 == 0 and even N, got {t.shape}")
    for name, a in (("packed", t.packed), ("absmax_q", t.absmax_q),
                    ("absmax_scale", t.absmax_scale),
                    ("absmax_offset", t.absmax_offset)):
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
    if t.packed.dtype != torch.uint8 or t.absmax_q.dtype != torch.uint8:
        raise TypeError("packed and absmax_q must be uint8")
    if (t.absmax_scale.dtype != torch.float32
            or t.absmax_offset.dtype != torch.float32):
        raise TypeError("absmax_scale and absmax_offset must be float32")
    if tuple(t.packed.shape) != (k, n // 2) or t.absmax_q.numel() != k // _BK * n:
        raise ValueError("packed/absmax_q sizes do not match the shape")
    return k, n


def nf4_matmul(x: torch.Tensor, t: NF4Tensor, out_dtype=None) -> torch.Tensor:
    """``x @ dequant(t)``. x: (..., K); t: kblock NF4Tensor of shape (K, N).
    Returns (..., N) in ``out_dtype`` (default x's dtype)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return nf4_matmul_reference(x, t, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"nf4_matmul runs on cuda or cpu, not {x.device}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    k, n = _check(x, t)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).to(torch.bfloat16).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    packed = t.packed.contiguous()
    absmax_q = t.absmax_q.contiguous()
    absmax_scale = t.absmax_scale.contiguous()
    offset = t.absmax_offset.reshape(1).contiguous()
    split = split_k_for(m, k, n, _sm_count(x.device.index))
    ws = (torch.empty((split, m, n), dtype=torch.float32, device=x.device)
          if split > 1 else out)

    lib = _build.load("nf4_matmul")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nf4_matmul_launch(
            x2.data_ptr(), packed.data_ptr(), absmax_q.data_ptr(),
            absmax_scale.data_ptr(), offset.data_ptr(), out.data_ptr(),
            ws.data_ptr(), m, k, n, split, _OUT_CODES[out_dtype], stream)
    if err != 0:
        msg = lib.nf4_cuda_error_string(err).decode()
        raise RuntimeError(
            f"nf4_matmul kernel launch failed (m={m}, k={k}, n={n}, "
            f"split_k={split}): cuda error {err}: {msg}")
    nf4_matmul.launches += 1
    return out.reshape(*lead, n)


nf4_matmul.launches = 0
