"""Fused NF4 dequant-matmul: ``x @ dequant(W)`` with W streamed in 4 bits.

Port of ``llm_in_practise_tpu/ops/nf4_matmul.py``, forward and backward.
On a CUDA tensor :func:`nf4_matmul` launches the hand-written Hopper
kernels in ``csrc/nf4_matmul.cu`` and :func:`nf4_matmul_backward` the one
in ``csrc/nf4_matmul_bwd.cu`` (``dx = dy @ dequant(W)^T``), or raise; the
forward has two kernels, picked by shape (:func:`_route`): the thin-M
streaming kernel of ``csrc/qmm_thin.cuh`` (``Nf4Thin``: one launch per
call, the K splits of a column slab reduced inside a thread-block cluster)
for decode and short prefill row counts, and the ``wgmma`` mainloop of
``csrc/qmm_wgmma.cuh`` (which the backward runs on too) for prefill and
training ones. On a CPU tensor they run the plain versions
:func:`nf4_matmul_reference` and :func:`nf4_matmul_backward_reference`,
which do the same arithmetic (bf16 operands, f32 sums) in plain tensor
ops. There is no fallback from a kernel to its plain version.

The base is frozen (QLoRA): :class:`NF4Matmul` differentiates with
respect to ``x`` only, and only where autograd asks for it.
``nf4_matmul.launches`` and ``nf4_matmul_backward.launches`` count the
kernel launches, and ``nf4_matmul.launches_by_route`` the forward's by
route.
"""

from __future__ import annotations

import torch

from llm_in_practise_tpu_torch.ops import _build, launch_count
from llm_in_practise_tpu_torch.quant import nf4
from llm_in_practise_tpu_torch.quant.nf4 import NF4Tensor

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_BK = 64    # K rows per absmax block


def nf4_matmul_reference(x: torch.Tensor, t: NF4Tensor,
                         out_dtype=None) -> torch.Tensor:
    """Plain version: bf16 operands, f32 products and sums."""
    out_dtype = out_dtype or x.dtype
    w = nf4.dequantize(t, torch.bfloat16).float()
    return (x.to(torch.bfloat16).float() @ w).to(out_dtype)


def _aligned(a: torch.Tensor) -> torch.Tensor:
    """``a`` contiguous at a 16-byte aligned address (the kernels' 16-byte
    copies and TMA descriptors need it)."""
    a = a.contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()


def _check_weight(t: NF4Tensor, device: torch.device, what: str
                  ) -> tuple[int, int]:
    """(K, N) of a weight the kernels can read on ``device``."""
    if t.layout != "kblock":
        raise ValueError(
            f"the CUDA {what} takes kblock-layout weights only; got "
            f"layout {t.layout!r} for shape {t.shape}")
    k, n = t.shape
    if k % _BK or n % 2:
        raise ValueError(f"kernel needs K % 64 == 0 and even N, got {t.shape}")
    for name, a in (("packed", t.packed), ("absmax_q", t.absmax_q),
                    ("absmax_scale", t.absmax_scale),
                    ("absmax_offset", t.absmax_offset)):
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, the input on {device}")
    if t.packed.dtype != torch.uint8 or t.absmax_q.dtype != torch.uint8:
        raise TypeError("packed and absmax_q must be uint8")
    if (t.absmax_scale.dtype != torch.float32
            or t.absmax_offset.dtype != torch.float32):
        raise TypeError("absmax_scale and absmax_offset must be float32")
    if (tuple(t.packed.shape) != (k, n // 2)
            or t.absmax_q.numel() != k // _BK * n
            or t.absmax_scale.numel() != -(-(k // _BK * n) // nf4.SCALE_BLOCK)):
        raise ValueError(
            "packed/absmax_q/absmax_scale sizes do not match the shape")
    return k, n


def _check(x: torch.Tensor, t: NF4Tensor) -> tuple[int, int]:
    k, n = _check_weight(t, x.device, "nf4_matmul")
    if x.shape[-1] != k:
        raise ValueError(f"x has K={x.shape[-1]}, weight has K={k}")
    return k, n


def nf4_matmul(x: torch.Tensor, t: NF4Tensor, out_dtype=None) -> torch.Tensor:
    """``x @ dequant(t)``. x: (..., K); t: kblock NF4Tensor of shape (K, N).
    Returns (..., N) in ``out_dtype`` (default x's dtype). Differentiable
    in ``x`` (:class:`NF4Matmul`)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return NF4Matmul.apply(x, t, out_dtype)
    return _forward(x, t, out_dtype)


# The forward's smallest row count on the wgmma route, from chip_smoke's
# crossover table (one layer's 7 Qwen3-8B projections, device time): the
# thin-M kernel is faster from M = 1 to 128 and the wgmma mainloop from 256
# up (the times are in PERF.md section 6).
WGMMA_MIN_M = 256
# the forward's kernels, by route name (``launches_by_route`` keys)
ROUTES = ("wgmma", "thin")


def _wgmma_shape(k: int, n: int) -> bool:
    """Whether the wgmma forward takes the shape: K % 64 == 0 (one absmax
    row per 64-row stage; every kblock leaf has it) and N % 32 == 0 (the
    low half's packed columns and absmax runs, N/2 bytes in, must start
    16-byte aligned for TMA)."""
    return k % _BK == 0 and n % 32 == 0


def _thin_shape(k: int, n: int) -> bool:
    """Whether the thin-M forward takes the shape: every kblock shape (K a
    positive multiple of 64, N even and positive; TMA where N % 32 == 0,
    plain loads otherwise)."""
    return k > 0 and k % _BK == 0 and n > 0 and n % 2 == 0


def _route(m: int, k: int, n: int) -> str:
    """The forward kernel for ``(m, k) @ (k, n)``: "wgmma"
    (``qmm_wgmma_kernel<Nf4Fwd>``) for the shapes it takes at
    ``m >= WGMMA_MIN_M``, else "thin" (``qmm_thin_kernel<Nf4Thin>``)."""
    return "wgmma" if m >= WGMMA_MIN_M and _wgmma_shape(k, n) else "thin"


def _checked_route(m: int, k: int, n: int, route: str | None) -> str:
    """``route`` if the shape takes it, :func:`_route`'s pick if None."""
    if route is None:
        return _route(m, k, n)
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "wgmma" and not _wgmma_shape(k, n):
        raise ValueError(f"the wgmma forward needs K % 64 == 0 and "
                         f"N % 32 == 0; got K={k}, N={n}")
    if route == "thin" and not _thin_shape(k, n):
        raise ValueError(f"the thin forward needs K % 64 == 0 and an even "
                         f"N; got K={k}, N={n}")
    return route


def _forward(x: torch.Tensor, t: NF4Tensor, out_dtype=None,
             route: str | None = None) -> torch.Tensor:
    """The forward; ``route`` overrides :func:`_route` (to time both
    kernels at one shape)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return nf4_matmul_reference(x, t, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"nf4_matmul runs on cuda or cpu, not {x.device}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    k, n = _check(x, t)
    lead = x.shape[:-1]
    x2 = _aligned(x.reshape(-1, k).to(torch.bfloat16))
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    route = _checked_route(m, k, n, route)
    packed, absmax_q, absmax_scale = (
        _aligned(a) for a in (t.packed, t.absmax_q, t.absmax_scale))
    offset = t.absmax_offset.reshape(1).contiguous()
    lib = _build.load("nf4_matmul")
    launch = (lib.nf4_matmul_wgmma_launch if route == "wgmma"
              else lib.nf4_matmul_thin_launch)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x2.data_ptr(), packed.data_ptr(), absmax_q.data_ptr(),
                     absmax_scale.data_ptr(), offset.data_ptr(),
                     out.data_ptr(), m, k, n, _OUT_CODES[out_dtype], stream)
    if err != 0:
        msg = lib.nf4_cuda_error_string(err).decode()
        raise RuntimeError(
            f"nf4_matmul ({route}) kernel launch failed (m={m}, k={k}, "
            f"n={n}): cuda error {err}: {msg}")
    launch_count.count(nf4_matmul, route)
    return out.reshape(*lead, n)


launch_count.counter(nf4_matmul, ROUTES)


def nf4_matmul_backward_reference(dy: torch.Tensor, t: NF4Tensor,
                                  out_dtype=None) -> torch.Tensor:
    """Plain version of the backward: ``dy @ dequant(t)^T`` with bf16
    operands, f32 products and sums."""
    out_dtype = out_dtype or dy.dtype
    w = nf4.dequantize(t, torch.bfloat16).float()
    return (dy.to(torch.bfloat16).float() @ w.T).to(out_dtype)


def _check_backward(dy: torch.Tensor, t: NF4Tensor) -> tuple[int, int]:
    k, n = _check_weight(t, dy.device, "nf4_matmul_backward")
    if dy.shape[-1] != n:
        raise ValueError(f"dy has N={dy.shape[-1]}, weight has N={n}")
    if n % 64:
        raise ValueError(f"the backward kernel needs N % 64 == 0, got {n}")
    return k, n


def nf4_matmul_backward(dy: torch.Tensor, t: NF4Tensor,
                        out_dtype=None) -> torch.Tensor:
    """``dx = dy @ dequant(t)^T``. dy: (..., N); t: kblock NF4Tensor of
    shape (K, N). Returns (..., K) in ``out_dtype`` (default dy's dtype).
    The CUDA kernel needs K % 64 == 0 and N % 64 == 0."""
    out_dtype = out_dtype or dy.dtype
    if dy.device.type == "cpu":
        return nf4_matmul_backward_reference(dy, t, out_dtype)
    if dy.device.type != "cuda":
        raise ValueError(
            f"nf4_matmul_backward runs on cuda or cpu, not {dy.device}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    k, n = _check_backward(dy, t)
    lead = dy.shape[:-1]
    dy2 = _aligned(dy.reshape(-1, n).to(torch.bfloat16))
    m = dy2.shape[0]
    dx = torch.empty((m, k), dtype=out_dtype, device=dy.device)
    if m == 0:
        return dx.reshape(*lead, k)
    packed, absmax_q, absmax_scale = (
        _aligned(a) for a in (t.packed, t.absmax_q, t.absmax_scale))
    offset = t.absmax_offset.reshape(1).contiguous()
    lib = _build.load("nf4_matmul_bwd")
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream(dy.device).cuda_stream
        err = lib.nf4_matmul_bwd_launch(
            dy2.data_ptr(), packed.data_ptr(), absmax_q.data_ptr(),
            absmax_scale.data_ptr(), offset.data_ptr(), dx.data_ptr(), m, k,
            n, _OUT_CODES[out_dtype], stream)
    if err != 0:
        msg = lib.nf4_bwd_cuda_error_string(err).decode()
        raise RuntimeError(
            f"nf4_matmul_backward kernel launch failed (m={m}, k={k}, "
            f"n={n}): cuda error {err}: {msg}")
    launch_count.count(nf4_matmul_backward)
    return dx.reshape(*lead, k)


launch_count.counter(nf4_matmul_backward)


class NF4Matmul(torch.autograd.Function):
    """``y = x @ dequant(W)`` with ``dx = dy @ dequant(W)^T``; the NF4
    base is frozen storage, so it gets no gradient (the JAX package's
    ``custom_vjp`` returns ``None`` for it too)."""

    @staticmethod
    def forward(ctx, x, t, out_dtype):
        ctx.t = t
        ctx.x_dtype = x.dtype
        return _forward(x, t, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        dx = None
        if ctx.needs_input_grad[0]:
            dx = nf4_matmul_backward(dy, ctx.t, ctx.x_dtype)
        return dx, None, None
