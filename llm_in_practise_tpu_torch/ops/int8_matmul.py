"""Fused W8A16 int8 matmul: int8 weights streamed, scale after the sum.

Port of ``llm_in_practise_tpu/ops/int8_matmul.py``, forward and backward.
On a CUDA tensor :func:`int8_matmul` (``(x @ q) * scale``) and
:func:`int8_matmul_backward` (``dx = bf16(dy * scale) @ q^T``) launch the
hand-written Hopper kernels in ``csrc/int8_matmul.cu``, or raise; the
forward has two kernels, picked by shape (:func:`_route`): the thin-M
streaming kernel of ``csrc/qmm_thin.cuh`` (``Int8Thin``: one launch per
call, the K splits of a column slab reduced inside a thread-block cluster,
the scale on the whole sum) for decode and short prefill row counts, and
the ``wgmma`` mainloop of ``csrc/qmm_wgmma.cuh`` for prefill and training
ones. On a CPU tensor they run the plain versions
:func:`int8_matmul_reference` and :func:`int8_matmul_backward_reference`,
which do the same arithmetic with the same rounding points in plain
tensor ops. There is no fallback from a
kernel to its plain version.

The JAX package routes int8 serving to XLA because of a TPU measurement;
the port runs every int8 projection through the kernel (its time beside
cuBLAS is in ``PERF.md``). The weight is a frozen export:
:class:`Int8Matmul` differentiates with respect to ``x`` only.
``int8_matmul.launches`` and ``int8_matmul_backward.launches`` count the
kernel launches, and ``int8_matmul.launches_by_route`` the forward's by
route. A stacked (3-D) leaf raises ``ValueError``: a scan-layout tree is
unstacked before it reaches a model.
"""

from __future__ import annotations

import torch

from llm_in_practise_tpu_torch.ops import _build, launch_count
from llm_in_practise_tpu_torch.ops.nf4_matmul import (
    _OUT_CODES,
    ROUTES,
    _aligned,
)
from llm_in_practise_tpu_torch.quant.int8 import Int8Tensor


def _two_d(t: Int8Tensor) -> None:
    if t.q.ndim != 2:
        raise ValueError(
            f"a stacked int8 leaf (q of shape {tuple(t.q.shape)}) has no "
            "single weight to multiply; unstack the scan-layout tree first "
            "(models.convert.unstack_layer_params)")


def int8_matmul_reference(x: torch.Tensor, t: Int8Tensor,
                          out_dtype=None) -> torch.Tensor:
    """Plain version: bf16 x, f32 sums, the scale on the f32 sum."""
    _two_d(t)
    out_dtype = out_dtype or x.dtype
    y = x.to(torch.bfloat16).float() @ t.q.float()
    return (y * t.scale).to(out_dtype)


def int8_matmul_backward_reference(dy: torch.Tensor, t: Int8Tensor,
                                   out_dtype=None) -> torch.Tensor:
    """Plain version of the backward: ``bf16(f32(dy) * scale) @ q^T`` with
    f32 sums."""
    _two_d(t)
    out_dtype = out_dtype or dy.dtype
    dys = (dy.float() * t.scale).to(torch.bfloat16).float()
    return (dys @ t.q.float().T).to(out_dtype)


def _check_weight(t: Int8Tensor, device: torch.device) -> tuple[int, int]:
    _two_d(t)
    k, n = t.q.shape
    for name, a in (("q", t.q), ("scale", t.scale)):
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, the input on {device}")
    if t.q.dtype != torch.int8 or t.scale.dtype != torch.float32:
        raise TypeError("q must be int8 and scale float32")
    if tuple(t.scale.shape) != (n,):
        raise ValueError(f"scale has shape {tuple(t.scale.shape)}, q "
                         f"{tuple(t.q.shape)}")
    return k, n


def _error(lib, err: int, what: str, **shape) -> RuntimeError:
    msg = lib.int8_cuda_error_string(err).decode()
    dims = ", ".join(f"{k}={v}" for k, v in shape.items())
    return RuntimeError(f"{what} kernel launch failed ({dims}): cuda error "
                        f"{err}: {msg}")


def int8_matmul(x: torch.Tensor, t: Int8Tensor, out_dtype=None
                ) -> torch.Tensor:
    """``(x @ q) * scale``. x: (..., K); t: 2-D Int8Tensor (K, N). Returns
    (..., N) in ``out_dtype`` (default x's dtype). Differentiable in ``x``
    (:class:`Int8Matmul`)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return Int8Matmul.apply(x, t, out_dtype)
    return _forward(x, t, out_dtype)


# The forward's smallest row count on the wgmma route, from chip_smoke's
# crossover table (one layer's 7 Qwen3-8B projections, device time): the
# thin-M kernel is faster from M = 1 to 128 and the wgmma mainloop from 256
# up (the times are in PERF.md section 6).
WGMMA_MIN_M = 256


def _wgmma_shape(k: int, n: int) -> bool:
    """Whether the wgmma forward takes the shape: TMA row strides of 2K (x)
    and N (q) bytes in 16-byte multiples."""
    return k % 8 == 0 and n % 16 == 0


def _thin_shape(k: int, n: int) -> bool:
    """Whether the thin-M forward takes the shape: any K and N from 1 (TMA
    where K % 8 == 0 and N % 16 == 0, plain loads otherwise)."""
    return k >= 1 and n >= 1


def _route(m: int, k: int, n: int) -> str:
    """The forward kernel for ``(m, k) @ (k, n)``: "wgmma"
    (``qmm_wgmma_kernel<Int8Fwd>``) for the shapes it takes at
    ``m >= WGMMA_MIN_M``, else "thin" (``qmm_thin_kernel<Int8Thin>``)."""
    return "wgmma" if m >= WGMMA_MIN_M and _wgmma_shape(k, n) else "thin"


def _checked_route(m: int, k: int, n: int, route: str | None) -> str:
    """``route`` if the shape takes it, :func:`_route`'s pick if None."""
    if route is None:
        return _route(m, k, n)
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "wgmma" and not _wgmma_shape(k, n):
        raise ValueError(f"the wgmma forward needs K % 8 == 0 and "
                         f"N % 16 == 0; got K={k}, N={n}")
    if route == "thin" and not _thin_shape(k, n):
        raise ValueError(f"the thin forward needs K >= 1 and N >= 1; got "
                         f"K={k}, N={n}")
    return route


def _forward(x: torch.Tensor, t: Int8Tensor, out_dtype=None,
             route: str | None = None) -> torch.Tensor:
    """The forward; ``route`` overrides :func:`_route` (to time both
    kernels at one shape)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_matmul_reference(x, t, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu, not {x.device}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    k, n = _check_weight(t, x.device)
    if x.shape[-1] != k:
        raise ValueError(f"x has K={x.shape[-1]}, weight has K={k}")
    lead = x.shape[:-1]
    x2 = _aligned(x.reshape(-1, k).to(torch.bfloat16))
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    route = _checked_route(m, k, n, route)
    q, scale = _aligned(t.q), _aligned(t.scale)
    lib = _build.load("int8_matmul")
    launch = (lib.int8_matmul_wgmma_launch if route == "wgmma"
              else lib.int8_matmul_thin_launch)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
                     out.data_ptr(), m, k, n, _OUT_CODES[out_dtype], stream)
    if err != 0:
        raise _error(lib, err, f"int8_matmul ({route})", m=m, k=k, n=n)
    launch_count.count(int8_matmul, route)
    return out.reshape(*lead, n)


launch_count.counter(int8_matmul, ROUTES)


def int8_matmul_backward(dy: torch.Tensor, t: Int8Tensor, out_dtype=None
                         ) -> torch.Tensor:
    """``dx = bf16(f32(dy) * scale) @ q^T``. dy: (..., N); t: 2-D
    Int8Tensor (K, N). Returns (..., K) in ``out_dtype`` (default dy's
    dtype). The CUDA kernel needs N % 16 == 0."""
    out_dtype = out_dtype or dy.dtype
    if dy.device.type == "cpu":
        return int8_matmul_backward_reference(dy, t, out_dtype)
    if dy.device.type != "cuda":
        raise ValueError(
            f"int8_matmul_backward runs on cuda or cpu, not {dy.device}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    k, n = _check_weight(t, dy.device)
    if dy.shape[-1] != n:
        raise ValueError(f"dy has N={dy.shape[-1]}, weight has N={n}")
    if n % 16:
        raise ValueError(f"the backward kernel needs N % 16 == 0, got "
                         f"shape {tuple(t.q.shape)}")
    lead = dy.shape[:-1]
    dy2 = dy.reshape(-1, n)
    scale = _aligned(t.scale)
    # the rounding point: scale in f32 first, then one bf16 rounding; the
    # launch does it for a bf16 dy (into the scratch dys), the wrapper here
    # for any other dtype
    prescaled = dy2.dtype != torch.bfloat16
    if prescaled:
        dy2 = (dy2.float() * scale).to(torch.bfloat16)
    dy2 = _aligned(dy2)
    m = dy2.shape[0]
    dx = torch.empty((m, k), dtype=out_dtype, device=dy.device)
    if m == 0:
        return dx.reshape(*lead, k)
    scale_ptr, dys_ptr = None, None
    if not prescaled:
        dys = torch.empty((m, n), dtype=torch.bfloat16, device=dy.device)
        scale_ptr, dys_ptr = scale.data_ptr(), dys.data_ptr()
    q = _aligned(t.q)
    lib = _build.load("int8_matmul")
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream(dy.device).cuda_stream
        err = lib.int8_matmul_bwd_launch(
            dy2.data_ptr(), q.data_ptr(), scale_ptr, dys_ptr, dx.data_ptr(),
            m, k, n, _OUT_CODES[out_dtype], stream)
    if err != 0:
        raise _error(lib, err, "int8_matmul_backward", m=m, k=k, n=n)
    launch_count.count(int8_matmul_backward)
    return dx.reshape(*lead, k)


launch_count.counter(int8_matmul_backward)


class Int8Matmul(torch.autograd.Function):
    """``y = (x @ q) * scale`` with ``dx = bf16(dy * scale) @ q^T``; the
    int8 weight is frozen storage and gets no gradient."""

    @staticmethod
    def forward(ctx, x, t, out_dtype):
        ctx.t = t
        ctx.x_dtype = x.dtype
        return _forward(x, t, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        dx = None
        if ctx.needs_input_grad[0]:
            dx = int8_matmul_backward(dy, ctx.t, ctx.x_dtype)
        return dx, None, None
