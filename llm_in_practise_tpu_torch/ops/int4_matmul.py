"""Fused W4A16 int4 dequant-matmul, the GPTQ/AWQ serving kernel.

Port of ``llm_in_practise_tpu/ops/int4_matmul.py``, forward and backward.
On a CUDA tensor :func:`int4_matmul` (``x @ W``) and
:func:`int4_matmul_backward` (``dx = dy @ W^T``) launch the hand-written
Hopper kernels in ``csrc/int4_matmul.cu``, or raise; the forward has two
kernels, picked by shape (:func:`_route`): the thin-M streaming kernel
of ``csrc/qmm_thin.cuh`` (``Int4Thin``, one launch per call, the K splits
of a column slab reduced inside a thread-block cluster) for decode row
counts and the ``wgmma`` mainloop of ``csrc/qmm_wgmma.cuh`` for prefill
and training ones. On a CPU tensor they run the plain versions
:func:`int4_matmul_reference` and
:func:`int4_matmul_backward_reference`, which do the same arithmetic
(bf16 operands, the weight ``(code - zero) * scale`` in f32 rounded once
to bf16, f32 sums) in plain tensor ops. There is no fallback from a
kernel to its plain version.

The weight is a frozen export: :class:`Int4Matmul` differentiates with
respect to ``x`` only, and only where autograd asks for it.
``int4_matmul.launches`` and ``int4_matmul_backward.launches`` count the
kernel launches, and ``int4_matmul.launches_by_route`` the forward's by
route.
"""

from __future__ import annotations

import torch

from llm_in_practise_tpu_torch.ops import _build, launch_count
from llm_in_practise_tpu_torch.ops.nf4_matmul import _OUT_CODES, _aligned
from llm_in_practise_tpu_torch.quant import int4
from llm_in_practise_tpu_torch.quant.int4 import Int4Tensor


def int4_matmul_reference(x: torch.Tensor, t: Int4Tensor,
                          out_dtype=None) -> torch.Tensor:
    """Plain version: bf16 operands, f32 products and sums."""
    out_dtype = out_dtype or x.dtype
    w = int4.decode(t, torch.bfloat16).float()
    return (x.to(torch.bfloat16).float() @ w).to(out_dtype)


def int4_matmul_backward_reference(dy: torch.Tensor, t: Int4Tensor,
                                   out_dtype=None) -> torch.Tensor:
    """Plain version of the backward: ``dy @ W^T`` with bf16 operands, f32
    products and sums."""
    out_dtype = out_dtype or dy.dtype
    w = int4.decode(t, torch.bfloat16).float()
    return (dy.to(torch.bfloat16).float() @ w.T).to(out_dtype)


def _check_weight(t: Int4Tensor, device: torch.device, what: str
                  ) -> tuple[int, int, int]:
    """(K, N, n_groups) of a weight the kernels can read on ``device``."""
    k, n = t.shape
    gs = t.group_size
    if k % 2 or gs % 2:
        raise ValueError(
            f"the CUDA {what} needs an even K and an even group size; got "
            f"shape {tuple(t.shape)} with group_size {gs}")
    for name, a in (("packed", t.packed), ("scales", t.scales),
                    ("zeros", t.zeros)):
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, the input on {device}")
    if t.packed.dtype != torch.uint8:
        raise TypeError("packed must be uint8")
    if t.scales.dtype != torch.float32 or t.zeros.dtype != torch.float32:
        raise TypeError("scales and zeros must be float32")
    n_groups = t.scales.shape[0]
    if (tuple(t.packed.shape) != (k // 2, n)
            or tuple(t.scales.shape) != (n_groups, n)
            or tuple(t.zeros.shape) != (n_groups, n)
            or n_groups * gs < k):
        raise ValueError(f"packed/scales/zeros sizes do not match shape "
                         f"{tuple(t.shape)} with group_size {gs}")
    return k, n, n_groups


def _error(lib, err: int, what: str, **shape) -> RuntimeError:
    msg = lib.int4_cuda_error_string(err).decode()
    dims = ", ".join(f"{k}={v}" for k, v in shape.items())
    return RuntimeError(f"{what} kernel launch failed ({dims}): cuda error "
                        f"{err}: {msg}")


def int4_matmul(x: torch.Tensor, t: Int4Tensor, out_dtype=None
                ) -> torch.Tensor:
    """``x @ decode(t)``. x: (..., K); t: Int4Tensor of shape (K, N).
    Returns (..., N) in ``out_dtype`` (default x's dtype). Differentiable
    in ``x`` (:class:`Int4Matmul`)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return Int4Matmul.apply(x, t, out_dtype)
    return _forward(x, t, out_dtype)


# The forward's smallest row count on the wgmma route, from chip_smoke's
# crossover table (one layer's 7 Qwen3-8B projections, device time): the
# thin-M kernel is faster from M = 1 to 128 and the wgmma mainloop from 256
# up (the times are in PERF.md section 6).
WGMMA_MIN_M = 256


def _wgmma_shape(k: int, n: int, gs: int) -> bool:
    """Whether the wgmma forward takes the shape: TMA row strides of 2K (x),
    N (codes) and 4N (scales, zeros) bytes in 16-byte multiples, and whole
    group rows per 64-row stage."""
    return k % 8 == 0 and n % 16 == 0 and (gs % 64 == 0 or 64 % gs == 0)


# the forward's kernels, by route name (``launches_by_route`` keys)
ROUTES = ("wgmma", "thin")


def _thin_shape(k: int, gs: int) -> bool:
    """Whether the thin-M kernel takes the shape: a byte's two K rows in
    one group (even K, even group size); any M and N."""
    return k % 2 == 0 and gs % 2 == 0


def _route(m: int, k: int, n: int, gs: int) -> str:
    """The forward kernel for ``(m, k) @ (k, n)`` at group size ``gs``:
    "wgmma" (``qmm_wgmma_kernel<Int4Fwd>``) for the shapes it takes at
    ``m >= WGMMA_MIN_M``, else "thin" (``qmm_thin_kernel<Int4Thin>``)."""
    return "wgmma" if m >= WGMMA_MIN_M and _wgmma_shape(k, n, gs) \
        else "thin"


def _checked_route(m: int, k: int, n: int, gs: int, route: str | None
                   ) -> str:
    """``route`` if the shape takes it, :func:`_route`'s pick if None."""
    if route is None:
        return _route(m, k, n, gs)
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "wgmma" and not _wgmma_shape(k, n, gs):
        raise ValueError(f"the wgmma forward needs K % 8 == 0, N % 16 == 0 "
                         f"and gs % 64 == 0 or 64 % gs == 0; got K={k}, "
                         f"N={n} with group_size {gs}")
    if route == "thin" and not _thin_shape(k, gs):
        raise ValueError(f"the thin forward needs an even K and an even "
                         f"group size; got K={k} with group_size {gs}")
    return route


def _forward(x: torch.Tensor, t: Int4Tensor, out_dtype=None,
             route: str | None = None) -> torch.Tensor:
    """The forward; ``route`` overrides :func:`_route` (to time both
    kernels at one shape)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int4_matmul_reference(x, t, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul runs on cuda or cpu, not {x.device}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    k, n, n_groups = _check_weight(t, x.device, "int4_matmul")
    if x.shape[-1] != k:
        raise ValueError(f"x has K={x.shape[-1]}, weight has K={k}")
    gs = t.group_size
    lead = x.shape[:-1]
    x2 = _aligned(x.reshape(-1, k).to(torch.bfloat16))
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    route = _checked_route(m, k, n, gs, route)
    packed, scales, zeros = (_aligned(a) for a in (t.packed, t.scales,
                                                   t.zeros))
    lib = _build.load("int4_matmul")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "wgmma":
            err = lib.int4_matmul_wgmma_launch(
                x2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                zeros.data_ptr(), out.data_ptr(), m, k, n, gs, n_groups,
                _OUT_CODES[out_dtype], stream)
        else:
            err = lib.int4_matmul_thin_launch(
                x2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                zeros.data_ptr(), out.data_ptr(), m, k, n, gs, n_groups,
                _OUT_CODES[out_dtype], stream)
    if err != 0:
        raise _error(lib, err, f"int4_matmul ({route})", m=m, k=k, n=n,
                     group_size=gs)
    launch_count.count(int4_matmul, route)
    return out.reshape(*lead, n)


launch_count.counter(int4_matmul, ROUTES)


def int4_matmul_backward(dy: torch.Tensor, t: Int4Tensor, out_dtype=None
                         ) -> torch.Tensor:
    """``dx = dy @ decode(t)^T``. dy: (..., N); t: Int4Tensor of shape
    (K, N). Returns (..., K) in ``out_dtype`` (default dy's dtype). The
    CUDA kernel also needs N % 16 == 0."""
    out_dtype = out_dtype or dy.dtype
    if dy.device.type == "cpu":
        return int4_matmul_backward_reference(dy, t, out_dtype)
    if dy.device.type != "cuda":
        raise ValueError(
            f"int4_matmul_backward runs on cuda or cpu, not {dy.device}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    k, n, n_groups = _check_weight(t, dy.device, "int4_matmul_backward")
    if dy.shape[-1] != n:
        raise ValueError(f"dy has N={dy.shape[-1]}, weight has N={n}")
    if n % 16:
        raise ValueError(f"the backward kernel needs N % 16 == 0, got "
                         f"shape {tuple(t.shape)}")
    lead = dy.shape[:-1]
    dy2 = _aligned(dy.reshape(-1, n).to(torch.bfloat16))
    m = dy2.shape[0]
    dx = torch.empty((m, k), dtype=out_dtype, device=dy.device)
    if m == 0:
        return dx.reshape(*lead, k)
    packed, scales, zeros = (_aligned(a) for a in (t.packed, t.scales,
                                                   t.zeros))
    lib = _build.load("int4_matmul")
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream(dy.device).cuda_stream
        err = lib.int4_matmul_bwd_launch(
            dy2.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            zeros.data_ptr(), dx.data_ptr(), m, k, n, t.group_size, n_groups,
            _OUT_CODES[out_dtype], stream)
    if err != 0:
        raise _error(lib, err, "int4_matmul_backward", m=m, k=k, n=n,
                     group_size=t.group_size)
    launch_count.count(int4_matmul_backward)
    return dx.reshape(*lead, k)


launch_count.counter(int4_matmul_backward)


class Int4Matmul(torch.autograd.Function):
    """``y = x @ W`` with ``dx = dy @ W^T``; the int4 weight is frozen
    storage and gets no gradient (the JAX ``custom_vjp`` returns ``None``
    for it too)."""

    @staticmethod
    def forward(ctx, x, t, out_dtype):
        ctx.t = t
        ctx.x_dtype = x.dtype
        return _forward(x, t, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        dx = None
        if ctx.needs_input_grad[0]:
            dx = int4_matmul_backward(dy, ctx.t, ctx.x_dtype)
        return dx, None, None
