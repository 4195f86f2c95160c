"""Causal flash attention (port of ``llm_in_practise_tpu/ops/flash_attention.py``).

On CUDA tensors the three hand-written Hopper kernels of
``csrc/flash_attention.cu`` run: the forward (O and the per-row LSE), and
the FlashAttention-2 backward as one dK/dV kernel and one dQ kernel, from
the saved LSE and ``delta = rowsum(dO * O)``. On CPU tensors the plain
versions :func:`flash_forward_reference` and :func:`flash_backward_reference`
compute the same functions in f32 tensor ops. There is no fallback from a
kernel to its plain version.

Layout: ``(B, L, H, D)`` for q and ``(B, L, Hkv, D)`` for k/v with
``H % Hkv == 0``: GQA is native, K and V are not repeated (the JAX entry
point requires equal heads and repeats them in ``ops/attention.py``).
The kernels read strided inputs and mask the ragged edge; nothing is
padded to the 128 tile. Causal only, as in the reference. The kernels
take bf16 and ``head_dim`` 64 or 128.

``flash_forward.launches``, ``flash_backward_dkv.launches`` and
``flash_backward_dq.launches`` count the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from llm_in_practise_tpu_torch.ops import _build, launch_count

KERNEL_HEAD_DIMS = (64, 128)


def _groups(q: torch.Tensor, k: torch.Tensor) -> int:
    b, length, n_head, head_dim = q.shape
    if k.shape[0] != b or k.shape[1] != length or k.shape[3] != head_dim:
        raise ValueError(
            f"flash attention needs k/v of shape (B, L, Hkv, D) matching q "
            f"{tuple(q.shape)}, got {tuple(k.shape)}")
    if n_head % k.shape[2]:
        raise ValueError(f"n_head ({n_head}) must be a multiple of the kv "
                         f"heads ({k.shape[2]})")
    return n_head // k.shape[2]


def _scores(q, k, scale):
    """(B, Hkv, G, L, L) f32 causal scores; masked entries are -inf."""
    b, length, n_head, d = q.shape
    g = n_head // k.shape[2]
    q5 = q.float().reshape(b, length, k.shape[2], g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5, k.float()) * scale
    keep = torch.ones(length, length, dtype=torch.bool,
                      device=q.device).tril()
    return s.masked_fill(~keep, float("-inf"))


def flash_forward_reference(q, k, v, scale: float):
    """Plain version of the forward: f32 scores and softmax. Returns O in
    q's dtype, (B, L, H, D), and the natural-log LSE, f32 (B, H, L)."""
    b, length, n_head, d = q.shape
    _groups(q, k)
    s = _scores(q, k, scale)
    lse = torch.logsumexp(s, dim=-1)                       # (B, Hkv, G, L)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return (out.reshape(b, length, n_head, d).to(q.dtype),
            lse.reshape(b, n_head, length))


def flash_backward_reference(q, k, v, out, lse, dout, scale: float):
    """Plain version of the backward: the FlashAttention-2 formulas in f32
    (``delta = rowsum(dO * O)``, ``P = exp(S - LSE)``,
    ``dS = P * (dP - delta)``). Returns (dq, dk, dv) in the inputs' dtypes."""
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)
    return _backward_from_delta(q, k, v, dout, lse, delta, scale)


def _backward_from_delta(q, k, v, dout, lse, delta, scale: float):
    """(dq, dk, dv) from the saved LSE and ``delta``, both (B, H, L) f32."""
    b, length, n_head, d = q.shape
    n_kv = k.shape[2]
    g = _groups(q, k)
    p = torch.exp(_scores(q, k, scale)
                  - lse.reshape(b, n_kv, g, length)[..., None])
    do5 = dout.float().reshape(b, length, n_kv, g, d)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do5)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do5, v.float())
    ds = p * (dp - delta.reshape(b, n_kv, g, length)[..., None]) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds,
                      q.float().reshape(b, length, n_kv, g, d))
    return (dq.reshape(b, length, n_head, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _kernel_input(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` as the kernels read it: D contiguous, the other strides
    nonzero multiples of 8 elements (the forward's TMA tensor maps take
    strides in 16-byte multiples), the base 16-byte aligned; a copy where
    ``x`` is not so."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the flash kernels take bf16; {name} is {x.dtype}")
    if (x.stride(-1) != 1 or any(s % 8 or s <= 0 for s in x.stride()[:3])
            or x.data_ptr() % 16):
        x = x.contiguous()
        if x.data_ptr() % 16:
            x = x.clone()
    return x


def _strides(x: torch.Tensor):
    return (ctypes.c_longlong * 3)(*x.stride()[:3])


def _check_cuda(q, k, v):
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernels take head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {q.shape[-1]}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    _groups(q, k)


def _raise_on(err: int, lib, what: str, shape) -> None:
    if err != 0:
        msg = lib.flash_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed (q {tuple(shape)}): "
                           f"cuda error {err}: {msg}")


def flash_forward(q, k, v, scale: float):
    """(O, LSE) of causal attention: O (B, L, H, D) in q's dtype, LSE
    (B, H, L) f32. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, scale)
    _check_cuda(q, k, v)
    q, k, v = (_kernel_input(x, n) for x, n in ((q, "q"), (k, "k"),
                                                 (v, "v")))
    b, length, n_head, d = q.shape
    out = torch.empty((b, length, n_head, d), dtype=torch.bfloat16,
                      device=q.device)
    lse = torch.empty((b, n_head, length), dtype=torch.float32,
                      device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, length, n_head, k.shape[2], d, _strides(q),
            _strides(k), _strides(v), float(scale), stream)
    _raise_on(err, lib, "flash_forward", q.shape)
    launch_count.count(flash_forward)
    return out, lse


launch_count.counter(flash_forward)


def backward_inputs(q, k, v, out, lse, dout):
    """The kernels' backward operands on the card: bf16 q, k, v, dO with
    strides they take, f32 LSE, and ``delta = rowsum(dO * O)`` (B, H, L)."""
    _check_cuda(q, k, v)
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError("dout and out must have q's shape")
    q, k, v, dout = (_kernel_input(x, n) for x, n in (
        (q, "q"), (k, "k"), (v, "v"), (dout, "dout")))
    # delta = rowsum(dO * O) stays a plain tensor op, as the JAX package
    # computes it outside Pallas (flash_attention.py:217)
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    return q, k, v, dout, lse.float().contiguous(), delta


def flash_backward_dkv(q, k, v, dout, lse, delta, scale: float):
    """(dk, dv) of causal attention, (B, L, Hkv, D): the dK/dV kernel on the
    card (operands from :func:`backward_inputs`), the plain version on
    CPU tensors. ``delta`` is rowsum(dO * O), (B, H, L) f32."""
    if q.device.type == "cpu":
        return _backward_from_delta(q, k, v, dout, lse, delta, scale)[1:]
    b, length, n_head, d = q.shape
    dk = torch.empty(k.shape, dtype=torch.bfloat16, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.bfloat16, device=q.device)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, length, n_head, k.shape[2], d, _strides(q), _strides(k),
            _strides(v), _strides(dout), float(scale), stream)
    _raise_on(err, lib, "flash_backward_dkv", q.shape)
    launch_count.count(flash_backward_dkv)
    return dk, dv


launch_count.counter(flash_backward_dkv)


def flash_backward_dq(q, k, v, dout, lse, delta, scale: float):
    """dq of causal attention, (B, L, H, D): the dQ kernel on the card,
    the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return _backward_from_delta(q, k, v, dout, lse, delta, scale)[0]
    b, length, n_head, d = q.shape
    dq = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, length,
            n_head, k.shape[2], d, _strides(q), _strides(k), _strides(v),
            _strides(dout), float(scale), stream)
    _raise_on(err, lib, "flash_backward_dq", q.shape)
    launch_count.count(flash_backward_dq)
    return dq


launch_count.counter(flash_backward_dq)


def flash_backward(q, k, v, out, lse, dout, scale: float):
    """(dq, dk, dv). CPU tensors take the plain version; on the card the
    dK/dV and dQ kernels run."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, out, lse, dout, scale)
    if q.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    q2, k2, v2, do2, lse2, delta = backward_inputs(q, k, v, out, lse, dout)
    dk, dv = flash_backward_dkv(q2, k2, v2, do2, lse2, delta, scale)
    dq = flash_backward_dq(q2, k2, v2, do2, lse2, delta, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal attention with the FlashAttention-2 backward; saves q, k, v,
    O and LSE (the JAX package's ``_flash_core`` residuals)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Causal flash attention over ``(B, L, H, D)`` q and ``(B, L, Hkv, D)``
    k/v; differentiable in all three."""
    if not causal:
        raise NotImplementedError("flash kernel is causal-only; use dense")
    _groups(q, k)
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, scale)
    return flash_forward(q, k, v, scale)[0]
