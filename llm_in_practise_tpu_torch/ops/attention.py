"""Attention (port of ``llm_in_practise_tpu/ops/attention.py``).

The JAX package computes cached prefill and decode attention in plain XLA
(its flash kernel serves uncached training only), so the port writes it
as plain tensor code: logits and softmax in f32, probabilities cast to
v's dtype, GQA contracted against the KV heads directly (no repeat of
K/V). Layout: q/k/v are ``(batch, length, heads, head_dim)``.

:func:`dot_product_attention` is the models' entry point: uncached causal
self-attention may take the flash kernels (:mod:`.flash_attention`),
every cached path stays dense, as in the reference. The dense path
takes the reference's other arguments too: ``causal=False``, an
additive ``bias``, ``kv_length``, ``scale`` and dropout on the
probabilities (A10; the GPT family trains with dropout).

In the contiguous KV layout every decode step reads the whole
``cache_len`` of every slot and masks what lies past the slot's depth,
exactly as the reference does.
"""

from __future__ import annotations

import torch

from llm_in_practise_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    flash_attention,
)

NEG_INF = -1e30


def causal_mask(q_len: int, kv_len: int,
                q_offset: torch.Tensor | int | None = None, *,
                device=None) -> torch.Tensor:
    """Additive f32 causal mask of shape (1|B, 1, q_len, kv_len).

    ``q_offset`` is the absolute position of the first query: default
    ``kv_len - q_len``; a scalar (KV-cached prefill) or a ``(B,)`` vector
    (continuous-batching decode, every slot at its own depth).
    """
    if q_offset is None:
        q_offset = kv_len - q_len
    q_offset = torch.as_tensor(q_offset, device=device)
    device = q_offset.device
    kv_pos = torch.arange(kv_len, device=device)
    if q_offset.ndim == 1:
        q_pos = torch.arange(q_len, device=device)[None, :] + q_offset[:, None]
        allowed = kv_pos[None, None, :] <= q_pos[:, :, None]
        return torch.where(allowed, 0.0, NEG_INF)[:, None]
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    allowed = kv_pos[None, :] <= q_pos
    return torch.where(allowed, 0.0, NEG_INF)[None, None]


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bias: torch.Tensor | None = None,
                    kv_length: torch.Tensor | None = None,
                    dropout_rate: float = 0.0,
                    generator: torch.Generator | None = None,
                    scale: float | None = None,
                    q_offset: torch.Tensor | int | None = None
                    ) -> torch.Tensor:
    """Attention in plain tensor code (JAX ``dense_attention``,
    ``ops/attention.py:52-121``). q: (B, Lq, H, D); k/v: (B, Lk, Hkv, D)
    with H % Hkv == 0. ``scale`` defaults to ``head_dim ** -0.5``;
    ``causal`` adds the mask of :func:`causal_mask`; ``kv_length`` (B,)
    sets every logit past a row's valid length to ``NEG_INF``; ``bias``
    is added to the logits (not with grouped heads, as in the
    reference); ``dropout_rate`` drops softmax probabilities, drawn from
    ``generator``, and scales the kept ones by ``1 / (1 - rate)``."""
    b, q_len, n_head, head_dim = q.shape
    kv_len, n_kv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else head_dim ** -0.5
    if n_head % n_kv or (n_kv != n_head and bias is not None):
        raise ValueError(
            f"grouped attention needs n_head ({n_head}) divisible by kv "
            f"heads ({n_kv}) and no bias")
    g = n_head // n_kv
    q5 = q.reshape(b, q_len, n_kv, g, head_dim)
    # (B, Hkv, G, Lq, Lk) logits in f32: bf16 products are exact in f32,
    # so this is the reference's preferred_element_type=f32 contraction
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q5.float(), k.float()) * scale
    if causal:
        logits = logits + causal_mask(
            q_len, kv_len, q_offset=q_offset, device=q.device)[:, :, None]
    if kv_length is not None:
        valid = (torch.arange(kv_len, device=q.device)
                 < torch.as_tensor(kv_length, device=q.device)[:, None])
        logits = torch.where(valid[:, None, None, None, :], logits, NEG_INF)
    if bias is not None:
        # (.., H, Lq, Lk) against (B, H, 1, Lq, Lk): g is 1 here
        logits = logits + bias.float().unsqueeze(-3)
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0:
        keep = torch.empty(probs.shape, dtype=torch.float32, device=q.device)
        keep.bernoulli_(1.0 - dropout_rate, generator=generator)
        probs = probs * keep / (1.0 - dropout_rate)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, q_len, n_head, head_dim)


def _flash_eligible(q, k, q_offset) -> bool:
    """Uncached self-attention shapes: the only case the flash path
    covers (``ops/attention.py:160-164`` of the reference)."""
    return (q_offset is None and k.shape[:2] == q.shape[:2]
            and k.shape[3] == q.shape[3] and q.shape[2] % k.shape[2] == 0)


def pick_impl(q, k, q_offset=None, *, causal: bool = True, bias=None,
              kv_length=None, dropout_rate: float = 0.0) -> str:
    """``impl="auto"``, decided before any launch: on a CUDA tensor the
    flash kernels for an uncached causal call with no bias, no
    ``kv_length`` and no dropout (the structural conditions of the
    reference's ``_pick_impl``) whose q is bf16 with a head_dim the
    kernels take (``KERNEL_HEAD_DIMS``), at every length (the
    reference's dense-below-L=512 rule is a v5e measurement); dense
    otherwise. On the CPU dense, as the JAX package's ``auto`` is off the
    TPU. This is a dispatch rule, not a fallback: a flash launch that
    fails raises."""
    if (q.device.type == "cuda" and causal and bias is None
            and kv_length is None and not dropout_rate
            and q.dtype == torch.bfloat16
            and q.shape[-1] in KERNEL_HEAD_DIMS
            and _flash_eligible(q, k, q_offset)):
        return "flash"
    return "dense"


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          bias: torch.Tensor | None = None,
                          kv_length: torch.Tensor | None = None,
                          dropout_rate: float = 0.0,
                          generator: torch.Generator | None = None,
                          scale: float | None = None,
                          q_offset: torch.Tensor | int | None = None,
                          impl: str = "auto") -> torch.Tensor:
    """Attention entry point of every model; ``impl`` is ``"auto"``
    (:func:`pick_impl`), ``"dense"`` or ``"flash"``. ``"flash"`` takes
    the flash path where it applies (causal, uncached, no bias,
    ``kv_length`` or dropout) and dense attention elsewhere, as the
    reference does; on a CUDA tensor the flash kernels raise on a dtype
    or head_dim they cannot take."""
    if impl not in ("auto", "dense", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "auto":
        impl = pick_impl(q, k, q_offset, causal=causal, bias=bias,
                         kv_length=kv_length, dropout_rate=dropout_rate)
    if (impl == "flash" and causal and bias is None and kv_length is None
            and not dropout_rate and _flash_eligible(q, k, q_offset)):
        return flash_attention(q, k, v, causal=True, scale=scale)
    return dense_attention(q, k, v, causal=causal, bias=bias,
                           kv_length=kv_length, dropout_rate=dropout_rate,
                           generator=generator, scale=scale,
                           q_offset=q_offset)
