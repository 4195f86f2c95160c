"""Dense causal attention (port of ``llm_in_practise_tpu/ops/attention.py``).

The JAX package computes cached prefill and decode attention in plain XLA
(its flash kernel serves uncached training only), so the port writes it
as plain tensor code: logits and softmax in f32, probabilities cast to
v's dtype, GQA contracted against the KV heads directly (no repeat of
K/V). Layout: q/k/v are ``(batch, length, heads, head_dim)``.

In the contiguous KV layout every decode step reads the whole
``cache_len`` of every slot and masks what lies past the slot's depth,
exactly as the reference does.
"""

from __future__ import annotations

import torch

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
                    q_offset: torch.Tensor | int | None = None) -> torch.Tensor:
    """Causal attention scaled by ``head_dim ** -0.5``. q: (B, Lq, H, D);
    k/v: (B, Lk, Hkv, D) with H % Hkv == 0."""
    b, q_len, n_head, head_dim = q.shape
    kv_len, n_kv = k.shape[1], k.shape[2]
    if n_head % n_kv:
        raise ValueError(
            f"grouped attention needs n_head ({n_head}) divisible by kv "
            f"heads ({n_kv})")
    g = n_head // n_kv
    q5 = q.reshape(b, q_len, n_kv, g, head_dim)
    # (B, Hkv, G, Lq, Lk) logits in f32: bf16 products are exact in f32,
    # so this is the reference's preferred_element_type=f32 contraction
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q5.float(), k.float())
    logits = logits * head_dim ** -0.5 + causal_mask(
        q_len, kv_len, q_offset=q_offset, device=q.device)[:, :, None]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, q_len, n_head, head_dim)
