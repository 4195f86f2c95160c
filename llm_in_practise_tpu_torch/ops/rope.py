"""Rotary position embeddings (port of ``llm_in_practise_tpu/ops/rope.py``).

Layout: q/k are ``(batch, length, heads, head_dim)``, as in the JAX
package. The cos/sin tables are f32 ``(max_seq_len, head_dim // 2)``.
"""

from __future__ import annotations

import torch


def precompute_cos_sin(head_dim: int, max_seq_len: int, theta: float = 10000.0,
                       *, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape (max_seq_len, head_dim // 2), f32."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    positions = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(positions, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
                     positions: torch.Tensor | None = None) -> torch.Tensor:
    """Rotate feature pairs of x: (B, L, H, D), in f32, back to x's dtype.

    Lane ``i`` pairs with lane ``i + D/2``: the HF "rotate_half" layout of
    Qwen/Llama checkpoints (the JAX function's ``interleaved=False``; its
    interleaved layout serves the GPT/DeepSeek families, not ported yet).
    ``positions``: optional (B, L) absolute positions (KV-cached decode);
    defaults to ``arange(L)``.
    """
    d = x.shape[-1]
    l = x.shape[1]
    if positions is None:
        cos_l = cos[:l][None, :, None, :]
        sin_l = sin[:l][None, :, None, :]
    else:
        cos_l = cos[positions][:, :, None, :]
        sin_l = sin[positions][:, :, None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    out = torch.cat([x1 * cos_l - x2 * sin_l, x2 * cos_l + x1 * sin_l], dim=-1)
    return out.to(x.dtype)
