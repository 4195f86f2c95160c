"""Rotary position embeddings (port of ``llm_in_practise_tpu/ops/rope.py``).

Layout: q/k are ``(batch, length, heads, head_dim)``, as in the JAX
package. The cos/sin tables are f32 ``(max_seq_len, head_dim // 2)``.
:func:`sinusoidal_embeddings` is the GPT family's fixed position table.
"""

from __future__ import annotations

import math

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
                     positions: torch.Tensor | None = None,
                     interleaved: bool = False) -> torch.Tensor:
    """Rotate feature pairs of x: (B, L, H, D), in f32, back to x's dtype.

    By default lane ``i`` pairs with lane ``i + D/2``: the HF
    "rotate_half" layout of Qwen/Llama checkpoints (the JAX function's
    ``interleaved=False``). ``interleaved=True`` pairs even and odd
    lanes, the JAX function's default, which the GPT family uses.
    ``positions``: optional (B, L) absolute positions (KV-cached decode);
    defaults to ``arange(L)``.
    """
    b, l, h, d = x.shape
    if positions is None:
        cos_l = cos[:l][None, :, None, :]
        sin_l = sin[:l][None, :, None, :]
    else:
        cos_l = cos[positions][:, :, None, :]
        sin_l = sin[positions][:, :, None, :]
    xf = x.to(torch.float32)
    if interleaved:
        pairs = xf.reshape(b, l, h, d // 2, 2)
        even, odd = pairs[..., 0], pairs[..., 1]
        out = torch.stack([even * cos_l - odd * sin_l,
                           even * sin_l + odd * cos_l], dim=-1)
        return out.reshape(x.shape).to(x.dtype)
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    out = torch.cat([x1 * cos_l - x2 * sin_l, x2 * cos_l + x1 * sin_l], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embeddings(max_len: int, dim: int, *,
                          device=None) -> torch.Tensor:
    """The classic fixed sinusoidal position table (max_len, dim), f32:
    sines on the even lanes, cosines on the odd ones (JAX
    ``ops/rope.py:68``)."""
    position = torch.arange(max_len, dtype=torch.float32,
                            device=device)[:, None]
    # the factor rounded to f32 first, as the reference computes it
    factor = -torch.tensor(math.log(10000.0), dtype=torch.float32,
                           device=device) / dim
    div_term = torch.exp(
        torch.arange(0, dim, 2, dtype=torch.float32, device=device) * factor)
    pe = torch.zeros((max_len, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe
