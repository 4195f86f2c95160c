"""KV-cache helpers (port of ``llm_in_practise_tpu/models/layers.py:94-122``).

A cache is a list of per-layer dicts ``{"k", "v", "index"}``; k/v are
``(slots, max_len, n_kv_head, head_dim)``, ``index`` is the write index,
a scalar or a ``(slots,)`` vector (continuous batching: every slot at its
own depth).
"""

from __future__ import annotations

import torch


def cache_positions(index: torch.Tensor | int, batch: int, length: int, *,
                    device=None) -> torch.Tensor:
    """(B, L) absolute positions of the current query block. ``index`` is
    a Python int, a scalar tensor or a ``(B,)`` vector."""
    if isinstance(index, int):
        pos = torch.arange(index, index + length, device=device)
        return pos[None, :].expand(batch, length)
    ar = torch.arange(length, device=index.device)
    if index.ndim == 1:
        return index[:, None] + ar[None, :]
    return (index + ar)[None, :].expand(batch, length)


def cache_update(buf: torch.Tensor, new: torch.Tensor,
                 index: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B, L, ...) into ``buf`` (B, max_len, ...) at ``index``.

    The port updates ``buf`` IN PLACE and returns it, where the JAX
    package returns a new buffer (its arrays are immutable; here a copy of
    a multi-GB cache per layer per step would be pure waste). As with
    ``dynamic_update_slice``, a start index that would run past the end is
    clamped to ``max_len - L``.
    """
    b, l = new.shape[:2]
    max_len = buf.shape[1]
    new = new.to(buf.dtype)
    if isinstance(index, int):
        start = min(max(index, 0), max_len - l)
        buf.narrow(1, start, l).copy_(new)
        return buf
    index = torch.as_tensor(index, device=buf.device)
    start = torch.clamp(index.to(torch.long), 0, max_len - l)
    if start.ndim == 0:
        buf.narrow(1, int(start), l).copy_(new)
        return buf
    rows = torch.arange(b, device=buf.device)[:, None]
    cols = start[:, None] + torch.arange(l, device=buf.device)[None, :]
    buf[rows, cols] = new
    return buf
