"""Layer helpers (port of ``llm_in_practise_tpu/models/layers.py:73-122``).

:func:`remat_apply` runs a block under gradient checkpointing. A cache
is a list of per-layer dicts ``{"k", "v", "index"}``; k/v are
``(slots, max_len, n_kv_head, head_dim)``, ``index`` is the write index,
a scalar or a ``(slots,)`` vector (continuous batching: every slot at its
own depth).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def remat_apply(block: torch.nn.Module, *args, **call_kwargs):
    """Apply a transformer block under gradient checkpointing: its
    activations are recomputed in the backward instead of saved. As in the
    reference, the block's cache output is dropped (remat runs only on the
    cache-free training forward). Non-reentrant, so inputs that need no
    gradient (layer 0's embedding) and keyword arguments are fine."""
    def run(*a):
        return block(*a, **call_kwargs)[0]

    return checkpoint(run, *args, use_reentrant=False)


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


def to_kv_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in the cache's dtype. A float8 cache saturates: values past
    the format's largest finite value (448 in e4m3fn) store that value,
    where a plain cast gives NaN on the card (and JAX's cast NaN from
    about 464 on). Below it the bytes are the plain cast's."""
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        top = torch.finfo(dtype).max
        x = x.clamp(-top, top)
    return x.to(dtype)


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
    new = to_kv_dtype(new, buf.dtype)
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
