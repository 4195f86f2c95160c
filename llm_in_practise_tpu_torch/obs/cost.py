"""Device memory telemetry (port of the memory part of
``llm_in_practise_tpu/obs/cost.py``).

- :func:`device_memory_stats`: what the card's caching allocator reports
  (bytes in use, the peak, the card's total memory), fail-open ``{}`` for
  a CPU device or a process without CUDA, so a scrape never fails on it.
- :func:`hbm_stats`: the same in the benchmark artifacts' shape.
- :func:`tree_bytes`: resident bytes of an ``nn.Module``'s parameters and
  buffers, or of a nested dict / list / tuple of tensors.

The FLOP / byte cost model and the card's data-sheet peaks are not
ported yet (ROADMAP.md queue A item 6).
"""

from __future__ import annotations

import torch


def device_memory_stats(device=None) -> dict:
    """``bytes_in_use`` (``torch.cuda.memory_allocated``),
    ``peak_bytes_in_use`` (``max_memory_allocated``) and ``bytes_limit``
    (the card's total memory, ``mem_get_info``) of ``device`` (default
    ``cuda:0``); ``{}`` for a CPU device or without CUDA. Telemetry fails
    open: it never raises."""
    try:
        dev = torch.device("cuda:0" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return {}
        return {"bytes_in_use": int(torch.cuda.memory_allocated(dev)),
                "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
                "bytes_limit": int(torch.cuda.mem_get_info(dev)[1])}
    except Exception:  # noqa: BLE001 — no runtime, no stats: fail open
        return {}


def hbm_stats() -> dict:
    """:func:`device_memory_stats` as ``hbm_bytes_in_use`` /
    ``hbm_bytes_limit`` / derived headroom in GiB."""
    s = device_memory_stats()
    used, limit = s.get("bytes_in_use"), s.get("bytes_limit")
    out = {}
    if used is not None:
        out["hbm_bytes_in_use"] = used
    if limit is not None:
        out["hbm_bytes_limit"] = limit
    if used is not None and limit is not None:
        out["hbm_headroom_gib"] = round((limit - used) / 2**30, 2)
    return out


def tree_bytes(tree) -> int:
    """Resident bytes of ``tree``: a module's parameters and buffers (each
    storage once: a tied embedding counts once) plus the packed leaves of
    its quantized projections, or every tensor of a nested dict / list /
    tuple (a quantized leaf counts its packed arrays, exactly what a full
    weight read streams)."""
    if isinstance(tree, torch.nn.Module):
        seen = {}
        for t in list(tree.parameters()) + list(tree.buffers()):
            seen[t.data_ptr()] = t.numel() * t.element_size()
        packed = 0
        for m in tree.modules():
            # a quantized projection keeps its leaf (NF4Tensor, ...) as a
            # plain attribute: neither a parameter nor a buffer
            w = m.__dict__.get("weight")
            if w is not None and not isinstance(w, torch.Tensor):
                packed += int(getattr(w, "nbytes", 0) or 0)
        return sum(seen.values()) + packed
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0
