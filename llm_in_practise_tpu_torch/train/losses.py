"""Loss functions for LM training and SFT (port of
``llm_in_practise_tpu/train/losses.py``).

Next-token cross-entropy with ``ignore_index`` label masking, and the
fused linear cross-entropy that never materializes the full
``(tokens, vocab)`` logits.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

IGNORE_INDEX = -100


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  ignore_index: int = IGNORE_INDEX):
    """Mean token cross-entropy in f32. Returns (loss, n_valid_tokens)."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits, dim=-1)
    token_ll = torch.gather(logp, -1, safe[..., None].long())[..., 0]
    n_valid = torch.clamp(valid.sum(), min=1)
    return -(token_ll * valid).sum() / n_valid, n_valid


def _logits_f32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w^T`` with compute-dtype operands and f32 results (the JAX
    ``preferred_element_type=f32`` product: no rounding of the logits to
    the compute dtype). On the CPU the operands are widened to f32, which
    is exact for bf16 inputs."""
    if h.device.type == "cuda" and h.dtype != torch.float32:
        return _MatmulF32.apply(h, w)
    return h.float() @ w.float().T


class _MatmulF32(torch.autograd.Function):
    """``h @ w^T`` in f32 from bf16/f16 operands on the card. The backward
    feeds the f32 cotangent to the tensor cores in the operands' dtype,
    as a default-precision f32 product does on the reference's TPU."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return torch.mm(h, w.T, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        gh = gw = None
        if ctx.needs_input_grad[0]:
            gh = (g.to(w.dtype) @ w).to(h.dtype)
        if ctx.needs_input_grad[1]:
            gw = (g.T.to(h.dtype) @ h).to(w.dtype)
        return gh, gw


def fused_linear_cross_entropy(
    hidden: torch.Tensor,
    weight: torch.Tensor,
    labels: torch.Tensor,
    *,
    transpose_weight: bool = False,
    bias: torch.Tensor | None = None,
    ignore_index: int = IGNORE_INDEX,
    chunk: int = 4096,
    vocab_chunk: int | None = None,
    compute_dtype=torch.bfloat16,
):
    """LM-head projection fused into the loss: full logits never exist.

    Tokens go in ``chunk``-row slabs; each slab's logits are
    ``hidden_chunk @ weight`` (compute-dtype operands, f32 results), reduced
    to per-token NLL and recomputed in the backward (checkpointed), so the
    vocab-axis memory is ``chunk x vocab``. ``vocab_chunk`` also tiles the
    vocab with a streaming logsumexp: the tile width is the vocab over the
    smallest exact divisor count within 4x of the requested granularity
    (no padding copy of the weight; no divisor -> untiled), and each tile
    is checkpointed on its own, so the peak is ``chunk x vocab_tile``
    (the whole chunk then needs no checkpoint of its own: what it would
    save is what the tiles save).

    hidden: (..., dim); weight: (dim, vocab), or (vocab, dim) with
    ``transpose_weight=True`` (tied embedding); bias: optional (vocab,),
    added to the f32 logits in f32 (an untied GPT head's); labels: (...)
    ints.
    Returns (mean_nll, n_valid_tokens).
    """
    dim = hidden.shape[-1]
    flat_h = hidden.reshape(-1, dim)
    flat_l = labels.reshape(-1)
    n_tok = flat_h.shape[0]
    chunk = min(chunk, n_tok)
    w = weight.to(compute_dtype)
    if not transpose_weight:
        w = w.T  # (vocab, dim) from here on
    vocab = w.shape[0]
    n_vtiles = 1
    if vocab_chunk is not None and vocab > vocab_chunk:
        target = -(-vocab // vocab_chunk)
        n_vtiles = next((c for c in range(target, min(4 * target, vocab) + 1)
                         if vocab % c == 0), 1)
    vtile = vocab // n_vtiles

    b = bias.float() if bias is not None else None

    def untiled_nll(w, hc, safe, valid):
        logits = _logits_f32(hc, w)
        if b is not None:
            logits = logits + b
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, 1, safe[:, None])[:, 0]
        return ((lse - tgt) * valid).sum()

    def tile_stats(w, hc, safe, i):
        logits = _logits_f32(hc, w.narrow(0, i * vtile, vtile))
        if b is not None:
            logits = logits + b.narrow(0, i * vtile, vtile)
        tile_max = logits.max(dim=-1).values
        sumexp = torch.exp(logits - tile_max[:, None]).sum(-1)
        local = safe - i * vtile
        in_tile = (local >= 0) & (local < vtile)
        picked = torch.gather(logits, 1,
                              local.clamp(0, vtile - 1)[:, None])[:, 0]
        return tile_max, sumexp, torch.where(in_tile, picked, 0.0)

    total = hidden.new_zeros((), dtype=torch.float32)
    n_valid = torch.zeros((), dtype=torch.long, device=hidden.device)
    for start in range(0, n_tok, chunk):
        hc = flat_h[start:start + chunk].to(compute_dtype)
        lb = flat_l[start:start + chunk]
        valid = lb != ignore_index
        safe = torch.where(valid, lb, 0).long()
        n_valid = n_valid + valid.sum()
        if n_vtiles == 1:
            total = total + checkpoint(untiled_nll, w, hc, safe, valid,
                                       use_reentrant=False)
            continue
        # online logsumexp over the vocab tiles: running max and sumexp,
        # plus the target logit from the tile that owns it
        m = torch.full((hc.shape[0],), float("-inf"), device=hc.device)
        s = torch.zeros((hc.shape[0],), device=hc.device)
        tgt = torch.zeros((hc.shape[0],), device=hc.device)
        for i in range(n_vtiles):
            tile_max, sumexp, picked = checkpoint(
                tile_stats, w, hc, safe, i, use_reentrant=False)
            new_m = torch.maximum(m, tile_max)
            s = s * torch.exp(m - new_m) + sumexp * torch.exp(tile_max - new_m)
            tgt = tgt + picked
            m = new_m
        total = total + ((m + torch.log(s) - tgt) * valid).sum()
    n_valid = torch.clamp(n_valid, min=1)
    return total / n_valid, n_valid



def perplexity(mean_nll: torch.Tensor) -> torch.Tensor:
    return torch.exp(mean_nll)
