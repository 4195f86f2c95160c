"""Token sampling (port of ``infer/sampling.py:17-90``): per-row
(:func:`sample_token_batched`, the engine's) and unbatched
(:func:`sample_token`, ``generate``'s), over the same filtering
(:func:`filter_logits`).

The random draw comes from an explicit ``torch.Generator`` (Gumbel-max
over the filtered logits, which is what ``jax.random.categorical``
computes). The two frameworks' generators give different numbers from the
same seed, so seeded sampling agrees with the JAX package in
distribution, not bit for bit.

Inside a CUDA graph the function must not read the device from the host
or draw from a generator: the caller then passes ``all_greedy`` (decided
on the host) and ``noise``, the uniform draws it filled before the replay.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def filter_logits(logits: torch.Tensor, *, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """``logits`` (B, vocab) over each row's temperature, with the tokens
    that row's top-k and then top-p filters drop set to ``NEG_INF``
    (``top_k`` 0 and ``top_p`` >= 1 disable; ``top_p`` 0 keeps only the
    top token)."""
    n_vocab = logits.shape[-1]
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]

    # one sort serves both filters
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values

    # row-wise top-k: kth-largest threshold (k=0 keeps all)
    k_idx = torch.clamp(top_k.to(torch.long) - 1, 0, n_vocab - 1)
    kth = torch.gather(sorted_desc, 1, k_idx[:, None])
    k_on = top_k[:, None] > 0
    scaled = torch.where(k_on & (scaled < kth), NEG_INF, scaled)
    ar = torch.arange(n_vocab, device=logits.device)[None, :]
    sorted_desc = torch.where(k_on & (ar > k_idx[:, None]), NEG_INF,
                              sorted_desc)

    # row-wise top-p over the filtered logits
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff_mask = cum - probs > top_p[:, None]
    cutoff_logit = torch.amin(
        torch.where(cutoff_mask, torch.inf, sorted_desc), dim=-1, keepdim=True)
    use_p = (top_p < 1.0)[:, None]
    return torch.where(use_p & (scaled < cutoff_logit), NEG_INF, scaled)


def _gumbel_argmax(scaled: torch.Tensor, generator, noise) -> torch.Tensor:
    u = noise if noise is not None else torch.rand(
        scaled.shape, generator=generator, device=scaled.device,
        dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return torch.argmax(scaled + gumbel, dim=-1)


def sample_token(generator: torch.Generator | None, logits: torch.Tensor, *,
                 temperature: float = 1.0, top_k: int | None = None,
                 top_p: float | None = None,
                 greedy: bool = False) -> torch.Tensor:
    """Next token ids from ``(..., vocab)`` logits, one setting for every
    row (JAX ``sample_token``): argmax when ``greedy`` or ``temperature``
    is 0, else a draw from ``generator`` over the filtered logits."""
    if greedy or temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    flat = logits.reshape(-1, logits.shape[-1])
    rows = flat.shape[0]

    def full(value, dtype):
        return torch.full((rows,), value, dtype=dtype, device=flat.device)

    scaled = filter_logits(
        flat, temperature=full(temperature, torch.float32),
        top_k=full(top_k or 0, torch.long),
        top_p=full(1.0 if top_p is None else top_p, torch.float32))
    return _gumbel_argmax(scaled, generator, None).reshape(logits.shape[:-1])


def sample_token_batched(generator: torch.Generator | None,
                         logits: torch.Tensor, *, temperature: torch.Tensor,
                         top_k: torch.Tensor, top_p: torch.Tensor,
                         greedy: torch.Tensor, all_greedy: bool | None = None,
                         noise: torch.Tensor | None = None) -> torch.Tensor:
    """Next token per row of ``logits`` (B, vocab), each row with its own
    ``temperature`` (floats), ``top_k`` (ints, 0 disables), ``top_p``
    (floats, >= 1 disables; 0 keeps only the top token) and ``greedy``
    (bools). Returns (B,) int64.

    ``all_greedy`` (default: read from ``greedy`` on the device) skips the
    draw when every row is greedy. ``noise`` (default: drawn here from
    ``generator``) is the (B, vocab) f32 uniform draw in [0, 1)."""
    if all_greedy is None:
        all_greedy = bool(greedy.all())
    if all_greedy:
        # every row greedy: nothing to draw (same answer as the full path)
        return torch.argmax(logits, dim=-1)
    scaled = filter_logits(logits, temperature=temperature, top_k=top_k,
                           top_p=top_p)
    sampled = _gumbel_argmax(scaled, generator, noise)
    return torch.where(greedy, torch.argmax(logits, dim=-1), sampled)
