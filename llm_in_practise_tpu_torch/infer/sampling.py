"""Per-row token sampling (port of ``infer/sampling.py:46-90``).

The random draw comes from an explicit ``torch.Generator`` (Gumbel-max
over the filtered logits, which is what ``jax.random.categorical``
computes). The two frameworks' generators give different numbers from the
same seed, so seeded sampling agrees with the JAX package in
distribution, not bit for bit.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def sample_token_batched(generator: torch.Generator | None,
                         logits: torch.Tensor, *, temperature: torch.Tensor,
                         top_k: torch.Tensor, top_p: torch.Tensor,
                         greedy: torch.Tensor) -> torch.Tensor:
    """Next token per row of ``logits`` (B, vocab), each row with its own
    ``temperature`` (floats), ``top_k`` (ints, 0 disables), ``top_p``
    (floats, >= 1 disables; 0 keeps only the top token) and ``greedy``
    (bools). Returns (B,) int64."""
    if bool(greedy.all()):
        # every row greedy: nothing to draw (same answer as the full path)
        return torch.argmax(logits, dim=-1)
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
    scaled = torch.where(use_p & (scaled < cutoff_logit), NEG_INF, scaled)

    u = torch.rand(scaled.shape, generator=generator, device=scaled.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(greedy, torch.argmax(logits, dim=-1), sampled)
