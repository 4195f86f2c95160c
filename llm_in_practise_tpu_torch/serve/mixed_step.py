"""Shared bodies of the engine's step paths (port of
``llm_in_practise_tpu/serve/mixed_step.py``).

The JAX package compiles each of these into one program, one dispatch.
Here each is plain tensor code over the engine's KV cache, which the
model updates in place; on the card
:mod:`~llm_in_practise_tpu_torch.serve.graphs` captures the decode block
and the fused mixed step as one CUDA graph each, and on the CPU the
engine calls them directly. No body reads the device from the host:

- :func:`decode_scan`: ``n`` single-token forwards plus samples, in the
  order of the JAX ``lax.scan`` body;
- :func:`batched_chunk`: one pinned-index prefill chunk for every row of
  the cache;
- :func:`make_mixed_step`: the chunk, then the ``n``-step block, then the
  final pin ``starts + lens + advance``;
- :func:`plan_decode_block`: the host-side policy for ``n``.

The bounds that keep every write of these bodies off attended KV (the
cache update clamps a window that runs past the end, as
``dynamic_update_slice`` does, which would shift it backward) are the
engine's to keep, as in the JAX package: ``n <= chunk``;
``done + chunk + n <= cache_len`` for a mid-prefill row;
``slot_len + chunk <= cache_len`` for an occupied row under a chunk.
"""

from __future__ import annotations

import torch

from llm_in_practise_tpu_torch.infer.sampling import sample_token_batched


def pin_index(cache, index_vec):
    """The cache with every layer's ``index`` replaced by ``index_vec``
    (the k/v buffers are the same tensors)."""
    return [{**layer, "index": index_vec} for layer in cache]


def decode_scan(model, cache, tokens, temperature, top_k, top_p, greedy, *,
                n, generator=None, all_greedy=None, noise=None):
    """``n`` single-token decodes, each sampling the next token of every
    row. ``noise`` (optional, (>= n, B, vocab)) holds step ``j``'s
    uniform draws at ``noise[j]``; without it each step draws from
    ``generator``. Returns ``((B, n) tokens, cache)``; the cache index
    has advanced by ``n`` on every row."""
    toks = []
    tok = tokens
    for j in range(n):
        logits, cache = model(tok[:, None], cache=cache)
        tok = sample_token_batched(
            generator, logits[:, -1, :].to(torch.float32),
            temperature=temperature, top_k=top_k, top_p=top_p,
            greedy=greedy, all_greedy=all_greedy,
            noise=None if noise is None else noise[j])
        toks.append(tok)
    return torch.stack(toks, dim=1), cache


def batched_chunk(model, cache, chunk_ids, starts, lens):
    """Advance every row one prefill chunk against the whole cache, each
    row's index pinned at ``starts`` (mid-prefill rows: their watermark;
    other rows: garbage KV above their own length, overwritten in order
    before any query attends it). ``lens`` is each row's real chunk
    length (0 off prefill). Returns ``((B, vocab) f32 logits at each
    row's last real position, cache)`` with the index at
    ``starts + lens``."""
    hidden, cache = model(chunk_ids, cache=pin_index(cache, starts),
                          return_hidden=True)
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    last = hidden[rows, torch.clamp(lens - 1, min=0)]
    logits = model.head(last).to(torch.float32)
    return logits, pin_index(cache, starts + lens)


def make_mixed_step(model):
    """The fused mixed step over ``model``::

        chunk_last, toks, cache = fn(
            cache, chunk_ids, starts, lens, advance, tokens, temperature,
            top_k, top_p, greedy, n=n, generator=None, all_greedy=None,
            noise=None)

    ``chunk_ids`` (B, chunk), ``starts`` and ``lens`` as in
    :func:`batched_chunk`; ``advance`` (B,): how far the block really
    moves each row (``n`` for ready rows, 0 elsewhere), so the final pin
    ``starts + lens + advance`` undoes the block's advance on mid-prefill
    and free rows. ``toks`` (B, n) is meaningful for ready rows only."""

    def mixed_step(cache, chunk_ids, starts, lens, advance, tokens,
                   temperature, top_k, top_p, greedy, *, n, generator=None,
                   all_greedy=None, noise=None):
        chunk_last, cache = batched_chunk(model, cache, chunk_ids, starts,
                                          lens)
        toks, cache = decode_scan(
            model, cache, tokens, temperature, top_k, top_p, greedy, n=n,
            generator=generator, all_greedy=all_greedy, noise=noise)
        return chunk_last, toks, pin_index(cache, starts + lens + advance)

    return mixed_step


def plan_decode_block(*, decode_steps: int, queue_depth: int,
                      soonest_finish: int | None, chunk: int | None,
                      prefill_headroom: int | None) -> int:
    """Decode block length ``n`` for this step (Sarathi-style stall-free
    batching, host side):

    - start from ``decode_steps``;
    - while requests queue, cap at the soonest deterministic completion
      among active rows, so a freed slot refills at the next step;
    - while a row is mid-prefill, cap at ``chunk`` (the next chunk's
      write must cover the block's garbage rows) and at
      ``prefill_headroom`` (min over prefill rows of
      ``cache_len - chunk - done``: the garbage rows must land inside the
      cache);
    - a capped length is quantized down to a power of two, so the block
      lengths (one captured graph each) are ``decode_steps`` and the
      powers of two below it.
    """
    n = decode_steps
    capped = False
    if (n > 1 and queue_depth > 0 and soonest_finish is not None
            and soonest_finish < n):
        n = max(1, soonest_finish)
        capped = True
    if chunk is not None and chunk < n:
        n = max(1, chunk)
        capped = True
    if prefill_headroom is not None and prefill_headroom < n:
        n = max(1, prefill_headroom)
        capped = True
    if capped and n > 1:
        n = 1 << (n.bit_length() - 1)
    return n
