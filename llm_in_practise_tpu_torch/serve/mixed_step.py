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
- :func:`spec_verify_block`: the fused speculative round, the verify of
  ``k`` drafted tokens and the block's remaining ``m`` greedy steps;
- :func:`draft_roll`: the draft model's catch-up and its ``k`` greedy
  draft tokens;
- :func:`plan_decode_block` and :func:`plan_spec_extension`: the
  host-side policies for ``n`` and ``m``.

Grammar masks (structured output, :mod:`.constrain`): given ``gmask``
or ``gmasks``, the bodies add a host-staged additive f32 mask (0 allowed, ``NEG_INF``
forbidden, zero rows for unconstrained slots) to the f32 logits before
sampling or the argmax. With the mask left out each body runs exactly
the unmasked code.

The bounds that keep every write of these bodies off attended KV (the
cache update clamps a window that runs past the end, as
``dynamic_update_slice`` does, which would shift it backward) are the
engine's to keep, as in the JAX package: ``n <= chunk``;
``done + chunk + n <= cache_len`` for a mid-prefill row;
``slot_len + chunk <= cache_len`` for an occupied row under a chunk;
``index + k + 1 + m <= cache_len`` for every live row of a spec round.
"""

from __future__ import annotations

import torch

from llm_in_practise_tpu_torch.infer.sampling import sample_token_batched


def pin_index(cache, index_vec):
    """The cache with every layer's ``index`` replaced by ``index_vec``
    (the k/v buffers are the same tensors)."""
    return [{**layer, "index": index_vec} for layer in cache]


def decode_scan(model, cache, tokens, temperature, top_k, top_p, greedy, *,
                n, generator=None, all_greedy=None, noise=None, gmask=None):
    """``n`` single-token decodes, each sampling the next token of every
    row. ``noise`` (optional, (>= n, B, vocab)) holds step ``j``'s
    uniform draws at ``noise[j]``; without it each step draws from
    ``generator``. Returns ``((B, n) tokens, cache)``; the cache index
    has advanced by ``n`` on every row.

    ``gmask`` (optional, (B, vocab) f32 additive): the grammar mask of
    one automaton state per row, so only ``n == 1`` is allowed (the
    engine's planner caps a constrained block at 1)."""
    if gmask is not None and n != 1:
        raise ValueError(
            f"grammar-masked decode blocks must be n=1, got n={n} "
            "(the per-slot mask is staged for one automaton state)")
    toks = []
    tok = tokens
    for j in range(n):
        logits, cache = model(tok[:, None], cache=cache)
        logits = logits[:, -1, :].to(torch.float32)
        if gmask is not None:
            logits = logits + gmask
        tok = sample_token_batched(
            generator, logits,
            temperature=temperature, top_k=top_k, top_p=top_p,
            greedy=greedy, all_greedy=all_greedy,
            noise=None if noise is None else noise[j])
        toks.append(tok)
    if not toks:
        return tokens.new_zeros((tokens.shape[0], 0)), cache
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


def spec_verify_block(model, cache, tokens, base, mask, *, m, gmasks=None):
    """The fused speculative round: verify the ``k`` drafted tokens and
    decode the planned block's remaining ``m`` greedy steps, with no
    value going to the host in between.

    1. One cached forward over the ``(B, k+1)`` tokens ``[last_token,
       draft_1..k]`` (zeros where nothing was drafted), the index pinned
       to ``base``.
    2. ``n_acc``: the longest prefix of the drafts that equals the
       forward's own f32 argmax (the sum of the cumprod of the matches).
    3. The index pinned to ``base + (n_acc + 1) * mask``: rows with mask
       0 (free, mid-prefill) return to ``base``.
    4. ``m`` greedy steps from each row's bonus token ``out[s, n_acc]``
       (:func:`decode_scan`); each overwrites the next rejected draft's
       row before any query attends it. The final pin is
       ``base + (n_acc + 1 + m) * mask``.

    Every emitted token (accepted, bonus or extension) is an argmax of
    this body's own forwards, so under greedy the stream is the plain
    one. Returns ``(out (B, k+1), n_acc (B,), extra (B, m), cache)``.

    ``gmasks`` (optional, (B, k+1, vocab) f32 additive): position ``j``'s
    row is the grammar mask of the automaton state after the first ``j``
    drafts (staged on the host), added before the argmax: a
    grammar-forbidden draft cannot be the masked argmax at its position,
    so the acceptance cumprod stops there as at a mismatch, and the
    bonus token is masked by its own state. Constrained rounds run at
    ``m == 0`` (the extension's steps have no host-staged mask).
    """
    logits, cache = model(tokens, cache=pin_index(cache, base))
    logits = logits.to(torch.float32)
    if gmasks is not None:
        logits = logits + gmasks
    out = torch.argmax(logits, dim=-1)
    # position j is accepted iff every draft up to and including j
    # matched the model's own output
    match = (out[:, :-1] == tokens[:, 1:]).to(torch.int64)
    n_acc = torch.cumprod(match, dim=1).sum(dim=1)
    cache = pin_index(cache, base + (n_acc + 1) * mask)
    if m == 0:
        return out, n_acc, out.new_zeros((out.shape[0], 0)), cache
    bonus = torch.gather(out, 1, n_acc[:, None])[:, 0]
    extra, cache = decode_scan(model, cache, bonus, None, None, None, None,
                               n=m, all_greedy=True)
    return out, n_acc, extra, pin_index(cache, base + (n_acc + 1 + m) * mask)


def draft_roll(model, cache, catchup, starts, lens, *, k):
    """The draft model's proposal: feed each row's unsynced tokens
    (``catchup`` (B, W), right-padded, the index pinned to ``starts``),
    then roll ``k`` greedy draft tokens. Returns ``(drafts (B, k),
    cache)`` with the index at ``starts + lens``; the rolled tokens' KV
    above it is overwritten by the next round's catch-up.

    The catch-up advances every row's index by the padded width ``W``;
    the re-pin to ``starts + lens`` before the roll puts draft tokens
    2..k at their true RoPE positions (without it they decode shifted
    and write their KV above the watermark)."""
    first_logits, cache = batched_chunk(model, cache, catchup, starts, lens)
    first = torch.argmax(first_logits, dim=-1)
    rest, cache = decode_scan(model, cache, first, None, None, None, None,
                              n=k - 1, all_greedy=True)
    drafts = torch.cat([first[:, None], rest], dim=1)
    return drafts, pin_index(cache, starts + lens)


def make_mixed_step(model):
    """The fused mixed step over ``model``::

        chunk_last, toks, cache = fn(
            cache, chunk_ids, starts, lens, advance, tokens, temperature,
            top_k, top_p, greedy, n=n, generator=None, all_greedy=None,
            noise=None, gmask=None)

    ``chunk_ids`` (B, chunk), ``starts`` and ``lens`` as in
    :func:`batched_chunk`; ``advance`` (B,): how far the block really
    moves each row (``n`` for ready rows, 0 elsewhere), so the final pin
    ``starts + lens + advance`` undoes the block's advance on mid-prefill
    and free rows. ``toks`` (B, n) is meaningful for ready rows only.
    ``gmask`` (B, vocab) masks the decode half only (mid-prefill rows
    need none: their first token samples at finalization, under the
    start state's mask); the planner caps a constrained block at
    ``n == 1``."""

    def mixed_step(cache, chunk_ids, starts, lens, advance, tokens,
                   temperature, top_k, top_p, greedy, *, n, generator=None,
                   all_greedy=None, noise=None, gmask=None):
        chunk_last, cache = batched_chunk(model, cache, chunk_ids, starts,
                                          lens)
        toks, cache = decode_scan(
            model, cache, tokens, temperature, top_k, top_p, greedy, n=n,
            generator=generator, all_greedy=all_greedy, noise=noise,
            gmask=gmask)
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


def plan_spec_extension(*, block: int, k: int, headroom: int) -> int:
    """Extra greedy steps ``m`` after the ``k``-token verify, so that one
    spec round spans the same ``n``-step plan as a plain block (``block``
    from :func:`plan_decode_block`): ``m = block - 1``, shrunk to
    ``headroom`` (min over live rows of ``cache_len - (k + 1) -
    position``: every write of the round lands inside the cache) and,
    when shrunk by headroom, quantized down to a power of two. Each
    ``m`` is one captured graph; ``m`` takes values in ``{decode_steps -
    1}``, ``{2^j - 1}`` (a capped block is a power of two), ``{2^j}``
    (headroom) and ``{0}``: about 2 log2(decode_steps) of them."""
    m = block - 1
    if m <= 0 or headroom <= 0:
        return 0
    if headroom < m:
        m = headroom
        if m > 1:
            m = 1 << (m.bit_length() - 1)
    return m
