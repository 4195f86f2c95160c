"""Autoregressive generation over the model's KV cache.

Port of ``llm_in_practise_tpu/infer/generate.py:22-113``: prefill once
over the prompt, then one-token decode steps reusing a pre-allocated
cache, with the prompt cropped to fit the cache, the cache capped at the
model's position table, eos padding of finished rows and an early stop
once every row has finished. The JAX package jits the two step functions;
here they are plain functions on the model (:func:`prefill`,
:func:`decode_step`), run under ``torch.inference_mode``.

:func:`load_model` reads a ``save_named`` ``model.msgpack`` (a merged
model) into a dense :class:`~..models.qwen3.Qwen3` on the device.
"""

from __future__ import annotations

import torch

from llm_in_practise_tpu_torch.core.device import resolve_device
from llm_in_practise_tpu_torch.infer.sampling import sample_token


def max_positions(config) -> int | None:
    """Longest position the model's RoPE table covers; a KV cache must
    never grow past it."""
    for field in ("max_seq_len", "seq_len"):
        v = getattr(config, field, None)
        if v is not None:
            return int(v)
    return None


def prefill(model, prompt_ids: torch.Tensor, cache):
    """``(last_logits, cache)`` after the whole prompt (B, Lp). The prompt
    runs over a cache of its own length, whose KV is then copied into
    ``cache``: the serving engine's prefill, so a prompt gives the same
    numbers here as served alone."""
    length = prompt_ids.shape[1]
    pre = model.init_cache(prompt_ids.shape[0], length,
                           dtype=cache[0]["k"].dtype)
    hidden, pre = model(prompt_ids, cache=pre, return_hidden=True)
    for layer, done in zip(cache, pre):
        layer["k"][:, :length] = done["k"]
        layer["v"][:, :length] = done["v"]
        layer["index"] = length
    return model.head(hidden[:, -1]), cache


def decode_step(model, token: torch.Tensor, cache):
    """``(logits, cache)`` after one token per row (B,)."""
    hidden, cache = model(token[:, None], cache=cache, return_hidden=True)
    return model.head(hidden[:, -1]), cache


@torch.inference_mode()
def generate(model, prompt_ids, *, max_new_tokens: int = 50,
             temperature: float = 1.0, top_k: int | None = None,
             top_p: float | None = None, greedy: bool = False,
             eos_id: int | None = None,
             generator: torch.Generator | None = None,
             cache_len: int | None = None,
             cache_dtype=torch.bfloat16) -> torch.Tensor:
    """Generate token ids. ``prompt_ids``: (B, Lp) ints. Returns (B,
    <= Lp + N) int64 on the model's device: the (cropped) prompt, then
    the new tokens. ``generator`` draws the samples (unused when
    greedy); a row that has produced ``eos_id`` is padded with it."""
    prompt_ids = torch.as_tensor(prompt_ids, dtype=torch.long,
                                 device=model.device)
    b, prompt_len = prompt_ids.shape
    limit = max_positions(model.config)
    cache_len = min(cache_len or limit, limit)
    if prompt_len >= cache_len:
        prompt_ids = prompt_ids[:, -(cache_len - 1):]
        prompt_len = prompt_ids.shape[1]
    max_new_tokens = min(max_new_tokens, cache_len - prompt_len)

    cache = model.init_cache(b, cache_len, dtype=cache_dtype)
    logits, cache = prefill(model, prompt_ids, cache)
    tokens = [prompt_ids]
    finished = torch.zeros((b,), dtype=torch.bool, device=model.device)
    for step in range(max_new_tokens):
        next_token = sample_token(generator, logits, temperature=temperature,
                                  top_k=top_k, top_p=top_p, greedy=greedy)
        if eos_id is not None:
            next_token = torch.where(finished, eos_id, next_token)
            finished = finished | (next_token == eos_id)
        tokens.append(next_token[:, None])
        if step == max_new_tokens - 1 or (
                eos_id is not None and bool(finished.all())):
            break
        logits, cache = decode_step(model, next_token, cache)
    return torch.cat(tokens, dim=1)


def load_model(path: str, device=None):
    """A ``save_named`` model checkpoint (``model.msgpack`` with a
    ``config`` in its sidecar, flax param names, unrolled or stacked) as
    a dense :class:`~..models.qwen3.Qwen3` on ``device`` (default: the
    card)."""
    from llm_in_practise_tpu_torch.ckpt.checkpoint import restore_checkpoint
    from llm_in_practise_tpu_torch.models.convert import params_from_jax
    from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config

    device = resolve_device(device)
    tree, meta = restore_checkpoint(path)
    if "config" not in meta:
        raise ValueError(f"{path}: the checkpoint's metadata carries no "
                         "model config")
    cfg = Qwen3Config.from_dict(meta["config"])
    state = params_from_jax(tree, cfg)
    del tree
    model = Qwen3(cfg, device="meta")
    # each host tensor goes as its device copy lands
    model.load_state({n: state.pop(n).to(device) for n in list(state)})
    return model
