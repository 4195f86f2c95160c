"""SFT chat pipeline: ChatML rendering, tokenization, label masking.

Port of ``llm_in_practise_tpu/data/sft.py:27-168`` (a copy: the port
imports nothing of the JAX package). The steps, as in the reference's
fine-tuning data flow:

1. placeholder substitution (``{{NAME}}`` / ``{{AUTHOR}}``),
2. conversion to chat ``messages`` with a fixed system prompt,
3. ChatML rendering ``<|im_start|>{role}\\n{content}<|im_end|>\\n``,
4. tokenization to a fixed ``max_length`` with right padding, and
5. label masking: positions outside the assistant turn are
   ``IGNORE_INDEX`` so the loss covers only the assistant response.

Arrays are numpy, identical to the JAX package's for the same tokenizer.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np

IGNORE_INDEX = -100

IM_START = "<|im_start|>"
IM_END = "<|im_end|>"


def substitute_placeholders(records: Sequence[dict], name: str,
                            author: str) -> list[dict]:
    """``{{NAME}}``/``{{AUTHOR}}`` substitution in each response."""
    out = []
    for r in records:
        r = dict(r)
        r["response"] = (r["response"].replace("{{NAME}}", name)
                         .replace("{{AUTHOR}}", author))
        out.append(r)
    return out


def to_chat_messages(record: dict, system_prompt: str) -> list[dict]:
    """query/response record -> system/user/assistant messages."""
    return [
        {"role": "system", "content": system_prompt},
        {"role": "user", "content": record["query"]},
        {"role": "assistant", "content": record["response"]},
    ]


def render_chatml(messages: Sequence[dict]) -> str:
    """``<|im_start|>{role}\\n{content}<|im_end|>\\n`` per message, stripped."""
    text = ""
    for msg in messages:
        text += f"{IM_START}{msg['role']}\n{msg['content']}{IM_END}\n"
    return text.strip()


@dataclasses.dataclass
class SFTBatch:
    input_ids: np.ndarray       # (n, L) int32
    attention_mask: np.ndarray  # (n, L) int32, 1 = real token
    labels: np.ndarray          # (n, L) int32, IGNORE_INDEX when masked


def tokenize_for_sft(chatml_texts: Sequence[str], tokenizer, *,
                     max_length: int = 512,
                     pad_id: int | None = None) -> SFTBatch:
    """Tokenize ChatML strings and mask non-assistant labels: everything
    before the ``<|im_start|>assistant`` turn and after its closing
    ``<|im_end|>``, located by encoding the text up to each marker."""
    if pad_id is None:
        pad_id = getattr(tokenizer, "pad_id", 0)
    rows_ids: list[list[int]] = []
    rows_labels: list[list[int]] = []
    for text in chatml_texts:
        ids = tokenizer.encode(text)[:max_length]
        marker = f"{IM_START}assistant"
        pos = text.find(marker)
        if pos >= 0:
            n_prefix = len(tokenizer.encode(text[:pos]))
            end_char = text.find(IM_END, pos)
            n_keep = (len(tokenizer.encode(text[: end_char + len(IM_END)]))
                      if end_char >= 0 else len(ids))
        else:
            n_prefix, n_keep = 0, len(ids)
        labels = [tid if n_prefix <= i < n_keep else IGNORE_INDEX
                  for i, tid in enumerate(ids)]
        rows_ids.append(ids)
        rows_labels.append(labels)

    n, length = len(rows_ids), max_length
    input_ids = np.full((n, length), pad_id, dtype=np.int32)
    attention_mask = np.zeros((n, length), dtype=np.int32)
    labels = np.full((n, length), IGNORE_INDEX, dtype=np.int32)
    for i, (ids, labs) in enumerate(zip(rows_ids, rows_labels)):
        input_ids[i, : len(ids)] = ids
        attention_mask[i, : len(ids)] = 1
        labels[i, : len(labs)] = labs
    return SFTBatch(input_ids, attention_mask, labels)


def build_sft_dataset(records: Sequence[dict], tokenizer, *,
                      name: str = "AI Assistant", author: str = "AI Team",
                      system_prompt: str | None = None,
                      max_length: int = 512) -> SFTBatch:
    """records -> substituted -> messages -> ChatML -> tokenized+masked."""
    if system_prompt is None:
        system_prompt = (
            f"You are a helpful assistant named {name}, trained by {author}.")
    subbed = substitute_placeholders(records, name, author)
    texts = [render_chatml(to_chat_messages(r, system_prompt)) for r in subbed]
    return tokenize_for_sft(texts, tokenizer, max_length=max_length)


def self_cognition_records(n: int = 64, seed: int = 0) -> list[dict]:
    """Deterministic stand-in for ``modelscope/self-cognition``:
    query/response pairs carrying the ``{{NAME}}``/``{{AUTHOR}}``
    placeholders the pipeline substitutes."""
    rng = np.random.default_rng(seed)
    queries = [
        "Who are you?", "What is your name?", "Who created you?",
        "Introduce yourself.", "Tell me about yourself.", "你是谁？",
        "What can you do?", "Who trained you?",
    ]
    responses = [
        "I am {{NAME}}, an AI assistant developed by {{AUTHOR}}.",
        "My name is {{NAME}}. I was created by {{AUTHOR}} to help you.",
        "I'm {{NAME}}, trained by {{AUTHOR}}.",
    ]
    return [
        {
            "query": queries[int(rng.integers(len(queries)))],
            "response": responses[int(rng.integers(len(responses)))],
            "tag": "zh" if int(rng.integers(2)) else "en",
        }
        for _ in range(n)
    ]
