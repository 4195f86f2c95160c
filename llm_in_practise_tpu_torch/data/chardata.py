"""Char-level dataset utilities (a copy of
``llm_in_practise_tpu/data/chardata.py``; numpy only).

Vocab built from sorted unique chars, dynamic ``vocab_size``,
sliding-window (x, y) next-char pairs, and the v1 trainer's data
augmentation by repetition.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CharTokenizer:
    stoi: dict[str, int]
    itos: dict[int, str]

    @classmethod
    def from_text(cls, text: str) -> "CharTokenizer":
        chars = sorted(set(text))
        stoi = {ch: i for i, ch in enumerate(chars)}
        itos = {i: ch for i, ch in enumerate(chars)}
        return cls(stoi, itos)

    @property
    def vocab_size(self) -> int:
        return len(self.stoi)

    def encode(self, text: str) -> np.ndarray:
        unknown = [ch for ch in text if ch not in self.stoi]
        if unknown:
            raise ValueError(f"chars outside vocab: {unknown[:10]!r}")
        return np.asarray([self.stoi[ch] for ch in text], dtype=np.int32)

    def decode(self, ids) -> str:
        return "".join(self.itos[int(i)] for i in ids)

    def to_dict(self) -> dict:
        return {"stoi": self.stoi}

    @classmethod
    def from_dict(cls, d: dict) -> "CharTokenizer":
        stoi = {k: int(v) for k, v in d["stoi"].items()}
        return cls(stoi, {v: k for k, v in stoi.items()})


def char_lm_examples(
    text: str, seq_len: int, *, repeat: int = 1
) -> tuple[np.ndarray, np.ndarray, CharTokenizer]:
    """Sliding-window next-char pairs: x[i] = data[i:i+L], y[i] = data[i+1:i+1+L].

    ``repeat`` mirrors the v1 trainer's 10× augmentation-by-repetition.
    Short texts are cycled so at least one full window exists.
    """
    tok = CharTokenizer.from_text(text)
    data = tok.encode(text * repeat)
    if len(data) <= seq_len:
        reps = seq_len // max(1, len(data)) + 2
        data = np.tile(data, reps)
    n = len(data) - seq_len
    x = np.stack([data[i : i + seq_len] for i in range(n)])
    y = np.stack([data[i + 1 : i + 1 + seq_len] for i in range(n)])
    return x, y, tok
