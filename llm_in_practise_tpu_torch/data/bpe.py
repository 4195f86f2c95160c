"""Byte-pair-encoding tokenizer, trainer and encoder (pure Python).

Port of ``llm_in_practise_tpu/data/bpe.py``: the same vocabulary, merges,
pre-tokenizers and JSON file format, so a tokenizer saved by either
package loads in the other. The JAX package's optional C++ encode loop is
not ported yet; this module runs the pure-Python merge loop only.
"""

from __future__ import annotations

import json
import os
import re
from collections import Counter
from collections.abc import Iterable, Iterator

DEFAULT_SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]")

# GPT-2 style byte-level pre-tokenization pattern: contractions, letter runs
# (with optional leading space), number runs, punctuation runs, whitespace.
_BYTELEVEL_PAT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+",
    re.UNICODE,
)
_WHITESPACE_PAT = re.compile(r"\w+|[^\w\s]+", re.UNICODE)


def _bytes_to_unicode() -> dict[int, str]:
    """Reversible byte→printable-unicode map (byte-level BPE alphabet).

    Printable bytes map to themselves; the rest are shifted into the
    256–511 private range so every byte has a visible, JSON-safe symbol.
    """
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


_BYTE_ENCODER = _bytes_to_unicode()
_BYTE_DECODER = {v: k for k, v in _BYTE_ENCODER.items()}


class BPETokenizer:
    """Byte-pair-encoding tokenizer with ByteLevel or whitespace pre-tok.

    API mirrors what the reference scripts use from HF ``tokenizers``:
    ``encode(text) -> ids``, ``decode(ids)``, ``token_to_id``, ``save`` /
    ``load``, ``get_vocab_size()``.
    """

    def __init__(
        self,
        vocab: dict[str, int],
        merges: list[tuple[str, str]],
        *,
        pre_tokenizer: str = "bytelevel",
        special_tokens: Iterable[str] = DEFAULT_SPECIAL_TOKENS,
        unk_token: str = "[UNK]",
    ):
        if pre_tokenizer not in ("bytelevel", "whitespace"):
            raise ValueError(f"unknown pre_tokenizer {pre_tokenizer!r}")
        self.vocab = dict(vocab)
        self.merges = [tuple(m) for m in merges]
        self.pre_tokenizer = pre_tokenizer
        self.special_tokens = list(special_tokens)
        self.unk_token = unk_token
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.merge_ranks = {m: i for i, m in enumerate(self.merges)}
        self._cache: dict[str, list[str]] = {}
        self._special_re = (
            re.compile("(" + "|".join(re.escape(t) for t in self.special_tokens) + ")")
            if self.special_tokens
            else None
        )

    # ------------------------------------------------------------------ train
    @classmethod
    def train(
        cls,
        texts: Iterable[str],
        vocab_size: int = 30000,
        *,
        pre_tokenizer: str = "bytelevel",
        special_tokens: Iterable[str] = DEFAULT_SPECIAL_TOKENS,
        min_frequency: int = 2,
        unk_token: str = "[UNK]",
    ) -> "BPETokenizer":
        """Train BPE from a text iterator (``train_from_iterator`` parity).

        Classic BPE: count pre-tokenized words, then repeatedly merge the
        most frequent adjacent symbol pair. Pair counts are updated
        incrementally per merge (only words containing the merged pair are
        touched), which keeps wikitext-2-scale training in pure Python
        tractable.
        """
        special_tokens = list(special_tokens)
        word_freq: Counter[tuple[str, ...]] = Counter()
        alphabet: set[str] = set()
        for text in texts:
            for piece in cls._pre_tokenize_static(text, pre_tokenizer):
                word_freq[tuple(piece)] += 1
        for word in word_freq:
            alphabet.update(word)
        if pre_tokenizer == "bytelevel":
            # full 256-byte alphabet so any UTF-8 input round-trips, seen in
            # training or not (byte-level BPE never emits UNK)
            alphabet.update(_BYTE_ENCODER.values())

        vocab: dict[str, int] = {}
        for tok in special_tokens:
            vocab[tok] = len(vocab)
        for sym in sorted(alphabet):
            if sym not in vocab:
                vocab[sym] = len(vocab)

        # words as mutable symbol lists + parallel counts
        words: list[list[str]] = []
        counts: list[int] = []
        for w, c in word_freq.items():
            words.append(list(w))
            counts.append(c)

        # pair -> total count, pair -> set of word indices containing it
        pair_counts: Counter[tuple[str, str]] = Counter()
        pair_words: dict[tuple[str, str], set[int]] = {}
        for wi, w in enumerate(words):
            for a, b in zip(w, w[1:]):
                pair_counts[(a, b)] += counts[wi]
                pair_words.setdefault((a, b), set()).add(wi)

        merges: list[tuple[str, str]] = []
        while len(vocab) < vocab_size and pair_counts:
            # max by (count, pair) for deterministic tie-breaking
            best = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0]))[0]
            if pair_counts[best] < min_frequency:
                break
            merges.append(best)
            new_sym = best[0] + best[1]
            if new_sym not in vocab:
                vocab[new_sym] = len(vocab)
            affected = pair_words.pop(best, set())
            pair_counts.pop(best, None)
            for wi in affected:
                w = words[wi]
                c = counts[wi]
                # remove old pair contributions for this word
                for a, b in zip(w, w[1:]):
                    p = (a, b)
                    if p == best:
                        continue
                    pair_counts[p] -= c
                    if pair_counts[p] <= 0:
                        del pair_counts[p]
                    ws = pair_words.get(p)
                    if ws is not None:
                        ws.discard(wi)
                        if not ws:
                            del pair_words[p]
                # apply the merge in-place
                j = 0
                merged: list[str] = []
                while j < len(w):
                    if j < len(w) - 1 and w[j] == best[0] and w[j + 1] == best[1]:
                        merged.append(new_sym)
                        j += 2
                    else:
                        merged.append(w[j])
                        j += 1
                words[wi] = merged
                # add new pair contributions
                for a, b in zip(merged, merged[1:]):
                    p = (a, b)
                    if p == best:
                        continue
                    pair_counts[p] = pair_counts.get(p, 0) + c
                    pair_words.setdefault(p, set()).add(wi)

        return cls(
            vocab,
            merges,
            pre_tokenizer=pre_tokenizer,
            special_tokens=special_tokens,
            unk_token=unk_token,
        )

    # ----------------------------------------------------------------- encode
    @staticmethod
    def _pre_tokenize_static(text: str, pre_tokenizer: str) -> Iterator[str]:
        if pre_tokenizer == "bytelevel":
            for m in _BYTELEVEL_PAT.finditer(text):
                piece = m.group(0).encode("utf-8")
                yield "".join(_BYTE_ENCODER[b] for b in piece)
        else:
            for m in _WHITESPACE_PAT.finditer(text):
                yield m.group(0)

    def _bpe(self, word: str) -> list[str]:
        """Apply merges to one pre-token, lowest-rank pair first."""
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        syms = list(word)
        while len(syms) > 1:
            ranked = [
                (self.merge_ranks.get((a, b)), i)
                for i, (a, b) in enumerate(zip(syms, syms[1:]))
            ]
            ranked = [(r, i) for r, i in ranked if r is not None]
            if not ranked:
                break
            _, i = min(ranked)
            syms[i : i + 2] = [syms[i] + syms[i + 1]]
        if len(self._cache) < 65536:
            self._cache[word] = syms
        return syms

    def encode(self, text: str, *, add_special_tokens: bool = False) -> list[int]:
        ids: list[int] = []
        if add_special_tokens and "[CLS]" in self.vocab:
            ids.append(self.vocab["[CLS]"])
        chunks = self._special_re.split(text) if self._special_re else [text]
        unk_id = self.vocab.get(self.unk_token)
        for chunk in chunks:
            if not chunk:
                continue
            if chunk in self.special_tokens:
                ids.append(self.vocab[chunk])
                continue
            for piece in self._pre_tokenize_static(chunk, self.pre_tokenizer):
                for sym in self._bpe(piece):
                    tid = self.vocab.get(sym)
                    if tid is None:
                        if unk_id is None:
                            raise KeyError(f"token {sym!r} not in vocab, no unk")
                        ids.append(unk_id)
                    else:
                        ids.append(tid)
        if add_special_tokens and "[SEP]" in self.vocab:
            ids.append(self.vocab["[SEP]"])
        return ids

    def encode_batch(self, texts: Iterable[str]) -> list[list[int]]:
        return [self.encode(t) for t in texts]

    def decode(self, ids: Iterable[int], *, skip_special_tokens: bool = True) -> str:
        toks: list[str] = []
        for i in ids:
            tok = self.id_to_token.get(int(i), self.unk_token)
            if skip_special_tokens and tok in self.special_tokens:
                continue
            toks.append(tok)
        text = "".join(toks)
        if self.pre_tokenizer == "bytelevel":
            data = bytes(_BYTE_DECODER[c] for c in text if c in _BYTE_DECODER)
            return data.decode("utf-8", errors="replace")
        return text

    # ------------------------------------------------------------------- misc
    def token_to_id(self, token: str) -> int | None:
        return self.vocab.get(token)

    def id_to_token_str(self, idx: int) -> str | None:
        return self.id_to_token.get(idx)

    def get_vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def vocab_size(self) -> int:
        """Alias matching :class:`CharTokenizer`'s interface."""
        return len(self.vocab)

    @property
    def pad_id(self) -> int:
        return self.vocab.get("[PAD]", 0)

    # ------------------------------------------------------------- save/load
    def save(self, path: str) -> None:
        payload = {
            "version": 1,
            "model": "BPE",
            "pre_tokenizer": self.pre_tokenizer,
            "unk_token": self.unk_token,
            "special_tokens": self.special_tokens,
            "vocab": self.vocab,
            "merges": [list(m) for m in self.merges],
        }
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, ensure_ascii=False)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
        return cls(
            payload["vocab"],
            [tuple(m) for m in payload["merges"]],
            pre_tokenizer=payload.get("pre_tokenizer", "bytelevel"),
            special_tokens=payload.get("special_tokens", DEFAULT_SPECIAL_TOKENS),
            unk_token=payload.get("unk_token", "[UNK]"),
        )

