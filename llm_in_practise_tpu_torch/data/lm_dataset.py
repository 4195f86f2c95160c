"""Language-model datasets: corpus prep, block chunking, splits.

Port of ``llm_in_practise_tpu/data/lm_dataset.py`` (a copy: the port
imports nothing of the JAX package, not even its numpy-only modules).
Outputs are host numpy int32, equal to the JAX package's.

``prepare_data`` resolves a corpus in the JAX package's order: an
explicit local file, then the HF ``datasets`` cache, then the
deterministic synthetic corpus. The one difference: the port never asks
the network. Where the JAX function first resolves the hub's host name
(and turns the hub's offline switches on when that fails), the port
turns them on outright, so ``datasets`` reads only what is already in
its local cache; offline, both packages end at the synthetic corpus.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
from collections.abc import Sequence

import numpy as np


def prepare_data(
    dataset: str = "wikitext-2",
    split: str = "train",
    *,
    local_path: str | None = None,
    synthetic_lines: int = 20000,
) -> list[str]:
    """A text corpus as filtered non-empty lines: ``local_path`` ->
    the local HF ``datasets`` cache (``wikitext-2`` / ``wikitext-103``)
    -> :func:`synthetic_corpus` seeded from the name and split."""
    if local_path is not None:
        with open(local_path, encoding="utf-8") as f:
            lines = f.read().splitlines()
        return [ln for ln in lines if ln.strip()]
    if (dataset.startswith("wikitext")
            and importlib.util.find_spec("datasets") is not None):
        try:
            os.environ.setdefault("HF_HUB_OFFLINE", "1")
            os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
            import datasets as hf_datasets

            name = ("wikitext-103-raw-v1" if "103" in dataset
                    else "wikitext-2-raw-v1")
            ds = hf_datasets.load_dataset(
                "wikitext", name, split=split,
                download_mode="reuse_cache_if_exists")
            return [t for t in ds["text"] if t.strip()]
        except Exception:
            pass
    return synthetic_corpus(n_lines=synthetic_lines,
                            seed=_stable_seed(dataset, split))


def _stable_seed(*parts: str) -> int:
    h = hashlib.sha256("|".join(parts).encode()).digest()
    return int.from_bytes(h[:4], "little")


_SYN_VOCAB = (
    "the of and to a in model training data loss gradient layer attention "
    "head expert token batch step learning rate optimizer shard mesh device "
    "compile kernel memory bandwidth matrix product norm residual embedding "
    "sequence cache decode sample epoch checkpoint resume metric eval test"
).split()


def synthetic_corpus(n_lines: int = 20000, seed: int = 0) -> list[str]:
    """Deterministic pseudo-natural corpus (a Zipf-like word draw): the
    stand-in for wikitext when no copy is at hand."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, len(_SYN_VOCAB) + 1, dtype=np.float64)
    probs = (1.0 / ranks) / (1.0 / ranks).sum()
    lines = []
    lengths = rng.integers(5, 40, size=n_lines)
    for ln in lengths:
        idx = rng.choice(len(_SYN_VOCAB), size=int(ln), p=probs)
        words = [_SYN_VOCAB[i] for i in idx]
        words[0] = words[0].capitalize()
        lines.append(" ".join(words) + ".")
    return lines


def block_chunk(token_ids: Sequence[int] | np.ndarray, block_size: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate -> truncate to a multiple of ``block_size`` -> rows ->
    shift: ``(x, y)`` of shape ``(n_blocks, block_size - 1)``, ``y`` the
    next-token targets."""
    ids = np.asarray(token_ids, dtype=np.int32)
    n_blocks = len(ids) // block_size
    if n_blocks == 0:
        raise ValueError(
            f"corpus of {len(ids)} tokens too small for block_size "
            f"{block_size}")
    blocks = ids[: n_blocks * block_size].reshape(n_blocks, block_size)
    return blocks[:, :-1].copy(), blocks[:, 1:].copy()


def tokenize_corpus(texts: Sequence[str], tokenizer, *, join: str = "\n"
                    ) -> np.ndarray:
    """A whole corpus encoded to one flat int32 id array, each text
    followed by ``join``."""
    ids: list[int] = []
    for text in texts:
        ids.extend(tokenizer.encode(text + join))
    if not ids:
        raise ValueError("empty dataset after tokenization")
    return np.asarray(ids, dtype=np.int32)


def train_val_split(n: int, val_fraction: float = 0.1, *, seed: int = 42
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Seeded permutation split of ``range(n)``: ``(train_idx,
    val_idx)``."""
    perm = np.random.default_rng(seed).permutation(n)
    n_val = max(1, int(n * val_fraction)) if 0 < val_fraction < 1 else 0
    return perm[n_val:], perm[:n_val]
