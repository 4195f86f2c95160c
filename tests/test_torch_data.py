"""PyTorch port: the calibration and SFT data modules against JAX's.

``data/lm_dataset.py``, ``data/loader.py`` and ``data/converters.py`` are
copies (the port imports nothing of the JAX package); here both run on
the same numpy-seeded inputs and must give equal strings and arrays.
``prepare_data`` is compared through its local-file and synthetic
branches only: the JAX function's ``datasets`` branch first resolves the
hub's host name, and these tests ask no network.
"""

import json

import numpy as np
import pytest

from llm_in_practise_tpu.data import converters as jax_conv
from llm_in_practise_tpu.data import lm_dataset as jax_lm
from llm_in_practise_tpu.data import loader as jax_loader
from llm_in_practise_tpu_torch.data import converters as conv
from llm_in_practise_tpu_torch.data import lm_dataset as lm
from llm_in_practise_tpu_torch.data import loader


class _CharTok:
    """A deterministic stand-in tokenizer: one id per character."""

    def encode(self, text):
        return [ord(c) % 97 for c in text]


@pytest.mark.parametrize("seed", [0, 7, lm._stable_seed("wikitext-2",
                                                        "train")])
def test_synthetic_corpus_equal_strings(seed):
    assert lm._stable_seed("a", "b") == jax_lm._stable_seed("a", "b")
    assert lm.synthetic_corpus(300, seed) == jax_lm.synthetic_corpus(300, seed)


def test_prepare_data_local_file_and_synthetic(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_text("first line\n\n  \nsecond line\nthird\n", encoding="utf-8")
    assert (lm.prepare_data(local_path=str(path))
            == jax_lm.prepare_data(local_path=str(path))
            == ["first line", "second line", "third"])
    # a name outside wikitext goes straight to the seeded synthetic corpus
    assert (lm.prepare_data("tiny-corpus", synthetic_lines=50)
            == jax_lm.prepare_data("tiny-corpus", synthetic_lines=50))


@pytest.mark.parametrize("block", [8, 33])
def test_block_chunk_and_tokenize_corpus_equal_arrays(block):
    texts = lm.synthetic_corpus(40, 3)
    ids = lm.tokenize_corpus(texts, _CharTok())
    np.testing.assert_array_equal(ids,
                                  jax_lm.tokenize_corpus(texts, _CharTok()))
    assert ids.dtype == np.int32
    for a, b in zip(lm.block_chunk(ids, block),
                    jax_lm.block_chunk(ids, block)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32
    with pytest.raises(ValueError, match="too small"):
        lm.block_chunk(ids[:3], block)
    with pytest.raises(ValueError, match="empty"):
        lm.tokenize_corpus([], _CharTok())


@pytest.mark.parametrize("n,frac,seed", [(100, 0.1, 42), (7, 0.5, 1),
                                         (10, 0.0, 3), (10, 1.0, 3)])
def test_train_val_splits_equal(n, frac, seed):
    for a, b in zip(lm.train_val_split(n, frac, seed=seed),
                    jax_lm.train_val_split(n, frac, seed=seed)):
        np.testing.assert_array_equal(a, b)
    arrays = (np.arange(n) * 3, np.arange(n)[:, None] * np.ones((1, 4)))
    got = loader.train_val_split(arrays, frac, seed)
    want = jax_loader.train_val_split(arrays, frac, seed)
    for part_got, part_want in zip(got, want):
        for a, b in zip(part_got, part_want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(batch_size=4),
    dict(batch_size=4, shuffle=False),
    dict(batch_size=3, drop_last=False, seed=5, epoch=2),
    dict(batch_size=4, process_index=1, process_count=2, drop_last=False),
])
def test_batch_iterator_equal(kw):
    arrays = (np.arange(22) * 2, np.arange(44).reshape(22, 2))
    got = list(loader.batch_iterator(arrays, **kw))
    want = list(jax_loader.batch_iterator(arrays, **kw))
    assert len(got) == len(want) > 0
    for bg, bw in zip(got, want):
        for a, b in zip(bg, bw):
            np.testing.assert_array_equal(a, b)
    for n, bs, drop in ((22, 4, True), (22, 4, False), (3, 4, True)):
        assert (loader.num_batches(n, bs, drop)
                == jax_loader.num_batches(n, bs, drop))
    with pytest.raises(ValueError, match="not divisible"):
        next(loader.batch_iterator(arrays, 3, process_count=2))


@pytest.mark.parametrize("record,system", [
    ({"instruction": "Sort.", "input": "[3, 1]", "output": "[1, 3]"}, None),
    ({"instruction": "Hi", "input": "", "output": "Hello"}, "Be brief."),
    ({"instruction": "Only this"}, None),
])
def test_alpaca_to_messages_equal(record, system):
    assert (conv.alpaca_to_messages(record, system)
            == jax_conv.alpaca_to_messages(record, system))


def test_self_cognition_conversion_equal(tmp_path):
    records = [{"query": "Who are you?", "response": "I am {{NAME}}."},
               {"query": "Maker?", "response": "{{AUTHOR}} built {{NAME}}."}]
    assert (conv.self_cognition_to_alpaca(records, name="Bot", author="Lab")
            == jax_conv.self_cognition_to_alpaca(records, name="Bot",
                                                 author="Lab"))
    src = tmp_path / "in.jsonl"
    src.write_text("\n".join(json.dumps(r) for r in records) + "\n\n",
                   encoding="utf-8")
    assert conv.convert_file(str(src), str(tmp_path / "port.json"),
                             name="Bot", author="Lab") == 2
    jax_conv.convert_file(str(src), str(tmp_path / "jax.json"), name="Bot",
                          author="Lab")
    assert ((tmp_path / "port.json").read_bytes()
            == (tmp_path / "jax.json").read_bytes())
