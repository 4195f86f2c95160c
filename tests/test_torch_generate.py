"""PyTorch port: ``infer/generate.py``, ``sample_token`` and the lifecycle CLIs.

Greedy ids from the port's ``generate`` equal the JAX package's on the HF
fixture (both in f32 with an f32 cache), with eos padding, the prompt
crop at ``cache_len`` and the cache cap at the position table.
``sample_token`` keeps the same tokens under top-k and top-p as the JAX
sampler on the same logits (the draw itself uses torch's generator, so
only the kept set is compared). The ``train`` -> ``merge_lora`` ->
``infer`` CLIs run with ``--device cpu``, with and without an HF
``--model_dir``, and ``serve --model_path`` answers a greedy chat with the
tokens ``generate`` gives on the same model.
"""

import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import load_fixture_both, tiny_port_model

from llm_in_practise_tpu.infer import sampling as jax_sampling
from llm_in_practise_tpu.infer.generate import generate as jax_generate
from llm_in_practise_tpu_torch import convert_hf, merge_lora
from llm_in_practise_tpu_torch.ckpt.checkpoint import (
    restore_checkpoint,
    save_named,
)
from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
from llm_in_practise_tpu_torch.data.sft import IM_END, IM_START
from llm_in_practise_tpu_torch.infer import __main__ as infer_cli
from llm_in_practise_tpu_torch.infer.generate import generate, load_model
from llm_in_practise_tpu_torch.infer.sampling import (
    NEG_INF,
    filter_logits,
    sample_token,
)
from llm_in_practise_tpu_torch.models import hf_loader
from llm_in_practise_tpu_torch.models.convert import (
    lora_from_jax,
    params_from_jax,
    params_to_jax,
)
from llm_in_practise_tpu_torch.models.qwen3 import (
    Qwen3Config,
    init_params,
    qwen3_config,
)
from llm_in_practise_tpu_torch.peft.lora import LoRAConfig
from llm_in_practise_tpu_torch.peft.lora import merge_lora as port_merge
from llm_in_practise_tpu_torch.quant.io import load_packed
from llm_in_practise_tpu_torch.serve.__main__ import build_parser, build_server
from llm_in_practise_tpu_torch.train import __main__ as train_cli


@pytest.fixture(scope="module")
def fixture_models():
    return load_fixture_both()


def _both(jmodel, jparams, pmodel, prompt, **kw):
    want = jax_generate(jmodel, jparams, jnp.asarray(prompt), greedy=True,
                        cache_dtype=jnp.float32, **kw)
    got = generate(pmodel, prompt, greedy=True, cache_dtype=torch.float32,
                   **kw)
    return np.asarray(want), got.numpy()


def test_greedy_ids_equal_jax_generate(fixture_models):
    jmodel, jparams, pmodel = fixture_models
    prompt = np.random.default_rng(0).integers(0, 160, (2, 9))
    want, got = _both(jmodel, jparams, pmodel, prompt, max_new_tokens=12)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 21)
    # eos: row 0's fourth new token; row 0 stops there and is padded
    eos = int(want[0, 9 + 3])
    want, got = _both(jmodel, jparams, pmodel, prompt, max_new_tokens=12,
                      eos_id=eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 9 + 3:] == eos).all()
    # the prompt is cropped to cache_len - 1 tokens, leaving room for one
    long_prompt = np.random.default_rng(1).integers(0, 160, (2, 20))
    want, got = _both(jmodel, jparams, pmodel, long_prompt,
                      max_new_tokens=5, cache_len=16)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 16)
    np.testing.assert_array_equal(got[:, :15], long_prompt[:, -15:])
    # the cache is capped at the position table (max_seq_len 64)
    want, got = _both(jmodel, jparams, pmodel, prompt[:, :4],
                      max_new_tokens=100, cache_len=500)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 64)


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.8), (7, 0.5),
                                         (None, 0.0), (3, 0.95)])
def test_sample_token_keeps_the_jax_set(monkeypatch, top_k, top_p):
    logits = np.random.default_rng(3).standard_normal((4, 50)).astype(
        np.float32) * 3
    seen = {}
    categorical = jax.random.categorical

    def capture(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return categorical(key, lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jax_sampling.sample_token(jax.random.PRNGKey(0), jnp.asarray(logits),
                              temperature=0.7, top_k=top_k, top_p=top_p)
    want = seen["logits"] > NEG_INF / 2
    rows = logits.shape[0]
    got = filter_logits(
        torch.from_numpy(logits), temperature=torch.full((rows,), 0.7),
        top_k=torch.full((rows,), top_k or 0),
        top_p=torch.full((rows,), 1.0 if top_p is None else top_p))
    np.testing.assert_array_equal(got.numpy() > NEG_INF / 2, want)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        ids = sample_token(gen, torch.from_numpy(logits), temperature=0.7,
                           top_k=top_k, top_p=top_p)
        assert want[np.arange(rows), ids.numpy()].all()
    greedy = sample_token(gen, torch.from_numpy(logits), greedy=True)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


def _tiny_hf_dir(path, vocab=512):
    """An HF directory of a small random Qwen3 written by ``save_qwen3``."""
    cfg = qwen3_config(vocab, n_layer=2, hidden_size=64,
                       intermediate_size=128, head_dim=16, max_seq_len=64)
    state = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    hf_loader.save_qwen3(state, cfg, path)
    return cfg


def _train(tmp_path, *extra):
    adapter = str(tmp_path / "adapter")
    assert train_cli.main(["--steps", "2", "--device", "cpu",
                           "--max_length", "32", "--batch_size", "2",
                           "--adapter_dir", adapter,
                           "--tokenizer_path", str(tmp_path / "tok.json"),
                           *extra]) == 0
    return adapter


def test_train_merge_and_infer_clis_with_an_hf_model(tmp_path, capsys):
    hf = str(tmp_path / "hf")
    _tiny_hf_dir(hf)
    adapter = _train(tmp_path, "--model_dir", hf)
    out = str(tmp_path / "merged")
    assert merge_lora.main(["--adapter_dir", adapter, "--model_dir", hf,
                            "--out_dir", out, "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == ["config.json", "model.json",
                                       "model.msgpack", "model.safetensors"]
    tree, meta = restore_checkpoint(os.path.join(out, "model.msgpack"))
    cfg = Qwen3Config.from_dict(meta["config"])
    merged = params_from_jax(tree, cfg)
    # the file holds the in-memory merge of the HF base and the adapter
    cfg_hf, base = hf_loader.load_qwen3(hf, device="cpu")
    atree, ameta = restore_checkpoint(os.path.join(adapter, "adapter.msgpack"))
    want = port_merge(base, lora_from_jax(atree, cfg_hf),
                      LoRAConfig.from_dict(ameta["lora_config"]))
    assert sorted(merged) == sorted(want)
    for name, t in want.items():
        assert t.dtype == torch.bfloat16 and torch.equal(merged[name], t)
    # the f32 HF export, cast back to bf16, holds the same weights
    _, export = hf_loader.load_qwen3(out, device="cpu")
    for name, t in want.items():
        assert torch.equal(export[name], t), name
    capsys.readouterr()
    assert infer_cli.main(["--model_path", os.path.join(out, "model.msgpack"),
                           "--tokenizer_path", str(tmp_path / "tok.json"),
                           "--device", "cpu", "--greedy",
                           "--max_new_tokens", "4"]) == 0
    assert capsys.readouterr().out.startswith("> Who are you?\n")


def test_merge_cli_rebuilds_the_tiny_model_and_convert_cli_exports(tmp_path,
                                                                  capsys):
    adapter = _train(tmp_path)
    out = str(tmp_path / "merged")
    assert merge_lora.main(["--adapter_dir", adapter, "--out_dir", out,
                            "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == ["model.json", "model.msgpack"]
    tree, meta = restore_checkpoint(os.path.join(out, "model.msgpack"))
    atree, ameta = restore_checkpoint(os.path.join(adapter, "adapter.msgpack"))
    cfg = Qwen3Config.from_dict(ameta["config"])
    _, base = train_cli.tiny_model(cfg.vocab_size, cfg.max_seq_len,
                                   torch.Generator(), "cpu")
    want = port_merge(base, lora_from_jax(atree, cfg),
                      LoRAConfig.from_dict(ameta["lora_config"]))
    merged = params_from_jax(tree, Qwen3Config.from_dict(meta["config"]))
    for name, t in want.items():
        assert torch.equal(merged[name], t), name
    assert infer_cli.main(["--model_path", os.path.join(out, "model.msgpack"),
                           "--tokenizer_path", str(tmp_path / "tok.json"),
                           "--device", "cpu", "--stream",
                           "--max_new_tokens", "4"]) == 0
    # convert_hf: an HF dir to a packed export the server reads
    hf = str(tmp_path / "hf")
    cfg_hf = _tiny_hf_dir(hf)
    for fmt in ("nf4", "int8"):
        export = str(tmp_path / fmt)
        assert convert_hf.main(["--model_dir", hf, "--out_dir", export,
                                "--quantization", fmt, "--device", "cpu"]) == 0
        qtree, qmeta = load_packed(export)
        assert qmeta["method"] == fmt and qmeta["family"] == "qwen3"
        assert qmeta["source"] == os.path.abspath(hf)
        assert Qwen3Config.from_dict(qmeta["config"]) == cfg_hf.replace(
            compute_dtype="bfloat16")
        assert type(qtree["block_0"]["mlp"]["up_proj"]["kernel"]).__name__ \
            == {"nf4": "NF4Tensor", "int8": "Int8Tensor"}[fmt]
    with pytest.raises(FileNotFoundError, match="adapter.msgpack"):
        merge_lora.main(["--adapter_dir", str(tmp_path / "none"),
                         "--device", "cpu"])


CORPUS = ("The quick brown fox jumps over the lazy dog. A tokenizer learns "
          "merges from the text it sees; the server renders chat messages "
          "as ChatML. Hello there, how are you? ")


def test_serve_model_path_answers_with_generate_tokens(tmp_path):
    tok = BPETokenizer.train([CORPUS] * 4, vocab_size=320,
                             special_tokens=[IM_START, IM_END],
                             min_frequency=1)
    tok_path = str(tmp_path / "tok.json")
    tok.save(tok_path)
    model = tiny_port_model(tok.get_vocab_size(), seed=11, max_seq_len=128)
    state = {n: p.detach() for n, p in model.named_parameters()}
    path = save_named(str(tmp_path / "merged"), params_to_jax(state,
                                                              model.cfg),
                      "model", metadata={"config": model.cfg.to_dict()})
    assert torch.equal(load_model(path, "cpu").tok_embed.weight,
                       model.tok_embed.weight)
    server = build_server(build_parser().parse_args(
        ["--model_path", path, "--tokenizer_path", tok_path,
         "--device", "cpu", "--max_slots", "1", "--cache_len", "128",
         "--scan-layers"]))
    seen = []
    submit = server.engine.submit

    def recording_submit(*args, **kwargs):
        seen.append(submit(*args, **kwargs))
        return seen[-1]

    server.engine.submit = recording_submit
    port = server.serve(host="127.0.0.1", port=0, background=True)
    body = {"model": "qwen3-h100", "temperature": 0.0, "max_tokens": 8,
            "messages": [{"role": "user", "content": "Hello there, fox?"}]}
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/chat/completions",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            content = json.loads(r.read())["choices"][0]["message"]["content"]
    finally:
        server.shutdown()
    (request,) = seen
    eos = tok.token_to_id(IM_END)
    ids = generate(server.engine.model, [request.prompt_ids], greedy=True,
                   max_new_tokens=8, eos_id=eos, cache_len=128,
                   cache_dtype=torch.float32)[0, len(request.prompt_ids):]
    new = ids.tolist()
    if eos in new:
        new = new[:new.index(eos)]
    assert request.output_ids == new and new
    assert content == tok.decode(new)
