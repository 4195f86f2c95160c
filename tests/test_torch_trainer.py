"""PyTorch port: ``train/trainer.py``, ``core/config.py``, the LM-head
bias in the fused CE, and the GPT CLIs (``minigpt_train``,
``gptlike_wikitext``), against the JAX package.

- ``core/config.py``: the precedence, ``"auto"``, unknown-key, coercion
  and PEP 604 cases of JAX ``tests/test_trainer.py:21-57`` as one
  parametrised test, each run on both packages' ``load`` / ``merge``.
- The Trainer on a tiny f32 GPT (dropout 0), the same init carried from
  JAX's Trainer and the same batch order: one step's params equal JAX's
  at 1e-5, and two epochs' history records (keys, steps, train and eval
  losses); it learns; the eval scores the ragged tail batch; resume from
  the latest checkpoint continues where an uninterrupted run goes;
  early stopping; non-``ddp`` strategies and larger meshes raise naming
  queue A item 14, ``zero_offload`` item 13; JAX's
  ``restore_checkpoint`` and ``GPT.apply`` read a port-written
  ``best_model`` and give the port's logits.
- ``fused_linear_cross_entropy`` with an untied GPT head's bias equals
  JAX's (tiled and untiled).
- The CLIs on the CPU at a small size: the loss falls, a checkpoint and
  a sample come out.
"""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_in_practise_tpu.ckpt import checkpoint as jax_ckpt
from llm_in_practise_tpu.core import config as jax_config
from llm_in_practise_tpu.models.gpt import GPT as JaxGPT
from llm_in_practise_tpu.models.gpt import GPTConfig as JaxGPTConfig
from llm_in_practise_tpu.train import losses as jax_losses
from llm_in_practise_tpu.train.trainer import Trainer as JaxTrainer
from llm_in_practise_tpu.train.trainer import TrainerConfig as JaxTC

from llm_in_practise_tpu_torch import gptlike_wikitext, minigpt_train
from llm_in_practise_tpu_torch.ckpt import checkpoint as ckpt
from llm_in_practise_tpu_torch.core import config as config_lib
from llm_in_practise_tpu_torch.models.convert import gpt_params_from_jax
from llm_in_practise_tpu_torch.models.gpt import GPT, GPTConfig
from llm_in_practise_tpu_torch.train import losses
from llm_in_practise_tpu_torch.train.step import head_weight
from llm_in_practise_tpu_torch.train.trainer import Trainer, TrainerConfig

GPT_KW = dict(vocab_size=61, seq_len=16, n_layer=2, n_head=2, embed_dim=32,
              dropout=0.0, tie_weights=False)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- core/config.py -----------------------------------------------------------


def _precedence(lib, tc, tmp_path):
    f = tmp_path / "train.json"
    f.write_text(json.dumps({"lr": 0.5, "epochs": 7}))
    cfg = lib.load(tc, config_file=str(f), cli_namespace=argparse.Namespace(
        lr=0.1, epochs=None, batch_size=4))
    return cfg.lr, cfg.epochs, cfg.batch_size


def _auto(lib, tc, tmp_path):
    return lib.load(tc, auto_resolvers={"total_steps": lambda: 123}
                    ).total_steps


def _unknown(lib, tc, tmp_path):
    f = tmp_path / "bad.json"
    f.write_text(json.dumps({"learning_rate_typo": 0.5}))
    with pytest.raises(ValueError, match="unknown") as e:
        lib.load(tc, config_file=str(f))
    return str(e.value)


def _coercion(lib, tc, tmp_path):
    cfg = lib.merge(tc(), {"lr": "0.25", "epochs": "3"})
    return cfg.lr, cfg.epochs


def _pep604(lib, tc, tmp_path):
    cfg = lib.load(tc, cli_namespace=argparse.Namespace(clip_norm="0.5"))
    return cfg.clip_norm, type(cfg.clip_norm).__name__


@pytest.mark.parametrize("case,want", [
    (_precedence, (0.5, 7, 4)), (_auto, 123),
    (_unknown, "unknown TrainerConfig key: learning_rate_typo"),
    (_coercion, (0.25, 3)), (_pep604, (0.5, "float"))])
def test_config_cases_match_jax(case, want, tmp_path):
    assert case(config_lib, TrainerConfig, tmp_path) == want
    assert case(jax_config, JaxTC, tmp_path) == want
    assert TrainerConfig.from_sources(total_steps=7).total_steps == 7


def test_trainer_config_fields_match_jax():
    port = {f: getattr(TrainerConfig(), f) for f in
            TrainerConfig.__dataclass_fields__}
    jax_ = {f: getattr(JaxTC(), f) for f in JaxTC.__dataclass_fields__}
    assert port == jax_


# --- the Trainer --------------------------------------------------------------


def data(n=20, seed=0):
    x = np.random.default_rng(seed).integers(0, 61, (n, 16)).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


def jax_trainer(tc, steps_per_epoch):
    jt = JaxTrainer(JaxGPT(JaxGPTConfig(**GPT_KW)), JaxTC(**tc))
    x, _ = data()
    jt.state = jt._init_state(x[:1], steps_per_epoch)
    p0 = jax.tree.map(np.asarray, jax.device_get(jt.state.params))
    return jt, p0


def port_trainer(tc, p0, **kw):
    cfg = GPTConfig(**GPT_KW)
    return Trainer(GPT(cfg, device="cpu"), TrainerConfig(**tc),
                   params=gpt_params_from_jax(p0, cfg), **kw)


def assert_params_close(pt, jt, tol=1e-5):
    want = gpt_params_from_jax(
        jax.tree.map(np.asarray, jax.device_get(jt.state.params)),
        pt.model.cfg)
    for n, t in pt.params.items():
        np.testing.assert_allclose(t.numpy(), want[n], rtol=tol, atol=tol,
                                   err_msg=n)


def test_one_step_and_two_epochs_match_jax():
    x, y = data()
    # one step of a batch of 16 (JAX's test run has 8 CPU devices: its
    # batches divide by 8)
    tc = dict(lr=1e-2, epochs=1, batch_size=16, log_every_steps=0)
    jt, p0 = jax_trainer(tc, 1)
    jt.train((x[:16], y[:16]))
    pt = port_trainer(tc, p0)
    pt.train((x[:16], y[:16]))
    assert pt.state.step == 1
    assert_params_close(pt, jt)
    # two epochs, a cosine schedule with warm-up, a held-out eval
    tc = dict(lr=1e-2, epochs=2, batch_size=8, schedule="cosine",
              warmup_steps=1, log_every_steps=0)
    jt, p0 = jax_trainer(tc, 2)
    jh = jt.train((x, y), eval_data=(x[:5], y[:5]))
    pt = port_trainer(tc, p0)
    ph = pt.train((x, y), eval_data=(x[:5], y[:5]))
    assert [sorted(r) for r in ph] == [sorted(r) for r in jh]
    for p, j in zip(ph, jh):
        assert (p["epoch"], p["step"]) == (j["epoch"], j["step"])
        np.testing.assert_allclose(p["train_loss"], j["train_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(p["eval_loss"], j["eval_loss"], rtol=1e-5)
    assert_params_close(pt, jt, tol=1e-4)


def test_learns_and_evaluates_the_tail_batch():
    x = np.tile(np.arange(16, dtype=np.int32) % 7, (24, 1))
    y = np.roll(x, -1, axis=1)
    tc = dict(lr=3e-3, epochs=6, batch_size=8, log_every_steps=0)
    pt = port_trainer(tc, jax_trainer(tc, 3)[1])
    hist = pt.train((x, y))
    assert hist[-1]["train_loss"] < 0.5 * hist[0]["train_loss"]
    # eval: 11 samples at batch 8 -> one full batch and a tail of 3
    xe, ye = data(11, seed=3)
    batches = list(pt._batches((xe, ye), 0, eval_mode=True))
    assert [len(b[0]) for b in batches] == [8, 3]
    m = pt.model
    with torch.no_grad():
        logits = m(torch.from_numpy(xe).long())
        want, _ = losses.cross_entropy(logits, torch.from_numpy(ye).long())
    np.testing.assert_allclose(pt.evaluate((xe, ye)), float(want), rtol=1e-6)


def test_resume_continues_as_an_uninterrupted_run(tmp_path):
    x, y = data(24)
    tc = dict(lr=1e-2, epochs=3, batch_size=8, log_every_steps=0,
              ckpt_dir=str(tmp_path / "a"))
    _, p0 = jax_trainer(tc, 3)
    full = port_trainer(tc, p0)
    full.train((x, y))
    half = port_trainer({**tc, "epochs": 1, "ckpt_dir": str(tmp_path / "b")},
                        p0)
    half.train((x, y))
    assert ckpt.latest_checkpoint(str(tmp_path / "b")).endswith(
        "ckpt_00000003.msgpack")
    tree, meta = ckpt.restore_checkpoint(
        ckpt.latest_checkpoint(str(tmp_path / "b")))
    assert sorted(tree) == ["opt_state", "params", "rng", "step"]
    assert meta["config"]["epochs"] == 1 and meta["step"] == 3
    resumed = port_trainer({**tc, "ckpt_dir": str(tmp_path / "b")}, p0)
    hist = resumed.train((x, y))
    assert [r["epoch"] for r in hist] == [2, 3]
    assert resumed.state.step == full.state.step == 9
    for n, t in resumed.params.items():
        torch.testing.assert_close(t, full.params[n], rtol=0, atol=0)


def test_early_stopping_and_best_model_read_by_jax(tmp_path):
    x, y = data(16)
    xe, ye = data(8, seed=5)
    tc = dict(lr=5e-2, epochs=8, batch_size=8, log_every_steps=0,
              eval_every_steps=1, early_stop_patience=1,
              ckpt_dir=str(tmp_path))
    pt = port_trainer(tc, jax_trainer(tc, 2)[1],
                      metadata={"note": "port"})
    hist = pt.train((x, y), eval_data=(xe, ye))
    assert len(hist) < 8        # stopped early
    params, meta = jax_ckpt.restore_checkpoint(
        os.path.join(str(tmp_path), "best_model.msgpack"))
    assert meta["note"] == "port" and meta["step"] >= 1
    ids = np.asarray(xe[:2])
    jlogits = np.asarray(JaxGPT(JaxGPTConfig(**GPT_KW)).apply(
        {"params": params}, jnp.asarray(ids)))
    best = GPT(GPTConfig(**GPT_KW), device="cpu")
    best.load_state(gpt_params_from_jax(params, best.cfg))
    with torch.no_grad():
        got = best(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, jlogits, rtol=1e-5, atol=1e-5)
    with torch.no_grad():    # the recorded eval loss is the best model's
        loss, _ = losses.cross_entropy(best(torch.from_numpy(xe).long()),
                                       torch.from_numpy(ye).long())
    np.testing.assert_allclose(meta["eval_loss"], float(loss), rtol=1e-5)


@pytest.mark.parametrize("kw,item", [
    ({"strategy": "fsdp"}, 14), ({"strategy": "tp"}, 14),
    ({"strategy": "zero1"}, 14), ({"mesh_data": 2}, 14),
    ({"mesh_model": 2}, 14), ({"strategy": "zero_offload"}, 13)])
def test_unported_strategies_raise(kw, item):
    with pytest.raises(NotImplementedError, match=f"queue A item {item}"):
        Trainer(GPT(GPTConfig(**GPT_KW), device="cpu"), TrainerConfig(**kw))
    with pytest.raises(ValueError, match="unknown strategy"):
        Trainer(GPT(GPTConfig(**GPT_KW), device="cpu"),
                TrainerConfig(strategy="nope"))


@pytest.mark.parametrize("vocab_chunk", [None, 16])
def test_fused_ce_carries_the_head_bias(vocab_chunk):
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 6, 32)).astype(np.float32)
    w = (0.2 * rng.standard_normal((32, 64))).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    y = rng.integers(0, 64, (2, 6))
    want, _ = jax_losses.fused_linear_cross_entropy(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(y), bias=jnp.asarray(b),
        vocab_chunk=vocab_chunk, compute_dtype=jnp.float32)
    got, _ = losses.fused_linear_cross_entropy(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(y),
        bias=torch.from_numpy(b), vocab_chunk=vocab_chunk,
        compute_dtype=torch.float32)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    m = GPT(GPTConfig(**GPT_KW), device="meta")
    kernel, transpose, bias = head_weight(m)
    assert kernel is m.lm_head.kernel and not transpose
    assert bias is m.lm_head.bias
    tied = GPT(GPTConfig(**{**GPT_KW, "tie_weights": True}), device="meta")
    assert head_weight(tied)[1:] == (True, None)


# --- the CLIs -----------------------------------------------------------------


def test_minigpt_train_cli_learns_and_samples(tmp_path):
    out = minigpt_train.run(["--epochs", "6", "--seq_len", "16",
                             "--batch_size", "16", "--ckpt_dir",
                             str(tmp_path), "--device", "cpu",
                             "--text", "abcdefgh " * 12,
                             "--prompt", "abc"])
    assert out["losses"][-1] < 0.7 * out["losses"][0]
    assert out["sample"].startswith("abc") and len(out["sample"]) > 3
    tree, meta = jax_ckpt.restore_checkpoint(out["ckpt_path"])
    assert meta["config"]["seq_len"] == 16 and "stoi" in meta["vocab"]
    cfg = JaxGPTConfig.from_dict(meta["config"])
    assert sorted(tree["params"]) == sorted(
        jax.eval_shape(lambda: JaxGPT(cfg).init(
            jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32)))["params"])


def test_gptlike_wikitext_cli_runs_on_the_cpu(tmp_path, monkeypatch):
    import llm_in_practise_tpu_torch.gptlike_wikitext as cli

    # the preset at a small width: the CLI's own path, a cheap model
    real = cli.gptlike_config
    monkeypatch.setattr(cli, "gptlike_config", lambda *a, **k: real(
        *a, **{**k, "n_layer": 2, "embed_dim": 64, "n_head": 2}))
    out = gptlike_wikitext.run([
        "--max_lines", "120", "--vocab_size", "300", "--block_size", "32",
        "--epochs", "2", "--batch_size", "8", "--lr", "3e-3",
        "--tokenizer_path", str(tmp_path / "tok.json"),
        "--ckpt_dir", str(tmp_path / "ck"),
        "--loss_curve", str(tmp_path / "loss.png"), "--device", "cpu"])
    hist = out["history"]
    assert [r["epoch"] for r in hist] == [1, 2]
    assert hist[1]["train_loss"] < hist[0]["train_loss"]
    assert os.path.exists(tmp_path / "ck" / "best_model.msgpack")
    assert ckpt.latest_checkpoint(str(tmp_path / "ck"))
    assert isinstance(out["sample"], str)
