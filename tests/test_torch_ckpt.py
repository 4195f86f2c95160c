"""PyTorch port: checkpoints in flax's msgpack format, both directions.

The port writes the bytes ``flax.serialization.to_bytes`` writes for the
same tree (ext type 1 arrays with bf16 named ``bfloat16``, ext type 3
numpy scalars, insertion order, chunked maps above ``MAX_CHUNK_SIZE``),
reads what the JAX package's ``save_named`` writes, and the other way
round. The adapter gate: an adapter the JAX package saves restores
through ``lora_from_jax``, and one the port's train CLI saves restores in
the JAX ``restore_checkpoint`` with its ``lora_config``; JAX
``merge_lora`` on it equals the port's merge at 1e-6 (f32 products in a
different summation order).
"""

import os

import flax.serialization
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from llm_in_practise_tpu.ckpt import checkpoint as jax_ckpt
from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.models.qwen3 import qwen3_config as jax_qwen3_config
from llm_in_practise_tpu.peft import lora as jax_lora
from llm_in_practise_tpu_torch.ckpt import checkpoint as ckpt
from llm_in_practise_tpu_torch.models.convert import (
    flax_path,
    lora_from_jax,
    lora_to_jax,
    params_to_jax,
)
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3Config
from llm_in_practise_tpu_torch.peft.lora import LoRAConfig, merge_lora
from llm_in_practise_tpu_torch.train import __main__ as train_cli


def _numpy_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "b": rng.standard_normal(3).astype(np.float32),
        "a": {"z": rng.standard_normal(2).astype(ml_dtypes.bfloat16),
              "c": np.int8(-3),
              "s": np.float32(2.5),
              "u": rng.integers(0, 255, (4, 5)).astype(np.uint8),
              "q": rng.integers(-127, 127, (64, 3)).astype(np.int8),
              "d0": np.asarray(1.5, np.float32),
              "e": np.zeros((0, 3), np.float32)},
        "w": rng.standard_normal((40, 30)).astype(np.float32),
    }


def _as_torch(tree):
    """The same tree with every array leaf a torch tensor (numpy scalars
    stay: the port writes them as flax does, ext type 3)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _as_torch(v)
        elif isinstance(v, np.ndarray):
            if v.dtype == ml_dtypes.bfloat16:
                out[k] = torch.from_numpy(v.view(np.uint16).astype(
                    np.int32)).to(torch.int16).view(torch.bfloat16)
            else:
                out[k] = torch.from_numpy(v.copy())
        else:
            out[k] = v
    return out


def _assert_tree_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_tree_equal(g, w)
            continue
        w = np.asarray(w)
        assert isinstance(g, torch.Tensor) and tuple(g.shape) == w.shape
        if w.dtype == ml_dtypes.bfloat16:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_flax_probe_tree_is_two_arrays_then_a_scalar(tmp_path):
    tree = {"b": np.zeros(3, np.float32),
            "a": {"z": np.zeros(2, ml_dtypes.bfloat16), "c": np.int8(1)}}
    want = flax.serialization.to_bytes(tree)
    codes = []
    flax.serialization.msgpack.unpackb(
        want, ext_hook=lambda c, d: codes.append(c), raw=False)
    assert codes == [1, 1, 3]
    path = str(tmp_path / "probe.msgpack")
    ckpt.write_msgpack(path, tree)
    assert _bytes(path) == want


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_port_bytes_equal_flax_to_bytes(tmp_path, leaves):
    tree = _numpy_tree()
    want = flax.serialization.to_bytes(tree)
    path = str(tmp_path / "t.msgpack")
    ckpt.write_msgpack(path, tree if leaves == "numpy" else _as_torch(tree))
    assert _bytes(path) == want
    got = ckpt.read_msgpack(path)
    _assert_tree_equal(got, tree)
    assert list(got) == list(tree) and list(got["a"]) == list(tree["a"])


def test_jax_save_named_restores_in_the_port_and_back(tmp_path):
    tree = _numpy_tree(1)
    meta = {"config": {"n_layer": 2}, "note": "x"}
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jpath = jax_ckpt.save_named(jax_dir, tree, "model", metadata=meta)
    got, got_meta = ckpt.restore_checkpoint(jpath)
    assert list(got) == ["a", "b", "w"]   # a JAX pytree's key order
    _assert_tree_equal(got, tree)
    assert got_meta == meta
    ppath = ckpt.save_named(port_dir, _as_torch(tree), "model", metadata=meta)
    assert _bytes(ppath) == _bytes(jpath)
    assert _bytes(ppath.replace(".msgpack", ".json")) == _bytes(
        jpath.replace(".msgpack", ".json"))
    back, back_meta = jax_ckpt.restore_checkpoint(ppath)
    assert back_meta == meta
    for k in ("b", "w"):
        np.testing.assert_array_equal(back[k], tree[k])
    # no sidecar: empty metadata in both
    ckpt.save_named(port_dir, {"x": torch.ones(2)}, "bare")
    assert ckpt.restore_checkpoint(os.path.join(port_dir, "bare.msgpack"))[1] \
        == {}
    with pytest.raises(FileNotFoundError, match="missing.msgpack"):
        ckpt.restore_checkpoint(str(tmp_path / "missing.msgpack"))


def test_chunked_leaf_round_trips(tmp_path, monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 4096)
    monkeypatch.setattr(ckpt, "MAX_CHUNK_SIZE", 4096)
    rng = np.random.default_rng(2)
    tree = {"emb": rng.standard_normal((100, 30)).astype(ml_dtypes.bfloat16),
            "f": {"w": rng.standard_normal((33, 40)).astype(np.float32),
                  "small": np.arange(5, dtype=np.int32)}}
    want = flax.serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in want
    path = str(tmp_path / "c.msgpack")
    ckpt.write_msgpack(path, _as_torch(tree))
    assert _bytes(path) == want
    _assert_tree_equal(ckpt.read_msgpack(path), tree)
    back = flax.serialization.msgpack_restore(_bytes(path))
    np.testing.assert_array_equal(back["f"]["w"], tree["f"]["w"])


def test_rotation_and_latest_give_jax_file_names(tmp_path):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    tree = {"w": np.ones(3, np.float32)}
    for step in (1, 5, 12, 30):
        jpath = jax_ckpt.save_checkpoint(jdir, tree, step, keep=2,
                                         metadata={"loss": 0.5})
        ppath = ckpt.save_checkpoint(pdir, _as_torch(tree), step, keep=2,
                                     metadata={"loss": 0.5})
        assert os.path.basename(ppath) == os.path.basename(jpath)
        assert _bytes(ppath) == _bytes(jpath)
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == [
        "ckpt_00000012.json", "ckpt_00000012.msgpack",
        "ckpt_00000030.json", "ckpt_00000030.msgpack"]
    assert os.path.basename(ckpt.latest_checkpoint(pdir)) == \
        "ckpt_00000030.msgpack"
    assert ckpt.restore_checkpoint(ckpt.latest_checkpoint(pdir))[1] == {
        "loss": 0.5, "step": 30}
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None


def test_jax_adapter_restores_through_lora_from_jax(tmp_path):
    jcfg = jax_qwen3_config(128, n_layer=2, hidden_size=64,
                            intermediate_size=128, head_dim=16)
    params = JaxQwen3(jcfg).init_params(jax.random.PRNGKey(0))
    lcfg = jax_lora.LoRAConfig(r=4, alpha=8.0)
    lora = jax_lora.init_lora(params, lcfg, jax.random.PRNGKey(1))
    lora = jax.tree.map(lambda x: x + 0.1, lora)   # a nonzero b
    path = jax_ckpt.save_named(str(tmp_path), jax.device_get(lora),
                               "adapter",
                               metadata={"lora_config": lcfg.to_dict()})
    tree, meta = ckpt.restore_checkpoint(path)
    assert LoRAConfig.from_dict(meta["lora_config"]).to_dict() == \
        lcfg.to_dict()
    cfg = Qwen3Config.from_dict(jcfg.to_dict())
    carried = lora_from_jax(tree, cfg)
    assert sorted(carried) == sorted(
        p.replace("block_", "blocks.").replace("/", ".") for p in lora)
    for path_, ab in lora.items():
        name = path_.replace("block_", "blocks.").replace("/", ".")
        for k in ("a", "b"):
            np.testing.assert_array_equal(carried[name][k].numpy(),
                                          np.asarray(ab[k]))
    # back out through lora_to_jax: the same bytes as JAX's file
    again = ckpt.save_named(str(tmp_path / "again"), lora_to_jax(carried),
                            "adapter")
    assert _bytes(again) == _bytes(path)
    # an adapter of a scan-layers run: a and b stacked under blocks/block
    stacked = jax_lora.stack_lora_tree(lora, jcfg.n_layer)
    assert all(k.startswith("blocks/block/") for k in stacked)
    spath = jax_ckpt.save_named(str(tmp_path / "scan"),
                                jax.device_get(stacked), "adapter")
    unstacked = lora_from_jax(ckpt.restore_checkpoint(spath)[0], cfg)
    assert sorted(unstacked) == sorted(carried)
    for name, ab in carried.items():
        for k in ("a", "b"):
            assert torch.equal(unstacked[name][k], ab[k])


def test_port_train_adapter_restores_and_merges_in_jax(tmp_path):
    adapter_dir = str(tmp_path / "adapter")
    assert train_cli.main(["--steps", "2", "--device", "cpu",
                           "--max_length", "32", "--batch_size", "2",
                           "--adapter_dir", adapter_dir]) == 0
    path = os.path.join(adapter_dir, "adapter.msgpack")
    jtree, jmeta = jax_ckpt.restore_checkpoint(path)
    lcfg = LoRAConfig.from_dict(jmeta["lora_config"])
    jcfg = jax_lora.LoRAConfig.from_dict(jmeta["lora_config"])
    assert jcfg.to_dict() == lcfg.to_dict()
    assert jcfg.target_patterns == (r"attn/(q_proj|v_proj)",)
    assert set(jtree) == {f"block_{i}/attn/{p}/kernel"
                          for i in range(2) for p in ("q_proj", "v_proj")}
    for ab in jtree.values():
        assert ab["a"].dtype == np.float32 and np.any(ab["b"] != 0)

    # the base the adapter was trained on, rebuilt as the merge CLI does
    cfg = Qwen3Config.from_dict(jmeta["config"])
    _, state = train_cli.tiny_model(cfg.vocab_size, cfg.max_seq_len,
                                    torch.Generator(), "cpu")
    ptree, _ = ckpt.restore_checkpoint(path)
    got = merge_lora(state, lora_from_jax(ptree, cfg), lcfg)
    jparams = jax.tree.map(lambda t: t.numpy(), params_to_jax(state, cfg))
    want = jax_lora.merge_lora(jparams, jtree, jcfg)
    for name, t in got.items():
        leaf = want
        for part in flax_path(name).split("/"):
            leaf = leaf[part]
        np.testing.assert_allclose(t.numpy(), np.asarray(leaf), rtol=0,
                                   atol=1e-6)
