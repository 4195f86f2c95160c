"""PyTorch port: the HF safetensors loader and writer, and stacked trees.

The committed fixture (``tests/fixtures/qwen3_tiny``, written by torch
transformers) goes through the port's own ``load_qwen3`` with no JAX on
that side and must match the torch goldens at 1e-4 (two independent f32
implementations, as in ``tests/test_qwen3_golden.py``); its state must
equal the JAX loader's tensor for tensor. A two-shard copy with an index
JSON, a bf16 copy and a tied config load as the JAX loader loads them;
``save_qwen3``'s export reads back in the JAX loader. A stacked
scan-layout tree (JAX ``stack_layer_params``), dense through a msgpack
checkpoint and int8 or NF4 packed through ``save_packed``, serves the
unrolled tree's logits exactly, with ``scan_layers`` on and off.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from torch_port_util import FIXTURE

from llm_in_practise_tpu.ckpt import checkpoint as jax_ckpt
from llm_in_practise_tpu.models import hf_loader as jax_hf
from llm_in_practise_tpu.models.qwen3 import stack_layer_params
from llm_in_practise_tpu.quant import int8 as jax_int8
from llm_in_practise_tpu.quant import io as jax_quant_io
from llm_in_practise_tpu.quant import nf4 as jax_nf4
from llm_in_practise_tpu_torch.ckpt.checkpoint import restore_checkpoint
from llm_in_practise_tpu_torch.models import hf_loader
from llm_in_practise_tpu_torch.models.convert import (
    params_from_jax,
    port_name,
    unstack_layer_params,
)
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
from llm_in_practise_tpu_torch.quant.io import load_packed
from llm_in_practise_tpu_torch.serve.quantized import QuantizedModel

F32 = {"compute_dtype": "float32"}


def _port_load(model_dir, dtype=torch.float32, **kw):
    return hf_loader.load_qwen3(model_dir, dtype=dtype, device="cpu",
                                config_overrides=F32, **kw)


def _jax_state(model_dir, dtype=jnp.float32):
    _, params = jax_hf.load_qwen3(model_dir, dtype=dtype,
                                  config_overrides=F32)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                flat[port_name(path)] = np.asarray(v)
    walk(params, "")
    return flat


def _assert_state_equal(state, want):
    assert sorted(state) == sorted(want)
    for name, w in want.items():
        t = state[name]
        if t.dtype == torch.bfloat16:
            t = t.float()
            w = w.astype(np.float32)
        np.testing.assert_array_equal(t.numpy(), w, err_msg=name)


def _logits(cfg, state, ids):
    model = Qwen3(cfg, device="cpu")
    model.load_state(state)
    with torch.no_grad():
        return model(torch.from_numpy(ids)).numpy()


def test_port_loader_matches_goldens_and_the_jax_loader():
    cfg, state = _port_load(FIXTURE)
    ids = np.load(os.path.join(FIXTURE, "golden_input.npy"))
    want = np.load(os.path.join(FIXTURE, "golden_logits.npy"))
    np.testing.assert_allclose(_logits(cfg, state, ids), want, rtol=1e-4,
                               atol=1e-4)
    _assert_state_equal(state, _jax_state(FIXTURE))
    assert hf_loader.map_hf_name("model.layers.1.mlp.up_proj.weight") == \
        jax_hf.map_hf_name("model.layers.1.mlp.up_proj.weight")
    assert hf_loader.map_hf_name("model.rotary_emb.inv_freq") is None
    with pytest.raises(FileNotFoundError, match="config.json"):
        hf_loader.load_qwen3(os.path.dirname(FIXTURE), device="cpu")


def _copy_config(src, dst, **changes):
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(src, "config.json")) as f:
        hf = json.load(f)
    hf.update(changes)
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(hf, f)


def test_two_shards_with_an_index_load_the_same(tmp_path):
    _copy_config(FIXTURE, str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        _port_load(str(tmp_path))
    tensors = load_file(os.path.join(FIXTURE, "model.safetensors"))
    names = sorted(tensors)
    half = len(names) // 2
    shards = {"model-00001-of-00002.safetensors": names[:half],
              "model-00002-of-00002.safetensors": names[half:]}
    weight_map = {}
    for fname, part in shards.items():
        save_file({n: tensors[n] for n in part}, str(tmp_path / fname))
        weight_map.update({n: fname for n in part})
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    _, one = _port_load(FIXTURE)
    _, two = _port_load(str(tmp_path))
    assert sorted(two) == sorted(one)
    for name in one:
        assert torch.equal(two[name], one[name]), name


def test_bf16_copy_loads_as_the_jax_loader_does(tmp_path):
    import safetensors.torch

    tensors = safetensors.torch.load_file(
        os.path.join(FIXTURE, "model.safetensors"))
    safetensors.torch.save_file(
        {n: t.to(torch.bfloat16) for n, t in tensors.items()},
        str(tmp_path / "model.safetensors"))
    _copy_config(FIXTURE, str(tmp_path))
    cfg, state = _port_load(str(tmp_path), dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in state.values())
    _assert_state_equal(state, _jax_state(str(tmp_path), jnp.bfloat16))


def test_tied_config_skips_lm_head(tmp_path):
    os.symlink(os.path.join(FIXTURE, "model.safetensors"),
               tmp_path / "model.safetensors")
    _copy_config(FIXTURE, str(tmp_path), tie_word_embeddings=True)
    cfg, state = _port_load(str(tmp_path))
    assert cfg.tie_word_embeddings and "lm_head.kernel" not in state
    _assert_state_equal(state, _jax_state(str(tmp_path)))
    cfg2, _ = _port_load(str(tmp_path), scan_layers=True)
    assert cfg2.scan_layers and cfg2.replace(scan_layers=False) == cfg


def test_save_qwen3_reads_back_in_the_jax_loader(tmp_path):
    cfg, state = _port_load(FIXTURE)
    hf_loader.save_qwen3(state, cfg, str(tmp_path / "port"))
    _assert_state_equal(state, _jax_state(str(tmp_path / "port")))
    jmodel, jparams = jax_hf.load_qwen3(FIXTURE, dtype=jnp.float32,
                                        config_overrides=F32)
    jax_hf.save_qwen3(jparams, jmodel.cfg, str(tmp_path / "jax"))
    with open(tmp_path / "port" / "config.json") as f:
        port_cfg = json.load(f)
    with open(tmp_path / "jax" / "config.json") as f:
        assert json.load(f) == port_cfg
    # a stacked flax tree is unstacked first, as JAX's save_qwen3 does
    stacked = stack_layer_params(jparams, cfg.n_layer)
    hf_loader.save_qwen3(jax.tree.map(np.asarray, stacked), cfg,
                         str(tmp_path / "stacked"))
    _, back = _port_load(str(tmp_path / "stacked"))
    for name in state:
        assert torch.equal(back[name], state[name]), name


def _quantize(params, fmt):
    def pick(path, leaf):
        return path.endswith("kernel") and "lm_head" not in path

    if fmt == "int8":
        return jax_int8.quantize_tree(params, pick)
    return jax_nf4.quantize_tree(params, pick)


@pytest.mark.parametrize("form", ["dense", "int8", "nf4"])
def test_stacked_tree_serves_the_unrolled_logits(tmp_path, form):
    jmodel, jparams = jax_hf.load_qwen3(FIXTURE, dtype=jnp.float32,
                                        config_overrides=F32)
    cfg = Qwen3Config.from_dict(jmodel.cfg.to_dict())
    ids = torch.from_numpy(np.load(os.path.join(FIXTURE,
                                                "golden_input.npy")))

    def model_of(tree, scan):
        c = cfg.replace(scan_layers=scan)
        if form == "dense":
            base = Qwen3(c, device="cpu")
            base.load_state(params_from_jax(tree, c))
            return base
        return QuantizedModel(Qwen3(c, device="meta"),
                              params_from_jax(tree, c), device="cpu")

    if form == "dense":
        unrolled = jax.tree.map(np.asarray, jparams)
        path = jax_ckpt.save_named(
            str(tmp_path), stack_layer_params(jparams, cfg.n_layer), "model",
            metadata={"config": jmodel.cfg.replace(
                scan_layers=True).to_dict()})
        stacked, meta = restore_checkpoint(path)
        assert "blocks" in stacked and meta["config"]["scan_layers"]
    else:
        qtree = _quantize(jparams, form)
        jax_quant_io.save_packed(str(tmp_path / "flat"), qtree)
        jax_quant_io.save_packed(
            str(tmp_path / "stacked"),
            stack_layer_params(qtree, cfg.n_layer))
        unrolled = load_packed(str(tmp_path / "flat"))[0]
        stacked = load_packed(str(tmp_path / "stacked"))[0]
        assert "blocks" in stacked
    with torch.no_grad():
        want = model_of(unrolled, False)(ids)
        for scan in (False, True):
            assert torch.equal(model_of(stacked, scan)(ids), want)


def test_unstack_slices_every_component():
    from llm_in_practise_tpu_torch.quant import int8, nf4

    w = torch.randn(3, 64, 8)
    flat = {"blocks/block/mlp/w/kernel": w,
            "blocks/block/mlp/q/kernel": int8.quantize(w),
            "ln_f/scale": torch.ones(8)}
    out = unstack_layer_params(flat, 3)
    assert sorted(out) == sorted(
        ["ln_f/scale"] + [f"block_{i}/mlp/{n}/kernel" for i in range(3)
                          for n in ("w", "q")])
    for i in range(3):
        q = out[f"block_{i}/mlp/q/kernel"]
        assert q.shape == (64, 8) and torch.equal(q.q, int8.quantize(w[i]).q)
        assert torch.equal(out[f"block_{i}/mlp/w/kernel"], w[i])
    # NF4 quantized over the stacked axis has no per-layer blocks
    with pytest.raises(ValueError, match="layer boundaries"):
        unstack_layer_params({"blocks/block/k": nf4.quantize(w)}, 3)


def test_save_packed_writes_the_jax_export(tmp_path):
    """The port's writer gives the JAX writer's manifest and arrays for
    NF4, int8, int4 and AWQ leaves and plain f32 / bf16 arrays."""
    from llm_in_practise_tpu.quant import int4 as jax_int4
    from llm_in_practise_tpu.quant.awq import AWQTensor as JaxAWQ
    from llm_in_practise_tpu_torch.quant.io import save_packed

    rng = np.random.default_rng(5)
    w = rng.standard_normal((128, 64)).astype(np.float32)
    jtree = {
        "block_0": {"attn": {"q_proj": {"kernel": jax_nf4.quantize(w)},
                             "k_proj": {"kernel": jax_int8.quantize(w)},
                             "v_proj": {"kernel": jax_int4.rtn_quantize(
                                 w, group_size=32)},
                             "out_proj": {"kernel": JaxAWQ(
                                 jax_int4.rtn_quantize(w, group_size=32),
                                 jnp.asarray(rng.uniform(0.5, 2, 128)
                                             .astype(np.float32)))}},
                    "ln1": {"scale": jnp.ones(64)}},
        "tok_embed": {"embedding": jnp.asarray(w, jnp.bfloat16)}}
    meta = {"family": "qwen3", "method": "mixed"}
    jax_quant_io.save_packed(str(tmp_path / "jax"), jtree, metadata=meta)
    port_tree, _ = load_packed(str(tmp_path / "jax"))
    save_packed(str(tmp_path / "port"), port_tree, metadata=meta)
    with open(tmp_path / "jax" / "manifest.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "manifest.json") as f:
        assert json.load(f) == want
    a = np.load(tmp_path / "jax" / "packed.npz")
    b = np.load(tmp_path / "port" / "packed.npz")
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    # and JAX reads the port's export
    back, back_meta = jax_quant_io.load_packed(str(tmp_path / "port"))
    assert back_meta == meta
    np.testing.assert_array_equal(
        np.asarray(back["block_0"]["attn"]["q_proj"]["kernel"].packed),
        np.asarray(jtree["block_0"]["attn"]["q_proj"]["kernel"].packed))
