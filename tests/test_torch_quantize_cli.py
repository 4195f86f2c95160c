"""PyTorch port: ``python -m llm_in_practise_tpu_torch.quantize`` on the HF
fixture, read back by the JAX package.

The fixture (f32, f32 compute) is written by the port's ``save_named`` as
``model.msgpack``; a whitespace BPE of at most the fixture's 160 ids is
trained on the synthetic corpus. The CLI runs with ``--device cpu`` for
GPTQ, AWQ and int8. Then: JAX's ``quant_io.load_packed`` reads the
packed export (the example's metadata keys), JAX's ``restore_checkpoint``
reads ``model_{method}_{w4|w8}.msgpack`` (equal to the packed tree
dequantized to f32), and the PPLs the CLI prints equal JAX's
``compare_quantized`` of the fixture against the export's dequantized
tree on the same batches within 1e-4 relative. Without ``--model_path``
the CLI takes the example's hermetic branch: a GPT pretrained with the
Trainer (stubbed here to a tiny one; ``test_torch_gpt_serve.py`` runs
the real branch) is quantized and exported with ``family: "gpt"``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_in_practise_tpu.ckpt import checkpoint as jax_ckpt
from llm_in_practise_tpu.quant import io as jax_quant_io
from llm_in_practise_tpu.quant import ppl as jax_ppl
from llm_in_practise_tpu.quant.awq import AWQTensor as JaxAWQTensor
from llm_in_practise_tpu.quant.awq import dequantize_tree as jax_dequantize
from llm_in_practise_tpu.quant.int4 import Int4Tensor as JaxInt4Tensor
from llm_in_practise_tpu.quant.int8 import Int8Tensor as JaxInt8Tensor
from llm_in_practise_tpu_torch import quantize
from llm_in_practise_tpu_torch.ckpt.checkpoint import save_named
from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
from llm_in_practise_tpu_torch.data.lm_dataset import prepare_data
from llm_in_practise_tpu_torch.models.convert import params_to_jax

from torch_port_util import load_fixture_both

MAX_LEN = 48   # the fixture's max_position_embeddings is 64


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("quantize_cli")
    jmodel, jparams, pmodel = load_fixture_both()
    cfg = pmodel.cfg
    state = {n: p.detach() for n, p in pmodel.named_parameters()}
    model_path = save_named(str(root / "model"), params_to_jax(state, cfg),
                            "model", metadata={"config": cfg.to_dict()})
    lines = prepare_data("wikitext-2")
    tok = BPETokenizer.train(lines[:2000], vocab_size=160,
                             pre_tokenizer="whitespace", min_frequency=1)
    assert tok.get_vocab_size() <= cfg.vocab_size
    tok_path = str(root / "tok.json")
    tok.save(tok_path)
    japply = jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                               deterministic=True))
    seqs = quantize.eval_sequences(tok, lines, MAX_LEN)
    return root, model_path, tok_path, jparams, japply, seqs


@pytest.mark.parametrize("method", ["gptq", "awq", "int8"])
def test_quantize_cli_export_and_ppl_match_jax(inputs, method, capsys):
    root, model_path, tok_path, jparams, japply, seqs = inputs
    out_dir = str(root / method)
    res = quantize.run(["--method", method, "--model_path", model_path,
                        "--tokenizer_path", tok_path, "--max_len",
                        str(MAX_LEN), "--out_dir", out_dir,
                        "--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"fp PPL {res['fp_ppl']:.3f}" in printed
    assert f"PPL {res['quant_ppl']:.3f}" in printed
    assert res["calib_sequences"] == 16 and len(seqs) == 32

    tree, meta = jax_quant_io.load_packed(os.path.join(out_dir, "packed"))
    wtag = "w8" if method == "int8" else "w4"
    assert meta["family"] == "qwen3" and meta["method"] == method
    assert meta["group_size"] == (None if method == "int8" else 32)
    assert meta["ppl"] == res["quant_ppl"]
    deq = jax_dequantize(tree, jnp.float32)
    dense, dmeta = jax_ckpt.restore_checkpoint(
        os.path.join(out_dir, f"model_{method}_{wtag}.msgpack"))
    assert dmeta["method"] == method and dmeta["ppl"] == res["quant_ppl"]
    flat_d = jax.tree_util.tree_leaves_with_path(dense)
    flat_q = dict(jax.tree_util.tree_leaves_with_path(deq))
    assert len(flat_d) == len(flat_q) == 2 * 11 + 3
    for path, leaf in flat_d:
        np.testing.assert_array_equal(np.asarray(leaf),
                                      np.asarray(flat_q[path]))
    quant_types = (JaxInt4Tensor, JaxAWQTensor, JaxInt8Tensor)
    leaves = jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, quant_types))
    # the block kernels, not the head or the embedding
    assert sum(isinstance(x, quant_types) for x in leaves) == 14

    batches = jax_ppl.make_batches(seqs, batch_size=8, max_len=MAX_LEN)
    want = jax_ppl.compare_quantized(japply, jparams, deq, batches)
    for key in ("fp_ppl", "quant_ppl"):
        np.testing.assert_allclose(res[key], want[key], rtol=1e-4)
    assert res["passed"] == want["passed"]
    if method != "int8":
        assert sorted(res["stats"]) == sorted(
            f"block_{i}/{sub}/{name}/kernel" for i in range(2)
            for sub, names in (("attn", ("q_proj", "k_proj", "v_proj",
                                         "out_proj")),
                               ("mlp", ("gate_proj", "up_proj",
                                        "down_proj")))
            for name in names)
        assert len(res["matrix_s"]) == 14
    assert isinstance(res["q_state"]["lm_head.kernel"], torch.Tensor)


def test_quantize_cli_without_a_model_raises(tmp_path, monkeypatch):
    # no longer raises: without a model the hermetic GPT branch runs
    from llm_in_practise_tpu_torch.models.gpt import gptlike_config
    from llm_in_practise_tpu_torch.models.gpt import init_params

    def tiny(device):
        tok = BPETokenizer.train(prepare_data("wikitext-2")[:50],
                                 vocab_size=160, min_frequency=1)
        cfg = gptlike_config(tok.vocab_size, seq_len=64, n_layer=1,
                             embed_dim=64, n_head=2, dropout=0.0)
        return tok, cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                     device=device)

    monkeypatch.setattr(quantize, "pretrain_hermetic", tiny)
    assert quantize.main(["--method", "gptq", "--out_dir", str(tmp_path),
                          "--device", "cpu", "--n_calib", "4"]) == 0
    _, meta = jax_quant_io.load_packed(str(tmp_path / "packed"))
    assert meta["family"] == "gpt" and meta["config"]["n_layer"] == 1
    assert os.path.exists(tmp_path / "tokenizer.json")
    assert quantize.build_parser().get_default("group_size") == 32
    assert quantize.block_target("block_0/attn/q_proj/kernel")
    assert not quantize.block_target("lm_head/kernel")
    assert not quantize.block_target("tok_embed/embedding")
