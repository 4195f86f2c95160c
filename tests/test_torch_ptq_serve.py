"""PyTorch port: serving PTQ exports written by the JAX package.

A 2-layer Qwen3 (hidden 256, intermediate 512, head_dim 64, 4/2 heads:
widths at which every int4 projection gets a plan from JAX's ``_plan``, so
JAX runs its Pallas kernels in interpret mode and not its dequant
fallback, asserted) with numpy-seeded weights, quantized by the JAX
package into four exports and written with its ``save_packed``:

- ``int4``: RTN, symmetric, group size 128 (GPTQModel's storage);
- ``awq``: the int4 codes of ``W * s``, asymmetric, group size 32, with a
  random per-input-channel ``s`` and ``inv_scale = 1 / s``;
- ``int8``: per-channel symmetric (``quant/int8.py::quantize_tree``);
- ``mixed``: the ``"mixed"`` preset, int8 MLP and NF4 attention
  (``peft/qlora.py::quantize_base_lowmem(fmt="mixed")``).

The port reads each with its own ``load_packed`` (byte for byte) and
serves it through ``QuantizedModel``; the logits are held against JAX's
``QuantizedModel`` (``fused_quant_apply``) at f32 compute, at
``1e-2 * max|ref|``, the NF4 whole-model limit. For int4 and AWQ both
sides round the same bf16 operands, and the limit covers what ROADMAP.md
C explains: one-ulp f32 differences upstream become bf16 noise (readings
1e-6 to 1.4e-3 over weight seeds 7-9). JAX serves int8 leaves through XLA
with the f32 input unrounded, while the port runs the int8 kernel, which
rounds x to bf16 (ROADMAP.md C): 2^-9 relative on every projection input,
read as 2.2e-3 to 2.8e-3 for int8 and mixed over the same seeds, so the
same 1e-2 is a bf16 tolerance with about 4x room. A wrong nibble, group or
scale moves the logits by O(1).

The CLI's build path serves one chat request over HTTP from the int4
export on the CPU.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import numpy_params

from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.models.qwen3 import qwen3_config as jax_qwen3_config
from llm_in_practise_tpu.ops.int4_matmul import _plan as int4_plan
from llm_in_practise_tpu.peft.qlora import quantize_base_lowmem
from llm_in_practise_tpu.quant import int4 as jax_int4
from llm_in_practise_tpu.quant import int8 as jax_int8
from llm_in_practise_tpu.quant import io as jax_quant_io
from llm_in_practise_tpu.quant.awq import AWQTensor as JaxAWQ
from llm_in_practise_tpu.serve.quantized import QuantizedModel as JaxQuantized
from llm_in_practise_tpu.utils.tree import path_str
from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
from llm_in_practise_tpu_torch.data.sft import IM_END, IM_START
from llm_in_practise_tpu_torch.models.convert import flatten, params_from_jax
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
from llm_in_practise_tpu_torch.quant.awq import AWQTensor
from llm_in_practise_tpu_torch.quant.int4 import Int4Tensor
from llm_in_practise_tpu_torch.quant.int8 import Int8Tensor
from llm_in_practise_tpu_torch.quant.io import load_packed
from llm_in_practise_tpu_torch.quant.nf4 import NF4Tensor
from llm_in_practise_tpu_torch.serve.__main__ import build_parser, build_server
from llm_in_practise_tpu_torch.serve.quantized import (
    QuantizedLinear,
    QuantizedModel,
)

VOCAB = 512
PTQ_CFG = dict(hidden_size=256, intermediate_size=512, n_head=4,
               n_kv_head=2, head_dim=64, n_layer=2, compute_dtype="float32",
               max_seq_len=64)
MODEL_TOL = 1e-2  # see the module docstring
FORMATS = ("int4", "awq", "int8", "mixed")


def _is_block_kernel(path: str) -> bool:
    return path.startswith("block_") and path.endswith("kernel")


def ptq_tree(params, fmt: str, seed: int = 0):
    """The JAX package's export of ``params`` in format ``fmt``."""
    rng = np.random.default_rng(seed)

    def int4_leaf(path, w):
        if not _is_block_kernel(path_str(path)):
            return w
        if fmt == "int4":
            return jax_int4.rtn_quantize(jnp.asarray(w), group_size=128)
        s = rng.uniform(0.5, 2.0, w.shape[0]).astype(np.float32)
        q = jax_int4.rtn_quantize(jnp.asarray(w * s[:, None]), group_size=32,
                                  sym=False)
        return JaxAWQ(q, jnp.asarray(1.0 / s))

    if fmt in ("int4", "awq"):
        return jax.tree_util.tree_map_with_path(int4_leaf, params)
    if fmt == "int8":
        return jax_int8.quantize_tree(
            params, lambda p, leaf: _is_block_kernel(p))
    return quantize_base_lowmem(params, fmt="mixed", cast_rest_above=None)


def assert_leaf_bytes_equal(got, want):
    """A port leaf from ``load_packed`` against the JAX leaf it came from."""
    fields = {Int4Tensor: ("packed", "scales", "zeros"),
              Int8Tensor: ("q", "scale"),
              NF4Tensor: ("packed", "absmax_q", "absmax_scale",
                          "absmax_offset")}
    if isinstance(got, AWQTensor):
        np.testing.assert_array_equal(got.inv_scale.numpy(),
                                      np.asarray(want.inv_scale))
        got, want = got.q, want.q
    if isinstance(got, torch.Tensor):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    assert tuple(got.shape) == tuple(want.shape)
    if isinstance(got, Int4Tensor):
        assert got.group_size == want.group_size
    for f in fields[type(got)]:
        np.testing.assert_array_equal(
            getattr(got, f).numpy().reshape(-1),
            np.asarray(getattr(want, f)).reshape(-1))


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    jmodel = JaxQwen3(jax_qwen3_config(VOCAB, **PTQ_CFG))
    params = numpy_params(jmodel, seed=7)
    out = {}
    for fmt in FORMATS:
        qtree = ptq_tree(params, fmt)
        path = str(tmp_path_factory.mktemp(fmt))
        jax_quant_io.save_packed(path, qtree, metadata={
            "config": jmodel.cfg.to_dict(), "family": "qwen3",
            "method": fmt})
        out[fmt] = (qtree, path)
    return jmodel, out


@pytest.mark.parametrize("fmt", FORMATS)
def test_export_reads_back_byte_for_byte(exports, fmt):
    _, trees = exports
    qtree, path = trees[fmt]
    tree, meta = load_packed(path)
    assert meta["method"] == fmt
    want = jax.tree_util.tree_leaves_with_path(
        qtree, is_leaf=lambda v: isinstance(v, JaxAWQ) or (
            hasattr(v, "packed") or hasattr(v, "q")))
    got = flatten(tree)
    assert set(got) == {path_str(p) for p, _ in want}
    for p, leaf in want:
        assert_leaf_bytes_equal(got[path_str(p)], leaf)
    if fmt in ("int4", "awq"):  # every int4 projection runs JAX's kernel
        for p, leaf in want:
            q = leaf.q if isinstance(leaf, JaxAWQ) else leaf
            if hasattr(q, "group_size"):
                assert int4_plan(q, 8) is not None, path_str(p)


def _port_model(jmodel, path):
    tree, _ = load_packed(path)
    cfg = Qwen3Config.from_dict(jmodel.cfg.to_dict())
    return QuantizedModel(Qwen3(cfg, device="meta"),
                          params_from_jax(tree, cfg),
                          compute_dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("fmt", FORMATS)
def test_served_logits_match_jax(exports, fmt):
    jmodel, trees = exports
    qtree, path = trees[fmt]
    pq = _port_model(jmodel, path)
    linears = [m for m in pq.modules() if isinstance(m, QuantizedLinear)]
    assert len(linears) == 7 * PTQ_CFG["n_layer"]
    if fmt == "mixed":
        kinds = {n.split(".")[2]: type(m.weight) for n, m in
                 pq.model.named_modules() if isinstance(m, QuantizedLinear)}
        assert kinds == {"attn": NF4Tensor, "mlp": Int8Tensor}
    ids = np.random.default_rng(1).integers(0, VOCAB, (2, 6))
    jq = JaxQuantized(jmodel, compute_dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda q, x: jq.apply({"params": q}, x))(
        qtree, jnp.asarray(ids)))
    with torch.inference_mode():
        got = pq(torch.from_numpy(ids)).numpy()
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= MODEL_TOL, err


def test_cli_serves_a_chat_request_from_the_int4_export(exports, tmp_path):
    _, trees = exports
    _, path = trees["int4"]
    tok = BPETokenizer.train(["The quick brown fox jumps over the lazy dog. "
                              "Hello there, how are you? "] * 4,
                             vocab_size=300, special_tokens=[IM_START, IM_END],
                             min_frequency=1)
    tok_path = str(tmp_path / "tok.json")
    tok.save(tok_path)
    server = build_server(build_parser().parse_args(
        ["--quantized_dir", path, "--tokenizer_path", tok_path,
         "--device", "cpu", "--max_slots", "2", "--cache_len", "64"]))
    linears = [m for m in server.engine.model.modules()
               if isinstance(m, QuantizedLinear)]
    assert len(linears) == 14
    assert all(isinstance(m.weight, Int4Tensor) for m in linears)
    port = server.serve(host="127.0.0.1", port=0, background=True)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/chat/completions",
            data=json.dumps({"model": "qwen3-h100", "max_tokens": 8,
                             "temperature": 0.0, "messages": [
                                 {"role": "user", "content": "Hello there"}]
                             }).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
    finally:
        server.shutdown()
    assert out["choices"][0]["finish_reason"] in ("stop", "length")
    assert 1 <= out["usage"]["completion_tokens"] <= 8
