"""PyTorch port: Qwen3 forward against the HF goldens and the JAX model.

The committed fixture (``tests/fixtures/qwen3_tiny``) is loaded with the
JAX package's HF loader in f32 and carried into the port byte for byte
(``models/convert.py``). Tolerances: 1e-4 against the torch-transformers
goldens (two independent f32 implementations, as in
``tests/test_qwen3_golden.py``), 1e-5 against the JAX model on the same
weights (same f32 arithmetic, summation order differs).

The NF4 model compares the port's quantized forward (plain version of the
CUDA kernel on the CPU) with the JAX ``QuantizedModel`` (Pallas kernel in
interpret mode). One kernel call agrees at ``1e-3 * max|ref|``
(``tests/test_torch_nf4.py``): both use bf16 operands with f32 sums. A
whole model cannot be held that tight: every kernel rounds its input to
bf16, so a one-ulp f32 difference upstream (RMSNorm's mean, the attention
softmax: summation order) can flip one bf16 rounding, and from then on
the residual stream differs by bf16 rounding noise (2**-8 relative), which
is above 1e-3. Measured here at two layers: 1.6e-3 * max|ref| for the
seed below, and 0.5e-3 to 1.6e-3 over weight seeds 7 to 9. The model
bound is therefore a few bf16 ulps, ``NF4_MODEL_TOL = 1e-2``; a wrong
codebook entry, nibble order or absmax block moves logits by O(1).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import FIXTURE, load_fixture_both, numpy_params

from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.models.qwen3 import qwen3_config as jax_qwen3_config
from llm_in_practise_tpu.ops.nf4_matmul import _plan
from llm_in_practise_tpu.quant import nf4 as jax_nf4
from llm_in_practise_tpu.serve.quantized import QuantizedModel as JaxQuantized
from llm_in_practise_tpu_torch.models.convert import params_from_jax
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
from llm_in_practise_tpu_torch.serve.quantized import NF4Linear, QuantizedModel


@pytest.fixture(scope="module")
def both():
    return load_fixture_both()


def _jax_cache(jmodel, batch, length, index):
    cache = jmodel.init_cache(batch, length, dtype=jnp.float32)
    for layer in cache:
        layer["index"] = jnp.asarray(index, jnp.int32)
    return cache


def test_logits_match_goldens_and_jax(both):
    jmodel, jparams, pmodel = both
    ids = np.load(os.path.join(FIXTURE, "golden_input.npy"))
    golden = np.load(os.path.join(FIXTURE, "golden_logits.npy"))
    with torch.inference_mode():
        got = pmodel(torch.from_numpy(ids.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, golden, rtol=1e-4, atol=1e-4)
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cached_prefill_and_per_slot_decode_match_jax(both):
    jmodel, jparams, pmodel = both
    rng = np.random.default_rng(0)
    vocab = jmodel.cfg.vocab_size
    prompt = rng.integers(0, vocab, (2, 5))
    steps = rng.integers(0, vocab, (3, 2, 1))
    jcache = _jax_cache(jmodel, 2, 16, [0, 0])
    pcache = pmodel.init_cache(2, 16, dtype=torch.float32)
    for layer in pcache:
        layer["index"] = torch.zeros(2, dtype=torch.long)
    japply = jax.jit(lambda p, x, c: jmodel.apply({"params": p}, x, cache=c))
    with torch.inference_mode():
        jl, jcache = japply(jparams, jnp.asarray(prompt), jcache)
        pl_, pcache = pmodel(torch.from_numpy(prompt), cache=pcache)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        # slots at different depths: slot 1 rewinds to position 3
        for layer in jcache:
            layer["index"] = jnp.asarray([5, 3], jnp.int32)
        for layer in pcache:
            layer["index"] = torch.tensor([5, 3])
        for tok in steps:
            jl, jcache = japply(jparams, jnp.asarray(tok), jcache)
            pl_, pcache = pmodel(torch.from_numpy(tok), cache=pcache)
            np.testing.assert_allclose(pl_.numpy(), np.asarray(jl),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(pcache[0]["index"].numpy(),
                                          np.asarray(jcache[0]["index"]))


def test_config_round_trips_from_hf_and_dict():
    import json

    with open(os.path.join(FIXTURE, "config.json")) as f:
        hf = json.load(f)
    from llm_in_practise_tpu.models.qwen3 import Qwen3Config as JaxConfig

    want = JaxConfig.from_hf_config(hf, compute_dtype="float32").to_dict()
    got = Qwen3Config.from_hf_config(hf, compute_dtype="float32")
    assert got.to_dict() == want
    assert Qwen3Config.from_dict(want) == got


def test_unported_layouts_raise():
    cfg = Qwen3Config.from_dict(
        jax_qwen3_config(64, n_layer=1).to_dict())
    with pytest.raises(NotImplementedError, match="scan_layers"):
        Qwen3(cfg.replace(scan_layers=True), device="cpu")
    with pytest.raises(NotImplementedError, match="flash"):
        Qwen3(cfg.replace(attn_impl="flash"), device="cpu")


# ---------------------------------------------------------------- NF4 model

NF4_MODEL_TOL = 1e-2  # see the module docstring

NF4_CFG = dict(hidden_size=256, intermediate_size=512, n_head=4, n_kv_head=2,
               head_dim=128, n_layer=2, compute_dtype="float32",
               max_seq_len=64)


@pytest.fixture(scope="module")
def nf4_pair():
    jmodel = JaxQwen3(jax_qwen3_config(512, **NF4_CFG))
    params = numpy_params(jmodel, seed=7)
    qtree = jax_nf4.quantize_tree(
        params, lambda p, leaf: p.startswith("block_") and p.endswith("kernel"))
    blocks = [leaf for leaf in jax.tree.leaves(
        qtree, is_leaf=lambda x: isinstance(x, jax_nf4.NF4Tensor))
        if isinstance(leaf, jax_nf4.NF4Tensor)]
    assert len(blocks) == 7 * NF4_CFG["n_layer"]
    for t in blocks:  # every projection runs the Pallas kernel in JAX
        assert t.layout == "kblock" and _plan(t, None, 8) is not None
    jq = JaxQuantized(jmodel, compute_dtype=jnp.float32)
    cfg = Qwen3Config.from_dict(jmodel.cfg.to_dict())
    state = params_from_jax(jax.tree.map(np.asarray, qtree), cfg)
    pq = QuantizedModel(Qwen3(cfg, device="meta"), state,
                        compute_dtype=torch.float32, device="cpu")
    return jq, qtree, pq


def test_quantized_model_matches_jax(nf4_pair):
    jq, qtree, pq = nf4_pair
    n_nf4 = sum(isinstance(m, NF4Linear) for m in pq.modules())
    assert n_nf4 == 7 * NF4_CFG["n_layer"]
    ids = np.random.default_rng(1).integers(0, 512, (2, 6))
    want = np.asarray(jax.jit(lambda q, x: jq.apply({"params": q}, x))(
        qtree, jnp.asarray(ids)))
    with torch.inference_mode():
        got = pq(torch.from_numpy(ids)).numpy()
    assert np.max(np.abs(got - want)) <= NF4_MODEL_TOL * np.max(np.abs(want))


def test_quantized_model_cached_matches_jax(nf4_pair):
    jq, qtree, pq = nf4_pair
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 512, (2, 4))
    tok = rng.integers(0, 512, (2, 1))
    jcache = jq.init_cache(2, 8, dtype=jnp.float32)
    for layer in jcache:
        layer["index"] = jnp.zeros((2,), jnp.int32)
    pcache = pq.init_cache(2, 8, dtype=torch.float32)
    japply = jax.jit(lambda q, x, c: jq.apply({"params": q}, x, cache=c))
    with torch.inference_mode():
        for ids in (prompt, tok):
            jl, jcache = japply(qtree, jnp.asarray(ids), jcache)
            pl_, pcache = pq(torch.from_numpy(ids), cache=pcache)
            want = np.asarray(jl)
            assert (np.max(np.abs(pl_.numpy() - want))
                    <= NF4_MODEL_TOL * np.max(np.abs(want)))


def test_unconsumed_quantized_leaf_raises(nf4_pair):
    _, qtree, _ = nf4_pair
    cfg = Qwen3Config.from_dict(
        jax_qwen3_config(512, **NF4_CFG).to_dict())
    state = params_from_jax(jax.tree.map(np.asarray, qtree), cfg)
    # a quantized leaf where no Dense kernel lives
    from llm_in_practise_tpu_torch.quant import nf4 as port_nf4

    state["ln_f.scale"] = port_nf4.quantize(np.ones((64, 4), np.float32))
    with pytest.raises(ValueError, match="not served"):
        QuantizedModel(Qwen3(cfg, device="meta"), state, device="cpu")
