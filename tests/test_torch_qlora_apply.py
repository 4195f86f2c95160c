"""PyTorch port: the materialized-dequant QLoRA path and the mixed
quantizer against JAX's.

A tiny Qwen3 in f32 with numpy-seeded weights, its kernels NF4-quantized
by JAX's ``quantize_base`` and carried across byte for byte, LoRA r 8 on
q/v with numpy-seeded A and B (B non-zero, so every factor has a
gradient).

- ``qlora_apply``, ``make_qlora_loss_fn`` and ``make_qlora_loss_fn_args``
  (dequantized in f32, next-token cross-entropy over the full logits):
  the loss and every LoRA gradient equal JAX's ``jax.value_and_grad``
  within 1e-4 relative (of the largest entry, for a gradient); the NF4
  leaves get no gradient.
- The same loss and gradients against the port's fused ``QLoRAModel``
  (the NF4 kernels' plain versions, which round x to bf16): within
  ``tests/test_torch_qlora_step.py``'s tolerances, 1e-3 relative for the
  loss and 1e-2 of the largest entry for each gradient.
- ``quantize_base(fmt="mixed")`` and a callable ``fmt``: the same leaves
  int8 and NF4 as JAX's ``quantize_base_lowmem`` (``cast_rest_above=None``:
  the port casts no unquantized leaf), with byte-equal codes (NF4 nibbles
  and absmax codes, int8 values); the f32 scales within a few ulps
  (1e-6 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.models.qwen3 import qwen3_config as jax_qwen3_config
from llm_in_practise_tpu.peft import lora as jax_lora
from llm_in_practise_tpu.peft import qlora as jax_qlora
from llm_in_practise_tpu.train.losses import cross_entropy as jax_ce
from llm_in_practise_tpu_torch.models.convert import (
    flax_path,
    lora_from_jax,
    params_from_jax,
)
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
from llm_in_practise_tpu_torch.peft import qlora
from llm_in_practise_tpu_torch.peft.fused import QLoRAModel
from llm_in_practise_tpu_torch.peft.lora import LoRAConfig
from llm_in_practise_tpu_torch.quant.int8 import Int8Tensor
from llm_in_practise_tpu_torch.quant.nf4 import NF4Tensor
from llm_in_practise_tpu_torch.train.losses import cross_entropy
from llm_in_practise_tpu_torch.train.step import default_loss

from torch_port_util import numpy_params

CFG = dict(hidden_size=128, intermediate_size=256, n_layer=2, n_head=4,
           n_kv_head=2, head_dim=32, max_seq_len=64, compute_dtype="float32")
VOCAB = 96


@pytest.fixture(scope="module")
def setup():
    jmodel = JaxQwen3(jax_qwen3_config(VOCAB, **CFG))
    params = numpy_params(jmodel, seed=11)
    qparams = jax_qlora.quantize_base(params)
    rng = np.random.default_rng(12)
    jcfg = jax_lora.LoRAConfig(r=8, alpha=16.0)
    lora_np = {}
    for path in jax_lora.target_paths(params, jcfg):
        block, sub, name, _ = path.split("/")
        d_in, d_out = params[block][sub][name]["kernel"].shape
        lora_np[path] = {
            "a": rng.normal(0, 0.05, (d_in, 8)).astype(np.float32),
            "b": rng.normal(0, 0.05, (8, d_out)).astype(np.float32)}
    x = rng.integers(0, VOCAB, (2, 20))
    y = np.roll(x, -1, axis=1)
    cfg = Qwen3Config.from_dict(jmodel.cfg.to_dict())
    qstate = params_from_jax(jax.tree.map(np.asarray, qparams), cfg)
    return jmodel, params, qparams, jcfg, lora_np, x, y, cfg, qstate


def _jax_base_loss(jmodel):
    def base_loss(p, batch, _rng):
        logits = jmodel.apply({"params": p}, batch[0], deterministic=True)
        return jax_ce(logits, batch[1])[0]
    return base_loss


def _port_lora(lora_np, cfg):
    lora = lora_from_jax(lora_np, cfg)
    for ab in lora.values():
        for t in ab.values():
            t.requires_grad_(True)
    keys = [(n, k) for n in sorted(lora) for k in ("a", "b")]
    return lora, keys, [lora[n][k] for n, k in keys]


def _assert_grads(keys, grads, want_grads, tol):
    for (name, k), got in zip(keys, grads):
        want = np.asarray(want_grads[flax_path(name)][k])
        assert np.max(np.abs(got.detach().numpy() - want)) <= tol * np.max(
            np.abs(want)), (name, k)


@pytest.mark.parametrize("form", ["closure", "args"])
def test_qlora_loss_and_grads_match_jax(setup, form):
    jmodel, _, qparams, jcfg, lora_np, x, y, cfg, qstate = setup
    jbatch = (jnp.asarray(x), jnp.asarray(y))
    lp = jax.tree.map(jnp.asarray, lora_np)
    model = Qwen3(cfg, device="meta")
    lcfg = LoRAConfig(r=8, alpha=16.0)
    lora, keys, leaves = _port_lora(lora_np, cfg)
    batch = (torch.from_numpy(x), torch.from_numpy(y))

    def base_loss(state, batch, _generator):
        return cross_entropy(model.apply(state, batch[0]), batch[1])[0]

    if form == "closure":
        jfn = jax_qlora.make_qlora_loss_fn(qparams, jcfg,
                                           _jax_base_loss(jmodel),
                                           dtype=jnp.float32)
        want_loss, want_grads = jax.jit(jax.value_and_grad(jfn))(
            lp, jbatch, None)
        fn = qlora.make_qlora_loss_fn(qstate, lcfg, base_loss,
                                      dtype=torch.float32)
        loss = fn(lora, batch, None)
    else:
        jfn = jax_qlora.make_qlora_loss_fn_args(jcfg, _jax_base_loss(jmodel),
                                                dtype=jnp.float32)
        want_loss, want_grads = jax.jit(jax.value_and_grad(jfn))(
            lp, qparams, jbatch, None)
        fn = qlora.make_qlora_loss_fn_args(lcfg, base_loss,
                                           dtype=torch.float32)
        loss = fn(lora, qstate, batch, None)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    _assert_grads(keys, grads, want_grads, 1e-4)


def test_qlora_apply_matches_jax_and_the_fused_model(setup):
    jmodel, _, qparams, jcfg, lora_np, x, y, cfg, qstate = setup
    lcfg = LoRAConfig(r=8, alpha=16.0)
    lora, keys, leaves = _port_lora(lora_np, cfg)
    eff = qlora.qlora_apply(qstate, lora, lcfg, dtype=torch.float32)
    want = jax_qlora.qlora_apply(qparams, jax.tree.map(jnp.asarray, lora_np),
                                 jcfg, dtype=jnp.float32)
    want = params_from_jax(jax.tree.map(np.asarray, want), cfg)
    assert sorted(eff) == sorted(want)
    for name, t in eff.items():
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        np.testing.assert_allclose(t.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6)
    assert eff["blocks.0.attn.q_proj.kernel"].requires_grad
    assert not eff["blocks.0.attn.k_proj.kernel"].requires_grad

    model = Qwen3(cfg, device="meta")
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    loss = cross_entropy(model.apply(eff, batch[0]), batch[1])[0]
    grads = torch.autograd.grad(loss, leaves)
    fused = QLoRAModel(Qwen3(cfg, device="meta"), qstate, lora_from_jax(
        lora_np, cfg), lcfg, compute_dtype=torch.float32, device="cpu")
    f_loss, _ = default_loss(fused, batch)
    factors = fused.lora_state()
    f_grads = torch.autograd.grad(f_loss, [factors[n][k] for n, k in keys])
    np.testing.assert_allclose(loss.item(), f_loss.item(), rtol=1e-3)
    for got, ref in zip(grads, f_grads):
        assert (got - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.parametrize("fmt", ["mixed", "callable"])
def test_mixed_and_callable_formats_match_jax_lowmem(setup, fmt):
    _, params, _, _, _, _, _, cfg, _ = setup
    state = params_from_jax(params, cfg)

    def pick(path):  # a flax path in JAX, a port name in the port
        return "int8" if ("down_proj" in path or "q_proj" in path) else "nf4"

    want = jax_qlora.quantize_base_lowmem(
        params, fmt=pick if fmt == "callable" else "mixed",
        cast_rest_above=None)
    want = params_from_jax(jax.tree.map(np.asarray, want), cfg)
    got = qlora.quantize_base(state,
                              fmt=pick if fmt == "callable" else "mixed")
    assert sorted(got) == sorted(want)
    kinds = {}
    for name, leaf in got.items():
        ref = want[name]
        assert type(leaf) is type(ref), name
        kinds[type(leaf).__name__] = kinds.get(type(leaf).__name__, 0) + 1
        if isinstance(leaf, NF4Tensor):
            for f in ("packed", "absmax_q"):
                assert torch.equal(getattr(leaf, f), getattr(ref, f)), name
            # the double-quant constants: a few f32 ulps (JAX jits its
            # per-leaf quantizer, and XLA reorders the reductions)
            for f in ("absmax_scale", "absmax_offset"):
                np.testing.assert_allclose(getattr(leaf, f).numpy(),
                                           getattr(ref, f).numpy(),
                                           rtol=1e-6, atol=0)
        elif isinstance(leaf, Int8Tensor):
            assert torch.equal(leaf.q, ref.q), name
            np.testing.assert_allclose(leaf.scale.numpy(), ref.scale.numpy(),
                                       rtol=2**-23, atol=0)
        else:
            assert torch.equal(leaf, ref) and leaf.dtype == torch.float32
    if fmt == "mixed":
        assert kinds == {"Int8Tensor": 6, "NF4Tensor": 8, "Tensor": 11}
        assert qlora.mixed_serve_fmt("blocks.1.mlp.up_proj.kernel") == "int8"
        assert qlora.mixed_serve_fmt("blocks.1.attn.q_proj.kernel") == "nf4"
    else:
        assert kinds == {"Int8Tensor": 4, "NF4Tensor": 10, "Tensor": 11}
    with pytest.raises(ValueError, match="fmt must be one of"):
        qlora.quantize_base(state, fmt=lambda n: "int4")
