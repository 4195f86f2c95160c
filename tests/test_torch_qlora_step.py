"""PyTorch port: one whole QLoRA training step against the JAX package.

A 2-layer Qwen3 at the NF4 test widths of ``tests/test_torch_qwen3.py``
(hidden 256, head_dim 128, 4/2 heads), tied embeddings, remat on every
block and ``attn_impl="flash"``, with numpy-seeded weights and LoRA
factors (r 8 on q_proj/v_proj; B is non-zero so every factor gets a
gradient). The JAX side is ``make_fused_qlora_loss_fn_args(...,
use_kernels=True)``: the Pallas NF4 forward/backward and flash kernels in
interpret mode. The port runs the same step through its own entry points
(``quantize_base``'s bytes carried by ``params_from_jax``, ``QLoRAModel``,
``make_fused_ce_loss``, ``make_train_step``) with the kernels' plain
versions.

Tolerances (ROADMAP.md C): every NF4 projection rounds its input to bf16,
so one-ulp f32 differences upstream become bf16 noise: the loss within
1e-3 relative, each LoRA gradient within 1e-2 of its largest entry.
After two AdamW steps the factors are compared by their updates: an
Adam step moves each entry by about ``lr * sign(g)``, so an entry whose
gradient is at the noise level may move the other way; the updates'
difference must stay under a tenth of the update's norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from torch_port_util import numpy_params

from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.models.qwen3 import qwen3_config as jax_qwen3_config
from llm_in_practise_tpu.peft import lora as jax_lora
from llm_in_practise_tpu.peft.fused import make_fused_qlora_loss_fn_args
from llm_in_practise_tpu.peft.qlora import quantize_base as jax_quantize_base
from llm_in_practise_tpu.train import optim as jax_optim
from llm_in_practise_tpu.train.losses import (
    fused_linear_cross_entropy as jax_fused_ce,
)
from llm_in_practise_tpu_torch.models.convert import (
    flax_path,
    lora_from_jax,
    params_from_jax,
)
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
from llm_in_practise_tpu_torch.peft.fused import QLoRALinear, QLoRAModel
from llm_in_practise_tpu_torch.peft.lora import LoRAConfig
from llm_in_practise_tpu_torch.train.optim import adamw
from llm_in_practise_tpu_torch.train.step import (
    create_train_state,
    make_fused_ce_loss,
    make_train_step,
)

CFG = dict(hidden_size=256, intermediate_size=512, n_head=4, n_kv_head=2,
           head_dim=128, n_layer=2, compute_dtype="float32", max_seq_len=128,
           tie_word_embeddings=True, remat=True, attn_impl="flash")
VOCAB, BATCH, LENGTH = 512, 2, 128
CHUNK = VOCAB_CHUNK = 128  # two token chunks, four vocab tiles
LR = 1e-3


def test_qlora_step_matches_jax():
    jmodel = JaxQwen3(jax_qwen3_config(VOCAB, **CFG))
    params = numpy_params(jmodel, seed=7)
    qparams = jax_quantize_base(params)
    rng = np.random.default_rng(3)
    jcfg = jax_lora.LoRAConfig(r=8, alpha=16.0)
    lora_np = {}
    for path in jax_lora.target_paths(params, jcfg):
        block, sub, name, _ = path.split("/")
        d_in, d_out = params[block][sub][name]["kernel"].shape
        lora_np[path] = {
            "a": rng.normal(0, 0.02, (d_in, 8)).astype(np.float32),
            "b": rng.normal(0, 0.02, (8, d_out)).astype(np.float32)}
    x = rng.integers(0, VOCAB, (BATCH, LENGTH))
    y = np.roll(x, -1, axis=1)

    def base_loss(apply_out, qp, batch, _rng):
        hidden = apply_out(batch[0], deterministic=True, return_hidden=True)
        return jax_fused_ce(hidden, qp["tok_embed"]["embedding"], batch[1],
                            transpose_weight=True, chunk=CHUNK,
                            vocab_chunk=VOCAB_CHUNK)[0]

    loss_fn = make_fused_qlora_loss_fn_args(
        jmodel, jcfg, base_loss, compute_dtype=jnp.float32, use_kernels=True)
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    jbatch = (jnp.asarray(x), jnp.asarray(y))
    lp = jax.tree.map(jnp.asarray, lora_np)
    want_loss, want_grads = value_and_grad(lp, qparams, jbatch, None)
    tx = jax_optim.adamw(LR)
    opt_state = tx.init(lp)
    for _ in range(2):
        _, grads = value_and_grad(lp, qparams, jbatch, None)
        updates, opt_state = tx.update(grads, opt_state, lp)
        lp = optax.apply_updates(lp, updates)

    cfg = Qwen3Config.from_dict(jmodel.cfg.to_dict())
    state = params_from_jax(jax.tree.map(np.asarray, qparams), cfg)
    model = QLoRAModel(Qwen3(cfg, device="meta"), state,
                       lora_from_jax(lora_np, cfg), LoRAConfig(r=8, alpha=16.0),
                       compute_dtype=torch.float32, device="cpu")
    assert sum(isinstance(m, QLoRALinear) for m in model.modules()) == 14
    trainable = [p for p in model.parameters() if p.requires_grad]
    assert len(trainable) == 8  # the LoRA factors and nothing else
    loss_of = make_fused_ce_loss(chunk=CHUNK, vocab_chunk=VOCAB_CHUNK)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    factors = model.lora_state()
    keys = [(n, k) for n in sorted(factors) for k in ("a", "b")]
    loss, aux = loss_of(model, batch)
    grads = torch.autograd.grad(loss, [factors[n][k] for n, k in keys])
    assert int(aux["n_valid"]) == BATCH * LENGTH
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-3)
    for (name, k), got in zip(keys, grads):
        want = np.asarray(want_grads[flax_path(name)][k])
        assert np.max(np.abs(got.numpy() - want)) <= 1e-2 * np.max(
            np.abs(want)), (name, k)

    train_state = create_train_state(model, adamw(LR))
    step = make_train_step(loss_fn=loss_of)
    for _ in range(2):
        train_state, metrics = step(train_state, batch)
        assert np.isfinite(float(metrics["loss"]))
        assert float(metrics["grad_norm"]) > 0
    for name, k in keys:
        start = lora_np[flax_path(name)][k]
        d_port = factors[name][k].detach().numpy() - start
        d_jax = np.asarray(lp[flax_path(name)][k]) - start
        assert np.linalg.norm(d_port - d_jax) <= 0.1 * np.linalg.norm(
            d_jax), (name, k)
