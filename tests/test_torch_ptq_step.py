"""PyTorch port: QLoRA over PTQ bases, against JAX.

The 2-layer model and exports of ``tests/test_torch_ptq_serve.py``. One
QLoRA step (loss and LoRA gradients) over an int4 base and over an int8
base, against JAX's ``make_fused_qlora_loss_fn_args(...,
use_kernels=True)`` with numpy-seeded factors (r 8 on q_proj/v_proj, B
non-zero so every factor has a gradient). The port's backward runs the dx
kernels' plain versions (``Int4Matmul``, ``Int8Matmul``). Over int4 both
sides round the same bf16 operands (readings: loss 2.5e-5 relative,
gradients 2.3e-3 of max|ref|). Over int8 JAX runs XLA on unrounded f32
inputs and dy, while the port's kernels round x and ``dy * scale`` to
bf16 (ROADMAP.md C): loss 3.0e-6, gradients 5.6e-3. Both are held to the
NF4 step's limits (``tests/test_torch_qlora_step.py``): the loss within
1e-3 relative and each LoRA gradient within 1e-2 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ptq_serve import PTQ_CFG, VOCAB, ptq_tree
from torch_port_util import numpy_params

from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.models.qwen3 import qwen3_config as jax_qwen3_config
from llm_in_practise_tpu.peft import lora as jax_lora
from llm_in_practise_tpu.peft.fused import make_fused_qlora_loss_fn_args
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
from llm_in_practise_tpu_torch.train.step import make_fused_ce_loss

BATCH, LENGTH = 2, 32
CHUNK = VOCAB_CHUNK = 128  # four vocab tiles
LOSS_TOL, GRAD_TOL = 1e-3, 1e-2


def carried(jmodel, qtree):
    cfg = Qwen3Config.from_dict(jmodel.cfg.to_dict())
    return cfg, params_from_jax(jax.tree.map(np.asarray, qtree), cfg)


@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_qlora_step_over_ptq_base_matches_jax(fmt):
    jmodel = JaxQwen3(jax_qwen3_config(VOCAB, tie_word_embeddings=True,
                                       **PTQ_CFG))
    params = numpy_params(jmodel, seed=7)
    qparams = ptq_tree(params, fmt)
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
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, lora_np), qparams,
        (jnp.asarray(x), jnp.asarray(y)), None)

    cfg, state = carried(jmodel, qparams)
    model = QLoRAModel(Qwen3(cfg, device="meta"), state,
                       lora_from_jax(lora_np, cfg),
                       LoRAConfig(r=8, alpha=16.0),
                       compute_dtype=torch.float32, device="cpu")
    assert sum(isinstance(m, QLoRALinear) for m in model.modules()) == 14
    factors = model.lora_state()
    keys = [(n, k) for n in sorted(factors) for k in ("a", "b")]
    loss, _ = make_fused_ce_loss(chunk=CHUNK, vocab_chunk=VOCAB_CHUNK)(
        model, (torch.from_numpy(x), torch.from_numpy(y)))
    grads = torch.autograd.grad(loss, [factors[n][k] for n, k in keys])
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_TOL)
    for (name, k), got in zip(keys, grads):
        want = np.asarray(want_grads[flax_path(name)][k])
        assert np.max(np.abs(got.numpy() - want)) <= GRAD_TOL * np.max(
            np.abs(want)), (name, k)
