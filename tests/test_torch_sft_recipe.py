"""PyTorch port: the recipe SFT (``python -m
llm_in_practise_tpu_torch.sft_recipe``) against the JAX example's loop.

- Three steps (at a cutoff of 64 tokens) of
  ``examples/recipes/lora_sft.json`` (self-cognition,
  LoRA on every kernel but the head) and of
  ``examples/recipes/deepseek_r1_qwen3_qlora.json`` (alpaca data through
  the registry, an NF4 base, LoRA on q/v): the example's tiny Qwen3 in
  f32 with numpy-seeded weights and JAX's ``init_lora`` factors carried
  across, the same tokenized batch; the loss of every step equals the
  JAX example's loop (``jax.value_and_grad`` + ``optax.adamw`` on the
  named schedule, batches from ``np.random.default_rng(0)``) within 1e-4
  relative.
- The CLI on a 2-step copy of ``lora_sft.json`` with ``--device cpu`` and
  its ``output_dir`` in a temporary directory: JAX's
  ``restore_checkpoint`` reads the adapter (the recipe and the LoRA
  config in its metadata) and the merged model.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from llm_in_practise_tpu.ckpt import checkpoint as jax_ckpt
from llm_in_practise_tpu.data.sft import IGNORE_INDEX
from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.models.qwen3 import qwen3_config as jax_qwen3_config
from llm_in_practise_tpu.peft import lora as jax_lora
from llm_in_practise_tpu.peft.qlora import qlora_apply as jax_qlora_apply
from llm_in_practise_tpu.peft.qlora import quantize_base as jax_quantize_base
from llm_in_practise_tpu.train import schedules as jax_schedules
from llm_in_practise_tpu_torch import sft_recipe
from llm_in_practise_tpu_torch.models.convert import (
    lora_from_jax,
    params_from_jax,
)
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config

from torch_port_util import numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = os.path.join(REPO, "examples", "recipes")
STEPS = 3


def _recipe(name: str, tmp_path, **kw) -> sft_recipe.SFTRecipe:
    with open(os.path.join(RECIPES, name)) as f:
        d = json.load(f)
    if d.get("dataset_registry"):
        d["dataset_registry"] = os.path.join(
            REPO, d["dataset_registry"])
    d.update(output_dir=str(tmp_path), num_train_steps=STEPS)
    d.update(kw)
    return sft_recipe.SFTRecipe(**d)


def _jax_losses(recipe, jmodel, params, lora, x, labels):
    """The JAX example's training loop (``examples/sft_recipe.py``)."""
    lcfg = jax_lora.LoRAConfig(r=recipe.lora_rank, alpha=recipe.lora_alpha,
                               target_patterns=sft_recipe.lora_config(
                                   recipe).target_patterns)
    if recipe.finetuning_type == "qlora":
        qparams = jax.jit(jax_quantize_base)(params)

        def effective(lp):
            return jax_qlora_apply(qparams, lp, lcfg, dtype=jnp.float32)
    else:
        def effective(lp):
            return jax_lora.apply_lora(params, lp, lcfg)

    def loss_fn(lp, idx):
        logits = jmodel.apply({"params": effective(lp)}, x[idx],
                              deterministic=True)
        lab = labels[idx]
        shift_logits = logits[:, :-1].astype(jnp.float32)
        shift_labels = lab[:, 1:]
        mask = shift_labels != IGNORE_INDEX
        logp = jax.nn.log_softmax(shift_logits)
        ll = jnp.take_along_axis(
            logp, jnp.maximum(shift_labels, 0)[..., None], -1)[..., 0]
        return -(ll * mask).sum() / jnp.maximum(mask.sum(), 1)

    lr = jax_schedules.by_name(recipe.lr_scheduler_type,
                               recipe.learning_rate,
                               total_steps=recipe.num_train_steps,
                               warmup_steps=recipe.warmup_steps)
    tx = optax.adamw(lr)
    opt_state = tx.init(lora)
    step_fn = jax.jit(jax.value_and_grad(loss_fn))
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(recipe.num_train_steps):
        idx = jnp.asarray(rng.integers(
            0, len(x), (recipe.per_device_train_batch_size,)))
        loss, grads = step_fn(lora, idx)
        updates, opt_state = tx.update(grads, opt_state, lora)
        lora = optax.apply_updates(lora, updates)
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("name", ["lora_sft.json",
                                  "deepseek_r1_qwen3_qlora.json"])
def test_recipe_losses_match_the_jax_loop(tmp_path, name):
    recipe = _recipe(name, tmp_path, cutoff_len=64)
    tok, batch = sft_recipe.build_dataset(
        recipe, sft_recipe.resolve_dataset(recipe))
    jcfg = jax_qwen3_config(tok.get_vocab_size(),
                            max_seq_len=recipe.cutoff_len,
                            compute_dtype="float32")
    jmodel = JaxQwen3(jcfg)
    params = numpy_params(jmodel, seed=21)
    lcfg = sft_recipe.lora_config(recipe)
    jlora = jax_lora.init_lora(
        params, jax_lora.LoRAConfig(r=lcfg.r, alpha=lcfg.alpha,
                                    target_patterns=lcfg.target_patterns),
        jax.random.PRNGKey(1))
    want = _jax_losses(recipe, jmodel, params, jlora,
                       jnp.asarray(batch.input_ids),
                       jnp.asarray(batch.labels))

    cfg = Qwen3Config.from_dict(jcfg.to_dict())
    state = params_from_jax(params, cfg)
    lora = lora_from_jax(jax.tree.map(np.asarray, jlora), cfg)
    assert sorted(lora) == sorted(
        n for n in state if n.endswith(".kernel")
        and "lm_head" not in n and "embed" not in n
        and (recipe.lora_target == "all"
             or any(p in n for p in ("q_proj", "v_proj"))))
    out, got = sft_recipe.train(recipe, Qwen3(cfg, device="meta"), state,
                                lcfg, lora, batch, "cpu")
    assert len(got) == STEPS and out is lora
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert all(not t.requires_grad for ab in lora.values()
               for t in ab.values())
    assert any(bool(ab["b"].abs().sum() > 0) for ab in lora.values())


def test_recipe_cli_writes_what_jax_reads(tmp_path):
    recipe = _recipe("lora_sft.json", tmp_path / "out", num_train_steps=2)
    path = tmp_path / "recipe.json"
    path.write_text(json.dumps(dataclasses.asdict(recipe)))
    assert sft_recipe.main(["--recipe", str(path), "--device", "cpu"]) == 0
    tree, meta = jax_ckpt.restore_checkpoint(
        str(tmp_path / "out" / "adapter.msgpack"))
    assert meta["recipe"]["num_train_steps"] == 2
    assert meta["lora_config"]["r"] == 8
    assert len(tree) == 2 * 7          # every block kernel of 2 layers
    for ab in tree.values():
        assert ab["a"].dtype == ab["b"].dtype == np.float32
    merged, mmeta = jax_ckpt.restore_checkpoint(
        str(tmp_path / "out" / "model.msgpack"))
    assert set(merged) == {"tok_embed", "ln_f", "lm_head", "block_0",
                           "block_1"}
    assert mmeta["config"]["n_layer"] == 2
    with pytest.raises(ValueError, match="unknown finetuning_type"):
        sft_recipe.train(dataclasses.replace(recipe, finetuning_type="full"),
                         None, {}, None, {}, None, "cpu")
    bad = dataclasses.replace(recipe, dataset="nope",
                              dataset_registry=os.path.join(
                                  RECIPES, "datasets.json"))
    with pytest.raises(ValueError, match="neither registered"):
        sft_recipe.resolve_dataset(bad)
