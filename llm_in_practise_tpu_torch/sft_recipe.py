"""Recipe-driven SFT: the LLaMA-Factory workflow analog.

Port of ``examples/sft_recipe.py``:

    python -m llm_in_practise_tpu_torch.sft_recipe \\
        --recipe examples/recipes/lora_sft.json [--device cpu]

A JSON recipe with LLaMA-Factory's knob surface (the same files the JAX
example reads) runs end to end: the dataset (the built-in
self-cognition records, or an alpaca JSON file, by name through a
``dataset_info.json``-like registry or by path) -> ChatML with the
loss on the assistant turn only -> LoRA (``finetuning_type: lora``) or
QLoRA over an NF4 base (``qlora``; the base dequantized and the delta
added in the loss, :func:`~.peft.qlora.qlora_apply`, as the JAX example
does) -> AdamW steps on the named schedule -> ``adapter.msgpack`` (flax's
format; JAX's ``restore_checkpoint`` reads it) -> with ``merge_after``
the merged ``model.msgpack``.

The model is ``model_dir``'s HF checkpoint, or else the train CLI's
small random Qwen3 (seeded; bf16 compute and head_dim 64, which the
card's attention kernels take, where the JAX example's tiny model
computes in f32). It runs on the card unless ``--device cpu`` is given;
on the card attention runs the flash kernels forward and backward.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from llm_in_practise_tpu_torch.ckpt.checkpoint import save_named
from llm_in_practise_tpu_torch.core.device import resolve_device
from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
from llm_in_practise_tpu_torch.data.converters import alpaca_to_messages
from llm_in_practise_tpu_torch.data.sft import (
    IM_END,
    IM_START,
    build_sft_dataset,
    render_chatml,
    self_cognition_records,
    tokenize_for_sft,
)
from llm_in_practise_tpu_torch.models.convert import (
    lora_to_jax,
    params_to_jax,
)
from llm_in_practise_tpu_torch.models.qwen3 import DTYPES, Qwen3
from llm_in_practise_tpu_torch.peft.lora import (
    LoRAConfig,
    apply_lora,
    init_lora,
    merge_lora,
    trainable_report,
)
from llm_in_practise_tpu_torch.peft.qlora import (
    memory_report,
    qlora_apply,
    quantize_base,
)
from llm_in_practise_tpu_torch.train import schedules
from llm_in_practise_tpu_torch.train.losses import cross_entropy
from llm_in_practise_tpu_torch.train.optim import adamw


@dataclasses.dataclass(frozen=True)
class SFTRecipe:
    """The LLaMA-Factory YAML knob surface, one dataclass."""

    # model: an HF dir; None -> the small random Qwen3
    model_dir: str | None = None
    # dataset: a registered name, "self_cognition", or an alpaca .json
    dataset: str = "self_cognition"
    # dataset_info.json analog {name: {path, format}}; paths resolve
    # relative to the registry file
    dataset_registry: str | None = None
    bot_name: str = "MyBot"
    bot_author: str = "MyTeam"
    cutoff_len: int = 128                 # max_length
    # "lora" (unquantized base) or "qlora" (NF4-quantized frozen base)
    finetuning_type: str = "lora"
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_target: str = "all"              # "all" | regex over kernel paths
    learning_rate: float = 1e-3
    num_train_steps: int = 60
    per_device_train_batch_size: int = 8
    lr_scheduler_type: str = "cosine"
    warmup_steps: int = 5
    output_dir: str = "/tmp/sft_recipe_out"
    merge_after: bool = False


def resolve_dataset(recipe: SFTRecipe) -> str:
    """``"self_cognition"`` or the path of an alpaca JSON file, through
    the registry when the recipe names one."""
    dataset = recipe.dataset
    if not recipe.dataset_registry:
        return dataset
    with open(recipe.dataset_registry, encoding="utf-8") as f:
        registry = json.load(f)
    entry = registry.get(dataset)
    if entry is None:
        if dataset != "self_cognition" and not os.path.exists(dataset):
            raise ValueError(
                f"dataset {dataset!r} is neither registered in "
                f"{recipe.dataset_registry} nor a file")
        return dataset
    fmt = entry.get("format", "alpaca")
    if fmt not in ("alpaca", "self_cognition"):
        raise ValueError(f"unknown dataset format {fmt!r}")
    if fmt == "self_cognition":
        dataset = "self_cognition"
    else:
        path = entry.get("path")
        if not path:
            raise ValueError(f"registry entry {recipe.dataset!r} has format "
                             f"{fmt!r} but no 'path'")
        dataset = os.path.join(
            os.path.dirname(os.path.abspath(recipe.dataset_registry)), path)
    print(f"dataset {recipe.dataset!r} -> {dataset} ({fmt})")
    return dataset


def build_dataset(recipe: SFTRecipe, dataset: str):
    """``(tokenizer, SFTBatch)``: a BPE trained on the rendered texts (or
    loaded from ``output_dir/tokenizer.json``) and the tokenized,
    label-masked batch, as the JAX example builds them."""
    from llm_in_practise_tpu_torch.train.__main__ import build_tokenizer

    tok_path = os.path.join(recipe.output_dir, "tokenizer.json")
    if dataset == "self_cognition":
        records = self_cognition_records(n=64)
        tok = build_tokenizer(records, recipe.bot_name, recipe.bot_author,
                              tok_path)
        return tok, build_sft_dataset(records, tok, name=recipe.bot_name,
                                      author=recipe.bot_author,
                                      max_length=recipe.cutoff_len)
    with open(dataset, encoding="utf-8") as f:
        alpaca = json.load(f)
    texts = [render_chatml(alpaca_to_messages(r)) for r in alpaca]
    if os.path.exists(tok_path):
        tok = BPETokenizer.load(tok_path)
    else:
        tok = BPETokenizer.train(
            texts, vocab_size=2000, min_frequency=1,
            special_tokens=("[PAD]", "[UNK]", IM_START, IM_END))
        tok.save(tok_path)
    return tok, tokenize_for_sft(texts, tok, max_length=recipe.cutoff_len)


def lora_config(recipe: SFTRecipe) -> LoRAConfig:
    """``lora_target: all`` is every kernel but the head and the
    embedding (LLaMA-Factory's meaning); else the recipe's regex over
    flax paths."""
    patterns = ((r"^(?!.*(?:lm_head|embed)).*kernel$",)
                if recipe.lora_target == "all" else (recipe.lora_target,))
    return LoRAConfig(r=recipe.lora_rank, alpha=recipe.lora_alpha,
                      target_patterns=patterns)


def train(recipe: SFTRecipe, model, params: dict, lcfg: LoRAConfig,
          lora: dict, batch, device) -> tuple[dict, list[float]]:
    """The recipe's steps over LoRA factors ``lora`` (updated in place):
    next-token cross-entropy on the assistant labels, AdamW as
    ``optax.adamw(lr)`` (weight decay 1e-4, no clipping) on the named
    schedule, batches drawn by ``np.random.default_rng(0)``. ``model`` is
    a :class:`~.models.qwen3.Qwen3` (it may live on ``meta``) applied to
    the effective state. Returns ``(lora, losses)``."""
    if recipe.finetuning_type == "qlora":
        qparams = quantize_base(params)
        print(memory_report(params, qparams))
        compute = DTYPES[model.config.compute_dtype]

        def effective(lp):
            return qlora_apply(qparams, lp, lcfg, dtype=compute)
    elif recipe.finetuning_type == "lora":
        def effective(lp):
            return apply_lora(params, lp, lcfg)
    else:
        raise ValueError(
            f"unknown finetuning_type {recipe.finetuning_type!r}")

    x = torch.from_numpy(batch.input_ids.astype(np.int64)).to(device)
    labels = torch.from_numpy(batch.labels.astype(np.int64)).to(device)
    leaves = [lora[n][k] for n in sorted(lora) for k in ("a", "b")]
    for t in leaves:
        t.requires_grad_(True)
    lr = schedules.by_name(recipe.lr_scheduler_type, recipe.learning_rate,
                           total_steps=recipe.num_train_steps,
                           warmup_steps=recipe.warmup_steps)
    tx = adamw(lr, weight_decay=1e-4, clip_norm=None)
    opt_state = tx.init(leaves)
    rng = np.random.default_rng(0)
    losses = []
    for step in range(recipe.num_train_steps):
        idx = torch.from_numpy(rng.integers(
            0, len(x), (recipe.per_device_train_batch_size,))).to(device)
        logits = model.apply(effective(lora), x[idx])
        loss, _ = cross_entropy(logits[:, :-1], labels[idx][:, 1:])
        grads = torch.autograd.grad(loss, leaves)
        tx.step(leaves, grads, opt_state)
        losses.append(float(loss.detach()))
        if step % 10 == 0 or step == recipe.num_train_steps - 1:
            print(f"step {step} | loss {losses[-1]:.4f}", flush=True)
    for t in leaves:
        t.requires_grad_(False)
    return lora, losses


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m llm_in_practise_tpu_torch.sft_recipe",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--recipe", required=True)
    p.add_argument("--device", default=None,
                   help="torch device; default the card (cuda:0)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    with open(args.recipe) as f:
        recipe = SFTRecipe(**json.load(f))
    print(f"recipe: {recipe}")
    device = resolve_device(args.device)
    os.makedirs(recipe.output_dir, exist_ok=True)

    tok, batch = build_dataset(recipe, resolve_dataset(recipe))
    print(f"dataset: {batch.input_ids.shape}")
    gen = torch.Generator(device=device)
    if recipe.model_dir:
        from llm_in_practise_tpu_torch.models.hf_loader import load_qwen3

        cfg, params = load_qwen3(recipe.model_dir, device=device)
    else:
        from llm_in_practise_tpu_torch.train.__main__ import tiny_model

        cfg, params = tiny_model(tok.get_vocab_size(), recipe.cutoff_len,
                                 gen, device)
    lcfg = lora_config(recipe)
    gen.manual_seed(1)
    lora = init_lora(params, lcfg, gen)
    print(trainable_report(params, lora))

    lora, losses = train(recipe, Qwen3(cfg, device="meta"), params, lcfg,
                         lora, batch, device)
    path = save_named(recipe.output_dir, lora_to_jax(lora), "adapter",
                      metadata={"lora_config": lcfg.to_dict(),
                                "recipe": dataclasses.asdict(recipe),
                                "config": cfg.to_dict()})
    print(f"adapter -> {path}")
    if recipe.merge_after:
        merged = merge_lora(params, lora, lcfg)
        path = save_named(recipe.output_dir, params_to_jax(merged, cfg),
                          "model", metadata={"config": cfg.to_dict()})
        print(f"merged model -> {path}")
    return 0 if all(np.isfinite(losses)) else 1


if __name__ == "__main__":
    sys.exit(main())
