"""Merge a LoRA adapter into base weights and save the merged model.

Port of ``examples/merge_lora.py``:

    python -m llm_in_practise_tpu_torch.merge_lora --adapter_dir A \\
        [--model_dir HF_DIR] [--out_dir OUT] [--device cpu]

Restores ``A/adapter.msgpack`` (written by the port's or the JAX
package's train CLI) and its ``lora_config``, takes the base from an HF
checkpoint (``--model_dir``) or else rebuilds the train CLI's small
random model, folds ``B @ A * (alpha / r)`` into each targeted kernel,
and writes ``OUT/model.msgpack`` (flax names, the model ``config`` in
``model.json``) that ``serve --model_path`` and ``infer`` load; with
``--model_dir`` also an HF export (f32 ``model.safetensors`` +
``config.json``) into ``OUT``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from llm_in_practise_tpu_torch.ckpt.checkpoint import (
    restore_checkpoint,
    save_named,
)
from llm_in_practise_tpu_torch.core.device import resolve_device
from llm_in_practise_tpu_torch.models.convert import (
    lora_from_jax,
    params_to_jax,
)
from llm_in_practise_tpu_torch.models.hf_loader import load_qwen3, save_qwen3
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3Config
from llm_in_practise_tpu_torch.peft.lora import LoRAConfig, merge_lora


def build_parser() -> argparse.ArgumentParser:
    tmp = tempfile.gettempdir()
    p = argparse.ArgumentParser(
        prog="python -m llm_in_practise_tpu_torch.merge_lora",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--adapter_dir",
                   default=os.path.join(tmp, "qwen3_lora_adapter"))
    p.add_argument("--model_dir", default=None,
                   help="HF Qwen3 dir; default rebuilds the train CLI's "
                        "small random model from the config in the "
                        "adapter's metadata and the train CLI's generator "
                        "seed, on the device given here (torch draws other "
                        "numbers on the CPU than on the card, so use the "
                        "device the adapter was trained on; the JAX "
                        "package's PRNGKey(0) init cannot be reproduced in "
                        "torch)")
    p.add_argument("--out_dir", default=os.path.join(tmp, "qwen3_merged"))
    p.add_argument("--device", default=None,
                   help="torch device; default the card (cuda:0)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    adapter_path = os.path.join(args.adapter_dir, "adapter.msgpack")
    tree, meta = restore_checkpoint(adapter_path)
    lcfg = LoRAConfig.from_dict(meta["lora_config"])
    print(f"adapter: {adapter_path} (r={lcfg.r}, alpha={lcfg.alpha})")

    if args.model_dir:
        cfg, params = load_qwen3(args.model_dir, device=device)
    else:
        from llm_in_practise_tpu_torch.train.__main__ import tiny_model

        if "config" not in meta:
            raise ValueError(
                f"{adapter_path}: the adapter's metadata has no model "
                "config to rebuild the base from; pass --model_dir")
        cfg = Qwen3Config.from_dict(meta["config"])
        gen = torch.Generator(device=device)
        cfg, params = tiny_model(cfg.vocab_size, cfg.max_seq_len, gen,
                                 device, remat=cfg.remat)

    lora = {n: {k: t.to(device) for k, t in ab.items()}
            for n, ab in lora_from_jax(tree, cfg).items()}
    merged = merge_lora(params, lora, lcfg)
    del params
    path = save_named(args.out_dir, params_to_jax(merged, cfg), "model",
                      metadata={"config": cfg.to_dict()})
    print(f"merged model -> {path}")
    if args.model_dir:
        save_qwen3(merged, cfg, args.out_dir)
        print(f"HF safetensors export -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
