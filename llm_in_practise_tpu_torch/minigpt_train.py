"""MiniGPT char-level pretraining, the minimum end-to-end slice.

Port of ``examples/minigpt_train.py``:

    python -m llm_in_practise_tpu_torch.minigpt_train [--epochs N] \\
        [--seq_len 64] [--batch_size 16] [--lr 3e-3] [--ckpt_dir DIR] \\
        [--prompt "TPUs are"] [--device cpu]

Char vocab -> sliding-window (x, y) pairs -> the MiniGPT v2 preset (4
post-LN layers, d_model 128, learned positions, dropout 0.1, f32) ->
AdamW with global-norm clipping, the batches shuffled per epoch ->
``ckpt_{step:08d}.msgpack`` with the config and the vocab -> a greedy
sample of 40 characters after ``--prompt``. Runs on the card unless
``--device cpu`` is given; at f32 and head_dim 32 attention takes the
dense path (the flash kernels take bf16 at head_dim 64 or 128).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from llm_in_practise_tpu_torch.ckpt import checkpoint as ckpt
from llm_in_practise_tpu_torch.core.device import resolve_device
from llm_in_practise_tpu_torch.data.chardata import char_lm_examples
from llm_in_practise_tpu_torch.data.loader import batch_iterator
from llm_in_practise_tpu_torch.infer.generate import generate
from llm_in_practise_tpu_torch.models.convert import gpt_params_to_jax
from llm_in_practise_tpu_torch.models.gpt import (
    GPT,
    init_params,
    minigpt_config,
)
from llm_in_practise_tpu_torch.train import optim
from llm_in_practise_tpu_torch.train import step as step_lib

SAMPLE_TEXT = (
    "TPUs are matrix machines: feed the systolic array big batched matmuls, "
    "keep the data in bfloat16, and let the compiler fuse the rest. "
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m llm_in_practise_tpu_torch.minigpt_train",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--text", default=SAMPLE_TEXT * 4)
    p.add_argument("--seq_len", type=int, default=64)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--weight_decay", type=float, default=0.1)
    p.add_argument("--ckpt_dir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "minigpt_ckpt"))
    p.add_argument("--prompt", default="TPUs are")
    p.add_argument("--device", default=None,
                   help="torch device; default the card (cuda:0)")
    return p


def run(argv=None) -> dict:
    """The CLI, returning ``losses`` (each printed epoch's mean),
    ``ckpt_path``, ``sample`` and the ``model``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    print(f"device: {device}")
    x, y, tok = char_lm_examples(args.text, args.seq_len)
    cfg = minigpt_config(tok.vocab_size, seq_len=args.seq_len)
    model = GPT(cfg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    model.load_state(init_params(cfg, gen, device=device))
    for p in model.parameters():
        p.requires_grad_(True)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"vocab={tok.vocab_size} examples={len(x)} params={n_params:,}")

    tx = optim.adamw(args.lr, weight_decay=args.weight_decay, clip_norm=1.0)
    state = step_lib.create_train_state(model, tx)
    gen.manual_seed(1)   # the dropout masks
    train_step = step_lib.make_train_step(
        loss_fn=step_lib.make_dropout_loss(gen))

    losses = []
    for epoch in range(args.epochs):
        t0 = time.time()
        epoch_losses = []
        for bx, by in batch_iterator((x, y), args.batch_size, seed=0,
                                     epoch=epoch):
            batch = (torch.from_numpy(bx).long().to(device),
                     torch.from_numpy(by).long().to(device))
            state, metrics = train_step(state, batch)
            epoch_losses.append(metrics["loss"])
        if epoch % 5 == 0 or epoch == args.epochs - 1:
            mean_loss = float(torch.stack(epoch_losses).mean())
            losses.append(mean_loss)
            print(f"epoch {epoch + 1}/{args.epochs} | loss {mean_loss:.4f} "
                  f"| {time.time() - t0:.2f}s")

    path = ckpt.save_checkpoint(
        args.ckpt_dir,
        {"params": gpt_params_to_jax(
            {n: p.detach() for n, p in model.named_parameters()}, cfg)},
        state.step,
        metadata={"config": cfg.to_dict(), "vocab": tok.to_dict()})
    print(f"saved {path}")

    prompt = torch.from_numpy(tok.encode(args.prompt)[None, :]).long()
    out = generate(model, prompt, max_new_tokens=40, greedy=True,
                   cache_dtype=torch.float32)
    sample = tok.decode(np.asarray(out[0].cpu()))
    print("sample:", repr(sample))
    return {"losses": losses, "ckpt_path": path, "sample": sample,
            "model": model, "tokenizer": tok}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
