"""GPTLike pretraining on wikitext with the in-tree BPE tokenizer.

Port of ``examples/gptlike_wikitext.py``:

    python -m llm_in_practise_tpu_torch.gptlike_wikitext \\
        [--pos learned|sinusoidal] [--epochs 2] [--batch_size 16] \\
        [--vocab_size 8000] [--block_size 256] [--max_lines 4000] \\
        [--tokenizer_path TOK.json] [--ckpt_dir DIR] [--device cpu]

Trains a BPE tokenizer on the corpus (or loads ``--tokenizer_path`` when
it exists), block-chunks the ids into shifted (x, y) pairs, holds out a
tenth, pretrains the GPTLike preset (6 pre-LN layers, 8 heads, d_model
512, tied head, dropout 0.1) with the :class:`~.train.trainer.Trainer`
(cosine schedule, 20 warm-up steps, best and latest checkpoints in
``--ckpt_dir``), plots the loss curve when matplotlib is installed, and
samples 40 tokens at temperature 0.8, top-k 50. ``prepare_data`` never
asks the network: offline it falls back to the seeded synthetic corpus.
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from llm_in_practise_tpu_torch.core.device import resolve_device
from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
from llm_in_practise_tpu_torch.data.lm_dataset import (
    block_chunk,
    prepare_data,
    tokenize_corpus,
    train_val_split,
)
from llm_in_practise_tpu_torch.infer.generate import generate
from llm_in_practise_tpu_torch.models.gpt import GPT, gptlike_config
from llm_in_practise_tpu_torch.train.trainer import Trainer, TrainerConfig


def build_parser() -> argparse.ArgumentParser:
    tmp = tempfile.gettempdir()
    p = argparse.ArgumentParser(
        prog="python -m llm_in_practise_tpu_torch.gptlike_wikitext",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="wikitext-2")
    p.add_argument("--vocab_size", type=int, default=8000)
    p.add_argument("--block_size", type=int, default=256)
    p.add_argument("--pos", default="learned",
                   choices=["learned", "sinusoidal"])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--max_lines", type=int, default=4000)
    p.add_argument("--tokenizer_path",
                   default=os.path.join(tmp, "gptlike_bpe.json"))
    p.add_argument("--ckpt_dir", default=os.path.join(tmp, "gptlike_ckpt"))
    p.add_argument("--loss_curve", default=os.path.join(tmp,
                                                        "gptlike_loss.png"))
    p.add_argument("--prompt", default="the")
    p.add_argument("--device", default=None,
                   help="torch device; default the card (cuda:0)")
    return p


def run(argv=None) -> dict:
    """The CLI, returning the ``history``, the ``trainer``, the
    ``tokenizer`` and the ``sample``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    lines = prepare_data(args.dataset)[: args.max_lines]
    print(f"corpus: {len(lines)} lines")
    if os.path.exists(args.tokenizer_path):
        tok = BPETokenizer.load(args.tokenizer_path)
    else:
        tok = BPETokenizer.train(lines, vocab_size=args.vocab_size)
        tok.save(args.tokenizer_path)
    print(f"tokenizer: vocab={tok.vocab_size}")

    ids = tokenize_corpus(lines, tok)
    x, y = block_chunk(ids, args.block_size)
    tr_idx, va_idx = train_val_split(len(x), val_fraction=0.1, seed=42)
    (xt, yt), (xv, yv) = (x[tr_idx], y[tr_idx]), (x[va_idx], y[va_idx])
    print(f"blocks: train={len(xt)} val={len(xv)}")

    model = GPT(gptlike_config(tok.vocab_size, pos_embedding=args.pos,
                               seq_len=args.block_size), device=device)
    cfg = TrainerConfig(lr=args.lr, epochs=args.epochs,
                        batch_size=args.batch_size, schedule="cosine",
                        warmup_steps=20, ckpt_dir=args.ckpt_dir,
                        strategy="ddp")
    trainer = Trainer(model, cfg,
                      metadata={"tokenizer_path": args.tokenizer_path})
    history = trainer.train((xt, yt), eval_data=(xv, yv))

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.plot([h["epoch"] for h in history],
                 [h["train_loss"] for h in history], label="train")
        if history and history[0].get("eval_loss") is not None:
            plt.plot([h["epoch"] for h in history],
                     [h["eval_loss"] for h in history], label="val")
        plt.xlabel("epoch"), plt.ylabel("loss"), plt.legend()
        plt.savefig(args.loss_curve)
        print(f"loss curve -> {args.loss_curve}")
    except ImportError:
        pass

    prompt = torch.as_tensor([tok.encode(args.prompt)], dtype=torch.long)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = generate(model, prompt, max_new_tokens=40, temperature=0.8,
                   top_k=50, generator=gen)
    sample = tok.decode(np.asarray(out[0].cpu()).tolist())
    print("sample:", repr(sample))
    return {"history": history, "trainer": trainer, "tokenizer": tok,
            "sample": sample}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
