"""QLoRA fine-tune of a Qwen3 on one card (port of
``examples/qwen3_qlora_fsdp.py`` for one device).

    python -m llm_in_practise_tpu_torch.train --steps 30
    python -m llm_in_practise_tpu_torch.train --model_dir HF_DIR \
        --adapter_dir OUT --steps 30
    python -m llm_in_practise_tpu_torch.train --steps 2 --device cpu

Builds a ChatML-aware BPE tokenizer on the self-cognition records, takes
a Qwen3 from an HF checkpoint (``--model_dir``, bf16) or else a small
random one (seeded), quantizes its block kernels to NF4 (double-quantized
absmax, bitsandbytes parity), attaches LoRA factors to
``attn/(q_proj|v_proj)``, runs ``--steps`` AdamW steps of next-token
cross-entropy on the assistant turns, printing the loss, and saves the
adapter to ``--adapter_dir/adapter.msgpack`` (flax's msgpack format, with
``lora_config`` and the model ``config`` in ``adapter.json``; JAX's
``restore_checkpoint`` and ``examples/merge_lora.py`` read it). Every NF4
projection runs the NF4 kernels forward and backward, and attention the
flash kernels (forward, dK/dV and dQ; head_dim 64 or 128). It runs on the
card unless ``--device cpu`` is given (then the kernels' plain versions
run); on the card it ends by printing each kernel's launch count.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from llm_in_practise_tpu_torch.ckpt.checkpoint import save_named
from llm_in_practise_tpu_torch.core.device import resolve_device
from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
from llm_in_practise_tpu_torch.data.sft import (
    IM_END,
    IM_START,
    build_sft_dataset,
    render_chatml,
    self_cognition_records,
    substitute_placeholders,
    to_chat_messages,
)
from llm_in_practise_tpu_torch.models.convert import lora_to_jax
from llm_in_practise_tpu_torch.models.hf_loader import load_config, load_qwen3
from llm_in_practise_tpu_torch.models.qwen3 import (
    Qwen3,
    init_params,
    qwen3_config,
)
from llm_in_practise_tpu_torch.ops.flash_attention import (
    flash_backward_dkv,
    flash_backward_dq,
    flash_forward,
)
from llm_in_practise_tpu_torch.ops.nf4_matmul import (
    nf4_matmul,
    nf4_matmul_backward,
)
from llm_in_practise_tpu_torch.peft.fused import QLoRAModel
from llm_in_practise_tpu_torch.peft.lora import (
    LoRAConfig,
    init_lora,
    trainable_report,
)
from llm_in_practise_tpu_torch.peft.qlora import memory_report, quantize_base
from llm_in_practise_tpu_torch.train.losses import cross_entropy
from llm_in_practise_tpu_torch.train.optim import adamw
from llm_in_practise_tpu_torch.train.step import (
    create_train_state,
    make_train_step,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m llm_in_practise_tpu_torch.train",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--model_dir", default=None,
                   help="HF Qwen3 checkpoint (config.json + safetensors); "
                        "default a small random Qwen3")
    p.add_argument("--name", default="MyBot")
    p.add_argument("--author", default="MyTeam")
    p.add_argument("--fsdp", type=int, default=1,
                   help="data-parallel shards; only 1 is ported")
    p.add_argument("--r", type=int, default=8)
    p.add_argument("--alpha", type=float, default=16.0)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_length", type=int, default=128)
    p.add_argument("--gradient-checkpointing", dest="gradient_checkpointing",
                   action="store_true",
                   help="recompute each block in the backward")
    p.add_argument("--adapter_dir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "qwen3_qlora_adapter"),
                   help="where the trained adapter is saved "
                        "(adapter.msgpack + adapter.json)")
    p.add_argument("--tokenizer_path", default=None,
                   help="BPE tokenizer JSON to load, or to save after "
                        "training one")
    p.add_argument("--device", default=None,
                   help="torch device; default the card (cuda:0)")
    return p


def check_not_ported(args) -> None:
    """Flags of the JAX example that this slice does not port."""
    if args.fsdp > 1:
        raise NotImplementedError(
            "--fsdp > 1 needs the distributed layer, which is not ported "
            "(ROADMAP.md queue A item 14)")


def build_tokenizer(records, name: str, author: str,
                    path: str | None) -> BPETokenizer:
    """A ChatML-aware BPE on the rendered SFT texts, as the JAX example
    trains it; loaded from ``path`` when that file exists."""
    if path:
        try:
            return BPETokenizer.load(path)
        except FileNotFoundError:
            pass
    system = f"You are a helpful assistant named {name}, trained by {author}."
    texts = [render_chatml(to_chat_messages(r, system))
             for r in substitute_placeholders(records, name, author)]
    tok = BPETokenizer.train(
        texts, vocab_size=800,
        special_tokens=("[PAD]", "[UNK]", IM_START, IM_END),
        min_frequency=1)
    if path:
        tok.save(path)
    return tok


def tiny_model(vocab_size: int, max_length: int, gen: torch.Generator,
               device, *, remat: bool = False):
    """``(cfg, state)`` of the small random Qwen3 trained without
    ``--model_dir``: bf16 compute and head_dim 64 (what the card's kernels
    take), weights drawn from ``gen`` seeded with 0 on ``device``."""
    cfg = qwen3_config(vocab_size, max_seq_len=max_length, head_dim=64,
                       compute_dtype="bfloat16", remat=remat)
    gen.manual_seed(0)
    return cfg, init_params(cfg, gen, device=device)


def shifted_loss(model, batch):
    """Next-token cross-entropy on the assistant labels (the JAX
    example's loss): logits at t predict labels at t + 1."""
    x, labels = batch
    logits = model(x)
    loss, n_valid = cross_entropy(logits[:, :-1], labels[:, 1:])
    return loss, {"n_valid": n_valid}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_not_ported(args)
    device = resolve_device(args.device)

    records = self_cognition_records(n=64)
    tok = build_tokenizer(records, args.name, args.author,
                          args.tokenizer_path)
    gen = torch.Generator(device=device)
    if args.model_dir:
        # bf16 compute; head_dim from the config (the flash kernels take
        # 64 and 128 and raise on any other)
        cfg = load_config(args.model_dir).replace(
            remat=args.gradient_checkpointing)
        params = load_qwen3(args.model_dir, device=device)[1]
    else:
        cfg, params = tiny_model(tok.get_vocab_size(), args.max_length,
                                 gen, device,
                                 remat=args.gradient_checkpointing)

    qparams = quantize_base(params)
    print(memory_report(params, qparams))
    lcfg = LoRAConfig(r=args.r, alpha=args.alpha,
                      target_patterns=(r"attn/(q_proj|v_proj)",))
    gen.manual_seed(1)
    lora = init_lora(params, lcfg, gen)
    print(trainable_report(params, lora))
    model = QLoRAModel(Qwen3(cfg, device="meta"), qparams, lora, lcfg,
                       device=device)
    del params

    batch = build_sft_dataset(records, tok, name=args.name,
                              author=args.author, max_length=args.max_length)
    x = torch.from_numpy(batch.input_ids.astype(np.int64)).to(device)
    labels = torch.from_numpy(batch.labels.astype(np.int64)).to(device)

    # the JAX example's optax.adamw(lr): weight decay 1e-4, no clipping
    state = create_train_state(
        model, adamw(args.lr, weight_decay=1e-4, clip_norm=None))
    train_step = make_train_step(loss_fn=shifted_loss)
    rng = np.random.default_rng(0)
    loss = float("nan")
    for step in range(args.steps):
        idx = torch.from_numpy(
            rng.integers(0, len(x), (args.batch_size,))).to(device)
        state, metrics = train_step(state, (x[idx], labels[idx]))
        loss = float(metrics["loss"])
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step} | loss {loss:.4f}", flush=True)
    print(f"trained {args.steps} steps on {device}; final loss {loss:.4f}")
    path = save_named(
        args.adapter_dir, lora_to_jax(model.lora_state()), "adapter",
        metadata={"lora_config": lcfg.to_dict(), "config": cfg.to_dict()})
    print(f"adapter saved -> {path}")
    if device.type == "cuda":
        print("kernel launches:", ", ".join(
            f"{fn.__name__} {fn.launches}" for fn in (
                nf4_matmul, nf4_matmul_backward, flash_forward,
                flash_backward_dkv, flash_backward_dq)))
    return 0 if np.isfinite(loss) else 1


if __name__ == "__main__":
    sys.exit(main())
