"""Post-training quantization (GPTQ / AWQ / int8) with the PPL gate.

Port of ``examples/quantize_ptq.py``:

    python -m llm_in_practise_tpu_torch.quantize --method gptq \\
        --model_path M/model.msgpack --tokenizer_path TOK.json \\
        [--group_size 32] [--n_calib 16] [--max_len 128] \\
        [--ppl_threshold 9.0] [--out_dir OUT] [--device cpu]

Restores a ``save_named`` Qwen3 checkpoint (``model.msgpack`` with the
model ``config`` in ``model.json``) and a BPE tokenizer, calibrates on
the first ``n_calib`` texts of ``prepare_data("wikitext-2")`` (the
synthetic corpus offline) that encode to 8 tokens or more, quantizes the
block kernels (GPTQ, AWQ, or per-channel int8 RTN; the embedding and the
LM head stay), scores the PPL of the fp and the dequantized model on
texts 1000-1200, and writes the dequantized f32 model as
``OUT/model_{method}_{w4|w8}.msgpack`` and the packed export as
``OUT/packed`` (``manifest.json`` + ``packed.npz``), which ``python -m
llm_in_practise_tpu_torch.serve --quantized_dir OUT/packed`` serves on
the W4A16 and W8A16 kernels. It runs on the card unless ``--device cpu``
is given; calibration and the PPL run the plain model, the export's
serving runs the kernels.

Without ``--model_path`` and ``--tokenizer_path`` it runs the example's
hermetic demo: it trains an 800-token BPE on the first 400 lines of the
corpus (saved as ``OUT/tokenizer.json``), pretrains a 2-layer, 128-wide
GPTLike GPT (4 heads, ``seq_len`` 64, dropout 0) for 2 epochs with the
:class:`~.train.trainer.Trainer`, and quantizes that; its export carries
``family: "gpt"``, which ``serve --quantized_dir`` builds a
:class:`~.models.gpt.GPT` for.
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
from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
from llm_in_practise_tpu_torch.data.lm_dataset import (
    block_chunk,
    prepare_data,
    tokenize_corpus,
)
from llm_in_practise_tpu_torch.models.convert import (
    gpt_params_to_jax,
    params_from_jax,
    params_to_jax,
)
from llm_in_practise_tpu_torch.models.gpt import GPT, gptlike_config
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
from llm_in_practise_tpu_torch.quant import int8
from llm_in_practise_tpu_torch.quant import io as quant_io
from llm_in_practise_tpu_torch.quant.awq import (
    AWQConfig,
    dequantize_tree,
    quantize_model_awq,
)
from llm_in_practise_tpu_torch.quant.gptq import (
    GPTQConfig,
    accumulate_dense_stats,
    quantize_model_gptq,
    stats_nbytes,
    sync_clock,
)
from llm_in_practise_tpu_torch.quant.ppl import compare_quantized, make_batches
from llm_in_practise_tpu_torch.train.trainer import Trainer, TrainerConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m llm_in_practise_tpu_torch.quantize",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--method", default="awq", choices=["gptq", "awq", "int8"])
    p.add_argument("--group_size", type=int, default=32)
    p.add_argument("--model_path", default=None,
                   help="save_named checkpoint (e.g. M/model.msgpack)")
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--n_calib", type=int, default=16)
    p.add_argument("--max_len", type=int, default=128)
    p.add_argument("--ppl_threshold", type=float, default=9.0)
    p.add_argument("--out_dir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "quantized_model"))
    p.add_argument("--device", default=None,
                   help="torch device; default the card (cuda:0)")
    return p


def calibration_ids(tok, lines, n_calib: int, max_len: int
                    ) -> list[list[int]]:
    """The example's calibration set: the first ``50 * n_calib`` lines,
    each cut to ``max_len`` ids, those of 8 ids or more, ``n_calib`` of
    them."""
    ids = [tok.encode(t)[:max_len] for t in lines[: 50 * n_calib]]
    return [c for c in ids if len(c) >= 8][:n_calib]


def eval_sequences(tok, lines, max_len: int) -> list[list[int]]:
    """The example's held-out set: lines 1000-1200, cut to ``max_len``
    ids, those of 8 ids or more, 32 of them."""
    seqs = [tok.encode(t)[:max_len] for t in lines[1000:1200]]
    return [s for s in seqs if len(s) >= 8][:32]


def block_target(key: str) -> bool:
    """The example's target: every kernel but the LM head and the
    embedding (a flax path or a port name)."""
    return "lm_head" not in key and "embed" not in key


def pretrain_hermetic(device):
    """The example's hermetic model: ``(tokenizer, GPTConfig, state)`` of
    a 2-layer gptlike GPT pretrained for 2 epochs on ``device``."""
    lines = prepare_data("wikitext-2")[:400]
    tok = BPETokenizer.train(lines, vocab_size=800)
    x, y = block_chunk(tokenize_corpus(lines, tok), 64)
    cfg = gptlike_config(tok.vocab_size, seq_len=64, n_layer=2,
                         embed_dim=128, n_head=4, dropout=0.0)
    trainer = Trainer(GPT(cfg, device=device),
                      TrainerConfig(lr=1e-3, epochs=2, batch_size=16,
                                    strategy="ddp"))
    trainer.train((x, y))
    return tok, cfg, trainer.params


def run(argv=None) -> dict:
    """The CLI, returning what it measured: ``fp_ppl``, ``quant_ppl``,
    ``degradation``, ``passed``, ``calib_sequences``, ``calib_s``,
    ``stats`` / ``stats_bytes`` (GPTQ and AWQ), ``quantize_s``,
    ``matrix_s`` (seconds per kernel), ``model_path``, ``packed_path``,
    the ``family`` and ``config``, the fp and quantized states, and in
    the hermetic branch ``tokenizer_path``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    out: dict = {"method": args.method}
    if args.model_path and args.tokenizer_path:
        tok = BPETokenizer.load(args.tokenizer_path)
        tree, meta = restore_checkpoint(args.model_path)
        cfg_dict = meta["config"]
        cfg = Qwen3Config.from_dict(cfg_dict)
        state = {n: t.to(device)
                 for n, t in params_from_jax(tree, cfg).items()}
        del tree
        model = Qwen3(cfg, device="meta")
        family, to_jax = "qwen3", params_to_jax
    else:
        tok, cfg, state = pretrain_hermetic(device)
        cfg_dict = cfg.to_dict()
        model = GPT(cfg, device="meta")
        family, to_jax = "gpt", gpt_params_to_jax
        os.makedirs(args.out_dir, exist_ok=True)
        out["tokenizer_path"] = os.path.join(args.out_dir, "tokenizer.json")
        tok.save(out["tokenizer_path"])
    out.update(family=family, fp_state=state, config=cfg)

    lines = prepare_data("wikitext-2")
    calib_batches = [torch.tensor([c], device=device)
                     for c in calibration_ids(tok, lines, args.n_calib,
                                              args.max_len)]
    out["calib_sequences"] = len(calib_batches)
    print(f"calibration: {len(calib_batches)} sequences")

    timings: dict = {}
    t0 = sync_clock(state["tok_embed.weight"])
    if args.method == "int8":
        # W8A16 per-channel RTN: no calibration at 8 bits
        qstate = int8.quantize_tree(
            state, lambda name, leaf: leaf.ndim == 2 and block_target(name))
    else:
        stats = accumulate_dense_stats(model, state, calib_batches,
                                       target=block_target)
        t1 = sync_clock(state["tok_embed.weight"])
        out.update(stats=stats, stats_bytes=stats_nbytes(stats),
                   calib_s=t1 - t0)
        print(f"calibration stats: {len(stats)} kernels, "
              f"{out['stats_bytes'] / 2**20:.1f} MiB, {t1 - t0:.2f}s")
        if args.method == "gptq":
            qstate = quantize_model_gptq(
                model, state, calib_batches,
                GPTQConfig(group_size=args.group_size), stats=stats,
                timings=timings)
        else:
            qstate = quantize_model_awq(
                model, state, calib_batches,
                AWQConfig(group_size=args.group_size), stats=stats,
                timings=timings)
    out["quantize_s"] = sync_clock(state["tok_embed.weight"]) - t0
    out["matrix_s"] = timings
    out["q_state"] = qstate

    # the PPL gate: the fp model against the dequantized one
    batches = make_batches(eval_sequences(tok, lines, args.max_len),
                           batch_size=8, max_len=args.max_len, device=device)
    deq = dequantize_tree(qstate, torch.float32)
    result = compare_quantized(model.apply, state, deq, batches,
                               threshold=args.ppl_threshold)
    wtag = "W8" if args.method == "int8" else "W4"
    print(f"fp PPL {result['fp_ppl']:.3f} | {args.method} {wtag} PPL "
          f"{result['quant_ppl']:.3f} | degradation "
          f"{result['degradation']:+.3f}")
    print(result["report"].summary())
    out.update({k: result[k] for k in ("fp_ppl", "quant_ppl", "degradation",
                                       "passed")})

    # per-channel int8 has no group dimension: no group_size recorded
    gs = None if args.method == "int8" else args.group_size
    out["model_path"] = save_named(
        args.out_dir, to_jax(deq, cfg),
        f"model_{args.method}_{wtag.lower()}",
        metadata={"config": cfg_dict, "method": args.method,
                  "group_size": gs, "ppl": result["quant_ppl"]})
    del deq
    print(f"quantized model -> {out['model_path']}")
    out["packed_path"] = quant_io.save_packed(
        os.path.join(args.out_dir, "packed"), to_jax(qstate, cfg),
        metadata={"config": cfg_dict, "family": family,
                  "method": args.method, "group_size": gs,
                  "ppl": result["quant_ppl"]})
    print(f"packed ({wtag}) export -> {out['packed_path']}")
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
