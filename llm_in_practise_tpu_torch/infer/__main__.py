"""Chat with a merged checkpoint: single-shot, sampling, multi-turn.

Port of ``examples/inference_chat.py``:

    python -m llm_in_practise_tpu_torch.infer [--model_path MODEL.msgpack] \\
        [--tokenizer_path TOK.json] [--prompt "Who are you?"] \\
        [--interactive] [--max_new_tokens 48] [--temperature 0.7] \\
        [--top_p 0.9] [--greedy] [--stream] [--device cpu]

Loads the model that ``merge_lora`` writes (or any ``save_named`` model
checkpoint with its config), keeps a rolling message history, renders
ChatML and generates with :func:`~.generate.generate`; ``--stream``
prints tokens as they decode. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from llm_in_practise_tpu_torch.core.device import resolve_device
from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
from llm_in_practise_tpu_torch.data.sft import IM_END, IM_START, render_chatml
from llm_in_practise_tpu_torch.infer.generate import (
    decode_step,
    generate,
    load_model,
    prefill,
)
from llm_in_practise_tpu_torch.infer.sampling import sample_token


def build_parser() -> argparse.ArgumentParser:
    tmp = tempfile.gettempdir()
    p = argparse.ArgumentParser(
        prog="python -m llm_in_practise_tpu_torch.infer",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--model_path",
                   default=os.path.join(tmp, "qwen3_merged", "model.msgpack"))
    p.add_argument("--tokenizer_path",
                   default=os.path.join(tmp, "qwen3_sft_bpe.json"))
    p.add_argument(
        "--system",
        default="You are a helpful assistant named MyBot, trained by MyTeam.",
        help="system prompt (the train CLI's default); pass '' for none")
    p.add_argument("--prompt", default="Who are you?",
                   help="single-shot prompt; omit --interactive for one turn")
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--max_new_tokens", type=int, default=48)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--stream", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device; default the card (cuda:0)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    tok = BPETokenizer.load(args.tokenizer_path)
    model = load_model(args.model_path, device)
    eos = tok.token_to_id(IM_END)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    history: list[dict] = []
    if args.system:
        history.append({"role": "system", "content": args.system})

    def stream(ids: torch.Tensor) -> str:
        # incremental prefill + decode, printing each new piece of text;
        # the prompt is cropped and the tokens capped to fit the cache, as
        # generate does
        cache_len = model.config.max_seq_len
        ids = ids[:, -(cache_len - 1):]
        n_new = min(args.max_new_tokens, cache_len - ids.shape[1])
        cache = model.init_cache(1, cache_len, dtype=torch.float32)
        out_ids: list[int] = []
        shown = text = ""
        with torch.inference_mode():
            logits, cache = prefill(model, ids, cache)
            for i in range(n_new):
                tok_id = int(sample_token(
                    gen, logits, temperature=args.temperature,
                    top_p=args.top_p, greedy=args.greedy)[0])
                if eos is not None and tok_id == eos:
                    break
                out_ids.append(tok_id)
                text = tok.decode(out_ids)
                print(text[len(shown):], end="", flush=True)
                shown = text
                if i + 1 < n_new:
                    logits, cache = decode_step(
                        model, torch.tensor([tok_id], device=device), cache)
        print()
        return text

    def answer(user_text: str) -> str:
        history.append({"role": "user", "content": user_text})
        prompt = render_chatml(history) + f"{IM_START}assistant\n"
        ids = torch.tensor([tok.encode(prompt)], device=device)
        if args.stream:
            text = stream(ids)
        else:
            out = generate(model, ids, max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature, top_p=args.top_p,
                           greedy=args.greedy, eos_id=eos, generator=gen)
            text = tok.decode(out[0, ids.shape[1]:].tolist())
            print(text.strip())
        history.append({"role": "assistant", "content": text.strip()})
        return text

    if args.interactive:
        print("chat (empty line to exit)")
        while True:
            try:
                user = input("> ").strip()
            except EOFError:
                break
            if not user:
                break
            answer(user)
    else:
        print(f"> {args.prompt}")
        answer(args.prompt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
