"""Serve a packed NF4 Qwen3 export over the OpenAI API on the card.

    python -m llm_in_practise_tpu_torch.serve --quantized_dir DIR \\
        --tokenizer_path TOK.json [--device cpu] [--max_slots 8] \\
        [--cache_len 512] [--kv-cache-dtype bfloat16] [--port 8000]

``DIR`` holds the ``packed.npz`` + ``manifest.json`` that the JAX
package's exporters write (``quant/io.py``); ``TOK.json`` is a BPE
tokenizer saved by either package. The flags of the JAX package's
``examples/serve_openai.py`` that this port does not have yet are
accepted and raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse

import torch

# JAX CLI flag -> (argparse kwargs, ROADMAP.md queue A item)
_NOT_PORTED = {
    "--model_path": (dict(default=None), 7),
    "--lora-modules": (dict(nargs="*", default=None), 5),
    "--enable-prefix-caching": (dict(action="store_true"), 3),
    "--session-store": (dict(action="store_true"), 5),
    "--session-ttl": (dict(type=float, default=None), 5),
    "--enable-chunked-prefill": (dict(type=int, nargs="?", const=256,
                                      default=None), 2),
    "--tensor-parallel-size": (dict(type=int, default=1), 14),
    "--kv-offload": (dict(action="store_true"), 5),
    "--kv-remote": (dict(default=None), 5),
    "--role": (dict(default="both"), 5),
    "--speculative": (dict(type=int, nargs="?", const=4, default=None), 4),
    "--decode-steps": (dict(type=int, default=1), 2),
    "--no-mixed-step": (dict(action="store_true"), 2),
    "--draft-model-path": (dict(default=None), 4),
    "--max-queue": (dict(type=int, default=None), 2),
    "--queue-timeout": (dict(type=float, default=None), 2),
    "--trace-file": (dict(default=None), 6),
    "--ttft-slo": (dict(type=float, default=None), 6),
    "--tpot-slo": (dict(type=float, default=None), 6),
    "--kv-page-size": (dict(type=int, default=None), 3),
    "--kv-pool-tokens": (dict(type=int, default=None), 3),
    "--tp-quantized-collectives": (dict(action="store_true"), 14),
    "--scan-layers": (dict(action="store_true"), 7),
}

_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m llm_in_practise_tpu_torch.serve")
    p.add_argument("--quantized_dir", required=True,
                   help="packed NF4 export (packed.npz + manifest.json)")
    p.add_argument("--tokenizer_path", required=True)
    p.add_argument("--model_name", default="qwen3-h100")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default=None,
                   help="default: the card (cuda:0); 'cpu' runs the plain "
                        "versions of the kernels")
    p.add_argument("--max_slots", type=int, default=8)
    p.add_argument("--cache_len", type=int, default=512)
    p.add_argument("--kv-cache-dtype", dest="kv_cache_dtype",
                   default="float32", choices=["float32", "bfloat16", "fp8"])
    p.add_argument("--kv-layout", dest="kv_layout", default="contiguous",
                   choices=["contiguous", "paged"])
    for flag, (kw, _) in _NOT_PORTED.items():
        p.add_argument(flag, dest=flag.lstrip("-").replace("-", "_"), **kw)
    return p


def check_not_ported(args) -> None:
    """Raise on any flag of the JAX CLI that this port does not serve."""
    for flag, (kw, item) in _NOT_PORTED.items():
        value = getattr(args, flag.lstrip("-").replace("-", "_"))
        if value not in (None, False, kw.get("default")):
            raise NotImplementedError(
                f"{flag} is not ported to the PyTorch server yet "
                f"(ROADMAP.md queue A item {item})")
    if args.kv_layout == "paged":
        raise NotImplementedError(
            "--kv-layout paged is not ported yet (ROADMAP.md queue A item 3)")
    if args.kv_cache_dtype == "fp8":
        raise NotImplementedError(
            "--kv-cache-dtype fp8 is not ported yet (ROADMAP.md queue A "
            "item 3)")


def build_server(args):
    """Load the export, build the model, engine and server (not started)."""
    from llm_in_practise_tpu_torch.core.device import resolve_device
    from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.models.convert import params_from_jax
    from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
    from llm_in_practise_tpu_torch.quant.io import load_packed
    from llm_in_practise_tpu_torch.serve.api import OpenAIServer
    from llm_in_practise_tpu_torch.serve.engine import InferenceEngine
    from llm_in_practise_tpu_torch.serve.quantized import QuantizedModel

    device = resolve_device(args.device)
    tok = BPETokenizer.load(args.tokenizer_path)
    tree, meta = load_packed(args.quantized_dir)
    if meta.get("family", "qwen3") != "qwen3":
        raise NotImplementedError(
            f"model family {meta.get('family')!r} is not ported; the "
            "PyTorch server serves Qwen3 exports")
    cfg = Qwen3Config.from_dict(meta["config"])
    state = params_from_jax(tree, cfg)
    model = QuantizedModel(Qwen3(cfg, device="meta"), state, device=device)
    engine = InferenceEngine(
        model, max_slots=args.max_slots, cache_len=args.cache_len,
        eos_id=tok.token_to_id(IM_END),
        cache_dtype=_KV_DTYPES[args.kv_cache_dtype])
    return OpenAIServer(engine, tok, model_name=args.model_name)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    check_not_ported(args)
    server = build_server(args)
    print(f"serving {args.quantized_dir} on {args.host}:{args.port} "
          f"({server.engine.device}; /v1/chat/completions, /v1/models, "
          "/health)", flush=True)
    server.serve(host=args.host, port=args.port)


if __name__ == "__main__":
    main()
