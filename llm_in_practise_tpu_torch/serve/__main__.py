"""Serve a Qwen3 over the OpenAI API on the card.

    python -m llm_in_practise_tpu_torch.serve [--model_path MODEL.msgpack \\
        | --quantized_dir DIR] --tokenizer_path TOK.json [--device cpu] \\
        [--max_slots 8] [--cache_len 512] [--kv-cache-dtype bfloat16|fp8] \\
        [--kv-layout paged|contiguous] [--kv-page-size 16] \\
        [--kv-pool-tokens N] [--enable-prefix-caching] [--port 8000] \\
        [--enable-chunked-prefill [256]] [--decode-steps 8] \\
        [--no-mixed-step] [--max-queue N] [--queue-timeout SECONDS] \\
        [--speculative [4] [--draft-model-path DRAFT.msgpack]] \\
        [--lora-modules NAME=ADAPTER_DIR ...] [--kv-offload] \\
        [--kv-remote HOST:PORT] [--role prefill|decode|both] \\
        [--session-store [--session-ttl SECONDS]] [--trace-file PATH] \\
        [--ttft-slo SECONDS] [--tpot-slo SECONDS]

``DIR`` holds the ``packed.npz`` + ``manifest.json`` that either
package's exporters write (``quant/io.py``, ``convert_hf``): NF4,
GPTQ/RTN int4, AWQ, int8, or a tree that mixes them (the ``"mixed"``
preset: int8 MLP, NF4 attention); each projection runs its format's
Hopper kernel. Without ``--quantized_dir`` the input is ``--model_path``
(default ``$TMPDIR/qwen3_merged/model.msgpack``), a merged dense model
written by either package's ``merge_lora``, served in its own dtype.
``--scan-layers`` is accepted: the port runs the unrolled blocks; as in
the JAX CLI it needs ``--kv-layout contiguous``. The KV layout defaults
to ``paged``, as the JAX CLI's does; ``fp8`` stores the KV as
``torch.float8_e4m3fn`` (a saturating cast). ``--speculative K`` drafts
K tokens per greedy slot by prompt lookup, or with the dense Qwen3 of
``--draft-model-path`` (a ``model.msgpack`` with its config, written by
either package's ``merge_lora`` or ``save_named``), and verifies them in
one fused round per step. Chat requests may carry ``response_format``
(``json_object``, ``json_schema``) and ``tools`` with a forcing
``tool_choice``: the engine masks each constrained step by the
request's grammar; ``POST /v1/embeddings`` answers pooled hidden states.
``--lora-modules name=path`` serves each adapter (an ``adapter.msgpack``
with its sidecar, or its directory, written by either package's
``save_named``) as an extra model name: one engine with an
``AdapterRegistry``, every adapter batched into the base model's
dispatches (``--quantized_dir``, ``--scan-layers``, a name equal to
``--model_name``, a missing checkpoint and a malformed spec are errors,
as in the JAX CLI). ``--kv-offload`` puts a host-RAM tier behind the
prefix cache and ``--kv-remote HOST:PORT`` a shared pool server
(``python -m llm_in_practise_tpu_torch.serve.kv_pool``; either package's
server), each per served model name. ``--role prefill`` or ``decode``
splits prefill from decode across replicas (it needs ``--kv-remote``:
the KV handoff travels through the pool server); a decode replica turns
ngram speculation on unless ``--speculative 0``. With ``--lora-modules``
and a tier, each adapter gets an engine of its own (its own tiers and
handoff namespace), as in the JAX CLI. ``--session-store`` keeps each
conversation's KV pinned across turns for requests that carry a session
id (the ``X-Session-ID`` header or the body's ``session_id``; paged
layout: pinned pages, contiguous: turn bookkeeping only), idle for at
most ``--session-ttl`` seconds; with ``--kv-remote`` every finished turn
is also published to the pool for the fleet's warm path.
``--trace-file PATH`` appends every request span (and, with the step
recorder on, each engine step's host and device lanes) to PATH as Chrome
trace events, one JSON per line (Perfetto opens it; the span ring at
``GET /debug/traces`` is on either way, ``LLM_TPU_TRACE=off`` turns
tracing off and ``LLM_TPU_STEPTRACE=off`` the step recorder).
``--ttft-slo`` / ``--tpot-slo`` turn on SLO goodput accounting
(``llm_goodput_tokens_total{slo}``, ``llm_slo_blame_total{phase}``). The
server answers ``GET /metrics``, ``/debug/kv``, ``/debug/sessions``,
``/debug/hbm``, ``/debug/requests``, ``/debug/traces``, ``POST
/debug/profile`` and the chat page at ``GET /``. ``TOK.json`` is a BPE
tokenizer saved by either package. The flags of the JAX package's
``examples/serve_openai.py`` that this port does not have yet (tensor
parallelism) are accepted and raise ``NotImplementedError`` naming their
ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

# JAX CLI flag -> (argparse kwargs, ROADMAP.md queue A item)
_NOT_PORTED = {
    "--tensor-parallel-size": (dict(type=int, default=1), 14),
    "--tp-quantized-collectives": (dict(action="store_true"), 14),
}

_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "fp8": torch.float8_e4m3fn}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m llm_in_practise_tpu_torch.serve")
    p.add_argument("--model_path",
                   default=os.path.join(tempfile.gettempdir(),
                                        "qwen3_merged", "model.msgpack"),
                   help="merged model checkpoint (model.msgpack with its "
                        "model.json), served when --quantized_dir is absent")
    p.add_argument("--quantized_dir", default=None,
                   help="packed export (packed.npz + manifest.json) in nf4, "
                        "int4 (GPTQ/RTN), awq, int8 or mixed format; the "
                        "export's method is printed at load")
    p.add_argument("--scan-layers", dest="scan_layers", action="store_true",
                   help="accepted as in the JAX CLI: the port runs the "
                        "unrolled blocks either way")
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
    p.add_argument("--kv-layout", dest="kv_layout", default="paged",
                   choices=["paged", "contiguous"],
                   help="KV cache layout: 'paged' (default) carves one pool "
                        "into pages behind per-slot block tables (admission "
                        "reserves actual pages, prefixes share refcounted "
                        "pages); 'contiguous' gives each slot a cache_len "
                        "region")
    p.add_argument("--kv-page-size", dest="kv_page_size", type=int,
                   default=16, metavar="TOKENS",
                   help="tokens per KV page (paged layout)")
    p.add_argument("--kv-pool-tokens", dest="kv_pool_tokens", type=int,
                   default=None, metavar="TOKENS",
                   help="page-pool capacity in tokens (paged layout); "
                        "default max_slots*cache_len")
    p.add_argument("--enable-prefix-caching", dest="prefix_caching",
                   action="store_true",
                   help="reuse prompt-prefix KV across requests (paged: "
                        "shared refcounted pages; contiguous: copied rows)")
    # scheduling and admission control, with the JAX CLI's meanings
    p.add_argument("--enable-chunked-prefill", dest="chunked_prefill",
                   type=int, nargs="?", const=256, default=None,
                   metavar="CHUNK",
                   help="prefill long prompts in CHUNK-token steps "
                        "interleaved with decode (default 256)")
    p.add_argument("--decode-steps", dest="decode_steps", type=int,
                   default=1, metavar="N",
                   help="decode N tokens per dispatch (multi-step "
                        "scheduling); on the card each block is one CUDA "
                        "graph replay")
    p.add_argument("--no-mixed-step", dest="mixed_step",
                   action="store_false", default=True,
                   help="disable the fused mixed step (default on: while "
                        "prompts chunk-prefill and slots decode, one "
                        "dispatch runs the chunk and the decode block)")
    p.add_argument("--max-queue", dest="max_queue", type=int, default=None,
                   metavar="N",
                   help="admission control: reject (HTTP 429 queue_full) "
                        "once N requests wait")
    p.add_argument("--queue-timeout", dest="queue_timeout", type=float,
                   default=None, metavar="SECONDS",
                   help="admission control: shed requests that waited "
                        "past this deadline (HTTP 429 queue_full)")
    p.add_argument("--speculative", type=int, nargs="?", const=4,
                   default=None, metavar="K",
                   help="speculative decoding: draft K tokens per greedy "
                        "slot (default 4) by prompt lookup, or with "
                        "--draft-model-path, and verify them in one fused "
                        "round; 0 turns it off")
    p.add_argument("--draft-model-path", dest="draft_model_path",
                   default=None,
                   help="draft model checkpoint (model.msgpack with its "
                        "config) proposing the K tokens; needs "
                        "--speculative K")
    p.add_argument("--lora-modules", dest="lora_modules", nargs="*",
                   default=None, metavar="NAME=PATH",
                   help="serve LoRA adapters as extra model names "
                        "(vLLM's --enable-lora --lora-modules): each PATH "
                        "is an adapter.msgpack with its sidecar, or its "
                        "directory; every adapter rides the base model's "
                        "dispatches through one AdapterRegistry")
    # the KV tiers and the disaggregated split, with the JAX CLI's meanings
    p.add_argument("--kv-offload", dest="kv_offload", action="store_true",
                   help="tiered KV: offload prefix entries to a host-RAM "
                        "pool (LMCache's CPU tier); turns the prefix cache "
                        "on")
    p.add_argument("--kv-remote", dest="kv_remote", default=None,
                   metavar="HOST:PORT",
                   help="tiered KV: share prefix entries through a kv_pool "
                        "server, namespaced per model (LMCache's lm:// "
                        "tier); also the handoff store of --role")
    p.add_argument("--role", default="both",
                   choices=["both", "prefill", "decode"],
                   help="disaggregated serving: 'prefill' prefills and "
                        "publishes KV (POST /internal/handoff/prefill), "
                        "'decode' decodes from claimed KV "
                        "(kv_transfer_params.handoff_id); needs "
                        "--kv-remote")
    p.add_argument("--session-store", dest="session_store",
                   action="store_true",
                   help="session-native serving: requests carrying a "
                        "session id (X-Session-ID header or body field) "
                        "keep their conversation KV pinned across turns, "
                        "and with --kv-remote each finished turn is "
                        "published to the pool's handoff namespace (the "
                        "fleet-wide warm path)")
    p.add_argument("--session-ttl", dest="session_ttl", type=float,
                   default=600.0, metavar="SECONDS",
                   help="idle TTL for pinned session KV (with "
                        "--session-store)")
    p.add_argument("--trace-file", dest="trace_file", default=None,
                   metavar="PATH",
                   help="append Chrome trace events (one JSON per line) "
                        "for every request span to PATH — open in "
                        "Perfetto / chrome://tracing; the in-memory "
                        "span ring is always on at GET /debug/traces "
                        "(LLM_TPU_TRACE=off disables tracing)")
    p.add_argument("--ttft-slo", dest="ttft_slo", type=float, default=None,
                   metavar="SECONDS",
                   help="SLO goodput accounting: TTFT threshold — "
                        "tokens of requests that miss it count as "
                        "llm_goodput_tokens_total{slo=violated}")
    p.add_argument("--tpot-slo", dest="tpot_slo", type=float, default=None,
                   metavar="SECONDS",
                   help="SLO goodput accounting: per-token (TPOT) "
                        "threshold")
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


def validate_args(args, error) -> None:
    """The JAX CLI's own argument checks (``examples/serve_openai.py:30-125``):
    adapters neither with a packed export nor with the scan layout, each
    ``name=path`` well formed, named apart from ``--model_name``, its
    checkpoint present (before the slow base load); the scan layout
    serves contiguous KV only; a draft model needs an explicit
    ``--speculative K`` with K > 0 (``--speculative 0`` resolves to off)
    and the unrolled layout."""
    from llm_in_practise_tpu_torch.serve.adapters import parse_lora_modules
    from llm_in_practise_tpu_torch.serve.disagg import default_speculative_k

    if args.quantized_dir and args.lora_modules:
        error("--lora-modules with --quantized_dir is not supported "
              "(adapters cannot merge into packed 4-bit kernels)")
    if args.scan_layers and args.lora_modules:
        error("--lora-modules with --scan-layers is not supported: "
              "adapters merge by unrolled block_i/... kernel paths, "
              "which do not exist in the stacked tree (they would "
              "silently serve base weights)")
    if args.lora_modules:
        try:
            modules = parse_lora_modules(args.lora_modules)
        except ValueError as e:
            error(f"--lora-modules: {e}")
        for name, path in modules.items():
            if name == args.model_name:
                error(f"--lora-modules: adapter name {name!r} collides "
                      "with --model_name (the base model's served name)")
            ckpt_file = (os.path.join(path, "adapter.msgpack")
                         if os.path.isdir(path) else path)
            if not os.path.exists(ckpt_file):
                error(f"--lora-modules {name}: no adapter checkpoint at "
                      f"{path} (want adapter.msgpack + sidecar from "
                      "save_named)")
    if args.role != "both" and not args.kv_remote:
        error(f"--role {args.role} requires --kv-remote: the KV handoff "
              "between the prefill and decode pools travels through the "
              "shared kv_pool server")
    if args.kv_remote is not None:
        _host, sep, port = args.kv_remote.rpartition(":")
        if not sep or not _host or not port.isdigit():
            error(f"--kv-remote expects HOST:PORT, got {args.kv_remote!r}")
    if args.scan_layers and args.kv_layout == "paged":
        error("--scan-layers serves with --kv-layout contiguous only "
              "(the paged pool supports the unrolled cache layout; pass "
              "--kv-layout contiguous explicitly)")
    if args.draft_model_path and args.speculative is None:
        error("--draft-model-path requires --speculative K")
    # a decode replica defaults speculation on (checked after the draft's
    # explicit-K requirement, which the default must not bypass)
    if args.role == "decode" and args.speculative is None:
        print(f"decode replica: ngram speculation on by default "
              f"(k={default_speculative_k(args.role, None)}; "
              "--speculative 0 turns it off)", flush=True)
    args.speculative = default_speculative_k(args.role, args.speculative)
    # resolved once: a decode replica's explicit 0 is None from here on,
    # which build_engine must not default again
    args.speculative_resolved = True
    if args.draft_model_path and args.speculative is None:
        error("--draft-model-path with --speculative 0 is "
              "contradictory: drop the draft model or pass a "
              "positive K")
    if args.draft_model_path and args.scan_layers:
        error("--draft-model-path with --scan-layers is not supported "
              "yet, as in the JAX CLI (whose stacked target's cache has "
              "its slot axis where the unstacked draft's does not)")


def load_draft_model(path: str, device):
    """The draft model of ``--draft-model-path``: a ``model.msgpack``
    restored through the port's checkpoint reader into a dense Qwen3 built
    from its ``config``, on ``device``."""
    from llm_in_practise_tpu_torch.infer.generate import load_model

    model = load_model(path, device)
    print(f"draft model: {path}", flush=True)
    return model


def build_server(args, *, model=None, tokenizer=None):
    """Load the export or the merged model, build the model, engine and
    server (not started). ``model`` / ``tokenizer``: ones already loaded,
    served in place of ``--quantized_dir`` / ``--model_path`` and
    ``--tokenizer_path``."""
    from llm_in_practise_tpu_torch.core.device import resolve_device
    from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.infer.generate import load_model
    from llm_in_practise_tpu_torch.models.convert import params_from_jax
    from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
    from llm_in_practise_tpu_torch.quant.io import load_packed
    from llm_in_practise_tpu_torch.serve.api import OpenAIServer
    from llm_in_practise_tpu_torch.serve.quantized import QuantizedModel

    device = resolve_device(args.device)
    if args.trace_file:
        from llm_in_practise_tpu_torch.obs.trace import get_tracer

        get_tracer().set_trace_file(args.trace_file)
        print(f"chrome trace events -> {args.trace_file} (open in "
              "Perfetto)", flush=True)
    tok = (tokenizer if tokenizer is not None
           else BPETokenizer.load(args.tokenizer_path))
    if model is not None:
        print(f"model: {type(model).__name__} given by the caller",
              flush=True)
    elif args.quantized_dir:
        tree, meta = load_packed(args.quantized_dir)
        if meta.get("family", "qwen3") != "qwen3":
            raise NotImplementedError(
                f"model family {meta.get('family')!r} is not ported; the "
                "PyTorch server serves Qwen3 exports")
        cfg = Qwen3Config.from_dict(meta["config"])
        print(f"packed model: {args.quantized_dir} ({meta.get('method')}, "
              f"ppl {meta.get('ppl')})", flush=True)
        state = params_from_jax(tree, cfg)
        model = QuantizedModel(Qwen3(cfg, device="meta"), state,
                               device=device)
    else:
        model = load_model(args.model_path, device)
        print(f"model: {args.model_path}", flush=True)
    if args.scan_layers:
        print("--scan-layers: the port runs the unrolled blocks (the scan "
              "layout is a layout of the JAX param tree)", flush=True)
    draft = (load_draft_model(args.draft_model_path, device)
             if args.draft_model_path else None)
    tiered = bool(args.kv_offload or args.kv_remote)
    if tiered:
        tiers = "HBM->host" + ("->remote" if args.kv_remote else "")
        print(f"tiered KV pool: {tiers} (namespaced per model)", flush=True)
    if args.role != "both":
        print(f"disaggregated role: {args.role} (handoff via "
              f"{args.kv_remote})", flush=True)
    registry = None
    if args.lora_modules and not tiered:
        from llm_in_practise_tpu_torch.serve.multi_lora import AdapterRegistry

        registry = AdapterRegistry(model)
    eos_id = tok.token_to_id(IM_END)
    session_store = None
    if args.session_store:
        from llm_in_practise_tpu_torch.serve.sessions import SessionStore

        session_store = SessionStore(ttl_s=args.session_ttl)
        pins = ("pinned pages" if args.kv_layout == "paged"
                else "turn bookkeeping only (contiguous layout: no pages "
                     "to pin; warm turns ride the prefix cache)")
        warm = ("fleet warm path via " + args.kv_remote
                if args.kv_remote else "local pins only (no --kv-remote)")
        print(f"session store: ttl {args.session_ttl:g}s, {pins}, {warm}",
              flush=True)
    engine = build_engine(model, args, eos_id=eos_id, draft_model=draft,
                          adapter_registry=registry,
                          session_store=session_store,
                          **engine_kw_for(args, args.model_name))
    adapters = {}
    if args.lora_modules:
        from llm_in_practise_tpu_torch.serve.adapters import (
            build_adapter_engines,
            parse_lora_modules,
        )
        from llm_in_practise_tpu_torch.serve.multi_lora import AdapterHandle

        modules = parse_lora_modules(args.lora_modules)
        if registry is not None:
            for name, path in modules.items():
                registry.register(name, path)
                adapters[name] = AdapterHandle(engine, name)
            print(f"adapters (batched multi-LoRA, one shared engine): "
                  f"{sorted(adapters)}", flush=True)
        else:
            # KV tiers and handoff stores are per served model (rows are
            # valid under one weight set): an engine per adapter, each
            # with its own namespace, as in the JAX CLI. The draft stays
            # with the base engine
            kw = engine_kwargs(args, eos_id=eos_id)
            adapters = build_adapter_engines(
                model, {n: p.detach() for n, p in model.named_parameters()},
                modules, engine_kw_for=lambda name: engine_kw_for(args, name),
                **kw)
    return OpenAIServer(engine, tok, model_name=args.model_name,
                        adapters=adapters, role=args.role)


def engine_kw_for(args, model_name: str) -> dict:
    """The per-model engine knobs of the KV tiers and the disaggregated
    split (JAX ``examples/serve_openai.py`` ``make_kv_pool`` and
    ``make_handoff``): a :class:`~.kv_pool.TieredKV` of its own (host
    pool, and the pool server's ``model_name`` namespace under
    ``--kv-remote``), the role, and a handoff store in that model's
    handoff namespace."""
    from llm_in_practise_tpu_torch.serve.disagg import RemoteHandoff
    from llm_in_practise_tpu_torch.serve.kv_pool import (
        HostKVPool,
        RemoteKVClient,
        TieredKV,
    )

    kw = {"role": args.role, "kv_pool": None, "handoff": None}
    address = None
    if args.kv_remote:
        host, _, port = args.kv_remote.rpartition(":")
        address = (host, int(port))
        kw["handoff"] = RemoteHandoff(address, namespace=model_name)
    if args.kv_offload or address is not None:
        remote = (RemoteKVClient(address, namespace=model_name)
                  if address is not None else None)
        kw["kv_pool"] = TieredKV(HostKVPool(), remote)
    return kw


def engine_kwargs(args, *, eos_id: int | None) -> dict:
    """The engine knobs every served model of the CLI shares."""
    from llm_in_practise_tpu_torch.serve.disagg import default_speculative_k

    return dict(
        max_slots=args.max_slots, cache_len=args.cache_len,
        eos_id=eos_id, cache_dtype=_KV_DTYPES[args.kv_cache_dtype],
        chunked_prefill=args.chunked_prefill, decode_steps=args.decode_steps,
        mixed_step=args.mixed_step, kv_layout=args.kv_layout,
        kv_page_size=args.kv_page_size, kv_pool_tokens=args.kv_pool_tokens,
        prefix_cache=args.prefix_caching, max_queue=args.max_queue,
        queue_timeout_s=args.queue_timeout,
        ttft_slo_s=args.ttft_slo,
        tpot_slo_s=args.tpot_slo,
        speculative_k=(args.speculative
                       if getattr(args, "speculative_resolved", False)
                       else default_speculative_k(args.role,
                                                  args.speculative)))


def build_engine(model, args, *, eos_id: int | None, draft_model=None,
                 adapter_registry=None, session_store=None, **kw):
    """The engine the CLI's ``args`` describe, over a loaded model (and
    the loaded draft of ``--draft-model-path``, the registry of
    ``--lora-modules`` and the store of ``--session-store``); ``kw``:
    :func:`engine_kw_for`'s knobs."""
    from llm_in_practise_tpu_torch.serve.engine import InferenceEngine

    return InferenceEngine(
        model, **engine_kwargs(args, eos_id=eos_id), **kw,
        draft_model=draft_model, adapter_registry=adapter_registry,
        session_store=session_store)


def main(argv=None) -> None:
    from llm_in_practise_tpu_torch.obs.logging import setup_logging

    setup_logging()
    parser = build_parser()
    args = parser.parse_args(argv)
    validate_args(args, parser.error)
    check_not_ported(args)
    server = build_server(args)
    print(f"serving {args.quantized_dir or args.model_path} on "
          f"{args.host}:{args.port} "
          f"({server.engine.device}; /v1/chat/completions, "
          "/v1/embeddings, /v1/models, /health, /metrics, /debug/kv, "
          "/debug/sessions, /debug/hbm, /debug/requests, /debug/traces, "
          "POST /debug/profile, the chat page at /)", flush=True)
    server.serve(host=args.host, port=args.port)


if __name__ == "__main__":
    main()
