#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 (or another CUDA card).

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:

1. Identify the card (``nvidia-smi`` name and power limit).
2. Build every CUDA kernel of the port from ``llm_in_practise_tpu_torch/csrc``
   (one nvcc per source, all started together).
3. Check each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it, and time kernel, plain version and
   one library call (CUDA events, L2 flushed before every launch).
4. Serve: a Qwen3-8B-width model (hidden 4096, inter 12288, 32/8 heads,
   head_dim 128, vocab 151936, tied embeddings) with random weights from a
   seeded generator, every block projection quantized to NF4, behind the
   port's OpenAI server on 127.0.0.1. Eight concurrent chat requests (four
   streamed) run through the HTTP API; the kernels' launch counters are
   zeroed just before and read just after, and must show the kernel ran
   for every projection of every forward pass.
5. Print the kernel summary, the card, and the final status line.

Needs the repository checkout beside it (it imports the port) and CUDA.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time
import types
import urllib.request

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_BF16_OPS_PER_S = 989e12   # dense bf16 tensor-core rate, data sheet
KERNEL_TOL = 1e-2              # max|kernel - plain| <= KERNEL_TOL * max|plain|
# whole-model logits, kernels vs plain versions, 36 random bf16 layers:
# measured 0.035 to 0.046 * max|plain| (seed 0, H100 80GB HBM3, 700 W);
# a wrong nibble, codebook entry or absmax block decorrelates the logits
# (error ~ 1 * max|plain|)
MODEL_TOL = 1e-1
QWEN3_8B = dict(vocab_size=151936, hidden_size=4096, intermediate_size=12288,
                n_head=32, n_kv_head=8, head_dim=128, rope_theta=1e6,
                tie_word_embeddings=True, compute_dtype="bfloat16")
PROJ_SHAPES = {  # Qwen3-8B block projections: name -> (K, N)
    "q_proj": (4096, 4096), "k_proj": (4096, 1024), "v_proj": (4096, 1024),
    "out_proj": (4096, 4096), "gate_proj": (4096, 12288),
    "up_proj": (4096, 12288), "down_proj": (12288, 4096)}
CHECK_M = (1, 8, 512)
N_LAYER = 36    # full depth of Qwen3-8B
MAX_SLOTS = 8
CACHE_LEN = 1024
MAX_TOKENS = 64


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, flush) -> float:
    """Median device time of ``fn`` in ms, L2 flushed before each launch."""
    import torch

    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def nf4_bound(m: int, k: int, n: int) -> tuple[float, str, int]:
    """Least time on the card: every input read once (x bf16, packed
    bytes, double-quantized absmax, its scales and offset), the output
    written once, against 2*M*K*N bf16 tensor-core operations."""
    nbytes = (m * k * 2 + k * n // 2 + k * n // 64
              + 4 * -(-(k * n // 64) // 256) + 4 + m * n * 2)
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 2 * m * k * n / H100_BF16_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", nbytes
    return t_ops * 1e3, "operations", nbytes


def check_nf4_kernel(seed: int) -> dict:
    """Kernel vs plain version at the serving shapes; returns the summary."""
    import torch

    from llm_in_practise_tpu_torch.ops.nf4_matmul import (
        nf4_matmul,
        nf4_matmul_reference,
        split_k_for,
    )
    from llm_in_practise_tpu_torch.quant import nf4

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, by_shape = [], {}
    for k, n in sorted(set(PROJ_SHAPES.values())):
        t = nf4.quantize(torch.randn(k, n, device=dev, generator=gen) * 0.02)
        w_bf16 = nf4.dequantize(t, torch.bfloat16)  # library yardstick only
        for m in CHECK_M:
            x = torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
            out = nf4_matmul(x, t, torch.bfloat16)
            ref = nf4_matmul_reference(x, t, torch.bfloat16)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            ok = bool(torch.isfinite(out).all().item()) and err <= KERNEL_TOL * scale
            bound_ms, bound_by, nbytes = nf4_bound(m, k, n)
            row = {
                "kernel": "nf4_matmul", "M": m, "K": k, "N": n,
                "split_k": split_k_for(m, k, n, sms),
                "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
                "tol": f"{KERNEL_TOL} * max|plain| (summation order; bf16 "
                       "output rounding)",
                "ms": time_ms(lambda: nf4_matmul(x, t, torch.bfloat16), 20,
                              flush),
                "plain_ms": time_ms(
                    lambda: nf4_matmul_reference(x, t, torch.bfloat16), 5,
                    flush),
                "library_ms": time_ms(lambda: torch.matmul(x, w_bf16), 20,
                                      flush),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": nbytes, "ok": ok,
            }
            log(json.dumps(row))
            rows.append(row)
            by_shape[(m, k, n)] = row
            if not ok:
                raise SystemExit(f"nf4_matmul disagrees with its plain "
                                 f"version at M={m} K={k} N={n}: {err}")
        del t, w_bf16
    # the summary: one decode step of one layer, all 7 projections at
    # M = max_slots (the engine decodes every slot in one batch)
    step = [by_shape[(MAX_SLOTS, k, n)] for k, n in PROJ_SHAPES.values()]
    return {
        "name": "nf4_matmul", "route": "cuda",
        "source": "llm_in_practise_tpu_torch/csrc/nf4_matmul.cu",
        "replaces": "llm_in_practise_tpu/ops/nf4_matmul.py:84",
        "tpu_function": "_fwd_kernel (pallas_call at :169)",
        "at": f"one layer's 7 projections at M={MAX_SLOTS} (decode step)",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in step),
        "plain_ms": sum(r["plain_ms"] for r in step),
        "bound_ms": sum(r["bound_ms"] for r in step),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in step)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in step),
        "shapes_checked": len(rows), "ok": all(r["ok"] for r in rows),
    }


def build_model(n_layer: int, seed: int):
    """Qwen3-8B width, random weights from a seeded generator on the card,
    block projections quantized to NF4 by the port's codec."""
    import torch

    from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
    from llm_in_practise_tpu_torch.quant import nf4
    from llm_in_practise_tpu_torch.serve.quantized import QuantizedModel

    dev = torch.device("cuda", 0)
    cfg = Qwen3Config(n_layer=n_layer, max_seq_len=CACHE_LEN, **QWEN3_8B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, bf16 = cfg.hidden_size, torch.bfloat16
    state = {"tok_embed.weight": (torch.randn(cfg.vocab_size, d, device=dev,
                                              generator=gen) * 0.02).to(bf16),
             "ln_f.scale": torch.ones(d, device=dev, dtype=bf16)}
    for i in range(n_layer):
        p = f"blocks.{i}"
        for name in ("ln1", "ln2"):
            state[f"{p}.{name}.scale"] = torch.ones(d, device=dev, dtype=bf16)
        for name in ("q_norm", "k_norm"):
            state[f"{p}.attn.{name}.scale"] = torch.ones(
                cfg.head_dim, device=dev, dtype=bf16)
        for name, (k, n) in PROJ_SHAPES.items():
            sub = "mlp" if name in ("gate_proj", "up_proj", "down_proj") \
                else "attn"
            w = torch.randn(k, n, device=dev, generator=gen) * 0.02
            state[f"{p}.{sub}.{name}.kernel"] = nf4.quantize(w)
    model = QuantizedModel(Qwen3(cfg, device="meta"), state, device=dev)
    return cfg, model


def model_check(model, tok_ids) -> dict:
    """Whole-model logits on a small input: kernels vs plain versions."""
    import torch

    from llm_in_practise_tpu_torch.ops.nf4_matmul import nf4_matmul_reference
    from llm_in_practise_tpu_torch.serve.quantized import NF4Linear

    def plain_forward(self, x):
        y = nf4_matmul_reference(x.to(self.compute_dtype), self.weight,
                                 self.compute_dtype)
        return y.to(x.dtype)

    ids = torch.tensor([tok_ids], device=model.device)
    with torch.inference_mode():
        got = model(ids).float()
        linears = [m for m in model.modules() if isinstance(m, NF4Linear)]
        for m in linears:
            m.forward = types.MethodType(plain_forward, m)
        try:
            want = model(ids).float()
        finally:
            for m in linears:
                del m.forward
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    res = {"shape": list(got.shape), "finite": bool(torch.isfinite(got).all()),
           "max_abs_err": err, "max_rel_err": err / scale,
           "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                 .float().mean()),
           "tol": f"{MODEL_TOL} * max|plain|: bf16 activations between "
                  "layers carry the kernels' summation-order differences "
                  "through every layer"}
    if not res["finite"] or err > MODEL_TOL * scale:
        raise SystemExit(f"model logits disagree with the plain path: {res}")
    return res


def post_chat(base: str, body: dict) -> dict:
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise SystemExit(f"HTTP {r.status}")
        if not body.get("stream"):
            out = json.loads(r.read())
            return {"content": out["choices"][0]["message"]["content"],
                    "finish_reason": out["choices"][0]["finish_reason"],
                    "usage": out["usage"], "wall_s": time.monotonic() - t0}
        lines = r.read().decode().split("\n")
    data = [ln[len("data: "):] for ln in lines if ln.startswith("data: ")]
    if data[-1] != "[DONE]":
        raise SystemExit("stream did not end with data: [DONE]")
    events = [json.loads(d) for d in data[:-1]]
    if any("error" in e for e in events):
        raise SystemExit(f"stream carried an error: {events}")
    return {"content": "".join(e["choices"][0]["delta"].get("content", "")
                               for e in events),
            "finish_reason": events[-1]["choices"][0]["finish_reason"],
            "done": True, "wall_s": time.monotonic() - t0}


def serve_phase(n_layer: int, seed: int, card: str) -> dict:
    import torch

    from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
    from llm_in_practise_tpu_torch.data.sft import IM_END, IM_START
    from llm_in_practise_tpu_torch.ops.nf4_matmul import nf4_matmul
    from llm_in_practise_tpu_torch.serve.api import OpenAIServer
    from llm_in_practise_tpu_torch.serve.engine import InferenceEngine

    t0 = time.monotonic()
    # a reference text that PRs do not edit, so the prompts' token ids stay
    # the same from one run to the next
    survey = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "SURVEY.md")
    with open(survey, encoding="utf-8") as f:
        corpus = f.read()
    tok = BPETokenizer.train([corpus], vocab_size=2000,
                             special_tokens=[IM_START, IM_END])
    log(f"tokenizer: BPE trained on SURVEY.md, vocab {tok.get_vocab_size()} "
        f"({time.monotonic() - t0:.1f}s)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    cfg, model = build_model(n_layer, seed)
    torch.cuda.synchronize()
    log(f"model: Qwen3-8B width, {n_layer} layers, NF4 block projections, "
        f"built and quantized in {time.monotonic() - t0:.1f}s")
    mcheck = model_check(model, tok.encode("The port serves Qwen3 on Hopper."))
    log("model check:", json.dumps(mcheck))

    engine = InferenceEngine(model, max_slots=MAX_SLOTS, cache_len=CACHE_LEN,
                             eos_id=tok.token_to_id(IM_END),
                             cache_dtype=torch.bfloat16, seed=seed)
    seen = []
    submit = engine.submit

    def recording_submit(*args, **kwargs):
        req = submit(*args, **kwargs)
        seen.append(req)
        return req

    engine.submit = recording_submit
    server = OpenAIServer(engine, tok, model_name="qwen3-8b-nf4")
    port = server.serve(host="127.0.0.1", port=0, background=True)
    base = f"http://127.0.0.1:{port}"
    topics = ["the KV cache", "NF4 quantization", "continuous batching",
              "rotary embeddings", "grouped-query attention", "SwiGLU",
              "the OpenAI API", "Hopper tensor cores"]

    def body(i, stream):
        return {"model": "qwen3-8b-nf4", "temperature": 0.0,
                "max_tokens": MAX_TOKENS, "stream": stream, "messages": [
                    {"role": "system", "content": "You are a helpful assistant."},
                    {"role": "user", "content": f"Explain {topics[i]} in a "
                                                "few sentences."}]}

    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            if json.loads(r.read()) != {"status": "ok"}:
                raise SystemExit("/health did not answer ok")
        post_chat(base, body(0, False))  # warm-up, outside the counted run
        torch.cuda.synchronize()
        seen.clear()
        nf4_matmul.launches = 0
        steps0 = engine.decode_steps_run + engine.prefill_batches_run
        t_run = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(MAX_SLOTS) as pool:
            futs = [pool.submit(post_chat, base, body(i, i % 2 == 1))
                    for i in range(MAX_SLOTS)]
            results = [f.result() for f in futs]
        wall = time.monotonic() - t_run
        forwards = engine.decode_steps_run + engine.prefill_batches_run - steps0
        launches = nf4_matmul.launches
        reqs = list(seen)
        # repeat request 0 alone, twice: greedy decoding is deterministic
        rep = []
        for _ in range(2):
            seen.clear()
            post_chat(base, body(0, False))
            rep.append(list(seen[0].output_ids))
    finally:
        server.shutdown()

    if engine.error is not None:
        raise SystemExit(f"engine failed: {engine.error!r}")
    if len(results) != MAX_SLOTS or sum(r.get("done", False)
                                        for r in results) != MAX_SLOTS // 2:
        raise SystemExit("not every request completed / streamed")
    for r in results:
        if r["finish_reason"] not in ("stop", "length") or not r["content"]:
            raise SystemExit(f"bad response: {r}")
    if any(rq.n_generated < 1 for rq in reqs) or len(reqs) != MAX_SLOTS:
        raise SystemExit("engine saw a request produce no tokens")
    per_forward = 7 * n_layer
    if launches == 0 or launches != per_forward * forwards:
        raise SystemExit(f"nf4_matmul launches {launches} != 7 x {n_layer} "
                         f"x {forwards} forward passes")
    if rep[0] != rep[1] or not rep[0]:
        raise SystemExit("the repeated greedy request changed its tokens")
    first = sorted(reqs, key=lambda r: r.uid)[0]
    gen_tokens = sum(r.n_generated for r in reqs)
    t_first = min(r.first_token_time for r in reqs)
    t_last = max(r.finish_time for r in reqs)
    out = {
        "card": card, "layers": n_layer, "max_slots": MAX_SLOTS,
        "cache_len": CACHE_LEN, "kv_dtype": "bfloat16",
        "requests": len(reqs), "streamed": MAX_SLOTS // 2,
        "completion_tokens": gen_tokens,
        "wall_s": wall,
        "decode_tok_s": sum(r.n_generated - 1 for r in reqs)
        / max(t_last - t_first, 1e-9),
        "ttft_p50_s": statistics.median(r.ttft_s for r in reqs),
        "tpot_p50_s": statistics.median(r.tpot_s for r in reqs
                                        if r.tpot_s is not None),
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "forward_passes": forwards, "nf4_launches": launches,
        "nf4_launches_per_forward": per_forward,
        "repeat_identical": rep[0] == rep[1],
        "repeat_matches_batched_run": rep[0] == first.output_ids,
        "model_check": mcheck,
    }
    log("serve:", json.dumps(out))
    out["decode_profile"] = profile_decode(
        engine, [r.prompt_ids for r in reqs])
    log("decode profile:", json.dumps(out["decode_profile"]))
    return {"launches": launches, "serve": out}


def profile_decode(engine, prompts, steps: int = 16) -> dict:
    """Where a decode step's time goes, after the counted run: the wall
    time of ``steps`` engine steps over a full batch (no profiler), and the
    device time of their kernels (torch.profiler, a second window).
    Kernels run on one stream, so their summed time is the device's busy
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from llm_in_practise_tpu_torch.serve.engine import SamplingParams

    params = SamplingParams(greedy=True, max_tokens=2 * steps + 4)
    for ids in prompts:
        engine.submit(ids, params)
    engine.step()  # admission, prefill and one decode: outside both windows
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us == 0:
        return {"step_wall_ms": wall_ms, "device_ms": "not measured"}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    nf4_us = sum(e.self_device_time_total for e in kernels
                 if "nf4_matmul" in e.key or "splitk_reduce" in e.key)
    return {
        "batch": len(prompts), "steps": steps,
        "step_wall_ms": wall_ms,
        "step_device_ms": device_us / 1e3 / steps,
        "device_busy_share": device_us / 1e3 / steps / wall_ms,
        "nf4_share_of_device": nf4_us / device_us,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "top_kernels_ms_per_step": {
            e.key[:60]: e.self_device_time_total / 1e3 / steps for e in top},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    # the port lives beside this script; without it there is nothing to run
    from llm_in_practise_tpu_torch.ops import _build

    t_start = time.monotonic()
    card = card_line()
    log("card:", card, "|", torch.cuda.get_device_name(0),
        "| torch", torch.__version__, "cuda", torch.version.cuda)
    log(f"build: {_build.build_all():.1f}s (nvcc, sm_90a)")
    summary = check_nf4_kernel(args.seed)
    served = serve_phase(N_LAYER, args.seed, card)
    summary["launches"] = served["launches"]
    log(json.dumps({"kernels": [summary]}))
    log(f"total {time.monotonic() - t_start:.1f}s")
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
