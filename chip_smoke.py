#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 (or another CUDA card).

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:

1. Identify the card (``nvidia-smi`` name and power limit).
2. Build every CUDA kernel of the port from ``llm_in_practise_tpu_torch/csrc``
   (one nvcc per source, all started together).
3. Check the NF4 forward kernel against its plain PyTorch version on the
   card at the shapes the serving path gives it, and time kernel, plain
   version and one library call (CUDA events, L2 flushed before every
   launch).
4. Serve: a Qwen3-8B-width model (hidden 4096, inter 12288, 32/8 heads,
   head_dim 128, vocab 151936, tied embeddings) with random weights from a
   seeded generator, every block projection quantized to NF4, behind the
   port's OpenAI server on 127.0.0.1. Eight concurrent chat requests (four
   streamed) run through the HTTP API; the kernels' launch counters are
   zeroed just before and read just after, and must show the kernel ran
   for every projection of every forward pass.
5. Training kernels: the NF4 forward and backward at M = 8192 for every
   Qwen3-8B projection shape, and the three flash kernels (forward, dK/dV,
   dQ) at batch 8 x 1024 tokens, 32/8 heads, plus a ragged length, each
   against its plain version (the flash outputs tile by tile, and a
   planted zeroed dV tile must read as a failure) and timed as in
   phase 3.
6. Whole step: one QLoRA step at full width, 2 layers, batch 2 x 1024,
   with the kernels and again with every kernel swapped for its plain
   version; the loss and every LoRA gradient must agree.
7. Train: QLoRA on Qwen3-8B (36 layers, NF4 base, LoRA r 8 on q/v_proj,
   remat on every block, fused cross-entropy over the tied embedding,
   AdamW lr 1e-4), batch 8 x 1024 random tokens: one warm-up step, then
   timed steps with the launch counters zeroed before and read after;
   every kernel's launches per step must equal the count derived from
   the model, and one more step is profiled.
8. Print the kernel summary, the card, and the final status line.

Needs the repository checkout beside it (it imports the port) and CUDA.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import gc
import json
import math
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
# training (bench.py: SEQ = 1024, the 8B rung; LoRA r 8 / alpha 16 on
# q_proj, v_proj; fused CE chunk 2048, vocab_chunk 8192; AdamW 1e-4)
TRAIN_BATCH = 8
TRAIN_SEQ = 1024
TRAIN_STEPS = 4          # timed, after one warm-up step
TRAIN_M = TRAIN_BATCH * TRAIN_SEQ
LORA_R, LORA_ALPHA = 8, 16.0
CE_CHUNK, CE_VOCAB_CHUNK = 2048, 8192
TRAIN_LR = 1e-4
# flash kernels vs their f32 plain versions: O and the gradients are
# bf16, and P and dS are rounded to bf16 for the tensor-core products
# (2**-9 relative each); LSE is f32 from exact bf16 products. The error is
# held tile by tile: in every FLASH_TILE-row slab of one (batch, head),
# max|kernel - plain| <= FLASH_TOL * max|plain| of that slab, so the large
# early rows of O and dV (row 0 of O is v[0]) set no limit for the small
# late ones; a zeroed or unmasked tile reads 1 there.
FLASH_TILE = 64
FLASH_TOL = 2e-2
LSE_TOL = 1e-3           # absolute, natural-log units
# whole QLoRA step, kernels vs plain versions, 2 layers at full width:
# bf16 activations carry the kernels' summation-order differences (bf16
# rounding noise) through the forward and the backward of both layers.
# Readings (seed 0, H100 80GB HBM3, 700 W): loss 4.9e-5 relative, LoRA
# gradients 2.2e-2 of max|plain|. The loss at random init is about
# ln(vocab) whatever the layers compute, so the gradients decide; the
# loss limit only catches a gross fault.
STEP_LOSS_TOL = 1e-3     # relative
STEP_GRAD_TOL = 5e-2     # max|kernel - plain| <= STEP_GRAD_TOL * max|plain|
STEP_LAYERS, STEP_BATCH = 2, 2


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


def flash_bound(b: int, length: int, h: int, d: int, products: int,
                nbytes: int) -> tuple[float, str, int]:
    """Least time on the card for a causal flash kernel: ``products``
    (L x D)-by-(D x L) products at 2 operations per multiply-add, over the
    live (lower-triangle) query/key pairs only, against ``nbytes`` read and
    written once."""
    ops = products * 2 * b * h * (length * (length + 1) // 2) * d
    t_ops = ops / H100_BF16_OPS_PER_S
    t_bytes = nbytes / H100_BYTES_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", nbytes
    return t_ops * 1e3, "operations", nbytes


def _rel(a, b) -> tuple[float, float]:
    err = (a.float() - b.float()).abs().max().item()
    return err, err / max(b.float().abs().max().item(), 1e-30)


def tile_err(got, want) -> dict:
    """``got`` against ``want``, both (B, L, heads, D): the largest of
    max|got - want| / max|want| over every FLASH_TILE-row slab of one
    (batch, head) (``tile_rel``, the criterion), the norm ratio
    ||got - want|| / ||want|| and the largest absolute error."""
    import torch

    diff = (got.float() - want.float()).abs()
    ref = want.float().abs()
    b, length, h, d = ref.shape
    pad = -length % FLASH_TILE
    if pad:  # the ragged last slab: zero rows add nothing to either max
        diff, ref = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                     for x in (diff, ref))
    tiles = (b, (length + pad) // FLASH_TILE, FLASH_TILE, h, d)
    tile_diff = diff.reshape(tiles).amax(dim=(2, 4))
    tile_ref = ref.reshape(tiles).amax(dim=(2, 4)).clamp_min(1e-30)
    norm_rel = (torch.linalg.vector_norm(got.float() - want.float())
                / torch.linalg.vector_norm(want.float())).item()
    return {"tile_rel": (tile_diff / tile_ref).max().item(),
            "norm_rel": norm_rel, "max_abs": diff.max().item()}


def check_train_nf4(seed: int, flush) -> dict:
    """The NF4 forward and backward kernels at M = 8192 for every Qwen3-8B
    projection shape."""
    import torch

    from llm_in_practise_tpu_torch.ops.nf4_matmul import (
        nf4_matmul,
        nf4_matmul_backward,
        nf4_matmul_backward_reference,
        nf4_matmul_reference,
    )
    from llm_in_practise_tpu_torch.quant import nf4

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    rows = {}
    for k, n in sorted(set(PROJ_SHAPES.values())):
        t = nf4.quantize(torch.randn(k, n, device=dev, generator=gen) * 0.02)
        w_bf16 = nf4.dequantize(t, torch.bfloat16)  # library yardstick only
        x = torch.randn(TRAIN_M, k, device=dev, generator=gen).to(
            torch.bfloat16)
        dy = torch.randn(TRAIN_M, n, device=dev, generator=gen).to(
            torch.bfloat16)
        bound_ms, bound_by, nbytes = nf4_bound(TRAIN_M, k, n)
        for kernel, fn, plain, lib, inp in (
                ("nf4_matmul", nf4_matmul, nf4_matmul_reference,
                 lambda: torch.matmul(x, w_bf16), x),
                ("nf4_matmul_backward", nf4_matmul_backward,
                 nf4_matmul_backward_reference,
                 lambda: torch.matmul(dy, w_bf16.T), dy)):
            out = fn(inp, t, torch.bfloat16)
            ref = plain(inp, t, torch.bfloat16)
            torch.cuda.synchronize()
            err, rel = _rel(out, ref)
            ok = bool(torch.isfinite(out).all().item()) and rel <= KERNEL_TOL
            row = {
                "kernel": kernel, "M": TRAIN_M, "K": k, "N": n,
                "max_abs_err": err, "max_rel_err": rel,
                "tol": f"{KERNEL_TOL} * max|plain| (summation order; bf16 "
                       "output rounding)",
                "ms": time_ms(lambda: fn(inp, t, torch.bfloat16), 10, flush),
                "plain_ms": time_ms(
                    lambda: plain(inp, t, torch.bfloat16), 3, flush),
                "library_ms": time_ms(lib, 10, flush),
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                "ok": ok,
            }
            log(json.dumps(row))
            rows[(kernel, k, n)] = row
            if not ok:
                raise SystemExit(f"{kernel} disagrees with its plain version "
                                 f"at M={TRAIN_M} K={k} N={n}: {rel}")
            del out, ref
        del t, w_bf16, x, dy
    return rows


def layer_sum(rows: dict, kernel: str) -> dict:
    """One layer's 7 projections at M = 8192, summed."""
    step = [rows[(kernel, k, n)] for k, n in PROJ_SHAPES.values()]
    return {
        "at": f"one layer's 7 projections at M={TRAIN_M} (training)",
        "max_abs_err": max(r["max_abs_err"] for r in step),
        "ms": sum(r["ms"] for r in step),
        "plain_ms": sum(r["plain_ms"] for r in step),
        "bound_ms": sum(r["bound_ms"] for r in step),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in step)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in step),
    }


def check_flash(seed: int, flush) -> dict:
    """The flash forward, dK/dV and dQ kernels against their plain
    versions at the training shape (8 x 1024, 32/8 heads, head_dim 128:
    16 key tiles, so the online softmax and the dK/dV loop run over many
    tiles) and a ragged length (1000: the last tile is masked); timed at
    the training shape, with SDPA as the library yardstick."""
    import torch
    import torch.nn.functional as F

    from llm_in_practise_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    n_head, n_kv, d = QWEN3_8B["n_head"], QWEN3_8B["n_kv_head"], \
        QWEN3_8B["head_dim"]
    scale = d ** -0.5
    checks, out = [], {}
    for b, length in ((TRAIN_BATCH, TRAIN_SEQ), (2, 1000)):
        def rnd(h):
            return torch.randn(b, length, h, d, device=dev,
                               generator=gen).to(torch.bfloat16)

        q, k, v, do = rnd(n_head), rnd(n_kv), rnd(n_kv), rnd(n_head)
        o, lse = fa.flash_forward(q, k, v, scale)
        ro, rlse = fa.flash_forward_reference(q, k, v, scale)
        q2, k2, v2, do2, lse2, delta = fa.backward_inputs(q, k, v, o, lse,
                                                          do)
        dk, dv = fa.flash_backward_dkv(q2, k2, v2, do2, lse2, delta, scale)
        dq = fa.flash_backward_dq(q2, k2, v2, do2, lse2, delta, scale)
        rq, rk, rv = fa.flash_backward_reference(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        res = {"B": b, "L": length, "H": n_head, "Hkv": n_kv, "D": d,
               "tile": FLASH_TILE, "o": tile_err(o, ro),
               "lse_abs": (lse - rlse).abs().max().item(),
               "dq": tile_err(dq, rq), "dk": tile_err(dk, rk),
               "dv": tile_err(dv, rv),
               "tol": f"tile_rel {FLASH_TOL}: max|kernel - plain| over "
                      f"max|plain| in every {FLASH_TILE}-row tile of one "
                      f"(batch, head); LSE {LSE_TOL} absolute"}
        # the check must see a planted fault: dV with its last key tile
        # (the smallest values, and the ragged one at L = 1000) zeroed
        dv_bad = dv.clone()
        dv_bad[:, (length - 1) // FLASH_TILE * FLASH_TILE:] = 0
        res["planted_dv_tile_zeroed"] = tile_err(dv_bad, rv)
        del dv_bad
        res["ok"] = (all(res[x]["tile_rel"] <= FLASH_TOL
                         for x in ("o", "dq", "dk", "dv"))
                     and res["lse_abs"] <= LSE_TOL
                     and all(bool(torch.isfinite(t).all())
                             for t in (o, lse, dq, dk, dv)))
        log("flash check:", json.dumps(res))
        checks.append(res)
        if not res["ok"]:
            raise SystemExit(f"flash kernels disagree with their plain "
                             f"versions: {res}")
        if res["planted_dv_tile_zeroed"]["tile_rel"] <= FLASH_TOL:
            raise SystemExit("the flash check does not see a zeroed dV "
                             f"tile: {res['planted_dv_tile_zeroed']}")
        del ro, rlse, rq, rk, rv
        if (b, length) != (TRAIN_BATCH, TRAIN_SEQ):
            continue
        # timing at the training shape; SDPA is the library yardstick
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
        do_t = do.transpose(1, 2)

        def sdpa_forward():
            with torch.no_grad():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)

        vec = b * n_head * length * 4
        qb = b * length * n_head * d * 2
        kvb = b * length * n_kv * d * 2
        rows = {
            "flash_forward": (
                lambda: fa.flash_forward(q, k, v, scale),
                lambda: fa.flash_forward_reference(q, k, v, scale),
                sdpa_forward,
                flash_bound(b, length, n_head, d, 2, 2 * qb + 2 * kvb + vec)),
            "flash_backward_dkv": (
                lambda: fa.flash_backward_dkv(q2, k2, v2, do2, lse2, delta,
                                              scale),
                lambda: fa.flash_backward_reference(q, k, v, o, lse, do,
                                                    scale),
                lambda: torch.autograd.grad(sdpa, (qt, kt, vt), do_t,
                                            retain_graph=True),
                flash_bound(b, length, n_head, d, 4,
                            2 * qb + 4 * kvb + 2 * vec)),
            "flash_backward_dq": (
                lambda: fa.flash_backward_dq(q2, k2, v2, do2, lse2, delta,
                                             scale),
                lambda: fa.flash_backward_reference(q, k, v, o, lse, do,
                                                    scale),
                lambda: torch.autograd.grad(sdpa, (qt, kt, vt), do_t,
                                            retain_graph=True),
                flash_bound(b, length, n_head, d, 3,
                            3 * qb + 2 * kvb + 2 * vec)),
        }
        for name, (fn, plain, lib, bound) in rows.items():
            out[name] = {
                "ms": time_ms(fn, 10, flush),
                "plain_ms": time_ms(plain, 3, flush),
                "library_ms": time_ms(lib, 10, flush),
                "bound_ms": bound[0], "bound_by": bound[1],
                "bytes": bound[2],
                "at": f"B={b} L={length} H={n_head} Hkv={n_kv} D={d}, "
                      "causal",
            }
            log(json.dumps({"kernel": name, **out[name]}))
        for name in ("flash_backward_dkv", "flash_backward_dq"):
            out[name]["library_covers"] = (
                "SDPA backward: dq, dk and dv together (compare with "
                "flash_backward_dkv + flash_backward_dq)")
        del qt, kt, vt, sdpa
    outputs = {"flash_forward": ("o",), "flash_backward_dkv": ("dk", "dv"),
               "flash_backward_dq": ("dq",)}
    for name, keys in outputs.items():
        out[name]["checks"] = checks
        out[name]["max_abs_err"] = max(c[x]["max_abs"] for c in checks
                                       for x in keys)
    return out


def build_qlora(n_layer: int, seed: int, *, lora_b_std: float = 0.0):
    """QLoRA on a Qwen3-8B-width base with random weights from a seeded
    generator on the card: the block kernels go through the port's
    ``quantize_base`` layer by layer (the f32 weights of one layer exist at
    a time), the embedding and norms stay bf16, LoRA factors come from
    ``init_lora`` (A ~ N(0, 0.02), B zeros unless ``lora_b_std``)."""
    import torch

    from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
    from llm_in_practise_tpu_torch.peft.fused import QLoRAModel
    from llm_in_practise_tpu_torch.peft.lora import LoRAConfig, init_lora
    from llm_in_practise_tpu_torch.peft.qlora import quantize_base

    dev = torch.device("cuda", 0)
    cfg = Qwen3Config(n_layer=n_layer, max_seq_len=TRAIN_SEQ, remat=True,
                      **QWEN3_8B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, bf16 = cfg.hidden_size, torch.bfloat16
    state = {"tok_embed.weight": (torch.randn(cfg.vocab_size, d, device=dev,
                                              generator=gen) * 0.02).to(bf16),
             "ln_f.scale": torch.ones(d, device=dev, dtype=bf16)}
    for i in range(n_layer):
        p = f"blocks.{i}"
        layer = {f"{p}.{name}.scale": torch.ones(d, device=dev, dtype=bf16)
                 for name in ("ln1", "ln2")}
        for name in ("q_norm", "k_norm"):
            layer[f"{p}.attn.{name}.scale"] = torch.ones(
                cfg.head_dim, device=dev, dtype=bf16)
        for name, (k, n) in PROJ_SHAPES.items():
            sub = "mlp" if name in ("gate_proj", "up_proj", "down_proj") \
                else "attn"
            layer[f"{p}.{sub}.{name}.kernel"] = torch.randn(
                k, n, device=dev, generator=gen) * 0.02
        state.update(quantize_base(layer))
    lcfg = LoRAConfig(r=LORA_R, alpha=LORA_ALPHA,
                      target_patterns=("q_proj", "v_proj"))
    lora = init_lora(state, lcfg, gen)
    if lora_b_std:
        for ab in lora.values():
            ab["b"].normal_(0.0, lora_b_std, generator=gen)
    model = QLoRAModel(Qwen3(cfg, device="meta"), state, lora, lcfg,
                       device=dev)
    return cfg, model


def plain_kernels():
    """Swap every kernel of the training path for its plain version (as
    ``model_check`` swaps ``NF4Linear.forward``); returns the undo."""
    import torch

    import llm_in_practise_tpu_torch.ops.attention as attention
    import llm_in_practise_tpu_torch.serve.quantized as quantized
    from llm_in_practise_tpu_torch.ops import flash_attention as fa
    from llm_in_practise_tpu_torch.ops import nf4_matmul as nm

    class PlainNF4(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, t, out_dtype):
            ctx.t, ctx.x_dtype = t, x.dtype
            return nm.nf4_matmul_reference(x, t, out_dtype)

        @staticmethod
        def backward(ctx, dy):
            dx = None
            if ctx.needs_input_grad[0]:
                dx = nm.nf4_matmul_backward_reference(dy, ctx.t, ctx.x_dtype)
            return dx, None, None

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, scale):
            out, lse = fa.flash_forward_reference(q, k, v, scale)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.scale = scale
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, out, lse = ctx.saved_tensors
            return (*fa.flash_backward_reference(q, k, v, out, lse, dout,
                                                 ctx.scale), None)

    def nf4_plain(x, t, out_dtype=None):
        if torch.is_grad_enabled() and x.requires_grad:
            return PlainNF4.apply(x, t, out_dtype)
        return nm.nf4_matmul_reference(x, t, out_dtype)

    def flash_plain(q, k, v, *, causal=True, scale=None):
        return PlainFlash.apply(q, k, v, q.shape[-1] ** -0.5
                                if scale is None else scale)

    saved = (quantized.nf4_matmul, attention.flash_attention)
    quantized.nf4_matmul, attention.flash_attention = nf4_plain, flash_plain

    def undo():
        quantized.nf4_matmul, attention.flash_attention = saved

    return undo


def kernel_counters() -> dict:
    from llm_in_practise_tpu_torch.ops import flash_attention as fa
    from llm_in_practise_tpu_torch.ops import nf4_matmul as nm

    return {"nf4_matmul": nm.nf4_matmul,
            "nf4_matmul_backward": nm.nf4_matmul_backward,
            "flash_forward": fa.flash_forward,
            "flash_backward_dkv": fa.flash_backward_dkv,
            "flash_backward_dq": fa.flash_backward_dq}


def zero_counters() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counters() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def expected_launches(n_layer: int) -> dict:
    """Kernel launches of one QLoRA training step, derived from the model.
    The 7 NF4 projections of a block run forward once, and again in the
    remat recompute, except the last one: PyTorch's non-reentrant
    checkpoint stops recomputing once every tensor the backward needs is
    rebuilt, and down_proj saves none (the frozen NF4 weight is not a
    saved tensor), so 13 per block. They run backward wherever their
    input needs a gradient: everywhere but layer 0's q/k/v, whose input
    (the frozen embedding) needs none. Attention runs forward twice and
    backward once per block."""
    return {"nf4_matmul": (7 + 6) * n_layer,
            "nf4_matmul_backward": 7 * n_layer - 3,
            "flash_forward": 2 * n_layer,
            "flash_backward_dkv": n_layer,
            "flash_backward_dq": n_layer}


def step_check(seed: int) -> dict:
    """One QLoRA step at full width, 2 layers, batch 2 x 1024, with the
    kernels and with their plain versions: loss and LoRA gradients. The
    LoRA B factors are drawn non-zero here, so every factor has a
    gradient (with B = 0 the gradients of A vanish)."""
    import torch

    from llm_in_practise_tpu_torch.train.step import make_fused_ce_loss

    cfg, model = build_qlora(STEP_LAYERS, seed + 3, lora_b_std=0.02)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed + 4)
    x = torch.randint(0, cfg.vocab_size, (STEP_BATCH, TRAIN_SEQ),
                      generator=gen, device=model.device)
    batch = (x, torch.roll(x, -1, dims=1))
    loss_fn = make_fused_ce_loss(chunk=CE_CHUNK, vocab_chunk=CE_VOCAB_CHUNK)
    params = model.lora_parameters()

    def run():
        loss, _ = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        return loss.detach(), grads

    zero_counters()
    loss_k, grads_k = run()
    counts = read_counters()
    undo = plain_kernels()
    try:
        zero_counters()
        loss_p, grads_p = run()
        plain_counts = read_counters()
    finally:
        undo()
    want = expected_launches(STEP_LAYERS)
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    grad_rel = [_rel(a, b)[1] for a, b in zip(grads_k, grads_p)]
    res = {"layers": STEP_LAYERS, "batch": STEP_BATCH, "seq": TRAIN_SEQ,
           "loss_kernels": loss_k.item(), "loss_plain": loss_p.item(),
           "loss_rel_err": loss_rel, "grad_max_rel_err": max(grad_rel),
           "grads": len(grad_rel), "launches": counts,
           "plain_launches": plain_counts,
           "tol": f"loss {STEP_LOSS_TOL} relative, each LoRA gradient "
                  f"{STEP_GRAD_TOL} * max|plain|: bf16 activations carry "
                  "the kernels' summation-order differences through both "
                  "layers, forward and backward"}
    log("step check:", json.dumps(res))
    if (not all(torch.isfinite(g).all() for g in grads_k)
            or loss_rel > STEP_LOSS_TOL or max(grad_rel) > STEP_GRAD_TOL
            or counts != want or any(plain_counts.values())):
        raise SystemExit(f"QLoRA step with kernels disagrees with the "
                         f"plain path (launches wanted {want}): {res}")
    del model
    return res


def flops_per_token(m: int, n_layer: int, seq: int, dim: int,
                    *, train_full: bool) -> float:
    """Copied from ``llm_in_practise_tpu/obs/cost.py::flops_per_token``
    (this script imports nothing of the JAX package). Per-token FLOPs:
    ``m`` matmul param elements (2 FLOPs each forward); causal attention
    (average S/2 keys): QK^T + AV = 4 (S/2) D per layer forward. Full
    training = 3x forward; QLoRA freezes the base, so the weight-gradient
    matmuls are skipped: 2x forward for the matmul part, attention
    backward still 3x its forward. The remat recompute is not counted."""
    matmul_fwd = 2.0 * m
    attn_fwd = 2.0 * n_layer * seq * dim
    if train_full:
        return 3.0 * (matmul_fwd + attn_fwd)
    return 2.0 * matmul_fwd + 3.0 * attn_fwd


def matmul_params(cfg) -> int:
    """Elements of the kernels that run as matmuls per token: every block
    projection plus the tied head (the embedding gather is no matmul)."""
    per_layer = sum(k * n for k, n in PROJ_SHAPES.values())
    return cfg.n_layer * per_layer + cfg.vocab_size * cfg.hidden_size


def train_phase(n_layer: int, seed: int, card: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from llm_in_practise_tpu_torch.train.optim import adamw
    from llm_in_practise_tpu_torch.train.step import (
        create_train_state,
        make_fused_ce_loss,
        make_train_step,
    )

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    cfg, model = build_qlora(n_layer, seed)
    torch.cuda.synchronize()
    log(f"train model: Qwen3-8B width, {n_layer} layers, NF4 base, LoRA r "
        f"{LORA_R} on q/v_proj, built in {time.monotonic() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed + 5)
    x = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                      generator=gen, device=model.device)
    batch = (x, torch.roll(x, -1, dims=1))
    # bench.py's step: optax.adamw(1e-4) (weight decay 1e-4, no clip)
    state = create_train_state(
        model, adamw(TRAIN_LR, weight_decay=1e-4, clip_norm=None))
    step = make_train_step(loss_fn=make_fused_ce_loss(
        chunk=CE_CHUNK, vocab_chunk=CE_VOCAB_CHUNK))
    lora_b = [ab["b"] for ab in model.lora_state().values()]

    t0 = time.monotonic()
    state, m0 = step(state, batch)  # warm-up, outside the counted run
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    losses = [m0["loss"].item()]
    b_nonzero = all(bool(b.abs().max() > 0) for b in lora_b)
    torch.cuda.reset_peak_memory_stats()
    per_step = expected_launches(n_layer)
    walls, step_counts = [], []
    for _ in range(TRAIN_STEPS):
        zero_counters()
        t0 = time.monotonic()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())  # syncs the step
        walls.append(time.monotonic() - t0)
        step_counts.append(read_counters())
    counts = {k: sum(c[k] for c in step_counts) for k in per_step}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    tokens = TRAIN_BATCH * TRAIN_SEQ
    wall = statistics.median(walls)
    f_tok = flops_per_token(matmul_params(cfg), n_layer, TRAIN_SEQ,
                            cfg.n_head * cfg.head_dim, train_full=False)
    out = {
        "card": card, "layers": n_layer, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "lora": {"r": LORA_R, "alpha": LORA_ALPHA,
                                   "targets": ["q_proj", "v_proj"]},
        "trainable_params": sum(p.numel() for p in model.lora_parameters()),
        "losses": losses, "warmup_step_s": warm_s, "step_walls_s": walls,
        "step_wall_s": wall, "tokens_per_s": tokens / wall,
        "flops_per_token": f_tok,
        "mfu": f_tok * tokens / wall / H100_BF16_OPS_PER_S,
        "mfu_formula": "flops_per_token(m, L, S, H*D, train_full=False) = "
                       "2*(2m) + 3*(2*L*S*H*D); m = block projections + "
                       "tied head; over 989e12 FLOP/s",
        "max_memory_allocated_gib": peak_gib,
        "launches": counts, "launches_per_step_expected": per_step,
        "launches_per_step_equal": all(c == per_step for c in step_counts),
        "lora_b_nonzero_after_step_1": b_nonzero,
    }
    log("train:", json.dumps(out))
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"non-finite training loss: {losses}")
    if not b_nonzero:
        raise SystemExit("the LoRA B factors did not move in step 1")
    if not all(c == per_step for c in step_counts):
        raise SystemExit(f"kernel launches per step {step_counts} != "
                         f"{per_step} for {n_layer} layers")
    # one more step under the profiler: where the device time goes
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        state, metrics = step(state, batch)
        metrics["loss"].item()
        prof_wall = time.monotonic() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us == 0:
        out["profile"] = {"step_wall_s": prof_wall,
                          "device_s": "not measured"}
    else:
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        out["profile"] = {
            "step_wall_s": prof_wall,
            "step_device_s": device_us / 1e6,
            "device_busy_share": device_us / 1e6 / prof_wall,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels_ms": {e.key[:70]: e.self_device_time_total / 1e3
                               for e in top},
        }
    log("train profile:", json.dumps(out["profile"]))
    return {"launches": counts, "train": out}


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
    log(f"build: {_build.build_all():.1f}s (nvcc, sm_90a, "
        f"{len(_build.KERNELS)} sources)")
    summary = check_nf4_kernel(args.seed)
    served = serve_phase(N_LAYER, args.seed, card)
    gc.collect()  # the serving model and engine go before training
    torch.cuda.empty_cache()

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    nf4_rows = check_train_nf4(args.seed, flush)
    flash_rows = check_flash(args.seed, flush)
    del flush
    step_res = step_check(args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    trained = train_phase(N_LAYER, args.seed, card)
    launches = trained["launches"]

    summary["launches"] = served["launches"] + launches["nf4_matmul"]
    summary["launches_by_path"] = {"serve": served["launches"],
                                   "train": launches["nf4_matmul"]}
    summary["train"] = layer_sum(nf4_rows, "nf4_matmul")
    csrc = "llm_in_practise_tpu_torch/csrc/"
    table = [summary, {
        "name": "nf4_matmul_backward", "route": "cuda",
        "source": csrc + "nf4_matmul_bwd.cu",
        "replaces": "llm_in_practise_tpu/ops/nf4_matmul.py:111",
        "tpu_function": "_bwd_kernel (pallas_call at :194)",
        **layer_sum(nf4_rows, "nf4_matmul_backward"),
        "launches": launches["nf4_matmul_backward"]}]
    for name, line, fn in (
            ("flash_forward", 55, "_fwd_kernel (pallas_call at :101)"),
            ("flash_backward_dkv", 129,
             "_bwd_dkv_kernel (pallas_call at :220)"),
            ("flash_backward_dq", 177,
             "_bwd_dq_kernel (pallas_call at :248)")):
        row = dict(flash_rows[name])
        row.pop("checks")
        table.append({"name": name, "route": "cuda",
                      "source": csrc + "flash_attention.cu",
                      "replaces": f"llm_in_practise_tpu/ops/"
                                  f"flash_attention.py:{line}",
                      "tpu_function": fn, **row,
                      "launches": launches[name]})
    log("flash checks:", json.dumps(flash_rows["flash_forward"]["checks"]))
    log("step check:", json.dumps(step_res))
    log(json.dumps({"kernels": table}))
    log(f"total {time.monotonic() - t_start:.1f}s")
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
