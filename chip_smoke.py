#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 (or another CUDA card).

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --flash-only   # phase 1, the flash source, and
                                         # the flash checks and times

With ``--flash-only`` it builds only ``csrc/flash_attention.cu``, runs the
flash checks and times of phase 6 on the kernels of the checkout it runs
from, prints their rows and stops (no status line): copied into an
unpacked earlier tree, it times that tree's flash kernels.

Phases, in order; any failure exits non-zero:

1. Identify the card (``nvidia-smi`` name and power limit).
2. Build every CUDA kernel of the port from ``llm_in_practise_tpu_torch/csrc``
   (one nvcc per source, all started together).
3. Check the NF4 forward kernels against their plain PyTorch version on
   the card at the shapes the serving path gives them, and time kernel,
   plain version and one library call (CUDA events, L2 flushed before every
   launch).
4. The same for the int4 (W4A16) and int8 (W8A16) kernels, forward and
   backward: every Qwen3-8B projection shape, M in {1, 8, 512, 8192} for
   the forwards and M = 8192 for all four; int4 symmetric with group size
   128 (GPTQModel's ``bits=4, group_size=128``) and asymmetric with group
   size 32 and fractional zeros (AWQ's grid). A planted fault (one group's
   scale, or for int8 a block of columns' or at M = 8192 one column's
   scale, zeroed in a copy of the weight) must read as a failure, on both
   forward routes. The dx kernels and both forward routes of int4 and
   int8 also run at ragged shapes (``DX_EDGE_SHAPES``, ``FWD_EDGE_SHAPES``,
   ``INT8_FWD_EDGE_SHAPES``: M, K and N off their tiles, int4 group sizes
   32 and 2), and every launch of a dx kernel or a forward is repeated and
   must give the same bytes. The NF4 and int8 forwards run on their thin-M
   route at every projection shape and ``THIN_CHECK_M`` rows. The thin-M
   route of all three forwards (``csrc/qmm_thin.cuh``) must reproduce the
   codec's weights bit for bit (unit-vector rows of x), give the same
   bytes over repeated launches of every instantiation (8 to 128 rows of x
   per block, TMA and plain-load path) and see a planted fault. Then the
   forward crossover tables of NF4, int4 and int8: both routes (the thin-M
   kernel and the wgmma mainloop) on one layer's 7 projections at
   ``THIN_CROSSOVER_M``, beside the row count from which each wrapper's
   ``_route`` takes wgmma; and the three forwards' device time at decode
   row counts (``DECODE_M``: kernel self time under torch.profiler, beside
   the event time), each against its library call.
5. Serve: a Qwen3-8B-width model (hidden 4096, inter 12288, 32/8 heads,
   head_dim 128, vocab 151936, tied embeddings) with random weights from a
   seeded generator, every block projection quantized on the card (NF4,
   then int4 RTN symmetric g128, then int8), behind the port's OpenAI
   server on 127.0.0.1. Eight concurrent chat requests (four streamed)
   run through the HTTP API; the kernels' launch counters are zeroed just
   before and read just after, and must show the format's kernel ran for
   every projection of every forward pass, on the route that ``_route``
   picks for each pass's row count. Then whole-model logits of an AWQ
   model (2 layers), kernels against plain versions, and a greedy
   generation for 8 prompts on it through the engine (every decode
   projection on int4's thin-M route). Each decode step of these engines
   is one CUDA graph replay.
   Between the NF4 and the int4 runs, ``serve_sched`` on the NF4 model:
   chunked prefill 256, decode blocks of 8, the fused mixed step,
   ``max_queue`` 4. Six chats, two
   long prompts (700 and 900 tokens) that chunk-prefill while they
   decode, two more of each that queue, and a burst past the queue that
   must get 429: through the engine with the fused step and without it
   (identical greedy tokens), then over HTTP with the counters zeroed
   before and read after (B1's launches per route must follow from the
   engine's forward counts, through graph replays); a decode-only
   profile of replayed blocks; a sampled block (captured, then
   replayed); and every captured graph replayed once
   against its eager body on copies of the same cache and inputs
   (identical tokens, index and KV bytes).
   Then ``serve_paged`` on the same model (paged KV and the prefix
   cache; decode blocks of 8): a 512-token system prompt (32 pages of 16)
   and 8 user turns of 24-59 tokens, driven step by step through five
   engines: paged and contiguous without a prefix cache (identical
   greedy tokens), paged with the page index and contiguous with its row
   cache (identical tokens; the sharers hit the 32 pages: tokens saved,
   shared pages at the peak, no leaked reference after the index is
   cleared), and paged fp8 (the system prompt's layer-0 pages are the
   saturating fp8 cast of the bf16 engine's, byte for byte; half the
   pool bytes; where each stream departs from bf16, a reading). Then a
   pool of 2048 tokens under 8 requests of about 300 + 256 tokens
   (preemption by recompute must fire, nothing leaks, every emitted
   token is among the top 5 of a teacher-forced forward); a server built
   with the CLI's defaults (paged) answers the 8 chats (4 streamed),
   ``/debug/kv`` reports the paged layout and a 512-token pool answers a
   700-token prompt with 422; a decode profile of that engine beside a
   contiguous one (TPOT, device time, busy share, kernels per step, the
   view's gather and scatter, graphs and pool); and a 2-layer int8 model
   serves the shared-prefix traffic paged with the tokens of its
   contiguous run (B8 launched).
   Then ``serve_spec`` on the same model (speculative decoding, k = 4,
   decode blocks of 8): a Qwen3-0.6B-shaped draft with seeded weights is
   written as ``model.msgpack`` and loaded by the CLI's draft loader;
   8 greedy chats of 128 new tokens (half repeat a 40-token passage) over
   HTTP on an ngram engine, then through paged engines without
   speculation, with the prompt lookup, the 0.6B draft and the target as
   its own draft, contiguous ones with the prompt lookup and the target
   as its own draft, and the 0.6B draft at decode steps of 1 while a
   700-token prompt chunk-prefills. Each spec round is one
   graph replay (two with a draft: its roll, then the verify); every
   round's acceptance is recomputed on the host; every spec, pspec and
   droll graph replays its eager body byte for byte; every token is in
   the top 5 of a teacher-forced forward, or no further below its top
   logit than the plain leg's tokens lie; a sampled request does not
   speculate; B1's launches per route follow
   from the engine's forwards (40-row verifies on the thin route); an
   explicit pool gives up the draft cache's rows. Readings: TPOT, tokens
   per round, acceptance, device and host time per round, the roll's
   device time, captures, and a 40-row verify beside an 8-row decode.
   No engine of the phase captures a masked graph kind.
   Then ``serve_struct`` on the same model (structured output and
   ``/v1/embeddings``; paged, chunked prefill 256, decode blocks of 8,
   the fused mixed step): the JAX structured bench's traffic, 16
   requests from ``serve/arrivals.py``'s seeded bursty schedule, half
   under the bench's JSON schema, replayed open loop (then a 700-token
   plain document) through paged engines with speculation off, the
   prompt lookup and the target as its own draft (k = 4), and
   contiguous engines with it off and with the prompt lookup; then over
   HTTP ``json_schema``
   (streamed and not), ``json_object``, a forced tool call, ``tools``
   with ``auto``, two 422s and ``/v1/embeddings``. Every constrained
   completion that stops parses and validates, with no violation; every
   masked graph replays its eager body byte for byte; while a slot is
   constrained each dispatch is one masked graph run at n 1 (m 0); masked
   spec rounds' acceptance is recounted on the host and bounded by the
   grammar; B1's launches per route follow from the forwards, the
   embeddings' too (and their vectors agree with the plain version's).
   Readings: TPOT and TTFT of constrained and plain requests, the first
   request's TPOT, mask staging and copy times, grammar compile time per
   state, ``vocab_strings`` time, masked captures. ``serve_spec`` and
   ``serve_struct`` run on an NF4 model built as the full one but
   ``CUT_LAYERS`` (12) deep, every check kept, so that the script stays
   inside half its time limit.
   Then ``serve_disagg`` (the KV tiers and the disaggregated prefill/
   decode handoff): a pool server started as ``python -m
   llm_in_practise_tpu_torch.serve.kv_pool --port 0``, a prefill replica
   and a decode replica (ngram k = 4, the decode default) with
   ``RemoteHandoff`` stores and a ``role="both"`` engine for the golden
   streams (paged, pages of 16, chunked prefill 256, decode blocks of
   8); the NF4 cell's 8 chats and two ~700-token documents. Leg 1 on the
   full-depth model: each prompt alone (streams equal to the ``both``
   engine's byte for byte), then all at once (every token in the top 5
   of a teacher-forced forward); a lost handoff (an id claimed twice
   re-prefills, counted); HTTP (``/internal/handoff/prefill``, then
   chats with ``kv_transfer_params``, streamed and not; 501 from the
   decode server). On the ``CUT_LAYERS`` model: paged -> contiguous and
   contiguous -> paged, a ``--kv-offload`` engine whose small L1's
   evictions re-hit from L2, and two engines sharing the pool server by
   write-through (the second's first request an L3 hit); fp8 -> fp8 on
   a 2-layer int8 model. The decode replica never prefills in a
   handed-off leg, the pool's pending handoffs return to 0, and B1 runs
   wgmma launches only on the prefill replica. Readings: bytes per
   entry, publish and claim seconds by piece, TTFT after a claim and
   TPOT beside ``both``, the write-through's cost, L3 ``get`` ms per MiB
   of the largest entry ``cache_len`` admits at full depth.
   Then ``serve_lora`` on the ``CUT_LAYERS`` NF4 model (batched
   multi-LoRA; paged, chunked prefill 256, decode blocks of 8, the mixed
   step): four
   seeded adapters (``sft-a`` and ``sft-b`` r 16 on the SFT default's
   attention targets, ``sft-a`` written by ``save_named`` and loaded by
   path; ``qv-8`` r 8 on q and v; ``ladder-6`` r 6 on q and the MLP), the
   JAX multi-LoRA bench's 16 arrivals pinned to [base, sft-a, sft-b,
   qv-8, ladder-6] in turn (two under the schema) and a 700-token document
   under ``sft-a``: paged with speculation off and with the prompt
   lookup, contiguous, all-adapter traffic, base-only traffic on a
   registry engine and on one without, hot loads that grow a bank, a
   byte-budget registry, prefix isolation and HTTP with adapter names.
   Every adapter twin replays its eager body byte for byte and its base
   rows equal the base kind's; each mixed-batch row against a batch-1
   forward under its adapter; one dispatch per decode block across
   adapters; recaptures after a bank grows; B1 per route as derived.
   Readings: TPOT / TTFT per traffic, the delta's device ms and kernels
   per decode step, MiB gathered per step, bank MiB, swap seconds, twin
   captures and recaptures.
   Then ``serve_sessions`` on the full-depth NF4 model (session-native
   serving, the chat page, ``/metrics`` and the HBM ledger; paged, pages
   of 16, prefix caching, decode blocks of 8): 8 sessions of 3 turns
   from ``serve/arrivals.py::synthesize_sessions``, one request at a
   time, with 4 unrelated 600-token requests between two rounds in a
   2048-token pool, on an engine without a store (its later turns must
   come out cold or under half their history) and twice on one with a
   ``SessionStore`` (every later turn admits from at least its pinned
   pages; the streams equal the second run's byte for byte and every
   token is in the top 5 of a teacher-forced forward); pins yielding in
   a 512-token pool (pressure evictions, no allocation failure while a
   pin remains, no slot loses a page, survivors are chain prefixes, a TTL
   sweep empties ``session_pins``); two replicas behind their own servers
   over loopback sharing a pool server started with ``--metrics-port``:
   a conversation moved from A to B by ``X-Session-ID`` is claimed and
   prefills only what its prompt does not share with the published
   history, a never-published session is a counted local prefill, a
   mismatched entry is discarded unscattered; ``/metrics`` parses and
   equals ``/debug/sessions`` and ``/debug/hbm``, the ledger books the
   pool, the weights and the pins and returns to its baseline, the
   pool's ``kvpool_*`` families, ``GET /`` and ``/chat`` and the SSE the
   page's script reads; B1 thin on both replicas. Readings: warm and
   cold TTFT by turn, the migration's prefill tokens and TTFT, the
   ledger's residual beside ``torch.cuda.memory_allocated``.
   Then ``serve_obs`` on the full-depth NF4 model (the tracer and the
   device plane): a server from ``serve.build_server`` with the CLI's
   defaults (paged, pages of 16, decode steps of 1) and ``--trace-file``,
   ``--ttft-slo 2.0``, ``--tpot-slo 0.1``; the NF4 cell's 8 chats (4
   streamed, 2 with a client ``traceparent``) and a ~700-token document.
   Each request's trace roots at ``api.chat`` with the engine's phase
   spans under it; ``/debug/traces``, the trace file (both lanes),
   ``/debug/requests`` (segments sum to wall within 1%) and ``/metrics``
   (TTFT counts, dispatches equal to the engine's and the step records',
   every step a partition, coverage >= 0.95, busy + host gap = 1,
   goodput's tokens the tokens generated, no MFU or bandwidth gauge
   above 1.05); a 1 ms TPOT SLO makes every request violate, blamed on
   spans of the blame list; ``POST /debug/profile`` while 4 chats stream
   answers 200 with B1 thin-M kernels in its trace, a second POST 409;
   the compile family equals the graphs' captures; the recorder and the
   tracer swapped off and on on one engine give the same greedy streams
   and TPOT p50 within 1.05. Then a prefill and a decode replica, each
   with its own tracer, over a pool server: one trace id in both rings
   (``handoff.publish`` in one, ``handoff.claim`` in the other), B1's
   wgmma route on the prefill replica only. Readings: a decode step's
   partition by activity, the busy share by CUDA events beside
   torch.profiler's (decode, and an eager prefill), the MFU and bandwidth
   gauges per phase, TTFT / TPOT p50 from the histograms beside the
   client's clock, the critical path, compile seconds, the profile's
   bytes and seconds, the on / off TPOT ratio.
6. Training kernels: the NF4 forward and backward at M = 8192 for every
   Qwen3-8B projection shape (both also at ragged shapes,
   ``NF4_FWD_EDGE_SHAPES`` on both forward routes and
   ``NF4_DX_EDGE_SHAPES``, every launch repeated for the same bytes, with
   a planted zeroed absmax block that must read as a failure, and the
   forward on a weight whose arrays start off 16-byte alignment), and
   the three flash kernels (forward, dK/dV, dQ) at ``FLASH_SHAPES`` (batch
   8 x 1024 tokens, 32/8 heads; a ragged length; head_dim 64 with a GQA
   group of 1; q, k, v as strided views of one fused tensor, whose
   forward and backward must give the bytes of contiguous copies), each
   against its plain version (the flash outputs tile by tile, every
   forward and backward launch repeated for the same bytes, and a planted
   zeroed tile of dq, of dk and of dv must each read as a failure) and
   timed as in phase 3 at the training shape, the dK/dV and dQ pair
   against SDPA's whole backward.
7. Whole step: one QLoRA step at full width, 2 layers, batch 2 x 1024,
   over an NF4, an int4 and an int8 base, with the kernels and again with
   every kernel swapped for its plain version; the loss and every LoRA
   gradient must agree, and each kernel's launches (the forwards' per
   route) must equal the count derived from the model.
8. Train: QLoRA on Qwen3-8B (36 layers, NF4 base, LoRA r 8 on q/v_proj,
   remat on every block, fused cross-entropy over the tied embedding,
   AdamW lr 1e-4), batch 8 x 1024 random tokens: one warm-up step, then
   timed steps with the launch counters zeroed before and read after;
   every kernel's launches per step must equal the count derived from
   the model (every NF4 forward on the wgmma route), and one more step is
   profiled.
9. Checkpoints (``ckpt``), at Qwen3-8B width with tied embeddings and
   seeded bf16 weights, ``CKPT_LAYERS`` (8) layers deep (the card's
   machine takes 45 GiB of disk writes per run), every file deleted after
   its check: the state written as an HF directory in the published layout
   (five safetensors shards, an index, ``config.json``); ``convert_hf``
   to an NF4 and to an int8 export, each served over HTTP by
   ``serve.build_server`` (the 8 greedy chats, admitted together) with
   tokens equal to a model quantized in memory from the same state, and
   B1 / B8 launches counted; ``train --model_dir --adapter_dir`` for two
   steps (B1, B2, B3-B5 launch; the restored adapter has the trained
   shapes, f32, a nonzero ``b``); ``merge_lora`` (``model.msgpack``
   equal to an in-memory merge, with its chunked embedding, and the f32
   HF export equal after a cast to bf16); ``serve --model_path`` dense,
   one graph replay per decode step, and ``infer.generate``'s greedy ids
   for the first prompt equal to a one-slot server's answer on the same
   model (an 8-slot engine rounds the f32 head otherwise). Bytes,
   seconds and GB/s of every read and write, host and card peaks.
10. Print the kernel summary (all nine kernels), the card, and the final
   status line.

Needs the repository checkout beside it (it imports the port) and CUDA.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
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
N_LAYER_FULL = N_LAYER
# serve_spec, serve_struct and serve_lora (and serve_disagg's cross-layout
# and tier legs) run at this depth, every check kept, so the script stays
# inside half its time limit as later slices add phases
CUT_LAYERS = 12
MAX_SLOTS = 8
CACHE_LEN = 1024
MAX_TOKENS = 64
SPEC_K = 4      # serve_spec's proposal length: a verify is 8 x 5 = 40 rows
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
# post-training-quantized formats: GPTQModel's QuantizeConfig(bits=4,
# group_size=128) (reference Quantization/GPTQModel/
# quantize_qwen3_4b_gptq.py:16-43), stored with RTN codes; AWQ's grid is
# asymmetric with fractional zeros, checked at group size 32
INT4_GS, AWQ_GS = 128, 32
PTQ_CHECK_M = (1, 8, 512, TRAIN_M)
# ragged shapes for the dx kernels (M, K, N, int4 group size): M off the
# 256-row tile on q_proj's shape, K off the 128-column tile (96 with
# groups of 32, 10 with groups of 2), N off the 64-column stage (48, and
# 1040 = 16 stages + 16 columns)
DX_EDGE_SHAPES = ((17, 4096, 4096, INT4_GS), (8191, 4096, 4096, INT4_GS),
                  (333, 96, 4096, 32), (333, 10, 4096, 2),
                  (333, 4096, 48, INT4_GS), (333, 4096, 1040, INT4_GS))
# ragged shapes for the int4 forward, both routes where they take the
# shape (M, K, N, group size): M off the 256-row tile, K off the 64-row
# stage (96 with groups of 32; 10 with groups of 2, which only the thin-M
# kernel takes: 2K bytes is no 16-byte multiple), N off the 128-column
# tile (48, and 1040 = 8 tiles + 16 columns)
FWD_EDGE_SHAPES = ((17, 4096, 4096, INT4_GS), (333, 4096, 4096, INT4_GS),
                   (8191, 4096, 4096, INT4_GS), (333, 96, 4096, 32),
                   (333, 10, 4096, 2), (333, 4096, 48, INT4_GS),
                   (333, 4096, 1040, INT4_GS))
# ragged shapes for the NF4 forward, both routes where the wgmma one takes
# the shape (M, K, N): M below the route threshold (17) and off the 256-row
# tile (333, 8191), a single 64-row stage (K = 64: half of thin's 128-k
# stage past K), N/2 % 64 == 32 (192: the last block's byte columns past
# N/2 are dropped), a low-half absmax run across a 256-value scale block
# (1088), and N % 32 != 0 (200), which only the thin kernel takes (on its
# plain-load path)
NF4_FWD_EDGE_SHAPES = ((17, 4096, 4096), (333, 4096, 4096),
                       (8191, 4096, 4096), (333, 64, 4096), (333, 4096, 192),
                       (333, 4096, 1088), (333, 4096, 200))
# the same for the int8 forward: K off the 64-row stage (96), N off the
# 128-column tile (48, and 1040 = 8 tiles + 16 columns), and K = 10 (2K
# bytes no 16-byte multiple), which only the thin kernel takes (on its
# plain-load path)
INT8_FWD_EDGE_SHAPES = ((333, 4096, 4096), (8191, 4096, 4096),
                        (333, 96, 4096), (333, 4096, 48), (333, 4096, 1040),
                        (333, 10, 4096))
# ragged shapes for the NF4 dx kernel (M, K, N): K off the 128-column tile
# (192), N/2 off the 64-column stage (N = 192 and 1088: the last high-half
# stage straddles into the low half, and a 64-column absmax run crosses a
# 256-value scale block), M off the 256-row tile
NF4_DX_EDGE_SHAPES = ((17, 4096, 4096), (8191, 4096, 4096), (333, 192, 4096),
                      (333, 4096, 192), (333, 4096, 1088), (33, 192, 192))
# the forward crossover tables (NF4, int4, int8): both routes at the decode
# row counts 1 and 8 and at these
CROSSOVER_M = (16, 64, 128, 256, 512, 1024, 8192)
THIN_CROSSOVER_M = (1, 8) + CROSSOVER_M
# row counts at which the NF4 and int8 forwards run on their thin-M route at
# every projection shape, held to the plain version: decode (1, 8, 16), a
# ragged block (17), a spec round's verify (40), short prefill, and the
# last row count below the wgmma route's threshold (255)
THIN_CHECK_M = (1, 8, 16, 17, MAX_SLOTS * (SPEC_K + 1), 64, 128, 255)
FWD_FORMATS = ("nf4", "int4", "int8")
# decode row counts whose device time (torch.profiler, kernel self time)
# the kernel table reports beside the event time; 40 is a spec round's
# verify
DECODE_M = (1, MAX_SLOTS, 16, MAX_SLOTS * (SPEC_K + 1))
# flash checks (B, L, H, Hkv, D, layout): the training shape, a ragged
# length, head_dim 64 with a GQA group of 1, and q, k, v as strided views
# of one fused (B, L, H + 2 Hkv, D) tensor
FLASH_SHAPES = ((TRAIN_BATCH, TRAIN_SEQ, 32, 8, 128, "contiguous"),
                (2, 1000, 32, 8, 128, "contiguous"),
                (2, 300, 8, 8, 64, "contiguous"),
                (2, 1000, 32, 8, 128, "fused_views"))
# readings of the kernels the wgmma routes replaced, per layer's 7
# projections at M = 8192 (PERF.md, mma.sync designs; NVIDIA H100 80GB HBM3,
# 700 W): printed beside this run's times, never measured here
EARLIER_MS = {"nf4_matmul": 18.86, "nf4_matmul_backward": 20.85,
              "int4_matmul": 22.95, "int8_matmul": 18.48}
AWQ_LAYERS = 2
# each forward's policy of the thin-M kernel (csrc/qmm_thin.cuh)
THIN_POLICIES = {"nf4": "Nf4Thin", "int4": "Int4Thin", "int8": "Int8Thin"}


def thin_labels(fmt: str) -> tuple:
    """The instantiations of ``fmt``'s thin-M kernel (8 MT rows of x per
    block; the TMA path or the plain-load one), as ptxas names them."""
    return tuple(f"{THIN_POLICIES[fmt]}ELi{mt}ELb{u}E"
                 for mt in (1, 2, 4, 8, 16) for u in (1, 0))


THIN_LABELS = sum((thin_labels(f) for f in THIN_POLICIES), ())
FLASH_FWD_LABELS = ("flash_fwd_kernelILi128E", "flash_fwd_kernelILi64E")
FLASH_DKV_LABELS = ("flash_bwd_dkv_kernelILi128E",
                    "flash_bwd_dkv_kernelILi64E")
FLASH_DQ_LABELS = ("flash_bwd_dq_kernelILi128E", "flash_bwd_dq_kernelILi64E")
# each kernel's entries in the ptxas report (qmm_resources)
PTXAS_LABELS = {"nf4_matmul": ("Nf4Fwd",) + thin_labels("nf4"),
                "nf4_matmul_backward": ("Nf4Dx",),
                "int4_matmul": ("Int4Fwd",) + thin_labels("int4"),
                "int4_matmul_backward": ("Int4Dx",),
                "int8_matmul": ("Int8Fwd",) + thin_labels("int8"),
                "int8_matmul_backward": ("Int8Dx", "int8_scale_dy_kernel"),
                "flash_forward": FLASH_FWD_LABELS,
                "flash_backward_dkv": FLASH_DKV_LABELS,
                "flash_backward_dq": FLASH_DQ_LABELS}


def set_depth(n_layer: int) -> None:
    """The depth the next phase's model has: every derivation of its
    launches reads ``N_LAYER``."""
    global N_LAYER
    N_LAYER = n_layer


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


def weight_bytes(fmt: str, k: int, n: int, gs: int = INT4_GS) -> int:
    """Stored bytes of one (K, N) weight: NF4 packed codes, absmax bytes,
    their f32 scales and offset; int4 packed codes with f32 scale and zero
    per group and column; int8 codes with an f32 scale per column."""
    if fmt == "nf4":
        return k * n // 2 + k * n // 64 + 4 * -(-(k * n // 64) // 256) + 4
    if fmt == "int4":
        return k * n // 2 + 2 * 4 * -(-k // gs) * n
    return k * n + 4 * n


def matmul_bound(m: int, k: int, n: int, wbytes: int
                 ) -> tuple[float, str, int]:
    """Least time on the card for ``x @ W`` or its ``dy @ W^T``: the bf16
    activation read once (M x K or M x N), the stored weight read once, the
    bf16 result written once (M x N or M x K), against 2*M*K*N bf16
    tensor-core operations."""
    nbytes = m * k * 2 + wbytes + m * n * 2
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 2 * m * k * n / H100_BF16_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", nbytes
    return t_ops * 1e3, "operations", nbytes


def qmm_resources() -> dict:
    """Registers, spills and shared memory of the kernels on the wgmma
    mainloop (B1's, B6's and B8's wgmma routes, B2, B7, B9), B9's scaling
    pass, every instantiation of the thin-M kernel (the decode routes of
    B1, B6 and B8) and the three wgmma flash kernels (B3, B4, B5), as
    ptxas reported them in this process's build, and whether ptxas warned
    C7515 (wgmma serialized) for each."""
    from llm_in_practise_tpu_torch.ops import _build

    labels = (("Nf4Fwd", "Int4Fwd", "Int8Fwd", "Int4Dx", "Int8Dx", "Nf4Dx",
               "int8_scale_dy_kernel") + THIN_LABELS + FLASH_FWD_LABELS
              + FLASH_DKV_LABELS + FLASH_DQ_LABELS)
    out = {}
    for src in ("nf4_matmul", "int4_matmul", "int8_matmul",
                "nf4_matmul_bwd", "flash_attention"):
        entry = None
        for line in _build.ptxas_log.get(src, "").splitlines():
            named = next((lab for lab in labels if lab in line), None)
            if "C7515" in line and named:
                out.setdefault(named, {"ptxas": [], "c7515": False})
                out[named]["c7515"] = True
            elif "Compiling entry function" in line:
                entry = named
            elif entry and ("spill" in line or "Used" in line):
                out.setdefault(entry, {"ptxas": [], "c7515": False})
                out[entry]["ptxas"].append(line.split(":", 1)[-1].strip())
    return {k: {"ptxas": "; ".join(v["ptxas"]), "c7515": v["c7515"]}
            for k, v in out.items()}


def fwd_op(fmt: str):
    """A forward format's wrapper module, its plain version and its route
    for (m, k, n) (int4 at ``INT4_GS``)."""
    from llm_in_practise_tpu_torch.ops import int4_matmul as i4
    from llm_in_practise_tpu_torch.ops import int8_matmul as i8
    from llm_in_practise_tpu_torch.ops import nf4_matmul as nm

    if fmt == "nf4":
        return nm, nm.nf4_matmul_reference, nm._route
    if fmt == "int8":
        return i8, i8.int8_matmul_reference, i8._route
    return (i4, i4.int4_matmul_reference,
            lambda m, k, n: i4._route(m, k, n, INT4_GS))


def check_nf4_kernel(seed: int) -> dict:
    """Kernel vs plain version at the serving shapes; returns the summary."""
    import torch

    from llm_in_practise_tpu_torch.ops.nf4_matmul import (
        _route,
        nf4_matmul,
        nf4_matmul_reference,
    )
    from llm_in_practise_tpu_torch.quant import nf4

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
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
            bound_ms, bound_by, nbytes = matmul_bound(
                m, k, n, weight_bytes("nf4", k, n))
            row = {
                "kernel": "nf4_matmul", "M": m, "K": k, "N": n,
                "route": _route(m, k, n),
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


def quantize_weight(fmt: str, w, gen=None):
    """One (K, N) weight in a serving format, by the port's codecs on the
    card. AWQ stores the int4 codes of ``W * s`` (asymmetric, group size
    32) with ``inv_scale = 1 / s`` for a random per-input-channel ``s``
    drawn from ``gen``."""
    import torch

    from llm_in_practise_tpu_torch.quant import int4, int8, nf4
    from llm_in_practise_tpu_torch.quant.awq import AWQTensor

    if fmt == "nf4":
        return nf4.quantize(w)
    if fmt == "int4":
        return int4.rtn_quantize(w, group_size=INT4_GS, sym=True)
    if fmt == "int8":
        return int8.quantize(w)
    s = 0.5 + 1.5 * torch.rand(w.shape[0], device=w.device, generator=gen)
    return AWQTensor(int4.rtn_quantize(w * s[:, None], group_size=AWQ_GS,
                                       sym=False), 1.0 / s)


def fractional_zero_int4(w, gs: int):
    """Asymmetric int4 with fractional zero-points (AWQ's affine grid): the
    RTN asymmetric parameters with 0.37 added to every zero."""
    from llm_in_practise_tpu_torch.quant import int4

    t = int4.rtn_quantize(w, group_size=gs, sym=False)
    return int4.encode(w, t.scales, t.zeros + 0.37, gs)


def b9_product_only(dy, t):
    """B9's launch without its scaling pass (dy taken as already scaled),
    for the split of its time: a callable on the card."""
    import torch

    from llm_in_practise_tpu_torch.ops import _build

    lib = _build.load("int8_matmul")
    m, n = dy.shape
    k = t.q.shape[0]
    dx = torch.empty((m, k), dtype=torch.bfloat16, device=dy.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.int8_matmul_bwd_launch(dy.data_ptr(), t.q.data_ptr(),
                                         None, None, dx.data_ptr(), m, k, n,
                                         1, stream)
        if err:
            raise SystemExit(f"B9 product launch failed: cuda error {err}")
    return run


def check_ptq_kernels(seed: int, flush) -> dict:
    """B6-B9 against their plain versions at every Qwen3-8B projection
    shape (see the module doc), timed as phase 3 times B1; the library
    yardstick is one torch.matmul on the weight dequantized to bf16
    beforehand (for the int8 forward ``(x @ q.bf16) * scale``). Returns the
    rows keyed ``(kernel, case, M, K, N)``."""
    import dataclasses

    import torch

    from llm_in_practise_tpu_torch.ops import int4_matmul as i4
    from llm_in_practise_tpu_torch.ops import int8_matmul as i8
    from llm_in_practise_tpu_torch.quant import int4, int8

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 6)
    rows = {}

    fwd_mod = {"int4_matmul": i4, "int8_matmul": i8}

    def check(kernel, case, fn, plain, lib, inp, t, wbytes, k, n, planted,
              edge=False, route=None):
        m = inp.shape[0]
        if route is not None:  # a forward route forced (edge shapes)
            def fn(a, w, dtype):
                return fwd_mod[kernel]._forward(a, w, dtype, route=route)
        out = fn(inp, t, torch.bfloat16)
        ref = plain(inp, t, torch.bfloat16)
        torch.cuda.synchronize()
        err, rel = _rel(out, ref)
        ok = bool(torch.isfinite(out).all().item()) and rel <= KERNEL_TOL
        row = {"kernel": kernel, "case": case, "M": m, "K": k, "N": n,
               "max_abs_err": err, "max_rel_err": rel,
               "tol": f"{KERNEL_TOL} * max|plain| (summation order; bf16 "
                      "output rounding)"}
        if kernel == "int4_matmul":
            row["route"] = route or i4._route(m, k, n, t.group_size)
        elif kernel == "int8_matmul":
            row["route"] = route or i8._route(m, k, n)
        # deterministic: each output element is reduced in one block (or
        # its K splits summed in one cluster) in a fixed order, so a second
        # launch gives the same bytes
        row["repeat_equal"] = torch.equal(out, fn(inp, t, torch.bfloat16))
        ok = ok and row["repeat_equal"]
        if not edge:
            bound_ms, bound_by, nbytes = matmul_bound(m, k, n, wbytes)
            iters = (10, 3) if m == TRAIN_M else (20, 5)
            row.update({
                "ms": time_ms(lambda: fn(inp, t, torch.bfloat16), iters[0],
                              flush),
                "plain_ms": time_ms(lambda: plain(inp, t, torch.bfloat16),
                                    iters[1], flush),
                "library_ms": time_ms(lib, iters[0], flush),
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes})
            if kernel == "int8_matmul_backward":
                row["product_ms"] = time_ms(b9_product_only(inp, t),
                                            iters[0], flush)
        row["ok"] = ok
        if planted is not None:
            # the check must see a fault: one group's (or, for int8, one
            # block of columns' or one column's) scale zeroed in a copy of
            # the weight
            bad = fn(inp, planted, torch.bfloat16)
            row["planted_zero_scale_rel_err"] = _rel(bad, ref)[1]
            ok = row["ok"] = ok and row["planted_zero_scale_rel_err"] > \
                KERNEL_TOL
        log(json.dumps(row))
        rows[("edge", kernel, case, m, k, n) if edge
             else (kernel, case, m, k, n)] = row
        if not ok:
            raise SystemExit(f"{kernel} ({case}) disagrees with its plain "
                             f"version, misses the planted fault or gives "
                             f"other bytes on a second launch, at "
                             f"M={m} K={k} N={n}: {row}")

    for k, n in sorted(set(PROJ_SHAPES.values())):
        w = torch.randn(k, n, device=dev, generator=gen) * 0.02
        plant = (k, n) == PROJ_SHAPES["q_proj"]
        int4_cases = {"sym_g128": (int4.rtn_quantize(w, group_size=INT4_GS),
                                   INT4_GS),
                      "asym_g32_frac": (fractional_zero_int4(w, AWQ_GS),
                                        AWQ_GS)}
        t8 = int8.quantize(w)
        del w
        w8 = int8.decode(t8)  # library yardsticks only
        q8 = t8.q.to(torch.bfloat16)
        bad8 = dataclasses.replace(t8, scale=t8.scale.clone())
        bad8.scale[:64] = 0
        bad8_col = dataclasses.replace(t8, scale=t8.scale.clone())
        bad8_col.scale[0] = 0
        for m in PTQ_CHECK_M:
            x = torch.randn(m, k, device=dev, generator=gen).to(
                torch.bfloat16)
            for case, (t, gs) in int4_cases.items():
                if case != "sym_g128" and m not in (MAX_SLOTS, TRAIN_M):
                    continue
                w4 = int4.decode(t)
                bad4 = None
                if plant and m in (MAX_SLOTS, TRAIN_M):  # both routes
                    bad4 = dataclasses.replace(t, scales=t.scales.clone())
                    bad4.scales[0] = 0
                check("int4_matmul", case, i4.int4_matmul,
                      i4.int4_matmul_reference, lambda: torch.matmul(x, w4),
                      x, t, weight_bytes("int4", k, n, gs), k, n, bad4)
                del w4
            check("int8_matmul", "per_channel", i8.int8_matmul,
                  i8.int8_matmul_reference,
                  lambda: torch.matmul(x, q8) * t8.scale, x, t8,
                  weight_bytes("int8", k, n), k, n,
                  None if not plant else bad8 if m == MAX_SLOTS
                  else bad8_col if m == TRAIN_M else None)
            del x
        dy = torch.randn(TRAIN_M, n, device=dev, generator=gen).to(
            torch.bfloat16)
        for case, (t, gs) in int4_cases.items():
            w4 = int4.decode(t)
            bad4 = None
            if plant:
                bad4 = dataclasses.replace(t, scales=t.scales.clone())
                bad4.scales[0] = 0
            check("int4_matmul_backward", case, i4.int4_matmul_backward,
                  i4.int4_matmul_backward_reference,
                  lambda: torch.matmul(dy, w4.T), dy, t,
                  weight_bytes("int4", k, n, gs), k, n, bad4)
            del w4
        check("int8_matmul_backward", "per_channel", i8.int8_matmul_backward,
              i8.int8_matmul_backward_reference,
              lambda: torch.matmul(dy, w8.T), dy, t8,
              weight_bytes("int8", k, n), k, n, bad8 if plant else None)
        del dy, t8, w8, q8, bad8, bad8_col, int4_cases
    # B7 and B9 at ragged shapes: M, K and N edges of the tiles (TMA's zero
    # fill and the guarded stores), group sizes down to 2
    for m, k, n, gs in DX_EDGE_SHAPES:
        w = torch.randn(k, n, device=dev, generator=gen) * 0.02
        dy = torch.randn(m, n, device=dev, generator=gen).to(torch.bfloat16)
        cases = {"sym": int4.rtn_quantize(w, group_size=gs),
                 "asym_frac": fractional_zero_int4(w, gs)}
        for case, t in cases.items():
            check("int4_matmul_backward", f"{case}_g{gs}",
                  i4.int4_matmul_backward, i4.int4_matmul_backward_reference,
                  None, dy, t, 0, k, n, None, edge=True)
        check("int8_matmul_backward", "per_channel", i8.int8_matmul_backward,
              i8.int8_matmul_backward_reference, None, dy, int8.quantize(w),
              0, k, n, None, edge=True)
        del w, dy, cases
    # B6 at ragged shapes on every route (wgmma where it takes the shape)
    for m, k, n, gs in FWD_EDGE_SHAPES:
        w = torch.randn(k, n, device=dev, generator=gen) * 0.02
        x = torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
        cases = {"sym": int4.rtn_quantize(w, group_size=gs),
                 "asym_frac": fractional_zero_int4(w, gs)}
        for route in i4.ROUTES:
            if route == "wgmma" and not i4._wgmma_shape(k, n, gs):
                continue
            for case, t in cases.items():
                check("int4_matmul", f"{case}_g{gs}@{route}", None,
                      i4.int4_matmul_reference, None, x, t, 0, k, n, None,
                      edge=True, route=route)
        del w, x, cases
    # B8 at ragged shapes on both routes (wgmma where it takes the shape)
    for m, k, n in INT8_FWD_EDGE_SHAPES:
        t = int8.quantize(torch.randn(k, n, device=dev, generator=gen) * 0.02)
        x = torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
        for route in i8.ROUTES:
            if route == "wgmma" and not i8._wgmma_shape(k, n):
                continue
            check("int8_matmul", f"per_channel@{route}", None,
                  i8.int8_matmul_reference, None, x, t, 0, k, n, None,
                  edge=True, route=route)
        del t, x
    return rows


# row counts of every thin-route instantiation (8, 16, 32, 64 and 128 rows
# of x per block), each launched THIN_REPEATS times for the same bytes
THIN_REPEAT_M = (1, 8, 16, 17, 32, 33, 64, 65, 128)
THIN_REPEATS = 10
# the thin route's repeat shapes per format, (K, N) and for int4 the group
# size: gate_proj's on the TMA path, then one the plain-load path takes
# (NF4: N % 32 != 0; int4: a group size that is no power of two; int8:
# K % 8 != 0 and N % 16 != 0)
THIN_REPEAT_SHAPES = {"nf4": ((4096, 12288, 0), (4096, 1000, 0)),
                      "int4": ((4096, 12288, INT4_GS), (4096, 1040, 96)),
                      "int8": ((4096, 12288, 0), (4100, 1000, 0))}


def thin_path(fmt: str, k: int, n: int, gs: int = 0) -> str:
    """Which path of the thin-M kernel fills a stage for this shape: "tma"
    or "plain", by the conditions of the C entries in ``csrc/``."""
    if fmt == "nf4":
        fast = n % 32 == 0
    elif fmt == "int8":
        fast = k % 8 == 0 and n % 16 == 0
    else:
        fast = k % 8 == 0 and n % 16 == 0 and gs >= 16 and gs & (gs - 1) == 0
    return "tma" if fast else "plain"


def thin_weight(fmt: str, w, gs: int = 0):
    """``w`` in ``fmt`` for the thin checks: NF4, int8, or int4 with
    AWQ-style fractional zeros at group size ``gs``."""
    from llm_in_practise_tpu_torch.quant import int8, nf4

    if fmt == "nf4":
        return nf4.quantize(w)
    if fmt == "int8":
        return int8.quantize(w)
    return fractional_zero_int4(w, gs)


def thin_codec_weights(fmt: str, t):
    """The weights the thin route must read back from unit-vector rows of
    x, in f32: the codec's bf16 weight for NF4 and int4; for int8 the
    kernel's weight is the code itself, so a unit row reads q * scale, the
    column scale applied to the exact sum in f32."""
    import torch

    from llm_in_practise_tpu_torch.quant import int4, nf4

    if fmt == "nf4":
        return nf4.dequantize(t, torch.bfloat16).float()
    if fmt == "int4":
        return int4.decode(t, torch.bfloat16).float()
    return t.q.float() * t.scale


def thin_fault(fmt: str, t):
    """A copy of ``t`` with a planted fault the thin checks must see: NF4
    absmax byte row 0 zeroed, int4 group row 0's scales zeroed, int8 column
    0's scale zeroed."""
    import dataclasses

    if fmt == "nf4":
        bad = dataclasses.replace(t, absmax_q=t.absmax_q.clone())
        bad.absmax_q[:t.shape[1]] = 0
    elif fmt == "int4":
        bad = dataclasses.replace(t, scales=t.scales.clone())
        bad.scales[0] = 0
    else:
        bad = dataclasses.replace(t, scale=t.scale.clone())
        bad.scale[0] = 0
    return bad


def thin_exactness(seed: int) -> dict:
    """The thin-M route of every forward format decodes every weight bit
    for bit as the codec does: with x rows that are unit vectors e_k (and
    an f32 output), row m of ``x @ W`` is row k_m of the weight exactly
    (products by 1.0 and sums of zeros are exact), for NF4, int8, and int4
    symmetric at g128 and with AWQ-style fractional zeros at g32, K rows at
    the edges of absmax blocks, groups, stages and K. It is deterministic:
    at every ``THIN_REPEAT_M`` (each instantiation of the kernel) on both
    ``THIN_REPEAT_SHAPES`` (the TMA path and the plain-load path),
    ``THIN_REPEATS`` launches give the same bytes. And it sees a planted
    fault (``thin_fault``) at M = 8 on both paths."""
    import torch

    from llm_in_practise_tpu_torch.quant import int4

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 13)
    out = {}
    for fmt in FWD_FORMATS:
        mod, plain, _ = fwd_op(fmt)

        def thin(x, t, dtype, mod=mod):
            return mod._forward(x, t, dtype, route="thin")

        for k, n in sorted(set(PROJ_SHAPES.values())):
            w = torch.randn(k, n, device=dev, generator=gen) * 0.02
            rows = [0, 1, 31, 32, 63, 64, 127, 128, 2049, k - 1]
            x = torch.zeros(len(rows), k, device=dev, dtype=torch.bfloat16)
            x[torch.arange(len(rows)), torch.tensor(rows)] = 1
            cases = {fmt: thin_weight(fmt, w)} if fmt != "int4" else {
                "int4 sym_g128": int4.rtn_quantize(w, group_size=INT4_GS),
                "int4 asym_g32_frac": fractional_zero_int4(w, AWQ_GS)}
            for case, t in cases.items():
                y = thin(x, t, torch.float32)
                want = thin_codec_weights(fmt, t)[rows]
                out[f"unit rows {case} K={k} N={n}"] = bool(torch.equal(y, want))
            del w, cases
        for k, n, gs in THIN_REPEAT_SHAPES[fmt]:
            path = thin_path(fmt, k, n, gs)
            t = thin_weight(fmt, torch.randn(k, n, device=dev, generator=gen)
                            * 0.02, gs)
            for m in THIN_REPEAT_M:
                x = torch.randn(m, k, device=dev, generator=gen).to(
                    torch.bfloat16)
                y = thin(x, t, torch.bfloat16)
                out[f"repeats {fmt} {path} M={m} K={k} N={n}"] = all(
                    torch.equal(y, thin(x, t, torch.bfloat16))
                    for _ in range(THIN_REPEATS))
                if m == MAX_SLOTS:
                    ref = plain(x, t, torch.bfloat16)
                    out[f"plain version {fmt} {path} M={m} K={k} N={n}"] = (
                        _rel(y, ref)[1] <= KERNEL_TOL)
                    out[f"planted fault seen {fmt} {path} K={k} N={n}"] = (
                        _rel(thin(x, thin_fault(fmt, t), torch.bfloat16),
                             ref)[1] > KERNEL_TOL)
            del t
    log("thin route, exactness:", json.dumps(out))
    if not all(out.values()):
        raise SystemExit(f"the thin route's weights differ from the codec's, "
                         f"a repeated launch gave other bytes, or a planted "
                         f"fault went unseen: "
                         f"{[k for k, v in out.items() if not v]}")
    return out


def thin_rows(seed: int) -> dict:
    """B1 and B8 below the wgmma threshold: at every Qwen3-8B projection
    shape and every ``THIN_CHECK_M`` row count, the wrapper's route (thin)
    against the plain version, and a second launch for the same bytes.
    Returns the largest error and the rows checked, per format."""
    import torch

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 14)
    out = {}
    for fmt in ("nf4", "int8"):
        mod, plain, route_of = fwd_op(fmt)
        wrapper = getattr(mod, f"{fmt}_matmul")
        worst, checked = 0.0, 0
        for k, n in sorted(set(PROJ_SHAPES.values())):
            t = thin_weight(fmt, torch.randn(k, n, device=dev, generator=gen)
                            * 0.02)
            for m in THIN_CHECK_M:
                x = torch.randn(m, k, device=dev, generator=gen).to(
                    torch.bfloat16)
                y = wrapper(x, t, torch.bfloat16)
                rel = _rel(y, plain(x, t, torch.bfloat16))[1]
                same = torch.equal(y, wrapper(x, t, torch.bfloat16))
                route = route_of(m, k, n)
                if (route != "thin" or not bool(torch.isfinite(y).all())
                        or rel > KERNEL_TOL or not same):
                    raise SystemExit(f"{fmt} forward at M={m} K={k} N={n}: "
                                     f"route {route}, rel {rel}, repeat "
                                     f"equal {same}")
                worst = max(worst, rel)
                checked += 1
            del t
        out[fmt] = {"M": list(THIN_CHECK_M), "shapes_checked": checked,
                    "max_rel_err": worst, "route": "thin",
                    "tol": f"{KERNEL_TOL} * max|plain|"}
    log("thin rows:", json.dumps(out))
    return out


def fwd_crossover(fmt: str, seed: int, flush) -> dict:
    """Every forward route of ``fmt`` (NF4, int4 symmetric with group size
    128, or int8) on one layer's 7 Qwen3-8B projections at every row count
    of ``THIN_CROSSOVER_M``: event times summed over the layer (L2 flushed
    before each launch) and device times (``device_ms``: the kernels' own
    time, without the wrapper's host work), every launch held to its plain
    version. ``faster`` is the route with the least device time (event
    time where the profiler records none). ``measured_from_M`` is the
    smallest row count from which the wgmma route is faster at every
    larger one in the table; the wrapper's ``_route`` takes wgmma from its
    ``WGMMA_MIN_M``, and ``route_agrees`` says whether it picks the fastest
    route at every row count. The routes are the wrapper module's
    ``ROUTES``, so the same function times a tree whose wrappers have
    other routes (an earlier checkout's split-K kernels, say)."""
    import torch

    mod, plain, route_of = fwd_op(fmt)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + {"int4": 7, "nf4": 10, "int8": 11}[fmt])
    weights = {kn: quantize_weight(
        fmt, torch.randn(*kn, device=dev, generator=gen) * 0.02)
        for kn in sorted(set(PROJ_SHAPES.values()))}
    table = []
    for m in THIN_CROSSOVER_M:
        xs = {k: torch.randn(m, k, device=dev, generator=gen).to(
            torch.bfloat16) for k in {k for k, _ in PROJ_SHAPES.values()}}
        ms = dict.fromkeys(mod.ROUTES, 0.0)
        worst = 0.0
        for k, n in PROJ_SHAPES.values():
            t, x = weights[(k, n)], xs[k]
            ref = plain(x, t, torch.bfloat16)
            for route in ms:
                def run(route=route, x=x, t=t):
                    return mod._forward(x, t, torch.bfloat16, route=route)

                out = run()
                rel = _rel(out, ref)[1]
                if not bool(torch.isfinite(out).all()) or rel > KERNEL_TOL:
                    raise SystemExit(f"{fmt} forward ({route}) disagrees "
                                     f"with its plain version at M={m} "
                                     f"K={k} N={n}: {rel}")
                worst = max(worst, rel)
                ms[route] += time_ms(run, 5 if m == TRAIN_M else 10, flush)
            del ref
        dev_ms = {route: device_ms(
            [lambda r=route, x=xs[k], t=weights[(k, n)]:
             mod._forward(x, t, torch.bfloat16, route=r)
             for k, n in PROJ_SHAPES.values()],
            rounds=5 if m == TRAIN_M else 20) for route in mod.ROUTES}
        by = dev_ms if None not in dev_ms.values() else ms
        row = {"M": m, **{f"{r}_ms": v for r, v in ms.items()},
               **{f"{r}_device_ms": v for r, v in dev_ms.items()},
               "faster": min(by, key=by.get), "max_rel_err": worst,
               "routed": route_of(m, *PROJ_SHAPES["q_proj"])}
        log(f"{fmt} crossover:", json.dumps(row))
        table.append(row)
        del xs
    measured = None
    for row in reversed(table):
        if row["faster"] != "wgmma":
            break
        measured = row["M"]
    at = "sym g128" if fmt == "int4" else "kblock" if fmt == "nf4" \
        else "per-channel"
    return {"at": f"one layer's 7 projections, {fmt} {at}", "table": table,
            "measured_from_M": measured, "route_from_M": mod.WGMMA_MIN_M,
            "route_agrees": all(r["routed"] == r["faster"] for r in table)}


def device_ms(calls, rounds: int = 20):
    """Device time of one round of ``calls`` in ms: the summed kernel self
    time under torch.profiler over ``rounds`` rounds, after one warm-up
    round, so the host's work around each launch (the wrapper's checks,
    allocations, the ctypes call) is not counted. None where the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity

    from llm_in_practise_tpu_torch.obs.meter import (
        exclusive_profile as profile,
    )

    for call in calls:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for call in calls:
                call()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / rounds if us else None


def device_ms_each(calls, key: str, rounds: int = 20):
    """Device time of each of ``calls`` in ms, in one round of all of them
    (so each weight is out of L2 by its next launch): the mean, over
    ``rounds`` rounds after one warm-up, of the kernels whose name holds
    ``key``, taken in launch order (each call launches one). None where the
    profiler records no such kernel times."""
    import torch
    from torch.profiler import ProfilerActivity

    from llm_in_practise_tpu_torch.obs.meter import (
        exclusive_profile as profile,
    )

    for call in calls:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for call in calls:
                call()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in sorted(
        (e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA and key in e.name),
        key=lambda e: e.time_range.start)]
    if len(us) != rounds * len(calls):
        return None
    return [sum(us[i::len(calls)]) / rounds / 1e3 for i in range(len(calls))]


def decode_device(seed: int, flush) -> dict:
    """One layer's 7 Qwen3-8B projections at each row count of
    ``DECODE_M``, per forward format (NF4, int4 symmetric g128, int8): the
    wrapper (the route ``_route`` picks) and the library call (one
    torch.matmul on the weight dequantized beforehand; for int8
    ``(x @ q.bf16) * scale``), each as device time (``device_ms``) and as
    event time (``time_ms`` per call, L2 flushed, summed); also the other
    route's device time, and at M = MAX_SLOTS each projection's own device
    time (``device_ms_each``). Rows back to back, so a weight read
    by one projection is out of L2 (108-193 MB a layer) by its next
    round."""
    import torch

    from llm_in_practise_tpu_torch.quant import int4, nf4

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 12)
    out = {}
    for fmt in FWD_FORMATS:
        mod, _, route_of = fwd_op(fmt)
        wrapper = getattr(mod, f"{fmt}_matmul")
        weights = {kn: quantize_weight(
            fmt, torch.randn(*kn, device=dev, generator=gen) * 0.02)
            for kn in sorted(set(PROJ_SHAPES.values()))}
        if fmt == "nf4":
            dense = {kn: nf4.dequantize(t, torch.bfloat16)
                     for kn, t in weights.items()}
        elif fmt == "int4":
            dense = {kn: int4.decode(t) for kn, t in weights.items()}
        else:
            dense = {kn: t.q.to(torch.bfloat16) for kn, t in weights.items()}
        rows = {}
        for m in DECODE_M:
            xs = {k: torch.randn(m, k, device=dev, generator=gen).to(
                torch.bfloat16) for k in {k for k, _ in PROJ_SHAPES.values()}}
            kern, lib = [], []
            for kn in PROJ_SHAPES.values():
                x, t, w = xs[kn[0]], weights[kn], dense[kn]
                kern.append(lambda x=x, t=t: wrapper(x, t, torch.bfloat16))
                if fmt == "int8":
                    lib.append(lambda x=x, w=w, t=t: torch.matmul(x, w)
                               * t.scale)
                else:
                    lib.append(lambda x=x, w=w: torch.matmul(x, w))
            row = {"route": route_of(m, *PROJ_SHAPES["q_proj"]),
                   "bound_ms": sum(matmul_bound(
                       m, k, n, weight_bytes(fmt, k, n))[0]
                       for k, n in PROJ_SHAPES.values()),
                   "device_ms": device_ms(kern),
                   "library_device_ms": device_ms(lib),
                   "ms": sum(time_ms(c, 20, flush) for c in kern),
                   "library_ms": sum(time_ms(c, 20, flush) for c in lib)}
            if m == MAX_SLOTS:  # where a decode step's time goes
                each = device_ms_each(kern, THIN_POLICIES[fmt])
                row["per_projection_device_ms"] = (
                    dict(zip(PROJ_SHAPES, each)) if each else None)
            for route in mod.ROUTES:
                if route != row["route"]:
                    row[f"{route}_device_ms"] = device_ms([
                        lambda x=xs[kn[0]], t=weights[kn], r=route:
                        mod._forward(x, t, torch.bfloat16, route=r)
                        for kn in PROJ_SHAPES.values()])
            log(f"{fmt} decode device time, M={m}:", json.dumps(row))
            rows[m] = row
            del xs, kern, lib
        out[fmt] = rows
        del weights, dense
    return out


def decode_fields(decode: dict, fmt: str) -> dict:
    """A forward's decode rows for the kernel table: device times at
    M = MAX_SLOTS beside the event times, and every DECODE_M row."""
    row = decode[fmt][MAX_SLOTS]
    return {"device_ms": row["device_ms"],
            "library_device_ms": row["library_device_ms"],
            "decode_device": decode[fmt]}


def edge_summary(rows: dict, kernel: str) -> dict:
    """A kernel's ragged-shape checks and whether every one of its launches
    repeated to the same bytes."""
    return {
        "edge_shapes": [
            {f: r.get(f) for f in ("case", "M", "K", "N", "max_rel_err",
                                   "repeat_equal")}
            for key, r in rows.items()
            if key[0] == "edge" and r["kernel"] == kernel],
        "repeat_equal_all": all(r["repeat_equal"] for r in rows.values()
                                if r["kernel"] == kernel)}


def ptq_summary(rows: dict, kernel: str, case: str, m: int) -> dict:
    """One layer's 7 projections at M = ``m``, summed; for a dx kernel also
    its ragged shapes and whether every repeated launch gave the same
    bytes."""
    step = [rows[(kernel, case, m, k, n)] for k, n in PROJ_SHAPES.values()]
    what = "decode step" if m == MAX_SLOTS else "training"
    extra = edge_summary(rows, kernel)
    if "product_ms" in step[0]:  # B9: the product without the scaling
        extra["product_ms"] = sum(r["product_ms"] for r in step)
    return {
        **extra,
        "at": f"one layer's 7 projections at M={m} ({what}), {case}",
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()
                           if r["kernel"] == kernel),
        "ms": sum(r["ms"] for r in step),
        "plain_ms": sum(r["plain_ms"] for r in step),
        "bound_ms": sum(r["bound_ms"] for r in step),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in step)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in step),
        "shapes_checked": sum(r["kernel"] == kernel for r in rows.values()),
        "planted_fault_seen": all(
            r["planted_zero_scale_rel_err"] > KERNEL_TOL
            for r in rows.values()
            if r["kernel"] == kernel and "planted_zero_scale_rel_err" in r),
    }


def build_model(fmt: str, n_layer: int, seed: int):
    """Qwen3-8B width, random weights from a seeded generator on the card,
    block projections quantized to ``fmt`` by the port's codecs."""
    import torch

    from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
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
            state[f"{p}.{sub}.{name}.kernel"] = quantize_weight(fmt, w, gen)
    model = QuantizedModel(Qwen3(cfg, device="meta"), state, device=dev)
    return cfg, model


# the kernel that serves each format's projections
SERVE_KERNEL = {"nf4": "nf4_matmul", "int4": "int4_matmul",
                "awq": "int4_matmul", "int8": "int8_matmul"}
# the device kernels of each forward's routes, as the profiler names them
# (the thin-M kernel's policy, the wgmma mainloop's policy)
ROUTE_KERNEL_KEYS = {"nf4_matmul": ("Nf4Thin", "Nf4Fwd"),
                     "int4_matmul": ("Int4Thin", "Int4Fwd"),
                     "int8_matmul": ("Int8Thin", "Int8Fwd")}


def model_check(model, tok_ids, fmt: str) -> dict:
    """Whole-model logits on a small input: kernels vs plain versions. The
    kernel forward must launch the format's kernel once per projection."""
    import torch

    counter = kernel_counters()[SERVE_KERNEL[fmt]]
    ids = torch.tensor([tok_ids], device=model.device)
    with torch.inference_mode():
        counter.launches = 0
        got = model(ids).float()
        launches = counter.launches
        undo = plain_kernels()
        try:
            want = model(ids).float()
        finally:
            undo()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    n_layer = model.config.n_layer
    res = {"format": fmt, "shape": list(got.shape),
           "finite": bool(torch.isfinite(got).all()),
           "max_abs_err": err, "max_rel_err": err / scale,
           "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                 .float().mean()),
           "kernel_launches": launches,
           "tol": f"{MODEL_TOL} * max|plain|: bf16 activations between "
                  "layers carry the kernels' summation-order differences "
                  "through every layer"}
    if (not res["finite"] or err > MODEL_TOL * scale
            or launches != 7 * n_layer):
        raise SystemExit(f"model logits disagree with the plain path, or "
                         f"{SERVE_KERNEL[fmt]} did not serve all 7 x "
                         f"{n_layer} projections: {res}")
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


def train_tokenizer():
    from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
    from llm_in_practise_tpu_torch.data.sft import IM_END, IM_START

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
    return tok


MODEL_CHECK_TEXT = "The port serves Qwen3 on Hopper."
# the chat requests' topics, one per slot
TOPICS = ("the KV cache", "NF4 quantization", "continuous batching",
          "rotary embeddings", "grouped-query attention", "SwiGLU",
          "the OpenAI API", "Hopper tensor cores")
AWQ_DECODE_TOKENS = 16


def awq_check(tok, seed: int) -> dict:
    """Whole-model logits of an AWQ model at full width, kernels against
    plain versions: each projection runs B6 after the elementwise
    ``x * inv_scale``."""
    import torch

    t0 = time.monotonic()
    _, model = build_model("awq", AWQ_LAYERS, seed)
    torch.cuda.synchronize()
    log(f"model: Qwen3-8B width, {AWQ_LAYERS} layers, AWQ block projections, "
        f"built and quantized in {time.monotonic() - t0:.1f}s")
    res = model_check(model, tok.encode(MODEL_CHECK_TEXT), "awq")
    log("awq model check:", json.dumps(res))
    res["decode"] = awq_decode(model, tok, seed)
    log("awq decode:", json.dumps(res["decode"]))
    return res


def awq_decode(model, tok, seed: int) -> dict:
    """Greedy generation for MAX_SLOTS prompts through the engine on the AWQ
    model (no HTTP): every pass's projections must run on the route that
    ``_route`` picks for its rows, every decode pass on that of MAX_SLOTS
    rows."""
    import torch

    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.serve.engine import (
        InferenceEngine,
        SamplingParams,
    )

    engine = InferenceEngine(model, max_slots=MAX_SLOTS, cache_len=CACHE_LEN,
                             eos_id=tok.token_to_id(IM_END),
                             cache_dtype=torch.bfloat16, seed=seed)
    passes = []  # rows of each prefill pass
    prefill = engine._prefill_batch

    def recording_prefill(batch):
        passes.append(len(batch) * max(len(r.prompt_ids) for _, r, _ in batch))
        return prefill(batch)

    engine._prefill_batch = recording_prefill
    params = SamplingParams(greedy=True, max_tokens=AWQ_DECODE_TOKENS)
    zero_counters()
    reqs = [engine.submit(tok.encode(f"Explain {topic} briefly."), params)
            for topic in TOPICS]
    while engine.step():
        pass
    torch.cuda.synchronize()
    forwards = engine.decode_steps_run + engine.prefill_batches_run
    routes = read_routes()["int4_matmul"]
    launches = read_counters()["int4_matmul"]
    decode_passes = forwards - len(passes)
    want = route_launches("int4", passes + [MAX_SLOTS] * decode_passes,
                          PROJ_SHAPES.values(), AWQ_LAYERS)
    res = {"requests": len(reqs),
           "completion_tokens": sum(r.n_generated for r in reqs),
           "prefill_rows": passes, "decode_passes": decode_passes,
           "launches": launches, "launches_by_route": routes,
           "expected": want}
    if (engine.error is not None or any(r.n_generated < 1 for r in reqs)
            or decode_passes < 1 or routes != want
            or launches != 7 * AWQ_LAYERS * forwards):
        raise SystemExit(f"AWQ decode did not run every projection on the "
                         f"route _route picks: {res}")
    return res


def serve_phase(fmt: str, n_layer: int, seed: int, card: str, tok,
                keep_model: bool = False) -> dict:
    """The serving cell of ``fmt``; with ``keep_model`` the result holds
    the model under ``"model"`` for the next phase."""
    import torch

    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.serve.api import OpenAIServer
    from llm_in_practise_tpu_torch.serve.engine import InferenceEngine

    kernel_name = SERVE_KERNEL[fmt]
    counter = kernel_counters()[kernel_name]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    cfg, model = build_model(fmt, n_layer, seed)
    torch.cuda.synchronize()
    log(f"model: Qwen3-8B width, {n_layer} layers, {fmt} block projections, "
        f"built and quantized in {time.monotonic() - t0:.1f}s")
    mcheck = model_check(model, tok.encode(MODEL_CHECK_TEXT), fmt)
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
    prefill_rows = []  # rows of each prefill pass: the forward route's input
    prefill = engine._prefill_batch

    def recording_prefill(batch):
        prefill_rows.append(len(batch) * max(len(r.prompt_ids)
                                             for _, r, _ in batch))
        return prefill(batch)

    engine._prefill_batch = recording_prefill
    model_name = f"qwen3-8b-{fmt}"
    server = OpenAIServer(engine, tok, model_name=model_name)
    port = server.serve(host="127.0.0.1", port=0, background=True)
    base = f"http://127.0.0.1:{port}"

    def body(i, stream):
        return {"model": model_name, "temperature": 0.0,
                "max_tokens": MAX_TOKENS, "stream": stream, "messages": [
                    {"role": "system", "content": "You are a helpful assistant."},
                    {"role": "user", "content": f"Explain {TOPICS[i]} in a "
                                                "few sentences."}]}

    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            if json.loads(r.read()) != {"status": "ok"}:
                raise SystemExit("/health did not answer ok")
        post_chat(base, body(0, False))  # warm-up, outside the counted run
        torch.cuda.synchronize()
        seen.clear()
        prefill_rows.clear()
        zero_counters()
        steps0 = engine.decode_steps_run + engine.prefill_batches_run
        t_run = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(MAX_SLOTS) as pool:
            futs = [pool.submit(post_chat, base, body(i, i % 2 == 1))
                    for i in range(MAX_SLOTS)]
            results = [f.result() for f in futs]
        wall = time.monotonic() - t_run
        forwards = engine.decode_steps_run + engine.prefill_batches_run - steps0
        counts = read_counters()
        routes = read_routes()[kernel_name]
        passes = list(prefill_rows)
        launches = counts[kernel_name]
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
    if (launches == 0 or launches != per_forward * forwards
            or sum(counts.values()) != launches):
        raise SystemExit(f"{kernel_name} launches {launches} != 7 x "
                         f"{n_layer} x {forwards} forward passes, or another "
                         f"kernel served this model: {counts}")
    if rep[0] != rep[1] or not rep[0]:
        raise SystemExit("the repeated greedy request changed its tokens")
    # prefill passes take the route the wrapper's _route picks for their
    # rows; decode passes (1 to MAX_SLOTS rows) that of MAX_SLOTS rows
    decode_passes = forwards - len(passes)
    want = route_launches(fmt, passes + [MAX_SLOTS] * decode_passes,
                          PROJ_SHAPES.values(), n_layer)
    route_check = {"launches_by_route": routes, "expected": want,
                   "prefill_rows": passes, "decode_passes": decode_passes,
                   "decode_route": fwd_op(fmt)[2](MAX_SLOTS,
                                                  *PROJ_SHAPES["q_proj"])}
    if routes != want:
        raise SystemExit(f"{kernel_name} routes {routes} != {want} for "
                         f"prefill passes of {passes} rows and "
                         f"{decode_passes} decode passes")
    first = sorted(reqs, key=lambda r: r.uid)[0]
    gen_tokens = sum(r.n_generated for r in reqs)
    t_first = min(r.first_token_time for r in reqs)
    t_last = max(r.finish_time for r in reqs)
    out = {
        "card": card, "format": fmt, "layers": n_layer,
        "max_slots": MAX_SLOTS,
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
        "forward_passes": forwards, "kernel": kernel_name,
        "kernel_launches": launches, "kernel_launches_per_forward": per_forward,
        "repeat_identical": rep[0] == rep[1],
        "repeat_matches_batched_run": rep[0] == first.output_ids,
        "model_check": mcheck,
    }
    out["routes"] = route_check
    log("serve:", json.dumps(out))
    out["decode_profile"] = profile_decode(
        engine, [r.prompt_ids for r in reqs], kernel_name)
    log("decode profile:", json.dumps(out["decode_profile"]))
    res = {"launches": launches, "serve": out, "routes": routes}
    if keep_model:
        res["model"] = model
    return res


def profile_decode(engine, prompts, kernel_name: str, steps: int = 16
                   ) -> dict:
    """Where a decode step's time goes, after the counted run: the wall
    time of ``steps`` engine steps over a full batch (no profiler), and the
    device time of their kernels (torch.profiler, a second window).
    Kernels run on one stream, so their summed time is the device's busy
    time."""
    import torch
    from torch.profiler import ProfilerActivity

    from llm_in_practise_tpu_torch.obs.meter import (
        exclusive_profile as profile,
    )

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
    kernel_us = sum(e.self_device_time_total for e in kernels
                    if any(key in e.key
                           for key in ROUTE_KERNEL_KEYS[kernel_name]))
    return {
        "batch": len(prompts), "steps": steps,
        "step_wall_ms": wall_ms,
        "step_device_ms": device_us / 1e3 / steps,
        "device_busy_share": device_us / 1e3 / steps / wall_ms,
        "kernel_share_of_device": kernel_us / device_us,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "top_kernels_ms_per_step": {
            e.key[:60]: e.self_device_time_total / 1e3 / steps for e in top},
    }


# serve_sched: the engine's scheduling paths (chunked prefill, multi-step
# decode, the fused mixed step, admission control) at Qwen3-8B width and
# depth on the NF4 model, every decode block and fused step a CUDA graph
SCHED = dict(chunked_prefill=256, decode_steps=8, mixed_step=True,
             max_queue=4)
SCHED_LONG = (700, 900)      # prompt tokens of the long requests
SCHED_LONG_TOKENS = 32       # new tokens of a long request
SCHED_FIRST_SHORT = 6        # short requests before the long ones
SCHED_PROFILE_BLOCKS = 4     # decode blocks in each timing window


def chat(content: str) -> list[dict]:
    return [{"role": "system", "content": "You are a helpful assistant."},
            {"role": "user", "content": content}]


def prompt_ids(tok, messages) -> list[int]:
    """The token ids the HTTP server gives ``messages``."""
    from types import SimpleNamespace

    from llm_in_practise_tpu_torch.serve.api import build_prompt

    return tok.encode(build_prompt([SimpleNamespace(**m) for m in messages]))


def long_messages(tok, target: int, start: int) -> list[dict]:
    """A document question whose chat prompt is ``target`` tokens, or the
    nearest below that whole words of SURVEY.md from word ``start`` give."""
    survey = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "SURVEY.md")
    with open(survey, encoding="utf-8") as f:
        words = f.read().split()
    words = (words * 2)[start % len(words):][:4 * target]

    def msgs(k):
        return chat("Summarize this document: " + " ".join(words[:k]))

    lo, hi = 1, len(words)   # the most words whose prompt fits
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if len(prompt_ids(tok, msgs(mid))) <= target:
            lo = mid
        else:
            hi = mid - 1
    return msgs(lo)


def sched_traffic(tok, seed: int) -> list[list[tuple]]:
    """The waves of serve_sched as (messages, max_tokens): 6 short chats
    in two groups of 3 (a group of more than ``max_queue`` would be shed
    before a step could admit it); 2 long prompts (700 and 900 tokens)
    that chunk-prefill while the chats decode; 2 more chats and 2 more
    long prompts, which queue."""
    import random

    rng = random.Random(seed)
    shorts = [chat(f"Explain {topic} in a few sentences.")
              for topic in TOPICS]
    longs = [long_messages(tok, n, rng.randrange(1 << 30))
             for n in SCHED_LONG * 2]
    half = SCHED_FIRST_SHORT // 2
    return [[(m, MAX_TOKENS) for m in shorts[:half]],
            [(m, MAX_TOKENS) for m in shorts[half:SCHED_FIRST_SHORT]],
            [(m, SCHED_LONG_TOKENS) for m in longs[:2]],
            [(m, MAX_TOKENS) for m in shorts[SCHED_FIRST_SHORT:]]
            + [(m, SCHED_LONG_TOKENS) for m in longs[2:]]]


def sched_direct(engine, tok, traffic, mixed_step: bool) -> dict:
    """The traffic through ``engine.submit`` and ``engine.step`` (no
    thread, so the schedule is the same in every run): each of the first
    three waves followed by one step (its admission and a block), then
    the last wave (it queues) and one more request, which ``max_queue``
    must shed."""
    from llm_in_practise_tpu_torch.serve.engine import SamplingParams

    engine.mixed_step = mixed_step
    reqs = []

    def submit(wave):
        for messages, max_tokens in wave:
            reqs.append(engine.submit(prompt_ids(tok, messages),
                                      SamplingParams(greedy=True,
                                                     max_tokens=max_tokens)))

    blocks0 = engine.mixed_blocks
    for wave in traffic[:-1]:
        submit(wave)
        engine.step()
    submit(traffic[-1])
    burst = engine.submit(prompt_ids(tok, traffic[0][0][0]),
                          SamplingParams(greedy=True, max_tokens=MAX_TOKENS))
    while engine.step():
        pass
    return {"tokens": [r.output_ids for r in reqs],
            "finish": [r.finish_reason for r in reqs],
            "burst_finish": burst.finish_reason,
            "mixed_blocks": engine.mixed_blocks - blocks0}


def post_429(base: str, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def quantiles(values) -> dict:
    import numpy as np

    v = np.asarray(list(values), dtype=np.float64)
    return {"p50": float(np.percentile(v, 50)),
            "p99": float(np.percentile(v, 99)), "n": int(v.size)}


def wait_for(cond, what: str, timeout_s: float = 120.0) -> None:
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout_s:
            raise SystemExit(f"serve_sched: timed out waiting for {what}")
        time.sleep(0.002)


def sched_http(engine, tok, traffic, model_name: str) -> dict:
    """The traffic over HTTP, the main path: the first group of chats;
    once it is admitted the second; after their first decode block the
    long prompts; once those are in slots the last wave and a burst past
    ``max_queue``, submitted while the engine loop waits at the start of
    its next admission (so the burst finds the queue full whatever the
    timing), which must get 429 ``queue_full``. The kernels' counters are
    zeroed just before and read just after."""
    from llm_in_practise_tpu_torch.serve.api import OpenAIServer

    seen = []
    submit = engine.submit

    def recording_submit(*args, **kwargs):
        req = submit(*args, **kwargs)
        seen.append(req)
        return req

    engine.submit = recording_submit
    prefill_rows = []
    prefill = engine._prefill_batch

    def recording_prefill(batch):
        prefill_rows.append(len(batch) * max(len(r.prompt_ids)
                                             for _, r, _ in batch))
        return prefill(batch)

    engine._prefill_batch = recording_prefill
    mixed_n = []
    mixed = engine._mixed_dispatch

    def recording_mixed(active, n):
        mixed_n.append(n)
        return mixed(active, n)

    engine._mixed_dispatch = recording_mixed
    gate = threading.Event()   # cleared: the next admission waits
    gate.set()
    admit = engine._admit

    def gated_admit():
        gate.wait()
        return admit()

    engine._admit = gated_admit
    server = OpenAIServer(engine, tok, model_name=model_name)
    port = server.serve(host="127.0.0.1", port=0, background=True)
    base = f"http://127.0.0.1:{port}"
    names = ("decode_steps_run", "prefill_batches_run", "chunk_batches_run",
             "chunk_slots_run", "mixed_blocks", "multi_blocks",
             "dispatches_total", "requests_shed")

    def body(i, messages, max_tokens):
        return {"model": model_name, "temperature": 0.0,
                "max_tokens": max_tokens, "stream": i % 2 == 0,
                "messages": messages}

    try:
        zero_counters()
        replays0 = engine.graphs.replays
        before = {k: getattr(engine, k) for k in names}
        t_run = time.monotonic()
        futs, i = [], 0
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            last = len(traffic) - 1
            for w, wave in enumerate(traffic):
                if w == last:
                    gate.clear()
                for messages, max_tokens in wave:
                    futs.append(pool.submit(post_chat, base,
                                            body(i, messages, max_tokens)))
                    i += 1
                if w < last:   # the wave is in slots
                    wait_for(lambda: len(seen) == i
                             and engine.pending.qsize() == 0,
                             f"wave {w}'s admission")
                if w == 1:     # every chat has its first block's tokens
                    wait_for(lambda: all(
                        r.n_generated > 1 or r.finish_reason is not None
                        for r in seen), "the chats' first block")
                if w == last:
                    try:
                        wait_for(lambda: engine.pending.qsize() == len(wave),
                                 "wave 3 to queue")
                        status, err = post_429(
                            base, body(0, traffic[0][0][0], MAX_TOKENS))
                    finally:
                        gate.set()
            results = [f.result() for f in futs]
        wall = time.monotonic() - t_run
        counts = read_counters()
        routes = read_routes()["nf4_matmul"]
        after = {k: getattr(engine, k) for k in names}
        replays = engine.graphs.replays - replays0
    finally:
        server.shutdown()
        engine.submit = submit
        engine._prefill_batch = prefill
        engine._mixed_dispatch = mixed
        engine._admit = admit
    if engine.error is not None:
        raise SystemExit(f"serve_sched: engine failed: {engine.error!r}")
    delta = {k: after[k] - before[k] for k in names}
    reqs = [r for r in seen if r.finish_reason != "queue_full"]
    return {"results": results, "reqs": reqs, "wall_s": wall, "t0": t_run,
            "counts": counts, "routes": routes, "delta": delta,
            "graph_replays": replays, "prefill_rows": prefill_rows,
            "mixed_n": mixed_n, "burst": {"status": status, "body": err}}


def sched_profile(engine, tok) -> dict:
    """One decode-only stretch over every slot (no prefill in flight):
    host wall per block (no profiler), then the device time of as many
    blocks under torch.profiler. Each block is one graph replay."""
    import torch
    from torch.profiler import ProfilerActivity

    from llm_in_practise_tpu_torch.obs.meter import (
        exclusive_profile as profile,
    )

    from llm_in_practise_tpu_torch.serve.engine import SamplingParams

    n = engine.decode_steps
    params = SamplingParams(greedy=True,
                            max_tokens=(2 * SCHED_PROFILE_BLOCKS + 2) * n)
    for topic in TOPICS:
        engine.submit(prompt_ids(tok, chat(f"Explain {topic} briefly.")),
                      params)
    engine.step()           # admission and the first block
    torch.cuda.synchronize()
    replays0 = engine.graphs.replays
    launches0 = read_counters()["nf4_matmul"]
    t0 = time.monotonic()
    for _ in range(SCHED_PROFILE_BLOCKS):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3 / SCHED_PROFILE_BLOCKS
    replays = engine.graphs.replays - replays0
    launches = read_counters()["nf4_matmul"] - launches0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(SCHED_PROFILE_BLOCKS):
            engine.step()
        torch.cuda.synchronize()
    while engine.step():
        pass
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    out = {"decode_steps_per_block": n, "slots": engine.max_slots,
           "block_wall_ms": wall_ms, "graph_launches_per_block":
           replays / SCHED_PROFILE_BLOCKS,
           "nf4_launches_per_block": launches / SCHED_PROFILE_BLOCKS,
           "host_wall_per_decode_step_ms": wall_ms / n}
    if replays != SCHED_PROFILE_BLOCKS:
        raise SystemExit(f"serve_sched: {replays} graph replays in "
                         f"{SCHED_PROFILE_BLOCKS} decode blocks")
    if device_us == 0:
        out["device_per_decode_step_ms"] = "not measured"
        return out
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    block_ms = device_us / 1e3 / SCHED_PROFILE_BLOCKS
    out.update({
        "device_per_decode_step_ms": block_ms / n,
        "device_busy_share": block_ms / wall_ms,
        "kernels_per_block": sum(e.count for e in kernels)
        / SCHED_PROFILE_BLOCKS,
        "top_kernels_ms_per_block": {
            e.key[:60]: e.self_device_time_total / 1e3 / SCHED_PROFILE_BLOCKS
            for e in top}})
    return out


def sched_sampled(engine) -> dict:
    """A sampled decode block (temperature 0.8, top-k 50, top-p 0.9, the
    noise drawn from the engine's generator before each run) through the
    engine's graph runner twice: the first run captures the variant, the
    second replays it; :func:`replay_check` then holds it to its eager
    body."""
    import numpy as np
    import torch

    g, b, n = engine.graphs, engine.max_slots, engine.decode_steps
    arrays = dict(tokens=np.arange(b, dtype=np.int64) + 100,
                  index=np.arange(b, dtype=np.int64) * 97 + 40,
                  temperature=np.full(b, 0.8, np.float32),
                  top_k=np.full(b, 50, np.int64),
                  top_p=np.full(b, 0.9, np.float32),
                  greedy=np.zeros(b, bool))
    replays0 = g.replays
    toks = []
    with torch.inference_mode():
        for _ in range(2):
            out = g.run("decode", n, all_greedy=False,
                        generator=engine.generator, **arrays)
            toks.append(out["toks"].cpu())
    vocab = engine.model.config.vocab_size
    res = {"captured": ("decode", n, False, None, None) in g.graphs,
           "replays": g.replays - replays0,
           "tokens_in_vocab": all(bool(((t >= 0) & (t < vocab)).all())
                                  for t in toks),
           "draws_differ": not torch.equal(toks[0], toks[1])}
    if not (res["captured"] and res["replays"] == 1
            and res["tokens_in_vocab"]):
        raise SystemExit(f"serve_sched: the sampled block failed: {res}")
    return res


def replay_check(engine, seed: int) -> dict:
    """Every captured variant, replayed once, against its eager body run
    on the card with the kernels, on copies of the same cache and inputs:
    tokens, next index and every KV row must be identical bytes."""
    import torch

    gen = torch.Generator(device=engine.device)
    gen.manual_seed(seed)
    saved = [(layer["k"].clone(), layer["v"].clone()) for layer in engine.cache]

    def restore():
        for layer, (k, v) in zip(engine.cache, saved):
            layer["k"].copy_(k)
            layer["v"].copy_(v)

    out = {}
    with torch.inference_mode():   # as the engine's steps run
        for key in sorted(engine.graphs.graphs):
            kind, n, all_greedy = key[:3]
            out[f"{kind} n={n} greedy={all_greedy}"] = replay_one(
                engine, key, gen, restore)
    restore()
    del saved
    if not out or not all(all(r.values()) for r in out.values()):
        raise SystemExit(f"serve_sched: a replay differs from its eager "
                         f"body: {out}")
    return out


def replay_one(engine, key, gen, restore) -> dict:
    """One variant of :func:`replay_check`: set the static inputs (every
    row at its own depth, inside the fused step's bounds), replay, keep
    the outputs and the cache, restore the cache, run the eager body."""
    import torch

    g = engine.graphs
    x = g.inputs
    b, c = engine.max_slots, engine.chunked_prefill
    dev = engine.device
    vocab = engine.model.config.vocab_size
    kind, n, all_greedy = key[:3]
    graph, static_out, _ = g.graphs[key]
    index = torch.arange(b, device=dev) * 97 + 40
    x["tokens"].copy_(torch.randint(0, vocab, (b,), device=dev,
                                    generator=gen))
    x["index"].copy_(index)
    x["temperature"].fill_(0.8)
    x["top_k"].fill_(50)
    x["top_p"].fill_(0.9)
    x["greedy"].copy_(torch.arange(b, device=dev) % 2 == 0)
    if all_greedy:
        x["greedy"].fill_(True)
    else:
        g.noise[:n].uniform_(0.0, 1.0, generator=gen)
    if kind == "mixed":
        lens = torch.tensor([c, c // 2, 0, 0, c, 0, 1, 0], device=dev)[:b]
        x["chunk_ids"].copy_(torch.randint(0, vocab, (b, c), device=dev,
                                           generator=gen))
        x["starts"].copy_(index)
        x["lens"].copy_(lens)
        x["advance"].copy_((lens == 0) * n)
    restore()
    graph.replay()
    torch.cuda.synchronize()
    got = {k: v.clone() for k, v in static_out.items()}
    got_kv = [(layer["k"].clone(), layer["v"].clone())
              for layer in engine.cache]
    restore()
    want = g._body(key)
    torch.cuda.synchronize()
    same_out = all(torch.equal(got[k], want[k]) for k in got)
    same_kv = all(torch.equal(k, layer["k"]) and torch.equal(v, layer["v"])
                  for (k, v), layer in zip(got_kv, engine.cache))
    return {"tokens_index_identical": same_out, "kv_identical": same_kv}


def sched_phase(model, tok, seed: int, card: str) -> dict:
    """serve_sched on ``model`` (Qwen3-8B width, NF4, full depth): the
    traffic of :func:`sched_traffic` fused, then sequential
    (``mixed_step=False``) through the engine directly (their greedy
    tokens must be identical), then fused over HTTP (the counted main
    path), then a decode-only profile and the replay-vs-eager check of
    every captured variant. One engine serves all of them; its graphs are
    captured on first use."""
    import torch

    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.serve.engine import InferenceEngine

    torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngine(model, max_slots=MAX_SLOTS, cache_len=CACHE_LEN,
                             eos_id=tok.token_to_id(IM_END),
                             cache_dtype=torch.bfloat16, seed=seed, **SCHED)
    traffic = sched_traffic(tok, seed)
    lens = [[len(prompt_ids(tok, m)) for m, _ in wave] for wave in traffic]
    log("serve_sched prompt tokens per wave:", json.dumps(lens))
    t0 = time.monotonic()
    fused = sched_direct(engine, tok, traffic, mixed_step=True)
    t_fused = time.monotonic() - t0
    t0 = time.monotonic()
    seq = sched_direct(engine, tok, traffic, mixed_step=False)
    t_seq = time.monotonic() - t0
    engine.mixed_step = True
    n_req = sum(len(w) for w in traffic)
    direct = {"fused_s": t_fused, "sequential_s": t_seq,
              "fused_mixed_blocks": fused["mixed_blocks"],
              "sequential_mixed_blocks": seq["mixed_blocks"],
              "tokens_identical": fused["tokens"] == seq["tokens"],
              "finish": fused["finish"],
              "burst_finish": [fused["burst_finish"], seq["burst_finish"]]}
    log("serve_sched direct runs:", json.dumps(direct))
    if (fused["tokens"] != seq["tokens"] or fused["finish"] != seq["finish"]
            or len(fused["tokens"]) != n_req
            or any(not t for t in fused["tokens"])):
        raise SystemExit("serve_sched: the fused and the sequential runs "
                         "gave different greedy tokens")
    if fused["mixed_blocks"] < 1 or seq["mixed_blocks"] != 0:
        raise SystemExit(f"serve_sched: mixed blocks {direct}")
    if direct["burst_finish"] != ["queue_full", "queue_full"]:
        raise SystemExit(f"serve_sched: max_queue shed nothing: {direct}")

    http = sched_http(engine, tok, traffic, "qwen3-8b-nf4-sched")
    d = http["delta"]
    forwards = (d["decode_steps_run"] + d["prefill_batches_run"]
                + d["chunk_batches_run"] + d["chunk_slots_run"])
    c = engine.chunked_prefill
    rows = (http["prefill_rows"] + [MAX_SLOTS] * d["decode_steps_run"]
            + [MAX_SLOTS * c] * d["chunk_batches_run"]
            + [c] * d["chunk_slots_run"])
    want = route_launches("nf4", rows, PROJ_SHAPES.values(), N_LAYER)
    per_forward = 7 * N_LAYER
    launches = http["counts"]["nf4_matmul"]
    results = http["results"]
    checks = {
        "launches_by_route": http["routes"], "expected": want,
        "decode_forwards": d["decode_steps_run"],
        "chunk_forwards": d["chunk_batches_run"] + d["chunk_slots_run"],
        "prefill_rows": http["prefill_rows"],
        "thin_from_decode": per_forward * d["decode_steps_run"],
        "wgmma_from_chunks": per_forward * (d["chunk_batches_run"]
                                            + d["chunk_slots_run"]),
        "mixed_block_lengths": http["mixed_n"],
        "graph_replays": http["graph_replays"],
        "dispatches": d["dispatches_total"],
        "burst": http["burst"], "streams_done": sum(
            r.get("done", False) for r in results)}
    log("serve_sched http checks:", json.dumps(checks))
    if (http["routes"] != want or launches != per_forward * forwards
            or sum(http["counts"].values()) != launches
            or not http["routes"]["thin"] or not http["routes"]["wgmma"]):
        raise SystemExit(f"serve_sched: nf4_matmul launches {launches} / "
                         f"{http['routes']} disagree with the engine's "
                         f"counters ({forwards} forwards): {checks}")
    if not http["mixed_n"] or max(http["mixed_n"]) < 2:
        raise SystemExit(f"serve_sched: no fused mixed block with n > 1: "
                         f"{http['mixed_n']}")
    if http["burst"]["status"] != 429 or http["burst"]["body"].get(
            "error", {}).get("code") != "queue_full":
        raise SystemExit(f"serve_sched: the burst got {http['burst']}")
    if len(results) != n_req or any(
            r["finish_reason"] not in ("stop", "length") for r in results):
        raise SystemExit(f"serve_sched: bad responses {results}")
    reqs = http["reqs"]
    short = [r for r in reqs if r.params.max_tokens == MAX_TOKENS]
    long = [r for r in reqs if r.params.max_tokens == SCHED_LONG_TOKENS]

    def lat(rs):
        return {"ttft_s": quantiles(r.ttft_s for r in rs),
                "tpot_s": quantiles(r.tpot_s for r in rs
                                    if r.tpot_s is not None)}

    profile_out = sched_profile(engine, tok)
    log("serve_sched decode profile:", json.dumps(profile_out))
    sampled = sched_sampled(engine)
    log("serve_sched sampled block:", json.dumps(sampled))
    replay = replay_check(engine, seed)
    log("serve_sched replay vs eager:", json.dumps(replay))
    g = engine.graphs
    out = {
        "card": card, "format": "nf4", "layers": N_LAYER,
        "max_slots": MAX_SLOTS, "cache_len": CACHE_LEN, "kv_dtype": "bfloat16",
        **{k: v for k, v in SCHED.items()}, "requests": len(reqs),
        "prompt_tokens": lens, "wall_s": http["wall_s"],
        "completion_tokens": sum(r.n_generated for r in reqs),
        "short": lat(short), "long": lat(long),
        "per_request": [  # in submission order: prompt, new tokens, times
            {"prompt": len(r.prompt_ids), "tokens": r.n_generated,
             "submit_s": r.submit_time - http["t0"], "ttft_s": r.ttft_s,
             "tpot_s": r.tpot_s} for r in reqs],
        "direct": direct, "checks": checks, "profile": profile_out,
        "capture_s": {f"{k} n={n} greedy={a}": s
                      for (k, n, a, *_), s in sorted(g.capture_s.items())},
        "sampled_block": sampled, "graph_pool_mib": g.pool_bytes / 2**20,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "replay_check": replay}
    log("serve_sched:", json.dumps(out))
    return {"launches": launches, "routes": http["routes"], "sched": out}


# serve_paged: paged KV and the prefix cache (vLLM's --enable-prefix-caching,
# --kv-cache-dtype fp8 and a page pool below the contiguous reservation,
# as examples/serve_openai.py:144,243-268 mirrors them) on the NF4 model
PAGED = dict(decode_steps=8)
PAGED_PREFIX = 512           # shared system prompt tokens: 32 pages of 16
PAGED_TURNS = tuple(24 + 5 * i for i in range(MAX_SLOTS))  # user turns
PAGED_POOL = 2048            # --kv-pool-tokens of the pool-pressure run
PAGED_PRESSURE_PROMPT = 300  # prompt tokens of a pool-pressure request
PAGED_PRESSURE_TOKENS = 256  # and its new tokens
PAGED_INT8_LAYERS = 2
PAGED_TOP_K = 5              # teacher-forced check: an emitted token is
#                              among the reference logits' top 5


def paged_traffic(tok) -> tuple[list[int], list[list[int]]]:
    """The shared-prefix traffic, as token ids: a system prompt of exactly
    ``PAGED_PREFIX`` tokens (ChatML from words of SURVEY.md) and 8 user
    turns of 24-59 tokens that differ in their first page."""
    survey = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "SURVEY.md")
    with open(survey, encoding="utf-8") as f:
        words = f.read().split()
    system = prompt_ids(tok, [{"role": "system",
                               "content": " ".join(words[:1500])}])
    if len(system) < PAGED_PREFIX:
        raise SystemExit(f"serve_paged: a system prompt of {len(system)} "
                         f"tokens, under {PAGED_PREFIX}")
    turns = []
    for i, n in enumerate(PAGED_TURNS):
        text = (f"Question {i + 1}: explain {TOPICS[i]} in a few sentences. "
                + " ".join(words[2000 + 97 * i:][:200]))
        turns.append(tok.encode(text)[:n])
    return system[:PAGED_PREFIX], turns


def paged_engine(model, tok, seed: int, **kw):
    import torch

    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.serve.engine import InferenceEngine

    kw.setdefault("cache_dtype", torch.bfloat16)
    return InferenceEngine(model, max_slots=MAX_SLOTS, cache_len=CACHE_LEN,
                           eos_id=tok.token_to_id(IM_END), seed=seed,
                           **{**PAGED, **kw})


def paged_drive(engine, system, turns) -> dict:
    """The shared-prefix traffic through ``engine``, one step at a time,
    the same steps for every engine: the system prompt alone (2 new
    tokens), then turn 0, which decodes two steps before the 7 sharers
    arrive together. Greedy, ``MAX_TOKENS`` new tokens each."""
    from llm_in_practise_tpu_torch.serve.engine import SamplingParams

    sp = SamplingParams(greedy=True, max_tokens=MAX_TOKENS)
    first = engine.submit(system, SamplingParams(greedy=True, max_tokens=2))
    while engine.step():
        pass
    reqs = [engine.submit(system + turns[0], sp)]
    shared_peak = 0

    def step():
        nonlocal shared_peak
        busy = engine.step()
        if engine.paged is not None:
            shared_peak = max(shared_peak, engine.paged.pool.shared_pages)
        return busy

    step()
    step()
    reqs += [engine.submit(system + t, sp) for t in turns[1:]]
    while step():
        pass
    if engine.error is not None:
        raise SystemExit(f"serve_paged: engine failed: {engine.error!r}")
    pc = engine.prefix_cache
    g = engine.graphs
    return {"system": list(first.output_ids),
            "graphs": [{"kind": k, "n": n, "greedy": a, "width": w,
                        "capture_s": c}
                       for (k, n, a, w, _), c in g.capture_s.items()],
            "graph_pool_mib": g.pool_bytes / 2**20,
            "tokens": [list(r.output_ids) for r in reqs],
            "finish": [r.finish_reason for r in reqs],
            "shared_pages_peak": shared_peak,
            "hits": pc.hits if pc else 0,
            "tokens_saved": pc.tokens_saved if pc else 0,
            "tpot_p50_s": statistics.median(r.tpot_s for r in reqs
                                            if r.tpot_s is not None)}


def first_divergence(a: list[list[int]], b: list[list[int]]) -> list:
    """Per stream: the first token index where ``a`` and ``b`` part, or
    None where they are equal."""
    out = []
    for x, y in zip(a, b):
        out.append(None if x == y else next(
            (i for i, (p, q) in enumerate(zip(x, y)) if p != q),
            min(len(x), len(y))))
    return out


def system_pages(engine, system) -> list:
    """The per-layer K and V rows of the system prompt, read back from the
    pages the prefix index holds for it."""
    import numpy as np
    import torch

    P = engine.paged.page_size
    pages = engine.prefix_cache.lookup(system + [0])
    try:
        rows = torch.from_numpy(np.concatenate(
            [np.arange(p * P, (p + 1) * P) for p in pages])).to(
                engine.device)
        return [{k: layer[k].index_select(0, rows).clone()
                 for k in ("k", "v")} for layer in engine.paged.kv]
    finally:
        engine.paged.pool.release(pages)


def teacher_forced(model, prompts, streams) -> list:
    """Per stream, how many of its tokens are among the top
    ``PAGED_TOP_K`` of the model's logits over the prompt and the stream
    before it, in one cached forward (dense attention, no flash): a
    check that tolerates a rounding-level near-tie but not a token from
    corrupted KV. The forward's kernel launches are not counted."""
    import torch

    from llm_in_practise_tpu_torch.ops import launch_count

    before = launch_count.snapshot()
    out = []
    try:
        with torch.inference_mode():
            for prompt, toks in zip(prompts, streams):
                if not toks:
                    out.append(0)
                    continue
                ids = torch.tensor([prompt + toks[:-1]],
                                   device=model.device)
                cache = model.init_cache(1, ids.shape[1],
                                         dtype=torch.bfloat16)
                logits, _ = model(ids, cache=cache)
                top = logits[0, len(prompt) - 1:].topk(PAGED_TOP_K).indices
                want = torch.tensor(toks, device=model.device)[:, None]
                out.append(int((top == want).any(-1).sum()))
    finally:
        launch_count.restore(before)
    return out


def gather_scatter_ms(engine, width: int, reps: int = 20) -> dict:
    """Device ms (CUDA events) of one paged decode step's view gather and
    window scatter at ``width``, on the engine's pool and block tables."""
    import numpy as np
    import torch

    from llm_in_practise_tpu_torch.serve.paged_kv import (
        gather_view,
        scatter_window,
        window_idx,
    )

    pg, b = engine.paged, engine.max_slots
    dev = engine.device
    index = np.minimum(engine._decode_index(), width - 1)
    gidx = torch.from_numpy(pg.gather_idx(width).reshape(-1).astype(
        np.int64)).to(dev)
    vidx = torch.from_numpy(window_idx(index, width, 1).reshape(-1)).to(dev)
    # the write-back of a step whose rows are all dead: the trash page
    sidx = torch.from_numpy(pg.scatter_idx(index, np.zeros(b, np.int64), 1)
                            .reshape(-1).astype(np.int64)).to(dev)
    idx_t = torch.from_numpy(index).to(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with torch.inference_mode():
        g, _ = gather_view(pg, gidx, b, idx_t)
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(reps):
            g, _ = gather_view(pg, gidx, b, idx_t)
        ev[1].record()
        for _ in range(reps):
            scatter_window(pg, g, vidx, sidx)
        ev[2].record()
        torch.cuda.synchronize()
    view_bytes = pg.view_bytes(width)
    return {"width": width, "view_mib": view_bytes / 2**20,
            "gather_ms": ev[0].elapsed_time(ev[1]) / reps,
            "scatter_ms": ev[1].elapsed_time(ev[2]) / reps,
            # the gather reads and writes the view once: its bound
            "gather_bound_ms": 2 * view_bytes / H100_BYTES_PER_S * 1e3}


def paged_tpot(engine, prompts) -> float:
    """TPOT p50 of the 8 chats through ``engine``, all submitted at once
    and stepped to the end (no profiler)."""
    import torch

    from llm_in_practise_tpu_torch.serve.engine import SamplingParams

    params = SamplingParams(greedy=True, max_tokens=MAX_TOKENS)
    reqs = [engine.submit(p, params) for p in prompts]
    while engine.step():
        pass
    torch.cuda.synchronize()
    return statistics.median(r.tpot_s for r in reqs if r.tpot_s is not None)


def paged_numerics(seed: int) -> dict:
    """Readings, not checks: why byte identity needs equal shapes on the
    card (decode attention over a 512-wide view against the same keys in
    a 1024-wide one; a 20-row suffix against 20 one-row decodes), and
    what torch's plain fp8 cast does there past 448."""
    import torch

    from llm_in_practise_tpu_torch.ops.attention import dense_attention

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen).bfloat16()

    # rows at depths up to 500, all inside the narrow view; 4 draws
    off = torch.tensor([100, 200, 300, 400, 450, 480, 495, 500], device=dev)
    width_diff = 0.0
    with torch.inference_mode():
        for _ in range(4):
            q, k, v = (rand(8, 1, 32, 128), rand(8, 1024, 8, 128),
                       rand(8, 1024, 8, 128))
            wide = dense_attention(q, k, v, q_offset=off)
            narrow = dense_attention(q, k[:, :512].contiguous(),
                                     v[:, :512].contiguous(), q_offset=off)
            width_diff = max(width_diff,
                             float((wide - narrow).float().abs().max()))
        qs = rand(1, 20, 32, 128)
        suffix = dense_attention(qs, k[:1], v[:1], q_offset=300)
        rows = torch.cat([dense_attention(
            qs[:, j:j + 1], k[:1], v[:1],
            q_offset=torch.tensor([300 + j], device=dev)) for j in range(20)],
            1)
        cast = torch.tensor([447.0, 500.0, -1e4], device=dev).to(
            torch.float8_e4m3fn).float().tolist()
    return {"decode_attention_w512_vs_w1024_max_abs": width_diff,
            "suffix20_vs_decodes_max_abs":
            float((suffix - rows).float().abs().max()),
            "plain_fp8_cast_447_500_-1e4": [str(x) for x in cast]}


def paged_http(model, tok, seed: int, card: str) -> dict:
    """A server built with the CLI's defaults (paged, pages of 16, a pool
    of max_slots x cache_len) answers the NF4 cell's 8 chats (4
    streamed); ``GET /debug/kv`` reports the paged layout; a second one
    with a pool of half a slot's cache answers a 700-token prompt with
    422, streamed or not."""
    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.serve.__main__ import (
        build_engine,
        build_parser,
    )
    from llm_in_practise_tpu_torch.serve.api import OpenAIServer

    argv = ["--tokenizer_path", "-", "--max_slots", str(MAX_SLOTS),
            "--cache_len", str(CACHE_LEN), "--kv-cache-dtype", "bfloat16"]
    eos = tok.token_to_id(IM_END)
    engine = build_engine(model, build_parser().parse_args(argv), eos_id=eos)
    small = build_engine(model, build_parser().parse_args(
        argv + ["--kv-pool-tokens", str(CACHE_LEN // 2)]), eos_id=eos)
    seen = []
    submit = engine.submit

    def recording_submit(*args, **kwargs):
        seen.append(submit(*args, **kwargs))
        return seen[-1]

    engine.submit = recording_submit
    servers = [OpenAIServer(e, tok, model_name="qwen3-8b-nf4-paged")
               for e in (engine, small)]
    bases = []
    for server in servers:
        port = server.serve(host="127.0.0.1", port=0, background=True)
        bases.append(f"http://127.0.0.1:{port}")

    def body(messages, stream=False):
        return {"model": "qwen3-8b-nf4-paged", "temperature": 0.0,
                "max_tokens": MAX_TOKENS, "stream": stream,
                "messages": messages}

    try:
        post_chat(bases[0], body(ckpt_chats()[0]))   # warm-up
        seen.clear()
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(MAX_SLOTS) as pool:
            futs = [pool.submit(post_chat, bases[0],
                                body(m, i % 2 == 1))
                    for i, m in enumerate(ckpt_chats())]
            results = [f.result() for f in futs]
        wall = time.monotonic() - t0
        with urllib.request.urlopen(bases[0] + "/debug/kv", timeout=60) as r:
            debug_kv = json.loads(r.read())
        big = long_messages(tok, 700, 0)
        status, err = post_429(bases[1], body(big))
        status_stream, err_stream = post_429(bases[1], body(big, True))
    finally:
        for s in servers:
            s.shutdown()
    if engine.error is not None:
        raise SystemExit(f"serve_paged: engine failed: {engine.error!r}")
    reqs = list(seen)
    res = {"requests": len(results), "wall_s": wall,
           "streams_done": sum(r.get("done", False) for r in results),
           "finish": [r["finish_reason"] for r in results],
           "tpot_p50_s": statistics.median(r.tpot_s for r in reqs
                                           if r.tpot_s is not None),
           "ttft_p50_s": statistics.median(r.ttft_s for r in reqs),
           "debug_kv": {k: debug_kv.get(k) for k in (
               "layout", "page_size", "pages_total", "pages_free",
               "pool_bytes", "preemptions", "rejected_too_large")},
           "too_large": [status, status_stream],
           "too_large_detail": err.get("error", {}).get("detail")}
    if (len(results) != MAX_SLOTS or res["streams_done"] != MAX_SLOTS // 2
            or any(f not in ("stop", "length") for f in res["finish"])
            or debug_kv.get("layout") != "paged"
            or debug_kv.get("pages_free") != debug_kv.get("pages_total")
            or [status, status_stream] != [422, 422]
            or {err["error"].get("code"), err_stream["error"].get("code")}
            != {"prompt_too_large"}):
        raise SystemExit(f"serve_paged: the HTTP checks failed: {res}")
    res["engine"] = engine
    return res


def paged_profile(engine, contiguous, tok, card: str) -> dict:
    """The paged engine beside a contiguous one on the same 8 chats (decode
    steps of 1, as the CLI's default): TPOT p50, a decode profile of
    each (:func:`profile_decode`), the paged step's gather and scatter,
    and the graphs the paged engine captured."""
    prompts = [prompt_ids(tok, m) for m in ckpt_chats()]
    tpot = {"paged": paged_tpot(engine, prompts),
            "contiguous": paged_tpot(contiguous, prompts)}
    prof = {"paged": profile_decode(engine, prompts, "nf4_matmul"),
            "contiguous": profile_decode(contiguous, prompts, "nf4_matmul")}
    # the view widths of the profiled steps, and the cache's full width
    width = engine._paged_width(int(max(len(p) for p in prompts)) + 33)
    g = engine.graphs
    return {
        "card": card, "tpot_p50_s": tpot,
        "tpot_ratio_paged_over_contiguous": tpot["paged"]
        / tpot["contiguous"],
        "profile": prof,
        "gather_scatter": [gather_scatter_ms(engine, w)
                           for w in (width, CACHE_LEN)],
        "graphs": [{"kind": k, "n": n, "greedy": a, "width": w,
                    "capture_s": s}
                   for (k, n, a, w, _), s in sorted(
                       g.capture_s.items(), key=lambda kv: str(kv[0]))],
        "graph_pool_mib": g.pool_bytes / 2**20}


def paged_phase(model, tok, seed: int, card: str, nf4_cell: dict) -> dict:
    """serve_paged on the NF4 model (Qwen3-8B width, full depth): the
    shared-prefix traffic on five engines, the pool-pressure run, fp8 KV,
    a 2-layer int8 model, HTTP through the CLI's defaults and a decode
    profile beside the contiguous layout. Launch counters are zeroed at
    its start; every check below exits non-zero."""
    import gc

    import torch

    from llm_in_practise_tpu_torch.models.layers import to_kv_dtype
    from llm_in_practise_tpu_torch.serve.engine import SamplingParams

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    numerics = paged_numerics(seed)
    log("serve_paged numerics (readings):", json.dumps(numerics))
    system, turns = paged_traffic(tok)
    runs = {}
    keep = {}
    for name, kw in (("contiguous", {}),
                     ("paged", {"kv_layout": "paged"}),
                     ("contiguous_prefix", {"prefix_cache": True}),
                     ("paged_prefix", {"kv_layout": "paged",
                                       "prefix_cache": True}),
                     ("paged_prefix_fp8", {
                         "kv_layout": "paged", "prefix_cache": True,
                         "cache_dtype": torch.float8_e4m3fn})):
        t0 = time.monotonic()
        engine = paged_engine(model, tok, seed, **kw)
        runs[name] = paged_drive(engine, system, turns)
        runs[name]["wall_s"] = time.monotonic() - t0
        if name.startswith("paged_prefix"):
            keep[name] = {"pages": system_pages(engine, system),
                          "pool_bytes": engine.paged.pool_bytes,
                          "finite": all(bool(torch.isfinite(
                              layer[k].float()).all())
                              for layer in engine.paged.kv
                              for k in ("k", "v"))}
            engine.prefix_cache.clear()
            engine.paged.pool.check_leaks(0)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    bf, f8 = keep["paged_prefix"], keep["paged_prefix_fp8"]
    f8_layers = [all(torch.equal(
        to_kv_dtype(b[k], torch.float8_e4m3fn).view(torch.uint8),
        f[k].view(torch.uint8)) for k in ("k", "v"))
        for b, f in zip(bf["pages"], f8["pages"])]
    shared = {
        "prefix_tokens": len(system), "turn_tokens": list(PAGED_TURNS),
        "paged_equals_contiguous":
            runs["paged"]["tokens"] == runs["contiguous"]["tokens"]
            and runs["paged"]["system"] == runs["contiguous"]["system"],
        "paged_prefix_equals_contiguous_prefix":
            runs["paged_prefix"]["tokens"]
            == runs["contiguous_prefix"]["tokens"],
        "tokens_saved": runs["paged_prefix"]["tokens_saved"],
        "tokens_saved_contiguous": runs["contiguous_prefix"]["tokens_saved"],
        "shared_pages_peak": runs["paged_prefix"]["shared_pages_peak"],
        # readings: a prefix hit computes the suffix with other shapes
        # than a cold prefill (cuBLAS and the kernels round by shape)
        "prefix_hit_vs_cold_first_divergence": first_divergence(
            runs["paged_prefix"]["tokens"], runs["contiguous"]["tokens"]),
        "tpot_p50_s": {k: r["tpot_p50_s"] for k, r in runs.items()},
        "wall_s": {k: r["wall_s"] for k, r in runs.items()},
        "graphs": {k: r["graphs"] for k, r in runs.items()},
        "graph_pool_mib": {k: r["graph_pool_mib"] for k, r in runs.items()},
        "finish": runs["paged"]["finish"]}
    fp8 = {"layer0_pages_equal_saturating_cast": f8_layers[0],
           "layers_equal": sum(f8_layers),
           "pool_bytes": [f8["pool_bytes"], bf["pool_bytes"]],
           "pool_finite": f8["finite"],
           "stream_departs_from_bf16_at": first_divergence(
               runs["paged_prefix_fp8"]["tokens"],
               runs["paged_prefix"]["tokens"])}
    del keep, bf, f8
    log("serve_paged shared prefix:", json.dumps(shared))
    log("serve_paged fp8:", json.dumps(fp8))
    if not (shared["paged_equals_contiguous"]
            and shared["paged_prefix_equals_contiguous_prefix"]
            and shared["tokens_saved"] >= (MAX_SLOTS - 1) * PAGED_PREFIX
            and shared["shared_pages_peak"] >= PAGED_PREFIX // 16):
        raise SystemExit(f"serve_paged: the shared-prefix checks failed: "
                         f"{shared}")
    if not (fp8["layer0_pages_equal_saturating_cast"] and fp8["pool_finite"]
            and 2 * fp8["pool_bytes"][0] == fp8["pool_bytes"][1]):
        raise SystemExit(f"serve_paged: the fp8 checks failed: {fp8}")

    # pool pressure: 8 x (300 + 256) tokens of demand on a 2048-token pool
    t0 = time.monotonic()
    docs = [prompt_ids(tok, long_messages(tok, PAGED_PRESSURE_PROMPT, 311 * i))
            for i in range(MAX_SLOTS)]
    sp = SamplingParams(greedy=True, max_tokens=PAGED_PRESSURE_TOKENS)
    out = {}
    for name, kw in (("contiguous", {}),
                     ("paged", {"kv_layout": "paged", "prefix_cache": True,
                                "kv_pool_tokens": PAGED_POOL})):
        engine = paged_engine(model, tok, seed, **kw)
        reqs = [engine.submit(d, sp) for d in docs]
        while engine.step():
            pass
        if engine.error is not None:
            raise SystemExit(f"serve_paged: engine failed: {engine.error!r}")
        out[name] = {"tokens": [list(r.output_ids) for r in reqs],
                     "finish": [r.finish_reason for r in reqs]}
        if engine.paged is not None:
            out[name]["preemptions"] = engine.preemptions
            out[name]["pool_mib"] = engine.paged.pool_bytes / 2**20
            engine.prefix_cache.clear()
            engine.paged.pool.check_leaks(0)
            out[name]["leaks"] = 0
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    streams = out["paged"]["tokens"]
    agree = teacher_forced(model, docs, streams)
    pressure = {
        "prompt_tokens": [len(d) for d in docs],
        "pool_tokens": PAGED_POOL, "pool_mib": out["paged"]["pool_mib"],
        "preemptions": out["paged"]["preemptions"],
        "finish": out["paged"]["finish"],
        "tokens": [len(t) for t in streams],
        f"top{PAGED_TOP_K}_agreeing": agree,
        "identical_to_contiguous": sum(
            a == b for a, b in zip(streams, out["contiguous"]["tokens"])),
        "first_divergence_from_contiguous": first_divergence(
            streams, out["contiguous"]["tokens"]),
        "wall_s": time.monotonic() - t0}
    log("serve_paged pool pressure:", json.dumps(pressure))
    if (pressure["preemptions"] < 1 or agree != pressure["tokens"]
            or any(f not in ("stop", "length") for f in pressure["finish"])
            or any(n != PAGED_PRESSURE_TOKENS
                   for n, f in zip(pressure["tokens"], pressure["finish"])
                   if f == "length")):
        raise SystemExit(f"serve_paged: the pool-pressure checks failed: "
                         f"{pressure}")

    http = paged_http(model, tok, seed, card)
    engine = http.pop("engine")
    log("serve_paged http:", json.dumps(http))
    contiguous = paged_engine(model, tok, seed, decode_steps=1)
    profile = paged_profile(engine, contiguous, tok, card)
    del engine, contiguous
    gc.collect()
    torch.cuda.empty_cache()
    log("serve_paged profile:", json.dumps(profile))
    counts, routes = read_counters(), read_routes()

    # a 2-layer int8 model: the shared-prefix traffic paged and contiguous
    cfg, int8_model = build_model("int8", PAGED_INT8_LAYERS, seed)
    int8 = {}
    for name, kw in (("contiguous", {}), ("paged", {"kv_layout": "paged"})):
        engine = paged_engine(int8_model, tok, seed, **kw)
        before = read_counters()["int8_matmul"]
        int8[name] = paged_drive(engine, system, turns)
        int8[name]["int8_launches"] = read_counters()["int8_matmul"] - before
        del engine
    del int8_model
    gc.collect()
    torch.cuda.empty_cache()
    int8_res = {"layers": PAGED_INT8_LAYERS,
                "paged_equals_contiguous":
                    int8["paged"]["tokens"] == int8["contiguous"]["tokens"],
                "int8_launches_paged": int8["paged"]["int8_launches"]}
    log("serve_paged int8:", json.dumps(int8_res))
    if not (int8_res["paged_equals_contiguous"]
            and int8_res["int8_launches_paged"] > 0):
        raise SystemExit(f"serve_paged: the int8 checks failed: {int8_res}")
    counts_all = read_counters()
    nf4_routes = routes["nf4_matmul"]
    if not (nf4_routes["thin"] and nf4_routes["wgmma"]):
        raise SystemExit(f"serve_paged: B1 did not launch on both routes: "
                         f"{nf4_routes}")
    res = {"card": card, "layers": N_LAYER, "max_slots": MAX_SLOTS,
           "cache_len": CACHE_LEN, **PAGED, "shared_prefix": shared,
           "fp8": fp8, "pool_pressure": pressure, "http": http,
           "profile": profile, "int8": int8_res, "numerics": numerics,
           "nf4_cell_tpot_p50_s": nf4_cell["tpot_p50_s"],
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2**30,
           "phase_wall_s": time.monotonic() - t_phase}
    log("serve_paged:", json.dumps({k: v for k, v in res.items()
                                    if k in ("phase_wall_s",
                                             "max_memory_allocated_gib",
                                             "nf4_cell_tpot_p50_s")}))
    return {"paged": res, "launches": counts["nf4_matmul"],
            "routes": nf4_routes,
            "int8_launches": counts_all["int8_matmul"]
            - counts["int8_matmul"]}


# serve_spec: speculative decoding (the JAX CLI's --speculative and
# --draft-model-path, vLLM's ngram and draft-model speculators) on the NF4
# model, k = SPEC_K, decode blocks of 8
SPEC = dict(decode_steps=8, kv_layout="paged")
SPEC_TOKENS = 128            # new tokens of each chat
SPEC_PASSAGE = 40            # tokens of the passage half the turns repeat
SPEC_LONG = 700              # leg 6's prompt, chunk-prefilling by 256
SPEC_CHUNK = 256
SPEC_PROFILE_STEPS = 3       # engine steps on the host clock; one more
#                              under torch.profiler
SPEC_DS1_TOKENS = 32         # new tokens of leg 6's chats
SPEC_MIN_ACCEPTANCE = 0.5    # the target as its own draft
# the draft: Qwen/Qwen3-0.6B's published config.json (hidden 1024, inter
# 3072, 28 layers, 16/8 heads, head_dim 128, tied embeddings), seeded
QWEN3_0_6B = dict(vocab_size=151936, hidden_size=1024,
                  intermediate_size=3072, n_layer=28, n_head=16,
                  n_kv_head=8, head_dim=128, rope_theta=1e6,
                  max_seq_len=40960, tie_word_embeddings=True,
                  compute_dtype="bfloat16")
SPEC_COUNTERS = ("decode_steps_run", "prefill_batches_run",
                 "chunk_batches_run", "chunk_slots_run", "spec_verifies_run",
                 "draft_chunks_run", "draft_rolls_run", "dispatches_total",
                 "spec_rounds", "spec_proposed", "spec_accepted",
                 "spec_round_tokens")


def teacher_ranks(model, prompts, streams) -> list[tuple[list, list]]:
    """Per stream, each emitted token's rank among the logits of a
    teacher-forced forward of the target over the prompt and the stream
    before it (0 = the argmax), and how far its logit lies below the
    largest. One cached forward per stream (dense attention); its kernel
    launches are not counted."""
    import torch

    from llm_in_practise_tpu_torch.ops import launch_count

    before = launch_count.snapshot()
    out = []
    try:
        with torch.inference_mode():
            for prompt, toks in zip(prompts, streams):
                if not toks:
                    out.append(([], []))
                    continue
                ids = torch.tensor([prompt + toks[:-1]],
                                   device=model.device)
                cache = model.init_cache(1, ids.shape[1],
                                         dtype=torch.bfloat16)
                logits, _ = model(ids, cache=cache)
                lg = logits[0, len(prompt) - 1:].float()
                want = torch.tensor(toks, device=model.device)[:, None]
                mine = lg.gather(1, want)
                out.append(((lg > mine).sum(1).tolist(),
                            (lg.max(1).values - mine[:, 0]).tolist()))
    finally:
        launch_count.restore(before)
    return out


def spec_traffic(tok) -> list[list[dict]]:
    """The 8 chats of serve_spec: every even turn repeats a passage of
    ``SPEC_PASSAGE`` tokens from SURVEY.md, so the prompt lookup has
    something to match."""
    survey = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "SURVEY.md")
    with open(survey, encoding="utf-8") as f:
        words = f.read().split()
    out = []
    for i in range(MAX_SLOTS):
        content = f"Explain {TOPICS[i]} in a few sentences."
        if i % 2 == 0:
            passage = tok.decode(tok.encode(
                " ".join(words[3000 + 61 * i:][:60]))[:SPEC_PASSAGE])
            content += f" Quote this twice: {passage} {passage}"
        out.append(chat(content))
    return out


def write_draft(path: str, seed: int) -> str:
    """The Qwen3-0.6B-shaped draft, bf16 weights drawn on the card from a
    seed, written as ``model.msgpack`` (with its config) by the port's
    checkpoint writer. Returns the file's path."""
    import torch

    from llm_in_practise_tpu_torch.ckpt.checkpoint import save_named
    from llm_in_practise_tpu_torch.models.convert import params_to_jax
    from llm_in_practise_tpu_torch.models.qwen3 import Qwen3Config, init_params

    cfg = Qwen3Config(**QWEN3_0_6B)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 13)
    state = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    out = save_named(path, params_to_jax(state, cfg), "model",
                     metadata={"config": cfg.to_dict()})
    del state
    return out


class SpecRecorder:
    """Hooks on one engine for a counted run, undone by :meth:`undo`: each
    spec round's dispatches, graph replays, new captures and draft
    catch-up chunks; each round's ``n_acc`` against the longest matching
    prefix recomputed on the host from ``out`` and the proposed tokens;
    the rows of every one-shot prefill and single-slot chunk (for the
    expected B1 launches)."""

    def __init__(self, engine):
        import numpy as np

        self.engine = engine
        g = engine.graphs
        self.rounds, self.acc_checked, self.acc_wrong = [], 0, []
        self.prefill_rows, self.chunk_rows = [], []
        self._saved = (g.run, engine._try_speculative, engine._prefill_batch,
                       engine._chunk_slot_impl)
        run, try_spec, prefill, chunk = self._saved

        def rec_run(kind, n, **kw):
            out = run(kind, n, **kw)
            if kind in ("spec", "pspec"):
                k = engine.speculative_k
                spec = out["spec"].cpu().numpy()
                toks = kw["spec_tokens"]
                match = spec[:, :k] == toks[:, 1:]
                host = np.cumprod(match, axis=1).sum(axis=1)
                self.acc_checked += 1
                if not np.array_equal(host, spec[:, k + 1]):
                    self.acc_wrong.append([host.tolist(),
                                           spec[:, k + 1].tolist()])
            return out

        def rec_try(active):
            e = engine
            before = (e.dispatches_total, g.replays, len(g.graphs),
                      e.draft_chunks_run, e.spec_rounds)
            ok = try_spec(active)
            if e.spec_rounds > before[4]:
                self.rounds.append({
                    "dispatches": e.dispatches_total - before[0],
                    "replays": g.replays - before[1],
                    "captures": len(g.graphs) - before[2],
                    "chunks": e.draft_chunks_run - before[3]})
            return ok

        def rec_prefill(batch):
            self.prefill_rows.append(
                len(batch) * max(len(r.prompt_ids) for _, r, _ in batch))
            return prefill(batch)

        def rec_chunk(model, cache, slot, ids, done, width):
            self.chunk_rows.append((model is engine.model, width))
            return chunk(model, cache, slot, ids, done, width)

        g.run = rec_run
        engine._try_speculative = rec_try
        engine._prefill_batch = rec_prefill
        engine._chunk_slot_impl = rec_chunk

    def undo(self):
        for name in ("_try_speculative", "_prefill_batch",
                     "_chunk_slot_impl"):
            del self.engine.__dict__[name]
        del self.engine.graphs.__dict__["run"]

    def round_checks(self) -> dict:
        """(d): an ngram round is one dispatch and one graph run (a replay,
        or the capture of a new variant), a draft round two (the roll and
        the verify), and only a catch-up chunk adds a dispatch, never a
        graph run."""
        e = self.engine
        runs = 2 if e.draft_model is not None else 1
        bad = [r for r in self.rounds
               if r["replays"] + r["captures"] != runs
               or r["dispatches"] != runs + r["chunks"]]
        return {"rounds": len(self.rounds), "graph_runs_per_round": runs,
                "replayed_rounds": sum(r["replays"] == runs
                                       for r in self.rounds),
                "rounds_with_chunks": sum(r["chunks"] > 0
                                          for r in self.rounds),
                "bad_rounds": bad[:4], "n_acc_checked": self.acc_checked,
                "n_acc_wrong": self.acc_wrong[:4]}


def spec_rows(engine, delta: dict, rec: SpecRecorder) -> list[int]:
    """The rows of every target forward the run made, from the engine's
    counters: one-shot prefills and single-slot chunks as recorded, decode
    steps (a round's extension included) over every slot, batched chunks,
    verifies of k + 1 rows per slot, and, where the target drafts itself,
    each roll's W-row catch-up and k - 1 decode steps."""
    k, c = engine.speculative_k, engine.chunked_prefill
    rows = list(rec.prefill_rows)
    rows += [w for is_target, w in rec.chunk_rows if is_target]
    rows += [MAX_SLOTS] * delta["decode_steps_run"]
    rows += [MAX_SLOTS * (c or 0)] * delta["chunk_batches_run"]
    if k is not None:
        rows += [MAX_SLOTS * (k + 1)] * delta["spec_verifies_run"]
    if engine.draft_model is engine.model:
        rows += ([MAX_SLOTS * engine._draft_window]
                 + [MAX_SLOTS] * (k - 1)) * delta["draft_rolls_run"]
    return rows


def spec_engine(model, tok, seed: int, **kw):
    import torch

    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.serve.engine import InferenceEngine

    return InferenceEngine(model, max_slots=MAX_SLOTS, cache_len=CACHE_LEN,
                           eos_id=tok.token_to_id(IM_END),
                           cache_dtype=torch.bfloat16, seed=seed,
                           **{**SPEC, **kw})


def spec_submit_all(engine, prompts, long_prompt=None,
                    max_tokens: int = SPEC_TOKENS) -> tuple:
    """The chats through ``engine`` step by step (with ``long_prompt``:
    the first 7, then the long prompt after one step), ``max_tokens``
    new tokens each. Returns the requests and the spec rounds run while a
    prompt was mid-prefill."""
    from llm_in_practise_tpu_torch.serve.engine import SamplingParams

    sp = SamplingParams(greedy=True, max_tokens=max_tokens)
    if long_prompt is None:
        reqs = [engine.submit(p, sp) for p in prompts]
    else:
        reqs = [engine.submit(p, sp) for p in prompts[:MAX_SLOTS - 1]]
        engine.step()
        reqs.append(engine.submit(long_prompt, sp))
    mid = 0
    while True:
        pre, rounds = bool(engine.slot_prefill), engine.spec_rounds
        busy = engine.step()
        mid += pre and engine.spec_rounds > rounds
        if not busy:
            break
    if engine.error is not None:
        raise SystemExit(f"serve_spec: engine failed: {engine.error!r}")
    return reqs, mid


def spec_profile(engine, prompts) -> dict:
    """Host wall per engine step (and per spec round) over
    ``SPEC_PROFILE_STEPS`` steady steps of the 8 chats, after their
    admission and first round, then the device time of one more step
    under torch.profiler (device activity only; a step of a 36-layer spec
    round is about 30000 kernels). The chats are left in flight; the
    engine does no counted work after this."""
    import torch
    from torch.profiler import ProfilerActivity

    from llm_in_practise_tpu_torch.obs.meter import (
        exclusive_profile as profile,
    )

    from llm_in_practise_tpu_torch.serve.engine import SamplingParams

    sp = SamplingParams(greedy=True, max_tokens=SPEC_TOKENS)
    for p in prompts:
        engine.submit(p, sp)
    engine.step()
    engine.step()
    torch.cuda.synchronize()
    n = SPEC_PROFILE_STEPS
    r0, t0_tok = engine.spec_rounds, engine.spec_round_tokens
    t0 = time.monotonic()
    for _ in range(n):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3 / n
    rounds_wall = engine.spec_rounds - r0
    r1 = engine.spec_rounds
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.step()
        torch.cuda.synchronize()
    rounds_prof = engine.spec_rounds - r1
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    out = {"steps": n, "step_wall_ms": wall_ms,
           "rounds_per_step": rounds_wall / n,
           "round_tokens_in_window": engine.spec_round_tokens - t0_tok}
    if rounds_wall:
        out["round_wall_ms"] = wall_ms * n / rounds_wall
    if not device_us:
        out["step_device_ms"] = "not measured"
        return out
    out["step_device_ms"] = device_us / 1e3
    out["device_busy_share"] = out["step_device_ms"] / wall_ms
    if rounds_prof:
        out["round_device_ms"] = device_us / 1e3 / rounds_prof
    return out


def spec_replay_check(engine, seed: int) -> dict:
    """(c): every captured ``spec``, ``pspec`` and ``droll`` graph,
    replayed once, against its eager body on copies of the same state
    (the KV cache or page pool, and the draft's cache) and inputs: the
    outputs and every state byte identical."""
    import numpy as np
    import torch

    from llm_in_practise_tpu_torch.ops import launch_count
    from llm_in_practise_tpu_torch.serve.paged_kv import window_idx

    g, b = engine.graphs, engine.max_slots
    dev = engine.device
    k = engine.speculative_k
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    vocab = engine.model.config.vocab_size
    state = []
    if engine.cache is not None:
        state += [layer[key] for layer in engine.cache for key in ("k", "v")]
    if engine.paged is not None:
        state.append(engine.paged.store)
    if engine.draft_cache is not None:
        state += [layer[key] for layer in engine.draft_cache
                  for key in ("k", "v")]
    saved = [t.clone() for t in state]

    def restore():
        for t, c in zip(state, saved):
            t.copy_(c)

    def compared(t):
        # the pool past its trash page: the trash rows take every
        # discarded write, several to one row in one scatter, in no fixed
        # order, and no query attends them
        if engine.paged is not None and t is engine.paged.store:
            return t[:, engine.paged.page_size:]
        return t

    snap = launch_count.snapshot()
    out = {}
    x = g.inputs
    try:
        with torch.inference_mode():
            for key in sorted(g.graphs, key=str):
                kind, n, _, width, _ = key
                if kind not in ("spec", "pspec", "droll"):
                    continue
                if kind == "droll":
                    W = width
                    x["catchup"].copy_(torch.randint(
                        0, vocab, (b, W), device=dev, generator=gen))
                    x["roll_starts"].copy_(torch.clamp(
                        torch.arange(b, device=dev) * 97 + 40,
                        max=engine.cache_len - W))
                    x["roll_lens"].copy_(torch.tensor(
                        [W, W // 2, 1, 0, W, 3, 0, 7], device=dev)[:b])
                else:
                    wwin = k + 1 + n
                    span = engine.cache_len if kind == "spec" else width
                    base = np.minimum(np.arange(b) * 37 + 5, span - wwin)
                    mask = np.arange(b) % 2 == 0
                    x["spec_tokens"].copy_(torch.randint(
                        0, vocab, (b, k + 1), device=dev, generator=gen))
                    x["index"].copy_(torch.from_numpy(base))
                    x["spec_mask"].copy_(torch.from_numpy(mask.astype(
                        np.int64)))
                    if kind == "pspec":
                        pg = engine.paged
                        for name, a in (
                                ("gidx", pg.gather_idx(width)),
                                ("vidx", window_idx(base, width, wwin)),
                                ("sidx", pg.scatter_idx(
                                    base, mask * wwin, wwin))):
                            flat = torch.from_numpy(a.reshape(-1).astype(
                                np.int64))
                            g._index_buf(name, flat.numel()).copy_(flat)
                graph, static_out, _ = g.graphs[key]
                restore()
                graph.replay()
                torch.cuda.synchronize()
                got = {n_: v.clone() for n_, v in static_out.items()}
                got_state = [compared(t).clone() for t in state]
                restore()
                want = g._body(key)
                torch.cuda.synchronize()
                out[f"{kind} n={n} width={width}"] = {
                    "outputs_identical": all(torch.equal(got[n_], want[n_])
                                             for n_ in got),
                    "state_identical": all(
                        torch.equal(a, compared(t))
                        for a, t in zip(got_state, state))}
                del got, got_state
        restore()
    finally:
        launch_count.restore(snap)
        del saved
    if not all(all(r.values()) for r in out.values()):
        raise SystemExit(f"serve_spec: a replay differs from its eager "
                         f"body: {out}")
    return out


def spec_leg(name: str, engine, model, prompts, long_prompt=None,
             max_tokens: int = SPEC_TOKENS) -> dict:
    """One leg: a warm-up run of the traffic (it captures every variant
    the counted run reaches), then the counted run with the launch
    counters zeroed before and read after and the recorder's hooks on,
    then a profile window. Every check of the leg exits non-zero."""
    import torch

    t0 = time.monotonic()
    spec_submit_all(engine, prompts, long_prompt, max_tokens)
    warm_s = time.monotonic() - t0
    g = engine.graphs
    rec = SpecRecorder(engine)
    zero_counters()
    before = {k: getattr(engine, k) for k in SPEC_COUNTERS}
    t0 = time.monotonic()
    try:
        reqs, mid = spec_submit_all(engine, prompts, long_prompt,
                                    max_tokens)
        torch.cuda.synchronize()
    finally:
        rec.undo()
    wall = time.monotonic() - t0
    routes = read_routes()["nf4_matmul"]
    launches = read_counters()["nf4_matmul"]
    delta = {k: getattr(engine, k) - before[k] for k in SPEC_COUNTERS}
    want = route_launches("nf4", spec_rows(engine, delta, rec),
                          PROJ_SHAPES.values(), N_LAYER)
    rounds = rec.round_checks()
    streams = [list(r.output_ids) for r in reqs]
    res = {
        "leg": name, "requests": len(reqs), "wall_s": wall,
        "warmup_wall_s": warm_s,
        "tokens": [len(t) for t in streams],
        "finish": [r.finish_reason for r in reqs],
        "tpot_p50_s": statistics.median(r.tpot_s for r in reqs
                                        if r.tpot_s is not None),
        "spec": {k: delta[k] for k in ("spec_rounds", "spec_proposed",
                                       "spec_accepted", "spec_round_tokens")},
        "tokens_per_round": (delta["spec_round_tokens"]
                             / delta["spec_rounds"]
                             if delta["spec_rounds"] else None),
        "acceptance": (delta["spec_accepted"] / delta["spec_proposed"]
                       if delta["spec_proposed"] else None),
        "forwards": {k: delta[k] for k in SPEC_COUNTERS[:7]},
        "dispatches": delta["dispatches_total"],
        "rounds_mid_prefill": mid, "round_checks": rounds,
        "b1_routes": routes, "b1_expected": want,
        "captures": len(g.capture_s),
        "capture_s": sum(g.capture_s.values()),
        "graphs": sorted(f"{k} n={n} w={w}" for k, n, _, w, _ in g.graphs),
        "graph_pool_mib": g.pool_bytes / 2**20,
        # an engine that never sees a constraint captures no masked kind
        # and allocates no mask buffer
        "masked_graphs": [k for k in g.graphs if k[0] in MASKED_KINDS],
        "mask_buffers": sorted(g.masks)}
    log(f"serve_spec {name}:", json.dumps(res))
    if res["masked_graphs"] or res["mask_buffers"]:
        raise SystemExit(f"serve_spec {name}: an unconstrained engine "
                         f"captured a masked kind or made a mask buffer")
    if (routes != want or launches != sum(routes.values())
            or any(f not in ("stop", "length") for f in res["finish"])):
        raise SystemExit(f"serve_spec {name}: B1 launches {routes} differ "
                         f"from the engine's forwards ({want}), or a bad "
                         f"finish")
    # a draft model proposes every step; the prompt lookup only where a
    # stream repeats itself (rare on random weights)
    if engine.speculative_k is not None and (
            (engine.draft_model is not None and not rounds["rounds"])
            or rounds["bad_rounds"] or rounds["n_acc_wrong"]
            or rounds["n_acc_checked"] != rounds["rounds"]):
        raise SystemExit(f"serve_spec {name}: the round checks failed: "
                         f"{rounds}")
    t0 = time.monotonic()
    res["profile"] = spec_profile(engine, prompts)
    res["profile"]["wall_s"] = time.monotonic() - t0
    log(f"serve_spec {name} profile:", json.dumps(res["profile"]))
    res["streams"] = streams
    res["prompts"] = [list(r.prompt_ids) for r in reqs]
    res["launches"] = launches
    return res


def spec_http(model, tok, seed: int, draft_path: str, chats) -> tuple:
    """Leg 7 and check (h), through the CLI's parser and loader: args with
    ``--speculative 4 --draft-model-path`` are validated and the draft
    loaded by ``load_draft_model``; a server on the ngram engine those
    args give without the draft answers the 8 chats (4 streamed, each
    ending in ``data: [DONE]``) after a warm-up round of the same; a
    second server with the draft and an explicit pool reports the draft's
    pool tax on ``GET /debug/kv``. Returns the loaded draft too."""
    import torch

    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.serve.__main__ import (
        build_engine,
        build_parser,
        load_draft_model,
        validate_args,
    )
    from llm_in_practise_tpu_torch.serve.api import OpenAIServer
    from llm_in_practise_tpu_torch.serve.paged_kv import kv_row_bytes

    def error(msg):
        raise SystemExit(f"serve_spec: the CLI refused its args: {msg}")

    base_argv = ["--tokenizer_path", "-", "--max_slots", str(MAX_SLOTS),
                 "--cache_len", str(CACHE_LEN), "--kv-cache-dtype",
                 "bfloat16", "--decode-steps", str(SPEC["decode_steps"]),
                 "--speculative", str(SPEC_K)]
    parser = build_parser()
    args = parser.parse_args(base_argv + ["--draft-model-path", draft_path])
    validate_args(args, error)
    draft = load_draft_model(args.draft_model_path, model.device)
    ngram_args = parser.parse_args(base_argv)
    validate_args(ngram_args, error)
    eos = tok.token_to_id(IM_END)
    engine = build_engine(model, ngram_args, eos_id=eos)
    # the draft's cache in target tokens, and a pool that leaves half the
    # slots' worth after it
    drow = kv_row_bytes(draft, torch.bfloat16)
    trow = kv_row_bytes(model, torch.bfloat16)
    reserved = math.ceil(MAX_SLOTS * CACHE_LEN * drow / trow)
    pool = reserved + MAX_SLOTS * CACHE_LEN // 2
    taxed = build_engine(model, parser.parse_args(
        base_argv + ["--kv-pool-tokens", str(pool)]), eos_id=eos,
        draft_model=draft)
    seen = []
    submit = engine.submit

    def recording_submit(*a, **kw):
        seen.append(submit(*a, **kw))
        return seen[-1]

    engine.submit = recording_submit
    servers = [OpenAIServer(e, tok, model_name="qwen3-8b-nf4-spec")
               for e in (engine, taxed)]
    bases = [f"http://127.0.0.1:{s.serve(host='127.0.0.1', port=0, background=True)}"
             for s in servers]
    def body(i):
        return {"model": "qwen3-8b-nf4-spec", "temperature": 0.0,
                "max_tokens": SPEC_TOKENS, "stream": i % 2 == 1,
                "messages": chats[i]}

    def burst():
        with concurrent.futures.ThreadPoolExecutor(MAX_SLOTS) as pool_:
            futs = [pool_.submit(post_chat, bases[0], body(i))
                    for i in range(MAX_SLOTS)]
            return [f.result() for f in futs]

    try:
        burst()                          # warm-up: the captures
        seen.clear()
        rec = SpecRecorder(engine)
        zero_counters()
        before = {k: getattr(engine, k) for k in SPEC_COUNTERS}
        t0 = time.monotonic()
        try:
            results = burst()
        finally:
            rec.undo()
        wall = time.monotonic() - t0
        routes = read_routes()["nf4_matmul"]
        delta = {k: getattr(engine, k) - before[k] for k in SPEC_COUNTERS}
        with urllib.request.urlopen(bases[1] + "/debug/kv", timeout=60) as r:
            debug_kv = json.loads(r.read())
    finally:
        for s in servers:
            s.shutdown()
    if engine.error is not None:
        raise SystemExit(f"serve_spec http: engine failed: {engine.error!r}")
    want = route_launches("nf4", spec_rows(engine, delta, rec),
                          PROJ_SHAPES.values(), N_LAYER)
    rounds = rec.round_checks()
    reqs = list(seen)
    res = {"leg": "http_ngram_paged", "requests": len(results),
           "wall_s": wall,
           "streams_done": sum(r.get("done", False) for r in results),
           "finish": [r["finish_reason"] for r in results],
           "tpot_p50_s": statistics.median(r.tpot_s for r in reqs
                                           if r.tpot_s is not None),
           "spec": {k: delta[k] for k in ("spec_rounds", "spec_proposed",
                                          "spec_accepted",
                                          "spec_round_tokens")},
           "round_checks": rounds, "b1_routes": routes, "b1_expected": want,
           "pool_tax": {"pool_tokens": pool, "draft_row_bytes": drow,
                        "target_row_bytes": trow,
                        "expected_reserved_tokens": reserved,
                        "debug_kv": {k: debug_kv.get(k) for k in (
                            "pages_total", "page_size",
                            "draft_kv_reserved_tokens",
                            "draft_kv_account_bytes")}}}
    log("serve_spec http:", json.dumps(res))
    if (len(results) != MAX_SLOTS or res["streams_done"] != MAX_SLOTS // 2
            or any(f not in ("stop", "length") for f in res["finish"])
            or routes != want or rounds["bad_rounds"]
            or rounds["n_acc_wrong"]):
        raise SystemExit(f"serve_spec http: the checks failed: {res}")
    if (debug_kv.get("draft_kv_reserved_tokens") != reserved
            or taxed.draft_kv_reserved_tokens != reserved
            or debug_kv.get("pages_total")
            != -(-(pool - reserved) // debug_kv.get("page_size"))
            or debug_kv.get("draft_kv_account_bytes")
            != MAX_SLOTS * CACHE_LEN * drow):
        raise SystemExit(f"serve_spec: the draft's pool tax is wrong: "
                         f"{res['pool_tax']}")
    res["streams"] = [list(r.output_ids) for r in reqs]
    res["prompts"] = [list(r.prompt_ids) for r in reqs]
    res["launches"] = sum(routes.values())
    del engine, taxed, servers
    return res, draft


def verify_vs_decode(model) -> dict:
    """The spec bet: device time (torch.profiler, every kernel's self
    time) of one cached forward over 8 x 5 = 40 rows, a verify, beside an
    8-row decode step, both at depth 128 of a contiguous cache. Launches
    are not counted."""
    import torch

    from llm_in_practise_tpu_torch.ops import launch_count
    from llm_in_practise_tpu_torch.serve.mixed_step import pin_index

    dev = model.device
    cache = model.init_cache(MAX_SLOTS, CACHE_LEN, dtype=torch.bfloat16)
    idx = torch.full((MAX_SLOTS,), 128, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    vocab = model.config.vocab_size
    toks = {w: torch.randint(0, vocab, (MAX_SLOTS, w), device=dev,
                             generator=gen) for w in (1, SPEC_K + 1)}
    snap = launch_count.snapshot()
    try:
        with torch.inference_mode():
            ms = {w: device_ms([lambda t=t: model(
                t, cache=pin_index(cache, idx))], rounds=3)
                for w, t in toks.items()}
    finally:
        launch_count.restore(snap)
    del cache
    out = {"decode_8_rows_device_ms": ms[1],
           "verify_40_rows_device_ms": ms[SPEC_K + 1]}
    if ms[1] and ms[SPEC_K + 1]:
        out["verify_over_decode"] = ms[SPEC_K + 1] / ms[1]
    return out


def spec_phase(model, tok, seed: int, card: str, nf4_cell: dict) -> dict:
    """serve_spec on the NF4 model (Qwen3-8B width, full depth): the 8
    chats over HTTP on an ngram engine built by the CLI's code (whose
    parser and draft loader also take ``--speculative 4
    --draft-model-path``), then through seven engines: paged plain,
    ngram, the 0.6B draft and the target as its own draft; contiguous
    ngram and the target as its own draft; and the 0.6B draft at
    ``decode_steps`` 1 while a 700-token prompt chunk-prefills (the
    prompt lookup finds no repeated token in a random-weight target's
    streams, so the composition path takes a proposer that always
    proposes). Checks, each exiting non-zero: (a) every emitted token in
    the teacher-forced top 5, or no further below the top logit than the
    plain leg's own tokens lie; (b) each round's ``n_acc`` equal to the host's longest matching
    prefix; (c) every captured spec, pspec and droll graph replays its
    eager body byte for byte; (d) a round is one graph run (ngram) or
    two (a draft), plus one eager dispatch per catch-up chunk; (e) the
    target as its own draft accepts at least ``SPEC_MIN_ACCEPTANCE``;
    (f) B1's launches per route follow from the engine's forwards; (g) a
    sampled request does not speculate; (h) an explicit pool gives up the
    draft cache's rows, on ``/debug/kv`` too; (i) streams end in
    ``data: [DONE]``."""
    import gc
    import shutil

    import torch

    from llm_in_practise_tpu_torch.serve.engine import SamplingParams

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    chats = spec_traffic(tok)
    prompts = [prompt_ids(tok, m) for m in chats]
    long_prompt = prompt_ids(tok, long_messages(tok, SPEC_LONG, 0))
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "spec_phase")
    t0 = time.monotonic()
    draft_path = write_draft(root, seed)
    write_s = time.monotonic() - t0
    draft_bytes = path_bytes(root)
    legs, launches, routes = {}, 0, {}

    def done(res):
        nonlocal launches
        launches += res.pop("launches")
        for r, c in res["b1_routes"].items():
            routes[r] = routes.get(r, 0) + c
        legs[res["leg"]] = res

    try:
        t0 = time.monotonic()
        http, draft = spec_http(model, tok, seed, draft_path, chats)
        http["leg_wall_s"] = time.monotonic() - t0
        done(http)
        gc.collect()
        torch.cuda.empty_cache()
        extra = {}
        for name, kw in (("paged_plain", {}),
                         ("paged_ngram", {"speculative_k": SPEC_K}),
                         ("paged_draft_0.6b", {"speculative_k": SPEC_K,
                                               "draft_model": draft}),
                         ("paged_target_draft", {"speculative_k": SPEC_K,
                                                 "draft_model": model}),
                         ("contiguous_ngram", {"speculative_k": SPEC_K,
                                               "kv_layout": "contiguous"}),
                         ("contiguous_target_draft", {
                             "speculative_k": SPEC_K, "draft_model": model,
                             "kv_layout": "contiguous"}),
                         ("paged_draft_ds1_chunked", {
                             "speculative_k": SPEC_K, "draft_model": draft,
                             "decode_steps": 1,
                             "chunked_prefill": SPEC_CHUNK})):
            t_leg = time.monotonic()
            engine = spec_engine(model, tok, seed, **kw)
            chunked = "chunked" in name
            res = spec_leg(name, engine, model, prompts,
                           long_prompt if chunked else None,
                           SPEC_DS1_TOKENS if chunked else SPEC_TOKENS)
            rolls = [v[0] for k, v in engine.graphs.graphs.items()
                     if k[0] == "droll"]
            if kw.get("draft_model") is not None:
                # one replay of the roll's graph: W-row catch-up + k - 1
                # decode steps of the draft
                res["draft_roll_device_ms"] = (
                    device_ms([rolls[0].replay], rounds=3) if rolls
                    else "not measured")
            if kw.get("speculative_k"):
                t0 = time.monotonic()
                res["replay_check"] = spec_replay_check(engine, seed)
                res["replay_check_wall_s"] = time.monotonic() - t0
            if name == "paged_target_draft":
                # (g): a sampled request takes the plain path, on an
                # engine whose greedy slots speculate every step
                while engine.step():
                    pass
                rounds0 = engine.spec_rounds
                h = engine.submit(prompts[0], SamplingParams(
                    temperature=0.8, top_k=50, top_p=0.9, max_tokens=16))
                while engine.step():
                    pass
                extra["sampled"] = {"tokens": len(h.output_ids),
                                    "spec_rounds_added":
                                        engine.spec_rounds - rounds0}
                if extra["sampled"]["spec_rounds_added"] or not h.output_ids:
                    raise SystemExit(f"serve_spec: a sampled request "
                                     f"speculated: {extra['sampled']}")
            res["leg_wall_s"] = time.monotonic() - t_leg
            done(res)
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        del draft
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t0 = time.monotonic()
    extra["verify_vs_decode"] = verify_vs_decode(model)
    extra["verify_vs_decode"]["wall_s"] = time.monotonic() - t0
    # (a): every emitted token among the target's top 5 of a teacher-forced
    # forward, or no further below its largest logit than the plain leg's
    # own tokens lie (the card's rounding by shape: random weights' logits
    # are near-flat, and a plain decode's token sits up to 0.2 below the
    # teacher-forced argmax; a token from corrupted KV lies logits away);
    # where each stream departs from the plain one, a reading
    t_teacher = time.monotonic()
    plain = legs["paged_plain"]["streams"]
    noise = None
    for name, res in legs.items():
        streams, prompts_ = res.pop("streams"), res.pop("prompts")
        ranks = teacher_ranks(model, prompts_, streams)
        if name == "paged_plain":
            noise = max(g for _, gs in ranks for g in gs)
        agree = [sum(r < PAGED_TOP_K for r in rs) for rs, _ in ranks]
        res[f"top{PAGED_TOP_K}_agreeing"] = agree
        res["teacher_forced_worst"] = [
            {"rank": max(rs, default=0), "logit_gap": max(gs, default=0.0)}
            for rs, gs in ranks]
        res["outside_top5_within_plain_gap"] = sum(
            r >= PAGED_TOP_K for rs, _ in ranks for r in rs)
        if name not in ("paged_plain", "paged_draft_ds1_chunked",
                        "http_ngram_paged"):
            res["first_divergence_from_plain"] = first_divergence(
                streams, plain)
        bad = [(r, g) for rs, gs in ranks for r, g in zip(rs, gs)
               if r >= PAGED_TOP_K and g > noise]
        if bad:
            raise SystemExit(
                f"serve_spec {name}: tokens outside the teacher-forced "
                f"top {PAGED_TOP_K} and further below its largest logit "
                f"than the plain leg's {noise}: {bad[:8]}")
    extra["teacher_forced_wall_s"] = time.monotonic() - t_teacher
    # (c) covered every spec graph kind
    checked = {key.split()[0] for leg in legs.values()
               for key in leg.get("replay_check", {})}
    if checked != {"spec", "pspec", "droll"}:
        raise SystemExit(f"serve_spec: replay-checked graph kinds "
                         f"{sorted(checked)}, not spec, pspec and droll")
    # (e): the target as its own draft accepts most of what it proposes
    for name in ("paged_target_draft", "contiguous_target_draft"):
        acc = legs[name]["acceptance"]
        if acc is None or acc < SPEC_MIN_ACCEPTANCE:
            raise SystemExit(f"serve_spec {name}: the target as its own "
                             f"draft accepted {acc} of its drafts, under "
                             f"{SPEC_MIN_ACCEPTANCE}")
    if not legs["paged_draft_ds1_chunked"]["rounds_mid_prefill"]:
        raise SystemExit("serve_spec: no round composed with the chunked "
                         "prefill at decode_steps 1")
    for name, leg in legs.items():
        log(f"serve_spec {name} checks:", json.dumps(
            {k: v for k, v in leg.items()
             if k in ("replay_check", "draft_roll_device_ms",
                      f"top{PAGED_TOP_K}_agreeing", "teacher_forced_worst",
                      "outside_top5_within_plain_gap", "leg_wall_s",
                      "replay_check_wall_s",
                      "first_divergence_from_plain")}))
    res = {"card": card, "layers": N_LAYER, "max_slots": MAX_SLOTS,
           "cache_len": CACHE_LEN, "k": SPEC_K, **SPEC,
           "draft": {"config": "Qwen/Qwen3-0.6B", "msgpack_bytes":
                     draft_bytes, "write_s": write_s},
           "legs": legs, **extra, "plain_logit_gap_max": noise,
           "nf4_cell_tpot_p50_s": nf4_cell["tpot_p50_s"],
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2**30,
           "phase_wall_s": time.monotonic() - t_phase}
    log("serve_spec:", json.dumps({k: v for k, v in res.items()
                                   if k != "legs"}))
    return {"spec": res, "launches": launches, "routes": routes}


# ---------------------------------------------------------------------------
# serve_struct: structured output (the OpenAI API's response_format and
# tools / tool_choice, grammar-masked in every decode path) and
# /v1/embeddings, on the traffic of the JAX structured bench
# (tools/structured_bench.py:50-60, 233-235)

STRUCT = dict(decode_steps=8, chunked_prefill=256, mixed_step=True)
STRUCT_ARRIVALS = dict(seed=42, n_requests=16, mean_iat_s=0.02, cv=2.0,
                       prompt_tokens=(8, 48), max_tokens=(72, 128))
STRUCT_LONG = 700            # a plain document after the schedule: the
#                              fused mixed step runs its masked twin
STRUCT_LONG_TOKENS = 16
# tools/structured_bench.py's SCHEMA
STRUCT_SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string", "minLength": 1, "maxLength": 10},
        "age": {"type": "integer"},
        "tags": {"type": "array", "items": {"enum": ["a", "b", "c"]},
                 "minItems": 1, "maxItems": 3},
    },
    "required": ["name", "age", "tags"],
}
STRUCT_TOOL = {"type": "function", "function": {
    "name": "lookup", "description": "search the notes",
    "parameters": {"type": "object",
                   "properties": {"q": {"type": "string", "maxLength": 6}},
                   "required": ["q"]}}}
STRUCT_HTTP_TOKENS = 128
MASKED_KINDS = ("mdecode", "pmdecode", "mmixed", "pmmixed", "mspec",
                "pmspec")
# /v1/embeddings, kernels vs plain versions on the unit vectors:
# max|kernel - plain| <= MODEL_TOL * max|plain| (36 bf16 layers, as the
# whole-model logits check)
EMBED_INPUTS = ("Structured output masks the logits on the host.",
                "The port serves Qwen3 on Hopper.")


def struct_rf() -> dict:
    return {"type": "json_schema",
            "json_schema": {"name": "person", "schema": STRUCT_SCHEMA}}


def struct_prompts(tok, schedule) -> tuple[list, list]:
    """Each arrival's prompt: ``prompt_tokens`` ids of SURVEY.md from its
    own offset; and the long document after the schedule."""
    survey = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "SURVEY.md")
    with open(survey, encoding="utf-8") as f:
        ids = tok.encode(f.read())
    prompts = [ids[97 * i: 97 * i + a.prompt_tokens]
               for i, a in enumerate(schedule)]
    return prompts, ids[-STRUCT_LONG:]


def struct_engine(model, tok, seed: int, **kw):
    import torch

    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.serve.engine import InferenceEngine

    return InferenceEngine(model, max_slots=MAX_SLOTS, cache_len=CACHE_LEN,
                           eos_id=tok.token_to_id(IM_END),
                           cache_dtype=torch.bfloat16, seed=seed,
                           **{"kv_layout": "paged", **STRUCT, **kw})


class StructRecorder(SpecRecorder):
    """:class:`SpecRecorder`'s hooks, and two more. On every graph run: its
    kind and ``n``, whether a ready slot was constrained, whether it
    replayed or captured; in a masked spec round, ``n_acc`` recounted on
    the host from the masked argmax, each constrained row's acceptance
    bounded by its first grammar-forbidden draft, and its bonus token
    allowed by the mask staged for it. On every mask copy to the card:
    its buffer, bytes and CUDA-event time."""

    def __init__(self, engine):
        import torch

        super().__init__(engine)
        g = engine.graphs
        inner = g.run
        stage = g._stage_mask
        self.runs, self.grammar_wrong = [], []
        self.copies = []        # (name, bytes, start event, end event)

        def stage_mask(name, a):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            stage(name, a)
            ev[1].record()
            self.copies.append((name, a.nbytes, *ev))

        g._stage_mask = stage_mask

        def run(kind, n, **kw):
            constrained = engine._constrained_active(engine._ready_slots())
            replays, graphs = g.replays, len(g.graphs)
            out = inner(kind, n, **kw)
            self.runs.append({
                "kind": kind, "n": n, "constrained": constrained,
                "masked": "gmask" in kw or "gmasks" in kw,
                "runs": g.replays - replays + len(g.graphs) - graphs})
            if kind in ("mspec", "pmspec"):
                self._masked_round(out, kw)
            return out

        g.run = run

    def undo(self):
        super().undo()
        del self.engine.graphs.__dict__["_stage_mask"]

    def copy_ms(self) -> dict:
        """Device ms of every mask copy, by buffer name (synchronizes)."""
        import torch

        torch.cuda.synchronize()
        out: dict[str, list[float]] = {}
        for name, _, a, b in self.copies:
            out.setdefault(name, []).append(a.elapsed_time(b))
        return out

    def _masked_round(self, out, kw) -> None:
        import numpy as np

        e = self.engine
        k = e.speculative_k
        spec = out["spec"].cpu().numpy()
        toks, gm = kw["spec_tokens"], kw["gmasks"]
        host = np.cumprod(spec[:, :k] == toks[:, 1:], axis=1).sum(axis=1)
        self.acc_checked += 1
        if not np.array_equal(host, spec[:, k + 1]):
            self.acc_wrong.append([host.tolist(), spec[:, k + 1].tolist()])
        for s, cs in enumerate(e.slot_constraint):
            if cs is None:
                continue
            n_acc, limit, cur = int(spec[s, k + 1]), k, cs.cur
            for j in range(k):
                cur = cs.auto.step(cur, int(toks[s, j + 1]))
                if cur is None:
                    limit = j
                    break
            bonus = int(spec[s, n_acc])
            if n_acc > limit or gm[s, n_acc, bonus] != 0:
                self.grammar_wrong.append(
                    {"slot": s, "n_acc": n_acc, "forbidden_at": limit,
                     "bonus": bonus})

    def dispatch_checks(self) -> dict:
        """(c): while a ready slot is constrained every dispatch is a
        masked kind at n 1 (a spec round at m 0) and one graph run; no
        masked kind runs otherwise."""
        bad = [r for r in self.runs if r["kind"] != "droll" and (
            r["masked"] != r["constrained"]
            or (r["kind"] in MASKED_KINDS) != r["constrained"]
            or (r["constrained"] and (
                r["n"] != (0 if r["kind"].endswith("spec") else 1)
                or r["runs"] != 1)))]
        kinds = {}
        for r in self.runs:
            kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
        return {"graph_runs": len(self.runs), "by_kind": kinds,
                "constrained_runs": sum(r["constrained"] for r in self.runs),
                "bad": bad[:4], "grammar_wrong": self.grammar_wrong[:4]}


def struct_run(engine, schedule, prompts, auto, long_prompt) -> tuple:
    """The schedule replayed open loop into the running engine (even
    arrivals carry the grammar), then the long plain document; waits for
    every request. Returns the requests in schedule order (the document
    last) and the arrivals' lateness."""
    from types import SimpleNamespace

    from llm_in_practise_tpu_torch.serve import arrivals
    from llm_in_practise_tpu_torch.serve.engine import SamplingParams

    def submit(a):
        sp = SamplingParams(greedy=True, max_tokens=a.max_tokens,
                            constraint=auto if a.i % 2 == 0 else None)
        return engine.submit(prompts[a.i], sp)

    items = [SimpleNamespace(at_s=a.at_s, max_tokens=a.max_tokens, i=i)
             for i, a in enumerate(schedule)]
    late = []
    reqs = arrivals.replay(items, submit, workers=len(items), lateness=late)
    reqs.append(engine.submit(long_prompt, SamplingParams(
        greedy=True, max_tokens=STRUCT_LONG_TOKENS)))
    for r in reqs:
        r.result()
    if engine.error is not None:
        raise SystemExit(f"serve_struct: engine failed: {engine.error!r}")
    return reqs, arrivals.lateness_stats(late)


def struct_outputs(reqs, auto, tok, label: str) -> dict:
    """(a) and (e) over the constrained requests (even arrivals): a
    completion that ended in ``stop`` parses and validates, no cursor
    counts a violation (streams cut by ``length`` counted apart), and the
    first token is allowed by the grammar's start state."""
    from llm_in_practise_tpu_torch.serve import constrain

    con = [r for i, r in enumerate(reqs[:-1]) if i % 2 == 0]
    start = auto.mask(auto.start)
    out = {"constrained": len(con), "stop": 0, "length": 0, "valid": 0,
           "violations": 0, "first_token_allowed": 0, "values": []}
    for r in con:
        cs = r.constraint_state
        out["violations"] += cs.violations if cs is not None else 1
        out[r.finish_reason] = out.get(r.finish_reason, 0) + 1
        ids = list(r.output_ids)
        out["first_token_allowed"] += bool(ids and start[ids[0]] == 0)
        if r.finish_reason == "stop":
            text = tok.decode(ids)
            try:
                ok = constrain.validate_instance(json.loads(text),
                                                 STRUCT_SCHEMA)
            except ValueError:
                ok = False
            out["valid"] += ok
            if len(out["values"]) < 2:
                out["values"].append(text)
    if (out["valid"] != out["stop"] or out["violations"]
            or out["first_token_allowed"] != len(con)
            or out["stop"] + out["length"] != len(con)):
        raise SystemExit(f"serve_struct {label}: a constrained output "
                         f"failed (a) or (e): {out}")
    return out


def struct_replay_check(engine, seed: int) -> dict:
    """(b): every captured masked graph, replayed once, against its eager
    body on copies of the same state and inputs (random masks, a tenth of
    each row allowed): the outputs and every state byte identical."""
    import numpy as np
    import torch

    from llm_in_practise_tpu_torch.ops import launch_count
    from llm_in_practise_tpu_torch.serve.constrain import NEG_INF
    from llm_in_practise_tpu_torch.serve.paged_kv import window_idx

    g, b = engine.graphs, engine.max_slots
    dev, k, c = engine.device, engine.speculative_k, engine.chunked_prefill
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    vocab = engine.model.config.vocab_size
    state = []
    if engine.cache is not None:
        state += [layer[key] for layer in engine.cache for key in ("k", "v")]
    if engine.paged is not None:
        state.append(engine.paged.store)
    saved = [t.clone() for t in state]

    def restore():
        for t, s in zip(state, saved):
            t.copy_(s)

    def compared(t):
        # the pool past its trash page (discarded writes, no fixed order)
        if engine.paged is not None and t is engine.paged.store:
            return t[:, engine.paged.page_size:]
        return t

    def rand_mask(name):
        m = g.masks[name]
        m.copy_(torch.where(torch.rand(m.shape, device=dev, generator=gen)
                            < 0.9, NEG_INF, 0.0))

    def index_bufs(width, starts, valid, wwin):
        pg = engine.paged
        for name, a in (("gidx", pg.gather_idx(width)),
                        ("vidx", window_idx(starts, width, wwin)),
                        ("sidx", pg.scatter_idx(starts, valid, wwin))):
            flat = torch.from_numpy(a.reshape(-1).astype(np.int64))
            g._index_buf(name, flat.numel()).copy_(flat)

    snap = launch_count.snapshot()
    out = {}
    x = g.inputs
    rows = np.arange(b)
    try:
        with torch.inference_mode():
            for key in sorted(g.graphs, key=str):
                kind, n, _, width, _ = key
                if kind not in MASKED_KINDS:
                    continue
                span = width or engine.cache_len
                x["tokens"].copy_(torch.randint(0, vocab, (b,), device=dev,
                                                generator=gen))
                mask = (rows % 2 == 0).astype(np.int64)
                if kind in ("mspec", "pmspec"):
                    wwin = k + 1 + n
                    base = np.minimum(rows * 37 + 5, span - wwin)
                    x["spec_tokens"].copy_(torch.randint(
                        0, vocab, (b, k + 1), device=dev, generator=gen))
                    x["index"].copy_(torch.from_numpy(base))
                    x["spec_mask"].copy_(torch.from_numpy(mask))
                    rand_mask("gmasks")
                    if kind == "pmspec":
                        index_bufs(width, base, mask * wwin, wwin)
                elif kind in ("mdecode", "pmdecode"):
                    idx = np.minimum(rows * 37 + 5, span - n)
                    x["index"].copy_(torch.from_numpy(idx))
                    rand_mask("gmask")
                    if kind == "pmdecode":
                        index_bufs(width, idx, mask * n, n)
                else:
                    starts = np.minimum(rows * 37 + 5, span - c - n)
                    lens = np.where(mask == 1, rows * 29 % c + 1, 0)
                    advance = np.where(mask == 1, 0, n)
                    x["chunk_ids"].copy_(torch.randint(
                        0, vocab, (b, c), device=dev, generator=gen))
                    for name, a in (("starts", starts), ("lens", lens),
                                    ("advance", advance)):
                        x[name].copy_(torch.from_numpy(a))
                    rand_mask("gmask")
                    if kind == "pmmixed":
                        index_bufs(width, starts, lens + advance, c)
                graph, static_out, _ = g.graphs[key]
                restore()
                graph.replay()
                torch.cuda.synchronize()
                got = {n_: v.clone() for n_, v in static_out.items()}
                got_state = [compared(t).clone() for t in state]
                restore()
                want = g._body(key)
                torch.cuda.synchronize()
                out[f"{kind} n={n} width={width}"] = {
                    "outputs_identical": all(torch.equal(got[n_], want[n_])
                                             for n_ in got),
                    "state_identical": all(
                        torch.equal(a, compared(t))
                        for a, t in zip(got_state, state))}
                del got, got_state
        restore()
    finally:
        launch_count.restore(snap)
        del saved
    if not all(all(r.values()) for r in out.values()):
        raise SystemExit(f"serve_struct: a masked replay differs from its "
                         f"eager body: {out}")
    return out


def struct_tpot(reqs) -> dict:
    def med(vals):
        vals = [v for v in vals if v is not None]
        return statistics.median(vals) if vals else None

    body = reqs[:-1]
    con = [r for i, r in enumerate(body) if i % 2 == 0]
    plain = [r for i, r in enumerate(body) if i % 2 == 1]
    return {"tpot_p50_s": {"constrained": med(r.tpot_s for r in con),
                           "plain": med(r.tpot_s for r in plain)},
            "ttft_p50_s": {"constrained": med(r.ttft_s for r in con),
                           "plain": med(r.ttft_s for r in plain)}}


def struct_leg(name: str, engine, model, auto, schedule, prompts,
               long_prompt, tok, seed: int) -> dict:
    """One leg: a warm-up replay of the traffic (it captures the variants
    and compiles the grammar states the counted run reaches), then the
    counted replay with the launch counters zeroed before and read after,
    the recorders on and the mask copies timed, then the replay check of
    the masked graphs. Every check of the leg exits non-zero."""
    import torch

    g = engine.graphs
    t_leg = time.monotonic()
    states0, comp0 = auto.states_compiled, auto.compile_seconds
    capture, pool_mib = g._capture, {}

    def rec_capture(key):
        before = g.pool_bytes
        capture(key)
        pool_mib[key] = (g.pool_bytes - before) / 2**20

    g._capture = rec_capture
    engine.start()
    try:
        t0 = time.monotonic()
        warm, _ = struct_run(engine, schedule, prompts, auto, long_prompt)
        warm_s = time.monotonic() - t0
        first = warm[0]         # the schedule's first constrained request
        warm_states = auto.states_compiled - states0
        warm_compile = auto.compile_seconds - comp0
        rec = StructRecorder(engine)
        zero_counters()
        before = {k: getattr(engine, k) for k in SPEC_COUNTERS}
        before.update(mask_s=engine.grammar_mask_seconds_total,
                      rejects=engine.spec_grammar_rejects,
                      states=auto.states_compiled,
                      compile_s=auto.compile_seconds,
                      mixed=engine.mixed_blocks)
        t0 = time.monotonic()
        try:
            reqs, lateness = struct_run(engine, schedule, prompts, auto,
                                        long_prompt)
            torch.cuda.synchronize()
        finally:
            rec.undo()
        wall = time.monotonic() - t0
    finally:
        engine.stop()
        del g.__dict__["_capture"]
    routes = read_routes()["nf4_matmul"]
    launches = read_counters()["nf4_matmul"]
    delta = {k: getattr(engine, k) - before[k] for k in SPEC_COUNTERS}
    want = route_launches("nf4", spec_rows(engine, delta, rec),
                          PROJ_SHAPES.values(), N_LAYER)
    copy_ms = rec.copy_ms()
    masked_steps = len(rec.copies)
    mask_s = engine.grammar_mask_seconds_total - before["mask_s"]
    compile_s = auto.compile_seconds - before["compile_s"]
    dispatch = rec.dispatch_checks()
    rounds = rec.round_checks()
    outputs = struct_outputs(reqs, auto, tok, name)
    mib = {"gmask": MAX_SLOTS * model.config.vocab_size * 4 / 2**20}
    if engine.speculative_k is not None:
        mib["gmasks"] = mib["gmask"] * (engine.speculative_k + 1)
    res = {
        "leg": name, "requests": len(reqs), "wall_s": wall,
        "warmup_wall_s": warm_s, **struct_tpot(reqs),
        "first_request": {"tpot_s": first.tpot_s, "ttft_s": first.ttft_s,
                          "states_compiled_in_warmup": warm_states,
                          "compile_s_in_warmup": warm_compile},
        "finish": [r.finish_reason for r in reqs],
        "lateness": lateness,
        "outputs": outputs,
        "masked_steps": masked_steps,
        "mask_host_ms_per_step": (mask_s - compile_s) * 1e3 / masked_steps
        if masked_steps else None,
        "grammar_mask_s": mask_s, "grammar_compile_s": compile_s,
        "states_compiled": auto.states_compiled - before["states"],
        "mask_copy": {name_: {"mib": mib[name_], "copies": len(v),
                              "ms_p50": statistics.median(v),
                              "ms_max": max(v)}
                      for name_, v in copy_ms.items()},
        "mask_copy_bytes": sum(c[1] for c in rec.copies),
        "spec": {k: delta[k] for k in ("spec_rounds", "spec_proposed",
                                       "spec_accepted", "spec_round_tokens")},
        "spec_grammar_rejects": engine.spec_grammar_rejects
        - before["rejects"],
        "mixed_blocks": engine.mixed_blocks - before["mixed"],
        "dispatch_checks": dispatch, "round_checks": rounds,
        "forwards": {k: delta[k] for k in SPEC_COUNTERS[:7]},
        "b1_routes": routes, "b1_expected": want,
        "captures": len(g.capture_s),
        "masked_captures": {f"{k[0]} n={k[1]} w={k[3]}": {
            "capture_s": g.capture_s[k],
            "pool_mib": pool_mib.get(k)}
            for k in g.capture_s if k[0] in MASKED_KINDS},
        "graph_pool_mib": g.pool_bytes / 2**20}
    log(f"serve_struct {name}:", json.dumps(res))
    if (routes != want or launches != sum(routes.values())
            or any(f not in ("stop", "length") for f in res["finish"])):
        raise SystemExit(f"serve_struct {name}: B1 launches {routes} differ "
                         f"from the engine's forwards ({want}), or a bad "
                         f"finish")
    if (dispatch["bad"] or dispatch["grammar_wrong"]
            or not dispatch["constrained_runs"] or rounds["bad_rounds"]
            or rounds["n_acc_wrong"]
            or rounds["n_acc_checked"] != rounds["rounds"]):
        raise SystemExit(f"serve_struct {name}: the dispatch or round "
                         f"checks failed: {dispatch} {rounds}")
    t0 = time.monotonic()
    res["replay_check"] = struct_replay_check(engine, seed)
    res["replay_check_wall_s"] = time.monotonic() - t0
    log(f"serve_struct {name} replay check:",
        json.dumps(res["replay_check"]))
    res["leg_wall_s"] = time.monotonic() - t_leg
    res["launches"] = launches
    return res


def struct_embeddings(srv, base: str) -> dict:
    """(f) for ``/v1/embeddings``: two strings and a token list over HTTP,
    the counters zeroed before and read after (B1 at each input's rows,
    the flash forward once per layer and input), each unit vector against
    the plain version's."""
    import numpy as np

    ids = srv.tokenizer.encode(EMBED_INPUTS[0])[:5] + [7, 11, 13]
    inputs = list(EMBED_INPUTS) + [ids]
    rows = [len(srv.tokenizer.encode(t)) for t in EMBED_INPUTS] + [len(ids)]
    zero_counters()
    req = urllib.request.Request(
        base + "/v1/embeddings", data=json.dumps(
            {"model": "qwen3-8b-nf4-struct", "input": inputs}).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=600) as r:
        body = json.loads(r.read())
    wall = time.monotonic() - t0
    routes = read_routes()["nf4_matmul"]
    counts = read_counters()
    want = route_launches("nf4", rows, PROJ_SHAPES.values(), N_LAYER)
    got = [np.asarray(d["embedding"]) for d in body["data"]]
    undo = plain_kernels()
    try:
        plain = []
        for x in [srv.tokenizer.encode(t) for t in EMBED_INPUTS] + [ids]:
            v = srv.embed_ids(x)
            plain.append(v / np.linalg.norm(v))
    finally:
        undo()
    errs = [float(np.abs(a - p).max()) for a, p in zip(got, plain)]
    scale = max(float(np.abs(p).max()) for p in plain)
    res = {"inputs": len(inputs), "rows": rows, "wall_s": wall,
           "usage": body["usage"], "dim": len(got[0]),
           "norms": [float(np.linalg.norm(v)) for v in got],
           "max_abs_err": max(errs), "max_rel_err": max(errs) / scale,
           "cosine_min": min(float(a @ p) for a, p in zip(got, plain)),
           "tol": f"{MODEL_TOL} * max|plain|, as the model check",
           "b1_routes": routes, "b1_expected": want,
           "flash_forward": counts["flash_forward"],
           "flash_expected": N_LAYER * len(inputs)}
    if (routes != want or counts["flash_forward"] != N_LAYER * len(inputs)
            or body["usage"]["prompt_tokens"] != sum(rows)
            or any(abs(n - 1.0) > 1e-6 for n in res["norms"])
            or res["max_abs_err"] > MODEL_TOL * scale):
        raise SystemExit(f"serve_struct embeddings: the checks failed: "
                         f"{res}")
    return res


def struct_http(model, tok, seed: int) -> dict:
    """The HTTP leg, on a server built by the CLI's code (paged, chunked
    prefill 256, decode blocks of 8): ``json_schema`` not streamed and
    streamed, ``json_object``, a tool call forced by name, ``tools`` with
    ``auto`` (served unconstrained), a 422 ``invalid_constraint`` and a
    malformed-shape 422, then ``/v1/embeddings``. Checks (a), (e) and
    (g) on what it returns."""
    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.serve import constrain
    from llm_in_practise_tpu_torch.serve.__main__ import (
        build_engine,
        build_parser,
    )
    from llm_in_practise_tpu_torch.serve.api import OpenAIServer

    argv = ["--tokenizer_path", "-", "--max_slots", str(MAX_SLOTS),
            "--cache_len", str(CACHE_LEN), "--kv-cache-dtype", "bfloat16",
            "--enable-chunked-prefill", str(STRUCT["chunked_prefill"]),
            "--decode-steps", str(STRUCT["decode_steps"])]
    engine = build_engine(model, build_parser().parse_args(argv),
                          eos_id=tok.token_to_id(IM_END))
    seen = []
    submit = engine.submit

    def recording_submit(*a, **kw):
        seen.append(submit(*a, **kw))
        return seen[-1]

    engine.submit = recording_submit
    srv = OpenAIServer(engine, tok, model_name="qwen3-8b-nf4-struct")
    base = f"http://127.0.0.1:{srv.serve(host='127.0.0.1', port=0, background=True)}"

    def body(**kw):
        return {"model": "qwen3-8b-nf4-struct", "temperature": 0.0,
                "max_tokens": STRUCT_HTTP_TOKENS,
                "messages": chat("Reply with a JSON record of a person."),
                **kw}

    def post(b):
        req = urllib.request.Request(
            base + "/v1/chat/completions", data=json.dumps(b).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())

    res = {}
    try:
        t0 = time.monotonic()
        res["json_schema"] = post_chat(base, body(
            response_format=struct_rf()))
        res["json_schema_stream"] = post_chat(base, body(
            response_format=struct_rf(), stream=True))
        res["json_object"] = post_chat(base, body(
            response_format={"type": "json_object"}))
        tool = post(body(tools=[STRUCT_TOOL], tool_choice={
            "type": "function", "function": {"name": "lookup"}}))
        auto_ = post_chat(base, body(tools=[STRUCT_TOOL], tool_choice="auto",
                                     max_tokens=16))
        bad = post_429(base, body(response_format={
            "type": "json_schema", "json_schema": {"schema": {
                "type": "integer", "minimum": 2}}}))
        shape = post_429(base, body(response_format={"type": "yaml"}))
        res["chat_wall_s"] = time.monotonic() - t0
        res["embeddings"] = struct_embeddings(srv, base)
    finally:
        srv.shutdown()
    if engine.error is not None:
        raise SystemExit(f"serve_struct http: engine failed: "
                         f"{engine.error!r}")
    reqs = list(seen)
    choice = tool["choices"][0]
    calls = choice["message"].get("tool_calls") or [{}]
    fn = calls[0].get("function", {})
    try:
        args = json.loads(fn.get("arguments", "null"))
    except ValueError:
        args = None
    res["tool_call"] = {"finish_reason": choice["finish_reason"],
                        "content": choice["message"]["content"],
                        "calls": len(calls), "name": fn.get("name"),
                        "arguments": fn.get("arguments"),
                        "id": calls[0].get("id"), "type": calls[0].get("type")}
    res["tools_auto"] = {"finish_reason": auto_["finish_reason"],
                         "constrained": reqs[4].params.constraint is not None}
    res["errors"] = {"invalid_constraint": [bad[0], bad[1]["error"].get(
        "code")], "malformed": [shape[0], shape[1]["error"].get("code")]}
    res["structured_counts"] = dict(srv.structured_counts)
    res["vocab_strings_s"] = srv.vocab_seconds
    res["server_states_compiled"] = sum(
        a.states_compiled for a in srv.constraints._cache.values())
    res["server_compile_s"] = sum(
        a.compile_seconds for a in srv.constraints._cache.values())
    res["requests"] = [{"finish": r.finish_reason, "tokens": len(r.output_ids),
                        "tpot_s": r.tpot_s, "ttft_s": r.ttft_s,
                        "violations": None if r.constraint_state is None
                        else r.constraint_state.violations}
                       for r in reqs]
    log("serve_struct http:", json.dumps(res))
    schema_ok = []
    for key in ("json_schema", "json_schema_stream"):
        r = res[key]
        ok = r["finish_reason"] == "length"
        if r["finish_reason"] == "stop":
            try:
                ok = constrain.validate_instance(json.loads(r["content"]),
                                                 STRUCT_SCHEMA)
            except ValueError:
                ok = False
        schema_ok.append(ok)
    obj = res["json_object"]
    obj_ok = obj["finish_reason"] == "length"
    if obj["finish_reason"] == "stop":
        try:
            obj_ok = isinstance(json.loads(obj["content"]), dict)
        except ValueError:
            obj_ok = False
    tc = res["tool_call"]
    tool_ok = (tc["finish_reason"] == "tool_calls" and tc["content"] is None
               and tc["calls"] == 1 and tc["name"] == "lookup"
               and tc["type"] == "function"
               and str(tc["id"]).startswith("call_")
               and constrain.validate_instance(
                   args, STRUCT_TOOL["function"]["parameters"]))
    if not (all(schema_ok) and obj_ok and tool_ok
            and res["json_schema_stream"].get("done")
            and not res["tools_auto"]["constrained"]
            and res["tools_auto"]["finish_reason"] in ("stop", "length")
            and res["errors"] == {"invalid_constraint":
                                  [422, "invalid_constraint"],
                                  "malformed": [422, None]}
            and res["structured_counts"] == {"json_object": 1,
                                             "json_schema": 2,
                                             "tool_call": 1}
            and all(not r["violations"] for r in res["requests"])):
        raise SystemExit(f"serve_struct http: the checks failed: {res}")
    res["launches"] = sum(res["embeddings"]["b1_routes"].values())
    return res


def struct_phase(model, tok, seed: int, card: str, nf4_cell: dict) -> dict:
    """serve_struct on the NF4 model (Qwen3-8B width, full depth): the JAX
    structured bench's traffic, ``arrivals.synthesize(seed=42, 16
    requests, mean gap 20 ms, cv 2, prompts of 8-48 tokens, 72-128 new
    tokens)``, half carrying the bench's schema and half plain, replayed
    open loop (then a 700-token plain document, so the fused mixed step
    runs its masked twin), through paged engines with speculation off,
    the prompt lookup (k = 4) and the target as its own draft (k = 4), and
    contiguous engines with it off and with the prompt lookup; then the
    HTTP leg. Checks, each
    exiting non-zero: (a) every constrained completion that ended in
    ``stop`` parses and validates, and no cursor counts a violation; (b)
    every masked graph replays its eager body byte for byte; (c) while a
    ready slot is constrained every dispatch is a masked kind at n 1 (m 0)
    and one graph run, no masked kind runs otherwise, the plain requests
    finish; (d) in the masked spec rounds ``n_acc`` equals the host's
    recount, is bounded by the first grammar-forbidden draft, and the
    target-draft leg counts grammar rejects; (e) every constrained first
    token is allowed by the start state; (f) B1's launches per route
    follow from the engine's forwards, and ``/v1/embeddings`` runs B1 at
    each input's rows with vectors within ``MODEL_TOL`` of the plain
    version's; (g) the forced tool call comes back as ``tool_calls``."""
    import gc

    import torch

    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.serve import arrivals, constrain

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    vocab_n = model.config.vocab_size
    t0 = time.monotonic()
    vocab = constrain.vocab_strings(tok, vocab_n)
    vocab_s = time.monotonic() - t0
    t0 = time.monotonic()
    auto = constrain.ConstraintCompiler().get(
        response_format=struct_rf(), vocab=vocab, vocab_key=0,
        eos_id=tok.token_to_id(IM_END))
    grammar_s = time.monotonic() - t0
    schedule = arrivals.synthesize(**STRUCT_ARRIVALS)
    prompts, long_prompt = struct_prompts(tok, schedule)
    legs, launches, routes = {}, 0, {}
    for name, kw in (("paged_off", {}),
                     ("paged_ngram", {"speculative_k": SPEC_K}),
                     ("paged_target_draft", {"speculative_k": SPEC_K,
                                             "draft_model": model}),
                     ("contiguous_off", {"kv_layout": "contiguous"}),
                     ("contiguous_ngram", {"kv_layout": "contiguous",
                                           "speculative_k": SPEC_K})):
        engine = struct_engine(model, tok, seed, **kw)
        res = struct_leg(name, engine, model, auto, schedule, prompts,
                         long_prompt, tok, seed)
        launches += res.pop("launches")
        for r, c in res["b1_routes"].items():
            routes[r] = routes.get(r, 0) + c
        legs[name] = res
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    http = struct_http(model, tok, seed)
    http["leg_wall_s"] = time.monotonic() - t0
    launches += http.pop("launches")
    for r, c in http["embeddings"]["b1_routes"].items():
        routes[r] = routes.get(r, 0) + c
    gc.collect()
    torch.cuda.empty_cache()
    # (b) covered the masked kinds the legs ran; (c) the mixed twin ran;
    # (d) the target's unmasked drafts break the grammar and are counted
    checked = {key.split()[0] for leg in legs.values()
               for key in leg["replay_check"]}
    if not {"pmdecode", "mdecode", "pmspec", "mspec"} <= checked or not (
            checked & {"pmmixed", "mmixed"}):
        raise SystemExit(f"serve_struct: replay-checked masked kinds "
                         f"{sorted(checked)}")
    if not legs["paged_target_draft"]["spec_grammar_rejects"]:
        raise SystemExit("serve_struct: the target-draft leg counted no "
                         "grammar reject")
    res = {"card": card, "layers": N_LAYER, "max_slots": MAX_SLOTS,
           "cache_len": CACHE_LEN, "k": SPEC_K, **STRUCT,
           "arrivals": {**STRUCT_ARRIVALS,
                        **arrivals.describe(schedule)},
           "vocab_strings_s": vocab_s, "grammar_build_s": grammar_s,
           "states_compiled": auto.states_compiled,
           "compile_s": auto.compile_seconds,
           "compile_s_per_state": auto.compile_seconds
           / max(auto.states_compiled, 1),
           "masked_kinds_checked": sorted(checked),
           "legs": legs, "http": http,
           "nf4_cell_tpot_p50_s": nf4_cell["tpot_p50_s"],
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2**30,
           "phase_wall_s": time.monotonic() - t_phase}
    log("serve_struct:", json.dumps({k: v for k, v in res.items()
                                     if k not in ("legs", "http")}))
    return {"struct": res, "launches": launches, "routes": routes,
            "flash_launches": http["embeddings"]["flash_forward"]}


LORA = dict(decode_steps=8, chunked_prefill=256, mixed_step=True)
# tools/multi_lora_bench.py:259-261's schedule
LORA_ARRIVALS = dict(seed=42, n_requests=16, mean_iat_s=0.02, cv=2.0,
                     prompt_tokens=(8, 48), max_tokens=(16, 48))
LORA_PINS = (None, "sft-a", "sft-b", "qv-8", "ladder-6")  # arrival i % 5
LORA_SCHEMA_ARRIVALS = (1, 8)   # an sft-a and a qv-8 arrival under SCHEMA
LORA_LONG = 700                 # a document under sft-a, chunk-prefilling
LORA_LONG_TOKENS = 16
# examples/qwen3_lora_sft.py:72-73, 113-114 (the SFT default; the model's
# attention output projection is out_proj, so o_proj matches nothing),
# bench.py:641-642, tools/multi_lora_bench.py:54, 88-89
SFT_TARGETS = (r"attn/(q_proj|k_proj|v_proj|o_proj)",)
LORA_ADAPTERS = {"sft-a": (16, 32.0, SFT_TARGETS),
                 "sft-b": (16, 32.0, SFT_TARGETS),
                 "qv-8": (8, 16.0, ("q_proj", "v_proj")),
                 "ladder-6": (6, 12.0, ("attn/q_proj", "mlp"))}
LORA_B_STD = 0.05     # B ~ N(0, 0.05), A ~ N(0, 1/K): a delta about a
#                       third of the base projection, so streams differ
LORA_HOT = ("hot-1", "hot-2")   # r 16 loads that grow bucket 16 from 4 to 8
# (b): every emitted token of a mixed batch is in the top LORA_TOP_K of
# an eager batch-1 forward of its row alone under its adapter, and lies
# at most LORA_GAP_TOL below that forward's top logit (set from the
# 4-layer probe before the full run; see PERF.md)
LORA_TOP_K = 5
LORA_GAP_TOL = 1.0
LORA_PROFILE_STEPS = 3


def lora_tree(name: str, seed: int, n_layer: int) -> dict:
    """A seeded LoRA tree of ``LORA_ADAPTERS[name]`` for the Qwen3-8B
    projections of ``n_layer`` layers, on the card."""
    import torch

    from llm_in_practise_tpu_torch.peft.lora import LoRAConfig, target_paths

    r, alpha, targets = LORA_ADAPTERS.get(name, LORA_ADAPTERS["sft-a"])
    shapes = {}
    for i in range(n_layer):
        for proj, (k, n) in PROJ_SHAPES.items():
            sub = "mlp" if proj in ("gate_proj", "up_proj", "down_proj") \
                else "attn"
            shapes[f"blocks.{i}.{sub}.{proj}.kernel"] = torch.empty(
                k, n, device="meta")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tree = {}
    for path in target_paths(shapes, LoRAConfig(r=r, alpha=alpha,
                                                target_patterns=targets)):
        k, n = shapes[path].shape
        tree[path] = {
            "a": torch.randn(k, r, device="cuda", generator=gen) / math.sqrt(k),
            "b": torch.randn(r, n, device="cuda", generator=gen) * LORA_B_STD}
    return tree


def lora_config(name: str):
    from llm_in_practise_tpu_torch.peft.lora import LoRAConfig

    r, alpha, targets = LORA_ADAPTERS.get(name, LORA_ADAPTERS["sft-a"])
    return LoRAConfig(r=r, alpha=alpha, target_patterns=targets)


def lora_registry(model, sft_a_path: str, seed: int, **kw):
    """The phase's registry: ``sft-a`` through ``register(path)`` (the
    checkpoint the port's ``save_named`` wrote), the others as trees."""
    from llm_in_practise_tpu_torch.serve.multi_lora import AdapterRegistry

    reg = AdapterRegistry(model, **kw)
    reg.register("sft-a", sft_a_path)
    for i, name in enumerate(("sft-b", "qv-8", "ladder-6")):
        reg.register_tree(name, lora_tree(name, seed + 2 + i, N_LAYER),
                          lora_config(name))
    return reg


def lora_engine(model, tok, seed: int, registry=None, **kw):
    import torch

    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.serve.engine import InferenceEngine

    return InferenceEngine(model, max_slots=MAX_SLOTS, cache_len=CACHE_LEN,
                           eos_id=tok.token_to_id(IM_END),
                           cache_dtype=torch.bfloat16, seed=seed,
                           adapter_registry=registry,
                           **{"kv_layout": "paged", **LORA, **kw})


def lora_run(engine, schedule, prompts, long_prompt, pins, auto) -> tuple:
    """The schedule replayed open loop into the running engine, arrival
    ``i`` under ``pins[i % len(pins)]`` (the ``LORA_SCHEMA_ARRIVALS``
    under the schema), then the long document under ``sft-a`` (base when
    every pin is None); waits for every request."""
    from types import SimpleNamespace

    from llm_in_practise_tpu_torch.serve import arrivals
    from llm_in_practise_tpu_torch.serve.engine import SamplingParams

    def submit(a):
        sp = SamplingParams(
            greedy=True, max_tokens=a.max_tokens,
            constraint=auto if a.i in LORA_SCHEMA_ARRIVALS else None)
        return engine.submit(prompts[a.i], sp, adapter=pins[a.i % len(pins)])

    items = [SimpleNamespace(at_s=a.at_s, max_tokens=a.max_tokens, i=i)
             for i, a in enumerate(schedule)]
    late = []
    reqs = arrivals.replay(items, submit, workers=len(items), lateness=late)
    doc = "sft-a" if any(pins) else None
    reqs.append(engine.submit(long_prompt, SamplingParams(
        greedy=True, max_tokens=LORA_LONG_TOKENS), adapter=doc))
    for r in reqs:
        r.result()
    if engine.error is not None:
        raise SystemExit(f"serve_lora: engine failed: {engine.error!r}")
    return reqs, arrivals.lateness_stats(late)


def lora_sync(engine, prompts, pins, max_tokens: int = 24) -> list:
    """The prompts submitted at once (prompt ``i`` under ``pins[i]``) and
    stepped on this thread until idle: one deterministic order of batch
    shapes, so two engines' streams compare byte for byte."""
    from llm_in_practise_tpu_torch.serve.engine import SamplingParams

    sp = SamplingParams(greedy=True, max_tokens=max_tokens)
    reqs = [engine.submit(p, sp, adapter=a) for p, a in zip(prompts, pins)]
    while engine.step():
        pass
    return [list(r.output_ids) for r in reqs]


class LoraRecorder(SpecRecorder):
    """:class:`SpecRecorder`'s hooks, and on every graph run its kind,
    whether it carried adapter rows, the distinct adapters of the ready
    slots and its graph runs; on every decode block and fused step the
    dispatches it made."""

    def __init__(self, engine):
        super().__init__(engine)
        g = engine.graphs
        inner = g.run
        self.runs, self.blocks = [], []

        def run(kind, n, **kw):
            ready = engine._ready_slots()
            replays, graphs = g.replays, len(g.graphs)
            out = inner(kind, n, **kw)
            self.runs.append({
                "kind": kind, "lora": kw.get("lora") is not None,
                "adapters": len({engine.slot_adapter[s] for s in ready}),
                "runs": g.replays - replays + len(g.graphs) - graphs})
            return out

        g.run = run
        self._blocks_saved = (engine._decode, engine._mixed_dispatch)
        decode, mixed = self._blocks_saved

        def rec(fn, name):
            def wrapped(active, n):
                d0 = engine.dispatches_total
                out = fn(active, n)
                self.blocks.append({
                    "path": name, "dispatches": engine.dispatches_total - d0,
                    "adapters": len({engine.slot_adapter[s]
                                     for s in active})})
                return out
            return wrapped

        engine._decode = rec(decode, "decode")
        engine._mixed_dispatch = rec(mixed, "mixed")

    def undo(self):
        super().undo()
        for name in ("_decode", "_mixed_dispatch"):
            del self.engine.__dict__[name]

    def dispatch_checks(self) -> dict:
        """(d): every decode block and fused step is one dispatch; every
        graph run is one replay or capture; the twins ran exactly while a
        ready slot carried an adapter; some runs mixed adapters."""
        e = self.engine
        bad_blocks = [b for b in self.blocks if b["dispatches"] > 1]
        bad_runs = [r for r in self.runs
                    if r["runs"] != 1 or (r["kind"] == "droll"
                                          and r["lora"])]
        kinds = {}
        for r in self.runs:
            key = ("l" if r["lora"] else "") + r["kind"]
            kinds[key] = kinds.get(key, 0) + 1
        return {"graph_runs": len(self.runs), "by_kind": kinds,
                "adapter_runs": sum(r["lora"] for r in self.runs),
                "mixed_adapter_runs": sum(r["lora"] and r["adapters"] > 1
                                          for r in self.runs),
                "blocks": len(self.blocks),
                "mixed_adapter_blocks": sum(b["adapters"] > 1
                                            for b in self.blocks),
                "bad_blocks": bad_blocks[:4], "bad_runs": bad_runs[:4],
                "registry": e.adapter_registry is not None}


LORA_REPLAY_PINS = (None, "sft-a", "sft-b", "qv-8", "ladder-6", None,
                    "sft-a", "qv-8")


def lora_replay_check(engine, seed: int) -> dict:
    """(a) and (c): every captured adapter twin, replayed once with rows
    under ``LORA_REPLAY_PINS``, against its eager body on copies of the
    same state and inputs (outputs and every state byte identical); then
    the base kind's eager body on the same state and inputs, whose rows
    0 and 5 (base in the twin) must equal the twin's byte for byte."""
    import numpy as np
    import torch

    from llm_in_practise_tpu_torch.ops import launch_count
    from llm_in_practise_tpu_torch.serve.constrain import NEG_INF
    from llm_in_practise_tpu_torch.serve.paged_kv import window_idx

    g, b = engine.graphs, engine.max_slots
    dev, k, c = engine.device, engine.speculative_k, engine.chunked_prefill
    reg = engine.adapter_registry
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    vocab = engine.model.config.vocab_size
    state = []
    if engine.cache is not None:
        state += [layer[key] for layer in engine.cache for key in ("k", "v")]
    if engine.paged is not None:
        state.append(engine.paged.store)
    saved = [t.clone() for t in state]
    base_rows = [i for i, a in enumerate(LORA_REPLAY_PINS) if a is None]

    def restore():
        for t, s in zip(state, saved):
            t.copy_(s)

    def compared(t):
        if engine.paged is not None and t is engine.paged.store:
            return t[:, engine.paged.page_size:]
        return t

    def index_bufs(width, starts, valid, wwin):
        pg = engine.paged
        for name, a in (("gidx", pg.gather_idx(width)),
                        ("vidx", window_idx(starts, width, wwin)),
                        ("sidx", pg.scatter_idx(starts, valid, wwin))):
            flat = torch.from_numpy(a.reshape(-1).astype(np.int64))
            g._index_buf(name, flat.numel()).copy_(flat)

    args = reg.dispatch_args(list(LORA_REPLAY_PINS))
    snap = launch_count.snapshot()
    out = {}
    x = g.inputs
    rows = np.arange(b)
    try:
        with torch.inference_mode():
            for key in sorted(g.graphs, key=str):
                lkind, n, _, width, _ = key
                if not lkind.startswith("l"):
                    continue
                kind = lkind[1:]
                g._stage_lora(args)     # same generation: fills idx only
                span = width or engine.cache_len
                x["tokens"].copy_(torch.randint(0, vocab, (b,), device=dev,
                                                generator=gen))
                mask = (rows % 2 == 0).astype(np.int64)
                for name in ("gmask", "gmasks"):
                    if name in g.masks:
                        m = g.masks[name]
                        m.copy_(torch.where(
                            torch.rand(m.shape, device=dev, generator=gen)
                            < 0.9, NEG_INF, 0.0))
                if kind.endswith("spec"):
                    wwin = k + 1 + n
                    base = np.minimum(rows * 37 + 5, span - wwin)
                    x["spec_tokens"].copy_(torch.randint(
                        0, vocab, (b, k + 1), device=dev, generator=gen))
                    x["index"].copy_(torch.from_numpy(base))
                    x["spec_mask"].copy_(torch.from_numpy(mask))
                    if kind.startswith("p"):
                        index_bufs(width, base, mask * wwin, wwin)
                elif kind.endswith("decode"):
                    idx = np.minimum(rows * 37 + 5, span - n)
                    x["index"].copy_(torch.from_numpy(idx))
                    if kind.startswith("p"):
                        index_bufs(width, idx, mask * n, n)
                else:
                    starts = np.minimum(rows * 37 + 5, span - c - n)
                    lens = np.where(mask == 1, rows * 29 % c + 1, 0)
                    advance = np.where(mask == 1, 0, n)
                    x["chunk_ids"].copy_(torch.randint(
                        0, vocab, (b, c), device=dev, generator=gen))
                    for name, a in (("starts", starts), ("lens", lens),
                                    ("advance", advance)):
                        x[name].copy_(torch.from_numpy(a))
                    if kind.startswith("p"):
                        index_bufs(width, starts, lens + advance, c)
                graph, static_out, _ = g.graphs[key]
                restore()
                graph.replay()
                torch.cuda.synchronize()
                got = {n_: v.clone() for n_, v in static_out.items()}
                got_state = [compared(t).clone() for t in state]
                restore()
                want = g._body(key)
                torch.cuda.synchronize()
                res = {"outputs_identical": all(
                           torch.equal(got[n_], want[n_]) for n_ in got),
                       "state_identical": all(
                           torch.equal(a, compared(t))
                           for a, t in zip(got_state, state))}
                restore()
                plain = g._body((kind,) + key[1:])
                torch.cuda.synchronize()
                res["base_rows_equal_base_kind"] = all(
                    torch.equal(got[n_][base_rows], plain[n_][base_rows])
                    for n_ in got if n_ != "index")
                res["adapter_rows_differ"] = any(
                    not torch.equal(got[n_][1], plain[n_][1])
                    for n_ in got if n_ != "index")
                out[f"{lkind} n={n} width={width}"] = res
                del got, got_state, want, plain
        restore()
    finally:
        launch_count.restore(snap)
        del saved
    if not all(r["outputs_identical"] and r["state_identical"]
               and r["base_rows_equal_base_kind"] for r in out.values()):
        raise SystemExit(f"serve_lora: an adapter twin differs from its "
                         f"eager body, or a base row from its base kind: "
                         f"{out}")
    return out


def lora_tpot(reqs) -> dict:
    def med(vals):
        vals = [v for v in vals if v is not None]
        return statistics.median(vals) if vals else None

    return {"tpot_p50_s": med(r.tpot_s for r in reqs[:-1]),
            "ttft_p50_s": med(r.ttft_s for r in reqs[:-1]),
            "document_ttft_s": reqs[-1].ttft_s}


def lora_leg(name: str, engine, schedule, prompts, long_prompt, pins, auto,
             seed: int, checks: bool = True) -> dict:
    """One open-loop leg: a warm-up replay (it captures the variants the
    counted run reaches), then the counted replay with the launch
    counters zeroed before and read after and the recorder on. With
    ``checks``: B1's launches per route as derived (g), the dispatch
    checks (d), every finish a stop or a length, then the replay check
    of the twins (a, c)."""
    import torch

    g = engine.graphs
    t_leg = time.monotonic()
    capture, pool_mib = g._capture, {}

    def rec_capture(key):
        before = g.pool_bytes
        capture(key)
        pool_mib[key] = (g.pool_bytes - before) / 2**20

    g._capture = rec_capture
    engine._stop.clear()        # a leg may reuse an engine an earlier leg
    engine.start()              # stopped
    try:
        t0 = time.monotonic()
        lora_run(engine, schedule, prompts, long_prompt, pins, auto)
        warm_s = time.monotonic() - t0
        rec = LoraRecorder(engine)
        zero_counters()
        before = {k: getattr(engine, k) for k in SPEC_COUNTERS}
        t0 = time.monotonic()
        try:
            reqs, lateness = lora_run(engine, schedule, prompts, long_prompt,
                                      pins, auto)
            torch.cuda.synchronize()
        finally:
            rec.undo()
        wall = time.monotonic() - t0
    finally:
        engine.stop()
        del g.__dict__["_capture"]
    if engine.paged is not None:
        engine.paged.pool.check_leaks(0)      # (f): every page returned
    routes = read_routes()["nf4_matmul"]
    launches = read_counters()["nf4_matmul"]
    delta = {k: getattr(engine, k) - before[k] for k in SPEC_COUNTERS}
    want = route_launches("nf4", spec_rows(engine, delta, rec),
                          PROJ_SHAPES.values(), N_LAYER)
    dispatch = rec.dispatch_checks()
    twins = {f"{k[0]} n={k[1]} w={k[3]}": {"capture_s": g.capture_s[k],
                                           "pool_mib": pool_mib.get(k)}
             for k in g.capture_s if k[0].startswith("l")}
    res = {"leg": name, "requests": len(reqs), "wall_s": wall,
           "warmup_wall_s": warm_s, **lora_tpot(reqs),
           "finish": [r.finish_reason for r in reqs],
           "adapters": [r.adapter for r in reqs], "lateness": lateness,
           "dispatch_checks": dispatch, "round_checks": rec.round_checks(),
           "forwards": {k: delta[k] for k in SPEC_COUNTERS[:7]},
           "b1_routes": routes, "b1_expected": want,
           "captures": len(g.capture_s), "twin_captures": twins,
           "twin_capture_s": sum(v["capture_s"] for v in twins.values()),
           "twin_pool_mib": sum(v["pool_mib"] or 0 for v in twins.values()),
           "graph_pool_mib": g.pool_bytes / 2**20,
           "lora_recaptures": g.lora_recaptures,
           "lora_idx_buffers": len(g.lora_idx)}
    log(f"serve_lora {name}:", json.dumps(res))
    if (routes != want or launches != sum(routes.values())
            or any(f not in ("stop", "length") for f in res["finish"])):
        raise SystemExit(f"serve_lora {name}: B1 launches {routes} differ "
                         f"from the engine's forwards ({want}), or a bad "
                         f"finish")
    if (dispatch["bad_blocks"] or dispatch["bad_runs"]
            or res["round_checks"]["bad_rounds"]
            or res["round_checks"]["n_acc_wrong"]):
        raise SystemExit(f"serve_lora {name}: the dispatch checks failed: "
                         f"{dispatch} {res['round_checks']}")
    if checks:
        if not dispatch["mixed_adapter_runs"]:
            raise SystemExit(f"serve_lora {name}: no graph run mixed "
                             f"adapters: {dispatch}")
        t0 = time.monotonic()
        res["replay_check"] = lora_replay_check(engine, seed)
        res["replay_check_wall_s"] = time.monotonic() - t0
        log(f"serve_lora {name} replay check:",
            json.dumps(res["replay_check"]))
    res["leg_wall_s"] = time.monotonic() - t_leg
    res["launches"] = launches
    return res, reqs


def lora_teacher(model, registry, prompts, reqs) -> dict:
    """(b): each request of a mixed batch against an eager batch-1
    forward of its row alone under its adapter (teacher-forced over the
    prompt and its stream): every token in the top ``LORA_TOP_K``, at
    most ``LORA_GAP_TOL`` below the top logit."""
    from llm_in_practise_tpu_torch.serve.multi_lora import lora_scope

    ranks, gaps = {}, {}
    for i, (prompt, r) in enumerate(zip(prompts, reqs)):
        if r.params.constraint is not None:
            continue            # its tokens obey the grammar's masks
        args = (registry.dispatch_args([r.adapter])
                if r.adapter is not None else None)
        with lora_scope(args, model.device):
            (rk, gp), = teacher_ranks(model, [prompt], [list(r.output_ids)])
        ranks.setdefault(str(r.adapter), []).extend(rk)
        gaps.setdefault(str(r.adapter), []).extend(gp)
    res = {a: {"tokens": len(ranks[a]), "max_rank": max(ranks[a]),
               "top1_share": sum(x == 0 for x in ranks[a]) / len(ranks[a]),
               "max_gap": max(gaps[a])} for a in ranks if ranks[a]}
    res["tol"] = (f"rank < {LORA_TOP_K} and top logit - token logit <= "
                  f"{LORA_GAP_TOL}")
    if any(v["max_rank"] >= LORA_TOP_K or v["max_gap"] > LORA_GAP_TOL
           for k, v in res.items() if k != "tol"):
        raise SystemExit(f"serve_lora: a mixed-batch token is off its "
                         f"batch-1 forward: {res}")
    return res


def lora_profile(engine, prompts, pins) -> dict:
    """Device time and kernel count of one decode block of 8 slots under
    ``pins``, under torch.profiler, after ``LORA_PROFILE_STEPS`` steps
    (the host wall of those steps includes the captures of each new view
    width, so it is not read); the requests then run to their end."""
    import torch
    from torch.profiler import ProfilerActivity

    from llm_in_practise_tpu_torch.obs.meter import (
        exclusive_profile as profile,
    )

    from llm_in_practise_tpu_torch.serve.engine import SamplingParams

    sp = SamplingParams(greedy=True, max_tokens=200)
    reqs = [engine.submit(p, sp, adapter=a) for p, a in zip(prompts, pins)]
    engine.step()
    engine.step()
    torch.cuda.synchronize()
    for _ in range(LORA_PROFILE_STEPS):
        engine.step()
    torch.cuda.synchronize()
    s1 = engine.decode_steps_run
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.step()
        torch.cuda.synchronize()
    per = engine.decode_steps_run - s1
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    count = sum(e.count for e in kernels)
    while engine.step():
        pass
    out = {"pins": list(pins), "profiled_decode_steps": per,
           "kernels_per_decode_step": count / max(per, 1)}
    out["device_ms_per_decode_step"] = (device_us / 1e3 / max(per, 1)
                                        if device_us else "not measured")
    return out


def lora_gather_mib(registry, slots: int) -> dict:
    """MiB the delta gathers per decode step (every bucket's factors of
    every target for each of ``slots`` rows, A and B, f32), per bucket."""
    out = {}
    with registry._lock:
        for rb, bucket in registry._buckets.items():
            per_row = 0
            for table in (bucket.stacked, bucket.flat):
                for fac in table.values():
                    per_row += (fac["a"][0].numel()
                                + fac["b"][0].numel()) * 4
            out[rb] = slots * per_row / 2**20
    return out


def lora_hot(engine, registry, prompts, seed: int) -> dict:
    """(e): r 16 loads after the legs grow bucket 16, whose banks are new
    tensors: the twins are dropped and recaptured (counted); the new
    adapter's stream is not base's, and equals the same engine's stream
    with graphs off (eager bodies over the new banks), byte for byte."""
    gen0 = registry.generation
    cap0 = registry.stats()["buckets"][16]["cap"]
    g = engine.graphs
    rec0, inv0 = g.lora_recaptures, g.lora_invalidations
    for i, name in enumerate(LORA_HOT):
        registry.register_tree(name, lora_tree(name, seed + 10 + i, N_LAYER),
                               lora_config(name))
    cap1 = registry.stats()["buckets"][16]["cap"]
    pins = (LORA_HOT[-1], None, "sft-a", LORA_HOT[-1])
    ps = prompts[:len(pins)]
    t0 = time.monotonic()
    graphs = lora_sync(engine, ps, pins)
    graph_s = time.monotonic() - t0
    g.capture = False
    try:
        eager = lora_sync(engine, ps, pins)
    finally:
        g.capture = True
    base = lora_sync(engine, ps[:1], (None,))
    res = {"bucket16_cap": [cap0, cap1],
           "generation": [gen0, registry.generation],
           "recaptures": g.lora_recaptures - rec0,
           "invalidations": g.lora_invalidations - inv0,
           "graph_equals_eager": graphs == eager,
           "hot_differs_from_base": graphs[0] != base[0],
           "wall_s": graph_s,
           "swap_seconds": list(registry.swap_seconds[-len(LORA_HOT):])}
    log("serve_lora hot-load:", json.dumps(res))
    if not (cap1 > cap0 and res["recaptures"] > 0 and res["invalidations"]
            and res["graph_equals_eager"] and res["hot_differs_from_base"]):
        raise SystemExit(f"serve_lora hot-load: the checks failed: {res}")
    return res


def lora_budget(model, seed: int) -> dict:
    """(f): a registry whose byte budget holds two r 16 adapters: loading
    a third evicts the least recently used idle one (never a busy one),
    and an exhausted budget with every row busy raises."""
    from llm_in_practise_tpu_torch.serve.multi_lora import AdapterRegistry

    probe = AdapterRegistry(model)
    probe.register_tree("x", lora_tree("x", seed + 20, N_LAYER),
                        lora_config("x"))
    one = probe.bytes_loaded
    del probe
    reg = AdapterRegistry(model, max_bytes=2 * one)
    for i, name in enumerate(("b0", "b1")):
        reg.register_tree(name, lora_tree(name, seed + 21 + i, N_LAYER),
                          lora_config(name))
    reg.acquire("b0")        # b0 used after b1: b1 is the LRU idle row
    reg.release("b0")
    reg.register_tree("b2", lora_tree("b2", seed + 23, N_LAYER),
                      lora_config("b2"))
    order = reg.names()
    reg.acquire("b0")        # every row busy: the next load must raise
    reg.acquire("b2")
    try:
        reg.register_tree("b3", lora_tree("b3", seed + 24, N_LAYER),
                          lora_config("b3"))
        exhausted = None
    except RuntimeError as e:
        exhausted = str(e)
    res = {"bytes_per_adapter": one, "max_bytes": 2 * one,
           "names_after_third": order, "stats": reg.stats(),
           "exhausted_error": exhausted}
    reg.release("b0")
    reg.release("b2")
    for name in reg.names():
        reg.evict(name)
    res["after_evict"] = {"bytes": reg.bytes_loaded,
                          "rows_in_use": sum(
                              b["cap"] - 1 - b["free"]
                              for b in reg.stats()["buckets"].values())}
    log("serve_lora byte budget:", json.dumps(res, default=str))
    if (order != ["b0", "b2"] or exhausted is None
            or "budget exhausted" not in exhausted
            or res["after_evict"] != {"bytes": 0, "rows_in_use": 0}):
        raise SystemExit(f"serve_lora byte budget: the checks failed: {res}")
    return res


def lora_prefix(model, tok, registry, seed: int) -> dict:
    """(f): the same prompt under base and two adapters never hits another
    namespace's pages; the same adapter does hit its own."""
    engine = lora_engine(model, tok, seed, registry, prefix_cache=True)
    prompt = tok.encode("Adapters keep their own prefix pages. " * 12)[:96]
    hits = []
    outs = {}
    for a in ("sft-a", None, "sft-b", "sft-a"):
        h0 = engine.prefix_cache.hits
        outs.setdefault(str(a), []).append(
            lora_sync(engine, [prompt], (a,), max_tokens=8)[0])
        hits.append(engine.prefix_cache.hits - h0)
    engine.prefix_cache.clear()
    engine.paged.pool.check_leaks(0)
    res = {"hits": hits, "streams": {a: len(v) for a, v in outs.items()},
           "sft_a_repeat_equal": outs["sft-a"][0] == outs["sft-a"][1]}
    log("serve_lora prefix isolation:", json.dumps(res))
    if hits != [0, 0, 0, 1]:
        raise SystemExit(f"serve_lora prefix isolation failed: {res}")
    del engine
    return res


def lora_http(model, tok, registry, seed: int) -> dict:
    """(h): a server built by the CLI's code (paged, chunked prefill 256,
    decode blocks of 8) over the registry, with ``AdapterHandle`` names:
    an adapter streamed and not, base, a 404 that lists the names,
    ``/v1/models``, and ``/v1/embeddings`` under an adapter name equal to
    the base vectors."""
    import numpy as np

    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.serve.__main__ import (
        build_engine,
        build_parser,
    )
    from llm_in_practise_tpu_torch.serve.api import OpenAIServer
    from llm_in_practise_tpu_torch.serve.multi_lora import AdapterHandle

    argv = ["--tokenizer_path", "-", "--max_slots", str(MAX_SLOTS),
            "--cache_len", str(CACHE_LEN), "--kv-cache-dtype", "bfloat16",
            "--enable-chunked-prefill", str(LORA["chunked_prefill"]),
            "--decode-steps", str(LORA["decode_steps"])]
    engine = build_engine(model, build_parser().parse_args(argv),
                          eos_id=tok.token_to_id(IM_END),
                          adapter_registry=registry)
    name = "qwen3-8b-nf4-lora"
    srv = OpenAIServer(engine, tok, model_name=name,
                       adapters={a: AdapterHandle(engine, a)
                                 for a in registry.names()})
    base = f"http://127.0.0.1:{srv.serve(host='127.0.0.1', port=0, background=True)}"

    def body(model_, **kw):
        return {"model": model_, "temperature": 0.0, "max_tokens": 32,
                "messages": chat("Summarize what an adapter changes."), **kw}

    def embed(model_):
        req = urllib.request.Request(
            base + "/v1/embeddings", data=json.dumps(
                {"model": model_, "input": list(EMBED_INPUTS)}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            return [np.asarray(d["embedding"])
                    for d in json.loads(r.read())["data"]]

    res = {}
    try:
        res["sft-a"] = post_chat(base, body("sft-a"))
        res["sft-a_stream"] = post_chat(base, body("sft-a", stream=True))
        res["base"] = post_chat(base, body(name))
        status, err = post_429(base, body("nope"))
        res["unknown"] = [status, err["error"]["message"]]
        with urllib.request.urlopen(base + "/v1/models", timeout=60) as r:
            res["models"] = [m["id"] for m in json.loads(r.read())["data"]]
        got, want = embed("sft-a"), embed(name)
    finally:
        srv.shutdown()
    if engine.error is not None:
        raise SystemExit(f"serve_lora http: engine failed: {engine.error!r}")
    err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    scale = max(float(np.abs(b).max()) for b in want)
    res["embeddings"] = {"max_abs_err": err, "max_rel_err": err / scale,
                         "tol": f"{MODEL_TOL} * max|base|, as serve_struct"}
    log("serve_lora http:", json.dumps(res))
    if not (res["sft-a"]["content"] == res["sft-a_stream"]["content"]
            and res["sft-a"]["content"] != res["base"]["content"]
            and res["unknown"][0] == 404
            and all(n in res["unknown"][1] for n in registry.names())
            and res["models"] == [name, *registry.names()]
            and err <= MODEL_TOL * scale):
        raise SystemExit(f"serve_lora http: the checks failed: {res}")
    return res


def lora_phase(model, tok, seed: int, card: str, nf4_cell: dict) -> dict:
    """serve_lora on the NF4 model (Qwen3-8B width, ``CUT_LAYERS`` deep
    since the serve_obs phase came in; every check kept): batched
    multi-LoRA over the NF4 base. Four seeded adapters: ``sft-a`` and
    ``sft-b`` (r 16, alpha 32, the repo's SFT targets; ``sft-a`` written
    by ``save_named`` and loaded by ``register(path)``), ``qv-8`` (r 8,
    q and v) and ``ladder-6`` (r 6, q and the MLP, padded to bucket 8,
    whose targets it widens). The JAX multi-LoRA bench's schedule
    (``arrivals.synthesize(seed=42, 16 requests, mean gap 20 ms, cv 2,
    prompts of 8-48 tokens, 16-48 new tokens)``), arrival ``i`` under
    ``[None, sft-a, sft-b, qv-8, ladder-6][i % 5]``, all greedy, two under
    the structured bench's schema, then a 700-token document under
    ``sft-a`` that chunk-prefills beside the decodes: paged with
    speculation off and with the prompt lookup (k = 4), contiguous with
    it off; every row base on the registry engine and on an engine
    without a registry; all-adapter traffic; hot loads that grow a bank;
    a byte-budget registry; prefix isolation; HTTP. Checks, each exiting
    non-zero: (a) every adapter twin replays its eager body byte for
    byte; (b) each row of a mixed batch against an eager batch-1 forward
    of it alone under its adapter (top 5, logit gap); (c) base rows of a
    twin equal the base kind's output; (d) every decode block and fused
    step is one dispatch (one graph run) while slots carry different
    adapters, and neither a base-only registry engine nor an engine
    without a registry captures a twin; (e) a grown bank recaptures the
    twins, and the new adapter's graph stream equals its eager stream
    and differs from base; (f) prefix isolation, LRU eviction under the
    byte budget, no leaked rows, bytes or pages; (g) B1's launches per
    route follow from the engine's forwards (the delta launches none);
    (h) HTTP adapter names, 404, ``/v1/models`` and base embeddings under
    an adapter name."""
    import gc

    import torch

    from llm_in_practise_tpu_torch.ckpt.checkpoint import save_named
    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.models.convert import lora_to_jax
    from llm_in_practise_tpu_torch.serve import arrivals, constrain

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    auto = constrain.ConstraintCompiler().get(
        response_format=struct_rf(),
        vocab=constrain.vocab_strings(tok, model.config.vocab_size),
        vocab_key=0, eos_id=tok.token_to_id(IM_END))
    schedule = arrivals.synthesize(**LORA_ARRIVALS)
    prompts, long_prompt = struct_prompts(tok, schedule)
    long_prompt = long_prompt[-LORA_LONG:]
    here = os.path.dirname(os.path.abspath(__file__))
    sft_dir = os.path.join(here, "build", "lora_phase", "sft-a")
    save_named(sft_dir, lora_to_jax(lora_tree("sft-a", seed + 1, N_LAYER)),
               "adapter", metadata={"lora_config":
                                    lora_config("sft-a").to_dict()})
    registry = lora_registry(model, sft_dir, seed)
    reg_swap = list(registry.swap_seconds)
    legs, launches, routes, reqs_by_leg = {}, 0, {}, {}

    def add(res):
        nonlocal launches
        launches += res.pop("launches")
        for r, c in res["b1_routes"].items():
            routes[r] = routes.get(r, 0) + c

    # the mixed traffic through the three registry engines
    for name, kw in (("paged_off", {}),
                     ("paged_ngram", {"speculative_k": SPEC_K}),
                     ("contiguous_off", {"kv_layout": "contiguous"})):
        engine = lora_engine(model, tok, seed, registry, **kw)
        res, reqs = lora_leg(name, engine, schedule, prompts, long_prompt,
                             LORA_PINS, auto, seed)
        add(res)
        legs[name] = res
        reqs_by_leg[name] = reqs
        if name == "paged_off":
            keep = engine       # serves the profile and the hot loads
        else:
            del engine
        gc.collect()
        torch.cuda.empty_cache()
    # (b) on the paged leg's streams
    teacher = lora_teacher(keep.model, registry,
                           prompts + [long_prompt], reqs_by_leg["paged_off"])
    # all-adapter and base-only traffic on the paged leg's engine (its
    # graphs warm), then base-only on an engine without a registry
    for name, pins in (("paged_all_adapters", LORA_PINS[1:]),
                       ("paged_base_registry", (None,))):
        res, _ = lora_leg(name, keep, schedule, prompts, long_prompt, pins,
                          auto, seed, checks=False)
        add(res)
        legs[name] = res
    engine = lora_engine(model, tok, seed)
    res, _ = lora_leg("paged_base_no_registry", engine, schedule, prompts,
                      long_prompt, (None,), auto, seed, checks=False)
    add(res)
    legs["paged_base_no_registry"] = res
    # (d) and base parity: a registry engine that serves base rows only
    # captures no twin, and its streams equal the engine without one's,
    # byte for byte (one deterministic order of batch shapes)
    base_streams = {"no_registry": lora_sync(engine, prompts[:MAX_SLOTS],
                                             (None,) * MAX_SLOTS)}
    del engine
    engine = lora_engine(model, tok, seed, registry)
    base_streams["registry"] = lora_sync(engine, prompts[:MAX_SLOTS],
                                         (None,) * MAX_SLOTS)
    twin_kinds = sorted({k[0] for k in engine.graphs.graphs
                         if k[0].startswith("l")})
    base_only = {"twin_kinds": twin_kinds,
                 "idx_buffers": len(engine.graphs.lora_idx),
                 "graph_kinds": sorted({k[0] for k in engine.graphs.graphs}),
                 "streams_equal": base_streams["registry"]
                 == base_streams["no_registry"]}
    log("serve_lora base-only registry engine:", json.dumps(base_only))
    if (twin_kinds or base_only["idx_buffers"]
            or not base_only["streams_equal"]
            or legs["paged_base_no_registry"]["dispatch_checks"][
                "adapter_runs"]):
        raise SystemExit(f"serve_lora: base rows ran an adapter twin, or a "
                         f"registry engine's base streams differ from an "
                         f"engine without a registry: {base_only}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    # the delta's cost per decode step: mixed adapters against base rows
    profile = {"mixed": lora_profile(keep, prompts[:MAX_SLOTS],
                                     LORA_REPLAY_PINS),
               "base": lora_profile(keep, prompts[:MAX_SLOTS],
                                    (None,) * MAX_SLOTS)}
    for key in ("device_ms_per_decode_step", "kernels_per_decode_step"):
        m, b = profile["mixed"][key], profile["base"][key]
        if isinstance(m, float) and isinstance(b, float):
            profile[f"delta_{key}"] = m - b
    profile["gathered_mib_per_decode_step"] = lora_gather_mib(registry,
                                                             MAX_SLOTS)
    log("serve_lora profile:", json.dumps(profile))
    hot = lora_hot(keep, registry, prompts, seed)
    bank_mib = {rb: v / 2**20 for rb, v in registry.bank_bytes().items()}
    del keep
    gc.collect()
    torch.cuda.empty_cache()
    budget = lora_budget(model, seed)
    prefix = lora_prefix(model, tok, registry, seed)
    t0 = time.monotonic()
    http = lora_http(model, tok, registry, seed)
    http["wall_s"] = time.monotonic() - t0
    # (f): no row, reference or page left
    stats = registry.stats()
    if any(stats["refcounts"].values()):
        raise SystemExit(f"serve_lora: leaked adapter refcounts: {stats}")
    # (a) covered a decode and a fused-step twin in each layout (plain or
    # masked), and a spec twin wherever the prompt lookup proposed
    checked = {key.split()[0] for leg in legs.values()
               for key in leg.get("replay_check", {})}
    want = [{"lpdecode", "lpmdecode"}, {"lpmixed", "lpmmixed"},
            {"ldecode", "lmdecode"}, {"lmixed", "lmmixed"}]
    if legs["paged_ngram"]["forwards"]["spec_verifies_run"]:
        want.append({"lpspec", "lpmspec"})
    if not all(checked & w for w in want):
        raise SystemExit(f"serve_lora: replay-checked twins "
                         f"{sorted(checked)}")
    res = {"card": card, "layers": N_LAYER, "max_slots": MAX_SLOTS,
           "cache_len": CACHE_LEN, "k": SPEC_K, **LORA,
           "arrivals": {**LORA_ARRIVALS, **arrivals.describe(schedule)},
           "adapters": {n: {"r": v[0], "alpha": v[1], "targets": v[2],
                            "bucket": registry._adapters[n].rb,
                            "n_bytes": registry._adapters[n].n_bytes}
                        for n, v in LORA_ADAPTERS.items()},
           "swap_seconds": reg_swap, "bank_mib": bank_mib,
           "twins_checked": sorted(checked), "teacher": teacher,
           "base_only_registry_engine": base_only,
           "profile": profile, "hot": hot, "budget": budget,
           "prefix": prefix, "http": http, "registry": stats,
           "tpot_p50_s": {n: legs[n]["tpot_p50_s"] for n in legs},
           "ttft_p50_s": {n: legs[n]["ttft_p50_s"] for n in legs},
           "nf4_cell_tpot_p50_s": nf4_cell["tpot_p50_s"],
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2**30,
           "phase_wall_s": time.monotonic() - t_phase}
    log("serve_lora:", json.dumps({k: v for k, v in res.items()
                                   if k not in ("http", "budget")},
                                  default=str))
    return {"lora": res, "legs": legs, "launches": launches,
            "routes": routes}


# serve_disagg: the KV tiers and the disaggregated prefill/decode handoff
# (the JAX CLI's --role, --kv-remote and --kv-offload; llm-d's
# prefill/decode split and LMCache's tiers) on the NF4 model
DISAGG = dict(decode_steps=8, chunked_prefill=256, kv_layout="paged",
              kv_page_size=16)
DISAGG_DOCS = 700            # prompt tokens of the two documents
DISAGG_L1_TOKENS = 96        # the --kv-offload leg's L1 budget: two chats


def disagg_traffic(tok) -> tuple[list, list]:
    """The NF4 cell's 8 chats and two ~700-token documents, as chat
    messages and as the prompt ids the HTTP server gives them."""
    msgs = [chat(f"Explain {topic} in a few sentences.") for topic in TOPICS]
    msgs += [long_messages(tok, DISAGG_DOCS, 613 * i) for i in (1, 2)]
    return msgs, [prompt_ids(tok, m) for m in msgs]


class DisaggTimer:
    """Host seconds of the handoff's pieces, recorded by wrappers around
    the port's functions for the phase (publisher threads record too):
    publish = the copy to the host, ``encode`` and the ``hput`` round
    trip; claim = the ``hclaim`` round trip, ``decode``, the copy to the
    card and the scatter into pages (each synchronised)."""

    def __init__(self, sync):
        from llm_in_practise_tpu_torch.serve import kv_pool
        from llm_in_practise_tpu_torch.serve.paged_kv import PagedKV

        self.sync = sync
        self.lock = threading.Lock()
        self.rows = {k: [] for k in ("to_host", "encode", "hput", "hclaim",
                                     "decode", "to_card", "scatter",
                                     "offload")}
        self.entry_bytes = []
        self.local = threading.local()
        self.undo = []
        self.n_claim = 0

        def patch(owner, name, make):
            orig = getattr(owner, name)
            setattr(owner, name, make(orig))
            self.undo.append((owner, name, orig))

        def timed(key, pre_sync=False):
            def make(orig):
                def fn(*a, **kw):
                    if pre_sync:
                        sync()
                    t0 = time.perf_counter()
                    out = orig(*a, **kw)
                    if pre_sync:
                        sync()
                    dt = time.perf_counter() - t0
                    self.note(key, dt)
                    setattr(self.local, key, dt)
                    return out
                return fn
            return make

        def encode(orig):
            def fn(host):
                t0 = time.perf_counter()
                blob = orig(host)
                dt = time.perf_counter() - t0
                self.note("encode", dt)
                self.local.encode = dt
                with self.lock:
                    self.entry_bytes.append(len(blob))
                return blob
            return fn

        def net(total_key, inner_key):
            def make(orig):
                def fn(*a, **kw):
                    setattr(self.local, inner_key, 0.0)
                    t0 = time.perf_counter()
                    out = orig(*a, **kw)
                    self.note(total_key, time.perf_counter() - t0
                              - getattr(self.local, inner_key))
                    return out
                return fn
            return make

        patch(kv_pool, "entry_to_host", timed("to_host"))
        patch(kv_pool, "encode_entry", encode)
        patch(kv_pool, "decode_entry", timed("decode"))
        patch(kv_pool, "rows_to_device", timed("to_card", pre_sync=True))
        patch(kv_pool.RemoteKVClient, "handoff_put", net("hput", "encode"))
        patch(kv_pool.RemoteKVClient, "handoff_claim",
              net("hclaim", "decode"))
        patch(kv_pool.TieredKV, "offload", timed("offload", pre_sync=True))
        patch(PagedKV, "scatter_rows", timed("scatter", pre_sync=True))

    def note(self, key, dt):
        with self.lock:
            self.rows[key].append(dt)

    def mark(self) -> dict:
        with self.lock:
            return {k: len(v) for k, v in self.rows.items()}

    def since(self, mark: dict) -> dict:
        """Sums and counts of every piece since ``mark``."""
        with self.lock:
            return {k: {"n": len(v) - mark[k],
                        "sum_s": sum(v[mark[k]:]),
                        "mean_s": (sum(v[mark[k]:]) / (len(v) - mark[k])
                                   if len(v) > mark[k] else None)}
                    for k, v in self.rows.items()}

    def close(self):
        for owner, name, orig in reversed(self.undo):
            setattr(owner, name, orig)


def disagg_counts(engine) -> dict:
    return {k: getattr(engine, k) for k in (
        "prefill_batches_run", "chunk_batches_run", "chunk_slots_run",
        "mixed_blocks", "local_prefills", "kv_admitted", "kv_rejected",
        "spec_rounds", "decode_steps_run")}


def counts_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def disagg_engine(model, tok, seed: int, **kw):
    import torch

    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.serve.engine import InferenceEngine

    kw = {**DISAGG, "cache_dtype": torch.bfloat16, **kw}
    return InferenceEngine(model, max_slots=MAX_SLOTS, cache_len=CACHE_LEN,
                           eos_id=tok.token_to_id(IM_END), seed=seed, **kw)


def drain(engine) -> None:
    while engine.step():
        pass
    if engine.error is not None:
        raise SystemExit(f"serve_disagg: engine failed: {engine.error!r}")


def prefill_handoff(pre, prompts) -> list[str]:
    """Every prompt through the prefill replica at once; each id, once its
    publish has landed (the request finishes only then)."""
    from llm_in_practise_tpu_torch.serve.disagg import new_handoff_id
    from llm_in_practise_tpu_torch.serve.engine import SamplingParams

    hids = [new_handoff_id() for _ in prompts]
    reqs = [pre.submit(p, SamplingParams(greedy=True, max_tokens=1),
                       handoff_id=h) for p, h in zip(prompts, hids)]
    drain(pre)
    for r in reqs:
        if r.result() != [] or r.finish_reason != "handoff":
            raise SystemExit(f"serve_disagg: a prefill replica request "
                             f"finished {r.finish_reason!r}")
    return hids


def decode_claimed(dec, store, prompts, hids) -> tuple[list, list]:
    """Claim each id and serve its prompt from the entry on the decode
    replica, all at once; the requests and the entries' widths."""
    from llm_in_practise_tpu_torch.serve.engine import SamplingParams

    sp = SamplingParams(greedy=True, max_tokens=MAX_TOKENS)
    hosts = [store.claim(h) for h in hids]
    if any(h is None for h in hosts):
        raise SystemExit("serve_disagg: a published handoff entry was lost")
    widths = [h.bucket for h in hosts]
    reqs = [dec.submit(p, sp, kv_entry=h) for p, h in zip(prompts, hosts)]
    del hosts
    drain(dec)
    return reqs, widths


def disagg_leg(name, pre, dec, store, both, prompts, *, sequential: bool,
               routes_by_role=None) -> dict:
    """One handoff leg. ``sequential``: each prompt alone through the
    prefill replica, the claim and the decode replica, beside ``both``
    serving it alone (the shapes match, so the streams must be equal);
    else every prompt at once (the streams are checked against a
    teacher-forced forward by the caller). ``routes_by_role``: B1's
    launches per route are booked to the replica that ran them."""
    from llm_in_practise_tpu_torch.serve.engine import SamplingParams

    def routes():
        return dict(read_routes()["nf4_matmul"])

    def book(role, before):
        if routes_by_role is not None:
            now = routes()
            for r, n in now.items():
                routes_by_role[role][r] += n - before[r]

    c0 = disagg_counts(dec)
    t0 = time.monotonic()
    groups = [[p] for p in prompts] if sequential else [prompts]
    streams, ttft, tpot, widths, golden, gttft, gtpot = ([] for _ in range(7))
    for group in groups:
        r0 = routes()
        hids = prefill_handoff(pre, group)
        book("prefill", r0)
        r0 = routes()
        reqs, w = decode_claimed(dec, store, group, hids)
        book("decode", r0)
        widths += w
        streams += [list(r.output_ids) for r in reqs]
        ttft += [r.ttft_s for r in reqs]
        tpot += [r.tpot_s for r in reqs]
        if both is not None:
            r0 = routes()
            sp = SamplingParams(greedy=True, max_tokens=MAX_TOKENS)
            g = [both.submit(p, sp) for p in group]
            drain(both)
            book("both", r0)
            golden += [list(r.output_ids) for r in g]
            gttft += [r.ttft_s for r in g]
            gtpot += [r.tpot_s for r in g]
    delta = counts_delta(disagg_counts(dec), c0)
    out = {"requests": len(prompts), "sequential": sequential,
           "entry_widths": widths, "decode_counts": delta,
           "streams": streams, "tokens": [len(s) for s in streams],
           "ttft_s": ttft, "tpot_s": tpot,
           "wall_s": time.monotonic() - t0}
    if both is not None:
        out.update(golden=golden, both_ttft_s=gttft, both_tpot_s=gtpot,
                   equal_to_both=[a == b for a, b in zip(streams, golden)])
    # a handed-off leg's decode replica never prefills
    out["interference_free"] = (
        delta["prefill_batches_run"] == delta["chunk_batches_run"]
        == delta["chunk_slots_run"] == delta["mixed_blocks"]
        == delta["local_prefills"] == 0
        and delta["kv_admitted"] == len(prompts))
    log(f"serve_disagg {name}:", json.dumps(
        {k: v for k, v in out.items() if k not in ("streams", "golden")}))
    return out


def pool_stats(address) -> dict:
    from llm_in_practise_tpu_torch.serve.kv_pool import RemoteKVClient

    return RemoteKVClient(address, timeout=30.0).stats()


def start_pool_server(metrics_port: int = 0) -> tuple:
    """``python -m llm_in_practise_tpu_torch.serve.kv_pool --port 0
    --metrics-port N`` (0: no scrape plane): the process and the address
    it printed first."""
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "llm_in_practise_tpu_torch.serve.kv_pool",
         "--port", "0", "--metrics-port", str(metrics_port)],
        stdout=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    line = proc.stdout.readline()
    if " on " not in line:
        proc.kill()
        raise SystemExit(f"serve_disagg: the pool server printed {line!r}")
    host, port = line.split(" on ")[1].split(" ")[0].rsplit(":", 1)
    return proc, (host, int(port))


def l3_get_reading(address, model) -> dict:
    """A remote ``get`` of the largest entry ``cache_len`` admits at the
    model's width and Qwen3-8B's full depth (``cache_len - 2`` rows of
    every layer's K and V in bf16, and the f32 last logits), through the
    pool server: host seconds, and ms per MiB; then the same through
    ``TieredKV.lookup`` with its default deadline."""
    import torch

    from llm_in_practise_tpu_torch.serve.kv_pool import (
        HostEntry,
        HostKVPool,
        RemoteKVClient,
        TieredKV,
        encode_entry,
    )

    cfg = model.config
    n = CACHE_LEN - 2
    row = torch.zeros((1, n, cfg.n_kv_head, cfg.head_dim),
                      dtype=torch.bfloat16)
    host = HostEntry(length=n, bucket=n,
                     rows=[{"k": row, "v": row} for _ in range(N_LAYER_FULL)],
                     last_logits=torch.zeros((1, cfg.vocab_size)))
    prompt = list(range(n))
    client = RemoteKVClient(address, namespace="disagg-l3-reading",
                            timeout=120.0)
    t0 = time.perf_counter()
    blob = encode_entry(host)
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    client.put(prompt, host)
    put_s = time.perf_counter() - t0
    del host, row
    gets = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = client.get(prompt, timeout=120.0)
        gets.append(time.perf_counter() - t0)
        if got is None or got.length != n:
            raise SystemExit("serve_disagg: the L3 reading's entry is gone")
        del got
    tiers = TieredKV(HostKVPool(), client)
    t0 = time.perf_counter()
    hit = tiers.lookup(prompt)
    lookup_s = time.perf_counter() - t0
    mib = len(blob) / 2**20
    return {"rows": n, "layers": N_LAYER_FULL, "mib": mib,
            "encode_s": encode_s, "put_s": put_s, "get_s": gets,
            "get_ms_per_mib": 1e3 * min(gets) / mib,
            "lookup_s": lookup_s, "lookup_hit": hit is not None,
            "lookup_timeout_s": tiers.lookup_timeout_s,
            "slow_trips": tiers.slow_trips}


def post_json(url: str, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def disagg_http(pre, dec, store, tok, golden, msgs) -> dict:
    """Two OpenAIServers over the leg-1 replicas: ``POST
    /internal/handoff/prefill`` to the prefill server, then a chat with
    ``kv_transfer_params`` to the decode server, not streamed and
    streamed (one at a time: the text must be the golden stream's), and
    the decode server's 501."""
    from llm_in_practise_tpu_torch.serve.api import OpenAIServer

    srv = {"prefill": OpenAIServer(pre, tok, model_name="qwen3-8b-nf4",
                                   role="prefill"),
           "decode": OpenAIServer(dec, tok, model_name="qwen3-8b-nf4",
                                  role="decode", handoff=store)}
    base = {k: f"http://127.0.0.1:{s.serve(host='127.0.0.1', port=0, background=True)}"
            for k, s in srv.items()}
    out = {"texts_equal": [], "prompt_tokens": []}
    try:
        c0 = disagg_counts(dec)
        for i, stream in ((0, False), (1, True)):
            body = {"model": "qwen3-8b-nf4", "temperature": 0.0,
                    "max_tokens": MAX_TOKENS, "messages": msgs[i]}
            status, got = post_json(base["prefill"]
                                    + "/internal/handoff/prefill", body)
            if status != 200:
                raise SystemExit(f"serve_disagg: prefill answered {status}: "
                                 f"{got}")
            out["prompt_tokens"].append(got["prompt_tokens"])
            res = post_chat(base["decode"], dict(
                body, stream=stream,
                kv_transfer_params={"handoff_id": got["handoff_id"]}))
            out["texts_equal"].append(
                res["content"] == tok.decode(golden[i]))
        out["decode_counts"] = counts_delta(disagg_counts(dec), c0)
        status, _ = post_json(base["decode"] + "/internal/handoff/prefill",
                              {"model": "qwen3-8b-nf4", "messages": msgs[0]})
        out["decode_prefill_status"] = status
        out["claimed"] = srv["decode"].handoff_meter.claimed
    finally:
        for s in srv.values():
            s.shutdown()
    return out


def disagg_phase(model, shallow, tok, seed: int, card: str,
                 nf4_cell: dict) -> dict:
    """serve_disagg: the KV tiers and the disaggregated handoff. A pool
    server started as ``python -m llm_in_practise_tpu_torch.serve.kv_pool
    --port 0``; a ``role="prefill"`` and a ``role="decode"`` engine (ngram
    k = 4, the decode default) with ``RemoteHandoff`` stores, and a
    ``role="both"`` engine of the decode replica's knobs for the golden
    streams; paged (pages of 16), 8 slots, cache_len 1024, chunked
    prefill 256, decode blocks of 8. Traffic: the NF4 cell's 8 chats and
    two ~700-token documents. Legs: (1) paged -> paged on the full-depth
    model, each prompt alone, then all at once; (2) paged -> contiguous
    and contiguous -> paged, (6) the tiers: a contiguous engine with
    ``--kv-offload`` and an L1 of ``DISAGG_L1_TOKENS`` whose evictions
    re-hit from L2, and two paged engines sharing the pool server by
    write-through, the second's first request an L3 hit, on the
    ``CUT_LAYERS`` model; (3) fp8 -> fp8 on a 2-layer int8 model; (4) a
    lost handoff; (5) HTTP. Checks, each exiting non-zero: where one
    request runs alone on engines of the same shapes the streams equal
    the ``both`` engine's byte for byte, elsewhere every token is in the
    top 5 of a teacher-forced forward; in every handed-off leg the decode
    replica runs no prefill batch, chunk or mixed block, counts no local
    prefill and admits every request from its entry; the lost leg counts
    one local prefill; the pool's ``handoff_pending`` returns to 0; B1
    launches on the wgmma route only on the prefill replica and only
    thin on the decode replica."""
    import gc

    import torch

    from llm_in_practise_tpu_torch.serve.disagg import RemoteHandoff
    from llm_in_practise_tpu_torch.serve.engine import SamplingParams
    from llm_in_practise_tpu_torch.serve.kv_pool import (
        HostKVPool,
        RemoteKVClient,
        TieredKV,
    )
    from llm_in_practise_tpu_torch.serve.prefix_cache import PrefixCache

    t_phase = time.monotonic()
    dev = model.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def free():
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    msgs, prompts = disagg_traffic(tok)
    proc, address = start_pool_server()
    timer = DisaggTimer(sync)
    checks, res = {}, {"card": card, "layers": N_LAYER_FULL,
                       "cut_layers": CUT_LAYERS, "max_slots": MAX_SLOTS,
                       "cache_len": CACHE_LEN, **DISAGG,
                       "prompt_tokens": [len(p) for p in prompts]}
    routes_by_role = {r: dict.fromkeys(("thin", "wgmma"), 0)
                      for r in ("prefill", "decode", "both")}
    try:
        store = RemoteHandoff(address, namespace="qwen3-8b-nf4",
                              timeout=60.0)

        def trio(m, layout_pre="paged", layout_dec="paged", **kw):
            pre = disagg_engine(m, tok, seed, role="prefill", handoff=store,
                                kv_layout=layout_pre, **kw)
            dec = disagg_engine(m, tok, seed, role="decode",
                                kv_layout=layout_dec, speculative_k=4, **kw)
            both = disagg_engine(m, tok, seed, kv_layout=layout_dec,
                                 speculative_k=4, **kw)
            return pre, dec, both

        # leg 1: paged -> paged, full depth. A warm-up of chat 0 through
        # all three (the counted run starts after its graph captures)
        pre, dec, both = trio(model)
        disagg_leg("warm-up", pre, dec, store, both, prompts[:1],
                   sequential=True)
        sync()
        zero_counters()
        mark = timer.mark()
        eb0 = len(timer.entry_bytes)
        seq = disagg_leg("leg1 sequential", pre, dec, store, both, prompts,
                         sequential=True, routes_by_role=routes_by_role)
        pieces = timer.since(mark)
        conc = disagg_leg("leg1 concurrent", pre, dec, store, None, prompts,
                          sequential=False, routes_by_role=routes_by_role)
        conc["top5_agreeing"] = teacher_forced(model, prompts,
                                               conc["streams"])
        checks["leg1_sequential_equal_both"] = all(seq["equal_to_both"])
        checks["leg1_interference_free"] = (seq["interference_free"]
                                            and conc["interference_free"])
        checks["leg1_concurrent_top5"] = (conc["top5_agreeing"]
                                          == conc["tokens"])
        res["leg1"] = {"sequential": {k: v for k, v in seq.items()
                                      if k not in ("streams", "golden")},
                       "concurrent": {k: v for k, v in conc.items()
                                      if k != "streams"},
                       "pieces": pieces}
        # leg 4: a lost handoff: an id claimed twice
        hid = prefill_handoff(pre, prompts[:1])[0]
        first = store.claim(hid)
        second = store.claim(hid)
        c0 = disagg_counts(dec)
        sp = SamplingParams(greedy=True, max_tokens=MAX_TOKENS)
        lost = dec.submit(prompts[0], sp, kv_entry=second)
        drain(dec)
        lost_delta = counts_delta(disagg_counts(dec), c0)
        checks["leg4_lost_counted"] = (
            first is not None and second is None
            and lost_delta["local_prefills"] == 1
            and lost_delta["kv_admitted"] == 0
            and len(lost.output_ids) > 0)
        res["leg4_lost"] = {"decode_counts": lost_delta,
                            "tokens": len(lost.output_ids),
                            "equal_to_both": list(lost.output_ids)
                            == seq["golden"][0]}
        del first
        # leg 5: HTTP over the leg-1 replicas
        http = disagg_http(pre, dec, store, tok, seq["golden"], msgs)
        checks["leg5_http"] = (all(http["texts_equal"])
                               and http["decode_prefill_status"] == 501
                               and http["decode_counts"]["kv_admitted"] == 2
                               and http["decode_counts"]["local_prefills"]
                               == 0 and http["claimed"] == 2)
        res["leg5_http"] = http
        log("serve_disagg leg5 http:", json.dumps(http))
        del pre, dec, both
        free()
        launches_full = read_counters()["nf4_matmul"]

        # leg 2: across layouts, CUT_LAYERS deep
        leg2 = {}
        for src, dst in (("paged", "contiguous"), ("contiguous", "paged")):
            pre, dec, both = trio(shallow, src, dst)
            r = disagg_leg(f"leg2 {src}->{dst}", pre, dec, store, both,
                           prompts[:MAX_SLOTS], sequential=True)
            docs = disagg_leg(f"leg2 {src}->{dst} documents", pre, dec,
                              store, None, prompts[MAX_SLOTS:],
                              sequential=False)
            docs["top5_agreeing"] = teacher_forced(
                shallow, prompts[MAX_SLOTS:], docs["streams"])
            leg2[f"{src}->{dst}"] = {
                "equal_to_both": r["equal_to_both"],
                "interference_free": r["interference_free"]
                and docs["interference_free"],
                "docs_top5": docs["top5_agreeing"] == docs["tokens"],
                "entry_widths": r["entry_widths"] + docs["entry_widths"],
                "ttft_s": r["ttft_s"], "both_ttft_s": r["both_ttft_s"]}
            del pre, dec, both
            free()
        checks["leg2"] = all(all(v["equal_to_both"]) and v["interference_free"]
                             and v["docs_top5"] for v in leg2.values())
        res["leg2"] = leg2

        # leg 6: the tiers, CUT_LAYERS deep. (a) --kv-offload with a small
        # L1: the second pass of the chats re-hits from L2
        from llm_in_practise_tpu_torch.serve.__main__ import (
            build_parser,
            engine_kw_for,
        )

        args = build_parser().parse_args(["--tokenizer_path", "-",
                                          "--kv-offload"])
        kw = engine_kw_for(args, "qwen3-8b-nf4")
        offl = disagg_engine(shallow, tok, seed, kv_layout="contiguous",
                             prefix_cache=PrefixCache(
                                 max_tokens=DISAGG_L1_TOKENS, min_prefix=16),
                             **kw)
        passes = []
        mark = timer.mark()
        for _ in range(2):
            out = []
            for p in prompts[:MAX_SLOTS]:
                r = offl.submit(p, sp)
                drain(offl)
                out.append(list(r.output_ids))
            passes.append(out)
        tiers = offl.kv_pool
        offload = timer.since(mark)["offload"]
        tiers_a = {"l1_budget_tokens": DISAGG_L1_TOKENS,
                   "l2_hits": tiers.host_pool.hits,
                   "l2_entries": tiers.host_pool.n_entries,
                   "l1_hits": offl.prefix_cache.hits,
                   "second_pass_equal": passes[0] == passes[1],
                   "offload_per_prefill_s": offload["mean_s"],
                   "offloads": offload["n"]}
        # the write-through's cost to the chats' TPOT: the documents
        # arrive while the chats decode, on the tiered engine and on one
        # without tiers; each engine runs the schedule twice, cold caches
        # each time, and the second run (its graphs captured) is read
        tpot = {}
        for name, eng in (("write_through", offl),
                          ("no_tiers", disagg_engine(
                              shallow, tok, seed, kv_layout="contiguous"))):
            for _ in range(2):
                if eng.prefix_cache is not None:
                    eng.prefix_cache.clear()
                tiers.host_pool.clear()
                mark = timer.mark()
                reqs = [eng.submit(p, sp) for p in prompts[:MAX_SLOTS]]
                eng.step()
                eng.step()
                reqs += [eng.submit(p, sp) for p in prompts[MAX_SLOTS:]]
                drain(eng)
            tpot[name] = {
                "chat_tpot_p50_s": statistics.median(
                    r.tpot_s for r in reqs[:MAX_SLOTS]
                    if r.tpot_s is not None),
                "offload_s": timer.since(mark)["offload"]["sum_s"]}
        tiers_a["tpot_with_documents"] = tpot
        del offl, tiers, eng
        free()
        checks["leg6_l2_rehit"] = (tiers_a["l2_hits"] >= 1
                                   and tiers_a["second_pass_equal"])
        # (b) two paged engines sharing the pool server by write-through
        l3 = {}
        for name in ("first", "second"):
            kv = TieredKV(HostKVPool(), RemoteKVClient(
                address, namespace="qwen3-8b-nf4-cut"))
            eng = disagg_engine(shallow, tok, seed, kv_pool=kv)
            s0 = pool_stats(address)
            r = eng.submit(prompts[MAX_SLOTS], sp)
            drain(eng)
            kv.flush()
            s1 = pool_stats(address)
            l3[name] = {"ttft_s": r.ttft_s, "tokens": list(r.output_ids),
                        "server_hits": s1["hits"] - s0["hits"],
                        "l2_misses": kv.host_pool.misses,
                        "prefill_forwards": eng.chunk_batches_run
                        + eng.prefill_batches_run + eng.chunk_slots_run}
            del eng, kv
            free()
        checks["leg6_l3_hit"] = (
            l3["second"]["server_hits"] == 1
            and l3["second"]["prefill_forwards"] == 0
            and l3["second"]["tokens"] == l3["first"]["tokens"])
        res["leg6_tiers"] = {
            "offload_l1": tiers_a,
            "l3": {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                   for k, v in l3.items()},
            "l3_get": l3_get_reading(address, model)}
        log("serve_disagg leg6 tiers:", json.dumps(res["leg6_tiers"]))
        launches_cut = read_counters()["nf4_matmul"] - launches_full

        # leg 3: fp8 -> fp8 on a 2-layer int8 model
        _, int8_model = build_model("int8", PAGED_INT8_LAYERS, seed)
        i8 = read_counters()["int8_matmul"]
        pre, dec, both = trio(int8_model, cache_dtype=torch.float8_e4m3fn)
        fp8 = disagg_leg("leg3 fp8", pre, dec, store, both,
                         prompts[:MAX_SLOTS], sequential=True)
        int8_launches = read_counters()["int8_matmul"] - i8
        checks["leg3_fp8"] = (all(fp8["equal_to_both"])
                              and fp8["interference_free"]
                              and int8_launches > 0)
        res["leg3_fp8"] = {"equal_to_both": fp8["equal_to_both"],
                           "int8_launches": int8_launches,
                           "entry_widths": fp8["entry_widths"]}
        del pre, dec, both, int8_model
        free()
        stats = pool_stats(address)
        checks["pool_handoff_pending_0"] = stats["handoff_pending"] == 0
        res["pool_stats"] = stats
    finally:
        timer.close()
        proc.terminate()
        proc.wait(timeout=30)
    counts = read_counters()
    # B1: prefill-sized (wgmma) launches only on the prefill replica,
    # thin launches only on the decode replica
    checks["b1_routes_by_role"] = (
        routes_by_role["prefill"]["wgmma"] > 0
        and routes_by_role["decode"]["wgmma"] == 0
        and routes_by_role["decode"]["thin"] > 0)
    res["b1_routes_by_role"] = routes_by_role
    # the readings the issue asks for, each with its origin in this run
    seq_pieces = res["leg1"]["pieces"]
    n_req = len(prompts)
    res["readings"] = {
        "entry_bytes": timer.entry_bytes[eb0:eb0 + n_req],
        "publish_s_per_entry": {k: seq_pieces[k]["mean_s"]
                                for k in ("to_host", "encode", "hput")},
        "claim_s_per_entry": {k: seq_pieces[k]["mean_s"]
                              for k in ("hclaim", "decode", "to_card",
                                        "scatter")},
        "decode_ttft_after_claim_s": seq["ttft_s"],
        "both_ttft_s": seq["both_ttft_s"],
        "decode_tpot_s": seq["tpot_s"], "both_tpot_s": seq["both_tpot_s"],
        "write_through_s_per_prefill":
            res["leg6_tiers"]["offload_l1"]["offload_per_prefill_s"],
        "l3_get_ms_per_mib": res["leg6_tiers"]["l3_get"]["get_ms_per_mib"]}
    res.update(checks=checks, launches_full_depth=launches_full,
               launches_cut_depth=launches_cut,
               nf4_cell_tpot_p50_s=nf4_cell["tpot_p50_s"],
               max_memory_allocated_gib=(
                   torch.cuda.max_memory_allocated() / 2**30),
               phase_wall_s=time.monotonic() - t_phase)
    log("serve_disagg readings:", json.dumps(res["readings"]))
    log("serve_disagg:", json.dumps({k: v for k, v in res.items()
                                     if k in ("checks", "b1_routes_by_role",
                                              "phase_wall_s",
                                              "max_memory_allocated_gib")}))
    if not all(checks.values()):
        raise SystemExit(f"serve_disagg: checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return {"disagg": res, "launches": counts["nf4_matmul"],
            "routes": read_routes()["nf4_matmul"],
            "int8_launches": int8_launches}


SESS = dict(decode_steps=8, kv_layout="paged", kv_page_size=16,
            prefix_cache=True)
SESS_ARRIVALS = dict(seed=7, n_sessions=8, turns=(3, 3),
                     prompt_tokens=(24, 64), max_tokens=(16, 32))
SESS_POOL = 2048             # page-pool tokens of leg 1: every pin and a filler
SESS_FILLERS = 4             # unrelated requests between two turn rounds ...
SESS_FILLER_TOKENS = 600     # ... of this many prompt tokens: 4 x 604 > 2048
SESS_YIELD_POOL = 512        # leg 2: too small for every pin and 3 slots
SESS_YIELD_PROMPT = 150      # leg 2's prompt tokens
SESS_FLEET_TOKENS = 32       # new tokens of a fleet leg's chat
SESS_PAGE_TOKENS = 256       # the chat page's max_tokens, as its script posts


def sess_words() -> list[str]:
    survey = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "SURVEY.md")
    with open(survey, encoding="utf-8") as f:
        return f.read().split()


def sess_text_ids(tok, words, start: int, n: int) -> list[int]:
    """``n`` token ids of SURVEY.md's words from word ``start`` (taken
    modulo the corpus)."""
    start %= len(words)
    ids = tok.encode(" ".join((words * 3)[start:start + 4 * n]))
    if len(ids) < n:
        raise SystemExit(f"serve_sessions: {len(ids)} ids, wanted {n}")
    return ids[:n]


def sess_schedule(tok) -> tuple[list, dict, list]:
    """The 8 three-turn sessions of ``synthesize_sessions`` (each turn's
    new suffix as SURVEY.md token ids of its drawn length), in turn
    rounds (every first turn, then every second, ...), and the fillers of
    the gaps between rounds (``SESS_FILLERS`` each, distinct)."""
    from llm_in_practise_tpu_torch.serve.arrivals import synthesize_sessions

    words = sess_words()
    sched = synthesize_sessions(**SESS_ARRIVALS)
    suffix = {(a.session_id, a.turn): sess_text_ids(
        tok, words, 211 * i, a.prompt_tokens) for i, a in enumerate(sched)}
    rounds = [[a for a in sched if a.turn == t]
              for t in range(SESS_ARRIVALS["turns"][1])]
    fillers = [[sess_text_ids(tok, words, 5000 + 1777 * (g * SESS_FILLERS + i),
                              SESS_FILLER_TOKENS)
                for i in range(SESS_FILLERS)]
               for g in range(len(rounds) - 1)]
    return rounds, suffix, fillers


class SessRecorder:
    """Per request (by uid) the admission's hit length, and per session
    the pages each finish pinned; the prefill tokens each engine ran
    (suffixes, one-shot batches and scatters of pulled entries)."""

    def __init__(self, engine):
        self.hit_len, self.pinned, self.prefill_tokens = {}, {}, 0
        self.scatters = 0
        begin, suffix = engine._paged_begin_prefill, engine._paged_suffix
        batch, insert = engine._prefill_batch, engine._paged_insert_entry

        def begin_w(req, slot, plen, hit):
            self.hit_len.setdefault(req.uid, 0 if hit is None else hit.length)
            return begin(req, slot, plen, hit)

        def suffix_w(slot, toks, done, req):
            self.prefill_tokens += len(toks)
            return suffix(slot, toks, done, req)

        def batch_w(b):
            self.prefill_tokens += sum(plen for _, _, plen in b)
            return batch(b)

        def insert_w(slot, entry, length):
            self.scatters += 1
            return insert(slot, entry, length)

        engine._paged_begin_prefill = begin_w
        engine._paged_suffix = suffix_w
        engine._prefill_batch = batch_w
        engine._paged_insert_entry = insert_w
        store = engine.session_store
        if store is not None:
            finish = store.note_finish

            def finish_w(sid, token_ids, pages, **kw):
                self.pinned[sid] = list(pages)
                return finish(sid, token_ids, pages, **kw)

            store.note_finish = finish_w


def sess_engine(model, tok, seed: int, **kw):
    import torch

    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.serve.engine import InferenceEngine

    kw = {**SESS, "cache_dtype": torch.bfloat16, **kw}
    return InferenceEngine(model, max_slots=MAX_SLOTS, cache_len=CACHE_LEN,
                           eos_id=tok.token_to_id(IM_END), seed=seed, **kw)


def sess_drive(engine, rec, rounds, suffix, fillers, with_sid: bool) -> list:
    """The schedule through ``engine``, one request at a time: each
    session's turn is its history (the last prompt and its stream) and
    its new suffix; the fillers run between two rounds. Returns one row
    per turn."""
    from llm_in_practise_tpu_torch.serve.engine import SamplingParams

    hist, rows = {}, []
    for t, rnd in enumerate(rounds):
        for a in rnd:
            prompt = hist.get(a.session_id, []) + suffix[(a.session_id,
                                                          a.turn)]
            pinned_before = len(rec.pinned.get(a.session_id, []))
            sp = SamplingParams(greedy=True, max_tokens=a.max_tokens)
            r = engine.submit(prompt, sp,
                              session_id=a.session_id if with_sid else None)
            drain(engine)
            out = list(r.output_ids)
            rows.append({"sid": a.session_id, "turn": t, "prompt": prompt,
                         "stream": out, "outcome": r.cache_outcome,
                         "hit_len": rec.hit_len.get(r.uid, 0),
                         "ttft_s": r.ttft_s,
                         "history_pages": (len(hist[a.session_id]) - 1)
                         // engine.paged.page_size
                         if a.session_id in hist else 0,
                         "pinned_before": pinned_before})
            hist[a.session_id] = prompt + out
        if t < len(fillers):
            sp = SamplingParams(greedy=True, max_tokens=4)
            for f in fillers[t]:
                engine.submit(f, sp)
                drain(engine)
    if engine.error is not None:
        raise SystemExit(f"serve_sessions: engine failed: {engine.error!r}")
    return rows


def sess_reset(engine) -> None:
    """Drop every pin and index entry: the pool back to empty."""
    store = engine.session_store
    if store is not None:
        for sid in list(store._sessions):
            store.drop(sid)
    engine.prefix_cache.clear()
    engine.paged.pool.check_leaks(0)


def parse_metrics(text: str) -> dict:
    """A strict reading of a Prometheus text exposition: every sample
    belongs to a ``# TYPE``-declared family (a histogram's ``_bucket`` /
    ``_count`` / ``_sum`` to its own), labels parse with their escapes,
    values are floats. ``{(sample name, frozenset(labels)): value}``."""
    import re

    kinds, out = {}, {}
    sample = re.compile(r'([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
    label = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"(,|$)')
    for line in text.split("\n"):
        if not line or line.startswith("# HELP"):
            continue
        if line.startswith("# TYPE"):
            _, _, name, kind = line.split(" ")
            kinds[name] = kind
            continue
        m = sample.match(line)
        if m is None:
            raise SystemExit(f"serve_sessions: bad exposition line {line!r}")
        name, raw = m.group(1), m.group(3) or ""
        fam = name
        for suf in ("_bucket", "_count", "_sum"):
            if name.endswith(suf) and kinds.get(name[:-len(suf)]) \
                    == "histogram":
                fam = name[:-len(suf)]
        if fam not in kinds:
            raise SystemExit(f"serve_sessions: sample {name} of no family")
        labels, pos = {}, 0
        while pos < len(raw):
            lm = label.match(raw, pos)
            if lm is None:
                raise SystemExit(f"serve_sessions: bad labels {raw!r}")
            labels[lm.group(1)] = (lm.group(2).replace('\\"', '"')
                                   .replace("\\n", "\n")
                                   .replace("\\\\", "\\"))
            pos = lm.end()
        out[(name, frozenset(labels.items()))] = float(m.group(4))
    return out


def get_url(url: str) -> tuple[int, str, str]:
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read().decode()


def post_session(base: str, body: dict, sid: str | None) -> dict:
    """A chat with the conversation handle in ``X-Session-ID``."""
    headers = {"Content-Type": "application/json"}
    if sid is not None:
        headers["X-Session-ID"] = sid
    req = urllib.request.Request(base + "/v1/chat/completions",
                                 data=json.dumps(body).encode(),
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise SystemExit(f"serve_sessions: HTTP {r.status}")
        return json.loads(r.read())


def sess_pins_leg(model, tok, seed: int, rounds, suffix, fillers) -> dict:
    """Leg 1, pins under pressure: the schedule on an engine without a
    store (the control: the fillers must cost it the conversations), then
    twice on one engine with a store (the second run after every pin and
    index entry is dropped: the same shapes, so the same bytes)."""
    ctl = sess_engine(model, tok, seed, kv_pool_tokens=SESS_POOL)
    crec = SessRecorder(ctl)
    control = sess_drive(ctl, crec, rounds, suffix, fillers, with_sid=False)
    ctl.stop()
    del ctl
    from llm_in_practise_tpu_torch.serve.sessions import SessionStore

    store = SessionStore()
    eng = sess_engine(model, tok, seed, kv_pool_tokens=SESS_POOL,
                      session_store=store)
    rec = SessRecorder(eng)
    runs, counters = [], []
    for _ in range(2):
        rec.pinned.clear()
        runs.append(sess_drive(eng, rec, rounds, suffix, fillers,
                               with_sid=True))
        counters.append(store.counters())
        sess_reset(eng)
    warm = [r for r in runs[0] if r["turn"] > 0]
    cold = [r for r in control if r["turn"] > 0]
    # (a) every later turn admits from at least its pinned history
    pinned_ok = all(r["outcome"] in ("hit", "partial")
                    and r["hit_len"] >= r["pinned_before"]
                    * eng.paged.page_size > 0 for r in warm)
    # the control lost the conversations to the fillers
    pressure_real = all(r["outcome"] == "cold"
                        or 2 * r["hit_len"] <= r["history_pages"]
                        * eng.paged.page_size for r in cold)
    # (b) byte-equal to the second run; top 5 of a cold recompute
    equal = [a["stream"] == b["stream"] for a, b in zip(*runs)]
    top5 = teacher_forced(model, [r["prompt"] for r in warm],
                          [r["stream"] for r in warm])
    tokens = [len(r["stream"]) for r in warm]

    def by_turn(rows, key):
        return {t: statistics.median(r[key] for r in rows if r["turn"] == t)
                for t in sorted({r["turn"] for r in rows})}

    out = {"checks": {"a_pinned_history_hit": pinned_ok,
                      "control_pressure_real": pressure_real,
                      "b_equal_second_run": all(equal),
                      "b_top5": top5 == tokens},
           "outcomes_warm": [r["outcome"] for r in runs[0]],
           "outcomes_control": [r["outcome"] for r in control],
           "hit_len_warm": [r["hit_len"] for r in warm],
           "pinned_pages_before": [r["pinned_before"] for r in warm],
           "hit_len_control": [r["hit_len"] for r in cold],
           "ttft_warm_run2_s_by_turn": by_turn(runs[1], "ttft_s"),
           "ttft_control_s_by_turn": by_turn(control, "ttft_s"),
           "ttft_warm_run2_s": [r["ttft_s"] for r in runs[1]],
           "ttft_control_s": [r["ttft_s"] for r in control],
           "prompt_tokens": [len(r["prompt"]) for r in runs[0]],
           "store_counters_by_run": counters,
           "pool_alloc_failures": eng.paged.pool.snapshot()["alloc_failures"],
           "turns": len(runs[0]), "top5_agreeing": sum(top5),
           "tokens": sum(tokens)}
    eng.stop()
    return out


def sess_yield_leg(model, tok, seed: int) -> dict:
    """Leg 2, pins yield: ``SESS_YIELD_POOL`` tokens of pool, 6 sessions
    in two waves of 3 concurrent requests (the second wave's slots need
    the first wave's pins)."""
    from llm_in_practise_tpu_torch.obs.hbm import get_ledger
    from llm_in_practise_tpu_torch.serve.engine import SamplingParams
    from llm_in_practise_tpu_torch.serve.sessions import SessionStore

    led = get_ledger()
    base = led.account_bytes("session_pins")
    store = SessionStore()
    eng = sess_engine(model, tok, seed, kv_pool_tokens=SESS_YIELD_POOL,
                      session_store=store)
    rec = SessRecorder(eng)
    pool = eng.paged.pool
    failures, slot_pages_ok = [], []
    alloc, reclaim = pool.try_alloc, pool.reclaim

    def try_alloc(n):
        got = alloc(n)
        if got is None:
            failures.append(store.pinned_pages)
        return got

    def reclaim_w(n):
        freed = reclaim(n)
        # no live slot lost a page: every mapped page still referenced
        slot_pages_ok.append(all(
            pool.refcount(p) >= 1 for s in range(eng.max_slots)
            for p in eng.paged.slot_pages(s)))
        return freed

    pool.try_alloc, pool.reclaim = try_alloc, reclaim_w
    words = sess_words()
    prompts = [sess_text_ids(tok, words, 9000 + 313 * i, SESS_YIELD_PROMPT)
               for i in range(6)]
    sp = SamplingParams(greedy=True, max_tokens=16)
    streams = []
    for wave in (prompts[:3], prompts[3:]):
        reqs = [eng.submit(p, sp, session_id=f"yield-{len(streams) + j}")
                for j, p in enumerate(wave)]
        drain(eng)
        streams += [list(r.output_ids) for r in reqs]
    top5 = teacher_forced(model, prompts, streams)
    chain_prefix = all(s.pages == rec.pinned[sid][:len(s.pages)]
                       for sid, s in store._sessions.items())
    pinned_bytes = led.account_bytes("session_pins") - base
    booked = pinned_bytes == store.pinned_pages * eng.paged.page_bytes
    ev = dict(store.counters()["evictions"])
    store.ttl_s = 1e-3
    time.sleep(0.01)
    store.sweep()
    out = {"checks": {
        "pressure_evictions": ev["pressure"] > 0,
        "admission_never_blocked_on_pins": all(f == 0 for f in failures),
        "no_slot_lost_a_page": all(slot_pages_ok) and top5 == [
            len(s) for s in streams],
        "surviving_pins_chain_prefixes": chain_prefix,
        "session_pins_booked": booked,
        "ttl_sweep_to_zero": (store.pinned_pages == 0
                              and led.account_bytes("session_pins")
                              == base)},
        "evictions": ev, "alloc_failures_pins": failures,
        "reclaims": len(slot_pages_ok), "preemptions": eng.preemptions,
        "pool_tokens": SESS_YIELD_POOL, "top5_agreeing": sum(top5),
        "tokens": sum(len(s) for s in streams)}
    eng.prefix_cache.clear()
    pool.check_leaks(0)
    eng.stop()
    return out


def sess_fleet_leg(model, tok, seed: int, card: str) -> dict:
    """Leg 3 and 4: replicas A and B behind their own OpenAIServers over
    loopback, sharing a pool server started as ``python -m
    llm_in_practise_tpu_torch.serve.kv_pool --port 0 --metrics-port N``;
    the migration, a lost entry, a mismatched entry, then the planes
    (``/metrics``, ``/debug/sessions``, ``/debug/hbm``, the pool's
    ``/metrics``, the chat page)."""
    import gc
    import socket

    import torch

    from llm_in_practise_tpu_torch.obs.cost import tree_bytes
    from llm_in_practise_tpu_torch.obs.hbm import get_ledger
    from llm_in_practise_tpu_torch.serve.api import OpenAIServer
    from llm_in_practise_tpu_torch.serve.disagg import RemoteHandoff
    from llm_in_practise_tpu_torch.serve.engine import SamplingParams
    from llm_in_practise_tpu_torch.serve.sessions import (
        SessionStore,
        session_hid,
    )

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        mport = s.getsockname()[1]
    proc, address = start_pool_server(mport)
    name = "qwen3-8b-nf4"
    led = get_ledger()
    checks, res = {}, {}
    servers = {}
    timer = DisaggTimer(torch.cuda.synchronize)
    try:
        base = led.baseline()
        reps = {}
        for r in ("A", "B"):
            store = SessionStore()
            eng = sess_engine(model, tok, seed, session_store=store,
                              handoff=RemoteHandoff(
                                  address, namespace=name, timeout=60.0))
            handles = []
            submit = eng.submit

            def submit_w(*a, _submit=submit, _h=handles, **kw):
                h = _submit(*a, **kw)
                _h.append(h)
                return h

            eng.submit = submit_w
            srv = OpenAIServer(eng, tok, model_name=name)
            port = srv.serve(host="127.0.0.1", port=0, background=True)
            servers[r] = srv
            reps[r] = {"engine": eng, "store": store, "handles": handles,
                       "rec": SessRecorder(eng),
                       "base": f"http://127.0.0.1:{port}",
                       "routes": dict.fromkeys(("thin", "wgmma"), 0)}

        def chat_to(r, messages, sid, max_tokens=SESS_FLEET_TOKENS):
            rep = reps[r]
            r0 = dict(read_routes()["nf4_matmul"])
            p0, n0 = rep["rec"].prefill_tokens, len(rep["handles"])
            got = post_session(rep["base"], {
                "model": name, "temperature": 0.0, "max_tokens": max_tokens,
                "messages": messages}, sid)
            for k, v in read_routes()["nf4_matmul"].items():
                rep["routes"][k] += v - r0[k]
            h = rep["handles"][n0]
            return {"text": got["choices"][0]["message"]["content"],
                    "prompt": list(h.prompt_ids),
                    "stream": list(h.output_ids), "ttft_s": h.ttft_s,
                    "outcome": h.cache_outcome,
                    "prefill_tokens": rep["rec"].prefill_tokens - p0}

        def pulls(r):
            return dict(reps[r]["store"].counters()["pulls"])

        # (3) the migration: turn 1 on A, its publish, turn 2 on B
        sid = "fleet-1"
        msgs = chat("Explain session pinning in a few sentences.")
        t1 = chat_to("A", msgs, sid)
        flushed = reps["A"]["store"].flush(60.0)
        msgs2 = msgs + [{"role": "assistant", "content": t1["text"]},
                        {"role": "user",
                         "content": "And how does a replica take it over?"}]
        pb0 = pulls("B")
        t2b = chat_to("B", msgs2, sid)
        pb1 = pulls("B")
        # what B pulled: A's published history (its full pages); the
        # prefix B's prompt shares with it
        hist = list(reps["A"]["store"].lookup(sid).token_ids)
        P = reps["B"]["engine"].paged.page_size
        nfull = len(hist) // P * P
        lcp = 0
        while (lcp < min(nfull, len(t2b["prompt"]) - 1)
               and t2b["prompt"][lcp] == hist[lcp]):
            lcp += 1
        t2a = chat_to("A", msgs2, sid)       # A's own turn 2, from its pin
        top5 = teacher_forced(model, [t2b["prompt"]], [t2b["stream"]])[0]
        checks["migration_claimed_on_B"] = (pb1["claimed"] - pb0["claimed"]
                                            == 1)
        checks["migration_published_on_A"] = (
            flushed and pulls("A")["published"] >= 1)
        checks["no_publish_failed"] = (pulls("A")["publish_failed"]
                                       == pulls("B")["publish_failed"] == 0)
        checks["B_prefilled_only_the_suffix"] = (
            t2b["outcome"] == "partial" and lcp > 0
            and t2b["prefill_tokens"] == len(t2b["prompt"]) - lcp)
        checks["B_top5"] = top5 == len(t2b["stream"]) > 0
        res["migration"] = {
            "turn1_prompt_tokens": len(t1["prompt"]),
            "published_tokens": nfull, "shared_prefix": lcp,
            "turn2_prompt_tokens": len(t2b["prompt"]),
            "B_prefill_tokens": t2b["prefill_tokens"],
            "B_outcome": t2b["outcome"], "A_turn2_outcome": t2a["outcome"],
            "B_ttft_s": t2b["ttft_s"], "A_turn2_ttft_s": t2a["ttft_s"],
            "A_turn1_ttft_s": t1["ttft_s"],
            "B_equal_A_turn2": t2b["stream"] == t2a["stream"],
            "first_divergence_vs_A": first_divergence([t2b["stream"]],
                                                      [t2a["stream"]])[0],
            "B_top5_agreeing": top5, "tokens": len(t2b["stream"])}
        # the same migration at the token level (the engines' own submit,
        # the API's pull): the whole published history is the turn-2
        # prompt's prefix, so B prefills only the new turn. The publish and
        # claim pieces are timed by the handoff's wrappers
        sid2 = "fleet-tokens"
        words = sess_words()
        p1 = sess_text_ids(tok, words, 7000, 48)
        new = sess_text_ids(tok, words, 7400, 40)
        sp = SamplingParams(greedy=True, max_tokens=SESS_FLEET_TOKENS)
        eng_a, eng_b = reps["A"]["engine"], reps["B"]["engine"]
        if not all(rep["store"].flush(60.0) for rep in reps.values()):
            raise SystemExit("serve_sessions: a publisher did not drain")
        r0 = dict(read_routes()["nf4_matmul"])
        mark = timer.mark()
        eb0 = len(timer.entry_bytes)
        r1 = eng_a.submit(p1, sp, session_id=sid2)
        out1 = r1.result()
        if not reps["A"]["store"].flush(60.0):
            raise SystemExit("serve_sessions: A's publisher did not drain")
        publish = timer.since(mark)
        entry_bytes = timer.entry_bytes[eb0:]
        n_pub = len(reps["A"]["store"].lookup(sid2).token_ids) // P * P
        for k, v in read_routes()["nf4_matmul"].items():
            reps["A"]["routes"][k] += v - r0[k]
        p2 = p1 + out1 + new
        r0 = dict(read_routes()["nf4_matmul"])
        mark, pf0 = timer.mark(), reps["B"]["rec"].prefill_tokens
        t0 = time.perf_counter()
        servers["B"]._session_pull(eng_b, sid2)
        pull_s = time.perf_counter() - t0
        r2 = eng_b.submit(p2, sp, session_id=sid2)
        out2 = r2.result()
        claim = timer.since(mark)
        for k, v in read_routes()["nf4_matmul"].items():
            reps["B"]["routes"][k] += v - r0[k]
        tok_prefill = reps["B"]["rec"].prefill_tokens - pf0
        top5_t = teacher_forced(model, [p2], [out2])[0]
        checks["token_migration_prefills_only_the_new_turn"] = (
            r2.cache_outcome == "partial" and n_pub >= len(p1) // P * P > 0
            and tok_prefill == len(p2) - n_pub and top5_t == len(out2) > 0)
        res["token_migration"] = {
            "turn1_prompt_tokens": len(p1), "published_tokens": n_pub,
            "entry_bytes": entry_bytes,
            "turn2_prompt_tokens": len(p2), "B_prefill_tokens": tok_prefill,
            "B_ttft_s": r2.ttft_s, "A_turn1_ttft_s": r1.ttft_s,
            "pull_s": pull_s, "B_top5_agreeing": top5_t,
            "tokens": len(out2),
            "publish_s": {k: publish[k]["sum_s"]
                          for k in ("to_host", "encode", "hput")},
            "claim_s": {k: claim[k]["sum_s"]
                        for k in ("hclaim", "decode", "to_card", "scatter")}}
        # a lost entry: a session never published
        pb0 = pulls("B")
        lost = chat_to("B", chat("A session nobody published."), "fleet-lost")
        pb1 = pulls("B")
        checks["lost_counted_local_prefill"] = (
            pb1["lost"] - pb0["lost"] == 1 and pb1["claimed"] == pb0["claimed"]
            and lost["prefill_tokens"] > 0 and len(lost["stream"]) > 0)
        # a mismatched entry: A's latest publish, its tokens shifted so no
        # prefix matches, pinned under another session's key
        if not reps["A"]["store"].flush(60.0):
            raise SystemExit("serve_sessions: A's publisher did not drain")
        hs = RemoteHandoff(address, namespace=name, timeout=60.0)
        entry = hs.claim(session_hid(sid))
        if entry is None:
            raise SystemExit("serve_sessions: A's second publish is gone")
        entry.token_ids = [t + 1 for t in entry.token_ids]
        hs.publish(session_hid("fleet-mismatch"), entry)
        del entry
        pb0, sc0 = pulls("B"), reps["B"]["rec"].scatters
        mis = chat_to("B", msgs2, "fleet-mismatch")
        pb1 = pulls("B")
        checks["mismatch_discarded_never_scattered"] = (
            pb1["claimed"] - pb0["claimed"] == 1
            and pb1["lost"] - pb0["lost"] == 1
            and reps["B"]["rec"].scatters == sc0
            and len(mis["stream"]) > 0)
        res["lost"] = {"prefill_tokens": lost["prefill_tokens"],
                       "outcome": lost["outcome"]}
        res["mismatch"] = {"prefill_tokens": mis["prefill_tokens"],
                           "outcome": mis["outcome"]}
        res["pulls"] = {r: pulls(r) for r in reps}

        # (4) the planes: /metrics against /debug/sessions and /debug/hbm
        # (the ledger is the process's: every publish has landed first)
        if not all(rep["store"].flush(60.0) for rep in reps.values()):
            raise SystemExit("serve_sessions: a publisher did not drain")
        planes = {}
        for r, rep in reps.items():
            _, ctype, text = get_url(rep["base"] + "/metrics")
            samples = parse_metrics(text)
            dbg = json.loads(get_url(rep["base"] + "/debug/sessions")[2])
            hbm = json.loads(get_url(rep["base"] + "/debug/hbm")[2])
            text2 = get_url(rep["base"] + "/metrics")[2]
            samples2 = parse_metrics(text2)

            def val(s, n, **lb):
                return s.get((n, frozenset(lb.items())))

            sess_ok = (val(samples, "llm_sessions_active") == dbg["active"]
                       and val(samples, "llm_session_pinned_pages")
                       == dbg["pinned_pages"]
                       and all(val(samples, "llm_session_turns_total",
                                   cache=k) == v
                               for k, v in dbg["turns"].items())
                       and all(val(samples, "llm_session_evictions_total",
                                   reason=k) == v
                               for k, v in dbg["evictions"].items())
                       and all(val(samples, "llm_session_pulls_total",
                                   event=k) == v
                               for k, v in dbg["pulls"].items()))
            accounts = {a: v["bytes"] for g in hbm["tree"].values()
                        for a, v in g["accounts"].items()}
            hbm_ok = all(val(samples2, "llm_hbm_ledger_bytes", owner=a) == b
                         for a, b in accounts.items())
            planes[r] = {"metrics_content_type": ctype,
                         "families": len({k[0] for k in samples}),
                         "session_families_equal_debug": sess_ok,
                         "ledger_families_equal_debug_hbm": hbm_ok}
            checks[f"metrics_{r}"] = sess_ok and hbm_ok and \
                ctype.startswith("text/plain")
        # the pool's scrape plane
        _, _, ptext = get_url(f"http://127.0.0.1:{mport}/metrics")
        pool = parse_metrics(ptext)
        pinned = pool.get(("kvpool_handoff_total",
                           frozenset({("event", "pinned")})))
        checks["pool_metrics"] = (
            pinned is not None and pinned >= 2
            and ("kvpool_handoff_wire_seconds_count",
                 frozenset({("op", "hput")})) in pool)
        planes["pool"] = {"families": len({k[0] for k in pool}),
                          "handoff_pinned": pinned}
        # the chat page, and the JSON its script posts
        page = {}
        for path in ("/", "/chat"):
            status, ctype, body = get_url(reps["A"]["base"] + path)
            page[path] = (status == 200 and ctype.startswith("text/html")
                          and name in body and "/v1/chat/completions" in body)
        r0 = dict(read_routes()["nf4_matmul"])
        sse = post_chat(reps["A"]["base"], {
            "model": name, "messages": [{"role": "user", "content": "hi"}],
            "stream": True, "max_tokens": SESS_PAGE_TOKENS})
        for k, v in read_routes()["nf4_matmul"].items():
            reps["A"]["routes"][k] += v - r0[k]
        checks["chat_page"] = all(page.values()) and sse.get("done") is True
        planes["chat_page"] = {"paths": page,
                               "sse_finish_reason": sse["finish_reason"],
                               "sse_wall_s": sse["wall_s"]}
        # B1 on both replicas, thin (every prompt under WGMMA_MIN_M rows)
        checks["b1_thin_on_both_replicas"] = all(
            rep["routes"]["thin"] > 0 and rep["routes"]["wgmma"] == 0
            for rep in reps.values())
        res["b1_routes_by_replica"] = {r: rep["routes"]
                                       for r, rep in reps.items()}
        # /debug/hbm with A alone (B stopped and collected)
        servers.pop("B").shutdown()
        del reps["B"], eng_b, r2     # a request holds its engine
        gc.collect()
        torch.cuda.empty_cache()
        hbm = json.loads(get_url(reps["A"]["base"] + "/debug/hbm")[2])
        moved = led.leaked_since(base)
        pins = reps["A"]["store"].pinned_pages
        checks["debug_hbm_books"] = (
            moved.get("kv_pool.pages") == eng_a.paged.pool_bytes
            and moved.get("weights/model") == tree_bytes(model)
            and moved.get("session_pins", 0) == pins * eng_a.paged.page_bytes
            and pins > 0)
        torch.cuda.synchronize()
        planes["debug_hbm_A"] = {
            "moved_since_phase_start": moved,
            "pool_bytes": eng_a.paged.pool_bytes,
            "tree_bytes_model": tree_bytes(model),
            "pinned_pages": pins, "page_bytes": eng_a.paged.page_bytes,
            "reconciliation": hbm["reconciliation"],
            "memory_allocated": torch.cuda.memory_allocated(),
            "unattributed_bytes": led.unattributed_bytes(),
            "transient_view": hbm["tree"]["transient_view"]["accounts"][
                "transient_view"],
            "reclaims": hbm["reclaims"]}
        servers.pop("A").shutdown()
        checks["leaked_since_baseline_empty"] = led.leaked_since(base) == {}
        res["planes"] = planes
    finally:
        timer.close()
        for srv in servers.values():
            srv.shutdown()
        proc.terminate()
        proc.wait(timeout=30)
    return {"checks": checks, **res}


def sessions_phase(model, tok, seed: int, card: str, nf4_cell: dict) -> dict:
    """serve_sessions: session-native serving, the chat page and the
    planes, on the full-depth NF4 model (paged, pages of 16, prefix
    caching, decode blocks of 8, bf16 KV). Legs: (1) pins under pressure,
    8 sessions of 3 turns from ``serve/arrivals.py::synthesize_sessions``
    one request at a time, ``SESS_FILLERS`` unrelated requests of
    ``SESS_FILLER_TOKENS`` between two rounds in a ``SESS_POOL``-token
    pool: an engine without a store must lose the conversations (its
    later turns cold or under half their history), the store's must
    admit every later turn from at least its pinned pages, with streams
    byte-equal to a second run of the same engine and every token in the
    top 5 of a teacher-forced cold recompute; (2) pins yield in a
    ``SESS_YIELD_POOL``-token pool: pressure evictions, no allocation
    failure while a pin remains, no slot loses a page, survivors are
    chain prefixes, a TTL sweep brings ``session_pins`` to 0; (3) fleet
    migration between two replicas over HTTP and a pool server: B claims
    ``session_hid(sid)`` and prefills only what its prompt does not share
    with the published history, a never-published session is a counted
    local prefill, a mismatched entry is discarded unscattered; (4) the
    planes: ``/metrics`` parses and equals ``/debug/sessions`` and
    ``/debug/hbm``, the ledger books the pool, the weights and the pins,
    and returns to its phase-start baseline, the pool's ``/metrics``, the
    chat page and its SSE; B1 thin on both replicas. Every failed check
    exits non-zero."""
    import torch

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    rounds, suffix, fillers = sess_schedule(tok)
    res = {"card": card, "layers": N_LAYER_FULL, "max_slots": MAX_SLOTS,
           "cache_len": CACHE_LEN, **SESS, "pool_tokens": SESS_POOL,
           "fillers": SESS_FILLERS, "filler_tokens": SESS_FILLER_TOKENS}
    t0 = time.monotonic()
    res["pins"] = sess_pins_leg(model, tok, seed, rounds, suffix, fillers)
    res["pins"]["wall_s"] = time.monotonic() - t0
    log("serve_sessions pins:", json.dumps(res["pins"]))
    t0 = time.monotonic()
    res["yield"] = sess_yield_leg(model, tok, seed)
    res["yield"]["wall_s"] = time.monotonic() - t0
    log("serve_sessions yield:", json.dumps(res["yield"]))
    t0 = time.monotonic()
    res["fleet"] = sess_fleet_leg(model, tok, seed, card)
    res["fleet"]["wall_s"] = time.monotonic() - t0
    log("serve_sessions fleet:", json.dumps(res["fleet"], default=str))
    checks = {f"pins_{k}": v for k, v in res["pins"]["checks"].items()}
    checks.update({f"yield_{k}": v for k, v in res["yield"]["checks"].items()})
    checks.update({f"fleet_{k}": v for k, v in res["fleet"]["checks"].items()})
    counts = read_counters()
    res.update(checks=checks, nf4_cell_tpot_p50_s=nf4_cell["tpot_p50_s"],
               max_memory_allocated_gib=(
                   torch.cuda.max_memory_allocated() / 2**30),
               phase_wall_s=time.monotonic() - t_phase)
    log("serve_sessions:", json.dumps({k: v for k, v in res.items()
                                       if k in ("checks", "phase_wall_s",
                                                "max_memory_allocated_gib")}))
    if not all(checks.values()):
        raise SystemExit(f"serve_sessions: checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return {"sessions": res, "launches": counts["nf4_matmul"],
            "routes": read_routes()["nf4_matmul"]}


# serve_obs: the tracer and the device plane (obs/trace.py,
# obs/steptrace.py, obs/cost.py, obs/meter.py, obs/prof.py) on a server
# that serve.build_server builds with the CLI's defaults (paged, pages of
# 16, decode steps of 1, no chunking) over the full-depth NF4 model
OBS_SLO = (2.0, 0.1)     # --ttft-slo / --tpot-slo: the reference's SLAs
OBS_DOC_TOKENS = 700     # the document's prompt: a one-shot wgmma prefill
OBS_PROFILE_S = 1.0      # POST /debug/profile's duration
OBS_PROFILE_TOKENS = 256  # the streams that run under the capture
OBS_ONOFF_ROUNDS = 3     # rounds with the planes on, and off, alternating
OBS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "obs_phase")
# a decode step's device time must not read above the card's bandwidth
# by more than rounding: a gauge above this is a fault of the cost model
# or of the timing, not the card
OBS_GAUGE_MAX = 1.05
OBS_ONOFF_MAX = 1.05     # TPOT p50 with the planes on over off


def obs_chat(base: str, body: dict, headers: dict | None = None) -> dict:
    """One chat over HTTP; for a stream, the client clock's TTFT (to the
    first event carrying content) beside its total."""
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise SystemExit(f"serve_obs: HTTP {r.status}")
        if not body.get("stream"):
            out = json.loads(r.read())
            return {"content": out["choices"][0]["message"]["content"],
                    "finish_reason": out["choices"][0]["finish_reason"],
                    "wall_s": time.monotonic() - t0}
        ttft, text, finish, done = None, [], None, False
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            data = line[len("data: "):]
            if data == "[DONE]":
                done = True
                break
            ev = json.loads(data)
            if "error" in ev:
                raise SystemExit(f"serve_obs: stream error {ev}")
            delta = ev["choices"][0]["delta"].get("content")
            if delta:
                if ttft is None:
                    ttft = time.monotonic() - t0
                text.append(delta)
            finish = ev["choices"][0].get("finish_reason") or finish
    return {"content": "".join(text), "finish_reason": finish, "done": done,
            "ttft_s": ttft, "wall_s": time.monotonic() - t0}


def delta_quantile(before, after, q: float) -> float | None:
    """The bucket-interpolated ``q`` quantile (``HistogramAccumulator``'s
    rule) of the observations between two snapshots of a histogram."""
    bounds, cum1, n1, _ = after
    _, cum0, n0, _ = before
    count = n1 - n0
    if count <= 0:
        return None
    rank = q * count
    prev_bound, prev_cum = 0.0, 0
    for bound, c1, c0 in zip(bounds, cum1, cum0):
        c = c1 - c0
        if c >= rank:
            if bound == float("inf"):
                return prev_bound
            span = c - prev_cum
            frac = (rank - prev_cum) / span if span else 1.0
            return prev_bound + frac * (bound - prev_bound)
        prev_bound, prev_cum = bound, c
    return bounds[-2]


def obs_kernels(path: str) -> dict:
    """The kernel events of a gzipped Chrome trace, and those of B1's
    thin-M (``Nf4Thin``) and wgmma (``Nf4Fwd``) kernels."""
    import gzip

    with gzip.open(path, "rt") as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {"events": len(events), "kernels": len(kernels),
            "b1_thin": sum("Nf4Thin" in e.get("name", "") for e in kernels),
            "b1_wgmma": sum("Nf4Fwd" in e.get("name", "") for e in kernels)}


def settle(engine) -> None:
    """Return once the engine thread's step in flight (the one that
    finished the last request) has closed its record: a step holds the
    engine's lock to its end."""
    with engine._lock:
        pass


def obs_round(engine, gate, prompts, max_tokens: int) -> tuple[list, list]:
    """``prompts`` submitted while admission is parked (so the engine
    thread admits them in one step), then released; their requests when
    all finish, and the step records of the round."""
    from llm_in_practise_tpu_torch.serve.engine import SamplingParams

    steps0 = engine.steptrace.snapshot()["steps"]
    gate.clear()
    reqs = [engine.submit(p, SamplingParams(greedy=True,
                                            max_tokens=max_tokens))
            for p in prompts]
    gate.set()
    engine._wake.set()
    for r in reqs:
        r.result()
    settle(engine)
    n = engine.steptrace.snapshot()["steps"] - steps0
    return reqs, (engine.steptrace.records(limit=n) if n > 0 else [])


def obs_profiled_round(engine, gate, prompts, max_tokens: int) -> dict:
    """The same round twice (greedy: the same steps): alone, where the
    step records' CUDA-event time gives the device time per step and the
    busy share; then under the profiler (CUDA activity), whose kernel
    time per step and busy share sit beside the events' share in that
    profiled round (the profiler slows the steps it traces)."""
    import torch
    from torch.profiler import ProfilerActivity

    from llm_in_practise_tpu_torch.obs.meter import exclusive_profile

    _, plain = obs_round(engine, gate, prompts, max_tokens)
    with exclusive_profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, recs = obs_round(engine, gate, prompts, max_tokens)
        torch.cuda.synchronize()
    kernel_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    wall0 = sum(r["wall_s"] for r in plain)
    wall = sum(r["wall_s"] for r in recs)
    return {"steps": len(plain), "steps_profiled": len(recs),
            "event_device_ms_per_step": (
                sum(r["device_s"] for r in plain) * 1e3 / len(plain)),
            "wall_ms_per_step": wall0 * 1e3 / len(plain),
            "event_busy": sum(r["device_s"] for r in plain) / wall0,
            "profiler_kernel_ms_per_step": (
                kernel_us / 1e3 / len(recs) if kernel_us
                else "not measured"),
            "profiled_wall_ms_per_step": wall * 1e3 / len(recs),
            "profiler_busy": (kernel_us / 1e6 / wall if kernel_us
                              else "not measured"),
            "event_busy_profiled": sum(r["device_s"] for r in recs) / wall}


def decode_partition(recs) -> dict:
    """Medians of the decode steps' records (one dispatch and no index
    build: no prefill in the step): wall, device and host activities."""
    steps = [r for r in recs if r["dispatches"] == 1
             and r["activities"].get("index_build", 0.0) == 0.0]
    if not steps:
        return {"steps": 0}
    return {"steps": len(steps),
            "wall_s": statistics.median(r["wall_s"] for r in steps),
            "device_s": statistics.median(r["device_s"] for r in steps),
            **{a: statistics.median(r["activities"].get(a, 0.0)
                                    for r in steps)
               for a in ("queue_drain", "admit", "plan", "dispatch_wait",
                         "sample_commit", "other")}}


def obs_server_leg(model, tok, seed: int) -> dict:
    """Leg 1: the server of ``build_server`` with ``--trace-file``,
    ``--ttft-slo`` and ``--tpot-slo``; checks (a)-(h) of
    :func:`obs_phase`, and the readings."""
    import threading

    import torch

    from llm_in_practise_tpu_torch.obs import meter
    from llm_in_practise_tpu_torch.obs.meter import GoodputMeter
    from llm_in_practise_tpu_torch.obs.steptrace import (
        DEVICE_LANE_TID,
        HOST_LANE_TID,
        StepTrace,
    )
    from llm_in_practise_tpu_torch.obs.trace import (
        Tracer,
        format_traceparent,
        get_tracer,
        new_context,
    )
    from llm_in_practise_tpu_torch.serve.__main__ import (
        build_parser,
        build_server,
    )

    os.makedirs(OBS_DIR, exist_ok=True)
    trace_path = os.path.join(OBS_DIR, "trace.jsonl")
    if os.path.exists(trace_path):
        os.remove(trace_path)
    os.environ["LLM_TPU_PROFILE_DIR"] = os.path.join(OBS_DIR, "profiles")
    args = build_parser().parse_args([
        "--tokenizer_path", "-", "--max_slots", str(MAX_SLOTS),
        "--cache_len", str(CACHE_LEN), "--kv-cache-dtype", "bfloat16",
        "--trace-file", trace_path, "--ttft-slo", str(OBS_SLO[0]),
        "--tpot-slo", str(OBS_SLO[1])])
    server = build_server(args, model=model, tokenizer=tok)
    engine = server.engine
    seen = []
    submit = engine.submit

    def recording_submit(*a, **kw):
        seen.append(submit(*a, **kw))
        return seen[-1]

    engine.submit = recording_submit
    # admission parked while a round is submitted (never by holding the
    # engine's lock: the engine thread retakes it between steps)
    gate = threading.Event()
    gate.set()
    admit = engine._admit

    def gated_admit():
        return admit() if gate.is_set() else False

    engine._admit = gated_admit
    port = server.serve(host="127.0.0.1", port=0, background=True)
    base = f"http://127.0.0.1:{port}"
    name = args.model_name
    doc = long_messages(tok, OBS_DOC_TOKENS, 7)

    def body(messages, stream=False, max_tokens=MAX_TOKENS):
        return {"model": name, "temperature": 0.0, "max_tokens": max_tokens,
                "stream": stream, "messages": messages}

    chats = ckpt_chats()
    clients = [new_context(), new_context()]   # chats 0 and 1 carry them

    def traffic(max_tokens=MAX_TOKENS, with_doc=True):
        with concurrent.futures.ThreadPoolExecutor(MAX_SLOTS + 1) as pool:
            futs = []
            for i, m in enumerate(chats):
                hdr = ({"traceparent": format_traceparent(clients[i])}
                       if i < len(clients) else None)
                futs.append(pool.submit(obs_chat, base,
                                        body(m, i % 2 == 1, max_tokens), hdr))
            if with_doc:
                futs.append(pool.submit(obs_chat, base, body(doc)))
            return [f.result() for f in futs]

    s = engine.stats
    res, checks = {}, {}
    try:
        traffic()                                   # warm-up: the captures
        settle(engine)
        seen.clear()
        before = parse_metrics(get_url(base + "/metrics")[2])
        hist0 = {"ttft": s.ttft.snapshot(), "tpot": s.tpot.snapshot()}
        steps0 = engine.steptrace.snapshot()["steps"]
        disp0 = engine.dispatches_total
        zero_routes = read_routes()["nf4_matmul"]
        t0 = time.monotonic()
        results = traffic()
        res["round_wall_s"] = time.monotonic() - t0
        settle(engine)
        reqs = list(seen)
        n_steps = engine.steptrace.snapshot()["steps"] - steps0
        recs = engine.steptrace.records(limit=n_steps)
        traces = json.loads(get_url(base + "/debug/traces")[2])
        dreq = json.loads(get_url(base + "/debug/requests")[2])
        text = get_url(base + "/metrics")[2]
        after = parse_metrics(text)
        hist1 = {"ttft": s.ttft.snapshot(), "tpot": s.tpot.snapshot()}
        round_routes = {k: v - zero_routes[k] for k, v in
                        read_routes()["nf4_matmul"].items()}

        # (a) every request's trace: api.chat at the root (a client's
        # traceparent adopted), the engine's phase spans under it
        tracer = server.tracer
        span_ok = []
        for r in reqs:
            spans = tracer.trace(r.trace.trace_id)
            roots = [sp for sp in spans if sp["span_id"] == r.trace.span_id]
            kids = {sp["name"] for sp in spans
                    if sp["parent_id"] == r.trace.span_id}
            ok = (len(roots) == 1 and roots[0]["name"] == "api.chat"
                  and {"engine.queue_wait", "engine.admit",
                       "engine.decode"} <= kids)
            client = [c for c in clients if c.trace_id == r.trace.trace_id]
            if client:
                ok = ok and roots[0]["parent_id"] == client[0].span_id
            elif roots:
                ok = ok and roots[0]["parent_id"] is None
            if roots and roots[0]["attrs"].get("stream"):
                ok = ok and "api.stream_flush" in kids
            span_ok.append(ok)
        checks["spans_under_api_chat"] = len(reqs) == MAX_SLOTS + 1 and all(
            span_ok)
        checks["client_traceparent_adopted"] = all(
            any(t["trace_id"] == c.trace_id for t in traces["traces"])
            for c in clients)
        # (c) each request's segments sum to its wall time
        by_uid = {d["uid"]: d for d in dreq["finished"]}
        seg_err = []
        for r in reqs:
            d = by_uid[r.uid]
            total = sum(v for k, v in d["segments"].items()
                        if k != "stream_flush")
            seg_err.append(abs(total - d["wall_s"]) / d["wall_s"])
        checks["segments_sum_to_wall"] = max(seg_err) <= 0.01

        # (d) /metrics (parse_metrics is strict) against the engine
        def val(fams, name, **labels):
            return fams.get((name, frozenset(labels.items())), 0.0)

        checks["ttft_counts_requests"] = (
            val(after, "llm_ttft_seconds_count")
            - val(before, "llm_ttft_seconds_count") == len(reqs))
        checks["dispatches_equal_engine"] = (
            val(after, "llm_dispatches_total") == engine.dispatches_total
            and engine.dispatches_total - disp0
            == sum(r["dispatches"] for r in recs))
        part_err = max(abs(sum(r["activities"].values()) + r["device_s"]
                           - r["wall_s"]) for r in recs)
        checks["every_step_a_partition"] = part_err <= 1e-6 and all(
            0 <= r["device_s"] <= r["wall_s"] for r in recs)
        snap = engine.steptrace.snapshot()
        checks["coverage_ge_0_95"] = snap["coverage"] >= 0.95
        busy = val(after, "llm_device_busy_fraction")
        gap = val(after, "llm_host_gap_fraction")
        checks["busy_plus_gap_is_1"] = abs(busy + gap - 1.0) <= 1e-9
        ok_tok = val(after, "llm_goodput_tokens_total", slo="ok")
        bad_tok = val(after, "llm_goodput_tokens_total", slo="violated")
        checks["goodput_tokens_equal_generated"] = (
            ok_tok + bad_tok == val(after, "llm_tokens_generated_total")
            == s.tokens_generated_total)
        gauges = {g: {dict(k[1])["phase"]: v for k, v in after.items()
                      if k[0] == g}
                  for g in ("llm_dispatch_mfu", "llm_dispatch_hbm_bw_util",
                            "llm_dispatch_tokens_per_dispatch")}
        checks["gauges_for_both_phases"] = all(
            set(gauges[g]) == {"prefill", "decode"} for g in gauges)
        checks["no_gauge_over_1_05"] = all(
            v <= OBS_GAUGE_MAX for g in ("llm_dispatch_mfu",
                                         "llm_dispatch_hbm_bw_util")
            for v in gauges[g].values())
        res["gauges"] = gauges
        res["cost_model"] = {
            "weight_bytes": engine.cost_model.weight_bytes,
            "kv_bytes_per_token": engine.cost_model.kv_bytes_per_token,
            "peak_flops": engine.cost_model.peak_flops,
            "peak_hbm_bw": engine.cost_model.peak_hbm_bw,
            "device_kind": engine.cost_model.device_kind}
        res["round_b1_routes"] = round_routes
        streams = [r for r in results if "done" in r]
        res["latency"] = {
            "ttft_p50_s_histogram": delta_quantile(hist0["ttft"],
                                                   hist1["ttft"], 0.5),
            "ttft_p50_s_engine": statistics.median(r.ttft_s for r in reqs),
            "ttft_p50_s_client_streams": statistics.median(
                r["ttft_s"] for r in streams),
            "tpot_p50_s_histogram": delta_quantile(hist0["tpot"],
                                                   hist1["tpot"], 0.5),
            "tpot_p50_s_engine": statistics.median(
                r.tpot_s for r in reqs if r.tpot_s is not None)}
        cp = {dict(k[1])["segment"]: v - val(before, k[0], **dict(k[1]))
              for k, v in after.items()
              if k[0] == "llm_request_critical_path_seconds_total"}
        res["critical_path_round_s"] = cp
        # the counted round's decode steps (the document's 1024-wide
        # view among them) and, below, the on rounds' (the 8 chats)
        res["decode_step_partition_p50"] = {"round": decode_partition(recs)}
        res["steptrace"] = {k: snap[k] for k in (
            "steps", "coverage", "device_busy_fraction",
            "host_gap_fraction")}

        # (e) a TPOT SLO no request meets: every one violates, blamed on
        # a phase of the blame list
        blame0 = dict(s.goodput.snapshot()["blame"])
        viol0 = s.goodput.snapshot()["requests_violated"]
        s.goodput.configure(tpot_slo_s=0.001)
        traffic(with_doc=False)
        gp = s.goodput.snapshot()
        s.goodput.configure(*OBS_SLO)
        blame = {k: v - blame0.get(k, 0) for k, v in gp["blame"].items()
                 if v - blame0.get(k, 0)}
        checks["every_request_violates"] = (
            gp["requests_violated"] - viol0 == MAX_SLOTS)
        checks["blame_names_blame_spans"] = (
            sum(blame.values()) == MAX_SLOTS
            and set(blame) <= set(GoodputMeter.BLAME_SPANS))
        res["blame"] = blame
        blame_fams = parse_metrics(get_url(base + "/metrics")[2])
        checks["blame_family_renders"] = sum(
            v for k, v in blame_fams.items()
            if k[0] == "llm_slo_blame_total") == sum(gp["blame"].values())

        # (f) POST /debug/profile while 4 chats stream; a second POST
        # while it runs is a 409
        with concurrent.futures.ThreadPoolExecutor(6) as pool:
            streams_f = [pool.submit(obs_chat, base,
                                     body(m, True, OBS_PROFILE_TOKENS))
                         for m in chats[:4]]
            wait_for(lambda: s.active_slots >= 4 and engine.stats
                     .tokens_generated_total > 0, "4 streams decoding")
            t_cap = time.monotonic()
            cap = pool.submit(post_json, base + "/debug/profile",
                              {"duration_s": OBS_PROFILE_S})
            wait_for(meter._profile_lock.locked, "the capture to start")
            second = post_json(base + "/debug/profile", {"duration_s": 0.1})
            status, payload = cap.result()
            cap_s = time.monotonic() - t_cap
            for f in streams_f:
                f.result()
        kern = obs_kernels(payload["perfetto"][0]) if status == 200 else {}
        checks["profile_200_with_b1_thin"] = (
            status == 200 and kern.get("b1_thin", 0) > 0)
        checks["profile_concurrent_409"] = second[0] == 409
        res["profile"] = {"status": status, "second_status": second[0],
                          "post_seconds": cap_s,
                          "duration_s": payload.get("duration_s"),
                          "bytes": sum(os.path.getsize(f)
                                       for f in payload.get("files", [])),
                          **kern}

        # (g) the compile family is the graphs' own capture record
        cm = engine.compile_meter
        cap_total = sum(engine.graphs.capture_s.values())
        checks["compile_equals_captures"] = (
            cm.compile_events == len(engine.graphs.capture_s) > 0
            and abs(cm.compile_seconds - cap_total) <= 0.01 * cap_total)
        res["compile"] = {"events": cm.compile_events,
                          "seconds": cm.compile_seconds,
                          "graphs_capture_s": cap_total}

        # (h) the recorder and the tracer off against on, swapped on this
        # one engine (no graph is captured again): the same greedy
        # streams, and TPOT p50 within OBS_ONOFF_MAX
        prompts = [prompt_ids(tok, m) for m in chats]
        on = (engine.steptrace, engine.tracer)
        tpot = {"on": [], "off": []}
        streams, on_recs = [], []
        for i in range(2 * OBS_ONOFF_ROUNDS):
            mode = "on" if i % 2 == 0 else "off"
            with engine._lock:
                if mode == "on":
                    engine.steptrace, engine.tracer = on
                else:
                    engine.steptrace = StepTrace(enabled=False)
                    engine.tracer = Tracer(enabled=False)
            rq, rr = obs_round(engine, gate, prompts, MAX_TOKENS)
            on_recs += rr
            tpot[mode] += [r.tpot_s for r in rq if r.tpot_s is not None]
            streams.append([r.output_ids for r in rq])
        with engine._lock:
            engine.steptrace, engine.tracer = on
        res["decode_step_partition_p50"]["chats"] = decode_partition(on_recs)
        ratio = statistics.median(tpot["on"]) / statistics.median(tpot["off"])
        checks["streams_equal_on_off"] = all(st == streams[0]
                                             for st in streams)
        checks["tpot_on_off_le_1_05"] = ratio <= OBS_ONOFF_MAX
        res["on_off"] = {"tpot_p50_on_s": statistics.median(tpot["on"]),
                         "tpot_p50_off_s": statistics.median(tpot["off"]),
                         "ratio": ratio, "rounds_each": OBS_ONOFF_ROUNDS}

        # readings: the busy share by events beside the profiler's, over
        # the same steps: the 8 chats (1 prefill step, then decode), and
        # the document's one-shot eager prefill alone
        res["busy_vs_profiler"] = {
            "chats_round": obs_profiled_round(engine, gate, prompts, 32),
            "doc_prefill": obs_profiled_round(
                engine, gate, [prompt_ids(tok, doc)], 1)}
        res["gauges_end"] = {phase: snap for phase, snap in
                             engine.dispatch_meter.phase_snapshot().items()}
    finally:
        server.shutdown()
        get_tracer().set_trace_file(None)     # flushes the sink
    if engine.error is not None:
        raise SystemExit(f"serve_obs: engine failed: {engine.error!r}")

    # (b) /debug/traces parsed above; every line of the trace file parses
    # and the file holds both lanes
    lanes, n_lines, bad = {"host": 0, "device": 0}, 0, 0
    with open(trace_path, encoding="utf-8") as f:
        for line in f:
            n_lines += 1
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                bad += 1
                continue
            if ev.get("cat") == "steptrace" and ev.get("ph") == "X":
                if ev["tid"] == HOST_LANE_TID:
                    lanes["host"] += 1
                elif ev["tid"] == DEVICE_LANE_TID:
                    lanes["device"] += 1
    checks["trace_file_parses_both_lanes"] = (
        bad == 0 and n_lines > 0 and lanes["host"] > 0
        and lanes["device"] > 0)
    checks["debug_traces_parses"] = bool(traces["traces"])
    res["trace_file"] = {"lines": n_lines, "bytes":
                         os.path.getsize(trace_path), **lanes}
    res["checks"] = checks
    return res


def obs_disagg_leg(model, tok, seed: int) -> dict:
    """Leg 2: a prefill and a decode replica over the same model object
    and a pool server, each with a tracer of its own (as two processes
    would have): ``POST /internal/handoff/prefill`` with a
    ``traceparent``, then a chat on the decode server whose
    ``kv_transfer_params`` carry the handoff id and the trace. One trace
    id in both rings (``handoff.publish`` in the prefill replica's,
    ``handoff.claim`` in the decode replica's); B1's wgmma route runs on
    the prefill replica only."""
    import torch

    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.obs.trace import (
        Tracer,
        format_traceparent,
        new_context,
    )
    from llm_in_practise_tpu_torch.serve.api import OpenAIServer
    from llm_in_practise_tpu_torch.serve.disagg import RemoteHandoff
    from llm_in_practise_tpu_torch.serve.engine import InferenceEngine

    proc, address = start_pool_server(0)
    name = "qwen3-8b-nf4"
    tracers = {"prefill": Tracer(enabled=True), "decode": Tracer(enabled=True)}
    engines = {role: InferenceEngine(
        model, max_slots=MAX_SLOTS, cache_len=CACHE_LEN,
        eos_id=tok.token_to_id(IM_END), cache_dtype=torch.bfloat16,
        seed=seed, kv_layout="paged", role=role,
        handoff=RemoteHandoff(address, namespace=name),
        tracer=tracers[role]) for role in ("prefill", "decode")}
    servers = {role: OpenAIServer(engines[role], tok, model_name=name,
                                  role=role) for role in engines}
    bases = {role: "http://127.0.0.1:"
             f"{s.serve(host='127.0.0.1', port=0, background=True)}"
             for role, s in servers.items()}
    client = new_context()
    tp = format_traceparent(client)
    body = {"model": name, "temperature": 0.0, "max_tokens": MAX_TOKENS,
            "messages": long_messages(tok, OBS_DOC_TOKENS, 11)}
    out = {}
    try:
        r0 = read_routes()["nf4_matmul"]
        req = urllib.request.Request(
            bases["prefill"] + "/internal/handoff/prefill",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json", "traceparent": tp})
        with urllib.request.urlopen(req, timeout=600) as r:
            got = json.loads(r.read())
        r1 = read_routes()["nf4_matmul"]
        # the router rides the trace along in the handoff body
        chat_res = post_chat(bases["decode"], dict(
            body, kv_transfer_params={"handoff_id": got["handoff_id"],
                                      "trace": tp}))
        r2 = read_routes()["nf4_matmul"]
    finally:
        for s in servers.values():
            s.shutdown()
        proc.terminate()
        proc.wait(timeout=60)
    routes = {"prefill": {k: r1[k] - r0[k] for k in r0},
              "decode": {k: r2[k] - r1[k] for k in r0}}
    names = {role: {sp["name"] for sp in t.trace(client.trace_id)}
             for role, t in tracers.items()}
    roots = [sp for t in tracers.values() for sp in t.trace(client.trace_id)
             if sp["name"] in ("api.prefill", "api.chat")]
    dec = engines["decode"]
    checks = {
        "one_trace_across_replicas": (
            {"api.prefill", "engine.admit", "handoff.publish"}
            <= names["prefill"]
            and {"api.chat", "handoff.claim", "engine.decode"}
            <= names["decode"]
            and len(roots) == 2
            and all(sp["parent_id"] == client.span_id for sp in roots)),
        "claimed_not_prefilled": (dec.kv_admitted == 1
                                  and dec.local_prefills == 0),
        "b1_wgmma_on_prefill_only": (routes["prefill"]["wgmma"] > 0
                                     and routes["decode"]["wgmma"] == 0
                                     and routes["decode"]["thin"] > 0),
        "chat_finished": chat_res["finish_reason"] in ("stop", "length")}
    out.update(checks=checks, routes=routes,
               prompt_tokens=got["prompt_tokens"],
               spans={role: sorted(n) for role, n in names.items()})
    return out


def obs_phase(model, tok, seed: int, card: str, nf4_cell: dict) -> dict:
    """serve_obs: the tracer and the device plane on the full-depth NF4
    model. Leg 1, a server from ``serve.build_server`` with the CLI's
    defaults and ``--trace-file``, ``--ttft-slo 2.0``, ``--tpot-slo 0.1``:
    the NF4 cell's 8 chats (4 streamed, 2 with a client ``traceparent``)
    and a ~700-token document. Checks, each exiting non-zero: (a) each
    request's trace has ``api.chat`` at its root (a client's trace id
    adopted) and the engine's phase spans under it; (b) ``/debug/traces``
    and every line of the trace file parse, and the file has the host and
    the device lane; (c) ``/debug/requests``: each request's segments sum
    to its wall time within 1%; (d) ``/metrics`` parses strictly,
    ``llm_ttft_seconds`` counts the requests, ``llm_dispatches_total``
    equals the engine's count and the step records', every step record
    is a partition, coverage >= 0.95, busy + host gap = 1, goodput's ok +
    violated tokens are the tokens generated, both phases have MFU and
    bandwidth gauges and none reads above 1.05; (e) under a TPOT SLO of
    1 ms every request violates and ``llm_slo_blame_total`` names spans
    of ``GoodputMeter.BLAME_SPANS``; (f) ``POST /debug/profile`` while 4
    chats stream answers 200 with B1 thin-M kernels in its trace, and a
    second POST during it 409; (g) the compile family equals the graphs'
    captures; (h) the recorder and the tracer off against on, swapped on
    one engine, give the same greedy streams and TPOT p50 within 1.05.
    Leg 2: :func:`obs_disagg_leg`. Readings, with the card: a decode
    step's partition by activity, the busy share by events beside the
    profiler's, the MFU and bandwidth gauges per phase, TTFT / TPOT p50
    from the histograms beside the client's clock, the critical path by
    segment, compile seconds, the profile's bytes and seconds, the on /
    off TPOT ratio."""
    import torch

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    res = {"card": card, "layers": N_LAYER_FULL, "max_slots": MAX_SLOTS,
           "cache_len": CACHE_LEN, "slo": OBS_SLO}
    t0 = time.monotonic()
    res["server"] = obs_server_leg(model, tok, seed)
    res["server"]["wall_s"] = time.monotonic() - t0
    log("serve_obs server:", json.dumps(res["server"], default=str))
    t0 = time.monotonic()
    res["disagg"] = obs_disagg_leg(model, tok, seed)
    res["disagg"]["wall_s"] = time.monotonic() - t0
    log("serve_obs disagg:", json.dumps(res["disagg"], default=str))
    checks = {f"server_{k}": v for k, v in res["server"]["checks"].items()}
    checks.update({f"disagg_{k}": v
                   for k, v in res["disagg"]["checks"].items()})
    counts = read_counters()
    res.update(checks=checks, nf4_cell_tpot_p50_s=nf4_cell["tpot_p50_s"],
               max_memory_allocated_gib=(
                   torch.cuda.max_memory_allocated() / 2**30),
               phase_wall_s=time.monotonic() - t_phase)
    log("serve_obs:", json.dumps({k: v for k, v in res.items()
                                  if k in ("checks", "phase_wall_s",
                                           "max_memory_allocated_gib")}))
    if not all(checks.values()):
        raise SystemExit(f"serve_obs: checks failed: "
                         f"{[k for k, v in checks.items() if not v]}")
    return {"obs": res, "launches": counts["nf4_matmul"],
            "routes": read_routes()["nf4_matmul"]}


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
    projection shape (the forward on the route ``_route`` picks); the
    forward also at ``NF4_FWD_EDGE_SHAPES`` on both routes and on a weight
    whose arrays start off 16-byte alignment, the backward at
    ``NF4_DX_EDGE_SHAPES``; every launch repeated for the same bytes, and
    on q_proj's shape a planted fault (the first 64-column absmax block of
    absmax row 0 zeroed in a copy of the weight) that must read as a
    failure in both directions."""

    import torch

    from llm_in_practise_tpu_torch.ops import nf4_matmul as nm
    from llm_in_practise_tpu_torch.quant import nf4

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    rows = {}

    def held(kernel, key, out, fn, inp, t, ref, plant=False, **fields):
        """One launch against its plain version, with nf4_extra's repeat
        and planted fault; fails the run unless all hold."""
        torch.cuda.synchronize()
        err, rel = _rel(out, ref)
        row = {"kernel": kernel, **fields, "max_abs_err": err,
               "max_rel_err": rel, **nf4_extra(out, fn, inp, t, ref, plant)}
        row["ok"] = (bool(torch.isfinite(out).all().item())
                     and rel <= KERNEL_TOL and row["ok"])
        rows[key] = row
        if not row["ok"]:
            raise SystemExit(f"{kernel} disagrees with its plain version, "
                             f"misses the planted fault or gives other bytes "
                             f"on a second launch: {row}")
        return row

    for k, n in sorted(set(PROJ_SHAPES.values())):
        t = nf4.quantize(torch.randn(k, n, device=dev, generator=gen) * 0.02)
        w_bf16 = nf4.dequantize(t, torch.bfloat16)  # library yardstick only
        x = torch.randn(TRAIN_M, k, device=dev, generator=gen).to(
            torch.bfloat16)
        dy = torch.randn(TRAIN_M, n, device=dev, generator=gen).to(
            torch.bfloat16)
        bound_ms, bound_by, nbytes = matmul_bound(
            TRAIN_M, k, n, weight_bytes("nf4", k, n))
        for kernel, fn, plain, lib, inp in (
                ("nf4_matmul", nm.nf4_matmul, nm.nf4_matmul_reference,
                 lambda: torch.matmul(x, w_bf16), x),
                ("nf4_matmul_backward", nm.nf4_matmul_backward,
                 nm.nf4_matmul_backward_reference,
                 lambda: torch.matmul(dy, w_bf16.T), dy)):
            out = fn(inp, t, torch.bfloat16)
            ref = plain(inp, t, torch.bfloat16)
            fields = {"M": TRAIN_M, "K": k, "N": n}
            if kernel == "nf4_matmul":
                fields["route"] = nm._route(TRAIN_M, k, n)
            row = held(kernel, (kernel, k, n), out, fn, inp, t, ref,
                       (k, n) == PROJ_SHAPES["q_proj"], **fields)
            row.update({
                "tol": f"{KERNEL_TOL} * max|plain| (summation order; bf16 "
                       "output rounding)",
                "ms": time_ms(lambda: fn(inp, t, torch.bfloat16), 10, flush),
                "plain_ms": time_ms(
                    lambda: plain(inp, t, torch.bfloat16), 3, flush),
                "library_ms": time_ms(lib, 10, flush),
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            })
            log(json.dumps(row))
            del out, ref
        del t, w_bf16, x, dy
    for m, k, n in NF4_FWD_EDGE_SHAPES:
        t = nf4.quantize(torch.randn(k, n, device=dev, generator=gen) * 0.02)
        x = torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
        ref = nm.nf4_matmul_reference(x, t, torch.bfloat16)
        # the same weight with packed, absmax_q and absmax_scale at starts
        # off 16-byte alignment: the wrapper must align them
        shifted = nf4_offset_views(t) if (k, n) == (4096, 4096) else None
        for route in nm.ROUTES:
            if route == "wgmma" and not nm._wgmma_shape(k, n):
                continue

            def fn(a, w, dtype, route=route):
                return nm._forward(a, w, dtype, route=route)

            for case, w in (("kblock", t), ("offset_views", shifted)):
                if w is None:
                    continue
                row = held("nf4_matmul", ("edge", "nf4_matmul",
                                          f"{case}@{route}", m, k, n),
                           fn(x, w, torch.bfloat16), fn, x, w, ref,
                           case=f"{case}@{route}", M=m, K=k, N=n)
                log(json.dumps(row))
        del t, x, ref, shifted
    for m, k, n in NF4_DX_EDGE_SHAPES:
        t = nf4.quantize(torch.randn(k, n, device=dev, generator=gen) * 0.02)
        dy = torch.randn(m, n, device=dev, generator=gen).to(torch.bfloat16)
        row = held("nf4_matmul_backward",
                   ("edge", "nf4_matmul_backward", "kblock", m, k, n),
                   nm.nf4_matmul_backward(dy, t, torch.bfloat16),
                   nm.nf4_matmul_backward, dy, t,
                   nm.nf4_matmul_backward_reference(dy, t, torch.bfloat16),
                   case="kblock", M=m, K=k, N=n)
        log(json.dumps(row))
        del t, dy
    return rows


def nf4_offset_views(t):
    """A copy of NF4 weight ``t`` whose packed and absmax_q bytes start 1
    byte, and whose absmax_scale starts 4 bytes, past a 16-byte boundary:
    views into larger buffers, as a slice of a bigger allocation gives."""
    import dataclasses

    import torch

    def shifted(a, pad):
        buf = torch.empty(a.numel() + pad, dtype=a.dtype, device=a.device)
        view = buf[pad:].view(a.shape)
        view.copy_(a)
        assert view.data_ptr() % 16 != 0
        return view

    return dataclasses.replace(t, packed=shifted(t.packed, 1),
                               absmax_q=shifted(t.absmax_q, 1),
                               absmax_scale=shifted(t.absmax_scale, 1))


def nf4_extra(out, fn, inp, t, ref, plant: bool) -> dict:
    """B1's or B2's repeat (the same bytes from a second launch) and, if
    ``plant``, its planted fault: the first absmax block (64 rows x 64
    columns of the high half) zeroed in a copy of the weight must move the
    result by more than KERNEL_TOL * max|plain|."""
    import dataclasses

    import torch

    res = {"repeat_equal": torch.equal(out, fn(inp, t, torch.bfloat16))}
    res["ok"] = res["repeat_equal"]
    if plant:
        bad = dataclasses.replace(t, absmax_q=t.absmax_q.clone())
        bad.absmax_q[:64] = 0
        res["planted_zero_absmax_rel_err"] = _rel(
            fn(inp, bad, torch.bfloat16), ref)[1]
        res["ok"] = res["ok"] and \
            res["planted_zero_absmax_rel_err"] > KERNEL_TOL
    return res


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
    versions at ``FLASH_SHAPES``: the training shape (8 x 1024, 32/8 heads,
    head_dim 128: 8 query tiles of the forward, 16 key tiles of the
    backward), a ragged length (1000: the last tile is masked), head_dim 64
    with a GQA group of 1, and q, k, v as strided views of one fused
    (B, L, H + 2 Hkv, D) tensor (the kernels' 4-D tensor maps over the
    caller's strides; the forward's and the backward's bytes must equal
    those from contiguous copies). Every forward and backward launch
    repeats to the same bytes (each row is reduced in one block in a fixed
    order), and a zeroed last tile of dq, of dk and of dv must each read
    as a failure. Timed at the training shape, with SDPA as the library
    yardstick."""
    import torch
    import torch.nn.functional as F

    from llm_in_practise_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    checks, out = [], {}
    for b, length, n_head, n_kv, d, layout in FLASH_SHAPES:
        scale = d ** -0.5

        def rnd(h):
            return torch.randn(b, length, h, d, device=dev,
                               generator=gen).to(torch.bfloat16)

        if layout == "fused_views":
            fused = rnd(n_head + 2 * n_kv)
            q, k, v = (fused[:, :, :n_head],
                       fused[:, :, n_head:n_head + n_kv],
                       fused[:, :, n_head + n_kv:])
        else:
            q, k, v = rnd(n_head), rnd(n_kv), rnd(n_kv)
        do = rnd(n_head)
        o, lse = fa.flash_forward(q, k, v, scale)
        o_rep, lse_rep = fa.flash_forward(q, k, v, scale)
        ro, rlse = fa.flash_forward_reference(q, k, v, scale)
        q2, k2, v2, do2, lse_k, delta = fa.backward_inputs(q, k, v, o, lse,
                                                           do)
        dk, dv = fa.flash_backward_dkv(q2, k2, v2, do2, lse_k, delta, scale)
        dq = fa.flash_backward_dq(q2, k2, v2, do2, lse_k, delta, scale)
        dk_rep, dv_rep = fa.flash_backward_dkv(q2, k2, v2, do2, lse_k, delta,
                                               scale)
        dq_rep = fa.flash_backward_dq(q2, k2, v2, do2, lse_k, delta, scale)
        rq, rk, rv = fa.flash_backward_reference(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        res = {"B": b, "L": length, "H": n_head, "Hkv": n_kv, "D": d,
               "layout": layout, "tile": FLASH_TILE, "o": tile_err(o, ro),
               "lse_abs": (lse - rlse).abs().max().item(),
               "dq": tile_err(dq, rq), "dk": tile_err(dk, rk),
               "dv": tile_err(dv, rv),
               "forward_repeat_equal": bool(torch.equal(o, o_rep)
                                            and torch.equal(lse, lse_rep)),
               "backward_repeat_equal": bool(torch.equal(dq, dq_rep)
                                             and torch.equal(dk, dk_rep)
                                             and torch.equal(dv, dv_rep)),
               "tol": f"tile_rel {FLASH_TOL}: max|kernel - plain| over "
                      f"max|plain| in every {FLASH_TILE}-row tile of one "
                      f"(batch, head); LSE {LSE_TOL} absolute"}
        if layout == "fused_views":
            oc, lsec = fa.flash_forward(q.contiguous(), k.contiguous(),
                                        v.contiguous(), scale)
            res["equal_to_contiguous"] = bool(torch.equal(o, oc)
                                              and torch.equal(lse, lsec))
            # the backward from contiguous copies of q, k, v and dO, on the
            # same O and LSE
            cq, ck, cv, cdo, clse, cdelta = fa.backward_inputs(
                q.contiguous(), k.contiguous(), v.contiguous(), o, lse,
                do.contiguous())
            cdk, cdv = fa.flash_backward_dkv(cq, ck, cv, cdo, clse, cdelta,
                                             scale)
            cdq = fa.flash_backward_dq(cq, ck, cv, cdo, clse, cdelta, scale)
            res["backward_equal_to_contiguous"] = bool(
                torch.equal(dq, cdq) and torch.equal(dk, cdk)
                and torch.equal(dv, cdv))
            del oc, lsec, cq, ck, cv, cdo, clse, cdelta, cdk, cdv, cdq
        # the check must see a planted fault in each gradient: its last
        # tile of rows (the smallest values, and the ragged one at L =
        # 1000) zeroed
        for name, got, want in (("dq", dq, rq), ("dk", dk, rk),
                                ("dv", dv, rv)):
            bad = got.clone()
            bad[:, (length - 1) // FLASH_TILE * FLASH_TILE:] = 0
            res[f"planted_{name}_tile_zeroed"] = tile_err(bad, want)
            del bad
        del o_rep, lse_rep, dq_rep, dk_rep, dv_rep
        res["ok"] = (all(res[x]["tile_rel"] <= FLASH_TOL
                         for x in ("o", "dq", "dk", "dv"))
                     and res["lse_abs"] <= LSE_TOL
                     and res["forward_repeat_equal"]
                     and res["backward_repeat_equal"]
                     and res.get("equal_to_contiguous", True)
                     and res.get("backward_equal_to_contiguous", True)
                     and all(bool(torch.isfinite(t).all())
                             for t in (o, lse, dq, dk, dv)))
        log("flash check:", json.dumps(res))
        checks.append(res)
        if not res["ok"]:
            raise SystemExit(f"flash kernels disagree with their plain "
                             f"versions, or their bytes moved: {res}")
        for name in ("dq", "dk", "dv"):
            if res[f"planted_{name}_tile_zeroed"]["tile_rel"] <= FLASH_TOL:
                raise SystemExit(
                    f"the flash check does not see a zeroed {name} tile: "
                    f"{res[f'planted_{name}_tile_zeroed']}")
        del ro, rlse, rq, rk, rv
        if (b, length, layout) != (TRAIN_BATCH, TRAIN_SEQ, "contiguous"):
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
                lambda: fa.flash_backward_dkv(q2, k2, v2, do2, lse_k, delta,
                                              scale),
                lambda: fa.flash_backward_reference(q, k, v, o, lse, do,
                                                    scale),
                lambda: torch.autograd.grad(sdpa, (qt, kt, vt), do_t,
                                            retain_graph=True),
                flash_bound(b, length, n_head, d, 4,
                            2 * qb + 4 * kvb + 2 * vec)),
            "flash_backward_dq": (
                lambda: fa.flash_backward_dq(q2, k2, v2, do2, lse_k, delta,
                                             scale),
                lambda: fa.flash_backward_reference(q, k, v, o, lse, do,
                                                    scale),
                None,  # the pair's yardstick is timed with dK/dV
                flash_bound(b, length, n_head, d, 3,
                            3 * qb + 2 * kvb + 2 * vec)),
        }
        for name, (fn, plain, lib, bound) in rows.items():
            out[name] = {
                "ms": time_ms(fn, 10, flush),
                "plain_ms": time_ms(plain, 3, flush),
                "library_ms": time_ms(lib, 10, flush) if lib else None,
                "bound_ms": bound[0], "bound_by": bound[1],
                "bytes": bound[2],
                "at": f"B={b} L={length} H={n_head} Hkv={n_kv} D={d}, "
                      "causal",
            }
            log(json.dumps({"kernel": name, **out[name]}))
        # no PyTorch call computes dK/dV or dQ alone (library_ms null):
        # the pair is set against SDPA's whole backward (dq, dk, dv)
        pair = {"ms": (out["flash_backward_dkv"]["ms"]
                       + out["flash_backward_dq"]["ms"]),
                "library_ms": out["flash_backward_dkv"]["library_ms"],
                "library": "SDPA backward: dq, dk and dv together"}
        pair["ratio"] = pair["ms"] / pair["library_ms"]
        for name in ("flash_backward_dkv", "flash_backward_dq"):
            out[name]["library_ms"] = None
            out[name]["pair"] = pair
        del qt, kt, vt, sdpa
    outputs = {"flash_forward": ("o",), "flash_backward_dkv": ("dk", "dv"),
               "flash_backward_dq": ("dq",)}
    for name, keys in outputs.items():
        out[name]["checks"] = checks
        out[name]["max_abs_err"] = max(c[x]["max_abs"] for c in checks
                                       for x in keys)
    return out


def build_qlora(n_layer: int, seed: int, *, fmt: str = "nf4",
                lora_b_std: float = 0.0):
    """QLoRA on a Qwen3-8B-width base with random weights from a seeded
    generator on the card: the block kernels are quantized layer by layer
    (the f32 weights of one layer exist at a time; NF4 through the port's
    ``quantize_base``, int4 and int8 through their codecs as a PTQ export
    holds them), the embedding and norms stay bf16, LoRA factors come from
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
        if fmt == "nf4":
            state.update(quantize_base(layer))
        else:
            state.update({name: quantize_weight(fmt, v)
                          if name.endswith(".kernel") else v
                          for name, v in layer.items()})
    lcfg = LoRAConfig(r=LORA_R, alpha=LORA_ALPHA,
                      target_patterns=("q_proj", "v_proj"))
    lora = init_lora(state, lcfg, gen)
    if lora_b_std:
        for ab in lora.values():
            ab["b"].normal_(0.0, lora_b_std, generator=gen)
    model = QLoRAModel(Qwen3(cfg, device="meta"), state, lora, lcfg,
                       device=dev)
    return cfg, model


def _plain_fn(fwd, bwd):
    """A kernel wrapper's stand-in built from its plain versions: the
    forward, and under autograd the backward where x needs a gradient."""
    import torch

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, t, out_dtype):
            ctx.t, ctx.x_dtype = t, x.dtype
            return fwd(x, t, out_dtype)

        @staticmethod
        def backward(ctx, dy):
            dx = None
            if ctx.needs_input_grad[0]:
                dx = bwd(dy, ctx.t, ctx.x_dtype)
            return dx, None, None

    def call(x, t, out_dtype=None):
        if torch.is_grad_enabled() and x.requires_grad:
            return Plain.apply(x, t, out_dtype)
        return fwd(x, t, out_dtype)

    return call


def plain_kernels():
    """Swap every kernel of the serving and training paths for its plain
    version (the quantized matmuls that ``serve/quantized.py`` dispatches
    to, and flash attention); returns the undo."""
    import torch

    import llm_in_practise_tpu_torch.ops.attention as attention
    import llm_in_practise_tpu_torch.serve.quantized as quantized
    from llm_in_practise_tpu_torch.ops import flash_attention as fa
    from llm_in_practise_tpu_torch.ops import int4_matmul as i4
    from llm_in_practise_tpu_torch.ops import int8_matmul as i8
    from llm_in_practise_tpu_torch.ops import nf4_matmul as nm

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

    def flash_plain(q, k, v, *, causal=True, scale=None):
        return PlainFlash.apply(q, k, v, q.shape[-1] ** -0.5
                                if scale is None else scale)

    saved = (quantized.nf4_matmul, quantized.int4_matmul,
             quantized.int8_matmul, attention.flash_attention)
    quantized.nf4_matmul = _plain_fn(nm.nf4_matmul_reference,
                                     nm.nf4_matmul_backward_reference)
    quantized.int4_matmul = _plain_fn(i4.int4_matmul_reference,
                                      i4.int4_matmul_backward_reference)
    quantized.int8_matmul = _plain_fn(i8.int8_matmul_reference,
                                      i8.int8_matmul_backward_reference)
    attention.flash_attention = flash_plain

    def undo():
        (quantized.nf4_matmul, quantized.int4_matmul, quantized.int8_matmul,
         attention.flash_attention) = saved

    return undo


def kernel_counters() -> dict:
    from llm_in_practise_tpu_torch.ops import flash_attention as fa
    from llm_in_practise_tpu_torch.ops import int4_matmul as i4
    from llm_in_practise_tpu_torch.ops import int8_matmul as i8
    from llm_in_practise_tpu_torch.ops import nf4_matmul as nm

    return {"nf4_matmul": nm.nf4_matmul,
            "nf4_matmul_backward": nm.nf4_matmul_backward,
            "flash_forward": fa.flash_forward,
            "flash_backward_dkv": fa.flash_backward_dkv,
            "flash_backward_dq": fa.flash_backward_dq,
            "int4_matmul": i4.int4_matmul,
            "int4_matmul_backward": i4.int4_matmul_backward,
            "int8_matmul": i8.int8_matmul,
            "int8_matmul_backward": i8.int8_matmul_backward}


def zero_counters() -> None:
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    for fmt in FWD_FORMATS:
        routes = counters[f"{fmt}_matmul"].launches_by_route
        for route in routes:
            routes[route] = 0


def read_counters() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def read_routes() -> dict:
    """Each forward kernel's launches by route since the last zero."""
    counters = kernel_counters()
    return {f"{fmt}_matmul": dict(counters[f"{fmt}_matmul"].launches_by_route)
            for fmt in FWD_FORMATS}


def route_launches(fmt: str, rows_per_pass, shapes, layers: int = 1
                   ) -> dict:
    """Launches per route that ``fmt``'s ``_route`` gives when forward
    passes of ``rows_per_pass`` rows each run the projections ``shapes``
    ((K, N) pairs, one launch each) in each of ``layers`` layers."""
    mod, _, route_of = fwd_op(fmt)
    counts = dict.fromkeys(mod.ROUTES, 0)
    for m in rows_per_pass:
        for k, n in shapes:
            counts[route_of(m, k, n)] += layers
    return counts


def expected_launches(n_layer: int, fmt: str = "nf4") -> dict:
    """Kernel launches of one QLoRA training step over a ``fmt`` base,
    derived from the model. The 7 quantized projections of a block run
    forward once, and again in the remat recompute, except the last one:
    PyTorch's non-reentrant checkpoint stops recomputing once every tensor
    the backward needs is rebuilt, and down_proj saves none (the frozen
    quantized weight is not a saved tensor), so 13 per block. They run
    backward wherever their input needs a gradient: everywhere but layer
    0's q/k/v, whose input (the frozen embedding) needs none. Attention
    runs forward twice and backward once per block. Every other kernel
    launches none."""
    counts = dict.fromkeys(kernel_counters(), 0)
    counts.update({f"{fmt}_matmul": (7 + 6) * n_layer,
                   f"{fmt}_matmul_backward": 7 * n_layer - 3,
                   "flash_forward": 2 * n_layer,
                   "flash_backward_dkv": n_layer,
                   "flash_backward_dq": n_layer})
    return counts


def step_check(seed: int, fmt: str = "nf4") -> dict:
    """One QLoRA step over a ``fmt`` base at full width, 2 layers, batch
    2 x 1024, with the kernels and with their plain versions: loss and
    LoRA gradients. The LoRA B factors are drawn non-zero here, so every
    factor has a gradient (with B = 0 the gradients of A vanish)."""
    import torch

    from llm_in_practise_tpu_torch.train.step import make_fused_ce_loss

    cfg, model = build_qlora(STEP_LAYERS, seed + 3, fmt=fmt, lora_b_std=0.02)
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
    routes = read_routes()[f"{fmt}_matmul"]
    undo = plain_kernels()
    try:
        zero_counters()
        loss_p, grads_p = run()
        plain_counts = read_counters()
    finally:
        undo()
    want = expected_launches(STEP_LAYERS, fmt)
    # the forwards see batch x seq rows: 7 projections, then the remat
    # recompute of all but down_proj, per layer
    shapes = list(PROJ_SHAPES.values())
    want_routes = route_launches(fmt, [STEP_BATCH * TRAIN_SEQ],
                                 shapes + shapes[:-1], STEP_LAYERS)
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    grad_rel = [_rel(a, b)[1] for a, b in zip(grads_k, grads_p)]
    res = {"base": fmt, "layers": STEP_LAYERS, "batch": STEP_BATCH,
           "seq": TRAIN_SEQ,
           "loss_kernels": loss_k.item(), "loss_plain": loss_p.item(),
           "loss_rel_err": loss_rel, "grad_max_rel_err": max(grad_rel),
           "grads": len(grad_rel), "launches": counts,
           "launches_by_route": routes,
           "plain_launches": plain_counts,
           "tol": f"loss {STEP_LOSS_TOL} relative, each LoRA gradient "
                  f"{STEP_GRAD_TOL} * max|plain|: bf16 activations carry "
                  "the kernels' summation-order differences through both "
                  "layers, forward and backward"}
    log("step check:", json.dumps(res))
    if (not all(torch.isfinite(g).all() for g in grads_k)
            or loss_rel > STEP_LOSS_TOL or max(grad_rel) > STEP_GRAD_TOL
            or counts != want or any(plain_counts.values())
            or routes != want_routes):
        raise SystemExit(f"QLoRA step over {fmt} with kernels disagrees "
                         f"with the plain path (launches wanted {want}, "
                         f"{fmt} forward routes {want_routes}): {res}")
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
    from torch.profiler import ProfilerActivity

    from llm_in_practise_tpu_torch.obs.meter import (
        exclusive_profile as profile,
    )

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
    # every NF4 forward sees batch x seq rows: the wgmma route's
    shapes = list(PROJ_SHAPES.values())
    route_per_step = route_launches("nf4", [TRAIN_M], shapes + shapes[:-1],
                                    n_layer)
    walls, step_counts, step_routes = [], [], []
    for _ in range(TRAIN_STEPS):
        zero_counters()
        t0 = time.monotonic()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())  # syncs the step
        walls.append(time.monotonic() - t0)
        step_counts.append(read_counters())
        step_routes.append(read_routes()["nf4_matmul"])
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
        "nf4_routes_per_step": step_routes,
        "nf4_routes_per_step_expected": route_per_step,
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
    if not all(r == route_per_step for r in step_routes):
        raise SystemExit(f"nf4_matmul routes per step {step_routes} != "
                         f"{route_per_step}")
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
            # the three flash kernels' share of the step (device ms and
            # launches), which the top kernels do not reach
            "flash_kernels": {name: {
                "ms": sum(e.self_device_time_total for e in kernels
                          if name in e.key) / 1e3,
                "launches": sum(e.count for e in kernels if name in e.key)}
                for name in ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                             "flash_bwd_dq_kernel")},
        }
    log("train profile:", json.dumps(out["profile"]))
    return {"launches": counts, "routes": step_routes, "train": out}


# ckpt phase: every file of the lifecycle at Qwen3-8B width. The published
# Qwen/Qwen3-8B checkpoint is five safetensors shards plus an index; its
# config.json keys below, tied as in the other cells (the published 8B has
# its own lm_head: the tie is the cells' cut). Depth is cut to 18 of 36
# layers: the card's machine takes 45 GiB of disk writes per run, deleted
# files included (a 36-layer run was stopped at 56.4 GiB), and the phase
# writes 1.71 GiB per layer (bf16 HF dir and model.msgpack, NF4 and int8
# exports, f32 HF export) plus 6.96 GiB for the embedding: 37.7 GiB at 18.
CKPT_LAYERS = 8
CKPT_SHARDS = 5
CKPT_TRAIN_STEPS = 2
CKPT_HF_CONFIG = {
    "architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3",
    "vocab_size": 151936, "hidden_size": 4096, "intermediate_size": 12288,
    "num_hidden_layers": CKPT_LAYERS, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-6, "max_position_embeddings": 40960,
    "tie_word_embeddings": True, "torch_dtype": "bfloat16"}


def path_bytes(path: str) -> int:
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def io_row(path: str, seconds: float) -> dict:
    n = path_bytes(path)
    return {"bytes": n, "s": seconds, "gb_s": n / seconds / 1e9}


@contextlib.contextmanager
def timed_calls(module, name: str, sink: dict, key: str):
    """Time each call of ``module.name`` into ``sink[key]`` while open."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        t0 = time.monotonic()
        out = fn(*args, **kwargs)
        sink[key] = time.monotonic() - t0
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def ckpt_state(cfg, seed: int) -> dict:
    """The phase's seeded bf16 state, on the card, in the port's names."""
    import torch

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, bf16 = cfg.hidden_size, torch.bfloat16

    def randn(*shape):
        return (torch.randn(*shape, device=dev, generator=gen) * 0.02).to(
            bf16)

    state = {"tok_embed.weight": randn(cfg.vocab_size, d),
             "ln_f.scale": torch.ones(d, device=dev, dtype=bf16)}
    for i in range(cfg.n_layer):
        p = f"blocks.{i}"
        for name in ("ln1", "ln2"):
            state[f"{p}.{name}.scale"] = torch.ones(d, device=dev, dtype=bf16)
        for name in ("q_norm", "k_norm"):
            state[f"{p}.attn.{name}.scale"] = torch.ones(
                cfg.head_dim, device=dev, dtype=bf16)
        for name, (k, n) in PROJ_SHAPES.items():
            sub = "mlp" if name in ("gate_proj", "up_proj", "down_proj") \
                else "attn"
            state[f"{p}.{sub}.{name}.kernel"] = randn(k, n)
    return state


def write_hf_dir(path: str, state: dict) -> None:
    """``state`` as the published layout: ``CKPT_SHARDS`` bf16 shards of
    about equal size, ``model.safetensors.index.json``, ``config.json``
    (fixture code: safetensors' own writer, not the port's)."""
    import safetensors.torch

    from llm_in_practise_tpu_torch.models.hf_loader import _hf_name

    os.makedirs(path, exist_ok=True)
    names = list(state)
    total = sum(t.numel() * t.element_size() for t in state.values())
    shards, cur, size = [], [], 0
    for name in names:
        cur.append(name)
        size += state[name].numel() * state[name].element_size()
        if size >= total * (len(shards) + 1) / CKPT_SHARDS:
            shards.append(cur)
            cur = []
    if cur:
        shards.append(cur)
    weight_map = {}
    for i, part in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        tensors = {}
        for name in part:
            hf, transpose = _hf_name(name)
            t = state[name]
            tensors[hf] = (t.t() if transpose else t).contiguous().cpu()
            weight_map[hf] = fname
        safetensors.torch.save_file(tensors, os.path.join(path, fname),
                                    metadata={"format": "pt"})
        del tensors
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(CKPT_HF_CONFIG, f, indent=2)


def ckpt_chats() -> list[list[dict]]:
    """The NF4 serving cell's 8 chats."""
    return [[{"role": "system", "content": "You are a helpful assistant."},
             {"role": "user",
              "content": f"Explain {TOPICS[i]} in a few sentences."}]
            for i in range(MAX_SLOTS)]


def direct_tokens(model, tok, seed: int) -> list[list[int]]:
    """Greedy tokens of the 8 chats through a fresh engine in the CLI's
    default KV layout (the served engines'), all submitted before its
    first step: the batches the gated HTTP run forms."""
    import torch

    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.serve.__main__ import build_parser
    from llm_in_practise_tpu_torch.serve.engine import (
        InferenceEngine,
        SamplingParams,
    )

    engine = InferenceEngine(model, max_slots=MAX_SLOTS, cache_len=CACHE_LEN,
                             eos_id=tok.token_to_id(IM_END),
                             cache_dtype=torch.bfloat16, seed=seed,
                             kv_layout=build_parser().get_default(
                                 "kv_layout"))
    params = SamplingParams(temperature=0.0, greedy=True,
                            max_tokens=MAX_TOKENS)
    reqs = [engine.submit(prompt_ids(tok, m), params) for m in ckpt_chats()]
    with torch.inference_mode():
        while engine.step():
            pass
    if engine.error is not None:
        raise SystemExit(f"engine failed: {engine.error!r}")
    return [list(r.output_ids) for r in reqs]


def served_chats(argv: list[str], tok, timings: dict) -> dict:
    """``serve.build_server(argv)``, then the 8 chats over HTTP (4
    streamed), submitted one by one in a fixed order while the engine
    waits at its next admission, so they are admitted together as in
    :func:`direct_tokens`: once to build the kernels and capture every
    graph the run takes (each paged view width has its own), then with
    the counters zeroed before and read after; then the first chat
    alone."""
    import torch

    from llm_in_practise_tpu_torch.ckpt import checkpoint as ckpt_mod
    from llm_in_practise_tpu_torch.quant import io as quant_io
    from llm_in_practise_tpu_torch.serve.__main__ import (
        build_parser,
        build_server,
    )

    t0 = time.monotonic()
    with timed_calls(quant_io, "load_packed", timings, "read_s"), \
            timed_calls(ckpt_mod, "restore_checkpoint", timings, "read_s"):
        server = build_server(build_parser().parse_args(argv))
    timings["build_server_s"] = time.monotonic() - t0
    engine = server.engine
    seen = []
    submit = engine.submit

    def recording_submit(*args, **kwargs):
        req = submit(*args, **kwargs)
        seen.append(req)
        return req

    engine.submit = recording_submit
    gate = threading.Event()
    gate.set()
    admit = engine._admit

    def gated_admit():
        gate.wait()
        return admit()

    engine._admit = gated_admit
    port = server.serve(host="127.0.0.1", port=0, background=True)
    base = f"http://127.0.0.1:{port}"

    def body(i, stream):
        return {"model": "qwen3-h100", "temperature": 0.0,
                "max_tokens": MAX_TOKENS, "stream": stream,
                "messages": ckpt_chats()[i]}

    def gated_batch():
        gate.clear()
        with concurrent.futures.ThreadPoolExecutor(MAX_SLOTS) as pool:
            futs = []
            for i in range(MAX_SLOTS):
                futs.append(pool.submit(post_chat, base, body(i, i % 2 == 1)))
                wait_for(lambda: engine.pending.qsize() == i + 1,
                         f"chat {i} to queue")
            gate.set()
            return [f.result() for f in futs]

    try:
        gated_batch()   # warm-up: builds and captures
        torch.cuda.synchronize()
        seen.clear()
        zero_counters()
        replays0 = engine.graphs.replays
        steps0 = (engine.decode_steps_run, engine.prefill_batches_run)
        t_run = time.monotonic()
        results = gated_batch()
        wall = time.monotonic() - t_run
        counts, routes = read_counters(), read_routes()
        decode_steps = engine.decode_steps_run - steps0[0]
        prefills = engine.prefill_batches_run - steps0[1]
        replays = engine.graphs.replays - replays0
        reqs = list(seen)
        seen.clear()
        post_chat(base, body(0, False))
        solo = list(seen[0].output_ids)
    finally:
        server.shutdown()
        gate.set()
    if engine.error is not None:
        raise SystemExit(f"engine failed: {engine.error!r}")
    if sum(r.get("done", False) for r in results) != MAX_SLOTS // 2 or any(
            r["finish_reason"] not in ("stop", "length") for r in results):
        raise SystemExit(f"a chat did not complete or stream: {results}")
    if replays != decode_steps:
        raise SystemExit(f"{replays} graph replays for {decode_steps} "
                         "decode steps: a decode step ran outside its graph")
    return {"model": engine.model, "solo": solo,
            "tokens": [list(r.output_ids) for r in reqs],
            "counts": counts, "routes": routes, "forwards":
            decode_steps + prefills, "decode_steps": decode_steps,
            "graph_replays": replays, "wall_s": wall,
            "ttft_p50_s": statistics.median(r.ttft_s for r in reqs),
            "tpot_p50_s": statistics.median(r.tpot_s for r in reqs
                                            if r.tpot_s is not None)}


def one_slot_chat(model, tok, messages) -> list[int]:
    """Greedy tokens of one chat over HTTP from a server whose engine has
    one slot, on ``model``: its decode runs one row, as ``generate``'s
    does. (cuBLAS's f32 GEMM of the tied head gives row 0 other rounding
    at 8 rows than at 1: 9.5e-6 apart in a probe on the card, enough to
    flip a near-tie of random weights' logits.)"""
    import torch

    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.serve.api import OpenAIServer
    from llm_in_practise_tpu_torch.serve.engine import InferenceEngine

    engine = InferenceEngine(model, max_slots=1, cache_len=CACHE_LEN,
                             eos_id=tok.token_to_id(IM_END),
                             cache_dtype=torch.bfloat16)
    seen = []
    submit = engine.submit

    def recording_submit(*args, **kwargs):
        seen.append(submit(*args, **kwargs))
        return seen[-1]

    engine.submit = recording_submit
    server = OpenAIServer(engine, tok, model_name="qwen3-h100")
    port = server.serve(host="127.0.0.1", port=0, background=True)
    try:
        post_chat(f"http://127.0.0.1:{port}", {
            "model": "qwen3-h100", "temperature": 0.0,
            "max_tokens": MAX_TOKENS, "messages": messages})
    finally:
        server.shutdown()
    if engine.error is not None:
        raise SystemExit(f"engine failed: {engine.error!r}")
    return list(seen[0].output_ids)


def ckpt_phase(seed: int, card: str, tok, nf4_cell: dict) -> dict:
    """The lifecycle's files at Qwen3-8B width and full depth: an HF
    directory written from seeded weights, ``convert_hf`` to NF4 and to
    int8 exports served over HTTP (tokens equal to a model quantized in
    memory from the same state), ``train --model_dir --adapter_dir``,
    ``merge_lora`` (``model.msgpack`` equal to an in-memory merge, its
    chunked embedding, the f32 HF export), and ``serve --model_path`` with
    ``infer.generate`` against the server. Each file is deleted after its
    check."""
    import resource
    import shutil

    import torch

    from llm_in_practise_tpu_torch import convert_hf as convert_mod
    from llm_in_practise_tpu_torch import merge_lora as merge_mod
    from llm_in_practise_tpu_torch.ckpt.checkpoint import restore_checkpoint
    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.infer.generate import generate
    from llm_in_practise_tpu_torch.models.convert import (
        lora_from_jax,
        params_from_jax,
    )
    from llm_in_practise_tpu_torch.models.hf_loader import (
        load_config,
        load_qwen3,
    )
    from llm_in_practise_tpu_torch.peft.lora import LoRAConfig, merge_lora
    from llm_in_practise_tpu_torch.peft.qlora import quantize_base
    from llm_in_practise_tpu_torch.quant import io as quant_io
    from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
    from llm_in_practise_tpu_torch.serve.quantized import QuantizedModel
    from llm_in_practise_tpu_torch.train import __main__ as train_mod

    t_phase = time.monotonic()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "ckpt_phase")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    hf, tok_path = os.path.join(root, "hf"), os.path.join(root, "tok.json")
    adapter, merged_dir = os.path.join(root, "adapter"), os.path.join(
        root, "merged")
    tok.save(tok_path)
    torch.cuda.reset_peak_memory_stats()
    out = {"card": card, "free_disk_gb_at_start":
           shutil.disk_usage(root).free / 1e9, "io": {}, "serve": {}}
    io = out["io"]

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    try:
        state = ckpt_state(Qwen3Config.from_hf_config(CKPT_HF_CONFIG), seed)
        t0 = time.monotonic()
        write_hf_dir(hf, state)
        io["hf_dir_write"] = io_row(hf, time.monotonic() - t0)
        log("ckpt: HF dir written:", json.dumps(io["hf_dir_write"]))
        cfg = load_config(hf)
        refs = {}
        for fmt in ("nf4", "int8"):
            model = QuantizedModel(Qwen3(cfg, device="meta"),
                                   quantize_base(dict(state), fmt=fmt))
            refs[fmt] = direct_tokens(model, tok, seed)
            del model
            free()
        del state
        free()

        launches = {}
        for fmt, kernel in (("nf4", "nf4_matmul"), ("int8", "int8_matmul")):
            export = os.path.join(root, fmt)
            t = {}
            t0 = time.monotonic()
            with timed_calls(convert_mod, "load_qwen3", t, "read_s"), \
                    timed_calls(quant_io, "save_packed", t, "write_s"):
                convert_mod.main(["--model_dir", hf, "--out_dir", export,
                                  "--quantization", fmt])
            t["convert_s"] = time.monotonic() - t0
            io[f"convert_{fmt}_read_hf"] = io_row(hf, t["read_s"])
            io[f"convert_{fmt}_write_export"] = io_row(export, t["write_s"])
            free()
            res = served_chats(["--quantized_dir", export, "--tokenizer_path",
                                tok_path, "--max_slots", str(MAX_SLOTS),
                                "--cache_len", str(CACHE_LEN),
                                "--kv-cache-dtype", "bfloat16"], tok, t)
            io[f"serve_{fmt}_read_export"] = io_row(export, t["read_s"])
            n = res["counts"][kernel]
            if res["tokens"] != refs[fmt]:
                raise SystemExit(
                    f"{fmt}: the served export's tokens differ from the "
                    "in-memory model's")
            if (n == 0 or n != 7 * cfg.n_layer * res["forwards"]
                    or sum(res["counts"].values()) != n):
                raise SystemExit(f"{kernel} launches {n} != 7 x "
                                 f"{cfg.n_layer} x {res['forwards']} "
                                 "forward passes, or "
                                 f"another kernel served: {res['counts']}")
            launches[kernel] = n
            out["serve"][fmt] = {
                k: res[k] for k in ("forwards", "decode_steps",
                                    "graph_replays", "wall_s", "ttft_p50_s",
                                    "tpot_p50_s")}
            out["serve"][fmt].update(
                kernel_launches=n, routes=res["routes"][kernel],
                tokens_equal_in_memory=True,
                convert_s=t["convert_s"], build_server_s=t["build_server_s"])
            log(f"ckpt: {fmt} export served:", json.dumps(out["serve"][fmt]))
            del res
            free()
            shutil.rmtree(export)

        # QLoRA from the HF dir; the adapter through the port's codec
        t = {}
        zero_counters()
        t0 = time.monotonic()
        with timed_calls(train_mod, "load_qwen3", t, "read_s"), \
                timed_calls(train_mod, "save_named", t, "write_s"):
            rc = train_mod.main(["--model_dir", hf, "--adapter_dir", adapter,
                                 "--steps", str(CKPT_TRAIN_STEPS)])
        torch.cuda.synchronize()
        train_counts = read_counters()
        out["train"] = {"rc": rc, "s": time.monotonic() - t0,
                        "launches": {k: v for k, v in train_counts.items()
                                     if v}}
        io["train_read_hf"] = io_row(hf, t["read_s"])
        io["adapter_write"] = io_row(adapter, t["write_s"])
        free()
        train_kernels = ("nf4_matmul", "nf4_matmul_backward", "flash_forward",
                         "flash_backward_dkv", "flash_backward_dq")
        if rc != 0 or any(train_counts[k] == 0 for k in train_kernels):
            raise SystemExit(f"train --model_dir failed or a kernel did not "
                             f"launch: rc {rc}, {train_counts}")
        atree, ameta = restore_checkpoint(os.path.join(adapter,
                                                       "adapter.msgpack"))
        lcfg = LoRAConfig.from_dict(ameta["lora_config"])
        want_keys = {f"block_{i}/attn/{p}/kernel" for i in range(cfg.n_layer)
                     for p in ("q_proj", "v_proj")}
        shapes_ok = all(
            tuple(ab["a"].shape) == (PROJ_SHAPES[k.split("/")[2]][0], lcfg.r)
            and tuple(ab["b"].shape) == (lcfg.r,
                                         PROJ_SHAPES[k.split("/")[2]][1])
            and ab["a"].dtype == ab["b"].dtype == torch.float32
            for k, ab in atree.items())
        b_moved = all(bool(ab["b"].abs().sum() > 0) for ab in atree.values())
        out["train"]["adapter"] = {"entries": len(atree),
                                   "shapes_f32": shapes_ok,
                                   "b_nonzero": b_moved, "r": lcfg.r}
        if set(atree) != want_keys or not shapes_ok or not b_moved:
            raise SystemExit(f"restored adapter is wrong: {out['train']}")
        log("ckpt: train:", json.dumps(out["train"]))

        # merge: model.msgpack + the f32 HF export
        t = {}
        with timed_calls(merge_mod, "load_qwen3", t, "read_s"), \
                timed_calls(merge_mod, "save_named", t, "msgpack_write_s"), \
                timed_calls(merge_mod, "save_qwen3", t, "f32_write_s"):
            merge_mod.main(["--adapter_dir", adapter, "--model_dir", hf,
                            "--out_dir", merged_dir])
        msgpack_path = os.path.join(merged_dir, "model.msgpack")
        f32_path = os.path.join(merged_dir, "model.safetensors")
        io["merge_read_hf"] = io_row(hf, t["read_s"])
        io["model_msgpack_write"] = io_row(msgpack_path, t["msgpack_write_s"])
        io["hf_f32_export_write"] = io_row(f32_path, t["f32_write_s"])
        out["disk_gb_at_peak"] = path_bytes(root) / 1e9
        free()
        import mmap

        with open(msgpack_path, "rb") as f, mmap.mmap(
                f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            chunked = mm.rfind(b"__msgpack_chunked_array__") >= 0
        t0 = time.monotonic()
        tree, meta = restore_checkpoint(msgpack_path)
        io["model_msgpack_read"] = io_row(msgpack_path,
                                          time.monotonic() - t0)
        restored = params_from_jax(tree, cfg)
        del tree
        t0 = time.monotonic()
        _, base = load_qwen3(hf)
        io["check_read_hf"] = io_row(hf, time.monotonic() - t0)
        lora = {n: {k: v.cuda() for k, v in ab.items()}
                for n, ab in lora_from_jax(atree, cfg).items()}
        merged = merge_lora(base, lora, lcfg)
        del base
        same_msgpack = sorted(restored) == sorted(merged) and all(
            restored[n].dtype == torch.bfloat16
            and torch.equal(restored[n].cuda(), merged[n]) for n in merged)
        del restored
        shutil.rmtree(hf)
        t0 = time.monotonic()
        _, export = load_qwen3(merged_dir)
        io["hf_f32_export_read"] = io_row(f32_path, time.monotonic() - t0)
        same_export = sorted(export) == sorted(merged) and all(
            torch.equal(export[n], merged[n]) for n in merged)
        del export, merged, lora
        free()
        os.remove(f32_path)
        out["merge"] = {"chunked_embedding": chunked,
                        "config_matches": meta["config"] == cfg.to_dict(),
                        "msgpack_equals_in_memory_merge": same_msgpack,
                        "f32_export_equals": same_export}
        log("ckpt: merge:", json.dumps(out["merge"]))
        if not all(out["merge"].values()):
            raise SystemExit(f"merged checkpoint checks failed: "
                             f"{out['merge']}")

        # the merged model, dense, behind the server; generate against it
        t = {}
        res = served_chats(["--model_path", msgpack_path, "--tokenizer_path",
                            tok_path, "--max_slots", str(MAX_SLOTS),
                            "--cache_len", str(CACHE_LEN),
                            "--kv-cache-dtype", "bfloat16"], tok, t)
        io["serve_dense_read_msgpack"] = io_row(msgpack_path, t["read_s"])
        eos = tok.token_to_id(IM_END)
        first = prompt_ids(tok, ckpt_chats()[0])
        ids = generate(res["model"], [first], greedy=True,
                       max_new_tokens=MAX_TOKENS, eos_id=eos,
                       cache_len=CACHE_LEN, cache_dtype=torch.bfloat16)
        new = ids[0, len(first):].tolist()
        new = new[:new.index(eos)] if eos in new else new
        one_slot = one_slot_chat(res["model"], tok, ckpt_chats()[0])
        out["serve"]["dense"] = {
            k: res[k] for k in ("forwards", "decode_steps", "graph_replays",
                                "wall_s", "ttft_p50_s", "tpot_p50_s")}
        out["serve"]["dense"].update(
            kernel_launches=sum(res["counts"].values()),
            build_server_s=t["build_server_s"],
            generate_equals_one_slot_server=new == one_slot,
            generate_equals_8_slot_server_alone=new == res["solo"],
            generate_equals_8_slot_server_batched=new == res["tokens"][0],
            generated=len(new))
        log("ckpt: dense served:", json.dumps(out["serve"]["dense"]))
        if new != one_slot or not new:
            raise SystemExit("infer.generate's greedy ids differ from the "
                             "one-slot server's for the first prompt")
        del res
        free()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {"ckpt_serve_nf4": launches.get("nf4_matmul", 0),
                       "ckpt_serve_int8": launches.get("int8_matmul", 0),
                       "ckpt_train": {k: v for k, v in train_counts.items()
                                      if v}}
    out["written_gib"] = sum(row["bytes"] for key, row in io.items()
                             if "write" in key) / 2**30
    out["host_peak_rss_gb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1e6
    out["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["nf4_cell"] = {k: nf4_cell[k] for k in ("ttft_p50_s", "tpot_p50_s")}
    out["phase_s"] = time.monotonic() - t_phase
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--flash-only", action="store_true",
                    help="build the flash source only, run the flash checks "
                         "and times, print their rows and stop")
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
    if args.flash_only:
        t0 = time.monotonic()
        _build.load("flash_attention")
        log(f"build: {time.monotonic() - t0:.1f}s (flash_attention only)")
        log("flash kernels (ptxas):", json.dumps(qmm_resources()))
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        rows = check_flash(args.seed, flush)
        for name, row in rows.items():
            row = {k: v for k, v in row.items() if k != "checks"}
            log(json.dumps({"kernel": name, **row}))
        log(f"flash only: total {time.monotonic() - t_start:.1f}s")
        log(card_line())
        return 0
    log(f"build: {_build.build_all():.1f}s (nvcc, sm_90a, "
        f"{len(_build.KERNELS)} sources)")
    resources = qmm_resources()
    log("wgmma mainloop kernels (ptxas):", json.dumps(resources))

    def free():
        gc.collect()  # a model and its engine go before the next phase
        torch.cuda.empty_cache()

    def phase_time(name, t0):
        log(f"phase {name}: {time.monotonic() - t0:.1f}s")

    t0 = time.monotonic()
    summary = check_nf4_kernel(args.seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ptq_rows = check_ptq_kernels(args.seed, flush)
    thin_exact = thin_exactness(args.seed)
    thin_checked = thin_rows(args.seed)
    crossovers = {}
    for fmt in FWD_FORMATS:
        crossovers[fmt] = fwd_crossover(fmt, args.seed, flush)
        log(f"{fmt} crossover:", json.dumps(crossovers[fmt]))
    decode = decode_device(args.seed, flush)
    phase_time("kernel checks", t0)
    tok = train_tokenizer()
    served = {}
    for fmt in ("nf4", "int4", "int8"):
        t0 = time.monotonic()
        served[fmt] = serve_phase(fmt, N_LAYER, args.seed, card, tok,
                                  keep_model=fmt == "nf4")
        phase_time(f"serve {fmt}", t0)
        if fmt == "nf4":   # serve_sched reuses the NF4 model
            model = served[fmt].pop("model")
            free()         # the serving phase's engine, cache and graphs
            t0 = time.monotonic()
            sched = sched_phase(model, tok, args.seed, card)
            phase_time("serve_sched", t0)
            free()         # serve_sched's engine, cache and graphs
            t0 = time.monotonic()
            paged = paged_phase(model, tok, args.seed, card,
                                served[fmt]["serve"])
            phase_time("serve_paged", t0)
            free()         # serve_paged's engines
            # serve_spec and serve_struct run at CUT_LAYERS deep (every
            # check kept), on a model built as the full one is
            t0 = time.monotonic()
            set_depth(CUT_LAYERS)
            _, shallow = build_model("nf4", CUT_LAYERS, args.seed)
            spec = spec_phase(shallow, tok, args.seed, card,
                              served[fmt]["serve"])
            phase_time("serve_spec", t0)
            free()         # serve_spec's engines and draft
            t0 = time.monotonic()
            struct = struct_phase(shallow, tok, args.seed, card,
                                  served[fmt]["serve"])
            phase_time("serve_struct", t0)
            set_depth(N_LAYER_FULL)
            free()         # serve_struct's engines
            # serve_disagg: leg 1 on the full-depth model, the cross-layout
            # and tier legs on the CUT_LAYERS one
            t0 = time.monotonic()
            disagg = disagg_phase(model, shallow, tok, args.seed, card,
                                  served[fmt]["serve"])
            phase_time("serve_disagg", t0)
            free()         # serve_disagg's engines
            # serve_lora at CUT_LAYERS deep too (every check kept)
            t0 = time.monotonic()
            set_depth(CUT_LAYERS)
            lora = lora_phase(shallow, tok, args.seed, card,
                              served[fmt]["serve"])
            set_depth(N_LAYER_FULL)
            del shallow
            phase_time("serve_lora", t0)
            free()         # serve_lora's engines and registries
            t0 = time.monotonic()
            sessions = sessions_phase(model, tok, args.seed, card,
                                      served[fmt]["serve"])
            phase_time("serve_sessions", t0)
            free()         # serve_sessions' engines and servers
            t0 = time.monotonic()
            obs = obs_phase(model, tok, args.seed, card,
                            served[fmt]["serve"])
            del model
            phase_time("serve_obs", t0)
        free()
    t0 = time.monotonic()
    awq_res = awq_check(tok, args.seed)
    free()
    phase_time("awq", t0)

    t0 = time.monotonic()
    nf4_rows = check_train_nf4(args.seed, flush)
    flash_rows = check_flash(args.seed, flush)
    del flush
    phase_time("training kernels", t0)
    steps = {}
    for fmt in ("nf4", "int4", "int8"):
        t0 = time.monotonic()
        steps[fmt] = step_check(args.seed, fmt)
        free()
        phase_time(f"step check {fmt}", t0)
    t0 = time.monotonic()
    trained = train_phase(N_LAYER, args.seed, card)
    phase_time("train", t0)
    launches = trained["launches"]
    free()
    t0 = time.monotonic()
    ckpt = ckpt_phase(args.seed, card, tok, served["nf4"]["serve"])
    phase_time("ckpt", t0)
    ckpt_train = ckpt["launches"]["ckpt_train"]

    csrc = "llm_in_practise_tpu_torch/csrc/"

    def ptxas(name):
        return {k: v for k, v in resources.items() if k in PTXAS_LABELS[name]}

    def fwd_routes(fmt, decode_m, by_route):
        """Which route each summarised row count took, the crossover table
        and the launches per route of each path."""
        route_of = fwd_op(fmt)[2]
        return {"fwd_route": {f"M={m}": route_of(m, *PROJ_SHAPES["q_proj"])
                              for m in (decode_m, TRAIN_M)},
                "crossover": crossovers[fmt], "launches_by_route": by_route}

    b1 = [r for r in nf4_rows.values() if r["kernel"] == "nf4_matmul"]
    b2 = [r for r in nf4_rows.values()
          if r["kernel"] == "nf4_matmul_backward"]
    train_routes = {route: sum(r[route] for r in trained["routes"])
                    for route in trained["routes"][0]}
    summary.update({
        "train": layer_sum(nf4_rows, "nf4_matmul"),
        **edge_summary(nf4_rows, "nf4_matmul"),
        "planted_fault_seen": all(r["planted_zero_absmax_rel_err"] >
                                  KERNEL_TOL for r in b1
                                  if "planted_zero_absmax_rel_err" in r),
        "ptxas": ptxas("nf4_matmul"),
        **fwd_routes("nf4", MAX_SLOTS, {
            "serve_nf4": served["nf4"]["routes"],
            "serve_nf4_sched": sched["routes"],
            "serve_nf4_paged": paged["routes"],
            "serve_nf4_spec": spec["routes"],
            "serve_nf4_struct": struct["routes"],
            "serve_nf4_lora": lora["routes"],
            "serve_nf4_disagg": disagg["routes"],
            "serve_nf4_sessions": sessions["routes"],
            "serve_nf4_obs": obs["routes"],
            "step_nf4": steps["nf4"]["launches_by_route"],
            "train_nf4": train_routes}),
        **decode_fields(decode, "nf4"),
        "thin_rows": thin_checked["nf4"],
        "thin_exactness": {k: v for k, v in thin_exact.items()
                           if " nf4" in k},
        "launches": (served["nf4"]["launches"] + sched["launches"]
                     + paged["launches"] + spec["launches"]
                     + struct["launches"] + lora["launches"]
                     + disagg["launches"] + sessions["launches"]
                     + obs["launches"] + launches["nf4_matmul"]
                     + ckpt["launches"]["ckpt_serve_nf4"]
                     + ckpt_train["nf4_matmul"]),
        "launches_by_path": {"serve_nf4": served["nf4"]["launches"],
                             "serve_nf4_sched": sched["launches"],
                             "serve_nf4_paged": paged["launches"],
                             "serve_nf4_spec": spec["launches"],
                             "serve_nf4_struct": struct["launches"],
                             "serve_nf4_lora": lora["launches"],
                             "serve_disagg": disagg["launches"],
                             "serve_sessions": sessions["launches"],
                             "serve_obs": obs["launches"],
                             "train_nf4": launches["nf4_matmul"],
                             "ckpt_serve_nf4":
                                 ckpt["launches"]["ckpt_serve_nf4"],
                             "ckpt_train": ckpt_train["nf4_matmul"]}})
    table = [summary, {
        "name": "nf4_matmul_backward",
        "source": csrc + "nf4_matmul_bwd.cu",
        "replaces": "llm_in_practise_tpu/ops/nf4_matmul.py:111",
        "tpu_function": "_bwd_kernel (pallas_call at :194)",
        **layer_sum(nf4_rows, "nf4_matmul_backward"),
        **edge_summary(nf4_rows, "nf4_matmul_backward"),
        "planted_fault_seen": all(r["planted_zero_absmax_rel_err"] >
                                  KERNEL_TOL for r in b2
                                  if "planted_zero_absmax_rel_err" in r),
        "ptxas": ptxas("nf4_matmul_backward"),
        "launches": (launches["nf4_matmul_backward"]
                     + ckpt_train["nf4_matmul_backward"]),
        "launches_by_path": {"train_nf4": launches["nf4_matmul_backward"],
                             "ckpt_train": ckpt_train["nf4_matmul_backward"]},
        "route": "cuda"}]
    for name, line, fn in (
            ("flash_forward", 55, "_fwd_kernel (pallas_call at :101)"),
            ("flash_backward_dkv", 129,
             "_bwd_dkv_kernel (pallas_call at :220)"),
            ("flash_backward_dq", 177,
             "_bwd_dq_kernel (pallas_call at :248)")):
        row = dict(flash_rows[name])
        row.pop("checks")
        row["ptxas"] = ptxas(name)
        by_path = {"train_nf4": launches[name],
                   "ckpt_train": ckpt_train[name]}
        if name == "flash_forward":
            # /v1/embeddings: one uncached forward per input
            by_path["serve_struct_embeddings"] = struct["flash_launches"]
        table.append({"name": name,
                      "source": csrc + "flash_attention.cu",
                      "replaces": f"llm_in_practise_tpu/ops/"
                                  f"flash_attention.py:{line}",
                      "tpu_function": fn, **row,
                      "launches": sum(by_path.values()),
                      "launches_by_path": by_path, "route": "cuda"})
    # B6-B9: launches on the PTQ serving runs and the PTQ step checks
    for name, fmt, src, line, fn, at_decode in (
            ("int4_matmul", "int4", "int4_matmul.cu", "int4_matmul.py:61",
             "_fwd_kernel (pallas_call at :157)", True),
            ("int4_matmul_backward", "int4", "int4_matmul.cu",
             "int4_matmul.py:86", "_bwd_kernel (pallas_call at :196)", False),
            ("int8_matmul", "int8", "int8_matmul.cu", "int8_matmul.py:50",
             "_fwd_kernel (pallas_call at :137)", True),
            ("int8_matmul_backward", "int8", "int8_matmul.cu",
             "int8_matmul.py:69", "_bwd_kernel (pallas_call at :173)",
             False)):
        case = "sym_g128" if fmt == "int4" else "per_channel"
        by_path = {f"step_{fmt}": steps[fmt]["launches"][name]}
        if at_decode:
            by_path = {f"serve_{fmt}": served[fmt]["launches"], **by_path}
        if name == "int4_matmul":
            by_path["serve_awq"] = awq_res["decode"]["launches"]
        if name == "int8_matmul":
            by_path["ckpt_serve_int8"] = ckpt["launches"]["ckpt_serve_int8"]
            by_path["serve_paged_int8"] = paged["int8_launches"]
            by_path["serve_disagg"] = disagg["int8_launches"]
        row = ptq_summary(ptq_rows, name, case,
                          MAX_SLOTS if at_decode else TRAIN_M)
        row["ptxas"] = ptxas(name)
        if at_decode:
            row["train"] = ptq_summary(ptq_rows, name, case, TRAIN_M)
            paths = {f"serve_{fmt}": served[fmt]["routes"],
                     f"step_{fmt}": steps[fmt]["launches_by_route"]}
            if fmt == "int4":
                paths["serve_awq"] = awq_res["decode"]["launches_by_route"]
            else:
                row["thin_rows"] = thin_checked[fmt]
            row["thin_exactness"] = {k: v for k, v in thin_exact.items()
                                     if f" {fmt}" in k}
            row.update(fwd_routes(fmt, MAX_SLOTS, paths))
            row.update(decode_fields(decode, fmt))
        table.append({"name": name, "source": csrc + src,
                      "replaces": f"llm_in_practise_tpu/ops/{line}",
                      "tpu_function": fn, **row,
                      "launches": sum(by_path.values()),
                      "launches_by_path": by_path, "route": "cuda"})
    if any(row["launches"] == 0 for row in table):
        raise SystemExit("a kernel of a path launched no time: "
                         f"{[(r['name'], r['launches']) for r in table]}")
    log("flash checks:", json.dumps(flash_rows["flash_forward"]["checks"]))
    log("decode device time, ms per layer's 7 projections (kernel self "
        "time under torch.profiler; event time beside it):",
        json.dumps(decode))
    log("step checks:", json.dumps(steps))
    log("awq model check:", json.dumps(awq_res))
    log("serving:", json.dumps({f: {k: v for k, v in r["serve"].items()
                                    if k != "model_check"}
                                for f, r in served.items()}))
    log("ckpt summary:", json.dumps(ckpt))
    log("serve_paged summary:", json.dumps(
        {k: v for k, v in paged["paged"].items()
         if k in ("profile", "phase_wall_s", "max_memory_allocated_gib",
                  "nf4_cell_tpot_p50_s")}))
    log("serve_spec summary:", json.dumps(
        {k: v for k, v in spec["spec"].items()
         if k in ("verify_vs_decode", "phase_wall_s",
                  "max_memory_allocated_gib", "nf4_cell_tpot_p50_s")}))
    log("serve_struct summary:", json.dumps(
        {k: v for k, v in struct["struct"].items()
         if k in ("vocab_strings_s", "states_compiled", "compile_s_per_state",
                  "masked_kinds_checked", "phase_wall_s",
                  "max_memory_allocated_gib", "nf4_cell_tpot_p50_s")}))
    log("serve_lora summary:", json.dumps(
        {k: v for k, v in lora["lora"].items()
         if k in ("tpot_p50_s", "ttft_p50_s", "profile", "bank_mib",
                  "swap_seconds", "twins_checked", "phase_wall_s",
                  "max_memory_allocated_gib", "nf4_cell_tpot_p50_s")},
        default=str))
    log("serve_disagg summary:", json.dumps(
        {k: v for k, v in disagg["disagg"].items()
         if k in ("readings", "checks", "b1_routes_by_role", "phase_wall_s",
                  "max_memory_allocated_gib", "nf4_cell_tpot_p50_s")}))
    log("serve_sessions summary:", json.dumps(
        {k: v for k, v in sessions["sessions"].items()
         if k in ("checks", "phase_wall_s", "max_memory_allocated_gib",
                  "nf4_cell_tpot_p50_s")}))
    log("serve_obs summary:", json.dumps(
        {k: v for k, v in obs["obs"].items()
         if k in ("checks", "phase_wall_s", "max_memory_allocated_gib",
                  "nf4_cell_tpot_p50_s")}))
    log("serve_sched summary:", json.dumps(
        {k: v for k, v in sched["sched"].items()
         if k in ("short", "long", "profile", "capture_s", "graph_pool_mib",
                  "max_memory_allocated_gib", "wall_s")}))
    log("earlier readings, not measured in this run (PERF.md; mma.sync "
        "designs, NVIDIA H100 80GB HBM3, 700 W), ms per layer's 7 "
        f"projections at M={TRAIN_M}: {json.dumps(EARLIER_MS)}; this run: "
        + json.dumps({r["name"]: (r.get("train") or r)["ms"] for r in table
                      if r["name"] in EARLIER_MS}))
    log(json.dumps({"kernels": table}))
    log(f"total {time.monotonic() - t_start:.1f}s")
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
