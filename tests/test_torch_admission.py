"""PyTorch port: the engine's admission control, its HTTP answer and the
scheduling flags of the serving CLI.

- ``max_queue``: a request that finds that many waiting is shed at
  submit, ``finish_reason == "queue_full"`` with no tokens; the others
  are served.
- ``queue_timeout_s``: the stale head of the queue is shed at the next
  step; a fresh request behind it is admitted.
- The HTTP server answers a shed request with 429 and the JAX server's
  error body (``llm_in_practise_tpu/serve/api.py``, ``queue_full_429``),
  streamed or not, for both shed paths.
- The CLI passes ``--enable-chunked-prefill``, ``--decode-steps``,
  ``--no-mixed-step``, ``--max-queue`` and ``--queue-timeout`` to the
  engine with the JAX CLI's meanings.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import pytest
import torch

from torch_port_util import numpy_params, tiny_port_model

from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.models.qwen3 import qwen3_config as jax_qwen3_config
from llm_in_practise_tpu.quant import io as jax_quant_io
from llm_in_practise_tpu.quant import nf4 as jax_nf4
from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
from llm_in_practise_tpu_torch.data.sft import IM_END, IM_START
from llm_in_practise_tpu_torch.serve.__main__ import build_parser, build_server
from llm_in_practise_tpu_torch.serve.api import OpenAIServer
from llm_in_practise_tpu_torch.serve.engine import (
    InferenceEngine,
    SamplingParams,
)

CORPUS = ("Admission control sheds a request when the queue is full; the "
          "server answers 429 and the client retries elsewhere. ")


def _queue_full_body(message):
    """The JAX server's 429 body (``serve/api.py`` ``queue_full_429``)."""
    return {"error": {
        "message": message + " — retry later or against another replica",
        "type": "rate_limit_error", "code": "queue_full"}}


@pytest.fixture(scope="module")
def tok():
    return BPETokenizer.train([CORPUS] * 4, vocab_size=300,
                              special_tokens=[IM_START, IM_END],
                              min_frequency=1)


def test_max_queue_sheds_at_submit():
    eng = InferenceEngine(tiny_port_model(64, seed=7), max_slots=1,
                          cache_len=32, cache_dtype=torch.float32,
                          max_queue=2)
    params = SamplingParams(greedy=True, max_tokens=3)
    kept = [eng.submit([1, 2, 3], params) for _ in range(2)]
    shed = eng.submit([4, 5, 6], params)
    assert shed.finish_reason == "queue_full"
    assert shed.result() == [] and shed.n_generated == 0
    assert shed.finish_time is not None and shed.first_token_time is None
    assert eng.requests_shed == 1 and eng.pending.qsize() == 2
    while eng.step():
        pass
    assert [r.finish_reason for r in kept] == ["length", "length"]
    assert all(len(r.result()) == 3 for r in kept)
    # the queue drained: a new request is accepted again
    assert eng.submit([7], params).finish_reason is None


def test_queue_timeout_sheds_the_stale_head():
    eng = InferenceEngine(tiny_port_model(64, seed=8), max_slots=2,
                          cache_len=32, cache_dtype=torch.float32,
                          queue_timeout_s=0.5)
    params = SamplingParams(greedy=True, max_tokens=2)
    stale, fresh = (eng.submit([1, 2, 3], params) for _ in range(2))
    stale.submit_time -= 5.0        # waited far past the deadline
    eng.step()
    assert stale.finish_reason == "queue_full" and stale.result() == []
    assert eng.requests_shed == 1
    assert fresh.first_token_time is not None
    while eng.step():
        pass
    assert fresh.finish_reason == "length" and len(fresh.result()) == 2


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("stream", [False, True])
def test_http_429_on_a_full_queue_and_on_a_timeout(tok, stream):
    model = tiny_port_model(tok.get_vocab_size(), seed=9)
    engine = InferenceEngine(model, max_slots=1, cache_len=64,
                             eos_id=tok.token_to_id(IM_END),
                             cache_dtype=torch.float32, max_queue=1)
    server = OpenAIServer(engine, tok, model_name="tiny")
    port = server.serve(host="127.0.0.1", port=0, background=True)
    url = f"http://127.0.0.1:{port}/v1/chat/completions"
    body = {"model": "tiny", "max_tokens": 4, "temperature": 0.0,
            "stream": stream, "messages": [{"role": "user",
                                            "content": "queue full?"}]}
    try:
        with engine._lock:          # the engine loop cannot admit
            waiting = engine.submit([1, 2, 3],
                                    SamplingParams(greedy=True, max_tokens=2))
            status, raw = _post(url, body)
            assert status == 429
            assert json.loads(raw) == _queue_full_body("engine queue full")
            # now the timeout path: the waiting request goes stale
            engine.queue_timeout_s = 0.05
            engine.max_queue = None
            result = {}
            t = threading.Thread(
                target=lambda: result.update(r=_post(url, body)))
            t.start()
            time.sleep(0.3)
        t.join(timeout=60)
        status, raw = result["r"]
        assert status == 429
        assert json.loads(raw) == _queue_full_body(
            "request timed out waiting for a slot")
        assert waiting.finish_reason == "queue_full"
        assert engine.requests_shed == 3
    finally:
        server.shutdown()


def test_cli_passes_the_scheduling_flags(tmp_path, tok):
    jmodel = JaxQwen3(jax_qwen3_config(
        tok.get_vocab_size(), hidden_size=64, intermediate_size=128,
        n_head=4, n_kv_head=2, head_dim=16, n_layer=1, max_seq_len=128,
        compute_dtype="float32"))
    qtree = jax_nf4.quantize_tree(
        numpy_params(jmodel, seed=6),
        lambda p, leaf: p.startswith("block_") and p.endswith("kernel"))
    export = str(tmp_path / "export")
    jax_quant_io.save_packed(export, qtree, metadata={
        "config": jmodel.cfg.to_dict(), "family": "qwen3", "method": "nf4"})
    tok_path = str(tmp_path / "tok.json")
    tok.save(tok_path)
    base = ["--quantized_dir", export, "--tokenizer_path", tok_path,
            "--device", "cpu", "--max_slots", "2", "--cache_len", "64"]

    engine = build_server(build_parser().parse_args(base)).engine
    assert (engine.chunked_prefill, engine.decode_steps, engine.mixed_step,
            engine.max_queue, engine.queue_timeout_s) == (
                None, 1, True, None, None)
    engine = build_server(build_parser().parse_args(base + [
        "--enable-chunked-prefill", "--decode-steps", "4",
        "--no-mixed-step", "--max-queue", "3",
        "--queue-timeout", "2.5"])).engine
    assert (engine.chunked_prefill, engine.decode_steps, engine.mixed_step,
            engine.max_queue, engine.queue_timeout_s) == (
                256, 4, False, 3, 2.5)
    engine = build_server(build_parser().parse_args(
        base + ["--enable-chunked-prefill", "16", "--decode-steps", "4"]
    )).engine
    assert (engine.chunked_prefill, engine.decode_steps) == (16, 4)
    # the built engine serves with them: a 39-token prompt in 3 chunks
    # (the CLI's default paged layout runs every chunk as the batched
    # chunk over all slots, as the JAX paged engine does), then two
    # blocks of 4 decode steps (a block shrinks to the soonest finish
    # only while requests queue; no EOS: random weights could stop the
    # stream anywhere)
    engine.eos_id = None
    out = engine.generate(list(range(1, 40)),
                          SamplingParams(greedy=True, max_tokens=6))
    assert engine.paged is not None
    assert len(out) == 6 and engine.chunk_batches_run == 3
    assert (engine.multi_blocks, engine.decode_steps_run) == (2, 8)
