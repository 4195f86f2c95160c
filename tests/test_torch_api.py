"""PyTorch port: the OpenAI-compatible server on the CPU.

A tiny random Qwen3 in the port (CPU) behind the port's engine and HTTP
server, with a byte-level BPE trained in the test that keeps the ChatML
markers as special tokens; the server listens on a free local port. The
last tests serve a packed NF4 export written by the JAX package through
the port's CLI build path.
"""

import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import numpy_params, tiny_port_model

from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.models.qwen3 import qwen3_config as jax_qwen3_config
from llm_in_practise_tpu.quant import io as jax_quant_io
from llm_in_practise_tpu.quant import nf4 as jax_nf4
from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
from llm_in_practise_tpu_torch.data.sft import IM_END, IM_START
from llm_in_practise_tpu_torch.quant.io import load_packed
from llm_in_practise_tpu_torch.quant.nf4 import NF4Tensor
from llm_in_practise_tpu_torch.serve import schemas
from llm_in_practise_tpu_torch.serve.__main__ import build_parser, build_server
from llm_in_practise_tpu_torch.serve.api import OpenAIServer, build_prompt
from llm_in_practise_tpu_torch.serve.engine import InferenceEngine

CORPUS = (
    "The quick brown fox jumps over the lazy dog. A tokenizer learns merges "
    "from the text it sees; the server renders chat messages as ChatML and "
    "streams tokens back as server-sent events. Hello there, how are you? "
)
MESSAGES = [{"role": "system", "content": "You are brief."},
            {"role": "user", "content": "Hello there, quick brown fox?"}]


@pytest.fixture(scope="module")
def served():
    tok = BPETokenizer.train([CORPUS] * 4, vocab_size=320,
                             special_tokens=[IM_START, IM_END],
                             min_frequency=1)
    model = tiny_port_model(tok.get_vocab_size(), seed=11)
    engine = InferenceEngine(model, max_slots=2, cache_len=128,
                             eos_id=tok.token_to_id(IM_END),
                             cache_dtype=torch.float32)
    server = OpenAIServer(engine, tok, model_name="tiny-qwen3")
    port = server.serve(host="127.0.0.1", port=0, background=True)
    try:
        yield server, tok, f"http://127.0.0.1:{port}"
    finally:
        server.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _chat_body(**kw):
    return {"model": "tiny-qwen3", "messages": MESSAGES, "temperature": 0.0,
            "max_tokens": 8, **kw}


def test_health_and_models(served):
    _, _, base = served
    assert _get(base + "/health") == (200, {"status": "ok"})
    status, models = _get(base + "/v1/models")
    assert status == 200
    assert [m["id"] for m in models["data"]] == ["tiny-qwen3"]


def test_chat_non_stream_usage_and_finish(served):
    _, tok, base = served
    status, raw = _post(base + "/v1/chat/completions", _chat_body())
    assert status == 200
    body = json.loads(raw)
    choice = body["choices"][0]
    assert choice["message"]["role"] == "assistant"
    assert isinstance(choice["message"]["content"], str)
    assert choice["finish_reason"] in ("stop", "length")
    msgs = [schemas.ChatMessage.from_dict(m) for m in MESSAGES]
    assert body["usage"]["prompt_tokens"] == len(tok.encode(build_prompt(msgs)))
    assert 1 <= body["usage"]["completion_tokens"] <= 8
    if choice["finish_reason"] == "length":
        assert body["usage"]["completion_tokens"] == 8
        assert choice["message"]["content"]


def test_stream_deltas_concatenate_to_greedy_content(served):
    _, _, base = served
    _, raw = _post(base + "/v1/chat/completions", _chat_body())
    want = json.loads(raw)["choices"][0]
    status, raw = _post(base + "/v1/chat/completions", _chat_body(stream=True))
    assert status == 200
    lines = [ln for ln in raw.decode().split("\n") if ln.startswith("data: ")]
    assert lines[-1] == "data: [DONE]"
    events = [json.loads(ln[len("data: "):]) for ln in lines[:-1]]
    assert events[0]["choices"][0]["delta"] == {"role": "assistant"}
    text = "".join(e["choices"][0]["delta"].get("content", "")
                   for e in events)
    assert text == want["message"]["content"]
    assert events[-1]["choices"][0]["finish_reason"] == want["finish_reason"]


@pytest.mark.parametrize("extra", [
    {"tools": [{"type": "function", "function": {"name": "f"}}]},
    {"response_format": {"type": "json_object"}},
])
def test_unported_fields_get_400(served, extra):
    _, _, base = served
    status, raw = _post(base + "/v1/chat/completions", _chat_body(**extra))
    assert status == 400
    assert "not supported" in json.loads(raw)["error"]["message"]


def test_invalid_request_gets_422_and_unknown_model_404(served):
    _, _, base = served
    status, _ = _post(base + "/v1/chat/completions",
                      {"model": "tiny-qwen3", "messages": []})
    assert status == 422
    status, _ = _post(base + "/v1/chat/completions",
                      _chat_body(model="other"))
    assert status == 404


def test_cli_serves_a_packed_export_written_by_jax(tmp_path, served):
    """quant/io.py reads the JAX exporter's npz + manifest byte for byte
    (NF4 leaves and a bf16 array leaf), and the CLI's build path serves it
    on the CPU."""
    _, tok, _ = served
    jmodel = JaxQwen3(jax_qwen3_config(
        tok.get_vocab_size(), hidden_size=64, intermediate_size=128,
        n_head=4, n_kv_head=2, head_dim=16, n_layer=1, max_seq_len=128,
        compute_dtype="float32"))
    params = numpy_params(jmodel, seed=5)
    params["tok_embed"]["embedding"] = params["tok_embed"]["embedding"].astype(
        jnp.bfloat16)
    qtree = jax_nf4.quantize_tree(
        params, lambda p, leaf: p.startswith("block_") and p.endswith("kernel"))
    export = str(tmp_path / "export")
    jax_quant_io.save_packed(export, qtree, metadata={
        "config": jmodel.cfg.to_dict(), "family": "qwen3", "method": "nf4"})
    tok_path = str(tmp_path / "tok.json")
    tok.save(tok_path)

    tree, meta = load_packed(export)
    want = qtree["block_0"]["attn"]["q_proj"]["kernel"]
    got = tree["block_0"]["attn"]["q_proj"]["kernel"]
    assert isinstance(got, NF4Tensor) and got.layout == "kblock"
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(got.absmax_q.numpy(),
                                  np.asarray(want.absmax_q))
    emb = tree["tok_embed"]["embedding"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        emb.view(torch.int16).numpy(),
        np.asarray(params["tok_embed"]["embedding"]).view(np.int16))
    assert meta["config"]["hidden_size"] == 64

    server = build_server(build_parser().parse_args(
        ["--quantized_dir", export, "--tokenizer_path", tok_path,
         "--device", "cpu", "--max_slots", "2", "--cache_len", "64"]))
    assert server.engine.device == torch.device("cpu")
    out = server.engine.generate(tok.encode("Hello there"))
    assert 1 <= len(out) <= 62
    assert all(0 <= t < tok.get_vocab_size() for t in out)


def test_packed_int8_leaves_are_not_ported(tmp_path):
    from llm_in_practise_tpu.quant import int8 as jax_int8

    w = np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)
    jax_quant_io.save_packed(str(tmp_path), {"w": jax_int8.quantize(w)})
    with pytest.raises(NotImplementedError, match="item 11"):
        load_packed(str(tmp_path))
