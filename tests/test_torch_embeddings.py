"""PyTorch port: ``POST /v1/embeddings`` against the JAX server's handler.

The committed HF fixture in both packages (f32), a char tokenizer, the
port's server over HTTP and the JAX ``OpenAIServer.handle_embeddings``
called directly: the pooled, unit-normalized vectors agree at 1e-5 for
strings, token lists and an input longer than the cache; each vector has
unit norm, a request repeats exactly and an input's vector does not
depend on its batch; usage, the 422 bodies' statuses and the 404 equal
JAX's; an embedding request is answered while the engine serves a chat.
"""

import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import load_fixture_both

from llm_in_practise_tpu.serve.api import OpenAIServer as JaxServer
from llm_in_practise_tpu.serve.engine import InferenceEngine as JaxEngine
from llm_in_practise_tpu_torch.serve.api import OpenAIServer
from llm_in_practise_tpu_torch.serve.engine import (
    InferenceEngine,
    SamplingParams,
)

TOL = 1e-5
NAME = "embed-test"


class CharTok:
    def encode(self, text: str) -> list[int]:
        return [min(ord(c), 127) for c in text]

    def decode(self, ids) -> str:
        return "".join(chr(int(i)) if int(i) < 128 else "" for i in ids)


@pytest.fixture(scope="module")
def servers():
    jmodel, jparams, pmodel = load_fixture_both()
    jeng = JaxEngine(jmodel, jparams, max_slots=2, cache_len=64,
                     cache_dtype=jnp.float32)
    jsrv = JaxServer(jeng, CharTok(), model_name=NAME)
    eng = InferenceEngine(pmodel, max_slots=2, cache_len=64,
                          cache_dtype=torch.float32)
    srv = OpenAIServer(eng, CharTok(), model_name=NAME)
    port = srv.serve(host="127.0.0.1", port=0, background=True)
    try:
        yield srv, jsrv, f"http://127.0.0.1:{port}"
    finally:
        srv.shutdown()
        jeng.stop()


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _jax(jsrv, body):
    got = {}
    jsrv.handle_embeddings(body, lambda code, b: got.update(code=code, b=b))
    return got["code"], got["b"]


INPUTS = [
    "The quick brown fox.",
    ["a", "hello there, embeddings"],
    [[5, 6, 7, 8, 9], [100, 3]],
    ["x", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14]],
    "long " * 20,        # 100 characters: cut to the cache's 64 rows
]


@pytest.mark.parametrize("case", range(len(INPUTS)))
def test_embeddings_equal_jax(servers, case):
    _, jsrv, base = servers
    body = {"model": NAME, "input": INPUTS[case]}
    status, got = _post(base + "/v1/embeddings", body)
    jstatus, want = _jax(jsrv, body)
    assert status == jstatus == 200
    assert got["object"] == "list" and got["model"] == NAME
    assert got["usage"] == want["usage"]
    assert len(got["data"]) == len(want["data"])
    for g, w in zip(got["data"], want["data"]):
        assert g["object"] == "embedding" and g["index"] == w["index"]
        v = np.asarray(g["embedding"])
        assert v.shape == (64,)
        np.testing.assert_allclose(v, w["embedding"], rtol=TOL, atol=TOL)
        assert abs(np.linalg.norm(v) - 1.0) < 1e-9


def test_embeddings_repeat_and_do_not_depend_on_the_batch(servers):
    _, _, base = servers
    body = {"input": ["abc", "a longer sentence", [7, 8, 9]]}
    _, first = _post(base + "/v1/embeddings", body)
    _, again = _post(base + "/v1/embeddings", body)
    assert first["data"] == again["data"]
    assert first["model"] == NAME      # the server's name when none is sent
    _, alone = _post(base + "/v1/embeddings", {"input": "a longer sentence"})
    assert alone["data"][0]["embedding"] == first["data"][1]["embedding"]
    assert first["usage"] == {"prompt_tokens": 3 + 17 + 3,
                              "total_tokens": 3 + 17 + 3}


@pytest.mark.parametrize("body", [
    {"input": []}, {"input": 3}, {"input": [1.5]}, {"input": [["a"]]},
    {"input": [[1, "b"]]}, {}, {"input": None},
    {"model": "other", "input": "x"},
])
def test_bad_input_422_and_unknown_model_404_as_jax(servers, body):
    _, jsrv, base = servers
    status, got = _post(base + "/v1/embeddings", body)
    jstatus, want = _jax(jsrv, body)
    assert status == jstatus == (404 if "model" in body else 422)
    assert got["error"]["type"] == want["error"]["type"]
    assert got["error"]["message"] == want["error"]["message"]


def test_embedding_between_chat_steps(servers):
    srv, _, base = servers
    handle = srv.engine.submit([5, 6, 7], SamplingParams(greedy=True,
                                                         max_tokens=40))
    out = {}
    t = threading.Thread(target=lambda: out.update(
        r=_post(base + "/v1/embeddings", {"input": "while decoding"})))
    t.start()
    t.join(timeout=60)
    assert out["r"][0] == 200
    assert len(handle.result()) == 40
    assert len(out["r"][1]["data"][0]["embedding"]) == 64
