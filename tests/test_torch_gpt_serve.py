"""PyTorch port: serving the GPT family, and the process-wide CUDA graph
capture lock (``serve/graphs.py``), against the JAX package.

- A tiny f32 GPT served by the port's ``InferenceEngine`` gives the JAX
  engine's greedy tokens and finish reasons (contiguous f32 KV, 2 slots,
  the same numpy-seeded weights).
- ``cache_len`` is clamped to the GPT's ``seq_len`` (a GPT has no
  ``max_seq_len``): a prompt plus generation never indexes past the
  learned position table.
- A GPT export written by the JAX package's own quantizers (int4 RTN of
  every block kernel, ``save_packed`` with ``family: "gpt"``) reads back
  through ``serve/__main__.py``: its biased projections become
  ``QuantizedLinear`` modules that keep their bias, the served logits
  equal JAX ``QuantizedModel``'s at 1e-2 (the bf16 rule of ROADMAP C),
  and the CLI's server answers ``/v1/chat/completions``.
- The ``quantize`` CLI's hermetic branch pretrains the 2-layer gptlike
  GPT, writes ``family: "gpt"`` with the GPT's config, and its export is
  served.
- ``CaptureLock``: a capture waits for other threads' work in flight and
  holds the gate alone; work on another thread waits while a capture is
  in flight; a thread's own work never blocks its capture; two threads
  that capture inside their work take turns; one capturing engine
  alone never waits. A capture pauses Python's cyclic garbage collector
  (fake CUDA calls), also when it fails.
"""

import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import run_jax_engine, run_port_engine

from llm_in_practise_tpu.models.gpt import GPT as JaxGPT
from llm_in_practise_tpu.models.gpt import GPTConfig as JaxGPTConfig
from llm_in_practise_tpu.quant import int4 as jax_int4
from llm_in_practise_tpu.quant import io as jax_quant_io
from llm_in_practise_tpu.serve.quantized import QuantizedModel as JaxQuantized

from llm_in_practise_tpu_torch import quantize
from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
from llm_in_practise_tpu_torch.data.sft import IM_END, IM_START
from llm_in_practise_tpu_torch.models.convert import gpt_params_from_jax
from llm_in_practise_tpu_torch.models.gpt import GPT, GPTConfig
from llm_in_practise_tpu_torch.quant.int4 import Int4Tensor
from llm_in_practise_tpu_torch.quant.io import load_packed
from llm_in_practise_tpu_torch.serve.__main__ import build_parser, build_server
from llm_in_practise_tpu_torch.serve.engine import InferenceEngine
from llm_in_practise_tpu_torch.serve.engine import SamplingParams
from llm_in_practise_tpu_torch.serve.graphs import CaptureLock
from llm_in_practise_tpu_torch.serve.quantized import (
    QuantizedLinear,
    QuantizedModel,
)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gpt_pair(vocab, seed=0, **kw):
    d = dict(vocab_size=vocab, seq_len=64, n_layer=2, n_head=2, embed_dim=64,
             dropout=0.1, tie_weights=False)
    d.update(kw)
    jm = JaxGPT(JaxGPTConfig(**d))
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if str(getattr(path[-1], "key", "")) == "scale":
            return (1 + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)["params"]
    cfg = GPTConfig(**d)
    pm = GPT(cfg, device="cpu")
    pm.load_state(gpt_params_from_jax(params, cfg))
    return jm, params, pm


def test_engine_greedy_tokens_equal_jax():
    jm, params, pm = gpt_pair(97, pos_embedding="learned")
    prompts = [[5, 9, 11, 3, 7], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]]
    want = run_jax_engine(jm, params, None, prompts, 12)
    got = run_port_engine(pm, None, prompts,
                          SamplingParams(greedy=True, max_tokens=12))
    assert got == want
    assert all(len(toks) == 12 for toks, _ in got)


def test_cache_len_is_clamped_to_seq_len():
    _, _, pm = gpt_pair(97, seq_len=24)
    eng = InferenceEngine(pm, max_slots=2, cache_len=512,
                          cache_dtype=torch.float32)
    assert eng.cache_len == 24
    # 20 prompt tokens and up to 40 new ones: the slot stops at the table
    req = eng.submit(list(range(1, 21)), SamplingParams(greedy=True,
                                                        max_tokens=40))
    while eng.step():
        pass
    toks = req.result()
    assert 1 <= len(toks) and 20 + len(toks) <= 24
    eng.stop()


def _jax_export(jm, params, path, group_size=32):
    def q(p, leaf):
        name = "/".join(str(k.key) for k in p)
        if (name.endswith("kernel") and "lm_head" not in name):
            return jax_int4.rtn_quantize(jnp.asarray(leaf),
                                         group_size=group_size)
        return leaf

    qtree = jax.tree_util.tree_map_with_path(q, params)
    jax_quant_io.save_packed(path, qtree, metadata={
        "config": jm.config.to_dict(), "family": "gpt", "method": "rtn"})
    return qtree


def _tokenizer(tmp_path):
    tok = BPETokenizer.train(["The quick brown fox jumps over the lazy dog. "
                              "Hello there, how are you? "] * 4,
                             vocab_size=300, special_tokens=[IM_START, IM_END],
                             min_frequency=1)
    path = str(tmp_path / "tok.json")
    tok.save(path)
    return tok, path


def _chat(server, content="Hello there", max_tokens=8):
    port = server.serve(host="127.0.0.1", port=0, background=True)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/chat/completions",
            data=json.dumps({"model": server.model_name,
                             "max_tokens": max_tokens,
                             "temperature": 0.0, "messages": [
                                 {"role": "user", "content": content}]
                             }).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())
    finally:
        server.shutdown()


def test_jax_gpt_export_keeps_biases_and_serves_chat(tmp_path):
    tok, tok_path = _tokenizer(tmp_path)
    jm, params, _ = gpt_pair(tok.vocab_size, seed=2, pos_embedding="learned")
    path = str(tmp_path / "export")
    qtree = _jax_export(jm, params, path)
    tree, meta = load_packed(path)
    assert meta["family"] == "gpt"
    cfg = GPTConfig.from_dict(meta["config"])
    pq = QuantizedModel(GPT(cfg, device="meta"), gpt_params_from_jax(
        tree, cfg), compute_dtype=torch.float32, device="cpu")
    linears = {n: m for n, m in pq.model.named_modules()
               if isinstance(m, QuantizedLinear)}
    assert len(linears) == 6 * cfg.n_layer
    for name, m in linears.items():
        assert isinstance(m.weight, Int4Tensor)
        np.testing.assert_array_equal(
            m.bias.detach().numpy(),
            np.asarray(params[f"block_{name.split('.')[1]}"][
                name.split(".")[2]][name.split(".")[3]]["bias"]))
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9))
    jq = JaxQuantized(jm, compute_dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda q, x: jq.apply({"params": q}, x))(
        qtree, jnp.asarray(ids)))
    with torch.inference_mode():
        got = pq(torch.from_numpy(ids)).numpy()
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= 1e-2, err
    # without the biases the logits would be far off: they are carried
    with torch.inference_mode():
        for m in linears.values():
            m.bias.zero_()
        nob = pq(torch.from_numpy(ids)).numpy()
    assert np.max(np.abs(nob - want)) / np.max(np.abs(want)) > 10 * err
    server = build_server(build_parser().parse_args(
        ["--quantized_dir", path, "--tokenizer_path", tok_path,
         "--device", "cpu", "--max_slots", "2", "--cache_len", "512"]))
    assert isinstance(server.engine.model.model, GPT)
    assert server.engine.cache_len == cfg.seq_len
    out = _chat(server)
    assert out["choices"][0]["finish_reason"] in ("stop", "length")
    assert 1 <= out["usage"]["completion_tokens"] <= 8


def test_hermetic_quantize_branch_writes_a_gpt_export(tmp_path):
    res = quantize.run(["--method", "gptq", "--out_dir", str(tmp_path),
                        "--device", "cpu"])
    assert res["family"] == "gpt"
    assert np.isfinite(res["fp_ppl"]) and np.isfinite(res["quant_ppl"])
    assert isinstance(res["passed"], bool)
    tree, meta = load_packed(res["packed_path"].rsplit("/", 1)[0])
    assert meta["family"] == "gpt" and meta["method"] == "gptq"
    cfg = GPTConfig.from_dict(meta["config"])
    assert (cfg.n_layer, cfg.embed_dim, cfg.n_head, cfg.seq_len,
            cfg.dropout, cfg.tie_weights) == (2, 128, 4, 64, 0.0, True)
    # every block kernel quantized, the embedding and position table not
    assert sorted(res["stats"]) == sorted(
        f"block_{i}/{m}/kernel" for i in range(2)
        for m in ("attn/q_proj", "attn/k_proj", "attn/v_proj",
                  "attn/out_proj", "mlp/fc_in", "mlp/fc_out"))
    assert isinstance(res["q_state"]["tok_embed.weight"], torch.Tensor)
    assert isinstance(res["q_state"]["pos_embed"], torch.Tensor)
    server = build_server(build_parser().parse_args(
        ["--quantized_dir", res["packed_path"].rsplit("/", 1)[0],
         "--tokenizer_path", res["tokenizer_path"], "--device", "cpu",
         "--max_slots", "2"]))
    assert server.engine.cache_len == 64
    out = _chat(server, "the history of the city", max_tokens=6)
    assert 1 <= out["usage"]["completion_tokens"] <= 6


# --- the capture lock ---------------------------------------------------------


class _User:
    pass


def _lock(n_users=2):
    lock = CaptureLock()
    users = [_User() for _ in range(n_users)]
    for u in users:
        lock.register(u)
    return lock, users


def test_capture_waits_for_work_in_flight_and_blocks_new_work():
    lock, _users = _lock()
    events = []
    in_work, release = threading.Event(), threading.Event()

    def worker():
        with lock.work():
            events.append("work start")
            in_work.set()
            release.wait(5)
            events.append("work end")

    t = threading.Thread(target=worker)
    t.start()
    in_work.wait(5)

    def capturer():
        with lock.capture():   # a fake capture
            events.append("capture start")
            time.sleep(0.05)
            events.append("capture end")

    c = threading.Thread(target=capturer)
    c.start()
    time.sleep(0.05)
    assert events == ["work start"]      # the capture waits
    release.set()
    t.join(5)
    time.sleep(0.01)
    late = threading.Thread(target=lambda: (lock.work().__enter__(),
                                            events.append("late work")))
    late.start()
    c.join(5)
    late.join(5)
    assert events[:4] == ["work start", "work end", "capture start",
                          "capture end"]
    assert events[4] == "late work"


def test_own_work_never_blocks_own_capture_and_two_capturers_take_turns():
    lock, _users = _lock()
    order = []

    def engine(name):
        with lock.work():            # the step
            with lock.work():        # nested: never waits
                pass
            with lock.capture():     # its first use of a variant
                order.append(f"{name} in")
                time.sleep(0.02)
                order.append(f"{name} out")

    threads = [threading.Thread(target=engine, args=(n,)) for n in "AB"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5)
    assert not any(t.is_alive() for t in threads)
    assert sorted(order) == ["A in", "A out", "B in", "B out"]
    # captures never overlap
    assert order[0][0] == order[1][0] and order[2][0] == order[3][0]
    assert lock.captures == 2


def test_one_capturing_engine_never_waits():
    lock, users = _lock(1)
    assert not lock.contended
    started = threading.Event()
    done = []

    def capturer():
        with lock.capture():
            started.set()
            time.sleep(0.1)

    c = threading.Thread(target=capturer)
    c.start()
    started.wait(5)
    t0 = time.monotonic()
    with lock.work():       # another thread: no wait with one engine
        done.append(time.monotonic() - t0)
    c.join(5)
    assert done[0] < 0.05 and lock.waits == 0
    second = _User()
    lock.register(second)
    assert lock.contended
    del second      # a collected engine leaves the count
    import gc
    gc.collect()
    assert not lock.contended


def test_capture_pauses_garbage_collection(monkeypatch):
    """A cyclic collection inside a capture, on the capturing thread, would
    destroy an unreachable engine's graphs, which invalidates the capture
    on the card: the collector is paused while the capture is open and
    resumes after it, also when the capture fails (fake CUDA calls)."""
    import contextlib
    import gc

    from llm_in_practise_tpu_torch.serve import graphs

    _, _, pm = gpt_pair(97)
    sg = graphs.StepGraphs(pm, pm.init_cache(2, 16, dtype=torch.float32),
                           max_slots=2, chunk=None, decode_steps=1,
                           capture=False)
    seen = []

    @contextlib.contextmanager
    def fake_graph(graph, pool=None, capture_error_mode="global"):
        seen.append(("begin", gc.isenabled()))
        yield
        seen.append(("end", gc.isenabled()))

    for name, fn in (("graph_pool_handle", lambda: "pool"),
                     ("synchronize", lambda *a: None),
                     ("empty_cache", lambda: None),
                     ("memory_reserved", lambda *a: 0),
                     ("CUDAGraph", lambda: object()), ("graph", fake_graph)):
        monkeypatch.setattr(torch.cuda, name, fn)

    def body(key):
        seen.append(("body", gc.isenabled()))
        if key[0] == "bad":
            raise RuntimeError("capture invalidated")
        return {}

    monkeypatch.setattr(sg, "_body", body)
    assert gc.isenabled()
    sg._capture(("decode", 1, True, None, None))
    assert seen == [("begin", False), ("body", False), ("end", False)]
    assert gc.isenabled() and ("decode", 1, True, None, None) in sg.graphs
    with pytest.raises(RuntimeError, match="capture of step variant"):
        sg._capture(("bad", 1, True, None, None))
    assert gc.isenabled()
