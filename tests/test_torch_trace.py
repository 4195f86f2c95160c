"""PyTorch port: the request tracer (``obs/trace.py``) and its wiring
through the engine and the HTTP server, against the JAX package.

- The tracer's contracts of ``tests/test_trace.py`` on the port's copy:
  the ``traceparent`` round trip, nesting, the bounded ring, a bad trace
  file failing open, the disabled tracer, the Chrome JSONL sink.
- Lockstep: the same seeded traffic through the JAX engine and the port's
  engine on the committed HF fixture records, per request, the same span
  names, parent links and attribute keys (and the same non-timing
  attribute values); durations differ.
- HTTP: a client's ``traceparent`` is adopted (``api.chat`` parents to its
  span, the engine's spans to ``api.chat``), ``GET /debug/traces``
  serves the ring, and a prefill -> decode hop over ``LocalHandoff``
  joins one trace across two replicas' rings.
"""

import json
import urllib.request

import jax.numpy as jnp
import pytest
import torch

from torch_port_util import load_fixture_both

from llm_in_practise_tpu.obs import trace as jtrace
from llm_in_practise_tpu.serve.engine import InferenceEngine as JaxEngine
from llm_in_practise_tpu.serve.engine import SamplingParams as JaxParams
from llm_in_practise_tpu_torch.obs.trace import (
    TraceContext,
    Tracer,
    format_traceparent,
    new_context,
    parse_traceparent,
)
from llm_in_practise_tpu_torch.serve.api import OpenAIServer
from llm_in_practise_tpu_torch.serve.disagg import LocalHandoff
from llm_in_practise_tpu_torch.serve.engine import (
    InferenceEngine,
    SamplingParams,
)

torch.set_num_threads(1)

# prompts longer than the chunk: every one chunk-prefills in both engines
PROMPTS = [[(i * 7 + j * 3 + 5) % 160 for i in range(20 + 4 * j)]
           for j in range(4)]
NEW = 6
ENGINE_KW = dict(max_slots=4, cache_len=64, chunked_prefill=8,
                 decode_steps=2)
# attribute values that do not depend on timing or on the uid counter
STABLE_ATTRS = ("slot", "path", "prompt_tokens", "chunk_tokens", "done",
                "batched", "fused", "tokens", "finish_reason")


class _Tok:
    """Character ids below the fixture's vocabulary of 160."""

    def encode(self, text):
        return [ord(c) % 160 for c in text][-40:]

    def decode(self, ids):
        return "".join(chr(97 + int(i) % 26) for i in ids)


@pytest.fixture(scope="module")
def fixture_models():
    return load_fixture_both()


# --- the tracer's own contracts (tests/test_trace.py) ------------------------


def test_traceparent_round_trip_and_strict_parse():
    ctx = new_context()
    assert parse_traceparent(format_traceparent(ctx)) == ctx
    assert parse_traceparent(None) is None
    assert parse_traceparent("garbage") is None
    assert parse_traceparent("00-" + "0" * 32 + "-" + "1" * 16 + "-01") \
        is None
    assert parse_traceparent("00-" + "a" * 32 + "-" + "0" * 16 + "-01") \
        is None
    # the JAX parser reads the port's header and the port reads JAX's
    assert jtrace.parse_traceparent(format_traceparent(ctx)).trace_id \
        == ctx.trace_id
    jctx = jtrace.new_context()
    assert parse_traceparent(jtrace.format_traceparent(jctx)) == \
        TraceContext(jctx.trace_id, jctx.span_id)


def test_span_nesting_shares_trace_and_parents():
    tr = Tracer(capacity=16, enabled=True)
    with tr.span("root") as root:
        with tr.span("child", parent=root) as child:
            assert child.trace_id == root.trace_id
            assert child.parent_id == root.span_id
    spans = tr.spans()
    assert {s["name"] for s in spans} == {"root", "child"}
    assert all(s["duration_s"] >= 0 for s in spans)


def test_ring_buffer_is_bounded():
    tr = Tracer(capacity=8, enabled=True)
    for i in range(100):
        tr.record(f"s{i}", duration_s=0.001)
    assert len(tr.spans()) == 8
    assert tr.summary()["spans_recorded"] == 100


def test_bad_trace_file_fails_open(tmp_path):
    tr = Tracer(capacity=8, enabled=True,
                trace_file=str(tmp_path / "missing" / "dir" / "t.jsonl"))
    tr.record("survives", duration_s=0.001)
    assert [s["name"] for s in tr.spans()] == ["survives"]
    assert not tr.has_file_sink and tr.file_sink_path is None


def test_disabled_tracer_records_nothing_and_passes_context_through():
    tr = Tracer(enabled=False)
    ctx = TraceContext("ab" * 16, "cd" * 8)
    sp = tr.start_span("x", parent=ctx)
    sp.end()
    assert sp.context() == ctx
    assert tr.spans() == [] and tr.summary()["spans_recorded"] == 0
    # nested no-op spans unwrap to the context (or None), never leak
    root = tr.start_span("api.chat")
    assert tr.start_span("handoff.claim", parent=root).context() is None
    child = tr.start_span("handoff.claim",
                          parent=tr.start_span("api.chat", parent=ctx))
    assert child.context() == ctx
    live = Tracer(enabled=True, capacity=4)
    sp = live.start_span("api.chat", parent=child)
    assert sp.trace_id == ctx.trace_id and sp.parent_id == ctx.span_id
    sp.end()


def test_chrome_trace_jsonl_sink(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    tr = Tracer(enabled=True, trace_file=path)
    with tr.span("op", op_kind="test"):
        pass
    tr.set_trace_file(None)
    lines = [json.loads(line) for line in open(path, encoding="utf-8")
             if line.strip()]
    assert len(lines) == 1
    ev = lines[0]
    assert ev["ph"] == "X" and ev["name"] == "op" and ev["dur"] >= 0
    assert ev["args"]["op_kind"] == "test" and "trace_id" in ev["args"]


# --- lockstep with the JAX engine --------------------------------------------


def _per_request(spans, ctx) -> list:
    """A request's spans as comparable rows: name, whether it parents to
    the request's context, its sorted attribute keys and stable values."""
    rows = []
    for s in spans:
        if s["trace_id"] != ctx.trace_id:
            continue
        attrs = s["attrs"]
        rows.append((s["name"], s["parent_id"] == ctx.span_id,
                     tuple(sorted(attrs)),
                     tuple((k, attrs[k]) for k in STABLE_ATTRS if k in attrs)))
    return sorted(rows, key=repr)


def test_engine_spans_equal_jax_in_lockstep(fixture_models):
    jmodel, jparams, pmodel = fixture_models
    jtr = jtrace.Tracer(capacity=1024, enabled=True)
    ptr = Tracer(capacity=1024, enabled=True)
    jeng = JaxEngine(jmodel, jparams, cache_dtype=jnp.float32, tracer=jtr,
                     **ENGINE_KW)
    peng = InferenceEngine(pmodel, cache_dtype=torch.float32, tracer=ptr,
                           **ENGINE_KW)
    jsp, psp = (JaxParams(greedy=True, max_tokens=NEW),
                SamplingParams(greedy=True, max_tokens=NEW))
    ctxs = [new_context() for _ in PROMPTS]
    jh, ph = [], []

    def submit(i):
        jh.append(jeng.submit(PROMPTS[i], jsp, trace=jtrace.TraceContext(
            ctxs[i].trace_id, ctxs[i].span_id)))
        ph.append(peng.submit(PROMPTS[i], psp, trace=ctxs[i]))

    try:
        submit(0)
        submit(1)
        for step in range(200):
            if step == 2:
                submit(2)
                submit(3)
            jbusy, pbusy = jeng.step(), peng.step()
            assert jbusy == pbusy, step
            if not jbusy and step > 2:
                break
        assert [r.result() for r in jh] == [r.result() for r in ph]
        for ctx in ctxs:
            jrows = _per_request(jtr.spans(), ctx)
            prows = _per_request(ptr.spans(), ctx)
            assert prows == jrows, ctx
            names = [r[0] for r in prows]
            assert {"engine.queue_wait", "engine.admit",
                    "engine.decode"} <= set(names)
            assert names.count("engine.prefill_chunk") >= 3
            assert all(r[1] for r in prows)   # every span under the request
    finally:
        jeng.stop()
        peng.stop()


def test_untraced_requests_record_no_spans(fixture_models):
    tr = Tracer(capacity=64, enabled=True)
    eng = InferenceEngine(fixture_models[2], cache_dtype=torch.float32,
                          tracer=tr, **ENGINE_KW)
    try:
        eng.generate(PROMPTS[0], SamplingParams(greedy=True, max_tokens=4))
        assert tr.spans() == []
    finally:
        eng.stop()


# --- over HTTP ----------------------------------------------------------------


def _post(port, path, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read().decode()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read().decode())


CHAT = {"model": "trace-test", "max_tokens": 5, "temperature": 0.0,
        "messages": [{"role": "user", "content": "where does the time go"}]}


def test_client_traceparent_is_adopted_over_http(fixture_models):
    tr = Tracer(capacity=256, enabled=True)
    eng = InferenceEngine(fixture_models[2], cache_dtype=torch.float32,
                          tracer=tr, **ENGINE_KW)
    srv = OpenAIServer(eng, _Tok(), model_name="trace-test")
    port = srv.serve(host="127.0.0.1", port=0, background=True)
    try:
        client = new_context()
        for stream in (False, True):
            status, _ = _post(port, "/v1/chat/completions",
                              dict(CHAT, stream=stream),
                              {"traceparent": format_traceparent(client)})
            assert status == 200
        payload = _get(port, "/debug/traces")
    finally:
        srv.shutdown()
    assert payload["summary"]["spans_recorded"] >= 8
    (ours,) = [t for t in payload["traces"]
               if t["trace_id"] == client.trace_id]
    roots = [s for s in ours["spans"] if s["name"] == "api.chat"]
    assert len(roots) == 2
    assert all(r["parent_id"] == client.span_id for r in roots)
    root_ids = {r["span_id"] for r in roots}
    engine = [s for s in ours["spans"] if s["name"].startswith("engine.")]
    assert {s["name"] for s in engine} >= {
        "engine.queue_wait", "engine.admit", "engine.prefill_chunk",
        "engine.decode"}
    assert all(s["parent_id"] in root_ids for s in engine)
    flush = [s for s in ours["spans"] if s["name"] == "api.stream_flush"]
    assert len(flush) == 1 and flush[0]["parent_id"] in root_ids
    assert {r["attrs"]["finish_reason"] for r in roots} <= {"stop", "length"}


def test_prefill_decode_hop_joins_one_trace(fixture_models):
    store = LocalHandoff()
    ptr, dtr = Tracer(capacity=256), Tracer(capacity=256)
    for t in (ptr, dtr):
        t.enabled = True
    pre = InferenceEngine(fixture_models[2], cache_dtype=torch.float32,
                          role="prefill", handoff=store, tracer=ptr,
                          **ENGINE_KW)
    dec = InferenceEngine(fixture_models[2], cache_dtype=torch.float32,
                          role="decode", handoff=store, tracer=dtr,
                          **ENGINE_KW)
    psrv = OpenAIServer(pre, _Tok(), model_name="trace-test",
                        role="prefill")
    dsrv = OpenAIServer(dec, _Tok(), model_name="trace-test", role="decode")
    pport = psrv.serve(host="127.0.0.1", port=0, background=True)
    dport = dsrv.serve(host="127.0.0.1", port=0, background=True)
    try:
        client = new_context()
        tp = format_traceparent(client)
        status, body = _post(pport, "/internal/handoff/prefill", CHAT,
                             {"traceparent": tp})
        assert status == 200
        hid = json.loads(body)["handoff_id"]
        # the router rides the trace along in the handoff body (no header)
        status, _ = _post(dport, "/v1/chat/completions", dict(
            CHAT, kv_transfer_params={"handoff_id": hid, "trace": tp}))
        assert status == 200
        assert dec.kv_admitted == 1 and dec.local_prefills == 0
    finally:
        psrv.shutdown()
        dsrv.shutdown()
    pnames = {s["name"] for s in ptr.trace(client.trace_id)}
    dnames = {s["name"] for s in dtr.trace(client.trace_id)}
    assert {"api.prefill", "engine.admit", "handoff.publish"} <= pnames
    assert {"api.chat", "handoff.claim", "engine.decode"} <= dnames
    assert "handoff.claim" not in pnames and "handoff.publish" not in dnames
    (claim,) = [s for s in dtr.trace(client.trace_id)
                if s["name"] == "handoff.claim"]
    assert claim["attrs"]["found"] is True
