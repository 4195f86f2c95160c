"""PyTorch port: the per-step host timeline (``obs/steptrace.py``) and the
request critical path, wired through the port's engine and server.

- The recorder's contracts of ``tests/test_steptrace.py`` on the port's
  copy: the ring bound, nested scopes pausing the outer one, device time
  deducted from the enclosing activity, the disabled recorder inert,
  every activity in the snapshot from birth.
- The live engine on the committed HF fixture: every step record is a
  partition (activities + device == wall) and coverage >= 0.95 in both
  KV layouts; a spec round books ``draft_propose``; the recorder off
  (``LLM_TPU_STEPTRACE=off``) gives the same greedy tokens, and so does
  swapping the recorder and the tracer off on one engine; the ``/metrics``
  families strict-parse with live values; TTFT carries the admission's
  cache label; ``GET /debug/requests``' segments sum to each request's
  wall time; the Perfetto export has both lanes.
- Lockstep with the JAX engine on the same traffic: the same number of
  recorded steps, the same dispatches per step and the same set of
  activities with time in each step.
"""

import json
import time
import urllib.request

import jax.numpy as jnp
import pytest
import torch

from promparse import parse_exposition
from torch_port_util import load_fixture_both

from llm_in_practise_tpu.serve.engine import InferenceEngine as JaxEngine
from llm_in_practise_tpu.serve.engine import SamplingParams as JaxParams
from llm_in_practise_tpu_torch.obs.steptrace import (
    ACTIVITIES,
    DEVICE_LANE_TID,
    HOST_LANE_TID,
    StepTrace,
)
from llm_in_practise_tpu_torch.obs.trace import Tracer, new_context
from llm_in_practise_tpu_torch.serve.api import OpenAIServer
from llm_in_practise_tpu_torch.serve.engine import (
    InferenceEngine,
    SamplingParams,
)

torch.set_num_threads(1)

ENGINE_KW = dict(max_slots=4, cache_len=64, chunked_prefill=8,
                 decode_steps=2, kv_page_size=8)
SHORT = ([3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8])
LONG = [(i * 7 + 3) % 160 for i in range(40)]
# longer than the chunk: the JAX engine counts a one-shot prefill as two
# programs (prefill and insert), the port as one dispatch
PROMPTS = [[(i * 7 + j * 3 + 5) % 160 for i in range(20 + 4 * j)]
           for j in range(4)]


class _Tok:
    def encode(self, text):
        return [ord(c) % 160 for c in text][-40:]

    def decode(self, ids):
        return "".join(chr(97 + int(i) % 26) for i in ids)


@pytest.fixture(scope="module")
def fixture_models():
    return load_fixture_both()


def _engine(fixture_models, **kw):
    for k, v in ENGINE_KW.items():
        kw.setdefault(k, v)
    kw.setdefault("cache_dtype", torch.float32)
    return InferenceEngine(fixture_models[2], **kw)


def _run_mixed_load(eng, max_tokens=16):
    sp = SamplingParams(greedy=True, max_tokens=max_tokens)
    h = [eng.submit(p, sp) for p in SHORT]
    eng.step()
    hl = eng.submit(LONG, SamplingParams(greedy=True, max_tokens=8))
    while eng.step():
        pass
    return [r.result() for r in (*h, hl)]


# --- the recorder ------------------------------------------------------------


def test_ring_bound():
    st = StepTrace(capacity=16, enabled=True)
    for _ in range(50):
        st.step_begin()
        with st.scope("admit"):
            pass
        st.step_end()
    assert len(st) == 16
    assert st.snapshot()["steps"] == 50


def test_scope_nesting_pauses_outer_and_device_deducts():
    st = StepTrace(enabled=True)
    st.step_begin()
    with st.scope("admit"):
        time.sleep(0.02)
        with st.scope("index_build"):
            time.sleep(0.02)
        time.sleep(0.02)
        st.note_device(0.02)
    rec = st.step_end()
    acts = rec["activities"]
    assert 0.01 < acts["index_build"] < 0.2
    assert 0.01 < acts["admit"] < 0.2
    assert acts["admit"] + acts["index_build"] < rec["wall_s"]
    assert rec["device_s"] == pytest.approx(0.02)
    assert (sum(acts.values()) + rec["device_s"]
            == pytest.approx(rec["wall_s"], rel=1e-6, abs=1e-6))


def test_disabled_recorder_is_inert():
    st = StepTrace(enabled=False)
    st.step_begin()
    with st.scope("admit"):
        st.note_device(1.0)
    assert st.step_end() is None
    assert len(st) == 0 and st.snapshot()["steps"] == 0
    assert set(StepTrace(enabled=True).snapshot()["host_seconds"]) \
        == set(ACTIVITIES)


# --- the live engine ---------------------------------------------------------


@pytest.mark.parametrize("kv_layout", ["contiguous", "paged"])
def test_every_step_is_a_partition_with_coverage(fixture_models, kv_layout):
    eng = _engine(fixture_models, kv_layout=kv_layout)
    try:
        _run_mixed_load(eng)
        recs = eng.steptrace.records()
        assert recs
        for rec in recs:
            total = sum(rec["activities"].values()) + rec["device_s"]
            assert total == pytest.approx(rec["wall_s"], rel=1e-6, abs=1e-6)
            assert 0.0 <= rec["device_s"] <= rec["wall_s"]
        snap = eng.steptrace.snapshot()
        assert snap["coverage"] >= 0.95
        assert snap["device_busy_fraction"] + snap["host_gap_fraction"] \
            == pytest.approx(1.0)
        for must in ("admit", "dispatch_wait", "sample_commit", "plan"):
            assert snap["host_seconds"][must] > 0.0, must
        # one booking per dispatch window, a fused step's two phases apart
        phases = eng.dispatch_meter.phase_snapshot()
        assert set(phases) == {"prefill", "decode"}
        assert eng.dispatch_meter.total == sum(
            r["dispatches"] for r in recs) - eng.mixed_blocks
    finally:
        eng.stop()


def test_spec_round_records_draft_propose(fixture_models):
    eng = _engine(fixture_models, speculative_k=3, decode_steps=1,
                  chunked_prefill=None)
    try:
        req = eng.submit([5, 9, 2, 6, 5, 9, 2, 6, 5, 9, 2, 6],
                         SamplingParams(greedy=True, max_tokens=24))
        while eng.step():
            pass
        req.result()
        assert eng.spec_rounds > 0
        assert eng.steptrace.snapshot()["host_seconds"]["draft_propose"] > 0
    finally:
        eng.stop()


def test_recorder_off_golden_parity(fixture_models, monkeypatch):
    on = _engine(fixture_models)
    out_on = _run_mixed_load(on)
    monkeypatch.setenv("LLM_TPU_STEPTRACE", "off")
    off = _engine(fixture_models)
    out_off = _run_mixed_load(off)
    assert not off.steptrace.enabled
    assert len(off.steptrace) == 0 and off.steptrace.snapshot()["steps"] == 0
    assert out_on == out_off
    # the planes swapped off and on again on ONE engine (no second
    # capture of any graph on the card): the same streams
    on.steptrace = StepTrace(enabled=False)
    on.tracer = Tracer(enabled=False)
    assert _run_mixed_load(on) == out_on
    on.steptrace = StepTrace(enabled=True)
    on.tracer = Tracer(enabled=True)
    assert _run_mixed_load(on) == out_on
    assert len(on.steptrace) > 0
    for eng in (on, off):
        eng.stop()


def test_metrics_families_strict_parse_live(fixture_models):
    eng = _engine(fixture_models)
    try:
        _run_mixed_load(eng)
        srv = OpenAIServer(eng, _Tok(), model_name="steptrace-test")
        fams = parse_exposition(srv.metrics_text())
    finally:
        eng.stop()
    gap = fams["llm_host_gap_seconds_total"]
    assert {dict(k[1])["activity"] for k in gap.samples} == set(ACTIVITIES)
    assert sum(gap.samples.values()) > 0
    assert next(iter(fams["llm_step_wall_seconds_total"]
                     .samples.values())) > 0
    steps = next(iter(fams["llm_engine_steps_total"].samples.values()))
    assert steps == eng.steptrace.snapshot()["steps"] > 0
    fv = next(iter(fams["llm_host_gap_fraction"].samples.values()))
    bv = next(iter(fams["llm_device_busy_fraction"].samples.values()))
    assert 0.0 <= fv <= 1.0 and 0.0 <= bv <= 1.0
    assert fv + bv == pytest.approx(1.0)
    segs = {dict(k[1])["segment"]: v for k, v in
            fams["llm_request_critical_path_seconds_total"].samples.items()}
    assert segs["decode_dispatch"] > 0 and segs["prefill_dispatch"] > 0
    ttft = fams["llm_ttft_seconds"]
    assert ttft.samples[("llm_ttft_seconds_count",
                         frozenset({("cache", "cold")}))] == 3
    assert ttft.samples[("llm_ttft_seconds_count", frozenset())] == 3
    assert next(v for k, v in fams["llm_dispatches_total"].samples.items()) \
        == eng.dispatch_meter.total
    tpd = {dict(k[1])["phase"] for k in
           fams["llm_dispatch_tokens_per_dispatch"].samples}
    assert tpd == {"prefill", "decode"}
    # the CPU has no data-sheet peak: the utilization gauges carry no
    # samples, their families stay registered
    assert fams["llm_dispatch_mfu"].samples == {}
    assert fams["llm_dispatch_hbm_bw_util"].samples == {}


def test_ttft_cache_labels_hit_and_cold(fixture_models):
    eng = _engine(fixture_models, prefix_cache=True, chunked_prefill=None)
    try:
        sp = SamplingParams(greedy=True, max_tokens=4)
        prompt = [7] * 24
        r1 = eng.submit(prompt, sp)
        while eng.step():
            pass
        r1.result()
        r2 = eng.submit(prompt, sp)
        while eng.step():
            pass
        r2.result()
        assert (r1.cache_outcome, r2.cache_outcome) == ("cold", "hit")
        assert eng.stats.ttft_by_cache["cold"].count == 1
        assert eng.stats.ttft_by_cache["hit"].count == 1
    finally:
        eng.stop()


def test_debug_requests_breakdown_sums_to_wall(fixture_models):
    eng = _engine(fixture_models)
    srv = OpenAIServer(eng, _Tok(), model_name="steptrace-test")
    port = srv.serve(host="127.0.0.1", port=0, background=True)
    try:
        for stream in (True, False):
            body = json.dumps({
                "model": "steptrace-test", "max_tokens": 8,
                "temperature": 0.0, "stream": stream,
                "messages": [{"role": "user",
                              "content": "hello host gap " * 3}]}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/chat/completions", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                resp.read()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/requests",
                timeout=30) as resp:
            payload = json.loads(resp.read().decode())
    finally:
        srv.shutdown()
    assert payload["capacity"] == 128
    assert len(payload["finished"]) == 2
    for rec in payload["finished"]:
        segs = rec["segments"]
        engine_sum = sum(v for k, v in segs.items() if k != "stream_flush")
        assert engine_sum == pytest.approx(rec["wall_s"], rel=1e-2,
                                           abs=2e-5)
        assert all(v >= 0 for v in segs.values())
        assert rec["cache"] == "cold"
        assert segs["prefill_dispatch"] > 0 and segs["decode_dispatch"] > 0
    assert any("stream_flush" in r["segments"] for r in payload["finished"])
    agg = payload["critical_path_seconds_total"]
    assert agg["decode_dispatch"] > 0 and agg["stream_flush"] >= 0


def test_perfetto_dual_lane(fixture_models, tmp_path):
    path = tmp_path / "steptrace.jsonl"
    tracer = Tracer(enabled=True, trace_file=str(path))
    eng = _engine(fixture_models, tracer=tracer)
    try:
        _run_mixed_load(eng)
    finally:
        tracer.set_trace_file(None)
        eng.stop()
    lanes = {"host": 0, "device": 0}
    names, meta = set(), set()
    with open(path, encoding="utf-8") as f:
        for line in f:
            ev = json.loads(line)
            if ev.get("ph") == "M":
                meta.add(ev["args"]["name"])
            if ev.get("cat") != "steptrace" or ev.get("ph") != "X":
                continue
            if ev["tid"] == HOST_LANE_TID:
                lanes["host"] += 1
                names.add(ev["name"])
            elif ev["tid"] == DEVICE_LANE_TID:
                lanes["device"] += 1
    assert lanes["host"] > 0 and lanes["device"] > 0
    assert {"engine host lane", "device lane"} <= meta
    assert {"admit", "dispatch_wait"} <= names


# --- lockstep with the JAX engine --------------------------------------------


def _nonzero(rec) -> frozenset:
    return frozenset(a for a, v in rec["activities"].items() if v > 0)


def test_steps_dispatches_and_activities_equal_jax(fixture_models):
    jmodel, jparams, pmodel = fixture_models
    kw = dict(max_slots=4, cache_len=64, chunked_prefill=8, decode_steps=2)
    jeng = JaxEngine(jmodel, jparams, cache_dtype=jnp.float32, **kw)
    peng = InferenceEngine(pmodel, cache_dtype=torch.float32, **kw)
    jsp, psp = (JaxParams(greedy=True, max_tokens=6),
                SamplingParams(greedy=True, max_tokens=6))
    jh, ph = [], []
    try:
        for step in range(200):
            if step in (0, 2):
                for p in PROMPTS[step: step + 2]:
                    jh.append(jeng.submit(p, jsp))
                    ph.append(peng.submit(p, psp))
            jbusy, pbusy = jeng.step(), peng.step()
            assert jbusy == pbusy, step
            assert (peng.dispatch_meter.last_step
                    == jeng.dispatch_meter.last_step), step
            if not jbusy and step > 2:
                break
        assert [r.result() for r in jh] == [r.result() for r in ph]
        jrecs, precs = jeng.steptrace.records(), peng.steptrace.records()
        assert len(precs) == len(jrecs) > 4
        assert [r["dispatches"] for r in precs] == \
            [r["dispatches"] for r in jrecs]
        assert peng.dispatch_meter.steps == jeng.dispatch_meter.steps
        assert [_nonzero(r) for r in precs] == [_nonzero(r) for r in jrecs]
        assert peng.dispatch_meter.total == jeng.dispatch_meter.total
        assert peng.mixed_blocks == jeng.mixed_blocks > 0
    finally:
        jeng.stop()
        peng.stop()


def test_traced_requests_cover_each_critical_path_segment(fixture_models):
    """A traced request's span durations and its critical path agree on
    what the engine booked: one ``engine.prefill_chunk`` span per chunk
    dispatch, whose durations sum to the request's ``prefill_dispatch``
    segment."""
    tr = Tracer(capacity=512, enabled=True)
    eng = _engine(fixture_models, tracer=tr)
    try:
        ctx = new_context()
        req = eng.submit(PROMPTS[3], SamplingParams(greedy=True,
                                                    max_tokens=4),
                         trace=ctx)
        while eng.step():
            pass
        req.result()
    finally:
        eng.stop()
    chunks = [s for s in tr.trace(ctx.trace_id)
              if s["name"] == "engine.prefill_chunk"]
    assert len(chunks) == -(-len(PROMPTS[3]) // 8)
    assert sum(s["duration_s"] for s in chunks) == pytest.approx(
        req.cp["prefill_dispatch"], rel=1e-6)
