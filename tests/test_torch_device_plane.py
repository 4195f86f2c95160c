"""PyTorch port: the device plane (``obs/cost.py``, ``obs/meter.py``,
``obs/prof.py``), the build identity (``obs/buildinfo.py``) and the debug
aids (``obs/debug.py``), against the JAX package where it has the same
arithmetic.

- The cost model's FLOPs and bytes equal JAX's for the committed HF
  fixture and for a Qwen3-8B geometry (no weights): ``step_flops``,
  ``step_bytes``, ``chunk_keys``, ``block_keys``, ``matmul_param_count``,
  ``flops_per_token``; MFU and bandwidth use under the same explicit
  peaks.
- ``weight_bytes`` (the port's ``tree_bytes`` of the served module)
  against JAX's ``tree_bytes`` of the NF4, int4 and int8 packed trees:
  equal, byte for byte.
- No data-sheet peak on the CPU: ``chip_peak()`` is None and the
  utilization gauges carry no samples; an H100's name resolves to the
  data sheet's 989e12 FLOP/s and 3.35e12 B/s.
- ``GoodputMeter`` / ``register_goodput`` and ``DispatchMeter`` give
  JAX's snapshots and samples for one scripted sequence of observations.
- ``CompileMeter``: graph captures and kernel builds; ``ProfilerCapture``
  on the CPU (a gzipped Chrome trace, 409 while another capture or a
  ``profile_trace`` holds the profiler, over HTTP on the model server and
  the pool's metrics port); ``build_info``.
- ``enable_debug`` / ``disable_debug`` and ``seed_everything`` against
  the contracts of ``tests/test_ops.py``'s ``TestDebug``; a NaN served by
  an engine is trapped while debug is on.
"""

import dataclasses
import gzip
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promparse import parse_exposition
from torch_port_util import load_fixture_both, numpy_params

from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.models.qwen3 import Qwen3Config as JaxQwen3Config
from llm_in_practise_tpu.models.qwen3 import qwen3_config as jax_qwen3_config
from llm_in_practise_tpu.obs import cost as jcost
from llm_in_practise_tpu.obs import meter as jmeter
from llm_in_practise_tpu.obs import trace as jtrace
from llm_in_practise_tpu.obs.registry import Registry as JaxRegistry
from llm_in_practise_tpu.peft.qlora import quantize_base_lowmem
from llm_in_practise_tpu.quant import int4 as jax_int4
from llm_in_practise_tpu.quant import int8 as jax_int8
from llm_in_practise_tpu.quant import io as jax_quant_io
from llm_in_practise_tpu.utils.tree import path_str
import llm_in_practise_tpu_torch
from llm_in_practise_tpu_torch.models.convert import params_from_jax
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
from llm_in_practise_tpu_torch.obs import buildinfo, cost, debug, meter, prof
from llm_in_practise_tpu_torch.obs.registry import Registry
from llm_in_practise_tpu_torch.obs.trace import TraceContext, Tracer
from llm_in_practise_tpu_torch.quant.io import load_packed
from llm_in_practise_tpu_torch.serve.api import OpenAIServer
from llm_in_practise_tpu_torch.serve.engine import (
    EngineDeadError,
    InferenceEngine,
    SamplingParams,
)
from llm_in_practise_tpu_torch.serve.kv_pool import KVPoolServer
from llm_in_practise_tpu_torch.serve.quantized import QuantizedModel

torch.set_num_threads(1)

QWEN3_8B = dict(vocab_size=151936, hidden_size=4096, intermediate_size=12288,
                n_layer=36, n_head=32, n_kv_head=8, head_dim=128,
                tie_word_embeddings=True)
# (new tokens, attended keys) and (weight passes, KV-read tokens, new
# tokens): a decode step, an 8-step block over 8 slots, a prefill chunk
FLOP_CASES = ((1, 1.0), (64, 2080.0), (256, 32896.0), (8, 3000.0))
BYTE_CASES = ((1, 512, 1), (8, 4096, 64), (1, 32896, 256))
PEAK_FLOPS, PEAK_BW = 1e12, 1e11


class _Tok:
    def encode(self, text):
        return [ord(c) % 160 for c in text][-40:]

    def decode(self, ids):
        return "".join(chr(97 + int(i) % 26) for i in ids)


@pytest.fixture(scope="module")
def fixture_models():
    return load_fixture_both()


# --- the cost model against JAX's ----------------------------------------------


def _geometries(fixture_models):
    jmodel, _, pmodel = fixture_models
    return {"fixture": (jcost.geometry_from_config(jmodel.cfg),
                        cost.geometry_from_config(pmodel.config)),
            "qwen3_8b": (jcost.geometry_from_config(JaxQwen3Config(**QWEN3_8B)),
                         cost.geometry_from_config(Qwen3Config(**QWEN3_8B)))}


@pytest.mark.parametrize("which", ["fixture", "qwen3_8b"])
def test_cost_model_arithmetic_equals_jax(fixture_models, which):
    jgeom, pgeom = _geometries(fixture_models)[which]
    assert dataclasses.asdict(pgeom) == dataclasses.asdict(jgeom)
    kw = dict(weight_bytes=123_456_789, kv_bytes_per_token=4096,
              peak_flops=PEAK_FLOPS, peak_hbm_bw=PEAK_BW)
    jcm = jcost.CostModel(geometry=jgeom, **kw)
    pcm = cost.CostModel(geometry=pgeom, **kw)
    for tokens, keys in FLOP_CASES:
        assert pcm.step_flops(tokens, keys) == jcm.step_flops(tokens, keys)
    for passes, kv, new in BYTE_CASES:
        assert pcm.step_bytes(passes, kv, new) == jcm.step_bytes(passes, kv,
                                                                 new)
    for n, ctx in ((1, 0), (8, 700), (4, 63)):
        assert cost.CostModel.block_keys(n, ctx) == \
            jcost.CostModel.block_keys(n, ctx)
        assert cost.CostModel.chunk_keys(n * 32, ctx) == \
            jcost.CostModel.chunk_keys(n * 32, ctx)
    for seq, full in ((1024, True), (1024, False), (4096, False)):
        args = (pgeom.matmul_params, pgeom.n_layer, seq, pgeom.attn_dim)
        assert cost.flops_per_token(*args, train_full=full) == \
            jcost.flops_per_token(*args, train_full=full)
    # the geometry reproduces the weights' own count (the fixture's)
    if which == "fixture":
        jmodel, jparams, pmodel = fixture_models
        tied = pmodel.config.tie_word_embeddings
        assert cost.matmul_param_count(pmodel, tied_head=tied) == \
            jcost.matmul_param_count(jparams, tied_head=tied)
        assert cost.matmul_param_count(pmodel, tied_head=True) == \
            jcost.matmul_param_count(jparams, tied_head=True)
        if tied:
            assert pgeom.matmul_params == cost.matmul_param_count(
                pmodel, tied_head=True)


def test_from_model_and_utilization_under_explicit_peaks(fixture_models):
    jmodel, jparams, pmodel = fixture_models
    pcm = cost.CostModel.from_model(pmodel, cache_dtype=torch.float32,
                                    peak_flops=PEAK_FLOPS,
                                    peak_hbm_bw=PEAK_BW)
    jcm = dataclasses.replace(
        jcost.CostModel.from_model(jmodel, jparams, cache_dtype=jnp.float32,
                                   device_kind="any"),
        peak_flops=PEAK_FLOPS, peak_hbm_bw=PEAK_BW)
    assert pcm.kv_bytes_per_token == jcm.kv_bytes_per_token
    # the fixture's f32 weights: the module holds exactly the tree's bytes
    assert pcm.weight_bytes == jcm.weight_bytes
    for tokens, keys in FLOP_CASES:
        for dt in (1e-3, 0.25):
            assert pcm.mfu(pcm.step_flops(tokens, keys), dt) == \
                pytest.approx(jcm.mfu(jcm.step_flops(tokens, keys), dt),
                              rel=1e-12)
    for passes, kv, new in BYTE_CASES:
        b = pcm.step_bytes(passes, kv, new)
        assert pcm.hbm_util(b, 0.01) == pytest.approx(
            jcm.hbm_util(jcm.step_bytes(passes, kv, new), 0.01), rel=1e-12)
    assert pcm.mfu(1.0, 0.0) is None and pcm.hbm_util(1.0, -1.0) is None

    class NoConfig:
        pass

    assert cost.CostModel.from_model(NoConfig()) is None


PTQ_CFG = dict(hidden_size=256, intermediate_size=512, n_head=4,
               n_kv_head=2, head_dim=64, n_layer=2, compute_dtype="float32",
               max_seq_len=64)


def _block_kernel(path) -> bool:
    p = path_str(path)
    return p.startswith("block_") and p.endswith("kernel")


@pytest.mark.parametrize("fmt", ["nf4", "int4", "int8"])
def test_weight_bytes_equal_jax_tree_bytes(fmt, tmp_path):
    jmodel = JaxQwen3(jax_qwen3_config(512, **PTQ_CFG))
    params = numpy_params(jmodel, seed=3)
    if fmt == "nf4":
        qtree = quantize_base_lowmem(params, fmt="nf4", cast_rest_above=None)
    elif fmt == "int4":
        qtree = jax.tree_util.tree_map_with_path(
            lambda p, w: (jax_int4.rtn_quantize(jnp.asarray(w),
                                                group_size=128)
                          if _block_kernel(p) else w), params)
    else:
        qtree = jax_int8.quantize_tree(
            params, lambda p, leaf: p.startswith("block_")
            and p.endswith("kernel"))
    jax_quant_io.save_packed(str(tmp_path), qtree, metadata={
        "config": jmodel.cfg.to_dict(), "family": "qwen3", "method": fmt})
    tree, _ = load_packed(str(tmp_path))
    cfg = Qwen3Config.from_dict(jmodel.cfg.to_dict())
    model = QuantizedModel(Qwen3(cfg, device="meta"),
                           params_from_jax(tree, cfg),
                           compute_dtype=torch.float32, device="cpu")
    want = jcost.tree_bytes(qtree)
    # the packed leaves, not a dequantized copy: the bytes a weight pass
    # streams, equal to the JAX tree's
    assert cost.tree_bytes(model) == want
    cm = cost.CostModel.from_model(model)
    assert cm.weight_bytes == want
    dense = sum(int(np.asarray(x).nbytes) for x in jax.tree.leaves(params))
    assert want < dense / 2


def test_chip_peak_is_none_on_the_cpu(fixture_models):
    assert cost.chip_peak() is None
    assert cost.chip_hbm_bw() is None
    cm = cost.CostModel.from_model(fixture_models[2])
    assert cm is not None and cm.device_kind == "cpu"
    assert cm.peak_flops is None and cm.peak_hbm_bw is None
    assert cm.mfu(1e9, 0.1) is None and cm.hbm_util(1e9, 0.1) is None
    # the one card every measurement of the port names, from the data
    # sheet; no TPU part and no fallback
    assert cost._lookup("NVIDIA H100 80GB HBM3", cost.PEAKS) == 989e12
    assert cost.chip_hbm_bw("NVIDIA H100 80GB HBM3") == 3.35e12
    assert cost.chip_hbm_bw("TPU v5 lite") is None
    assert cost._lookup("NVIDIA A100-SXM4-80GB", cost.PEAKS) is None
    cm = cost.CostModel.from_model(fixture_models[2],
                                   device_kind="NVIDIA H100 80GB HBM3")
    assert (cm.peak_flops, cm.peak_hbm_bw) == (989e12, 3.35e12)


# --- the meters against JAX's --------------------------------------------------


def _goodput_script(gp, tracer, ctx_type):
    ctx = ctx_type("ab" * 16, "cd" * 8)
    tracer.record("engine.queue_wait", ctx, duration_s=0.01)
    tracer.record("engine.decode", ctx, duration_s=5.0)
    tracer.record("api.stream_flush", ctx, duration_s=0.02)
    tracer.record("api.chat", ctx, duration_s=9.0)   # never blamed
    out = [gp.observe(tokens=5, ttft_s=100.0)]       # off: not booked
    gp.configure(ttft_slo_s=1.0, tpot_slo_s=0.1)
    out += [gp.observe(tokens=5, ttft_s=0.5, tpot_s=0.05),
            gp.observe(tokens=3, ttft_s=2.0, tpot_s=0.05,
                       trace_id=ctx.trace_id),
            gp.observe(tokens=4, ttft_s=0.5, tpot_s=0.5),
            gp.observe(tokens=10, total_s=1.5),
            gp.observe(tokens=10, total_s=2.5, trace_id="ef" * 16)]
    return out


def test_goodput_and_its_families_equal_jax():
    pgp = meter.GoodputMeter(tracer=Tracer(enabled=True))
    jgp = jmeter.GoodputMeter(tracer=jtrace.Tracer(enabled=True))
    assert _goodput_script(pgp, pgp.tracer, TraceContext) == \
        _goodput_script(jgp, jgp.tracer, jtrace.TraceContext)
    assert pgp.snapshot() == jgp.snapshot()
    assert pgp.snapshot()["blame"] == {"engine.decode": 1, "unknown": 2}
    preg, jreg = Registry(), JaxRegistry()
    meter.register_goodput(preg, pgp)
    jmeter.register_goodput(jreg, jgp)
    assert preg.render() == jreg.render()
    parse_exposition(preg.render())


def test_dispatch_meter_equals_jax():
    pdm, jdm = meter.DispatchMeter(window=4), jmeter.DispatchMeter(window=4)
    for dm in (pdm, jdm):
        for i in range(7):
            dm.count()
            dm.note_phase("decode", tokens=8, duration_s=0.01 * (i + 1),
                          mfu=0.01 * i, hbm_bw_util=0.1 * i)
            if i % 3 == 0:
                dm.count(2)
                dm.note_phase("prefill", tokens=256, duration_s=0.05)
            dm.note_step(1 + (i % 3 == 0) * 2)
        dm.wrap(lambda: None)()
    assert pdm.phase_snapshot() == jdm.phase_snapshot()
    assert (pdm.total, pdm.steps, pdm.last_step, pdm.mean_per_step) == \
        (jdm.total, jdm.steps, jdm.last_step, jdm.mean_per_step)
    assert "mfu" not in pdm.phase_snapshot()["prefill"]


def test_rolling_meters_and_handoff_meter_equal_jax():
    prm, jrm = meter.RollingMean(3), jmeter.RollingMean(3)
    assert [prm.update(v) for v in (1, 2, 3, 10)] == \
        [jrm.update(v) for v in (1, 2, 3, 10)]
    th = meter.Throughput()
    th.step(100)
    th.step(50)
    assert th.steps == 2 and th.tokens == 150 and th.tokens_per_sec > 0
    assert meter.EpochTimer().elapsed() >= 0
    hm = meter.HandoffMeter()
    threads = [threading.Thread(target=lambda: [hm.claim_outcome(True)
                                                for _ in range(500)])
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    hm.claim_outcome(False)
    hm.note_repin(True)
    hm.note_repin(False)
    assert (hm.claimed, hm.lost, hm.repinned, hm.repin_failed) == \
        (2000, 1, 1, 1)
    # the API server uses this meter (moved here from serve/api.py)
    from llm_in_practise_tpu_torch.serve import api

    assert api.HandoffMeter is meter.HandoffMeter


# --- compile telemetry -----------------------------------------------------------


def test_compile_meter_books_captures_and_builds(fixture_models):
    cm = prof.CompileMeter()
    cm.note(0.5)
    cm.note(0.25)
    assert (cm.compile_events, cm.compile_seconds) == (2, 0.75)
    eng = InferenceEngine(fixture_models[2], max_slots=2, cache_len=64,
                          cache_dtype=torch.float32)
    # every capture of the engine's graphs reports to its meter
    assert eng.graphs.compile_meter is eng.compile_meter
    prof.note_build(1.5)      # a kernel build while the engine lives
    assert (eng.compile_meter.compile_events,
            eng.compile_meter.compile_seconds) == (1, 1.5)
    eng.stop()
    prof.note_build(2.0)      # after stop(): no longer watched
    assert eng.compile_meter.compile_events == 1
    srv_fams = parse_exposition(OpenAIServer(
        InferenceEngine(fixture_models[2], max_slots=2, cache_len=64,
                        cache_dtype=torch.float32),
        _Tok()).metrics_text())
    assert srv_fams["llm_compile_events_total"].kind == "counter"


# --- on-demand profiler capture --------------------------------------------------


def test_profiler_capture_on_the_cpu(tmp_path):
    cap = prof.ProfilerCapture(base_dir=str(tmp_path))
    out = cap.capture(0.05)
    assert out["duration_s"] == cap.MIN_DURATION_S
    assert out["perfetto"] and all(f.endswith(".trace.json.gz")
                                   for f in out["perfetto"])
    with gzip.open(out["perfetto"][0], "rt") as f:
        assert "traceEvents" in json.load(f)
    assert cap.capture(-3)["duration_s"] == cap.MIN_DURATION_S
    # busy while another session holds the profiler
    with meter.profile_trace(str(tmp_path / "outer")) as outer:
        assert outer is not None
        with meter.profile_trace(str(tmp_path / "inner")) as inner:
            assert inner is None     # nested: a no-op, the outer keeps on
        with pytest.raises(prof.ProfilerBusyError):
            cap.capture(0.05)
    with meter.exclusive_profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(prof.ProfilerBusyError):
            cap.capture(0.05)
    assert os.listdir(tmp_path / "outer")
    assert not (tmp_path / "inner").exists()
    with pytest.raises(ValueError):
        with meter.profile_trace(str(tmp_path / "exc")):
            raise ValueError("boom")
    assert cap.capture(0.05)["files"]    # the exception released it
    assert cap.busy_rejections == 2 and cap.captures == 3


def _post(url, payload, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_post_debug_profile_on_model_and_pool_servers(fixture_models,
                                                      monkeypatch, tmp_path):
    monkeypatch.setattr(prof, "_default_profiler",
                        prof.ProfilerCapture(base_dir=str(tmp_path)))
    eng = InferenceEngine(fixture_models[2], max_slots=2, cache_len=64,
                          cache_dtype=torch.float32)
    srv = OpenAIServer(eng, _Tok(), model_name="plane")
    port = srv.serve(host="127.0.0.1", port=0, background=True)
    pool = KVPoolServer().start()
    mport = pool.serve_metrics("127.0.0.1", 0)
    try:
        base = f"http://127.0.0.1:{port}"
        results = {}

        def long_capture():
            results["long"] = _post(base + "/debug/profile",
                                    {"duration_s": 1.5})

        t = threading.Thread(target=long_capture)
        t.start()
        deadline = time.monotonic() + 30
        while not meter._profile_lock.locked():   # the capture has begun
            assert time.monotonic() < deadline
            time.sleep(0.005)
        status, body = _post(base + "/debug/profile", {"duration_s": 0.1})
        assert status == 409 and body["error"]["code"] == "profile_busy"
        # the pool's metrics port shares the process's one profiler
        status, _ = _post(f"http://127.0.0.1:{mport}/debug/profile",
                          {"duration_s": 0.1})
        assert status == 409
        t.join()
        status, body = results["long"]
        assert status == 200 and body["perfetto"]
        status, body = _post(f"http://127.0.0.1:{mport}/debug/profile",
                             {"duration_s": 0.1})
        assert status == 200 and body["perfetto"]
        assert _post(base + "/debug/profile", {"duration_s": "x"})[0] == 422
        assert _post(base + "/debug/profile", [1])[0] == 422
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/debug/traces",
                                    timeout=30) as r:
            assert "summary" in json.loads(r.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics",
                                    timeout=30) as r:
            fams = parse_exposition(r.read().decode())
        (labels,) = [dict(k[1]) for k in fams["llm_build_info"].samples]
        assert labels["version"] == llm_in_practise_tpu_torch.__version__
    finally:
        srv.shutdown()
        pool.stop()


def test_post_debug_profile_waits_for_the_engine_step(fixture_models,
                                                      monkeypatch, tmp_path):
    """The capture starts (and stops) the profiler only under the engine's
    step lock: CUPTI's start or stop beside the engine thread's CUDA graph
    launch can deadlock on the card."""
    monkeypatch.setattr(prof, "_default_profiler",
                        prof.ProfilerCapture(base_dir=str(tmp_path)))
    calls = []
    for name in ("start", "stop"):
        real = getattr(torch.profiler.profile, name)

        def wrapped(self, _real=real, _name=name):
            calls.append(_name)
            return _real(self)
        monkeypatch.setattr(torch.profiler.profile, name, wrapped)
    eng = InferenceEngine(fixture_models[2], max_slots=2, cache_len=64,
                          cache_dtype=torch.float32)
    srv = OpenAIServer(eng, _Tok(), model_name="plane")
    port = srv.serve(host="127.0.0.1", port=0, background=True)
    results = {}
    try:
        with eng._lock:       # a step in flight
            t = threading.Thread(target=lambda: results.update(
                post=_post(f"http://127.0.0.1:{port}/debug/profile",
                           {"duration_s": 0.05})))
            t.start()
            deadline = time.monotonic() + 30
            while not meter._profile_lock.locked():   # the capture began
                assert time.monotonic() < deadline
                time.sleep(0.005)
            time.sleep(0.3)
            assert calls == []    # the profiler waits for the step's end
        t.join(timeout=60)
    finally:
        srv.shutdown()
    status, body = results["post"]
    assert status == 200 and body["perfetto"]
    assert calls == ["start", "stop"]


def test_engine_paused_waits_for_one_step_however_busy(fixture_models):
    """``paused()`` holds the step lock, taken at the end of the step in
    flight, even when the loop never idles: the loop waits for it before
    its next step."""
    eng = InferenceEngine(fixture_models[2], max_slots=2, cache_len=64,
                          cache_dtype=torch.float32)

    def busy_step():             # always work to do: 10 ms under the lock
        with eng._lock:
            time.sleep(0.01)
        return True
    eng.step = busy_step
    eng.start()
    held = []

    def pause_often():
        for _ in range(20):
            with eng.paused():
                held.append(eng._lock.locked())
    t = threading.Thread(target=pause_often, daemon=True)
    try:
        t.start()
        t.join(timeout=20)
    finally:
        eng.stop()
    assert not t.is_alive()
    assert held == [True] * 20


# --- build identity --------------------------------------------------------------


def test_build_info(monkeypatch):
    monkeypatch.delenv("LLM_TPU_BUILD_VERSION", raising=False)
    monkeypatch.delenv("LLM_TPU_BUILD_SHA", raising=False)
    info = buildinfo.build_info({"b": 2, "a": 1})
    assert info["version"] == llm_in_practise_tpu_torch.__version__
    assert info["config_hash"] == buildinfo.config_fingerprint(
        {"a": 1, "b": 2}) != buildinfo.config_fingerprint({"a": 1})
    assert len(info["git_sha"]) == 12 or info["git_sha"] == "unknown"
    assert buildinfo.build_info()["config_hash"] == "none"
    # the same fingerprint as JAX's for the same config
    from llm_in_practise_tpu.obs import buildinfo as jbuild

    assert info["config_hash"] == jbuild.config_fingerprint({"b": 2, "a": 1})
    monkeypatch.setenv("LLM_TPU_BUILD_VERSION", "canary-7")
    monkeypatch.setenv("LLM_TPU_BUILD_SHA", "deadbeef")
    reg = Registry()
    labels = buildinfo.register_build_info(reg, {"server": "x"})
    assert labels["version"] == "canary-7" and labels["git_sha"] == "deadbeef"
    fams = parse_exposition(reg.render())
    assert list(fams["llm_build_info"].samples.values()) == [1.0]


# --- debug aids ------------------------------------------------------------------


def test_nan_trap_raises_and_resets():
    debug.enable_debug(nans=True)
    try:
        with pytest.raises(FloatingPointError):
            torch.log(torch.zeros(4)) - torch.log(torch.zeros(4))
        # inf is a legitimate sentinel: not trapped without infs
        assert torch.isinf(torch.log(torch.zeros(2))).all()
    finally:
        debug.disable_debug()
    out = torch.log(torch.zeros(4)) - torch.log(torch.zeros(4))
    assert bool(torch.isnan(out).all())
    debug.enable_debug(nans=False, infs=True)
    try:
        with pytest.raises(FloatingPointError):
            torch.log(torch.zeros(2))
    finally:
        debug.disable_debug()
    assert not torch.is_anomaly_enabled()


def test_served_nan_is_trapped_and_disable_jit_goes_eager(fixture_models):
    model = fixture_models[2]
    eng = InferenceEngine(model, max_slots=2, cache_len=64,
                          cache_dtype=torch.float32)
    saved = model.ln_f.scale.detach().clone()
    with torch.no_grad():
        model.ln_f.scale.fill_(float("nan"))
    debug.enable_debug(nans=True, disable_jit=True)
    try:
        assert debug.graphs_disabled()
        assert not InferenceEngine(model, max_slots=2, cache_len=64,
                                   cache_dtype=torch.float32).graphs.capture
        with pytest.raises(FloatingPointError):
            eng.generate([1, 2, 3], SamplingParams(greedy=True,
                                                   max_tokens=2))
        # the engine's own thread steps under its trap too
        threaded = InferenceEngine(model, max_slots=2, cache_len=64,
                                   cache_dtype=torch.float32)
        threaded.start()
        req = threaded.submit([1, 2, 3], SamplingParams(greedy=True,
                                                        max_tokens=2))
        with pytest.raises(EngineDeadError):
            req.result()
        assert isinstance(threaded.error, FloatingPointError)
        threaded.stop()
    finally:
        debug.disable_debug()
        with torch.no_grad():
            model.ln_f.scale.copy_(saved)
        eng.stop()
    assert not debug.graphs_disabled()


def test_seed_everything_deterministic():
    g1 = debug.seed_everything(42)
    a = np.random.rand(3)
    g2 = debug.seed_everything(42)
    assert (np.random.rand(3) == a).all()
    assert torch.equal(torch.rand(4, generator=g1),
                       torch.rand(4, generator=g2))
    g3 = debug.seed_everything(7)
    assert not torch.equal(torch.rand(4, generator=g3),
                           torch.rand(4, generator=debug.seed_everything(42)))
    # seed + rank: rank 1 of seed 41 is seed 42
    assert torch.equal(torch.rand(4, generator=debug.seed_everything(41,
                                                                     rank=1)),
                       torch.rand(4, generator=debug.seed_everything(42)))


def test_tap_prints_and_refuses_inside_a_capture(capsys, monkeypatch):
    t = torch.arange(3)
    assert debug.tap(t, "x") is t
    assert "x: tensor([0, 1, 2])" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        debug.tap(t, "y")


def test_device_plane_families_on_a_live_server(fixture_models):
    eng = InferenceEngine(fixture_models[2], max_slots=2, cache_len=64,
                          cache_dtype=torch.float32, chunked_prefill=8,
                          ttft_slo_s=120.0, tpot_slo_s=60.0)
    srv = OpenAIServer(eng, _Tok(), model_name="plane")
    port = srv.serve(host="127.0.0.1", port=0, background=True)
    try:
        for content in ("short", "a much longer prompt that chunks " * 2):
            status, _ = _post(f"http://127.0.0.1:{port}/v1/chat/completions",
                              {"model": "plane", "max_tokens": 4,
                               "temperature": 0.0,
                               "messages": [{"role": "user",
                                             "content": content}]})
            assert status == 200
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as r:
            fams = parse_exposition(r.read().decode())
    finally:
        srv.shutdown()
    ok = ("llm_goodput_tokens_total", frozenset({("slo", "ok")}))
    bad = ("llm_goodput_tokens_total", frozenset({("slo", "violated")}))
    assert fams["llm_goodput_tokens_total"].samples[ok] == \
        eng.stats.tokens_generated_total == 8
    assert fams["llm_goodput_tokens_total"].samples[bad] == 0
    assert fams["llm_tpot_seconds"].samples[
        ("llm_tpot_seconds_count", frozenset())] == 2
    (labels,) = [dict(k[1]) for k in fams["llm_build_info"].samples]
    assert set(labels) == {"version", "git_sha", "config_hash"}
    assert labels["config_hash"] != "none"
    assert fams["llm_dispatches_per_step"].kind == "gauge"
    assert next(iter(fams["llm_dispatches_total"].samples.values())) == \
        eng.dispatch_meter.total > 0
