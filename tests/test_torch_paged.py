"""PyTorch port: paged KV (``serve/paged_kv.py`` and the engine's paged
path) against the JAX package.

- The page pool and the block-table index builders against JAX's on the
  same operation sequences: free-list order, refcounts, block tables and
  the gather/scatter indices, all exact.
- The paged engine stepped in lockstep with the JAX paged engine on the
  committed HF fixture (f32 compute and KV, 4 slots of 64 positions,
  pages of 8): after every step the block tables are equal, every live
  pool row (each ready slot's rows below its length, each mid-prefill
  slot's below its watermark) agrees at 1e-5, and at the end the greedy
  tokens and finish reasons are identical. Cases: the fused mixed step,
  the sequential paths, one-shot admission. One JAX engine serves every
  case, so its programs compile once per width bucket.
- Preemption by recompute: streams equal to unpreempted ones (the port's
  and JAX's); churn leaks no page reference; more slots than the
  contiguous layout's capacity.
- The 422 ``prompt_too_large`` with its page math and ``GET /debug/kv``
  over HTTP through ``build_server --device cpu``; the contiguous
  ``debug_kv``; the CLI's defaults and its scan-layers check.
- fp8 KV: the cache cast's bytes equal JAX's ``astype(float8_e4m3fn)``
  below 464; above it JAX gives NaN and the port saturates to +-448.
"""

import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torch_port_util import load_fixture_both, tiny_port_model

from llm_in_practise_tpu.serve import paged_kv as jax_paged
from llm_in_practise_tpu.serve.engine import InferenceEngine as JaxEngine
from llm_in_practise_tpu.serve.engine import SamplingParams as JaxParams
from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
from llm_in_practise_tpu_torch.data.sft import IM_END, IM_START
from llm_in_practise_tpu_torch.models.layers import to_kv_dtype
from llm_in_practise_tpu_torch.serve import paged_kv
from llm_in_practise_tpu_torch.serve.__main__ import (
    build_parser,
    build_server,
    main,
)
from llm_in_practise_tpu_torch.serve.engine import (
    InferenceEngine,
    SamplingParams,
)

SHORT = ([3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8])
LONG = [(i * 7 + 3) % 160 for i in range(30)]   # 30 tokens: 4 chunks of 8
PAGE = 8
ENGINE = dict(max_slots=4, cache_len=64, kv_layout="paged",
              kv_page_size=PAGE, chunked_prefill=8, decode_steps=4)
KV_TOL = 1e-5


@pytest.fixture(scope="module")
def fixture_models():
    return load_fixture_both()


@pytest.fixture(scope="module")
def engines(fixture_models):
    """One port engine and one JAX paged engine for every lockstep case:
    the cases switch both engines' ``mixed_step`` / ``chunked_prefill``
    between runs (the JAX programs then compile once per width bucket),
    and both pools carry the same history."""
    jmodel, jparams, pmodel = fixture_models
    port = InferenceEngine(pmodel, cache_dtype=torch.float32, **ENGINE)
    jeng = JaxEngine(jmodel, jparams, cache_dtype=jnp.float32, **ENGINE)
    yield port, jeng
    jeng.stop()


def _configure(engines, mixed_step=True, chunked_prefill=8):
    for eng in engines:
        eng.mixed_step, eng.chunked_prefill = mixed_step, chunked_prefill
    return engines


# --- the pool and the index builders ----------------------------------------


def _pool_state(pool):
    return (list(pool._free), pool._refs.tolist(), pool.snapshot())


def test_page_pool_matches_jax():
    freed = {}
    pools = []
    for mod in (paged_kv, jax_paged):
        pool = mod.PagePool(num_pages=9, page_size=16)
        trace = [pool.capacity, pool.free_pages]
        a = pool.alloc(3)
        pool.share(a[:2])
        trace += [a, pool.shared_pages, pool.refcount(a[0])]
        pool.release(a)
        trace += [pool.free_pages, _pool_state(pool)]
        b = pool.alloc(4)
        trace += [b, pool.try_alloc(5), pool.alloc_failures]
        with pytest.raises(mod.PagePoolExhausted):
            pool.alloc(5)
        unallocated = [p for p in range(1, 9) if pool.refcount(p) == 0]
        with pytest.raises(ValueError):
            pool.share([b[0], unallocated[0]])
        held = list(b)

        def reclaim(n, held=held, pool=pool, key=mod.__name__):
            take = held[:n]
            del held[:n]
            freed.setdefault(key, []).extend(take)
            pool.release(take)
            return len(take)

        pool.reclaim = reclaim
        trace += [pool.try_alloc(3), _pool_state(pool)]
        pool.reclaim = None
        pool.release([p for p in range(1, 9) if pool.refcount(p) > 0
                      for _ in range(pool.refcount(p))])
        with pytest.raises(ValueError):
            pool.release([1])
        pool.check_leaks(0)
        trace.append(_pool_state(pool))
        pools.append(trace)
    assert pools[0] == pools[1]
    assert freed[paged_kv.__name__] == freed[jax_paged.__name__]
    assert paged_kv.pages_for(17, 16) == jax_paged.pages_for(17, 16) == 2


def test_paged_kv_index_builders_match_jax(fixture_models):
    jmodel, _, pmodel = fixture_models
    kw = dict(max_slots=4, cache_len=64, page_size=PAGE, pool_tokens=144)
    port = paged_kv.PagedKV(pmodel, dtype=torch.float32, **kw)
    ref = jax_paged.PagedKV(jmodel, dtype=jnp.float32, **kw)
    rng = np.random.default_rng(0)
    try:
        for kv in (port, ref):
            assert kv.extend(0, 21) and kv.extend(2, 9)
            assert kv.extend(0, 40)            # grows by two pages
            shared = kv.slot_pages(0)[:2]
            kv.pool.share(shared)
            kv.map_shared(1, shared)
            assert kv.extend(1, 30)
            kv.release_slot(2)
            assert kv.extend(3, 64) and not kv.extend(2, 64)
        np.testing.assert_array_equal(port.block_tables, ref.block_tables)
        np.testing.assert_array_equal(port.slot_pages_n, ref.slot_pages_n)
        assert _pool_state(port.pool) == _pool_state(ref.pool)
        for width in (8, 16, 32, 64):
            np.testing.assert_array_equal(port.gather_idx(width),
                                          ref.gather_idx(width))
            for slot in range(4):
                np.testing.assert_array_equal(
                    port.row_gather_idx(slot, width),
                    ref.row_gather_idx(slot, width))
        for wwin in (1, 4, 8):
            starts = rng.integers(0, 64 - wwin, size=4)
            valid = rng.integers(0, wwin + 1, size=4)
            np.testing.assert_array_equal(
                port.scatter_idx(starts, valid, wwin),
                ref.scatter_idx(starts, valid, wwin))
        np.testing.assert_array_equal(
            port.rows_scatter_idx([0, 3, 1], [21, 5, 30], 32),
            ref.rows_scatter_idx([0, 3, 1], [21, 5, 30], 32))
        assert port.fits_ever(144) == ref.fits_ever(144) is True
        assert port.fits_ever(145) == ref.fits_ever(145) is False
        assert (port.pool_bytes, port.row_bytes, port.page_bytes,
                port.view_bytes(32)) == (ref.pool_bytes, ref.row_bytes,
                                         ref.page_bytes, ref.view_bytes(32))
        snap, want = port.debug_snapshot(), ref.debug_snapshot()
        want.pop("ledger_account")
        assert snap == want
    finally:
        ref.close()


# --- the engine in lockstep with JAX ----------------------------------------


def _watermarks(eng) -> np.ndarray:
    valid = np.zeros((eng.max_slots,), np.int64)
    for s, req in enumerate(eng.slot_req):
        if req is not None and eng.slot_ready[s]:
            valid[s] = eng.slot_len[s]
    for s, st in eng.slot_prefill.items():
        valid[s] = st["done"]
    return valid


def _live_rows(eng, slot, valid):
    bt = eng.paged.block_tables
    t = np.arange(valid)
    return bt[slot, t // PAGE] * PAGE + t % PAGE


def _assert_same_state(port, jeng, where):
    np.testing.assert_array_equal(port.paged.block_tables,
                                  jeng.paged.block_tables, err_msg=where)
    np.testing.assert_array_equal(port.paged.slot_pages_n,
                                  jeng.paged.slot_pages_n, err_msg=where)
    assert port.paged.pool.snapshot() == jeng.paged.pool.snapshot(), where
    valid = _watermarks(port)
    np.testing.assert_array_equal(valid, _watermarks(jeng), err_msg=where)
    for s in range(port.max_slots):
        rows = _live_rows(port, s, int(valid[s]))
        for i, (pl, jl) in enumerate(zip(port.paged.kv, jeng.paged.kv)):
            for key in ("k", "v"):
                np.testing.assert_allclose(
                    pl[key][rows].numpy(), np.asarray(jl[key])[rows],
                    rtol=KV_TOL, atol=KV_TOL,
                    err_msg=f"{where}: layer {i} {key} slot {s}")


@pytest.mark.parametrize("case", [
    dict(), dict(mixed_step=False), dict(chunked_prefill=None)],
    ids=["fused", "sequential", "one_shot"])
def test_lockstep_matches_jax_paged_engine(engines, case):
    port, jeng = _configure(engines, **case)
    mixed0 = port.mixed_blocks
    hp = [port.submit(p, SamplingParams(greedy=True, max_tokens=24))
          for p in SHORT]
    hj = [jeng.submit(p, JaxParams(greedy=True, max_tokens=24))
          for p in SHORT]
    assert port.step() and jeng.step()
    hp.append(port.submit(LONG, SamplingParams(greedy=True, max_tokens=8)))
    hj.append(jeng.submit(LONG, JaxParams(greedy=True, max_tokens=8)))
    for i in range(64):
        busy = port.step()
        assert busy == jeng.step(), f"step {i}"
        _assert_same_state(port, jeng, f"step {i}")
        if not busy:
            break
    else:
        raise AssertionError("the load never drained")
    assert [r.result() for r in hp] == [r.result() for r in hj]
    assert [r.finish_reason for r in hp] == [r.finish_reason for r in hj]
    assert [len(r.output_ids) for r in hp] == [24, 24, 8]
    assert (port.mixed_blocks > mixed0) == (
        "mixed_step" not in case and "chunked_prefill" not in case)
    port.paged.pool.check_leaks(0)
    jeng.paged.pool.check_leaks(0)


def test_preemption_streams_equal_unpreempted(fixture_models, engines):
    """A pool sized for about two of three requests: preemption fires and
    every stream still completes with exactly the tokens of an engine
    that never preempts, the port's and the JAX engine's."""
    _, _, pmodel = fixture_models
    free, jeng = _configure(engines)
    prompts = [[(j * 3 + i) % 160 for i in range(20)] for j in range(3)]
    sp = SamplingParams(greedy=True, max_tokens=30)
    tight = InferenceEngine(pmodel, cache_dtype=torch.float32,
                            prefix_cache=True,
                            **{**ENGINE, "kv_pool_tokens": 96})
    hs = [tight.submit(p, sp) for p in prompts]
    while tight.step():
        pass
    assert tight.preemptions > 0
    hj = [jeng.submit(p, JaxParams(greedy=True, max_tokens=30))
          for p in prompts]
    while jeng.step():
        pass
    for p, h, j in zip(prompts, hs, hj):
        out = h.result()
        assert h.finish_reason == "length" and len(out) == 30
        assert out == free.generate(p, sp) == j.result()
    assert tight.debug_kv()["preemptions"] == tight.preemptions
    tight.prefix_cache.clear()
    tight.paged.pool.check_leaks(0)


def test_churn_leaks_no_page_reference():
    """Admit/finish/shed/preempt cycles, then drain: only the index holds
    pages, and clearing it frees every one."""
    model = tiny_port_model(64, seed=3)
    e = InferenceEngine(model, max_slots=4, cache_len=64,
                        cache_dtype=torch.float32, kv_layout="paged",
                        kv_page_size=PAGE, kv_pool_tokens=64,
                        prefix_cache=True, max_queue=4, chunked_prefill=8,
                        decode_steps=2)
    rng = np.random.default_rng(0)
    handles = []
    for _ in range(5):
        for j in range(6):
            p = [int(x) for x in rng.integers(0, 64, size=6 + 4 * j)]
            handles.append(e.submit(p, SamplingParams(
                greedy=True, max_tokens=int(rng.integers(1, 20)))))
        while e.step():
            pass
    for h in handles:
        h.result()
    assert e.requests_shed > 0 and e.preemptions > 0
    e.paged.pool.check_leaks(e.prefix_cache.n_entries)
    e.prefix_cache.clear()
    e.paged.pool.check_leaks(0)


def test_more_slots_than_contiguous_capacity():
    """8 slots over a pool of 128 tokens (the contiguous layout's bytes for
    2 slots): short requests all run at once and complete."""
    model = tiny_port_model(64, seed=4)
    e = InferenceEngine(model, max_slots=8, cache_len=64,
                        cache_dtype=torch.float32, kv_layout="paged",
                        kv_page_size=PAGE, kv_pool_tokens=128)
    sp = SamplingParams(greedy=True, max_tokens=6)
    hs = [e.submit([j + 1, j + 2, j + 3, j + 4], sp) for j in range(8)]
    e.step()
    assert sum(r is not None for r in e.slot_req) == 8
    while e.step():
        pass
    ref = InferenceEngine(model, max_slots=8, cache_len=64,
                          cache_dtype=torch.float32)
    assert [h.result() for h in hs] == [
        ref.generate([j + 1, j + 2, j + 3, j + 4], sp) for j in range(8)]
    e.paged.pool.check_leaks(0)


# --- HTTP, the CLI and debug_kv ----------------------------------------------

CORPUS = ("Paged KV carves one pool into pages behind block tables; a "
          "prompt that can never fit it gets 422 with the page math. ")


def test_too_large_and_debug_kv_over_http(tmp_path):
    from llm_in_practise_tpu_torch.ckpt.checkpoint import save_named
    from llm_in_practise_tpu_torch.models.convert import params_to_jax

    tok = BPETokenizer.train([CORPUS] * 4, vocab_size=300,
                             special_tokens=[IM_START, IM_END],
                             min_frequency=1)
    tok_path = str(tmp_path / "tok.json")
    tok.save(tok_path)
    model = tiny_port_model(tok.get_vocab_size(), seed=7, max_seq_len=128)
    state = {n: p.detach() for n, p in model.named_parameters()}
    path = save_named(str(tmp_path / "m"), params_to_jax(state, model.cfg),
                      "model", metadata={"config": model.cfg.to_dict()})
    server = build_server(build_parser().parse_args(
        ["--model_path", path, "--tokenizer_path", tok_path, "--device",
         "cpu", "--max_slots", "2", "--cache_len", "128",
         "--kv-pool-tokens", "64", "--kv-page-size", "16"]))
    assert server.engine.paged is not None       # the CLI's default
    port = server.serve(host="127.0.0.1", port=0, background=True)
    base = f"http://127.0.0.1:{port}"

    def post(content, stream=False):
        body = {"model": "qwen3-h100", "temperature": 0.0, "max_tokens": 4,
                "stream": stream,
                "messages": [{"role": "user", "content": content}]}
        req = urllib.request.Request(
            base + "/v1/chat/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    try:
        for stream in (False, True):
            status, raw = post(CORPUS * 2, stream)
            body = json.loads(raw)
            assert status == 422, body
            err = body["error"]
            assert (err["code"], err["type"]) == ("prompt_too_large",
                                                  "invalid_request_error")
            detail = err["detail"]
            assert detail["page_size"] == 16 and detail["pages_capacity"] == 4
            assert detail["pages_needed"] == paged_kv.pages_for(
                detail["prompt_tokens"] + 1, 16) > 4
        status, raw = post("Hi there")
        assert status == 200, raw
        with urllib.request.urlopen(base + "/debug/kv", timeout=30) as r:
            snap = json.loads(r.read())
        assert snap["layout"] == "paged" and snap["pages_total"] == 4
        assert snap["rejected_too_large"] == 2
        for key in ("refcount_histogram", "fragmentation",
                    "block_table_pages_per_slot", "live_tokens"):
            assert key in snap
        assert server.engine.paged.pool.free_pages == 4
    finally:
        server.shutdown()


def test_contiguous_debug_kv():
    e = InferenceEngine(tiny_port_model(64, seed=5), max_slots=4,
                        cache_len=48, cache_dtype=torch.float32)
    snap = e.debug_kv()
    assert snap["layout"] == "contiguous"
    assert snap["kv_tokens_reserved"] == 4 * 48
    cfg = e.model.config
    assert snap["kv_bytes"] == (cfg.n_layer * 2 * 4 * 48 * cfg.n_kv_head
                                * cfg.head_dim * 4)


def test_cli_defaults_to_paged_and_rejects_scan_layers_paged(capsys):
    args = build_parser().parse_args(["--tokenizer_path", "t"])
    assert (args.kv_layout, args.kv_page_size, args.kv_pool_tokens,
            args.prefix_caching) == ("paged", 16, None, False)
    with pytest.raises(SystemExit):
        main(["--tokenizer_path", "t", "--scan-layers"])
    assert "--kv-layout contiguous" in capsys.readouterr().err


# --- fp8 KV -----------------------------------------------------------------


def test_fp8_cast_bytes_match_jax_below_464_and_saturate_above():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(20000) * 40,
                        rng.uniform(-460.0, 460.0, 20000),
                        np.array([0.0, -0.0, 447.0, 448.0, 455.0, 462.0,
                                  -462.0, 1e-9])]).astype(np.float32)
    for dt in (np.float32, ml_dtypes.bfloat16):
        xs = x.astype(dt)
        want = jnp.asarray(xs).astype(jnp.float8_e4m3fn)
        got = to_kv_dtype(torch.from_numpy(xs.astype(np.float32)).to(
            torch.bfloat16 if dt is not np.float32 else torch.float32),
            torch.float8_e4m3fn)
        np.testing.assert_array_equal(
            got.view(torch.uint8).numpy(),
            np.asarray(want).view(np.uint8))
    big = np.array([465.0, 500.0, 1e4, -1e4, -600.0], np.float32)
    assert np.isnan(np.asarray(
        jnp.asarray(big).astype(jnp.float8_e4m3fn)).astype(np.float32)).all()
    sat = to_kv_dtype(torch.from_numpy(big), torch.float8_e4m3fn).float()
    assert sat.tolist() == [448.0, 448.0, 448.0, -448.0, -448.0]


def test_fp8_paged_engine_stores_half_the_bytes_and_serves():
    model = tiny_port_model(64, seed=8)
    kw = dict(max_slots=2, cache_len=64, kv_layout="paged",
              kv_page_size=PAGE, chunked_prefill=8, decode_steps=2)
    f8 = InferenceEngine(model, cache_dtype=torch.float8_e4m3fn, **kw)
    bf = InferenceEngine(model, cache_dtype=torch.bfloat16, **kw)
    assert f8.paged.store.dtype == torch.float8_e4m3fn
    assert 2 * f8.paged.pool_bytes == bf.paged.pool_bytes
    prompt = [(i * 5 + 2) % 64 for i in range(21)]
    sp = SamplingParams(greedy=True, max_tokens=6)
    h = f8.submit(prompt, sp)
    f8.step()               # 3 chunks of 8: the first is in the pages
    first_page = f8.paged.slot_pages(0)[0]
    rows = f8.paged.kv[0]["k"][first_page * PAGE:(first_page + 1) * PAGE]
    assert rows.dtype == torch.float8_e4m3fn and rows.float().abs().sum() > 0
    while f8.step():
        pass
    out = h.result()
    assert len(out) == 6
    assert torch.isfinite(f8.paged.store.float()).all()
    # the contiguous fp8 engine computes the same tokens
    contiguous = InferenceEngine(model, cache_dtype=torch.float8_e4m3fn,
                                 **{**kw, "kv_layout": "contiguous"})
    assert contiguous.generate(prompt, sp) == out
    f8.paged.pool.check_leaks(0)
