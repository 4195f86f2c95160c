"""PyTorch port: speculative decoding (``serve/mixed_step.py``'s
``spec_verify_block`` and ``plan_spec_extension``, ``serve/disagg.py``'s
default, the engine's ngram and draft-model proposers, the CLI's
``--speculative`` / ``--draft-model-path``) against the JAX package.

- ``plan_spec_extension`` and ``default_speculative_k`` equal JAX's on a
  grid of their arguments.
- ``spec_verify_block`` equals JAX's on the same cache and tokens at
  ``m`` 0 and 3 (a row whose drafts all match, one that matches two,
  one that matches none, one masked): ``out``, ``n_acc``, ``extra`` and
  the index exactly, KV below the new index at 1e-5.
- The engine in lockstep with the JAX engine on the committed HF fixture
  (f32 compute and KV, 4 slots of 64 positions, chunked prefill 8,
  decode blocks of 4, k = 4), in both layouts, with the ngram proposer, a
  1-layer numpy-seeded Qwen3 draft and the target as its own draft: two
  chats decode while a 30-token prompt chunk-prefills. After every step
  the slot tables, the four spec counters, the draft watermarks and the
  KV below every watermark (the draft's too) agree at 1e-5; at the end
  the tokens and finish reasons are equal. The paged engines with the
  1-layer draft (and the ngram cases on them) have the prefix cache on.
  Also ``decode_steps`` 1, where the spec round composes with the
  prefill. One JAX engine serves every case of its layout and draft (the
  ngram cases switch the draft off), so its programs compile once.
- Preemption between rounds under a pool the draft's cache shrinks: the
  streams equal an unpreempted engine's and the JAX engine's.
- The draft cache's deduction from an explicit pool, ``debug_kv``'s keys
  and the ``ValueError`` of a pool the draft eats, as in JAX.
- The stated contract of the reference's
  ``test_spec_round_is_one_dispatch_many_tokens``: an ngram round is one
  dispatch, a draft round whose gap fits the window is two, and the
  target as its draft at k = 4, ``decode_steps`` 4 commits 8 tokens.
- Sampled requests and slots near the cache's end take the plain path;
  the knobs are validated as in JAX; the CLI's four argument errors; a
  draft ``model.msgpack`` loads through the CLI's loader and a server
  built from the args speculates.
"""

import contextlib
import dataclasses
import itertools
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import load_fixture_both, numpy_params, tiny_port_model

from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.serve.disagg import (
    DECODE_DEFAULT_SPEC_K as JAX_DECODE_DEFAULT_SPEC_K,
)
from llm_in_practise_tpu.serve.disagg import (
    default_speculative_k as jax_default_speculative_k,
)
from llm_in_practise_tpu.serve.engine import InferenceEngine as JaxEngine
from llm_in_practise_tpu.serve.engine import SamplingParams as JaxParams
from llm_in_practise_tpu.serve.mixed_step import (
    plan_spec_extension as jax_plan_spec_extension,
)
from llm_in_practise_tpu.serve.mixed_step import (
    spec_verify_block as jax_spec_verify_block,
)
from llm_in_practise_tpu_torch.models.convert import params_from_jax
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
from llm_in_practise_tpu_torch.serve.disagg import (
    DECODE_DEFAULT_SPEC_K,
    default_speculative_k,
)
from llm_in_practise_tpu_torch.serve.engine import (
    InferenceEngine,
    SamplingParams,
)
from llm_in_practise_tpu_torch.serve.mixed_step import (
    plan_spec_extension,
    spec_verify_block,
)

K = 4
SHORT = ([5, 6, 7, 8] * 3, [2, 7, 1, 8, 2, 8, 1, 8])
LONG = [(i * 7 + 3) % 160 for i in range(30)]   # 30 tokens: 4 chunks of 8
PAGE = 8
ENGINE = dict(max_slots=4, cache_len=64, chunked_prefill=8, decode_steps=4,
              speculative_k=K)
KV_TOL = 1e-5


@pytest.fixture(scope="module")
def fixture_models():
    return load_fixture_both()


@pytest.fixture(scope="module")
def draft_models(fixture_models):
    """A 1-layer Qwen3 of the fixture's shape, numpy-seeded: the JAX model
    and params, and the same weights in the port."""
    jmodel = fixture_models[0]
    jdraft = JaxQwen3(dataclasses.replace(jmodel.cfg, n_layer=1))
    jparams = numpy_params(jdraft, seed=11)
    cfg = Qwen3Config.from_dict(jdraft.cfg.to_dict())
    pdraft = Qwen3(cfg, device="cpu")
    pdraft.load_state(params_from_jax(jparams, cfg))
    return jdraft, jparams, pdraft


# the engine knobs of each shared (layout, draft) pair: the paged pair with
# the 1-layer draft also has the prefix cache on (its later cases hit the
# pages of the earlier ones)
PAIRS = {("contiguous", "draft"): ENGINE, ("contiguous", "self"): ENGINE,
         ("paged", "draft"): dict(ENGINE, kv_layout="paged",
                                  kv_page_size=PAGE),
         ("paged", "self"): dict(ENGINE, kv_layout="paged",
                                 kv_page_size=PAGE)}


@pytest.fixture(scope="module")
def engine_pairs(fixture_models, draft_models):
    """One port engine and one JAX engine per (layout, draft), built at
    first use and shared by every case of that pair."""
    jmodel, jparams, pmodel = fixture_models
    drafts = {"draft": draft_models,
              "self": (jmodel, jparams, pmodel)}
    pairs = {}

    def get(layout, draft):
        key = (layout, draft)
        if key not in pairs:
            jd, jdp, pd = drafts[draft]
            kw = dict(PAIRS[key])
            if key == ("paged", "draft"):
                kw["prefix_cache"] = True
            port = InferenceEngine(pmodel, cache_dtype=torch.float32,
                                   draft_model=pd, **kw)
            jeng = JaxEngine(jmodel, jparams, cache_dtype=jnp.float32,
                             draft_model=jd, draft_params=jdp, **kw)
            pairs[key] = (port, jeng)
        return pairs[key]

    yield get
    for _, jeng in pairs.values():
        jeng.stop()


@contextlib.contextmanager
def _configured(engines, ngram=False, **attrs):
    """Both engines with the ngram proposer (their draft switched off)
    and ``attrs`` set, for one case."""
    saved = [(e.draft_model, {a: getattr(e, a) for a in attrs})
             for e in engines]
    for e in engines:
        if ngram:
            e.draft_model = None
        for a, v in attrs.items():
            setattr(e, a, v)
    try:
        yield engines
    finally:
        for e, (draft, old) in zip(engines, saved):
            e.draft_model = draft
            for a, v in old.items():
                setattr(e, a, v)


# --- the planners and the verify body ---------------------------------------


def test_plan_spec_extension_and_default_k_equal_jax():
    for block, k, head in itertools.product(
            range(0, 10), (1, 2, 4, 7), (-3, -1, 0, 1, 2, 3, 5, 6, 9, 40)):
        kw = dict(block=block, k=k, headroom=head)
        m = plan_spec_extension(**kw)
        assert m == jax_plan_spec_extension(**kw), kw
        assert 0 <= m <= max(block - 1, 0)
    assert DECODE_DEFAULT_SPEC_K == JAX_DECODE_DEFAULT_SPEC_K == 4
    for role, req in itertools.product(("both", "decode", "prefill"),
                                       (None, 0, 1, 4, 9)):
        assert default_speculative_k(role, req) == \
            jax_default_speculative_k(role, req), (role, req)


def _greedy_drafts(pmodel, cache_np, tokens, base, depth):
    """Set row r's drafts to the model's own greedy continuation for its
    first ``depth[r]`` positions (the rest stay as given), one verify of
    the port's body per position."""
    tokens = tokens.copy()
    for j in range(1, K + 1):
        cache = _port_cache(pmodel, cache_np)
        out, _, _, _ = spec_verify_block(
            pmodel, cache, torch.from_numpy(tokens),
            torch.from_numpy(base), torch.zeros(len(base), dtype=torch.int64),
            m=0)
        for r, d in enumerate(depth):
            if j <= d:
                tokens[r, j] = int(out[r, j - 1])
            elif j == d + 1:   # the first mismatch
                tokens[r, j] = (int(out[r, j - 1]) + 1) % 160
    return tokens


def _port_cache(pmodel, cache_np):
    cache = pmodel.init_cache(4, 64, dtype=torch.float32)
    for layer, (k, v) in zip(cache, cache_np):
        layer["k"].copy_(torch.from_numpy(k))
        layer["v"].copy_(torch.from_numpy(v))
    return cache


@pytest.mark.parametrize("m", [0, 3])
def test_spec_verify_block_equals_jax(fixture_models, m):
    jmodel, jparams, pmodel = fixture_models
    cfg = pmodel.config
    rng = np.random.default_rng(m)
    shape = (4, 64, cfg.n_kv_head, cfg.head_dim)
    cache_np = [tuple(rng.standard_normal(shape).astype(np.float32)
                      for _ in range(2)) for _ in range(cfg.n_layer)]
    base = np.array([10, 20, 5, 30], np.int64)
    mask = np.array([1, 1, 1, 0], np.int64)
    tokens = rng.integers(0, 160, size=(4, K + 1)).astype(np.int64)
    # row 0 matches every draft, row 1 two, row 2 none; row 3 is masked
    tokens = _greedy_drafts(pmodel, cache_np, tokens, base, (K, 2, 0, 1))
    cache = _port_cache(pmodel, cache_np)
    out, n_acc, extra, cache = spec_verify_block(
        pmodel, cache, torch.from_numpy(tokens), torch.from_numpy(base),
        torch.from_numpy(mask), m=m)
    jcache = [{"k": jnp.asarray(k), "v": jnp.asarray(v),
               "index": jnp.zeros((), jnp.int32)} for k, v in cache_np]
    verify = jax.jit(jax_spec_verify_block, static_argnums=0,
                     static_argnames="m")
    jout, jn_acc, jextra, jcache = verify(
        jmodel, jparams, jcache, jnp.asarray(tokens, jnp.int32),
        jnp.asarray(base), jnp.asarray(mask), m=m)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(jn_acc))
    assert n_acc.tolist()[:3] == [K, 2, 0]
    np.testing.assert_array_equal(extra.numpy(), np.asarray(jextra))
    assert extra.shape == (4, m)
    index = cache[0]["index"].numpy()
    np.testing.assert_array_equal(index, np.asarray(jcache[0]["index"]))
    np.testing.assert_array_equal(index, base + (n_acc.numpy() + 1 + m)
                                  * mask)
    for pl, jl in zip(cache, jcache):
        for key in ("k", "v"):
            got, want = pl[key].numpy(), np.asarray(jl[key])
            for s in range(4):
                np.testing.assert_allclose(
                    got[s, :index[s]], want[s, :index[s]], rtol=KV_TOL,
                    atol=KV_TOL)


# --- the engine in lockstep with JAX ----------------------------------------


def _watermarks(eng) -> np.ndarray:
    valid = np.zeros((eng.max_slots,), np.int64)
    for s, req in enumerate(eng.slot_req):
        if req is not None and eng.slot_ready[s]:
            valid[s] = eng.slot_len[s]
    for s, st in eng.slot_prefill.items():
        valid[s] = st["done"]
    return valid


def _kv_rows(eng, slot, valid):
    """Each layer's (k, v) rows ``[0, valid)`` of ``slot``, as numpy."""
    if eng.paged is not None:
        bt = eng.paged.block_tables
        t = np.arange(valid)
        rows = bt[slot, t // PAGE] * PAGE + t % PAGE
        return [tuple(np.asarray(layer[key])[rows] for key in ("k", "v"))
                for layer in eng.paged.kv]
    return [tuple(np.asarray(layer[key])[slot, :valid]
                  for key in ("k", "v")) for layer in eng.cache]


SPEC_COUNTERS = ("spec_proposed", "spec_accepted", "spec_rounds",
                 "spec_round_tokens")


def _assert_same_state(port, jeng, where):
    assert [r is None for r in port.slot_req] == \
        [r is None for r in jeng.slot_req], where
    assert {s: st["done"] for s, st in port.slot_prefill.items()} == \
        {s: st["done"] for s, st in jeng.slot_prefill.items()}, where
    valid = _watermarks(port)
    np.testing.assert_array_equal(valid, _watermarks(jeng), err_msg=where)
    for s in range(port.max_slots):
        if port.slot_req[s] is not None and port.slot_ready[s]:
            assert port.slot_last_token[s] == jeng.slot_last_token[s], where
            assert port.slot_budget[s] == jeng.slot_budget[s], where
    assert [getattr(port, c) for c in SPEC_COUNTERS] == \
        [getattr(jeng, c) for c in SPEC_COUNTERS], where
    if port.paged is not None:
        np.testing.assert_array_equal(port.paged.block_tables,
                                      jeng.paged.block_tables, err_msg=where)
        assert port.paged.pool.snapshot() == jeng.paged.pool.snapshot(), \
            where
    for s in range(port.max_slots):
        for i, (got, want) in enumerate(zip(_kv_rows(port, s, valid[s]),
                                            _kv_rows(jeng, s, valid[s]))):
            for g, w in zip(got, want):
                np.testing.assert_allclose(
                    g, w, rtol=KV_TOL, atol=KV_TOL,
                    err_msg=f"{where}: layer {i} slot {s}")
    if port.draft_model is None:
        return
    synced = np.where(jeng._draft_uid >= 0, jeng._draft_sync, 0)
    np.testing.assert_array_equal(
        np.where(port._draft_uid >= 0, port._draft_sync, 0), synced,
        err_msg=where)
    for s in range(port.max_slots):
        n = int(synced[s])
        for pl, jl in zip(port.draft_cache, jeng.draft_cache):
            for key in ("k", "v"):
                np.testing.assert_allclose(
                    pl[key][s, :n].numpy(), np.asarray(jl[key])[s, :n],
                    rtol=KV_TOL, atol=KV_TOL,
                    err_msg=f"{where}: draft {key} slot {s}")


def _run_lockstep(port, jeng, short_tokens=24, long_tokens=8):
    """The mixed load in lockstep: the chats, one step, then the long
    prompt; state compared after every step."""
    rounds0 = port.spec_rounds
    hp = [port.submit(p, SamplingParams(greedy=True, max_tokens=short_tokens))
          for p in SHORT]
    hj = [jeng.submit(p, JaxParams(greedy=True, max_tokens=short_tokens))
          for p in SHORT]
    assert port.step() and jeng.step()
    hp.append(port.submit(LONG, SamplingParams(greedy=True,
                                               max_tokens=long_tokens)))
    hj.append(jeng.submit(LONG, JaxParams(greedy=True,
                                          max_tokens=long_tokens)))
    _assert_same_state(port, jeng, "after the first step")
    for i in itertools.count():
        assert i < 64, "the load never drained"
        busy = port.step()
        assert busy == jeng.step(), f"step {i}"
        _assert_same_state(port, jeng, f"step {i}")
        if not busy:
            break
    assert [r.result() for r in hp] == [r.result() for r in hj]
    assert [r.finish_reason for r in hp] == [r.finish_reason for r in hj]
    assert port.spec_rounds > rounds0
    if port.paged is not None:
        if port.prefix_cache is not None:
            port.prefix_cache.clear()
            jeng.prefix_cache.clear()
        port.paged.pool.check_leaks(0)
        jeng.paged.pool.check_leaks(0)
    return hp


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("proposer", ["ngram", "draft", "self"])
def test_lockstep_matches_jax_engine(engine_pairs, layout, proposer):
    draft = "draft" if proposer == "ngram" else proposer
    with _configured(engine_pairs(layout, draft),
                     ngram=proposer == "ngram") as (port, jeng):
        hp = _run_lockstep(port, jeng)
    assert [len(r.output_ids) for r in hp] == [24, 24, 8]
    if proposer == "self":      # the target drafts itself: all accepted
        assert port.spec_accepted == port.spec_proposed > 0


def test_lockstep_decode_steps_1_speculates_mid_prefill(engine_pairs):
    """At ``decode_steps`` 1 the spec round composes with the chunked
    prefill: rounds land while the long prompt is mid-prefill."""
    with _configured(engine_pairs("contiguous", "draft"), ngram=True,
                     decode_steps=1) as (port, jeng):
        mid = []
        step = port.step

        def counting_step():
            before = port.spec_rounds
            busy = step()
            if port.slot_prefill and port.spec_rounds > before:
                mid.append(port.spec_rounds)
            return busy

        port.step = counting_step
        try:
            _run_lockstep(port, jeng)
        finally:
            del port.step
    assert mid, "no spec round ran while the prompt was mid-prefill"


def test_preemption_between_rounds_streams_equal(engine_pairs,
                                                 fixture_models):
    """A paged engine with the prefix cache and the 1-layer draft on a
    pool that the draft's cache shrinks to 96 tokens preempts between
    rounds; its streams equal an unpreempted engine's and the JAX
    engine's."""
    pmodel = fixture_models[2]
    port, jeng = engine_pairs("paged", "draft")
    tight = InferenceEngine(pmodel, cache_dtype=torch.float32,
                            draft_model=port.draft_model, prefix_cache=True,
                            **{**PAIRS[("paged", "draft")],
                               # 128: the draft cache's 4 x 64 rows at
                               # half the target's bytes per row
                               "kv_pool_tokens": 96 + 128})
    assert tight.draft_kv_reserved_tokens == 128
    prompts = [[(j * 3 + i) % 160 for i in range(20)] for j in range(3)]
    sp = SamplingParams(greedy=True, max_tokens=30)
    hs = [tight.submit(p, sp) for p in prompts]
    while tight.step():
        pass
    assert tight.preemptions > 0 and tight.spec_rounds > 0
    hj = [jeng.submit(p, JaxParams(greedy=True, max_tokens=30))
          for p in prompts]
    while jeng.step():
        pass
    free = InferenceEngine(pmodel, cache_dtype=torch.float32,
                           **{**PAIRS[("paged", "draft")],
                              "speculative_k": None})
    for p, h, j in zip(prompts, hs, hj):
        assert h.finish_reason == "length"
        assert h.result() == j.result() == free.generate(p, sp)
    tight.prefix_cache.clear()
    tight.paged.pool.check_leaks(0)
    jeng.prefix_cache.clear()
    jeng.paged.pool.check_leaks(0)


# --- the draft's pool tax, and the knobs --------------------------------------


def test_draft_pool_deduction_and_debug_kv_equal_jax(fixture_models,
                                                     draft_models):
    jmodel, jparams, pmodel = fixture_models
    jdraft, jdparams, pdraft = draft_models
    kw = dict(max_slots=4, cache_len=64, kv_layout="paged",
              kv_page_size=PAGE, speculative_k=K)
    for pool in (None, 400):
        extra = {} if pool is None else {"kv_pool_tokens": pool}
        port = InferenceEngine(pmodel, cache_dtype=torch.float32,
                               draft_model=pdraft, **kw, **extra)
        jeng = JaxEngine(jmodel, jparams, cache_dtype=jnp.float32,
                         draft_model=jdraft, draft_params=jdparams, **kw,
                         **extra)
        try:
            snap, want = port.debug_kv(), jeng.debug_kv()
            for key in ("pages_total", "draft_kv_reserved_tokens",
                        "pool_bytes"):
                assert snap[key] == want[key], key
            # JAX books the draft cache's whole tree: its per-layer int32
            # index vectors too
            index_bytes = jdraft.cfg.n_layer * 4 * 4
            assert snap["draft_kv_account_bytes"] == \
                want["draft_kv_account_bytes"] - index_bytes > 0
            assert set(want) - set(snap) == {"ledger_account"}
        finally:
            jeng.stop()
    assert port.draft_kv_reserved_tokens == 128
    with pytest.raises(ValueError, match="after the draft cache") as e:
        InferenceEngine(pmodel, draft_model=pdraft, kv_pool_tokens=140,
                        **kw)
    with pytest.raises(ValueError, match="after the draft cache") as je:
        JaxEngine(jmodel, jparams, draft_model=jdraft, draft_params=jdparams,
                  kv_pool_tokens=140, **kw)
    assert str(e.value) == str(je.value)


@pytest.mark.parametrize("knob,match", [
    (dict(speculative_k=0), "speculative_k must be >= 1"),
    (dict(draft="yes"), "draft_model needs speculative_k")])
def test_spec_knobs_are_validated_as_in_jax(fixture_models, knob, match):
    jmodel, jparams, pmodel = fixture_models
    pkw = dict(knob)
    jkw = dict(knob)
    if pkw.pop("draft", None):
        pkw["draft_model"] = pmodel
        jkw.pop("draft")
        jkw.update(draft_model=jmodel, draft_params=jparams)
    with pytest.raises(ValueError, match=match):
        InferenceEngine(pmodel, max_slots=2, cache_len=32, **pkw)
    with pytest.raises(ValueError, match=match):
        JaxEngine(jmodel, jparams, max_slots=2, cache_len=32, **jkw)


# --- the red reference test's stated contract, and the plain path -------------

REPETITIVE = [1, 2, 3, 4, 5] * 6


def test_spec_round_dispatch_contract(fixture_models):
    """An ngram round is one dispatch; a draft round is two (the roll,
    then the verify) once the draft's gap fits its window; a wider gap
    adds one eager catch-up chunk per window. The target as its own draft
    at k = 4 and ``decode_steps`` 4 commits k accepted + the bonus + 3
    extension tokens = 8 in one round."""
    pmodel = fixture_models[2]
    eng = InferenceEngine(pmodel, max_slots=4, cache_len=64,
                          cache_dtype=torch.float32, speculative_k=K,
                          decode_steps=4, draft_model=pmodel)
    h = eng.submit(REPETITIVE, SamplingParams(greedy=True, max_tokens=30))
    eng.step()       # the prefill, its first token and the first round
    assert eng.spec_rounds == 1 and h.n_generated == 1 + K + 1 + 3
    # 31 tokens to sync against a window of 16: one chunk, then the roll
    assert eng.draft_chunks_run == 1 and eng.draft_rolls_run == 1
    assert eng.last_step_dispatches == 1 + 1 + 2
    gen0 = h.n_generated
    eng.step()                          # one fused spec round
    assert eng.spec_rounds == 2
    assert h.n_generated - gen0 == K + 1 + 3
    assert eng.draft_chunks_run == 1
    assert eng.last_step_dispatches == 2

    ngram = InferenceEngine(pmodel, max_slots=4, cache_len=64,
                            cache_dtype=torch.float32, speculative_k=3,
                            decode_steps=4)
    h = ngram.submit(REPETITIVE, SamplingParams(greedy=True, max_tokens=30))
    ngram.step()
    gen0 = h.n_generated
    while ngram.spec_rounds == 0 and h.finish_reason is None:
        gen0 = h.n_generated
        ngram.step()
    assert ngram.spec_rounds >= 1
    assert ngram.last_step_dispatches == 1
    assert h.n_generated - gen0 > 1


def test_sampled_and_cache_tail_take_the_plain_path(fixture_models):
    pmodel = fixture_models[2]
    kw = dict(max_slots=2, cache_len=64, cache_dtype=torch.float32,
              decode_steps=4)
    spec = InferenceEngine(pmodel, speculative_k=K, draft_model=pmodel,
                           seed=3, **kw)
    plain = InferenceEngine(pmodel, seed=3, **kw)
    sampled = SamplingParams(temperature=0.8, top_k=20, max_tokens=12)
    assert spec.generate(REPETITIVE, sampled) == \
        plain.generate(REPETITIVE, sampled)
    assert spec.spec_rounds == 0 and spec.draft_rolls_run == 0
    # a 58-token prompt: no round fits the cache (58 + k + 1 > 64)
    tail = [(i * 5 + 1) % 160 for i in range(58)]
    greedy = SamplingParams(greedy=True, max_tokens=8)
    assert spec.generate(tail, greedy) == plain.generate(tail, greedy)
    assert spec.spec_rounds == 0


# --- the CLI -------------------------------------------------------------------


@pytest.mark.parametrize("argv,message", [
    (["--draft-model-path", "d.msgpack"], "requires --speculative K"),
    (["--draft-model-path", "d.msgpack", "--speculative", "0"],
     "contradictory"),
    (["--draft-model-path", "d.msgpack", "--speculative", "4",
      "--scan-layers", "--kv-layout", "contiguous"], "--scan-layers"),
    (["--scan-layers"], "--kv-layout contiguous")])
def test_cli_argument_errors(argv, message, capsys):
    from llm_in_practise_tpu_torch.serve.__main__ import main

    with pytest.raises(SystemExit):
        main(["--tokenizer_path", "t"] + argv)
    assert message in capsys.readouterr().err


def test_cli_speculative_resolves_and_serves_with_a_draft(tmp_path):
    from llm_in_practise_tpu_torch.ckpt.checkpoint import save_named
    from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
    from llm_in_practise_tpu_torch.data.sft import IM_END, IM_START
    from llm_in_practise_tpu_torch.models.convert import params_to_jax
    from llm_in_practise_tpu_torch.serve.__main__ import (
        build_parser,
        build_server,
        validate_args,
    )

    parser = build_parser()

    def error(msg):
        raise AssertionError(msg)

    args = parser.parse_args(["--tokenizer_path", "t", "--speculative"])
    validate_args(args, error)
    assert args.speculative == 4
    args = parser.parse_args(["--tokenizer_path", "t", "--speculative", "0"])
    validate_args(args, error)
    assert args.speculative is None

    text = "one two three four five six seven eight " * 3
    tok = BPETokenizer.train([text] * 4, vocab_size=300,
                             special_tokens=[IM_START, IM_END],
                             min_frequency=1)
    tok_path = str(tmp_path / "tok.json")
    tok.save(tok_path)
    # the fixture's shape at the tokenizer's vocabulary
    pmodel = tiny_port_model(tok.get_vocab_size(), seed=7, max_seq_len=128,
                             hidden_size=64, intermediate_size=128,
                             n_head=4, n_kv_head=2, head_dim=16)
    state = {n: p.detach() for n, p in pmodel.named_parameters()}
    meta = {"config": pmodel.cfg.to_dict()}
    target = save_named(str(tmp_path / "t"), params_to_jax(
        state, pmodel.cfg), "model", metadata=meta)
    draft = save_named(str(tmp_path / "d"), params_to_jax(
        state, pmodel.cfg), "model", metadata=meta)
    args = parser.parse_args(
        ["--model_path", target, "--tokenizer_path", tok_path, "--device",
         "cpu", "--max_slots", "2", "--cache_len", "128", "--speculative",
         "4", "--draft-model-path", draft, "--decode-steps", "4"])
    validate_args(args, error)
    server = build_server(args)
    engine = server.engine
    assert engine.paged is not None and engine.speculative_k == 4
    assert engine.draft_model is not None and engine.draft_model is not \
        engine.model
    port = server.serve(host="127.0.0.1", port=0, background=True)
    try:
        body = {"model": "qwen3-h100", "temperature": 0.0, "max_tokens": 12,
                "messages": [{"role": "user", "content": text}]}
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/chat/completions",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
    finally:
        server.shutdown()
    assert out["choices"][0]["finish_reason"] in ("stop", "length")
    assert engine.spec_rounds > 0 and engine.draft_rolls_run > 0
    # the drafted weights are the target's: every draft is accepted
    assert engine.spec_accepted == engine.spec_proposed > 0


def test_graph_kinds_keys_on_the_cpu(fixture_models):
    """The engine routes its spec rounds and rolls through the graph
    runner's ``spec`` / ``pspec`` / ``droll`` kinds (run eagerly here)."""
    pmodel = fixture_models[2]
    seen = []
    for layout in ("contiguous", "paged"):
        eng = InferenceEngine(pmodel, max_slots=2, cache_len=64,
                              cache_dtype=torch.float32, speculative_k=K,
                              decode_steps=4, draft_model=pmodel,
                              kv_layout=layout, kv_page_size=PAGE)
        run = eng.graphs.run

        def recording(kind, n, **kw):
            seen.append((kind, n, kw.get("width")))
            return run(kind, n, **kw)

        eng.graphs.run = recording
        eng.generate(REPETITIVE, SamplingParams(greedy=True, max_tokens=10))
    kinds = {k for k, _, _ in seen}
    assert {"spec", "pspec", "droll"} <= kinds
    assert all(n == K and w == 16 for k, n, w in seen if k == "droll")
    assert all(w is not None for k, _, w in seen if k == "pspec")
