"""PyTorch port: the prefix cache (``serve/prefix_cache.py`` and the
engine's hit paths) against the JAX package.

- ``PagedPrefixIndex`` and ``PrefixLRU`` against JAX's on the same
  operation sequences: chain lookups and their cap, the token budget,
  cascading eviction through the pool's reclaim hook, the release of a
  deep chain, counters and pool refcounts, all exact.
- Copy-on-write prefix sharing on the committed HF fixture (f32, pages of
  8): a partial hit's ``hits`` and ``tokens_saved`` equal the JAX paged
  engine's and its tokens equal JAX's and a cold engine's; shared pages
  carry refcount >= 2 while a sharer runs; the forced fork of a shared
  page leaves the sharer's page untouched.
- The contiguous layout's row cache: full and partial hits with the JAX
  engine's counters and tokens.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import load_fixture_both, tiny_port_model

from llm_in_practise_tpu.serve import paged_kv as jax_paged
from llm_in_practise_tpu.serve import prefix_cache as jax_prefix
from llm_in_practise_tpu.serve.engine import InferenceEngine as JaxEngine
from llm_in_practise_tpu.serve.engine import SamplingParams as JaxParams
from llm_in_practise_tpu_torch.serve import paged_kv, prefix_cache
from llm_in_practise_tpu_torch.serve.engine import (
    InferenceEngine,
    SamplingParams,
)

PAGE = 8
BASE = [(i * 5 + 1) % 160 for i in range(40)]
SHARED = BASE[:36] + [60, 61]             # shares 4 full pages of BASE
ENGINE = dict(max_slots=4, cache_len=64, kv_page_size=PAGE,
              prefix_cache=True, chunked_prefill=None)


@pytest.fixture(scope="module")
def fixture_models():
    return load_fixture_both()


def _both(fn):
    """``fn(paged_module, prefix_module)`` on the port and on JAX."""
    return [fn(pk, pc) for pk, pc in ((paged_kv, prefix_cache),
                                      (jax_paged, jax_prefix))]


def _counters(idx):
    return (idx.hits, idx.misses, idx.full_hits, idx.tokens_saved,
            idx.n_entries, idx.cached_tokens)


def test_paged_index_matches_jax():
    def run(pk, pc):
        pool = pk.PagePool(num_pages=40, page_size=4)
        idx = pc.PagedPrefixIndex(pool, max_tokens=40, min_prefix=4)
        pool.reclaim = idx.evict_pages
        trace = []
        toks = list(range(12))                 # 3 full pages
        pages = pool.alloc(3)
        trace.append(idx.register(toks, pages))
        # a full-prompt hit stops at (len - 1) // P pages
        hit = idx.lookup(toks)
        trace += [hit, _counters(idx)]
        pool.release(hit)
        # a prompt diverging in its third page matches two
        hit = idx.lookup(toks[:8] + [99, 98, 97, 96, 1, 2])
        trace += [hit, _counters(idx)]
        pool.release(hit)
        trace += [idx.lookup([50] * 12), idx.lookup([1, 2]), _counters(idx)]
        # a second chain sharing the first page, then a budget overflow
        other = pool.alloc(4)
        trace.append(idx.register(toks[:4] + list(range(20, 32)), other))
        more = pool.alloc(5)
        trace.append(idx.register(list(range(100, 120)), more))
        trace += [_counters(idx), pool._refs.tolist(), list(pool._free)]
        pool.release(pages + other + more)
        # the reclaim hook: an allocation past the free list evicts LRU
        # chains (cascading), their pages then free
        trace.append(pool.try_alloc(len(pool._free) + 2))
        trace += [_counters(idx), pool._refs.tolist(), list(pool._free)]
        idx.clear()
        trace += [_counters(idx), pool.snapshot()]
        return trace

    port, ref = _both(run)
    assert port == ref


def test_paged_index_deep_chain_eviction_matches_jax():
    def run(pk, pc):
        pool = pk.PagePool(num_pages=1302, page_size=4)
        idx = pc.PagedPrefixIndex(pool, max_tokens=1 << 30, min_prefix=4)
        toks = [int(x) for x in np.arange(4 * 1200) % 64]
        pages = pool.alloc(1200)
        created = idx.register(toks, pages)
        pool.release(pages)
        dropped = idx.evict_pages(1)           # the whole chain cascades
        pool.check_leaks(0)
        return created, dropped, _counters(idx), list(pool._free)[:8]

    port, ref = _both(run)
    assert port == ref and port[:2] == (1200, 1200)


def test_prefix_lru_matches_jax():
    def run(pk, pc):
        lru = pc.PrefixLRU(max_tokens=20, min_prefix=3,
                           length_of=lambda v: v[0])
        trace = []
        lru.put([1, 2, 3, 4], (4, "a"))
        lru.put([1, 2, 3, 4, 5, 6, 7, 8], (8, "b"))
        lru.put([9, 9], (2, "short"))          # below min_prefix: ignored
        trace.append(lru.lookup([1, 2, 3, 4, 5, 6, 7, 8, 9]))
        trace.append(lru.lookup([1, 2, 3, 4, 0]))
        trace.append(lru.lookup([1, 2, 3, 4, 5, 6, 7, 8, 9],
                                usable=lambda v: v[0] < 8))
        trace.append(lru.lookup([7, 7, 7]))
        lru.put([5, 5, 5, 5, 5, 5], (6, "c"))
        lru.put([6, 6, 6, 6, 6, 6, 6], (7, "d"))   # over budget: evicts
        trace += [lru.cached_tokens, lru.n_entries, lru.hits, lru.misses,
                  lru.lookup([1, 2, 3, 4, 9]), lru.lookup([5] * 7),
                  lru.lookup([6] * 8)]
        lru.clear()
        trace += [lru.cached_tokens, lru.n_entries]
        cache = pc.PrefixCache(max_tokens=64, min_prefix=2)
        cache.put([1, 2, 3], pc.PrefixEntry(3, 3, [], None))
        hit = cache.lookup([1, 2, 3])
        trace += [hit.length, cache.full_hits, cache.tokens_saved]
        return trace

    port, ref = _both(run)
    assert port == ref


# --- copy-on-write prefix sharing in the engine -----------------------------


def _jax_engine(fixture_models, layout):
    jmodel, jparams, _ = fixture_models
    return JaxEngine(jmodel, jparams, cache_dtype=jnp.float32,
                     kv_layout=layout, **ENGINE)


def _port_engine(fixture_models, layout, **kw):
    return InferenceEngine(fixture_models[2], cache_dtype=torch.float32,
                           kv_layout=layout, **{**ENGINE, **kw})


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_prefix_hits_match_jax(fixture_models, layout):
    """BASE, then SHARED (a partial hit: 4 shared pages in the paged
    layout; a miss in the contiguous one, whose entries are whole
    prompts), BASE again (a hit capped below the last position / a full
    hit), then BASE extended by two tokens (5 pages / a partial hit on
    the BASE entry): the counters equal the JAX engine's, the tokens
    equal JAX's and a cold engine's."""
    sp = SamplingParams(greedy=True, max_tokens=12)
    port = _port_engine(fixture_models, layout)
    jeng = _jax_engine(fixture_models, layout)
    cold = InferenceEngine(fixture_models[2], max_slots=4, cache_len=64,
                           cache_dtype=torch.float32)
    try:
        for prompt in (BASE, SHARED, BASE, BASE + [7, 8]):
            got = port.generate(prompt, sp)
            want = jeng.generate(prompt, JaxParams(greedy=True,
                                                   max_tokens=12))
            assert got == want == cold.generate(prompt, sp)
            assert _counters(port.prefix_cache)[:4] == \
                _counters(jeng.prefix_cache)[:4]
        expect = {"paged": (3, 1, 3, 104), "contiguous": (2, 2, 1, 80)}
        assert _counters(port.prefix_cache)[:4] == expect[layout]
        if layout == "paged":
            assert (port.prefix_cache.n_entries
                    == jeng.prefix_cache.n_entries)
            np.testing.assert_array_equal(port.paged.block_tables,
                                          jeng.paged.block_tables)
            port.prefix_cache.clear()
            port.paged.pool.check_leaks(0)
    finally:
        jeng.stop()


def test_shared_pages_refcounted_while_running(fixture_models):
    e = _port_engine(fixture_models, "paged")
    e.generate(BASE, SamplingParams(greedy=True, max_tokens=4))
    h = e.submit(SHARED, SamplingParams(greedy=True, max_tokens=20))
    e.step()                                   # admitted: pages shared
    slot = next(s for s, r in enumerate(e.slot_req) if r is h)
    shared = e.paged.slot_pages(slot)[:4]
    assert all(e.paged.pool.refcount(p) >= 2 for p in shared)
    assert e.debug_kv()["pages_shared"] >= 4
    while e.step():
        pass
    assert len(h.result()) == 20
    e.prefix_cache.clear()
    e.paged.pool.check_leaks(0)


def test_cow_fork_on_shared_write():
    """Force a write window onto a shared page: the writer gets a private
    copy, refcounts drop back, the sharer's page keeps its bytes."""
    model = tiny_port_model(64, seed=9)
    e = InferenceEngine(model, max_slots=2, cache_len=64,
                        cache_dtype=torch.float32, kv_layout="paged",
                        kv_page_size=16)
    pool = e.paged.pool
    pages = pool.alloc(2)
    e.paged.map_shared(0, list(pages))          # slot 0 maps them
    pool.share(pages)                           # a second reader
    for layer in e.paged.kv:                    # recognisable bytes
        for key in ("k", "v"):
            layer[key].normal_()
    before = [layer["k"][pages[1] * 16: pages[1] * 16 + 16].clone()
              for layer in e.paged.kv]
    e._paged_cow_fork(0, 20, 4)                 # a window inside page 1
    forked = int(e.paged.block_tables[0, 1])
    assert forked != pages[1] and int(e.paged.block_tables[0, 0]) == pages[0]
    assert pool.refcount(pages[1]) == 1 and pool.refcount(forked) == 1
    for layer, snap in zip(e.paged.kv, before):
        assert torch.equal(layer["k"][forked * 16: forked * 16 + 16], snap)
        assert torch.equal(layer["k"][pages[1] * 16: pages[1] * 16 + 16],
                           snap)
    e.paged.release_slot(0)
    pool.release(pages)
    pool.check_leaks(0)
