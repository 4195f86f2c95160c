"""PyTorch port: session-native serving (``serve/sessions.py`` and the
session paths of the engine, the API and the CLI) against the JAX
package, on the committed HF fixture in f32.

- The ring and the wire key: ``ConsistentHashRing.owners()`` and
  ``session_hid`` equal JAX's on the same nodes and keys.
- The store: the five contracts of JAX's ``test_sessions.py`` store tests
  (pin and replace, TTL and capacity eviction, pressure reclaim newest
  pages first, the chained reclaim hook, adopt / take_pending
  validation), on a stand-in pool whose ``paged`` namespace has no
  ``page_bytes`` (the case the JAX store fails on) and on one that has
  it (then the ``session_pins`` ledger account follows the pins).
- The engine in lockstep with the JAX engine: a session's turns pin and
  warm-hit, a migration through the handoff store, a lost pull and a
  mismatched pull each give the JAX engine's greedy tokens, with JAX's
  store counters.
- HTTP: the session flow over ``X-Session-ID`` with ``/debug/sessions``
  and ``/metrics``, the claim on a miss across two servers sharing a
  handoff store, and the chat page at ``GET /`` and ``/chat`` (byte-equal
  to JAX's ``webui_html``).
"""

import json
import time
import types
import urllib.request

import jax.numpy as jnp
import pytest
import torch

from torch_port_util import load_fixture_both

from llm_in_practise_tpu.serve import sessions as jsessions
from llm_in_practise_tpu.serve.engine import InferenceEngine as JaxEngine
from llm_in_practise_tpu.serve.engine import SamplingParams as JaxParams
from llm_in_practise_tpu_torch.obs.hbm import get_ledger
from llm_in_practise_tpu_torch.serve.api import OpenAIServer, webui_html
from llm_in_practise_tpu_torch.serve.disagg import LocalHandoff
from llm_in_practise_tpu_torch.serve.engine import (
    InferenceEngine,
    SamplingParams,
)
from llm_in_practise_tpu_torch.serve.sessions import (
    ConsistentHashRing,
    SessionStore,
    session_hid,
)

torch.set_num_threads(1)

P = 8                                            # tokens per page
P1 = [(i * 11 + 3) % 160 for i in range(20)]
EXTRA = [(i * 5 + 1) % 160 for i in range(8)]
NEW = 8
SP = SamplingParams(greedy=True, max_tokens=NEW)
JSP = JaxParams(greedy=True, max_tokens=NEW)


@pytest.fixture(scope="module")
def fixture_models():
    return load_fixture_both()


def _port(fixture_models, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("cache_len", 64)
    kw.setdefault("kv_page_size", P)
    kw.setdefault("cache_dtype", torch.float32)
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("prefix_cache", True)
    return InferenceEngine(fixture_models[2], **kw)


def _jax(fixture_models, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("cache_len", 64)
    kw.setdefault("kv_page_size", P)
    kw.setdefault("cache_dtype", jnp.float32)
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("prefix_cache", True)
    return JaxEngine(fixture_models[0], fixture_models[1], **kw)


@pytest.fixture(scope="module")
def jax_ref(fixture_models):
    """A session-less JAX engine: the golden tokens of every prompt."""
    eng = _jax(fixture_models)
    yield eng
    eng.stop()


def _run(eng, prompt, sid=None, sp=SP):
    h = eng.submit(prompt, sp, session_id=sid)
    while eng.step():
        pass
    return h.result()


# --- the ring and the wire key ---------------------------------------------------


def test_ring_owners_and_session_hid_equal_jax():
    nodes = [f"http://h{i}:8000" for i in range(5)]
    keys = [f"sess-{k}" for k in range(300)] + ["", "x" * 200, "séance"]
    ours, theirs = ConsistentHashRing(nodes), jsessions.ConsistentHashRing(
        nodes)
    for k in keys:
        for n in (1, 2, 5, 9):
            assert ours.owners(k, n) == theirs.owners(k, n)
        assert session_hid(k) == jsessions.session_hid(k)
    # a node leaving: the same survivors' keys on both sides
    less = nodes[:-1]
    assert ([ConsistentHashRing(less).owner(k) for k in keys]
            == [jsessions.ConsistentHashRing(less).owner(k) for k in keys])
    assert ConsistentHashRing([]).owners("k") == []
    assert len(ConsistentHashRing(nodes + nodes[:2])) == len(nodes)


# --- the store contracts -----------------------------------------------------------


class _FakePool:
    def __init__(self):
        self.refs: dict[int, int] = {}
        self.reclaim = None

    def share(self, pages):
        for p in pages:
            self.refs[p] = self.refs.get(p, 0) + 1

    def release(self, pages):
        for p in pages:
            self.refs[p] -= 1
            if self.refs[p] == 0:
                del self.refs[p]


PAGE_BYTES = (None, 64)   # a paged namespace without the byte rate, and with


def _paged(pool, page_bytes):
    ns = types.SimpleNamespace(pool=pool, page_size=16)
    if page_bytes is not None:
        ns.page_bytes = page_bytes
    return ns


def _store(page_bytes, pool=None, **kw):
    pool = pool or _FakePool()
    kw.setdefault("ttl_s", 100.0)
    store = SessionStore(**kw)
    store.attach(types.SimpleNamespace(handoff=None,
                                       paged=_paged(pool, page_bytes)))
    return store, pool


def _pins_booked(page_bytes, store, base):
    """The session_pins account moved by exactly the pinned pages (or not
    at all without a byte rate)."""
    moved = get_ledger().account_bytes("session_pins") - base
    assert moved == store.pinned_pages * (page_bytes or 0)


@pytest.mark.parametrize("page_bytes", PAGE_BYTES)
def test_store_pin_replace_and_release(page_bytes):
    base = get_ledger().account_bytes("session_pins")
    store, pool = _store(page_bytes)
    store.note_finish("s", [1] * 32, [10, 11], cache_outcome="cold")
    assert pool.refs == {10: 1, 11: 1}
    _pins_booked(page_bytes, store, base)
    store.note_finish("s", [1] * 64, [10, 11, 12], cache_outcome="partial")
    assert pool.refs == {10: 1, 11: 1, 12: 1}   # re-pin, never double
    _pins_booked(page_bytes, store, base)
    assert store.lookup("s").turns == 2
    assert store.counters()["turns"] == {"hit": 0, "partial": 1, "cold": 1}
    assert store.drop("s") and pool.refs == {}
    _pins_booked(page_bytes, store, base)


@pytest.mark.parametrize("page_bytes", PAGE_BYTES)
def test_store_ttl_and_capacity_eviction(page_bytes):
    base = get_ledger().account_bytes("session_pins")
    clk = {"t": 0.0}
    store, pool = _store(page_bytes, ttl_s=10.0, max_sessions=2,
                         clock=lambda: clk["t"])
    store.note_finish("a", [1], [1])
    store.note_finish("b", [1], [2])
    store.note_finish("c", [1], [3])            # capacity: LRU 'a' dies
    assert store.lookup("a") is None and 1 not in pool.refs
    assert store.evictions["capacity"] == 1
    _pins_booked(page_bytes, store, base)
    clk["t"] = 11.0
    assert store.sweep() == 2                   # TTL kills b and c
    assert store.active == 0 and pool.refs == {}
    assert store.evictions["ttl"] == 2
    _pins_booked(page_bytes, store, base)


@pytest.mark.parametrize("page_bytes", PAGE_BYTES)
def test_store_pressure_reclaim_newest_pages_first(page_bytes):
    base = get_ledger().account_bytes("session_pins")
    store, pool = _store(page_bytes)
    store.note_finish("old", list(range(64)), [1, 2, 3, 4])
    store.note_finish("new", list(range(64)), [9, 8, 7, 6])
    freed = store.reclaim_pages(2)
    assert freed == 2
    # LRU session first ('old'), NEWEST pages first: the surviving pin
    # [1, 2] is still a valid chain prefix
    assert store.lookup("old").pages == [1, 2]
    assert store.lookup("new").pages == [9, 8, 7, 6]
    assert 3 not in pool.refs and 4 not in pool.refs
    assert store.evictions["pressure"] == 1
    # the pool hook's shortfall reaches the sessions
    freed = pool.reclaim(3)
    assert freed == 3 and store.pinned_pages == 3
    _pins_booked(page_bytes, store, base)
    store.close()
    _pins_booked(page_bytes, store, base)


@pytest.mark.parametrize("page_bytes", PAGE_BYTES)
def test_store_reclaim_chains_after_prior_hook(page_bytes):
    pool = _FakePool()
    pool.reclaim = lambda n: min(n, 2)          # the COW index frees 2
    store, _ = _store(page_bytes, pool=pool)
    store.note_finish("s", list(range(64)), [1, 2, 3, 4])
    assert pool.reclaim(3) == 3                 # 2 prior + 1 session pin
    assert store.lookup("s").pages == [1, 2, 3]
    store.close()


def _host(length, token_ids, **kw):
    return types.SimpleNamespace(length=length, token_ids=token_ids,
                                 last_logits=None, slot_axis=0, **kw)


@pytest.mark.parametrize("page_bytes", PAGE_BYTES)
def test_adopt_and_take_pending_validation(page_bytes):
    store, _ = _store(page_bytes)
    # entries without token ids cannot be validated: lost
    assert not store.adopt("s", _host(32, None))
    assert store.pulls["lost"] == 1
    toks = list(range(32))
    assert store.adopt("s", _host(32, toks))
    assert store.known("s")
    # longest common prefix, capped at the KV length
    host, n = store.take_pending("s", toks + [99, 98])
    assert n == 32
    assert store.take_pending("s", toks) is None        # consumed once
    # a diverging tail: a shorter match
    assert store.adopt("s", _host(32, toks))
    _, n = store.take_pending("s", toks[:20] + [101] * 12)
    assert n == 20
    # a zero-length match (the sid reused by another conversation): lost
    assert store.adopt("s", _host(32, toks))
    assert store.take_pending("s", [101, 102, 103]) is None
    assert store.pulls["lost"] == 2
    assert store.pulls["claimed"] == 3


# --- the engine, in lockstep with JAX ---------------------------------------------


def test_session_turns_pin_and_warm_hit(fixture_models, jax_ref):
    """Both turns give the JAX session engine's tokens (and a cold JAX
    engine's); the pins, the history and the counters are JAX's."""
    store = SessionStore()
    eng = _port(fixture_models, session_store=store)
    jstore = jsessions.SessionStore()
    jeng = _jax(fixture_models, session_store=jstore)
    try:
        outs1 = _run(eng, P1, "conv")
        assert outs1 == _run(jeng, P1, "conv", JSP)
        sess, jsess = store.lookup("conv"), jstore.lookup("conv")
        hist = len(P1) + len(outs1) - 1          # the last token's KV is unwritten
        assert len(sess.pages) == len(jsess.pages) == hist // P
        assert sess.token_ids == jsess.token_ids == (P1 + outs1)[:hist]
        p2 = P1 + outs1 + EXTRA
        want = jax_ref.generate(p2, JSP)
        assert _run(eng, p2, "conv") == _run(jeng, p2, "conv", JSP) == want
        c = store.counters()
        assert c == jstore.counters()
        assert c["turns"]["cold"] == 1
        assert c["turns"]["hit"] + c["turns"]["partial"] == 1
        assert store.lookup("conv").turns == 2
        dbg = eng.debug_sessions()
        assert dbg["enabled"] and dbg["active"] == 1
        assert dbg["sessions"][0]["turns"] == 2
        assert (set(dbg) == set(jeng.debug_sessions())
                and set(dbg["sessions"][0])
                == set(jeng.debug_sessions()["sessions"][0]))
    finally:
        eng.stop()                               # close() drops every pin
        jeng.stop()
    assert store.active == 0
    eng.paged.pool.check_leaks(len(eng.prefix_cache._entries))


def test_session_migration_via_pool_is_golden(fixture_models, jax_ref):
    """Replica A serves turn 1 and publishes; B claims the entry,
    validates its tokens and serves turn 2 with a cold JAX engine's
    tokens, admitted warm."""
    hand = LocalHandoff()
    store_a = SessionStore()
    eng_a = _port(fixture_models, handoff=hand, session_store=store_a)
    outs1 = _run(eng_a, P1, "mig")
    assert store_a.flush(), "publisher did not drain"
    assert store_a.counters()["pulls"]["published"] == 1
    host = hand.claim(session_hid("mig"))        # what B's API layer does
    nfull = (len(P1) + len(outs1) - 1) // P * P
    assert host.length == nfull and host.last_logits is None
    assert list(host.token_ids) == (P1 + outs1)[:nfull]
    eng_a.stop()

    store_b = SessionStore()
    eng_b = _port(fixture_models, session_store=store_b)
    assert store_b.adopt("mig", host)
    p2 = P1 + outs1 + EXTRA
    got = _run(eng_b, p2, "mig")
    assert got == jax_ref.generate(p2, JSP)
    cb = store_b.counters()
    assert cb["pulls"]["claimed"] == 1
    assert cb["turns"]["partial"] == 1           # admitted warm, not cold
    # the suffix alone prefilled: no one-shot batch of the whole prompt
    assert eng_b.prefill_batches_run == 0 and eng_b.chunk_slots_run == 1
    assert store_b.lookup("mig").turns == 1 and store_b.pinned_pages > 0
    eng_b.stop()


def test_session_pool_miss_degrades_to_local_prefill(fixture_models,
                                                     jax_ref):
    """An empty pool never fails the request: counted lost, a local
    prefill, the golden tokens."""
    hand = LocalHandoff()
    assert hand.claim(session_hid("ghost")) is None
    store = SessionStore()
    eng = _port(fixture_models, session_store=store)
    store.note_lost()                            # what the API layer counts
    assert _run(eng, P1, "ghost") == jax_ref.generate(P1, JSP)
    c = store.counters()
    assert c["pulls"]["lost"] == 1 and c["turns"]["cold"] == 1
    eng.stop()


def test_mismatched_pull_discarded_never_scattered(fixture_models, jax_ref,
                                                   monkeypatch):
    """A pulled entry whose tokens share NO prefix with the prompt (a
    reused sid) is dropped before any scatter; JAX's store does the
    same."""
    hand = LocalHandoff()
    store_a = SessionStore()
    eng_a = _port(fixture_models, handoff=hand, session_store=store_a)
    _run(eng_a, P1, "reused")
    assert store_a.flush()
    eng_a.stop()
    host = hand.claim(session_hid("reused"))
    store_b = SessionStore()
    eng_b = _port(fixture_models, session_store=store_b)
    assert store_b.adopt("reused", host)
    other = [(i * 13 + 7) % 160 for i in range(24)]
    assert other[0] != P1[0]
    scattered = []
    monkeypatch.setattr(eng_b, "_paged_insert_entry",
                        lambda *a: scattered.append(a))
    assert _run(eng_b, other, "reused") == jax_ref.generate(other, JSP)
    assert scattered == []
    assert store_b.counters()["pulls"]["lost"] == 1
    # JAX's store discards the same entry for the same prompt
    jstore = jsessions.SessionStore()
    assert jstore.adopt("reused", types.SimpleNamespace(
        length=host.length, token_ids=host.token_ids, last_logits=None,
        slot_axis=0))
    assert jstore.take_pending("reused", other) is None
    assert jstore.counters()["pulls"] == store_b.counters()["pulls"]
    eng_b.stop()


def test_contiguous_engine_keeps_turn_bookkeeping(fixture_models, jax_ref):
    """A contiguous engine has no pages to pin: the store records the
    history and the turn outcomes, and the row cache gives the warm
    turn."""
    store = SessionStore()
    eng = _port(fixture_models, kv_layout="contiguous",
                session_store=store)
    outs1 = _run(eng, P1, "c")
    assert outs1 == jax_ref.generate(P1, JSP)
    p2 = P1 + outs1 + EXTRA
    outs2 = _run(eng, p2, "c")
    assert outs2 == jax_ref.generate(p2, JSP)
    sess = store.lookup("c")
    assert sess.pages == [] and sess.turns == 2
    assert sess.token_ids == (p2 + outs2)[:-1]
    assert store.counters()["turns"] == {"hit": 0, "partial": 1, "cold": 1}
    eng.stop()


# --- HTTP -----------------------------------------------------------------------------


class _CharTok:
    """Invertible toy tokenizer (ids = code points mod 160): a decoded
    reply re-encodes to the SAME ids, so a multi-turn ChatML prompt
    token-matches the published session history."""

    def encode(self, text):
        return [ord(c) % 160 for c in text][:60]

    def decode(self, ids):
        return "".join(chr(int(i) % 160) for i in ids)


def _chat(port, messages, sid=None, header=True, **kw):
    body = {"model": "m", "max_tokens": 4, "temperature": 0.0,
            "messages": messages, **kw}
    headers = {"Content-Type": "application/json"}
    if sid is not None and header:
        headers["X-Session-ID"] = sid
    elif sid is not None:
        body["session_id"] = sid
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps(body).encode(), headers=headers)
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_http_session_flow_and_debug_endpoint(fixture_models):
    store = SessionStore()
    eng = _port(fixture_models, session_store=store, max_slots=2)
    srv = OpenAIServer(eng, _CharTok(), model_name="m")
    port = srv.serve(host="127.0.0.1", port=0, background=True)
    try:
        msgs = [{"role": "user", "content": "hi"}]
        reply = _chat(port, msgs, "web-1")["choices"][0]["message"]["content"]
        msgs += [{"role": "assistant", "content": reply},
                 {"role": "user", "content": "again"}]
        # the header wins over a conflicting body field
        _chat(port, msgs, "web-1", session_id="other")
        dbg = json.loads(_get(port, "/debug/sessions")[2])
        assert dbg["enabled"] and dbg["active"] == 1
        assert dbg["sessions"][0]["session_id"] == "web-1"
        assert dbg["sessions"][0]["turns"] == 2
        text = _get(port, "/metrics")[2].decode()
        assert "llm_sessions_active 1" in text
        assert 'llm_session_turns_total{cache="cold"} 1' in text
        assert f"llm_session_pinned_pages {store.pinned_pages}" in text
        # no session id, or a body field alone
        _chat(port, [{"role": "user", "content": "x"}])
        _chat(port, [{"role": "user", "content": "y"}], "body-1",
              header=False)
        assert store.lookup("body-1") is not None
        assert store.active == 2
    finally:
        srv.shutdown()


def test_http_claim_on_miss_pulls_from_shared_pool(fixture_models):
    """Two servers over one handoff store: turn 1 lands on A, turn 2 on
    B, which claims A's published entry at admission and serves the
    session warm."""
    hand = LocalHandoff()
    stores, servers, ports = [], [], []
    try:
        for _ in range(2):
            st = SessionStore()
            e = _port(fixture_models, handoff=hand, session_store=st,
                      max_slots=2)
            srv = OpenAIServer(e, _CharTok(), model_name="m")
            ports.append(srv.serve(host="127.0.0.1", port=0,
                                   background=True))
            stores.append(st)
            servers.append(srv)
        msgs = [{"role": "user", "content": "hello fleet"}]
        got = _chat(ports[0], msgs, "moved-1", header=False)
        reply = got["choices"][0]["message"]["content"]
        assert stores[0].flush(), "A's publish did not drain"
        msgs += [{"role": "assistant", "content": reply},
                 {"role": "user", "content": "follow up"}]
        assert _chat(ports[1], msgs, "moved-1")["choices"][0]["message"]
        cb = stores[1].counters()
        assert cb["pulls"]["claimed"] == 1       # pulled, token-validated
        assert cb["turns"]["partial"] == 1       # and admitted warm
        # a session never published: B answers, counts it lost and
        # prefills locally (the shared ChatML head may still page-hit)
        _chat(ports[1], [{"role": "user", "content": "new"}], "never")
        cb = stores[1].counters()
        assert cb["pulls"]["lost"] == 1 and cb["pulls"]["claimed"] == 1
        assert sum(cb["turns"].values()) == 2
        assert stores[1].lookup("never").turns == 1
    finally:
        for srv in servers:
            srv.shutdown()


def test_chat_page_is_jax_webui_and_served(fixture_models):
    from llm_in_practise_tpu.serve.api import webui_html as jax_webui

    for name in ("m", "qwen3 <8B> & \"friends\""):
        assert webui_html(name) == jax_webui(name)
    eng = _port(fixture_models, max_slots=2)
    srv = OpenAIServer(eng, _CharTok(), model_name="page-model")
    port = srv.serve(host="127.0.0.1", port=0, background=True)
    try:
        for path in ("/", "/chat"):
            status, ctype, body = _get(port, path)
            assert status == 200 and ctype.startswith("text/html")
            assert body.decode() == webui_html("page-model")
        # the JSON the page's script posts streams SSE deltas
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/chat/completions",
            data=json.dumps({"model": "page-model", "stream": True,
                             "max_tokens": 4, "messages": [
                                 {"role": "user", "content": "hi"}]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.headers.get("Content-Type") == "text/event-stream"
            lines = [ln for ln in r.read().decode().split("\n")
                     if ln.startswith("data: ")]
        assert lines[-1] == "data: [DONE]"
        assert all("choices" in json.loads(ln[6:]) for ln in lines[:-1])
    finally:
        srv.shutdown()


# --- pins under pressure (the port's admission finds a pin the index dropped) ---


def _fillers(n, length, seed):
    return [[(seed + 17 * i + 5 * j) % 157 + 1 for j in range(length)]
            for i in range(n)]


def test_pins_survive_unrelated_traffic_past_the_pool(fixture_models,
                                                      jax_ref):
    """Between two turns, unrelated requests need more tokens than the
    pool holds: the index evicts the conversation's entries, the pin keeps
    its pages, and the follow-up turn admits from them (a page hit of the
    whole pinned history) with the golden tokens. Without a store the same
    schedule comes back cold."""
    fill = _fillers(6, 30, 3)                    # 6 x 38 rows > 160 tokens
    out = {}
    for with_store in (True, False):
        store = SessionStore() if with_store else None
        eng = _port(fixture_models, kv_pool_tokens=160, session_store=store,
                    max_slots=2)
        outs1 = _run(eng, P1, "p")
        for f in fill:
            _run(eng, f, None)
        p2 = P1 + outs1 + EXTRA
        # the unrelated traffic evicted the conversation from the index
        idx = eng.prefix_cache.lookup(p2)
        eng.paged.pool.release(idx)
        assert idx == []
        saved = eng.prefix_cache.tokens_saved
        h = eng.submit(p2, SP, session_id="p")
        while eng.step():
            pass
        got = h.result()
        assert got == jax_ref.generate(p2, JSP)
        out[with_store] = (h.cache_outcome, eng.prefix_cache.tokens_saved
                           - saved, eng.chunk_slots_run)
        if with_store:
            assert h.cache_outcome == "partial"
            # the whole pinned history: its full pages
            pinned = (len(P1) + len(outs1) - 1) // P
            assert store.counters()["evictions"]["pressure"] == 0
            assert eng.paged.pool.snapshot()["alloc_failures"] == 0
            assert store.lookup("p").turns == 2
            assert len(store.lookup("p").pages) >= pinned
        eng.stop()
    assert out[False][0] == "cold"


def test_pins_yield_to_active_slots(fixture_models, jax_ref):
    """A pool too small for every pin plus the active slots: pins yield
    newest pages first (each survivor a prefix of its chain), admission
    never fails while a pin remains, every stream is golden, and a short
    TTL returns the pin account to its baseline."""
    led = get_ledger()
    base = led.account_bytes("session_pins")
    store = SessionStore(ttl_s=30.0)
    eng = _port(fixture_models, kv_pool_tokens=96, session_store=store,
                max_slots=2)
    pool = eng.paged.pool
    pinned_at, failures = {}, []
    real_finish, real_alloc = store.note_finish, pool.try_alloc

    def note_finish(sid, token_ids, pages, **kw):
        pinned_at[sid] = list(pages)
        return real_finish(sid, token_ids, pages, **kw)

    def try_alloc(n):
        got = real_alloc(n)
        if got is None:
            failures.append(store.pinned_pages)
        return got

    store.note_finish, pool.try_alloc = note_finish, try_alloc
    prompts = _fillers(5, 22, 11)
    for i, p in enumerate(prompts):
        assert _run(eng, p, f"s{i}") == jax_ref.generate(p, JSP)
    assert store.counters()["evictions"]["pressure"] > 0
    assert all(f == 0 for f in failures), failures
    for sid, sess in list(store._sessions.items()):
        assert sess.pages == pinned_at[sid][:len(sess.pages)]
    assert (led.account_bytes("session_pins") - base
            == store.pinned_pages * eng.paged.page_bytes)
    store.ttl_s = 1e-3
    time.sleep(0.01)
    store.sweep()
    assert store.pinned_pages == 0
    assert led.account_bytes("session_pins") == base
    eng.prefix_cache.clear()
    pool.check_leaks(0)
    eng.stop()
