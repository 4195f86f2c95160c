"""PyTorch port: the HBM ledger and the card's memory telemetry
(``obs/hbm.py``, ``obs/cost.py``) and their call sites, against the JAX
package.

- The ledger's unit contracts (JAX ``test_hbm_ledger.py``'s): signed
  booking with double frees left visible, pulses that move the peak and
  not the balance, one-lock transfers, view and host accounts left out of
  the device sum, the fail-open residual, reclaim counts, baselines,
  the ownership tree; each held on the port's ledger and on JAX's.
- ``host_entry_bytes`` and ``tree_bytes`` over tensors, arrays, modules
  and quantized leaves; ``device_memory_stats`` fails open on the CPU
  and reads the allocator on a CUDA device.
- The ``/metrics`` families render through the strict parser.
- Churn to zero: an engine books its weights and KV at build and returns
  them at ``stop()`` (paged, contiguous, with a draft); adapters book
  and evict (the same bytes as JAX's registry books); session pins walk
  back to the baseline; a handoff's staging is freed after the publish;
  preemption and prefix eviction count reclaims.
- HTTP: ``/debug/kv``, ``/debug/hbm`` and ``/metrics`` tell the same
  byte story.
"""

import http.client
import json
import time

import jax
import numpy as np
import pytest
import torch

from promparse import parse_exposition
from torch_port_util import load_fixture_both

from llm_in_practise_tpu.obs import hbm as jhbm
from llm_in_practise_tpu.peft.lora import LoRAConfig as JaxLoRAConfig
from llm_in_practise_tpu.peft.lora import init_lora as jax_init_lora
from llm_in_practise_tpu.serve.multi_lora import (
    AdapterRegistry as JaxRegistry,
)
from llm_in_practise_tpu_torch.models.convert import lora_from_jax
from llm_in_practise_tpu_torch.obs import cost
from llm_in_practise_tpu_torch.obs import hbm as phbm
from llm_in_practise_tpu_torch.obs.hbm import (
    HOST_ACCOUNTS,
    VIEW_ACCOUNTS,
    get_ledger,
    host_entry_bytes,
    register_hbm_ledger,
)
from llm_in_practise_tpu_torch.obs.registry import Registry
from llm_in_practise_tpu_torch.peft.lora import LoRAConfig
from llm_in_practise_tpu_torch.serve.api import OpenAIServer
from llm_in_practise_tpu_torch.serve.disagg import LocalHandoff
from llm_in_practise_tpu_torch.serve.engine import (
    InferenceEngine,
    SamplingParams,
)
from llm_in_practise_tpu_torch.serve.multi_lora import AdapterRegistry
from llm_in_practise_tpu_torch.serve.sessions import SessionStore

torch.set_num_threads(1)

SP = SamplingParams(greedy=True, max_tokens=6)
LEDGERS = {"port": phbm.HbmLedger, "jax": jhbm.HbmLedger}


@pytest.fixture(scope="module")
def fixture_models():
    return load_fixture_both()


def _engine(fixture_models, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("cache_len", 64)
    kw.setdefault("kv_page_size", 8)
    kw.setdefault("cache_dtype", torch.float32)
    return InferenceEngine(fixture_models[2], **kw)


# --- the ledger's unit contracts, on both packages -------------------------------


@pytest.fixture(params=sorted(LEDGERS))
def ledger_cls(request):
    return LEDGERS[request.param]


def test_book_moves_balance_and_peak(ledger_cls):
    led = ledger_cls(device_stats=lambda: {})
    led.book("weights/model", 100)
    led.book("weights/model", 50)
    led.book("weights/model", -30)
    snap = led.snapshot()["accounts"]["weights/model"]
    assert snap["bytes"] == 120 and snap["peak_bytes"] == 150
    assert snap["allocs"] == 2 and snap["frees"] == 1


def test_double_free_stays_visible_as_negative_balance(ledger_cls):
    led = ledger_cls(device_stats=lambda: {})
    led.book("kv_pool.pages", 10)
    led.book("kv_pool.pages", -20)
    assert led.account_bytes("kv_pool.pages") == -10   # not clamped


def test_pulse_raises_peak_without_moving_bytes(ledger_cls):
    led = ledger_cls(device_stats=lambda: {})
    led.book("kv_pool.pages", 100)
    led.pulse("transient_view", 40)
    led.pulse("transient_view", 25)
    tv = led.snapshot()["accounts"]["transient_view"]
    assert tv["bytes"] == 0 and tv["peak_bytes"] == 40
    assert tv["pulses"] == 2 and tv["last_pulse_bytes"] == 25
    # a pulse on an account WITH a balance peaks at balance + pulse
    led.book("transient_view", 10)
    led.pulse("transient_view", 40)
    assert led.snapshot()["accounts"]["transient_view"]["peak_bytes"] == 50


def test_transfer_conserves_the_device_total(ledger_cls):
    led = ledger_cls(device_stats=lambda: {})
    led.book("weights/model", 100)
    led.transfer("weights/model", "weights/draft_model", 40)
    assert led.account_bytes("weights/model") == 60
    assert led.account_bytes("weights/draft_model") == 40
    assert led.device_bytes() == 100


def test_view_and_host_planes_excluded_from_device_sum(ledger_cls):
    led = ledger_cls(device_stats=lambda: {})
    led.book("kv_pool.pages", 100)
    led.book("session_pins", 80)            # a view into kv_pool.pages
    led.book("handoff_staging", 30)         # process RAM, not device
    assert VIEW_ACCOUNTS == jhbm.VIEW_ACCOUNTS == {"session_pins"}
    assert HOST_ACCOUNTS == jhbm.HOST_ACCOUNTS == {"handoff_staging"}
    assert led.device_bytes() == 100


def test_reconciliation_residual_and_fail_open(ledger_cls):
    led = ledger_cls(device_stats=lambda: {"bytes_in_use": 150})
    led.book("weights/model", 100)
    led.book("session_pins", 999)           # views never skew the residual
    assert led.unattributed_bytes() == 50
    tree = led.debug_tree()
    assert tree["reconciliation"]["unattributed_bytes"] == 50
    assert tree["reconciliation"]["fail_open"] is False
    open_led = ledger_cls(device_stats=lambda: {})
    open_led.book("weights/model", 100)
    assert open_led.unattributed_bytes() == 0
    assert open_led.debug_tree()["reconciliation"]["fail_open"] is True


def test_note_reclaim_accumulates_by_owner_and_reason(ledger_cls):
    led = ledger_cls(device_stats=lambda: {})
    led.note_reclaim("kv_pool.pages", "preempt")
    led.note_reclaim("kv_pool.pages", "preempt", 2)
    led.note_reclaim("session_pins", "ttl")
    rows = {(r["owner"], r["reason"]): r["events"]
            for r in led.snapshot()["reclaims"]}
    assert rows == {("kv_pool.pages", "preempt"): 3,
                    ("session_pins", "ttl"): 1}


def test_leaked_since_diffs_against_a_baseline(ledger_cls):
    led = ledger_cls(device_stats=lambda: {})
    led.book("weights/model", 100)
    base = led.baseline()
    led.book("kv_pool.pages", 64)
    assert led.leaked_since(base) == {"kv_pool.pages": 64}
    led.book("kv_pool.pages", -64)
    assert led.leaked_since(base) == {}


def test_debug_tree_groups_accounts_by_component(ledger_cls):
    led = ledger_cls(device_stats=lambda: {})
    led.book("weights/model", 100)
    led.book("weights/draft_model", 40)
    led.book("session_pins", 16)
    tree = led.debug_tree()["tree"]
    assert tree["weights"]["bytes"] == 140
    assert set(tree["weights"]["accounts"]) == {"weights/model",
                                                "weights/draft_model"}
    assert tree["session_pins"]["accounts"]["session_pins"]["plane"] == "view"
    assert tree["weights"]["accounts"]["weights/model"]["plane"] == "device"


def test_same_operations_same_snapshot_in_both_packages():
    ops = [("book", "weights/model", 100), ("pulse", "transient_view", 64),
           ("book", "kv_pool.pages", 512), ("transfer", "kv_pool.pages",
                                            "session_pins", 32),
           ("note_reclaim", "kv_pool.pages", "preempt"),
           ("book", "handoff_staging", 7), ("book", "handoff_staging", -7)]
    snaps = []
    for cls in (phbm.HbmLedger, jhbm.HbmLedger):
        led = cls(device_stats=lambda: {"bytes_in_use": 1000})
        for op, *args in ops:
            getattr(led, op)(*args)
        snaps.append((led.snapshot(), led.debug_tree(),
                      led.unattributed_bytes()))
    assert snaps[0] == snaps[1]


# --- byte counting and the card's stats ----------------------------------------------


def test_host_entry_bytes_sums_rows_and_logits():
    class Host:
        rows = [{"k": torch.zeros((4, 8)), "v": np.zeros((4, 8), np.float32)}]
        last_logits = torch.zeros(64, dtype=torch.bfloat16)

    assert host_entry_bytes(Host()) == 2 * 4 * 8 * 4 + 64 * 2
    assert host_entry_bytes(object()) == 0


def test_tree_bytes_counts_modules_leaves_and_nests(fixture_models):
    from llm_in_practise_tpu_torch.quant import nf4
    from llm_in_practise_tpu_torch.serve.quantized import QuantizedLinear

    model = fixture_models[2]
    want = sum(p.numel() * p.element_size() for p in model.parameters())
    assert cost.tree_bytes(model) == want
    nested = {"a": [torch.zeros(3), (torch.zeros(2, dtype=torch.int8),)],
              "b": None}
    assert cost.tree_bytes(nested) == 3 * 4 + 2
    leaf = nf4.quantize(torch.randn(64, 128))
    mod = torch.nn.ModuleList([QuantizedLinear(leaf, torch.float32),
                               torch.nn.Linear(2, 2)])
    assert cost.tree_bytes(mod) == leaf.nbytes + 6 * 4
    tied = torch.nn.Linear(4, 4, bias=False)
    pair = torch.nn.ModuleList([tied, torch.nn.Linear(4, 4, bias=False)])
    pair[1].weight = tied.weight            # a tied weight counts once
    assert cost.tree_bytes(pair) == 16 * 4


def test_device_memory_stats_fail_open_and_allocator(monkeypatch):
    assert cost.device_memory_stats("cpu") == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cost.device_memory_stats() == {} and cost.hbm_stats() == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 3 << 30)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: 5 << 30)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (70 << 30, 80 << 30))
    assert cost.device_memory_stats() == {
        "bytes_in_use": 3 << 30, "peak_bytes_in_use": 5 << 30,
        "bytes_limit": 80 << 30}
    assert cost.hbm_stats() == {"hbm_bytes_in_use": 3 << 30,
                                "hbm_bytes_limit": 80 << 30,
                                "hbm_headroom_gib": 77.0}

    def boom(d):
        raise RuntimeError("no context")

    monkeypatch.setattr(torch.cuda, "memory_allocated", boom)
    assert cost.device_memory_stats("cuda:0") == {}


def test_register_hbm_ledger_renders_strict():
    led = phbm.HbmLedger(device_stats=lambda: {"bytes_in_use": 200})
    led.book("weights/model", 150)
    led.pulse("transient_view", 70)
    led.note_reclaim("kv_pool.pages", "preempt", 3)
    reg = Registry()
    register_hbm_ledger(reg, led)
    fams = parse_exposition(reg.render())
    assert fams["llm_hbm_ledger_bytes"].samples[
        ("llm_hbm_ledger_bytes", frozenset({("owner", "weights/model")}))
    ] == 150
    assert fams["llm_hbm_ledger_peak_bytes"].samples[
        ("llm_hbm_ledger_peak_bytes",
         frozenset({("owner", "transient_view")}))] == 70
    assert fams["llm_hbm_reclaims_total"].samples[
        ("llm_hbm_reclaims_total", frozenset({("owner", "kv_pool.pages"),
                                              ("reason", "preempt")}))] == 3
    assert fams["llm_hbm_unattributed_bytes"].samples[
        ("llm_hbm_unattributed_bytes", frozenset())] == 50
    # the same ledger through JAX's registration renders the same text
    from llm_in_practise_tpu.obs.registry import Registry as JaxRegistryR

    jreg = JaxRegistryR()
    jhbm.register_hbm_ledger(jreg, led)
    assert jreg.render() == reg.render()


# --- churn to zero ---------------------------------------------------------------------


def test_engine_books_on_build_and_restores_baseline_on_stop(fixture_models):
    led = get_ledger()
    base = led.baseline()
    pulses = led.snapshot()["accounts"].get("transient_view",
                                           {}).get("pulses", 0)
    eng = _engine(fixture_models, kv_layout="paged", prefix_cache=True)
    grown = led.leaked_since(base)
    assert grown["weights/model"] == cost.tree_bytes(fixture_models[2])
    assert grown["kv_pool.pages"] == eng.paged.pool_bytes
    assert eng.paged.pool_bytes == ((eng.paged.pool.capacity + 1)
                                    * eng.paged.page_bytes)
    out = eng.generate([1, 5, 9, 13] * 3, SP)
    assert len(out) == 6
    tv = led.snapshot()["accounts"]["transient_view"]
    assert tv["pulses"] > pulses and tv["last_pulse_bytes"] > 0
    eng.prefix_cache.clear()
    eng.stop()
    assert led.leaked_since(base) == {}
    eng.stop()                                   # idempotent
    assert led.leaked_since(base) == {}


def test_contiguous_engine_books_kv_contiguous(fixture_models):
    led = get_ledger()
    base = led.baseline()
    eng = _engine(fixture_models)
    grown = led.leaked_since(base)
    snap = eng.debug_kv()
    assert snap["ledger_account"] == "kv.contiguous"
    assert grown["kv.contiguous"] == snap["kv_bytes"] > 0
    eng.stop()
    assert led.leaked_since(base) == {}


def test_draft_cache_is_a_first_class_account(fixture_models):
    from torch_port_util import tiny_port_model

    led = get_ledger()
    base = led.baseline()
    draft = tiny_port_model(160, seed=3, n_layer=1, hidden_size=32,
                            intermediate_size=64, head_dim=16)
    eng = _engine(fixture_models, kv_layout="paged", kv_pool_tokens=256,
                  speculative_k=3, decode_steps=4, draft_model=draft)
    grown = led.leaked_since(base)
    assert grown["kv.draft"] == eng.draft_kv_bytes() > 0
    assert grown["weights/draft_model"] == cost.tree_bytes(draft)
    assert eng.debug_kv()["draft_kv_account_bytes"] == grown["kv.draft"]
    eng.stop()
    assert led.leaked_since(base) == {}
    # a target drafting for itself owns its weights once
    eng = _engine(fixture_models, kv_layout="paged", speculative_k=3,
                  draft_model=fixture_models[2])
    grown = led.leaked_since(base)
    assert "weights/draft_model" not in grown and grown["kv.draft"] > 0
    eng.stop()
    assert led.leaked_since(base) == {}


def test_adapter_registry_churn_to_zero(fixture_models):
    jmodel, jparams, pmodel = fixture_models
    c = dict(r=2, alpha=4.0, target_patterns=("attn/q_proj",))
    trees = [jax.tree.map(np.asarray, jax_init_lora(
        jparams, JaxLoRAConfig(**c), jax.random.PRNGKey(i)))
        for i in range(5)]
    led, jled = get_ledger(), jhbm.get_ledger()
    base, jbase = led.baseline(), jled.baseline()
    reg = AdapterRegistry(pmodel)
    reg.register_tree("t0", lora_from_jax(trees[0], pmodel.config),
                      LoRAConfig(**c))
    jreg = JaxRegistry(jparams)
    jreg.register_tree("t0", trees[0], JaxLoRAConfig(**c))
    per = reg.bytes_loaded
    # the same account and bytes as JAX's registry books
    assert led.leaked_since(base) == {"adapters/r2": per}
    assert jled.leaked_since(jbase) == {"adapters/r2": per}
    budget = AdapterRegistry(pmodel, max_bytes=int(per * 2.5))
    for i in range(5):
        budget.register_tree(f"t{i}",
                             lora_from_jax(trees[i], pmodel.config),
                             LoRAConfig(**c))
    assert budget.evictions_total == 3
    reclaims = {(r["owner"], r["reason"]): r["events"]
                for r in led.snapshot()["reclaims"]}
    assert reclaims[("adapters/r2", "budget")] >= 3
    for name in budget.names():
        budget.evict(name)
    reg.evict("t0")
    jreg.evict("t0")
    assert led.leaked_since(base) == {}
    assert jled.leaked_since(jbase) == {}


def test_session_pins_expire_to_baseline(fixture_models):
    """Pins attribute pool pages to conversations; capacity, pressure and
    TTL each release them with their own reclaim reason, and the view
    account walks back to the baseline."""
    led = get_ledger()
    base = led.baseline()
    store = SessionStore(ttl_s=0.2, max_sessions=2)
    eng = _engine(fixture_models, kv_layout="paged", prefix_cache=True,
                  session_store=store)
    for k in range(3):                     # the 3rd arrival: capacity
        h = eng.submit([k + 1, k + 2, k + 3, k + 4] * 5, SP,
                       session_id=f"s{k}")
        while eng.step():
            pass
        h.result()
    pinned = led.account_bytes("session_pins") - base.get("session_pins", 0)
    assert pinned > 0
    assert pinned == store.pinned_pages * eng.paged.page_bytes
    store.reclaim_pages(1)                 # pressure
    time.sleep(0.25)
    store.sweep()                          # ttl
    assert led.account_bytes("session_pins") == base.get("session_pins", 0)
    reclaims = {(r["owner"], r["reason"]): r["events"]
                for r in led.snapshot()["reclaims"]}
    for reason in ("capacity", "pressure", "ttl"):
        assert reclaims.get(("session_pins", reason), 0) >= 1, reason
    eng.prefix_cache.clear()
    eng.stop()
    assert led.leaked_since(base) == {}


def test_preempt_and_prefix_evict_count_reclaims_and_staging_frees(
        fixture_models):
    from llm_in_practise_tpu_torch.serve.disagg import new_handoff_id

    led = get_ledger()

    def events(owner, reason):
        return sum(r["events"] for r in led.snapshot()["reclaims"]
                   if (r["owner"], r["reason"]) == (owner, reason))

    pre, ev = events("kv_pool.pages", "preempt"), events("kv_pool.pages",
                                                         "prefix_evict")
    base = led.baseline()
    # a 48-token pool under 4 requests that each grow to 31 tokens
    eng = _engine(fixture_models, kv_layout="paged", kv_pool_tokens=48,
                  prefix_cache=True)
    reqs = [eng.submit([(7 * i + j) % 160 for j in range(9 + i)],
                       SamplingParams(greedy=True, max_tokens=20))
            for i in range(4)]
    while eng.step():
        pass
    assert all(r.result() for r in reqs)
    assert eng.preemptions > 0
    assert events("kv_pool.pages", "preempt") - pre == eng.preemptions
    assert events("kv_pool.pages", "prefix_evict") > ev
    eng.prefix_cache.clear()
    eng.stop()
    # a prefill replica's publish stages the entry on the host, then
    # frees it
    store = LocalHandoff()
    pre_eng = _engine(fixture_models, kv_layout="paged", role="prefill",
                      handoff=store)
    h = pre_eng.submit(list(range(1, 20)), SP, handoff_id=new_handoff_id())
    while pre_eng.step():
        pass
    assert h.result() == [] and h.finish_reason == "handoff"
    staging = led.snapshot()["accounts"]["handoff_staging"]
    assert staging["bytes"] == base.get("handoff_staging", 0)
    assert staging["peak_bytes"] > 0
    pre_eng.stop()
    assert led.leaked_since(base) == {}


# --- the HTTP planes ---------------------------------------------------------------------


class _Tok:
    def encode(self, text):
        return [ord(c) % 160 for c in text][:32]

    def decode(self, ids):
        return "".join(chr(int(i) % 160) for i in ids)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, body


def test_debug_hbm_and_debug_kv_agree_over_http(fixture_models):
    """One server, three windows (/debug/kv, /debug/hbm, /metrics) tell
    the same byte story."""
    eng = _engine(fixture_models, kv_layout="paged", kv_pool_tokens=256,
                  prefix_cache=True)
    srv = OpenAIServer(eng, _Tok(), model_name="hbm-test")
    port = srv.serve(host="127.0.0.1", port=0, background=True)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/chat/completions", json.dumps({
            "model": "hbm-test",
            "messages": [{"role": "user", "content": "hello"}],
            "max_tokens": 4, "temperature": 0.0,
        }), {"Content-Type": "application/json"})
        assert conn.getresponse().status == 200
        conn.close()
        status, raw = _get(port, "/debug/kv")
        kv = json.loads(raw)
        status, raw = _get(port, "/debug/hbm")
        assert status == 200
        hbm = json.loads(raw)
        assert kv["ledger_account"] == "kv_pool.pages"
        pool_acct = hbm["tree"]["kv_pool.pages"]["accounts"]["kv_pool.pages"]
        # the process-wide account holds this pool's bytes (and any other
        # live pool's)
        assert pool_acct["bytes"] >= kv["pool_bytes"]
        # pages_total is usable capacity; the buffer also holds the trash
        # page 0
        assert kv["pool_bytes"] == (kv["pages_total"] + 1) * kv["page_bytes"]
        assert kv["slot_mapped_bytes"] <= kv["pool_bytes"]
        assert hbm["reconciliation"]["fail_open"] is True   # the CPU
        tv = hbm["tree"]["transient_view"]["accounts"]["transient_view"]
        assert tv["pulses"] > 0 and tv["peak_bytes"] > 0
        status, raw = _get(port, "/metrics")
        fams = parse_exposition(raw.decode())       # strict parse
        sample = fams["llm_hbm_ledger_bytes"].samples[
            ("llm_hbm_ledger_bytes",
             frozenset({("owner", "kv_pool.pages")}))]
        assert sample == pool_acct["bytes"]
        assert fams["llm_hbm_unattributed_bytes"].samples[
            ("llm_hbm_unattributed_bytes", frozenset())] == 0
        assert not fams["llm_device_hbm_bytes"].samples   # the CPU: none
        assert fams["llm_kv_page_size"].samples[
            ("llm_kv_page_size", frozenset())] == kv["page_size"]
    finally:
        srv.shutdown()


def test_unstopped_engine_frees_its_books_when_collected(fixture_models):
    """An engine (and its page pool) dropped without ``stop()`` returns
    its bytes when collected: the ledger tracks live owners."""
    import gc

    led = get_ledger()
    base = led.baseline()
    eng = _engine(fixture_models, kv_layout="paged")
    assert led.leaked_since(base)["kv_pool.pages"] == eng.paged.pool_bytes
    del eng
    gc.collect()
    assert led.leaked_since(base) == {}


def test_ledger_books_from_many_threads_lose_no_update():
    """The engine, handler and publisher threads book into one ledger:
    16 threads of paired books and pulses under a short switch interval
    leave every balance at zero and every count whole."""
    import sys
    import threading

    led = phbm.HbmLedger(device_stats=lambda: {})
    n_threads, n_ops = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            owner = f"adapters/r{i % 4}"
            for _ in range(n_ops):
                led.book(owner, 3)
                led.pulse("transient_view", 5)
                led.book(owner, -3)
                led.note_reclaim("kv_pool.pages", "preempt")

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = led.snapshot()
    assert all(a["bytes"] == 0 for a in snap["accounts"].values())
    assert sum(a["allocs"] for name, a in snap["accounts"].items()
               if name.startswith("adapters/")) == n_threads * n_ops
    assert snap["accounts"]["transient_view"]["pulses"] == n_threads * n_ops
    assert snap["reclaims"] == [{"owner": "kv_pool.pages",
                                 "reason": "preempt",
                                 "events": n_threads * n_ops}]
