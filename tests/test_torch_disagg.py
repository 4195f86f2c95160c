"""PyTorch port: disaggregated prefill/decode serving (``serve/disagg.py``
and the role split across the engine, the API and the CLI) against the
JAX package, on the committed HF fixture in f32.

- Golden tokens: a prompt prefilled on a ``role="prefill"`` engine, its
  KV published, claimed and admitted by a ``role="decode"`` engine gives
  the JAX ``role="both"`` engine's greedy tokens, in both KV layouts and
  across them, over ``LocalHandoff`` and over the port's pool server (and
  from a JAX prefill replica through the port's pool server).
- Degradation: a lost entry, a mismatched entry (``kv_rejected``) and the
  pool going down mid-claim each re-prefill locally and complete,
  counted as the JAX decode engine counts them.
- A decode replica under concurrent load runs no mixed block; with
  ``decode_steps`` > 1 it composes speculation with a local prefill where
  a ``both`` engine suspends it: the port's counters equal JAX's, step by
  step.
- HTTP: ``POST /internal/handoff/prefill`` answers 200 with the handoff id
  and prompt tokens (501 on a decode server), a chat carrying
  ``kv_transfer_params`` streams the golden tokens, a 429 re-pins the
  claimed entry; the CLI's ``--role`` / ``--kv-remote`` checks.
- The divergence ROADMAP.md §C records: an entry whose pow2-padded width
  exceeds ``cache_len`` is rejected by JAX and admitted by the port.

Every socket carries a timeout and every server stops in a finalizer.
"""

import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import load_fixture_both

from llm_in_practise_tpu.serve import disagg as jdisagg
from llm_in_practise_tpu.serve import kv_pool as jkv
from llm_in_practise_tpu.serve.engine import InferenceEngine as JaxEngine
from llm_in_practise_tpu.serve.engine import SamplingParams as JaxParams
from llm_in_practise_tpu_torch.models.layers import to_kv_dtype
from llm_in_practise_tpu_torch.serve.api import OpenAIServer, build_prompt
from llm_in_practise_tpu_torch.serve.disagg import (
    LocalHandoff,
    RemoteHandoff,
    new_handoff_id,
)
from llm_in_practise_tpu_torch.serve.engine import (
    InferenceEngine,
    SamplingParams,
)
from llm_in_practise_tpu_torch.serve.kv_pool import HostEntry, KVPoolServer

torch.set_num_threads(1)

PROMPTS = [[(i * 7 + j * 3 + 5) % 160 for i in range(20 + 4 * j)]
           for j in range(4)]
NEW = 12
SP = SamplingParams(greedy=True, max_tokens=NEW)
LAYOUTS = ("contiguous", "paged")


@pytest.fixture(scope="module")
def fixture_models():
    return load_fixture_both()


def _port(fixture_models, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("cache_len", 64)
    kw.setdefault("kv_page_size", 8)
    kw.setdefault("cache_dtype", torch.float32)
    return InferenceEngine(fixture_models[2], **kw)


def _jax(fixture_models, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("cache_len", 64)
    kw.setdefault("kv_page_size", 8)
    kw.setdefault("cache_dtype", jnp.float32)
    kw.setdefault("kv_layout", "contiguous")
    return JaxEngine(fixture_models[0], fixture_models[1], **kw)


@pytest.fixture(scope="module")
def golden(fixture_models):
    """The JAX ``role="both"`` engine's greedy tokens, one prompt at a
    time."""
    eng = _jax(fixture_models)
    out = [eng.generate(p, JaxParams(greedy=True, max_tokens=NEW))
           for p in PROMPTS]
    eng.stop()
    return out


def _prefill_to(pre, prompt, sp=SP):
    hid = new_handoff_id()
    h = pre.submit(prompt, sp, handoff_id=hid)
    while pre.step():
        pass
    assert h.result() == []            # a prefill replica emits no token
    assert h.finish_reason == "handoff", h.finish_reason
    return hid


def _decode(dec, prompt, host):
    h = dec.submit(prompt, SP, kv_entry=host)
    while dec.step():
        pass
    return h.result()


# --- golden tokens --------------------------------------------------------------


@pytest.mark.parametrize("src", LAYOUTS)
@pytest.mark.parametrize("dst", LAYOUTS)
def test_handoff_golden_tokens_local_store(fixture_models, golden, src, dst):
    store = LocalHandoff()
    pre = _port(fixture_models, kv_layout=src, role="prefill", handoff=store,
                chunked_prefill=8)
    dec = _port(fixture_models, kv_layout=dst, role="decode")
    for prompt, want in zip(PROMPTS, golden):
        hid = _prefill_to(pre, prompt)
        host = store.claim(hid)
        assert host is not None and host.length == len(prompt)
        # a paged producer ships its live pages; a contiguous one the
        # prompt's rows
        assert host.bucket == (-(-len(prompt) // 8) * 8 if src == "paged"
                               else len(prompt))
        assert _decode(dec, prompt, host) == want
    assert pre.handoff_published == len(PROMPTS)
    assert pre.slot_req == [None] * 4
    assert dec.kv_admitted == len(PROMPTS)
    assert dec.local_prefills == 0 and dec.kv_rejected == 0
    assert dec.prefill_batches_run == dec.chunk_slots_run == 0
    if src == "paged":
        pre.paged.pool.check_leaks(0)
    pre.stop()
    dec.stop()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_handoff_golden_tokens_over_pool_server(fixture_models, golden,
                                                layout):
    server = KVPoolServer(min_prefix=4).start()
    try:
        store = RemoteHandoff(server.address, namespace="m")
        pre = _port(fixture_models, kv_layout=layout, role="prefill",
                    handoff=store)
        dec = _port(fixture_models, kv_layout=layout, role="decode")
        for prompt, want in zip(PROMPTS[:2], golden):
            hid = _prefill_to(pre, prompt)
            host = store.claim(hid)
            assert host is not None
            assert _decode(dec, prompt, host) == want
        assert server.handoff_puts == 2 and server.handoff_claims == 2
        assert server.stats()["handoff_pending"] == 0
        assert store.claim(hid) is None         # claimed once
        pre.stop()
        dec.stop()
    finally:
        server.stop()


def test_jax_prefill_replica_hands_off_to_the_port(fixture_models, golden):
    """A JAX prefill replica publishes through the port's pool server; a
    port decode replica claims the entry and decodes JAX's tokens."""
    server = KVPoolServer(min_prefix=4).start()
    try:
        jstore = jdisagg.RemoteHandoff(server.address, namespace="m")
        pre = _jax(fixture_models, role="prefill", handoff=jstore)
        dec = _port(fixture_models, kv_layout="paged", role="decode")
        store = RemoteHandoff(server.address, namespace="m")
        for prompt, want in zip(PROMPTS[2:], golden[2:]):
            hid = jdisagg.new_handoff_id()
            h = pre.submit(prompt, JaxParams(greedy=True, max_tokens=NEW),
                           handoff_id=hid)
            while pre.step():
                pass
            assert h.result() == [] and h.finish_reason == "handoff"
            host = store.claim(hid)
            # JAX ships a pow2 bucket; the port copies the prompt's rows
            assert host.bucket >= len(prompt)
            assert _decode(dec, prompt, host) == want
        assert dec.kv_admitted == 2 and dec.local_prefills == 0
        pre.stop()
        dec.stop()
    finally:
        server.stop()


# --- degradation ----------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
def test_lost_and_mismatched_entries_reprefill_as_jax_counts(
        fixture_models, golden, layout):
    dec = _port(fixture_models, kv_layout=layout, role="decode")
    jdec = _jax(fixture_models, kv_layout=layout, role="decode")
    store = LocalHandoff()
    assert store.claim("never-published") is None
    # JAX rejects a contiguous consumer's entry wider than its cache and
    # either layout's entry of the other slot axis (the port: no rows for
    # its layers, and the slot axis)
    bogus = dict(length=len(PROMPTS[0]), bucket=1024, rows=[],
                 last_logits=np.zeros((1, 160), np.float32),
                 slot_axis=0 if layout == "contiguous" else 1)
    short = dict(length=4, bucket=16, rows=[],
                 last_logits=np.zeros((1, 160), np.float32))
    for entry in (None, bogus, short):
        got = _decode(dec, PROMPTS[0], None if entry is None else HostEntry(
            **{**entry, "last_logits": torch.zeros(1, 160)}))
        h = jdec.submit(PROMPTS[0], JaxParams(greedy=True, max_tokens=NEW),
                        kv_entry=None if entry is None
                        else jkv.HostEntry(**entry))
        while jdec.step():
            pass
        assert got == h.result() == golden[0]
    assert (dec.local_prefills, dec.kv_rejected, dec.kv_admitted) == (
        jdec.local_prefills, jdec.kv_rejected, jdec.kv_admitted) == (3, 2, 0)
    dec.stop()
    jdec.stop()


def test_pool_down_mid_claim_degrades(fixture_models, golden):
    server = KVPoolServer(min_prefix=4).start()
    store = RemoteHandoff(server.address, namespace="m", timeout=2.0)
    pre = _port(fixture_models, role="prefill", handoff=store)
    hid = _prefill_to(pre, PROMPTS[1])
    server.stop()                       # the pool dies before the claim
    assert store.claim(hid) is None and store.claim_errors == 1
    dec = _port(fixture_models, role="decode")
    assert _decode(dec, PROMPTS[1], None) == golden[1]
    assert dec.local_prefills == 1
    # a prefill replica whose pool is gone finishes "handoff_failed"
    h = pre.submit(PROMPTS[0], SP, handoff_id=new_handoff_id())
    while pre.step():
        pass
    assert h.result() == [] and h.finish_reason == "handoff_failed"
    assert pre.handoff_publish_failed == 1
    pre.stop()
    dec.stop()


def test_pow2_width_past_cache_len_is_admitted_where_jax_rejects(
        fixture_models):
    """ROADMAP.md §C: a page-wise entry of 56 rows (7 pages of 8) for a
    50-token prompt. JAX's contiguous consumer pads it to 64 > its
    cache_len of 60 and rejects it; the port copies the 50 rows and
    decodes the golden tokens."""
    prompt = [(i * 5 + 2) % 160 for i in range(50)]
    sp = SamplingParams(greedy=True, max_tokens=6)
    store = LocalHandoff()
    pre = _port(fixture_models, kv_layout="paged", role="prefill",
                handoff=store, cache_len=60)
    host = store.claim(_prefill_to(pre, prompt, sp))
    assert (host.length, host.bucket, host.page_size) == (50, 56, 8)
    want = _port(fixture_models, cache_len=60).generate(prompt, sp)
    dec = _port(fixture_models, cache_len=60, role="decode")
    h = dec.submit(prompt, sp, kv_entry=host)
    while dec.step():
        pass
    assert h.result() == want and dec.kv_admitted == 1
    jentry = jkv.HostEntry(
        length=50, bucket=56, page_size=8, last_logits=host.last_logits.numpy(),
        rows=[{k: v.numpy() for k, v in layer.items()} for layer in host.rows])
    jdec = _jax(fixture_models, cache_len=60, role="decode")
    assert "exceeds engine cache_len" in jdisagg.usable_for_engine(
        jentry, prompt, jdec)
    pre.stop()
    dec.stop()
    jdec.stop()


def test_fp8_decode_pool_takes_a_saturating_cast_of_the_entry(
        fixture_models):
    """An f32 entry into an fp8 paged decode pool: the pool's rows are the
    entry's saturating fp8 cast (JAX's bytes wherever its cast is finite,
    ROADMAP.md §C), and the stream equals JAX's fp8 decode replica's."""
    store = LocalHandoff()
    pre = _port(fixture_models, kv_layout="paged", role="prefill",
                handoff=store)
    hid = _prefill_to(pre, PROMPTS[3])
    host = store.claim(hid)
    dec = _port(fixture_models, kv_layout="paged", role="decode",
                cache_dtype=torch.float8_e4m3fn)
    h = dec.submit(PROMPTS[3], SP, kv_entry=host)
    dec.step()                            # admission inserts the rows
    pages = dec.paged.slot_pages(0)
    rows = torch.cat([torch.arange(p * 8, p * 8 + 8) for p in pages])
    rows = rows[:len(PROMPTS[3])]
    for layer, src in zip(dec.paged.kv, host.rows):
        for k in ("k", "v"):
            want = to_kv_dtype(src[k][0, :len(PROMPTS[3])],
                               torch.float8_e4m3fn)
            assert torch.equal(layer[k][rows].view(torch.uint8),
                               want.view(torch.uint8))
    while dec.step():
        pass
    jdec = _jax(fixture_models, kv_layout="paged", role="decode",
                cache_dtype=jnp.float8_e4m3fn)
    jh = jdec.submit(PROMPTS[3], JaxParams(greedy=True, max_tokens=NEW),
                     kv_entry=jkv.HostEntry(
                         length=host.length, bucket=host.bucket,
                         page_size=host.page_size,
                         last_logits=host.last_logits.numpy(),
                         rows=[{k: v.numpy() for k, v in layer.items()}
                               for layer in host.rows]))
    while jdec.step():
        pass
    assert h.result() == jh.result()
    pre.stop()
    dec.stop()
    jdec.stop()


# --- a decode replica under load ------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_replica_zero_mixed_blocks_under_concurrent_load(
        fixture_models, golden, layout):
    mixed_kw = dict(chunked_prefill=8, decode_steps=4)
    store = LocalHandoff()
    pre = _port(fixture_models, kv_layout=layout, role="prefill",
                handoff=store, **mixed_kw)
    dec = _port(fixture_models, kv_layout=layout, role="decode", **mixed_kw)
    hosts = [store.claim(_prefill_to(pre, p)) for p in PROMPTS]
    dec.start()
    try:
        handles = [dec.submit(p, SP, kv_entry=h)
                   for p, h in zip(PROMPTS, hosts)]
        outs = [h.result() for h in handles]
    finally:
        dec.stop()
        pre.stop()
    assert outs == golden
    assert dec.mixed_blocks == 0 and not dec.slot_prefill
    assert dec.kv_admitted == len(PROMPTS) and dec.local_prefills == 0


SPEC_COUNTERS = ("spec_rounds", "spec_proposed", "spec_accepted",
                 "spec_round_tokens", "mixed_blocks", "local_prefills",
                 "kv_admitted")


@pytest.mark.parametrize("role", ["decode", "both"])
def test_decode_role_composes_speculation_with_a_local_prefill(
        fixture_models, role):
    """decode_steps 4 and k = 4: one request decodes from a claimed entry
    while a long prompt without one prefills in chunks of 8. A decode
    replica keeps speculating (no mixed block); a ``both`` engine runs
    the fused mixed step. The counters equal JAX's after every step."""
    kw = dict(chunked_prefill=8, decode_steps=4, speculative_k=4,
              role=role, max_slots=2)
    store = LocalHandoff()
    pre = _port(fixture_models, role="prefill", handoff=store)
    repeat = [5, 6, 7, 8, 9] * 4                 # a prompt ngram can draft
    host = store.claim(_prefill_to(pre, repeat))
    jhost = jkv.HostEntry(length=host.length, bucket=host.bucket,
                          last_logits=host.last_logits.numpy(),
                          rows=[{k: v.numpy() for k, v in layer.items()}
                                for layer in host.rows])
    port, jeng = _port(fixture_models, **kw), _jax(fixture_models, **kw)
    sp = dict(greedy=True, max_tokens=24)
    hp = [port.submit(repeat, SamplingParams(**sp), kv_entry=host)]
    hj = [jeng.submit(repeat, JaxParams(**sp), kv_entry=jhost)]
    port.step()
    jeng.step()
    hp.append(port.submit(PROMPTS[3], SamplingParams(**sp)))
    hj.append(jeng.submit(PROMPTS[3], JaxParams(**sp)))
    for i in range(40):
        busy = port.step()
        assert busy == jeng.step(), i
        assert ({c: getattr(port, c) for c in SPEC_COUNTERS}
                == {c: getattr(jeng, c) for c in SPEC_COUNTERS}), i
        if not busy:
            break
    assert [h.result() for h in hp] == [h.result() for h in hj]
    assert port.kv_admitted == 1
    assert port.local_prefills == (role == "decode")
    if role == "decode":
        assert port.mixed_blocks == 0 and port.spec_rounds > 0
    else:
        assert port.mixed_blocks > 0
    for e in (pre, port, jeng):
        e.stop()


# --- HTTP and the CLI -------------------------------------------------------------


class CharTok:
    """One character per token (ids past 127 decode to '')."""

    def encode(self, text: str) -> list[int]:
        return [min(ord(c), 127) for c in text]

    def decode(self, ids) -> str:
        return "".join(chr(int(i)) if int(i) < 128 else "" for i in ids)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            raw = r.read().decode()
            status = r.status
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    if body.get("stream"):
        data = [ln[6:] for ln in raw.split("\n") if ln.startswith("data: ")]
        assert data[-1] == "[DONE]"
        events = [json.loads(d) for d in data[:-1]]
        return status, "".join(e["choices"][0]["delta"].get("content", "")
                               for e in events)
    return status, json.loads(raw)


@pytest.fixture
def disagg_http(fixture_models):
    """A prefill server and a decode server sharing a pool server."""
    pool = KVPoolServer(min_prefix=4).start()
    servers, base = [], {}
    try:
        for role in ("prefill", "decode"):
            store = RemoteHandoff(pool.address, namespace="m", timeout=5.0)
            eng = _port(fixture_models, kv_layout="paged", role=role,
                        handoff=store if role == "prefill" else None,
                        max_queue=1 if role == "decode" else None)
            srv = OpenAIServer(eng, CharTok(), model_name="m", role=role,
                               handoff=store)
            base[role] = "http://127.0.0.1:%d" % srv.serve(
                host="127.0.0.1", port=0, background=True)
            servers.append(srv)
        yield base, servers, pool
    finally:
        for srv in servers:
            srv.shutdown()
        pool.stop()


BODY = {"model": "m", "max_tokens": 8, "temperature": 0.0,
        "messages": [{"role": "user", "content": "hi"}]}


def _golden_text(fixture_models):
    from types import SimpleNamespace

    ids = CharTok().encode(build_prompt(
        [SimpleNamespace(**m) for m in BODY["messages"]]))
    eng = _jax(fixture_models)
    out = eng.generate(ids, JaxParams(greedy=True, max_tokens=8))
    eng.stop()
    return ids, CharTok().decode(out)


def test_http_prefill_then_claim_streams_the_golden_tokens(fixture_models,
                                                           disagg_http):
    base, servers, pool = disagg_http
    ids, want = _golden_text(fixture_models)
    status, out = _post(base["decode"] + "/internal/handoff/prefill", BODY)
    assert status == 501
    texts = []
    for stream in (False, True):
        status, out = _post(base["prefill"] + "/internal/handoff/prefill",
                            BODY)
        assert status == 200 and out["prompt_tokens"] == len(ids)
        assert pool.stats()["handoff_pending"] == 1
        status, got = _post(base["decode"] + "/v1/chat/completions",
                            dict(BODY, stream=stream, kv_transfer_params={
                                "handoff_id": out["handoff_id"]}))
        assert status == 200
        texts.append(got if stream
                     else got["choices"][0]["message"]["content"])
    assert texts == [want, want]
    dec = servers[1].engine
    assert dec.kv_admitted == 2 and dec.local_prefills == 0
    assert dec.mixed_blocks == 0 and dec.prefill_batches_run == 0
    assert servers[1].handoff_meter.claimed == 2
    assert pool.stats()["handoff_pending"] == 0
    # a lost id re-prefills locally and still answers
    status, got = _post(base["decode"] + "/v1/chat/completions",
                        dict(BODY, kv_transfer_params={"handoff_id": "gone"}))
    assert status == 200 and got["choices"][0]["message"]["content"] == want
    assert servers[1].handoff_meter.lost == 1 and dec.local_prefills == 1


def test_http_shed_request_repins_its_claimed_entry(fixture_models,
                                                    disagg_http):
    base, servers, pool = disagg_http
    status, out = _post(base["prefill"] + "/internal/handoff/prefill", BODY)
    assert status == 200
    dec_srv = servers[1]
    eng = dec_srv.engine
    # park the decode engine's loop at admission so the queue stays full
    gate_in, gate_out = __import__("threading").Event(), \
        __import__("threading").Event()
    admit = eng._admit

    def parked():
        gate_in.set()
        gate_out.wait(30)
        return admit()

    eng._admit = parked
    assert gate_in.wait(30)
    eng.submit([1, 2, 3], SamplingParams(max_tokens=1))   # fills max_queue 1
    status, got = _post(base["decode"] + "/v1/chat/completions",
                        dict(BODY, kv_transfer_params={
                            "handoff_id": out["handoff_id"]}))
    assert status == 429 and got["error"]["code"] == "queue_full"
    assert dec_srv.handoff_meter.repinned == 1
    assert pool.stats()["handoff_pending"] == 1     # the retry can claim
    eng._admit = admit
    gate_out.set()


def test_cli_role_and_kv_remote_checks(capsys):
    from llm_in_practise_tpu_torch.serve.__main__ import (
        build_parser,
        engine_kw_for,
        validate_args,
    )

    def error(msg):
        raise SystemExit(msg)

    parser = build_parser()
    base = ["--tokenizer_path", "t"]
    for role in ("prefill", "decode"):
        with pytest.raises(SystemExit, match="requires --kv-remote"):
            validate_args(parser.parse_args(base + ["--role", role]), error)
    with pytest.raises(SystemExit, match="HOST:PORT"):
        validate_args(parser.parse_args(base + ["--kv-remote", "nope"]),
                      error)
    args = parser.parse_args(base + ["--role", "decode", "--kv-remote",
                                     "127.0.0.1:8100"])
    validate_args(args, error)
    assert args.speculative == 4 and "speculation on" in capsys.readouterr().out
    args = parser.parse_args(base + ["--role", "decode", "--kv-remote",
                                     "127.0.0.1:8100", "--speculative", "0"])
    validate_args(args, error)
    assert args.speculative is None
    kw = engine_kw_for(args, "m")
    assert kw["role"] == "decode" and kw["handoff"].address == (
        "127.0.0.1", 8100)
    assert kw["kv_pool"].remote.namespace == "m"
    args = parser.parse_args(base + ["--kv-offload"])
    validate_args(args, error)
    kw = engine_kw_for(args, "m")
    assert kw["handoff"] is None and kw["kv_pool"].remote is None


def test_cli_builds_tiers_and_handoff_stores_per_model(tmp_path):
    """``--lora-modules`` with ``--kv-offload`` and ``--kv-remote``: an
    engine per adapter, each with tiers and a handoff store of its own
    model name (JAX ``examples/serve_openai.py:380-419, 494-498``); the
    adapter's engine serves its merged weights' greedy tokens."""
    from llm_in_practise_tpu_torch.ckpt.checkpoint import save_named
    from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
    from llm_in_practise_tpu_torch.data.sft import IM_END, IM_START
    from llm_in_practise_tpu_torch.models.convert import (
        lora_to_jax,
        params_to_jax,
    )
    from llm_in_practise_tpu_torch.models.qwen3 import Qwen3
    from llm_in_practise_tpu_torch.peft.lora import (
        LoRAConfig,
        init_lora,
        merge_lora,
    )
    from llm_in_practise_tpu_torch.serve.__main__ import (
        build_parser,
        build_server,
        validate_args,
    )

    from torch_port_util import tiny_port_model

    text = "one two three four five six seven eight " * 3
    tok = BPETokenizer.train([text] * 4, vocab_size=300,
                             special_tokens=[IM_START, IM_END],
                             min_frequency=1)
    tok.save(str(tmp_path / "tok.json"))
    pmodel = tiny_port_model(tok.get_vocab_size(), seed=7, max_seq_len=128,
                             hidden_size=64, intermediate_size=128,
                             n_head=4, n_kv_head=2, head_dim=16)
    state = {n: p.detach() for n, p in pmodel.named_parameters()}
    model = save_named(str(tmp_path / "m"), params_to_jax(state, pmodel.cfg),
                       "model", metadata={"config": pmodel.cfg.to_dict()})
    lcfg = LoRAConfig(r=4, alpha=8.0, target_patterns=("attn/q_proj",))
    gen = torch.Generator().manual_seed(3)
    lora = init_lora(state, lcfg, gen)
    for ab in lora.values():
        ab["b"] = 0.3 * torch.randn(ab["b"].shape, generator=gen)
    save_named(str(tmp_path / "a"), lora_to_jax(lora), "adapter",
               metadata={"lora_config": lcfg.to_dict()})
    pool = KVPoolServer().start()
    try:
        args = build_parser().parse_args(
            ["--model_path", model, "--tokenizer_path",
             str(tmp_path / "tok.json"), "--device", "cpu", "--max_slots",
             "2", "--cache_len", "64", "--lora-modules",
             f"tuned={tmp_path / 'a'}", "--kv-offload", "--kv-remote",
             "%s:%d" % pool.address, "--role", "prefill"])

        def error(msg):
            raise AssertionError(msg)

        validate_args(args, error)
        srv = build_server(args)
        base, tuned = srv.engine, srv.adapters["tuned"]
        assert srv.role == "prefill" and tuned.role == "prefill"
        assert base.adapter_registry is None and tuned is not base
        assert (base.kv_pool.remote.namespace, tuned.kv_pool.remote.namespace
                ) == ("qwen3-h100", "tuned")
        assert tuned.kv_pool is not base.kv_pool
        assert tuned.handoff._client.namespace == "__handoff__/tuned"
        merged = Qwen3(pmodel.cfg, device="cpu")
        merged.load_state(merge_lora(state, lora, lcfg))
        ids = tok.encode(text[:40])
        sp = SamplingParams(greedy=True, max_tokens=6)
        want = InferenceEngine(merged, max_slots=1, cache_len=64,
                               cache_dtype=torch.float32).generate(ids, sp)
        assert tuned.generate(ids, sp) == want
        base.stop()
        tuned.stop()
    finally:
        pool.stop()
