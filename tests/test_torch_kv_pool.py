"""PyTorch port: the tiered KV pool (``serve/kv_pool.py``) against the JAX
package.

- The wire: for f32, bf16 and fp8 rows, with and without ``token_ids``,
  with and without last logits, the port's ``encode_entry`` equals JAX's
  byte for byte, and each package's ``decode_entry`` reads the other's
  blob. The port's client against JAX's pool server and JAX's client
  against the port's: ``put`` / ``get``, ``hput`` / ``hclaim`` and
  ``stats`` answer the same as within one package.
- The server's contracts (JAX ``tests/test_kv_pool.py``): longest-prefix
  LRU, namespaces, the global token / byte / namespace budgets, framing
  caps, connection faults, handoff TTL and budget, pin-until-claimed.
- The tiers in the engine, each in lockstep with the JAX engine on the
  committed HF fixture in f32 (the same greedy tokens and tier counters):
  offload on L1 eviction with a re-hit from the host pool, write-through
  shared across two engines through a pool server (both layouts), the
  ``usable`` filter, ``kv_pool`` turning the prefix cache on, a caller's
  ``on_evict`` chained, no re-offload of a written-through entry, the
  circuit breaker, and an L3 that dies mid-offload.

Every socket carries a timeout and every server stops in a finalizer.
"""

import socket
import struct
import threading
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torch_port_util import load_fixture_both

from llm_in_practise_tpu.serve import kv_pool as jkv
from llm_in_practise_tpu.serve.engine import InferenceEngine as JaxEngine
from llm_in_practise_tpu.serve.engine import SamplingParams as JaxParams
from llm_in_practise_tpu.serve.prefix_cache import PrefixCache as JaxPrefixCache
from llm_in_practise_tpu_torch.serve import kv_pool as pkv
from llm_in_practise_tpu_torch.serve.engine import (
    InferenceEngine,
    SamplingParams,
)
from llm_in_practise_tpu_torch.serve.kv_pool import (
    HandoffRejected,
    HostEntry,
    HostKVPool,
    KVPoolServer,
    RemoteKVClient,
    TieredKV,
    decode_entry,
    encode_entry,
)
from llm_in_practise_tpu_torch.serve.prefix_cache import PrefixCache

torch.set_num_threads(1)

_NP = {"float32": np.dtype(np.float32),
       "bfloat16": np.dtype(ml_dtypes.bfloat16),
       "float8_e4m3fn": np.dtype(ml_dtypes.float8_e4m3fn)}


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """The same bytes as a torch tensor of the same dtype."""
    raw = torch.from_numpy(np.frombuffer(a.tobytes(), np.uint8).copy())
    return raw.view(pkv.WIRE_DTYPES[a.dtype.name]).reshape(a.shape)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    raw = t.contiguous().view(torch.uint8).numpy().tobytes()
    return np.frombuffer(raw, _NP[pkv._wire_name(t)]).reshape(t.shape)


def _entries(dtype: str, token_ids: bool, logits: bool, length=16,
             bucket=16, layers=2):
    """The same entry in both packages (numpy arrays for JAX, tensors of
    the same bytes for the port)."""
    rng = np.random.default_rng(length + layers)
    rows = [{k: (rng.standard_normal((1, bucket, 2, 4)) * 3).astype(
        np.float32).astype(_NP[dtype]) for k in ("k", "v")}
        for _ in range(layers)]
    last = (rng.standard_normal((1, 64)).astype(np.float32) if logits
            else None)
    ids = [int(t) for t in rng.integers(0, 1000, length)] if token_ids \
        else None
    j = jkv.HostEntry(length=length, bucket=bucket, rows=rows,
                      last_logits=last, token_ids=ids)
    p = HostEntry(length=length, bucket=bucket,
                  rows=[{k: _to_torch(v) for k, v in layer.items()}
                        for layer in rows],
                  last_logits=None if last is None else _to_torch(last),
                  token_ids=ids)
    return j, p


def _host_entry(length=16, bucket=16, layers=2):
    return _entries("float32", False, True, length, bucket, layers)[1]


def _same_entry(port: HostEntry, jax: "jkv.HostEntry") -> None:
    assert (port.length, port.bucket, port.slot_axis, port.page_size,
            port.token_ids) == (jax.length, jax.bucket, jax.slot_axis,
                                jax.page_size, jax.token_ids)
    assert len(port.rows) == len(jax.rows)
    for pl, jl in zip(port.rows, jax.rows):
        assert sorted(pl) == sorted(jl)
        for k in jl:
            assert pkv._wire_name(pl[k]) == jl[k].dtype.name
            assert _to_numpy(pl[k]).tobytes() == np.asarray(jl[k]).tobytes()
    if jax.last_logits is None:
        assert port.last_logits is None
    else:
        np.testing.assert_array_equal(port.last_logits.numpy(),
                                      jax.last_logits)


@pytest.fixture
def servers():
    """Started pool servers of either package, stopped at teardown."""
    started = []

    def start(server):
        started.append(server.start())
        return server

    yield start
    for s in started:
        s.stop()


# --- the wire -----------------------------------------------------------------


@pytest.mark.parametrize("logits", [True, False], ids=["logits", "null"])
@pytest.mark.parametrize("token_ids", [False, True], ids=["plain", "ids"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e4m3fn"])
def test_encode_equals_jax_bytes_and_decodes_across(dtype, token_ids,
                                                    logits):
    j, p = _entries(dtype, token_ids, logits)
    blob = encode_entry(p)
    assert blob == jkv.encode_entry(j)
    _same_entry(decode_entry(blob), j)
    _same_entry(p, jkv.decode_entry(blob))
    # a page-wise entry's extra manifest fields ride the same way
    j.page_size = p.page_size = 8
    assert encode_entry(p) == jkv.encode_entry(j)
    assert decode_entry(jkv.encode_entry(j)).pages == 2


def test_decode_rejects_a_short_blob_and_an_unknown_dtype():
    _, p = _entries("float32", False, True)
    blob = encode_entry(p)
    with pytest.raises(ValueError, match="shorter"):
        decode_entry(blob[:-4])
    p.rows[0]["k"] = p.rows[0]["k"].to(torch.float16)
    with pytest.raises(ValueError, match="wire name"):
        encode_entry(p)


def _op_sequence(client_cls, entry_of, address):
    """put / get / hput / hclaim / stats against one server; every answer
    in a comparable form."""
    a = client_cls(address, namespace="m-a", timeout=5.0)
    b = client_cls(address, namespace="m-b", timeout=5.0)
    out = []
    prompt = list(range(32))
    a.put(prompt, entry_of(32))
    for query in (prompt, prompt + [7, 7], [5, 4, 3, 2, 1]):
        got = a.get(query)
        out.append(None if got is None else (got.length, got.bucket))
    out.append(b.get(prompt) is None)            # namespaces isolate
    a.handoff_put("h1", entry_of(16))
    got = a.handoff_claim("h1")
    out.append((got.length, got.bucket))
    out.append(a.handoff_claim("h1") is None)     # claimed once
    out.append(b.handoff_claim("h1") is None)
    out.append(a.stats())
    return out


@pytest.mark.parametrize("pair", ["port_client_jax_server",
                                  "jax_client_port_server"])
def test_clients_and_servers_interoperate(pair, servers):
    def port_entry(n):
        return _entries("bfloat16", False, True, length=n, bucket=n)[1]

    def jax_entry(n):
        return _entries("bfloat16", False, True, length=n, bucket=n)[0]

    want = _op_sequence(jkv.RemoteKVClient, jax_entry,
                        servers(jkv.KVPoolServer(min_prefix=4)).address)
    if pair == "port_client_jax_server":
        server = servers(jkv.KVPoolServer(min_prefix=4))
        got = _op_sequence(RemoteKVClient, port_entry, server.address)
    else:
        server = servers(KVPoolServer(min_prefix=4))
        got = _op_sequence(jkv.RemoteKVClient, jax_entry, server.address)
    assert got == want
    # the stored blob is the other package's, byte for byte
    j, p = _entries("bfloat16", False, True, length=32, bucket=32)
    stored = next(iter(server._entries.values()))[2]
    assert bytes(stored) == encode_entry(p) == jkv.encode_entry(j)


# --- the server ---------------------------------------------------------------


def test_host_pool_longest_prefix_and_lru():
    pool = HostKVPool(max_tokens=64, min_prefix=4)
    pool.put(list(range(8)), _host_entry(length=8, bucket=8))
    pool.put(list(range(16)), _host_entry(length=16, bucket=16))
    hit = pool.lookup(list(range(20)))
    assert hit is not None and hit.length == 16
    assert pool.lookup([99, 98, 97, 96, 95]) is None
    pool.put(list(range(100, 148)), _host_entry(length=48, bucket=48))
    assert pool.cached_tokens <= 64


def test_prefix_lru_on_evict_peek_and_pop_lru_match_jax():
    from llm_in_practise_tpu.serve.prefix_cache import PrefixLRU as JaxLRU
    from llm_in_practise_tpu_torch.serve.prefix_cache import PrefixLRU

    logs = {"port": [], "jax": []}
    lrus = {"port": PrefixLRU(max_tokens=40, min_prefix=4,
                              length_of=len,
                              on_evict=lambda k, v: logs["port"].append(k)),
            "jax": JaxLRU(max_tokens=40, min_prefix=4, length_of=len,
                          on_evict=lambda k, v: logs["jax"].append(k))}
    for lru in lrus.values():
        for i in range(5):
            lru.put(list(range(10 * i, 10 * i + 12)), "x" * 12)
        assert lru.peek(tuple(range(40, 52))) == "x" * 12
        assert lru.peek((1, 2)) is None
        lru.pop_lru()
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 3
    assert (lrus["port"].cached_tokens, lrus["port"].n_entries) == (
        lrus["jax"].cached_tokens, lrus["jax"].n_entries)
    while lrus["port"].pop_lru() is not None:
        pass
    assert lrus["port"].n_entries == 0


def test_pool_server_roundtrip_and_prefix_match(servers):
    server = servers(KVPoolServer(min_prefix=4))
    client = RemoteKVClient(server.address)
    prompt = list(range(32))
    client.put(prompt, _host_entry(length=32, bucket=32))
    for query in (prompt, prompt + [7, 7, 7]):
        got = client.get(query)
        assert got is not None and got.length == 32
    assert client.get([5, 4, 3, 2, 1]) is None
    stats = client.stats()
    assert stats["entries"] == 1 and stats["hits"] == 2


def test_pool_server_namespaces_isolate_models(servers):
    server = servers(KVPoolServer(min_prefix=4))
    a = RemoteKVClient(server.address, namespace="model-a")
    b = RemoteKVClient(server.address, namespace="model-b")
    prompt = list(range(16))
    a.put(prompt, _host_entry())
    assert b.get(prompt) is None
    assert a.get(prompt) is not None
    b.put(prompt, _host_entry())
    stats = a.stats()
    assert stats["entries"] == 2 and stats["namespaces"] == 2


def test_pool_server_concurrent_clients(servers):
    server = servers(KVPoolServer(min_prefix=4))
    errors = []

    def worker(base):
        try:
            client = RemoteKVClient(server.address)
            prompt = list(range(base, base + 16))
            client.put(prompt, _host_entry())
            got = client.get(prompt)
            assert got is not None and got.length == 16
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i * 100,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors
    assert server.stats()["entries"] == 8


def test_pool_server_rejects_oversized_frames(servers):
    server = servers(KVPoolServer(max_payload=1 << 16))
    with socket.create_connection(server.address, timeout=2.0) as s:
        s.sendall(struct.pack("<II", 8, (1 << 32) - 1) + b'{"op":1}')
        assert s.recv(1) == b""
    client = RemoteKVClient(server.address, namespace="m")
    client.put(list(range(16)), _host_entry())
    assert client.get(list(range(20))) is not None


def test_pool_server_global_byte_budget_evicts_lru(servers):
    entry = _host_entry()
    blob_size = len(encode_entry(entry))
    server = servers(KVPoolServer(max_bytes=int(blob_size * 2.5),
                                  max_tokens=1 << 20))
    a = RemoteKVClient(server.address, namespace="a")
    b = RemoteKVClient(server.address, namespace="b")
    p1, p2, p3 = ([i, *range(1, 16)] for i in (101, 102, 103))
    a.put(p1, entry)
    b.put(p2, entry)
    assert server.cached_bytes == 2 * blob_size
    a.put(p3, entry)
    assert server.cached_bytes == 2 * blob_size
    assert a.get(p1 + [99]) is None
    assert b.get(p2 + [99]) is not None
    assert a.get(p3 + [99]) is not None


def test_pool_server_bounds_namespaces(servers):
    server = servers(KVPoolServer(max_namespaces=2))
    for ns in ("a", "b"):
        RemoteKVClient(server.address, namespace=ns).put(
            list(range(16)), _host_entry())
    RemoteKVClient(server.address, namespace="c").put(
        list(range(16)), _host_entry())
    assert server.rejected == 1
    assert RemoteKVClient(server.address, namespace="c").get(
        list(range(20))) is None
    assert RemoteKVClient(server.address, namespace="a").get(
        list(range(20))) is not None


def test_pool_server_short_prefix_and_over_cap_puts_leak_no_budget(servers):
    server = servers(KVPoolServer(min_prefix=16))
    client = RemoteKVClient(server.address, namespace="m")
    client.put(list(range(8)), _host_entry(length=8, bucket=8))
    assert server.cached_bytes == 0 and server.rejected == 1
    assert "m" not in server._namespaces
    tight = servers(KVPoolServer(min_prefix=4, max_payload=16))
    with pytest.raises(OSError):
        RemoteKVClient(tight.address, namespace="n").put(
            list(range(16)), _host_entry())
    assert tight.cached_bytes == 0 and "n" not in tight._namespaces


def test_pool_server_replacement_put_accounts_once(servers):
    entry = _host_entry()
    server = servers(KVPoolServer())
    client = RemoteKVClient(server.address, namespace="m")
    client.put(list(range(16)), entry)
    client.put(list(range(16)), entry)
    assert server.cached_bytes == len(encode_entry(entry))


def test_pool_server_contains_connection_faults(servers):
    server = servers(KVPoolServer(min_prefix=4, max_payload=1 << 16))
    with socket.create_connection(server.address, timeout=2.0) as s:
        s.sendall(struct.pack("<II", 7, 0) + b"not{json")
        assert s.recv(1) == b""
    with socket.create_connection(server.address, timeout=2.0) as s:
        s.sendall(struct.pack("<II", 8, (1 << 32) - 1) + b'{"op":1}')
        assert s.recv(1) == b""
    with socket.create_connection(server.address, timeout=2.0) as s:
        s.sendall(struct.pack("<II", 64, 0) + b"abc")
    with socket.create_connection(server.address, timeout=2.0):
        pass
    deadline = time.monotonic() + 5
    while server.conn_errors < 3 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert server.conn_errors == 3
    client = RemoteKVClient(server.address, namespace="m")
    client.put(list(range(16)), _host_entry())
    assert client.get(list(range(20))) is not None
    assert client.stats()["conn_errors"] == 3


def test_namespace_slot_released_when_entries_evicted(servers):
    entry = _host_entry()
    blob = len(encode_entry(entry))
    server = servers(KVPoolServer(max_namespaces=2,
                                  max_bytes=int(blob * 1.5)))
    for i, ns in enumerate(("v1", "v2", "v3", "v4")):
        c = RemoteKVClient(server.address, namespace=ns)
        prompt = [100 + i, *range(1, 16)]
        c.put(prompt, entry)
        assert c.get(prompt + [99]) is not None, ns
    assert server.rejected == 0 and server.n_namespaces == 1


def test_handoff_pin_survives_eviction_pressure(servers):
    blob = len(encode_entry(_host_entry()))
    server = servers(KVPoolServer(min_prefix=4, max_bytes=int(blob * 1.5)))
    client = RemoteKVClient(server.address, namespace="m")
    pinned = _host_entry(layers=1)
    client.handoff_put("pinned", pinned)
    for i in range(4):
        client.put([100 + i, *range(1, 16)], _host_entry())
    got = client.handoff_claim("pinned")
    assert got is not None and got.length == 16
    assert torch.equal(got.rows[0]["k"], pinned.rows[0]["k"])
    assert server.stats()["handoff_pending"] == 0
    # each handoff op is timed once (booked just after its reply)
    deadline = time.monotonic() + 5
    while (server.handoff_wire["hclaim"][0] < 1
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert [server.handoff_wire[op][0] for op in ("hput", "hclaim")] == [1, 1]


def test_handoff_ttl_reclaim_and_budget(servers):
    clock = {"t": 0.0}
    server = servers(KVPoolServer(min_prefix=4, handoff_ttl_s=30.0,
                                  clock=lambda: clock["t"]))
    client = RemoteKVClient(server.address, namespace="m")
    e = _host_entry(layers=1)
    e.page_size = 8
    client.handoff_put("h", e)
    assert server.handoff_pages == 2
    clock["t"] = 31.0
    assert client.handoff_claim("h") is None
    assert server.handoff_expired == 1
    assert server.handoff_bytes == 0 and server.handoff_pages == 0
    tight = servers(KVPoolServer(min_prefix=4,
                                 max_handoff_bytes=len(encode_entry(e))))
    client = RemoteKVClient(tight.address, namespace="m")
    client.handoff_put("a", e)
    with pytest.raises(HandoffRejected):
        client.handoff_put("b", e)
    assert tight.handoff_rejected == 1
    assert client.handoff_claim("a") is not None


def test_remote_circuit_breaker_after_failure():
    clock = {"t": 0.0}
    pool = TieredKV(HostKVPool(min_prefix=4),
                    RemoteKVClient(("127.0.0.1", 1), timeout=0.2),
                    remote_cooldown_s=30.0, clock=lambda: clock["t"])
    assert pool.lookup(list(range(16))) is None
    assert pool.remote_errors == 1
    assert pool.lookup(list(range(16))) is None
    assert pool.remote_errors == 1
    clock["t"] = 31.0
    assert pool.lookup(list(range(16))) is None
    assert pool.remote_errors == 2


def test_slow_remote_lookup_trips_cooldown(servers):
    server = servers(KVPoolServer())
    client = RemoteKVClient(server.address, namespace="m", timeout=5.0)
    client.put(list(range(16)), _host_entry())
    clock = {"t": 0.0}
    pool = TieredKV(HostKVPool(min_prefix=4), client, remote_cooldown_s=30.0,
                    lookup_timeout_s=0.25, clock=lambda: clock["t"])
    real_get = client.get

    def slow_get(prompt_ids, timeout=None):
        clock["t"] += 1.0
        return real_get(prompt_ids, timeout=timeout)

    client.get = slow_get
    assert pool.lookup(list(range(16))) is not None
    assert pool.slow_trips == 1 and pool.remote_errors == 0
    pool.host_pool.clear()
    assert pool.lookup(list(range(16))) is None
    assert pool.slow_trips == 1


def test_pool_server_cli_serves_and_refuses_metrics_port():
    import subprocess
    import sys

    with pytest.raises(NotImplementedError, match="item 6"):
        pkv.main(["--metrics-port", "8101"])
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "llm_in_practise_tpu_torch.serve.kv_pool",
         "--port", "0"], stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        host, port = line.split(" on ")[1].split(" ")[0].rsplit(":", 1)
        client = RemoteKVClient((host, int(port)), timeout=5.0)
        assert client.stats()["entries"] == 0
    finally:
        proc.terminate()
        proc.wait(timeout=10)


# --- the tiers in the engine, in lockstep with JAX ---------------------------

PROMPT_A = list(range(1, 33))          # 32 tokens: a cacheable prefix
PROMPT_B = list(range(40, 60))         # another prefix, forces eviction


@pytest.fixture(scope="module")
def fixture_models():
    return load_fixture_both()


class _Pair:
    """The same tier setup on the port and on the JAX package."""

    def __init__(self, fixture_models, *, l1=None, remote=None,
                 layout="contiguous", hook=None, prefix_cache=None,
                 **pool_kw):
        jmodel, jparams, pmodel = fixture_models
        self.seen = {"port": [], "jax": []}
        kw = dict(max_slots=2, cache_len=64, kv_layout=layout,
                  kv_page_size=8)
        jl1 = pl1 = prefix_cache
        if l1 is not None:
            jl1 = JaxPrefixCache(
                max_tokens=l1, min_prefix=8,
                on_evict=(lambda k, e: self.seen["jax"].append(k))
                if hook else None)
            pl1 = PrefixCache(
                max_tokens=l1, min_prefix=8,
                on_evict=(lambda k, e: self.seen["port"].append(k))
                if hook else None)
        self.jpool = jkv.TieredKV(
            jkv.HostKVPool(min_prefix=8),
            None if remote is None else jkv.RemoteKVClient(
                remote[0].address, namespace="m"), **pool_kw)
        self.ppool = TieredKV(
            HostKVPool(min_prefix=8),
            None if remote is None else RemoteKVClient(
                remote[1].address, namespace="m"), **pool_kw)
        self.jeng = JaxEngine(jmodel, jparams, cache_dtype=jnp.float32,
                              prefix_cache=jl1, kv_pool=self.jpool, **kw)
        self.peng = InferenceEngine(pmodel, cache_dtype=torch.float32,
                                    prefix_cache=pl1, kv_pool=self.ppool,
                                    **kw)

    def generate(self, prompt, n=6):
        got = self.peng.generate(prompt, SamplingParams(greedy=True,
                                                        max_tokens=n))
        want = self.jeng.generate(prompt, JaxParams(greedy=True,
                                                    max_tokens=n))
        assert got == want
        self.ppool.flush()
        self.jpool.flush()
        return got

    def counters(self):
        out = {}
        for name, eng, pool in (("port", self.peng, self.ppool),
                                ("jax", self.jeng, self.jpool)):
            pc = eng.prefix_cache
            out[name] = dict(
                l1_hits=pc.hits, l1_misses=pc.misses,
                l1_full_hits=pc.full_hits, l1_saved=pc.tokens_saved,
                l2_hits=pool.host_pool.hits, l2_misses=pool.host_pool.misses,
                l2_tokens=pool.host_pool.cached_tokens,
                l2_entries=pool.host_pool.n_entries,
                remote_errors=pool.remote_errors)
        assert out["port"] == out["jax"], out
        return out["port"]

    def close(self):
        self.jeng.stop()
        self.peng.stop()


def test_offload_on_eviction_rehits_from_host_pool(fixture_models):
    pair = _Pair(fixture_models, l1=40, offload_on_put=False)
    cold = pair.generate(PROMPT_A)
    pair.generate(PROMPT_B)       # B's entry pushes A out of the 40-token L1
    c = pair.counters()
    assert c["l2_tokens"] >= 32   # A was offloaded, not dropped
    assert pair.generate(PROMPT_A) == cold
    c = pair.counters()
    assert c["l2_hits"] >= 1
    pair.close()


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_writethrough_shares_prefix_across_engines(fixture_models, servers,
                                                   layout):
    remote = (servers(jkv.KVPoolServer(min_prefix=8)),
              servers(KVPoolServer(min_prefix=8)))
    first = _Pair(fixture_models, remote=remote, layout=layout)
    out1 = first.generate(PROMPT_A)
    assert remote[1]._entries and remote[0]._entries
    second = _Pair(fixture_models, remote=remote, layout=layout)
    assert second.generate(PROMPT_A) == out1
    assert remote[1].hits == remote[0].hits >= 1
    assert second.ppool.host_pool.misses == second.jpool.host_pool.misses >= 1
    assert second.generate(PROMPT_A) == out1
    if layout == "contiguous":
        c = second.counters()
        assert c["l1_full_hits"] >= 1
    else:
        # the tier hit was promoted into the page index
        assert (second.peng.prefix_cache.hits
                == second.jeng.prefix_cache.hits >= 1)
    # the stored blobs carry the same bytes
    (pk, pv), = remote[1]._entries.items()
    (jk, jv), = remote[0]._entries.items()
    assert pk == jk and pv[:2] == jv[:2]
    assert decode_entry(bytes(pv[2])).length == jkv.decode_entry(
        jv[2]).length
    for p in (first, second):
        p.close()


def test_unusable_pool_entry_is_filtered_before_any_copy(fixture_models):
    pair = _Pair(fixture_models, offload_on_put=False)
    # rows of another model's shape (and wider than the cache): touching
    # them would fail loudly
    big = _entries("float32", False, True, length=32, bucket=256)
    pair.ppool.host_pool.put(PROMPT_A, big[1])
    pair.jpool.host_pool.put(PROMPT_A, big[0])
    assert len(pair.generate(PROMPT_A, 4)) == 4
    pair.counters()
    pair.close()


def test_pool_entry_with_a_long_suffix_serves(fixture_models):
    pair = _Pair(fixture_models, offload_on_put=True)
    pair.generate(PROMPT_A, 4)
    # a 60-token prompt sharing A's 32: the suffix fits in both packages
    assert len(pair.generate(PROMPT_A + list(range(100, 128)), 2)) == 2
    pair.counters()
    pair.close()


def test_kv_pool_turns_the_prefix_cache_on(fixture_models):
    pair = _Pair(fixture_models, prefix_cache=False, async_offload=False)
    assert pair.peng.prefix_cache is not None
    pair.generate(PROMPT_A, 4)
    c = pair.counters()
    assert c["l2_tokens"] >= len(PROMPT_A)     # write-through ran
    pair.close()


def test_caller_on_evict_hook_is_chained(fixture_models):
    pair = _Pair(fixture_models, l1=40, hook=True, offload_on_put=False,
                 async_offload=False)
    pair.generate(PROMPT_A, 4)
    pair.generate(PROMPT_B, 4)
    assert pair.seen["port"] == pair.seen["jax"]
    assert pair.seen["port"][0][: len(PROMPT_A)] == tuple(PROMPT_A)
    assert pair.counters()["l2_tokens"] >= 32   # the offload ran too
    pair.close()


def test_writethrough_entry_not_reoffloaded_on_eviction(fixture_models):
    pair = _Pair(fixture_models, l1=40, async_offload=False)
    calls = {"port": [], "jax": []}
    for name, pool in (("port", pair.ppool), ("jax", pair.jpool)):
        orig = pool.offload

        def spy(ids, e, _orig=orig, _log=calls[name]):
            _log.append(tuple(ids))
            return _orig(ids, e)

        pool.offload = spy
    pair.generate(PROMPT_A, 4)     # write-through #1
    pair.generate(PROMPT_B, 4)     # evicts A: no second offload of A
    assert calls["port"] == calls["jax"]
    assert sum(c[: len(PROMPT_A)] == tuple(PROMPT_A)
               for c in calls["port"]) == 1
    pair.close()


def test_l3_dies_mid_offload_fails_open_then_recovers(fixture_models):
    clock = {"t": 0.0}
    server = KVPoolServer(min_prefix=8).start()
    host, port = server.address
    pool = TieredKV(HostKVPool(min_prefix=8),
                    RemoteKVClient((host, port), timeout=1.0),
                    async_offload=False, remote_cooldown_s=30.0,
                    clock=lambda: clock["t"])
    eng = InferenceEngine(fixture_models[2], max_slots=2, cache_len=64,
                          cache_dtype=torch.float32,
                          prefix_cache=PrefixCache(max_tokens=40,
                                                   min_prefix=8),
                          kv_pool=pool)
    sp = SamplingParams(greedy=True, max_tokens=6)
    try:
        cold = eng.generate(PROMPT_A, sp)
        assert server._entries
    finally:
        server.stop()
    assert len(eng.generate(PROMPT_B, sp)) == 6       # offload fails open
    assert pool.remote_errors >= 1
    errors = pool.remote_errors
    assert eng.generate(PROMPT_A, sp) == cold          # the host copy
    pool.host_pool.clear()
    assert pool.lookup([9] * 9) is None
    assert pool.remote_errors == errors                # breaker open
    revived = KVPoolServer(host, port, min_prefix=8).start()
    try:
        RemoteKVClient((host, port)).put(PROMPT_A, _host_entry(32, 32))
        clock["t"] = 31.0
        hit = pool.lookup(PROMPT_A)
        assert hit is not None and hit.length == 32 and revived.hits >= 1
    finally:
        revived.stop()
