"""PyTorch port: every metric family the port's servers register is in
``docs/observability.md``'s catalog, and every HBM-ledger account the
port books matches a pattern of its "Memory plane" glossary (the doc
check of ``tools/check_metric_docs.py``, whose doc-matching helpers this
reuses, over the port's registries and sources). The port's families
also carry the JAX families' types, help and label names.
"""

import os
import re

import jax.numpy as jnp
import pytest
import torch

from promparse import parse_exposition
from torch_port_util import load_fixture_both
from tools import check_metric_docs as docs

from llm_in_practise_tpu.serve.api import OpenAIServer as JaxServer
from llm_in_practise_tpu.serve.engine import InferenceEngine as JaxEngine
from llm_in_practise_tpu.serve.kv_pool import KVPoolServer as JaxPool
from llm_in_practise_tpu_torch.serve.api import OpenAIServer
from llm_in_practise_tpu_torch.serve.engine import InferenceEngine
from llm_in_practise_tpu_torch.serve.kv_pool import KVPoolServer
from llm_in_practise_tpu_torch.serve.sessions import SessionStore

PORT_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "llm_in_practise_tpu_torch")


class _Tok:
    def encode(self, text):
        return [ord(c) % 160 for c in text][:32]

    def decode(self, ids):
        return "".join(chr(int(i) % 160) for i in ids)


# every conditional family on: paged KV, the prefix cache, speculation,
# multi-step decode, a session store
ENGINE_KW = dict(max_slots=2, cache_len=64, kv_layout="paged",
                 kv_page_size=8, prefix_cache=True, speculative_k=2,
                 decode_steps=2)


@pytest.fixture(scope="module")
def registries():
    """The port's model server and pool server registries, and JAX's, each
    built with every conditional family on (never started)."""
    jmodel, jparams, pmodel = load_fixture_both()
    eng = InferenceEngine(pmodel, cache_dtype=torch.float32,
                          session_store=SessionStore(), **ENGINE_KW)
    jeng = JaxEngine(jmodel, jparams, cache_dtype=jnp.float32, **ENGINE_KW)
    pool, jpool = KVPoolServer(), JaxPool()
    out = {"port": [OpenAIServer(eng, _Tok(), model_name="census").registry,
                    pool.registry],
           "jax": [JaxServer(jeng, _Tok(), model_name="census").registry,
                   jpool.registry]}
    yield out
    eng.stop()
    jeng.stop()
    for p in (pool, jpool):
        p._server.server_close()


def _names(regs) -> frozenset:
    out = set()
    for reg in regs:
        out |= reg.family_names()
    return frozenset(out)


def test_every_port_family_is_in_the_docs_catalog(registries):
    names = _names(registries["port"])
    assert len(names) >= 50
    for must in ("llm_sessions_active", "llm_session_turns_total",
                 "llm_hbm_ledger_bytes", "llm_kv_pages", "llm_spec_rounds_total",
                 "llm_multi_decode_blocks_total", "llm_tenant_tokens_total",
                 "kvpool_handoff_wire_seconds", "kvpool_handoff_total"):
        assert must in names, must
    assert docs.check(registered=names) == []
    # the check has teeth: an undocumented name is reported
    assert docs.check(registered=names | {"llm_not_a_documented_family"}) \
        == ["llm_not_a_documented_family"]


def test_port_families_match_jax_types_help_and_labels(registries):
    def families(regs):
        return {f.name: f for reg in regs for f in reg._families}

    ours, theirs = families(registries["port"]), families(registries["jax"])
    assert set(ours) <= set(theirs), sorted(set(ours) - set(theirs))
    for name, fam in ours.items():
        assert (fam.kind, fam.help) == (theirs[name].kind,
                                        theirs[name].help), name

    def label_names(regs):
        out = {}
        for reg in regs:
            for fam in parse_exposition(reg.render()).values():
                out[fam.name] = {frozenset(k for k, _ in labels) - {"le"}
                                 for _, labels in fam.samples}
        return out

    ours_l, theirs_l = (label_names(registries["port"]),
                        label_names(registries["jax"]))
    for name, labels in ours_l.items():
        if labels and theirs_l.get(name):
            assert labels == theirs_l[name], name


def _port_ledger_accounts() -> dict:
    """``account pattern -> ["path:line", ...]`` for every literal owner
    booked in the port's sources (the tool's own census walks only the
    JAX package and the tools)."""
    out: dict = {}
    for dirpath, _, filenames in os.walk(PORT_SRC):
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path, encoding="utf-8") as f:
                for lineno, line in enumerate(f, 1):
                    for m in docs._LEDGER_CALL.finditer(line):
                        owner = m.group(3)
                        if m.group(1):          # f-string: {rb} -> *
                            owner = re.sub(r"\{[^{}]*\}", "*", owner)
                        out.setdefault(owner, []).append(
                            f"{os.path.relpath(path, PORT_SRC)}:{lineno}")
    return out


def test_every_port_ledger_account_is_in_the_glossary():
    accounts = _port_ledger_accounts()
    assert {"weights/model", "weights/draft_model", "kv_pool.pages",
            "kv.contiguous", "kv.draft", "adapters/r*", "session_pins",
            "transient_view", "handoff_staging"} <= set(accounts)
    assert docs.check_ledger_owners(accounts=accounts) == []
    assert docs.check_ledger_owners(
        accounts={**accounts, "scratch/unknown": ["x.py:1"]})


def test_pool_registry_renders_strict_and_reads_live_counters():
    pool = KVPoolServer()
    try:
        pool.handoff_wire["hput"].observe(0.003)
        pool.handoff_puts += 1
        fams = parse_exposition(pool.metrics_text())
        assert fams["kvpool_handoff_total"].samples[
            ("kvpool_handoff_total", frozenset({("event", "pinned")}))] == 1
        assert fams["kvpool_handoff_wire_seconds"].samples[
            ("kvpool_handoff_wire_seconds_count",
             frozenset({("op", "hput")}))] == 1
        assert pool.stats()["handoff_puts"] == 1
    finally:
        pool._server.server_close()


# the families of the tracer and the device plane (JAX api.py:700-1087),
# less the tensor-parallel three, which wait for sharded serving
PLANE_FAMILIES = (
    "llm_build_info", "llm_compile_events_total", "llm_compile_seconds_total",
    "llm_device_busy_fraction", "llm_host_gap_fraction",
    "llm_host_gap_seconds_total", "llm_step_wall_seconds_total",
    "llm_engine_steps_total", "llm_dispatch_mfu", "llm_dispatch_hbm_bw_util",
    "llm_dispatch_tokens_per_dispatch", "llm_dispatches_per_step",
    "llm_dispatches_total", "llm_mixed_blocks_total",
    "llm_goodput_tokens_total", "llm_slo_requests_total",
    "llm_slo_blame_total", "llm_ttft_seconds", "llm_tpot_seconds",
    "llm_request_critical_path_seconds_total")
TP_FAMILIES = ("llm_collective_bytes_total", "llm_collective_seconds_total",
               "llm_tp_size")


def test_port_registers_the_tracer_and_device_plane_families(registries):
    server, pool = registries["port"]
    assert len(PLANE_FAMILIES) == 20
    assert set(PLANE_FAMILIES) <= server.family_names()
    assert not set(TP_FAMILIES) & server.family_names()
    assert set(TP_FAMILIES) <= registries["jax"][0].family_names()
    assert "llm_build_info" in pool.family_names()
    # each renders through the strict parser, the histograms with buckets
    fams = parse_exposition(server.render())
    for name in PLANE_FAMILIES:
        assert name in fams, name
    assert fams["llm_ttft_seconds"].kind == "histogram"
    assert "llm_build_info" in parse_exposition(pool.render())
