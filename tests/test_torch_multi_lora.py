"""PyTorch port: batched multi-LoRA serving (``serve/multi_lora.py``,
``serve/adapters.py``, the engine's adapter rows and the adapter twins of
its step paths, the API's adapter model names, ``--lora-modules``)
against the JAX package.

The adapters are JAX ``tests/test_multi_lora.py``'s, numpy-seeded: ``t1``
r 2 (rank bucket 2) on ``attn/q_proj`` and ``mlp``, ``t2`` r 3 (bucket 4)
on ``attn/q_proj``, B noised so that they steer, carried into the port
with ``lora_from_jax``. The model is the committed HF fixture (f32
compute and KV).

- The registry against JAX's through one sequence of register, acquire,
  busy hot-swap, evict, re-register, byte-budget eviction, an exhausted
  budget and churn: rows, rank buckets, capacities, ``ns``,
  ``bytes_loaded``, ``n_bytes``, the counters and the errors equal. A
  recycled row carries no stale delta; ``dispatch_args`` is None when
  every row is base.
- The gathered delta equals JAX's ``_gathered_delta`` at 1e-6 on the
  same banks and mixed rows; base rows are exactly 0.
- The engine in lockstep with the JAX registry engine, {contiguous,
  paged} x {spec off, ngram, the target as its own draft}: base, ``t1``
  and ``t2`` interleaved, then a prompt under ``t1`` chunk-prefilling
  (the fused mixed step's twin): tokens and finish reasons equal JAX's
  and the port's own merged-weight engines'; a steady step with mixed
  adapters is one target dispatch; the draft stays base.
- Over NF4 (the port's plain versions, JAX's interpret-mode kernels): a
  contiguous case's greedy tokens equal.
- Masked twins: a ``json_schema`` greedy request under an adapter beside
  a base request, in both layouts, equal to JAX's and valid.
- Preemption under an adapter, prefix isolation in both layouts, the
  submit errors, ``AdapterHandle``, ``build_adapter_engines``'s two
  branches, the API (adapter names streamed and not, 404, ``/v1/models``,
  embeddings under an adapter name equal to JAX's base vectors at 1e-5),
  the CLI's ``--lora-modules`` and its five errors.
"""

import contextlib
import itertools
import json
import logging
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import load_fixture_both, numpy_params

from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.models.qwen3 import qwen3_config as jax_qwen3_config
from llm_in_practise_tpu.peft.lora import LoRAConfig as JaxLoRAConfig
from llm_in_practise_tpu.peft.lora import init_lora as jax_init_lora
from llm_in_practise_tpu.peft.lora import stack_lora_tree as jax_stack
from llm_in_practise_tpu.quant import nf4 as jax_nf4
from llm_in_practise_tpu.serve import constrain as jax_constrain
from llm_in_practise_tpu.serve.api import OpenAIServer as JaxServer
from llm_in_practise_tpu.serve.engine import InferenceEngine as JaxEngine
from llm_in_practise_tpu.serve.engine import SamplingParams as JaxParams
from llm_in_practise_tpu.serve.multi_lora import (
    AdapterHandle as JaxHandle,
)
from llm_in_practise_tpu.serve.multi_lora import (
    AdapterRegistry as JaxRegistry,
)
from llm_in_practise_tpu.serve.multi_lora import (
    _gathered_delta as jax_gathered_delta,
)
from llm_in_practise_tpu_torch.ckpt.checkpoint import save_named
from llm_in_practise_tpu_torch.models.convert import (
    lora_from_jax,
    params_from_jax,
    params_to_jax,
)
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
from llm_in_practise_tpu_torch.peft.lora import LoRAConfig, merge_lora
from llm_in_practise_tpu_torch.peft.lora import stack_lora_tree
from llm_in_practise_tpu_torch.serve import constrain
from llm_in_practise_tpu_torch.serve.adapters import (
    build_adapter_engines,
    parse_lora_modules,
)
from llm_in_practise_tpu_torch.serve.api import OpenAIServer
from llm_in_practise_tpu_torch.serve.engine import (
    InferenceEngine,
    SamplingParams,
)
from llm_in_practise_tpu_torch.serve.multi_lora import (
    AdapterHandle,
    AdapterRegistry,
    LoRAProjection,
    current_lora,
    gathered_delta,
    lora_context,
)
from llm_in_practise_tpu_torch.serve.quantized import QuantizedModel

K = 4
PAGE = 8
ENGINE = dict(max_slots=4, cache_len=64, chunked_prefill=8, decode_steps=4,
              speculative_k=K)
P0 = [1, 5, 9, 13, 2, 7, 1, 8, 2, 8, 3, 1, 4, 1, 5, 9]
P1 = [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18]
LONG = [(i * 7 + 3) % 160 for i in range(30)]   # 4 chunks of 8
NEW = 12
DELTA_TOL = 1e-6
EMBED_TOL = 1e-5
C1 = dict(r=2, alpha=4.0, target_patterns=("attn/q_proj", "mlp"))
C2 = dict(r=3, alpha=6.0, target_patterns=("attn/q_proj",))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models' ops run faster on one thread than on a pool that
    the test runner's parallel workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_lora(jparams, cfg: dict, seed: int) -> dict:
    """A JAX-layout LoRA tree for ``jparams`` (JAX ``init_lora``'s
    targets and shapes) with numpy-seeded factors: A N(0, 0.1), B
    N(0, 0.3), so that the adapter steers greedy tokens."""
    rng = np.random.default_rng(seed)
    tree = jax_init_lora(jparams, JaxLoRAConfig(**cfg), jax.random.PRNGKey(0))
    return {path: {"a": (0.1 * rng.standard_normal(ab["a"].shape)
                         ).astype(np.float32),
                   "b": (0.3 * rng.standard_normal(ab["b"].shape)
                         ).astype(np.float32)}
            for path, ab in sorted(tree.items())}


@pytest.fixture(scope="module")
def world():
    """The fixture in both packages and the two adapters: JAX trees and
    configs, the same trees in the port, and their merged-weight port
    models."""
    jmodel, jparams, pmodel = load_fixture_both()
    cfg = pmodel.config
    state = {n: p.detach() for n, p in pmodel.named_parameters()}
    adapters = {}
    for name, c, seed in (("t1", C1, 1), ("t2", C2, 3)):
        jt = _numpy_lora(jparams, c, seed)
        pt = lora_from_jax(jt, cfg)
        merged = Qwen3(cfg, device="cpu")
        merged.load_state(merge_lora(state, pt, LoRAConfig(**c)))
        adapters[name] = dict(jtree=jt, jcfg=JaxLoRAConfig(**c), tree=pt,
                              cfg=LoRAConfig(**c), merged=merged)
    return dict(jmodel=jmodel, jparams=jparams, pmodel=pmodel, state=state,
                adapters=adapters)


def _port_registry(world, **kw):
    reg = AdapterRegistry(world["pmodel"], **kw)
    for name, a in world["adapters"].items():
        reg.register_tree(name, a["tree"], a["cfg"])
    return reg


def _jax_registry(world, **kw):
    reg = JaxRegistry(world["jparams"], **kw)
    for name, a in world["adapters"].items():
        reg.register_tree(name, a["jtree"], a["jcfg"])
    return reg


_MERGED: dict = {}


def _merged_tokens(world, adapter, prompt, n=NEW) -> list[int]:
    """The port's own merged-weight engine's greedy stream (base for
    None), computed once per (adapter, prompt, n)."""
    key = (adapter, tuple(prompt), n)
    if key not in _MERGED:
        model = (world["pmodel"] if adapter is None
                 else world["adapters"][adapter]["merged"])
        eng = InferenceEngine(model, max_slots=1, cache_len=64,
                              cache_dtype=torch.float32)
        _MERGED[key] = eng.generate(prompt, SamplingParams(
            greedy=True, max_tokens=n))
    return _MERGED[key]


# --- stacking, the registry, the delta ---------------------------------------


def test_stack_lora_tree_equals_jax(world):
    a = world["adapters"]["t1"]
    got = stack_lora_tree(a["tree"], 2)
    want = jax_stack(a["jtree"], 2)
    assert sorted(got) == sorted(
        k.replace("/", ".") for k in want)
    for key, ab in want.items():
        for part in ("a", "b"):
            np.testing.assert_array_equal(
                got[key.replace("/", ".")][part].numpy(),
                np.asarray(ab[part]))
    part = {k: v for k, v in a["tree"].items() if k.startswith("blocks.0.")}
    with pytest.raises(ValueError, match="every\nlayer|every layer"):
        stack_lora_tree(part, 2)
    with pytest.raises(ValueError, match="every layer"):
        jax_stack({k: v for k, v in a["jtree"].items()
                   if k.startswith("block_0/")}, 2)


def _view(reg) -> dict:
    s = reg.stats()
    recs = {n: (r.rb, r.row, r.ns, r.n_bytes, r.refcount)
            for n, r in reg._adapters.items()}
    return {"recs": recs, "bytes": reg.bytes_loaded,
            **{k: s[k] for k in ("loaded", "loads_total", "evictions_total",
                                 "tenant_tokens", "buckets", "refcounts")}}


def _both(op, jreg, preg):
    """Run ``op`` on both registries: the same result or the same error,
    then the same state."""
    outs = []
    for reg in (jreg, preg):
        try:
            outs.append(("ok", op(reg)))
        except (RuntimeError, KeyError, ValueError) as e:
            outs.append((type(e).__name__, str(e)))
    assert outs[0] == outs[1], outs
    assert _view(jreg) == _view(preg)
    return outs[0]


def test_registry_sequence_equals_jax(world):
    ad = world["adapters"]

    def reg_tree(name, which):
        return lambda r: r.register_tree(
            name, *((ad[which]["jtree"], ad[which]["jcfg"])
                    if isinstance(r, JaxRegistry)
                    else (ad[which]["tree"], ad[which]["cfg"])))

    jreg = JaxRegistry(world["jparams"])
    preg = AdapterRegistry(world["pmodel"])
    assert preg.n_layer == jreg.n_layer == 2
    _both(reg_tree("t1", "t1"), jreg, preg)
    _both(reg_tree("t2", "t2"), jreg, preg)
    _both(lambda r: r.acquire("t1"), jreg, preg)
    assert _both(reg_tree("t1", "t1"), jreg, preg)[0] == "RuntimeError"
    assert _both(lambda r: r.evict("t1"), jreg, preg)[0] == "RuntimeError"
    assert _both(lambda r: r.acquire("nope"), jreg, preg)[0] == "KeyError"
    _both(lambda r: r.note_tokens("t1", 5), jreg, preg)
    _both(lambda r: r.release("t1"), jreg, preg)
    assert _both(lambda r: r.evict("t1"), jreg, preg) == ("ok", True)
    assert _both(lambda r: r.evict("t1"), jreg, preg) == ("ok", False)
    _both(reg_tree("t1", "t1"), jreg, preg)        # the recycled row
    _both(reg_tree("t3", "t1"), jreg, preg)        # bucket 2 grows
    _both(reg_tree("t2", "t2"), jreg, preg)        # hot swap: a fresh ns
    for name in (None, "t1", "t2", "nope"):
        assert _both(lambda r: r.ns_of(name), jreg, preg)[0] == "ok"
    assert _both(lambda r: r.names(), jreg, preg)[1] == ["t1", "t2", "t3"]
    assert _both(lambda r: "t3" in r, jreg, preg)[1] is True
    assert jreg.dispatch_args([None, None]) is None
    assert preg.dispatch_args([None, None]) is None
    # byte budget: the LRU idle adapter goes; with every row busy, the
    # load raises
    b1 = preg._adapters["t1"].n_bytes
    b2 = preg._adapters["t2"].n_bytes
    jb = JaxRegistry(world["jparams"], max_bytes=max(b1, b2))
    pb = AdapterRegistry(world["pmodel"], max_bytes=max(b1, b2))
    _both(reg_tree("t1", "t1"), jb, pb)
    _both(reg_tree("t2", "t2"), jb, pb)
    assert "t1" not in pb and pb.evictions_total == 1
    _both(lambda r: r.acquire("t2"), jb, pb)
    assert _both(reg_tree("t1", "t1"), jb, pb)[0] == "RuntimeError"
    # churn across both buckets: every row back, no bytes left
    jc = JaxRegistry(world["jparams"])
    pc = AdapterRegistry(world["pmodel"])
    for i in range(4):
        _both(reg_tree(f"a{i}", "t1"), jc, pc)
        _both(reg_tree(f"b{i}", "t2"), jc, pc)
    for i in range(4):
        _both(lambda r: r.evict(f"a{i}"), jc, pc)
        _both(lambda r: r.evict(f"b{i}"), jc, pc)
    s = pc.stats()
    assert s["loaded"] == 0 and s["bytes_loaded"] == 0
    assert all(b["free"] == b["cap"] - 1 for b in s["buckets"].values())
    assert s["swap_seconds_total"] > 0 and len(pc.swap_seconds) == 8
    with pytest.raises(NotImplementedError, match="item 14"):
        AdapterRegistry(world["pmodel"], mesh=object())


def test_recycled_row_carries_no_stale_delta(world):
    """``t1`` (q_proj and mlp) evicted, then an r 2 adapter on q_proj
    only in its recycled row: the row's mlp factors are zero and the
    stream is its merged-weight engine's."""
    cfg2 = dict(C2, r=2, alpha=9.0)
    jt = _numpy_lora(world["jparams"], cfg2, 5)
    pt = lora_from_jax(jt, world["pmodel"].config)
    reg = AdapterRegistry(world["pmodel"])
    a = world["adapters"]["t1"]
    reg.register_tree("t1", a["tree"], a["cfg"])
    row = reg._adapters["t1"].row
    reg.evict("t1")
    reg.register_tree("q", pt, LoRAConfig(**cfg2))
    assert reg._adapters["q"].row == row
    bank = reg._buckets[2]
    for key, fac in bank.stacked.items():
        if "mlp" in key:
            assert not fac["a"][row].any() and not fac["b"][row].any()
    eng = InferenceEngine(world["pmodel"], max_slots=2, cache_len=64,
                          cache_dtype=torch.float32, adapter_registry=reg)
    got = eng.generate(P1, SamplingParams(greedy=True, max_tokens=NEW),
                       adapter="q")
    merged = Qwen3(world["pmodel"].config, device="cpu")
    merged.load_state(merge_lora(world["state"], pt, LoRAConfig(**cfg2)))
    ref = InferenceEngine(merged, max_slots=1, cache_len=64,
                          cache_dtype=torch.float32).generate(
        P1, SamplingParams(greedy=True, max_tokens=NEW))
    assert got == ref


def test_gathered_delta_equals_jax(world):
    jreg, preg = _jax_registry(world), _port_registry(world)
    rows = [None, "t1", "t2", "t1", None]
    jargs = jreg.dispatch_args(rows)
    pargs = preg.dispatch_args(rows)
    assert sorted(pargs["idx"]) == sorted(jargs["idx"]) == [2, 4]
    for rb in pargs["idx"]:
        np.testing.assert_array_equal(pargs["idx"][rb],
                                      np.asarray(jargs["idx"][rb]))
    ctx = {"idx": {rb: torch.from_numpy(v) for rb, v in pargs["idx"].items()},
           "banks": pargs["banks"]}
    x = np.random.default_rng(0).standard_normal((5, 3, 64)).astype(
        np.float32)
    for layer, target in itertools.product((0, 1), ("attn/q_proj",
                                                     "mlp/up_proj")):
        jkey = f"block_{layer}/{target}/kernel"
        pkey = f"blocks.{layer}.{target.replace('/', '.')}.kernel"
        want = np.asarray(jax_gathered_delta(jargs, jkey, jnp.asarray(x)))
        got = gathered_delta(ctx, pkey, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got.reshape(want.shape), want,
                                   rtol=DELTA_TOL, atol=DELTA_TOL)
        assert not got[0].any() and not got[4].any()   # base rows: 0
        if target == "mlp/up_proj":                    # t2 lacks mlp
            assert not got[2].any()
    # a target no bucket carries
    assert gathered_delta(ctx, "blocks.0.attn.k_proj.kernel",
                          torch.from_numpy(x)) is None
    assert jax_gathered_delta(jargs, "block_0/attn/k_proj/kernel",
                              jnp.asarray(x)) is None


def test_projection_runs_base_without_a_context(world):
    """The facade's wrappers: with no context each calls its module and
    nothing else; the context stack is per thread."""
    reg = _port_registry(world)
    eng = InferenceEngine(world["pmodel"], max_slots=2, cache_len=64,
                          cache_dtype=torch.float32, adapter_registry=reg)
    q = world["pmodel"].blocks[0].attn.q_proj
    assert isinstance(q, LoRAProjection) and eng.model.inner is \
        world["pmodel"]
    x = torch.randn(2, 3, 64)
    assert torch.equal(q(x), q.inner(x))
    assert current_lora() is None
    with lora_context({"idx": {}, "banks": {}}):
        assert current_lora() is not None
    assert current_lora() is None


# --- the engine in lockstep with the JAX registry engine ---------------------


@pytest.fixture(scope="module")
def engine_pairs(world):
    """One port and one JAX registry engine per layout, the target as its
    own draft (the ngram and spec-off cases switch it off), built at
    first use and shared by every case of the layout."""
    pairs = {}

    def get(layout):
        if layout not in pairs:
            kw = dict(ENGINE)
            if layout == "paged":
                kw.update(kv_layout="paged", kv_page_size=PAGE)
            port = InferenceEngine(
                world["pmodel"], cache_dtype=torch.float32,
                draft_model=world["pmodel"],
                adapter_registry=_port_registry(world), **kw)
            jeng = JaxEngine(
                world["jmodel"], world["jparams"], cache_dtype=jnp.float32,
                draft_model=world["jmodel"], draft_params=world["jparams"],
                adapter_registry=_jax_registry(world), **kw)
            pairs[layout] = (port, jeng)
        return pairs[layout]

    yield get
    for _, jeng in pairs.values():
        jeng.stop()


@contextlib.contextmanager
def _configured(engines, proposer):
    """Both engines with ``proposer``: ``"self"`` (the target drafts),
    ``"ngram"`` (draft off) or ``"off"`` (no speculation)."""
    saved = [(e.draft_model, e.speculative_k) for e in engines]
    for e in engines:
        if proposer != "self":
            e.draft_model = None
        if proposer == "off":
            e.speculative_k = None
    try:
        yield engines
    finally:
        for e, (draft, k) in zip(engines, saved):
            e.draft_model, e.speculative_k = draft, k


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("proposer", ["off", "ngram", "self"])
def test_lockstep_matches_jax_registry_engine(world, engine_pairs, layout,
                                              proposer):
    # the short streams outlive the long prompt's prefill, so steady
    # mixed-adapter steps follow it
    sp = dict(greedy=True, max_tokens=24)
    jobs = [(P0, None), (P0, "t1"), (P1, "t2")]
    kinds = []
    with _configured(engine_pairs(layout), proposer) as (port, jeng):
        run = port.graphs.run

        def spy(kind, n, **kw):
            kinds.append((kind, kw.get("lora") is not None))
            return run(kind, n, **kw)

        port.graphs.run = spy
        try:
            hp = [port.submit(p, SamplingParams(**sp), adapter=a)
                  for p, a in jobs]
            hj = [jeng.submit(p, JaxParams(**sp), adapter=a)
                  for p, a in jobs]
            assert port.step() and jeng.step()
            hp.append(port.submit(LONG, SamplingParams(greedy=True,
                                                       max_tokens=6),
                                  adapter="t1"))
            hj.append(jeng.submit(LONG, JaxParams(greedy=True, max_tokens=6),
                                  adapter="t1"))
            steady = []
            for i in itertools.count():
                assert i < 200, "the load never drained"
                drafts = port.draft_rolls_run + port.draft_chunks_run
                busy = port.step()
                assert busy == jeng.step(), f"step {i}"
                if not busy:
                    break
                if (not port.slot_prefill and port._ready_slots()
                        and len({port.slot_adapter[s]
                                 for s in port._ready_slots()}) > 1):
                    steady.append(port.last_step_dispatches
                                  - (port.draft_rolls_run
                                     + port.draft_chunks_run - drafts))
        finally:
            del port.graphs.run
        outs = [r.result() for r in hp]
        assert outs == [r.result() for r in hj]
        assert [r.finish_reason for r in hp] == \
            [r.finish_reason for r in hj]
        # the contract of JAX's test_mixed_adapter_parity: each stream is
        # its merged-weight engine's
        for (p, a), out in zip(jobs + [(LONG, "t1")], outs):
            assert out == _merged_tokens(world, a, p, len(out)), a
        assert outs[0] != outs[1][:len(outs[0])]          # t1 steers
        # steady decode with mixed adapters: one target dispatch a step
        assert steady and set(steady) == {1}, steady
        reg = port.adapter_registry
        assert all(v == 0 for v in reg.stats()["refcounts"].values())
        if port.paged is not None:
            port.paged.pool.check_leaks(0)
    assert port.mixed_blocks > 0
    ran = {k for k, lora in kinds if lora}
    assert all(k != "droll" for k in ran)             # the draft is base
    pre = "p" if layout == "paged" else ""
    assert pre + "mixed" in ran and (pre + "decode" in ran
                                     or pre + "spec" in ran), ran
    if proposer != "off":
        assert pre + "spec" in ran, ran
    if proposer == "self":
        assert any(k == "droll" for k, _ in kinds)


def test_nf4_base_under_adapters_equals_jax():
    """The port's NF4 model (the kernel's plain version on the CPU) with a
    registry against JAX's ``QuantizedModel`` over the same NF4 tree with
    one: greedy tokens equal (the two differ by rounding noise only, as
    in ``test_torch_engine.py``, far below these streams' top-2 gaps)."""
    from llm_in_practise_tpu.serve.quantized import (
        QuantizedModel as JaxQuantized,
    )

    jmodel = JaxQwen3(jax_qwen3_config(
        512, hidden_size=256, intermediate_size=512, n_head=4, n_kv_head=2,
        head_dim=128, n_layer=1, compute_dtype="float32", max_seq_len=64))
    params = numpy_params(jmodel, seed=7)
    qtree = jax_nf4.quantize_tree(
        params, lambda p, leaf: p.startswith("block_") and p.endswith("kernel"))
    cfg = Qwen3Config.from_dict(jmodel.cfg.to_dict())
    pq = QuantizedModel(
        Qwen3(cfg, device="meta"),
        params_from_jax(jax.tree.map(np.asarray, qtree), cfg),
        compute_dtype=torch.float32, device="cpu")
    c = dict(r=4, alpha=8.0, target_patterns=("attn/(q_proj|v_proj)", "mlp"))
    jt = _numpy_lora(params, c, 9)
    preg = AdapterRegistry(pq)
    preg.register_tree("a", lora_from_jax(jt, cfg), LoRAConfig(**c))
    jreg = JaxRegistry(qtree)
    jreg.register_tree("a", jt, JaxLoRAConfig(**c))
    kw = dict(max_slots=2, cache_len=64)
    port = InferenceEngine(pq, cache_dtype=torch.float32,
                           adapter_registry=preg, **kw)
    jeng = JaxEngine(JaxQuantized(jmodel, compute_dtype=jnp.float32), qtree,
                     cache_dtype=jnp.float32, adapter_registry=jreg,
                     kv_layout="contiguous", **kw)
    prompts = [[3, 17, 42, 9, 88, 5, 61], [120, 7, 7, 33]]
    n = 6
    hp = [port.submit(p, SamplingParams(greedy=True, max_tokens=n),
                      adapter=a) for p, a in zip(prompts, ("a", None))]
    hj = [jeng.submit(p, JaxParams(greedy=True, max_tokens=n), adapter=a)
          for p, a in zip(prompts, ("a", None))]
    while port.step():
        pass
    while jeng.step():
        pass
    jeng.stop()
    outs = [r.result() for r in hp]
    assert outs == [r.result() for r in hj]
    base = InferenceEngine(pq, cache_dtype=torch.float32, **kw).generate(
        prompts[0], SamplingParams(greedy=True, max_tokens=n))
    assert outs[0] != base                               # the adapter steers


SCHEMA = {
    "type": "object",
    "properties": {"name": {"type": "string", "minLength": 1,
                            "maxLength": 8},
                   "age": {"type": "integer"}},
    "required": ["name", "age"],
}


class CharTok:
    """One character per token: ids 0-127 are ``chr(id)``, ids 128-159
    decode to ''."""

    def encode(self, text: str) -> list[int]:
        return [min(ord(c), 127) for c in text]

    def decode(self, ids) -> str:
        return "".join(chr(int(i)) if int(i) < 128 else "" for i in ids)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_masked_twins_under_an_adapter_equal_jax(engine_pairs, layout):
    """A ``json_schema`` greedy request under ``t2`` beside a base
    request: the masked adapter twins run; tokens equal JAX's and the
    output validates."""
    tok = CharTok()
    rf = {"type": "json_schema", "json_schema": {"schema": SCHEMA}}
    pa = constrain.compile_request_constraint(
        vocab=constrain.vocab_strings(tok, 160), response_format=rf,
        eos_id=None)
    ja = jax_constrain.compile_request_constraint(
        vocab=jax_constrain.vocab_strings(tok, 160), response_format=rf,
        eos_id=None)
    kinds = []
    with _configured(engine_pairs(layout), "off") as (port, jeng):
        run = port.graphs.run

        def spy(kind, n, **kw):
            kinds.append((kind, kw.get("lora") is not None))
            return run(kind, n, **kw)

        port.graphs.run = spy
        try:
            hp = [port.submit(P0, SamplingParams(
                      greedy=True, max_tokens=60, constraint=pa),
                      adapter="t2"),
                  port.submit(P1, SamplingParams(greedy=True, max_tokens=8))]
            hj = [jeng.submit(P0, JaxParams(greedy=True, max_tokens=60,
                                            constraint=ja), adapter="t2"),
                  jeng.submit(P1, JaxParams(greedy=True, max_tokens=8))]
            while port.step():
                pass
            while jeng.step():
                pass
        finally:
            del port.graphs.run
    outs = [r.result() for r in hp]
    assert outs == [r.result() for r in hj]
    if hp[0].finish_reason == "stop":
        assert constrain.validate_instance(json.loads(tok.decode(outs[0])),
                                           SCHEMA)
    assert hp[0].constraint_state.violations == 0
    pre = "p" if layout == "paged" else ""
    assert (pre + "mdecode", True) in kinds, kinds


def test_preemption_resume_under_adapter_equals_free_pool_and_jax(world):
    """A pool sized to preempt, adapters pinned: the streams equal a free
    pool's and JAX's; no page or refcount leaks."""
    sp = dict(greedy=True, max_tokens=30)
    prompts = [[(j * 3 + i) % 150 for i in range(20)] for j in range(3)]
    adapters = ["t1", None, "t2"]
    kw = dict(max_slots=3, cache_len=64, kv_layout="paged", kv_page_size=PAGE)
    tight = InferenceEngine(world["pmodel"], cache_dtype=torch.float32,
                            kv_pool_tokens=96, prefix_cache=True,
                            adapter_registry=_port_registry(world), **kw)
    free = InferenceEngine(world["pmodel"], cache_dtype=torch.float32,
                           adapter_registry=_port_registry(world), **kw)
    jeng = JaxEngine(world["jmodel"], world["jparams"],
                     cache_dtype=jnp.float32, kv_pool_tokens=96,
                     prefix_cache=True,
                     adapter_registry=_jax_registry(world), **kw)
    outs = []
    for eng, params in ((tight, SamplingParams), (free, SamplingParams),
                        (jeng, JaxParams)):
        rs = [eng.submit(p, params(**sp), adapter=a)
              for p, a in zip(prompts, adapters)]
        while eng.step():
            pass
        outs.append([r.result() for r in rs])
    jeng.stop()
    assert tight.preemptions > 0
    # the tight pool's streams are JAX's (finish reasons included: a slot
    # that cannot grow as the last occupant ends with "cache" in both),
    # and each is the free pool's stream, or a prefix of it
    assert outs[0] == outs[2]
    assert all(f[:len(t)] == t and len(t) >= 24
               for t, f in zip(outs[0], outs[1]))
    tight.prefix_cache.clear()
    tight.paged.pool.check_leaks(0)
    assert all(v == 0 for v in
               tight.adapter_registry.stats()["refcounts"].values())


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_prefix_cache_isolated_per_adapter(world, layout):
    pfx = [(i * 5 + 2) % 150 for i in range(40)]
    sp = SamplingParams(greedy=True, max_tokens=6)
    kw = dict(kv_layout=layout, kv_page_size=PAGE) if layout == "paged" \
        else {}
    eng = InferenceEngine(world["pmodel"], max_slots=2, cache_len=64,
                          cache_dtype=torch.float32, prefix_cache=True,
                          adapter_registry=_port_registry(world), **kw)
    first = eng.generate(pfx, sp, adapter="t1")
    h0 = eng.prefix_cache.hits
    base = eng.generate(pfx, sp)                 # base: ns 0
    eng.generate(pfx, sp, adapter="t2")          # another tenant
    assert eng.prefix_cache.hits == h0           # no cross-namespace hit
    again = eng.generate(pfx, sp, adapter="t1")
    assert eng.prefix_cache.hits == h0 + 1       # its own namespace hits
    assert again == first == _merged_tokens(world, "t1", pfx, 6)
    assert base == _merged_tokens(world, None, pfx, 6)
    assert eng._ns_ids(None, [1, 2]) == [1, 2]
    ns = eng.adapter_registry.ns_of("t1")
    assert eng._ns_ids("t1", [1, 2]) == [1 + (ns << 32), 2 + (ns << 32)]


def test_submit_errors_and_handle(world):
    reg = _port_registry(world)
    eng = InferenceEngine(world["pmodel"], max_slots=2, cache_len=64,
                          cache_dtype=torch.float32, adapter_registry=reg)
    sp = SamplingParams(greedy=True, max_tokens=NEW)
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit(P0, sp, adapter="nope")
    bare = InferenceEngine(world["pmodel"], max_slots=2, cache_len=64,
                           cache_dtype=torch.float32)
    with pytest.raises(ValueError, match="no adapter_registry"):
        bare.submit(P0, sp, adapter="t1")
    h = AdapterHandle(eng, "t1")
    r = h.submit(P0, sp)
    assert r.adapter == "t1" and reg.stats()["refcounts"]["t1"] == 1
    while eng.step():
        pass
    assert r.result() == _merged_tokens(world, "t1", P0)
    assert h.adapter_registry is reg and h.max_slots == 2
    assert reg.stats()["refcounts"]["t1"] == 0
    assert reg.stats()["tenant_tokens"] == {"t1": NEW}
    # a shed request drops its refcount at once
    eng2 = InferenceEngine(world["pmodel"], max_slots=1, cache_len=64,
                           cache_dtype=torch.float32, max_queue=1,
                           adapter_registry=reg)
    eng2.submit(P0, sp)
    shed = eng2.submit(P1, sp, adapter="t2")
    assert shed.finish_reason == "queue_full"
    assert reg.stats()["refcounts"]["t2"] == 0
    assert isinstance(JaxHandle, type)


def _write_adapter(world, tmp_path, name):
    a = world["adapters"][name]
    d = tmp_path / name
    save_named(str(d), {k: {"a": torch.from_numpy(v["a"]),
                            "b": torch.from_numpy(v["b"])}
                        for k, v in a["jtree"].items()}, "adapter",
               metadata={"lora_config": a["cfg"].to_dict()})
    return str(d)


def test_build_adapter_engines_registry_and_legacy(world, tmp_path, caplog):
    modules = {"tuned": _write_adapter(world, tmp_path, "t1")}
    kw = dict(max_slots=2, cache_len=64, cache_dtype=torch.float32)
    handles = build_adapter_engines(world["pmodel"], None, modules, **kw)
    h = handles["tuned"]
    assert isinstance(h, AdapterHandle) and "tuned" in h.adapter_registry
    sp = SamplingParams(greedy=True, max_tokens=NEW)
    assert h.generate(P0, sp) == _merged_tokens(world, "t1", P0)
    with caplog.at_level(logging.WARNING,
                         logger="llm_in_practise_tpu_torch.serve.adapters"):
        legacy = build_adapter_engines(
            world["pmodel"], world["state"], modules,
            engine_kw_for=lambda name: {}, **kw)
    eng = legacy["tuned"]
    assert not isinstance(eng, AdapterHandle) and eng.adapter_registry is None
    assert any("engine-per-adapter" in r.message for r in caplog.records)
    assert eng.generate(P0, sp) == _merged_tokens(world, "t1", P0)
    assert parse_lora_modules(["a=b", "c=d=e"]) == {"a": "b", "c": "d=e"}
    with pytest.raises(ValueError, match="name=path"):
        parse_lora_modules(["nopath"])


# --- the API and the CLI ------------------------------------------------------

NAME = "lora-test"


@pytest.fixture(scope="module")
def server(world):
    eng = InferenceEngine(world["pmodel"], max_slots=2, cache_len=64,
                          cache_dtype=torch.float32,
                          adapter_registry=_port_registry(world))
    srv = OpenAIServer(eng, CharTok(), model_name=NAME,
                       adapters={n: AdapterHandle(eng, n)
                                 for n in ("t1", "t2")})
    port = srv.serve(host="127.0.0.1", port=0, background=True)
    jeng = JaxEngine(world["jmodel"], world["jparams"], max_slots=2,
                     cache_len=64, cache_dtype=jnp.float32,
                     adapter_registry=_jax_registry(world))
    jsrv = JaxServer(jeng, CharTok(), model_name=NAME,
                     adapters={n: JaxHandle(jeng, n) for n in ("t1", "t2")})
    try:
        yield srv, jsrv, f"http://127.0.0.1:{port}"
    finally:
        srv.shutdown()
        jeng.stop()


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _chat(model, stream=False):
    return {"model": model, "temperature": 0.0, "max_tokens": 8,
            "stream": stream,
            "messages": [{"role": "user", "content": "hello"}]}


def test_api_adapter_names_streamed_and_not(world, server):
    srv, _, base = server
    url = base + "/v1/chat/completions"
    texts = {}
    for model in (NAME, "t1", "t2"):
        status, body = _post(url, _chat(model))
        assert status == 200
        texts[model] = json.loads(body)["choices"][0]["message"]["content"]
        status, raw = _post(url, _chat(model, stream=True))
        assert status == 200 and raw.rstrip().endswith("data: [DONE]")
        streamed = "".join(
            (json.loads(line[6:])["choices"][0]["delta"].get("content")
             or "") for line in raw.splitlines()
            if line.startswith("data: {"))
        assert streamed == texts[model]
    # each name serves its adapter: the tokens of its merged engine
    from llm_in_practise_tpu_torch.serve.api import build_prompt
    from llm_in_practise_tpu_torch.serve.schemas import ChatMessage

    ids = CharTok().encode(build_prompt([ChatMessage("user", "hello")]))
    for model, adapter in ((NAME, None), ("t1", "t1"), ("t2", "t2")):
        assert texts[model] == CharTok().decode(
            _merged_tokens(world, adapter, ids, 8))
    assert len(set(texts.values())) == 3


def test_api_404_lists_names_and_models_lists_adapters(server):
    _, _, base = server
    status, body = _post(base + "/v1/chat/completions", _chat("nope"))
    assert status == 404
    msg = json.loads(body)["error"]["message"]
    assert all(n in msg for n in (NAME, "t1", "t2"))
    with urllib.request.urlopen(base + "/v1/models", timeout=60) as r:
        ids = [m["id"] for m in json.loads(r.read())["data"]]
    assert ids == [NAME, "t1", "t2"]


def test_api_embeddings_under_an_adapter_are_jax_base_vectors(server):
    _, jsrv, base = server
    for model in ("t1", NAME):
        body = {"model": model, "input": ["hello there", [5, 6, 7, 8]]}
        status, raw = _post(base + "/v1/embeddings", body)
        got = {}
        jsrv.handle_embeddings(body, lambda c, b: got.update(code=c, b=b))
        assert status == got["code"] == 200
        for g, w in zip(json.loads(raw)["data"], got["b"]["data"]):
            np.testing.assert_allclose(g["embedding"], w["embedding"],
                                       rtol=EMBED_TOL, atol=EMBED_TOL)
    status, _ = _post(base + "/v1/embeddings", {"model": "nope",
                                                "input": "x"})
    assert status == 404


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """A BPE tokenizer, a dense ``model.msgpack`` of the fixture's shape
    at its vocabulary, and an adapter of that model (the port's
    ``init_lora``, B noised) saved with ``save_named``; the adapter's
    merged model beside them."""
    from llm_in_practise_tpu_torch.data.bpe import BPETokenizer
    from llm_in_practise_tpu_torch.data.sft import IM_END, IM_START
    from llm_in_practise_tpu_torch.models.convert import lora_to_jax
    from llm_in_practise_tpu_torch.peft.lora import init_lora

    from torch_port_util import tiny_port_model

    tmp = tmp_path_factory.mktemp("cli")
    text = "one two three four five six seven eight " * 3
    tok = BPETokenizer.train([text] * 4, vocab_size=300,
                             special_tokens=[IM_START, IM_END],
                             min_frequency=1)
    tok_path = str(tmp / "tok.json")
    tok.save(tok_path)
    pmodel = tiny_port_model(tok.get_vocab_size(), seed=7, max_seq_len=128,
                             hidden_size=64, intermediate_size=128,
                             n_head=4, n_kv_head=2, head_dim=16)
    cfg = pmodel.cfg
    state = {n: p.detach() for n, p in pmodel.named_parameters()}
    model = save_named(str(tmp / "m"), params_to_jax(state, cfg), "model",
                       metadata={"config": cfg.to_dict()})
    lcfg = LoRAConfig(r=4, alpha=8.0, target_patterns=("attn/q_proj",
                                                       "mlp"))
    gen = torch.Generator().manual_seed(3)
    lora = init_lora(state, lcfg, gen)
    for ab in lora.values():
        ab["a"] = ab["a"] * 10.0
        ab["b"] = 0.3 * torch.randn(ab["b"].shape, generator=gen)
    adapter = str(tmp / "a")
    save_named(adapter, lora_to_jax(lora), "adapter",
               metadata={"lora_config": lcfg.to_dict()})
    merged = Qwen3(cfg, device="cpu")
    merged.load_state(merge_lora(state, lora, lcfg))
    return tok_path, model, adapter, text, tok, merged


def test_cli_lora_modules_serves_the_adapter(world, cli_files):
    from llm_in_practise_tpu_torch.serve.__main__ import (
        build_parser,
        build_server,
        check_not_ported,
        validate_args,
    )

    tok_path, model, adapter, text, tok, merged = cli_files
    args = build_parser().parse_args(
        ["--model_path", model, "--tokenizer_path", tok_path, "--device",
         "cpu", "--max_slots", "2", "--cache_len", "64",
         "--lora-modules", f"tuned={adapter}"])

    def error(msg):
        raise AssertionError(msg)

    validate_args(args, error)
    check_not_ported(args)
    srv = build_server(args)
    assert sorted(srv.adapters) == ["tuned"]
    assert srv.engine.adapter_registry.names() == ["tuned"]
    port = srv.serve(host="127.0.0.1", port=0, background=True)
    try:
        url = f"http://127.0.0.1:{port}/v1/chat/completions"
        body = {"temperature": 0.0, "max_tokens": 8,
                "messages": [{"role": "user", "content": text[:40]}]}
        outs = {}
        for m in ("qwen3-h100", "tuned"):
            status, raw = _post(url, dict(body, model=m))
            assert status == 200
            outs[m] = json.loads(raw)["choices"][0]["message"]["content"]
    finally:
        srv.shutdown()
    from llm_in_practise_tpu_torch.data.sft import IM_END
    from llm_in_practise_tpu_torch.serve.api import build_prompt
    from llm_in_practise_tpu_torch.serve.schemas import ChatMessage

    ids = tok.encode(build_prompt([ChatMessage("user", text[:40])]))
    want = InferenceEngine(merged, max_slots=1, cache_len=64,
                           eos_id=tok.token_to_id(IM_END)).generate(
        ids, SamplingParams(greedy=True, max_tokens=8))
    assert outs["tuned"] == tok.decode(want) != outs["qwen3-h100"]
    assert list(srv.engine.adapter_registry.stats()["tenant_tokens"]) == \
        ["tuned"]


@pytest.mark.parametrize("extra,message", [
    (["--quantized_dir", "q"], "--quantized_dir"),
    (["--scan-layers", "--kv-layout", "contiguous"], "--scan-layers"),
    (["--model_name", "tuned"], "collides"),
    (["MISSING"], "no adapter checkpoint"),
    (["BAD"], "expected name=path"),
])
def test_cli_lora_modules_errors(cli_files, extra, message, capsys):
    from llm_in_practise_tpu_torch.serve.__main__ import main

    tok_path, _, adapter = cli_files[:3]
    spec = {"MISSING": ["--lora-modules", "tuned=/nonexistent/dir"],
            "BAD": ["--lora-modules", "tuned"]}.get(
        extra[0], ["--lora-modules", f"tuned={adapter}"] + extra)
    with pytest.raises(SystemExit):
        main(["--tokenizer_path", tok_path] + spec)
    assert message in capsys.readouterr().err
