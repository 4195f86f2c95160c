"""PyTorch port: structured output (``serve/constrain.py``, the masked
bodies of ``serve/mixed_step.py``, the engine's grammar staging, the
masked graph kinds' eager bodies, the API's ``response_format`` /
``tools`` surface) and ``serve/arrivals.py``, against the JAX package.

- The grammar copy: regex membership and unsupported syntax, the same
  ``ConstraintError`` on each unsupported keyword, ``validate_instance``
  on a seeded set of values, every state's mask row and transition table
  along seeded random walks equal byte for byte (states compared through
  a canonical form of the grammar graph), ``eos_id`` allowed only at
  accepting states, and the compiler's LRU eviction.
- The bodies: ``decode_scan(gmask=)`` (and its ``n == 1`` rule), the
  masked mixed step and ``spec_verify_block(gmasks=)`` at ``m`` 0 with a
  grammar-forbidden draft equal JAX's: tokens, ``n_acc`` and ``extra``
  exactly, KV at 1e-5.
- The engine in lockstep with the JAX engine on the committed HF fixture
  (its weights, ``max_seq_len`` raised to 256; f32 compute and KV; a char
  tokenizer: ids 0-127 are characters, ids 128-159 decode to ''):
  {contiguous, paged} x {spec off, ngram, the target as its own draft},
  with the mixed step: a constrained greedy request beside a plain one
  and a prompt chunk-prefilling. After every step the slot tables, the
  cursors' states and ``spec_grammar_rejects`` agree (and KV at 1e-5); at
  the end the tokens and finish reasons are equal, every constrained
  output validates, and a steady step with a constrained slot is one
  target dispatch. One JAX engine per layout serves every case.
- Conformance fuzz over the four JAX fuzz schemas at temperature 0 (equal
  to the JAX engine's tokens) and 1 (parses, validates, no violation);
  ``json_object`` mode; preemption under an active grammar (streams equal
  to the free pool's and to JAX's); a contiguous prefix-cache hit on a
  constrained prompt's entry, plain or under another schema, equal to a
  cold engine's stream and JAX's.
- The API over HTTP: ``json_schema`` streamed and not, ``tool_choice`` by
  name and ``"required"`` giving ``tool_calls``, ``tools`` with ``auto``
  served unconstrained, 422 on a malformed shape and 422
  ``invalid_constraint`` on an unsupported keyword, the structured counts.
- ``arrivals``: ``synthesize`` / ``describe`` / the session variants /
  ``lateness_stats`` equal JAX's for the same seeds; ``replay`` keeps
  schedule order.
"""

import contextlib
import dataclasses
import itertools
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import FIXTURE

from llm_in_practise_tpu.models.hf_loader import load_qwen3
from llm_in_practise_tpu.serve import arrivals as jax_arrivals
from llm_in_practise_tpu.serve import constrain as jax_constrain
from llm_in_practise_tpu.serve.engine import InferenceEngine as JaxEngine
from llm_in_practise_tpu.serve.engine import SamplingParams as JaxParams
from llm_in_practise_tpu.serve.mixed_step import decode_scan as jax_decode_scan
from llm_in_practise_tpu.serve.mixed_step import (
    make_masked_mixed_step as jax_make_masked_mixed_step,
)
from llm_in_practise_tpu.serve.mixed_step import (
    spec_verify_block as jax_spec_verify_block,
)
from llm_in_practise_tpu_torch.models.convert import params_from_jax
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
from llm_in_practise_tpu_torch.serve import arrivals, constrain
from llm_in_practise_tpu_torch.serve.api import OpenAIServer
from llm_in_practise_tpu_torch.serve.engine import (
    InferenceEngine,
    SamplingParams,
)
from llm_in_practise_tpu_torch.serve.mixed_step import (
    decode_scan,
    make_mixed_step,
    pin_index,
    spec_verify_block,
)

VOCAB = 160
KV_TOL = 1e-5
K = 4
PAGE = 16


class CharTok:
    """One character per token: ids 0-127 are ``chr(id)``, ids 128-159
    decode to '' (never maskable in)."""

    def encode(self, text: str) -> list[int]:
        return [min(ord(c), 127) for c in text]

    def decode(self, ids) -> str:
        return "".join(chr(int(i)) if int(i) < 128 else "" for i in ids)


TOK = CharTok()
VOCAB_STRS = constrain.vocab_strings(TOK, VOCAB)

SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string", "minLength": 1, "maxLength": 8},
        "age": {"type": "integer"},
        "tags": {"type": "array", "items": {"enum": ["a", "b", "c"]},
                 "minItems": 1, "maxItems": 3},
    },
    "required": ["name", "age", "tags"],
}

# tests/test_structured_output.py's fuzz schemas
FUZZ_SCHEMAS = [
    SCHEMA,
    {"type": "object",
     "properties": {"ok": {"type": "boolean"},
                    "score": {"type": "number"}},
     "required": ["ok", "score"]},
    {"type": "object",
     "properties": {"code": {"type": "string",
                             "pattern": "[A-Z]{2}[0-9]{3}"},
                    "null_or_int": {"anyOf": [{"type": "null"},
                                              {"type": "integer"}]}},
     "required": ["code", "null_or_int"]},
    {"type": "object",
     "properties": {"inner": {"type": "object",
                              "properties": {"v": {"const": "x"}},
                              "required": ["v"]},
                    "xs": {"type": "array",
                           "items": {"type": "integer"},
                           "minItems": 2, "maxItems": 4}},
     "required": ["inner", "xs"]},
]

TOOLS = [{"type": "function", "function": {
    "name": "lookup",
    "parameters": {"type": "object",
                   "properties": {"q": {"type": "string", "maxLength": 6}},
                   "required": ["q"]}}},
    {"type": "function", "function": {
        "name": "add",
        "parameters": {"type": "object",
                       "properties": {"a": {"type": "integer"},
                                      "b": {"type": "integer"}},
                       "required": ["a", "b"]}}}]


def _rf(schema):
    return {"type": "json_schema", "json_schema": {"schema": schema}}


def _autos(response_format=None, tools=None, tool_choice=None, eos_id=None):
    """The same request compiled by the port and by JAX."""
    kw = dict(response_format=response_format, tools=tools,
              tool_choice=tool_choice, eos_id=eos_id)
    return (constrain.compile_request_constraint(vocab=VOCAB_STRS, **kw),
            jax_constrain.compile_request_constraint(
                vocab=jax_constrain.vocab_strings(TOK, VOCAB), **kw))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models' ops run faster on one thread than on a pool that
    the test runner's parallel workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- a canonical form of grammar states --------------------------------------


def _node_index(root) -> tuple[dict, list]:
    """Number the grammar graph's nodes in DFS order (identity-keyed),
    with each node's description: equal lists mean equal grammars."""
    index, desc = {}, []

    def visit(node):
        if id(node) in index:
            return
        index[id(node)] = len(desc)
        name = type(node).__name__
        if name == "Lit":
            desc.append((name, node.text))
        elif name == "Chars":
            desc.append((name, "".join(sorted(node.allowed))))
        elif name == "Rep":
            desc.append((name, node.lo, node.hi))
        else:
            desc.append((name,))
        kids = {"Seq": lambda: node.parts, "Alt": lambda: node.options,
                "Rep": lambda: [node.item] + ([node.sep] if node.sep
                                              else []),
                "Ref": lambda: [node.target]}.get(name, lambda: [])()
        for k in kids:
            visit(k)

    visit(root)
    return index, desc


def _canon(state, index) -> list:
    """A state (a frozenset of NFA positions over nodes) with every node
    replaced by its DFS number: comparable across the two packages."""
    def cont(c):
        if c is None:
            return None
        if c[0] == "n":
            return ("n", index[id(c[1])], cont(c[2]))
        return (c[0], index[id(c[1])], c[2], cont(c[3]))

    out = []
    for pos in state:
        if isinstance(pos, str):
            out.append(("end",))
        elif pos[0] == "lit":
            out.append(("lit", index[id(pos[1])], pos[2], cont(pos[3])))
        else:
            out.append(("chr", index[id(pos[1])], cont(pos[2])))
    return sorted(out, key=repr)


class Canon:
    """Canonical states of one automaton."""

    def __init__(self, auto):
        self.auto = auto
        self.index, self.desc = _node_index(auto.root)

    def __call__(self, state):
        return _canon(state, self.index)


def _cursor_view(cs, canon_by_auto):
    if cs is None:
        return None
    canon = canon_by_auto.get(id(cs.auto))
    if canon is None:
        canon = canon_by_auto[id(cs.auto)] = Canon(cs.auto)
    return (canon(cs.cur), cs.done, cs.violations)


# --- the grammar copy --------------------------------------------------------


def test_regex_membership_and_unsupported_syntax_equal_jax():
    pats = ["ab+(c|d)[0-9]{2}", "[A-Z]{2}[0-9]{3}", "x?y*z", "(ab|cd){1,3}",
            r"\d+\.\d{2}", "[^a-c]"]
    rng = np.random.default_rng(0)
    alphabet = "abcdxyzAZ059.-"
    for pat in pats:
        mine = constrain.TokenAutomaton(constrain.compile_regex(pat),
                                        VOCAB_STRS, eos_id=None)
        theirs = jax_constrain.TokenAutomaton(
            jax_constrain.compile_regex(pat), VOCAB_STRS, eos_id=None)
        for _ in range(60):
            text = "".join(rng.choice(list(alphabet),
                                      size=int(rng.integers(0, 8))))
            got = []
            for auto, mod in ((mine, constrain), (theirs, jax_constrain)):
                cur = auto.start
                for ch in text:
                    cur = auto.step(cur, ord(ch))
                    if cur is None:
                        break
                got.append(None if cur is None else mod.is_accepting(cur))
            assert got[0] == got[1], (pat, text)
    for bad in ("a(", "a[", "*a", "a{2", "a(?=b)", "a{3,1}", "[]"):
        with pytest.raises(jax_constrain.ConstraintError) as je:
            jax_constrain.compile_regex(bad)
        with pytest.raises(constrain.ConstraintError) as pe:
            constrain.compile_regex(bad)
        assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("bad", [
    {"type": "integer", "minimum": 3},
    {"type": "object", "minProperties": 1},
    {"type": "string", "format": "date-time"},
    {"oneOf": [{"type": "integer"}]},
    {"type": "frobnicate"},
    {"type": "array", "items": {"type": "string"}, "uniqueItems": True},
    {"type": "object", "properties": {"a": {"type": "integer"}},
     "required": ["b"]},
    {"enum": []},
])
def test_unsupported_keywords_raise_as_jax(bad):
    with pytest.raises(jax_constrain.ConstraintError) as je:
        jax_constrain.compile_schema(bad)
    with pytest.raises(constrain.ConstraintError) as pe:
        constrain.compile_schema(bad)
    assert str(pe.value) == str(je.value)


def _random_value(rng, depth=0):
    kind = int(rng.integers(0, 8 if depth < 2 else 5))
    if kind == 0:
        return int(rng.integers(-50, 50))
    if kind == 1:
        return float(rng.standard_normal())
    if kind == 2:
        return "".join(rng.choice(list("abcAB09"), int(rng.integers(0, 10))))
    if kind == 3:
        return bool(rng.integers(0, 2))
    if kind == 4:
        return None
    if kind == 5:
        return [_random_value(rng, depth + 1)
                for _ in range(int(rng.integers(0, 5)))]
    keys = ["name", "age", "tags", "ok", "score", "code", "null_or_int",
            "inner", "xs", "v"]
    return {str(k): _random_value(rng, depth + 1)
            for k in rng.choice(keys, int(rng.integers(0, 5)),
                                replace=False)}


def test_validate_instance_equals_jax():
    rng = np.random.default_rng(1)
    values = [_random_value(rng) for _ in range(300)]
    values += [{"name": "x", "age": 3, "tags": ["a"]},
               {"name": "x", "age": 3, "tags": []},
               {"ok": True, "score": 1.5}, {"code": "AB123",
                                            "null_or_int": None},
               {"inner": {"v": "x"}, "xs": [1, 2]}]
    agree = 0
    for schema in FUZZ_SCHEMAS + [{"type": "integer"}, {"enum": ["a", 1]},
                                  {"const": "x"}]:
        for v in values:
            mine = constrain.validate_instance(v, schema)
            assert mine == jax_constrain.validate_instance(v, schema), (
                schema, v)
            agree += mine
    assert agree > 5


WALK_REQUESTS = [dict(response_format=_rf(s)) for s in FUZZ_SCHEMAS] + [
    dict(response_format={"type": "json_object"}),
    dict(tools=TOOLS, tool_choice="required"),
    dict(tools=TOOLS, tool_choice={"type": "function",
                                   "function": {"name": "add"}}),
]


@pytest.mark.parametrize("req", range(len(WALK_REQUESTS)))
def test_automaton_walks_equal_jax(req):
    """Along seeded random walks every state's mask row, transition
    table and accepting flag equal JAX's, byte for byte, and EOS is
    allowed exactly at accepting states."""
    eos = 130
    mine, theirs = _autos(eos_id=eos, **WALK_REQUESTS[req])
    assert mine.kind == theirs.kind
    cm, ct = Canon(mine), Canon(theirs)
    assert cm.desc == ct.desc          # the same grammar graph
    rng = np.random.default_rng(req)
    for _ in range(6):
        a, b = mine.start, theirs.start
        for _ in range(40):
            assert cm(a) == ct(b)
            ma, mb = mine.mask(a), theirs.mask(b)
            assert ma.dtype == mb.dtype == np.float32
            assert ma.tobytes() == mb.tobytes()
            ta, tb = mine._trans[a], theirs._trans[b]
            assert sorted(ta) == sorted(tb)
            for tid in ta:
                assert cm(ta[tid]) == ct(tb[tid])
            acc = constrain.is_accepting(a)
            assert acc == jax_constrain.is_accepting(b)
            assert (ma[eos] == 0.0) == acc
            assert mine.exhausted(a) == theirs.exhausted(b)
            if not ta:
                break
            tid = int(rng.choice(sorted(ta)))
            a, b = ta[tid], tb[tid]
    assert mine.states_compiled == theirs.states_compiled > 0


def test_neg_inf_and_compiler_lru_equal_jax():
    assert constrain.NEG_INF == jax_constrain.NEG_INF
    assert constrain.NEG_INF.dtype == np.float32
    pc = constrain.ConstraintCompiler(max_entries=2)
    jc = jax_constrain.ConstraintCompiler(max_entries=2)
    order = [0, 1, 0, 2, 1, 3, 3, 0]
    for i in order:
        kw = dict(response_format=_rf(FUZZ_SCHEMAS[i]), vocab=VOCAB_STRS,
                  vocab_key=1, eos_id=None)
        a, b = pc.get(**kw), jc.get(**kw)
        assert a.kind == b.kind == "json_schema"
        assert pc.get(**kw) is a       # a hit returns the shared automaton
        assert [k[2] for k in pc._cache] == [k[2] for k in jc._cache]
    assert pc.compiles == jc.compiles == 6
    assert len(pc._cache) == 2
    with pytest.raises(constrain.ConstraintError):
        pc.get(response_format=_rf({"type": "integer", "minimum": 1}),
               vocab=VOCAB_STRS, vocab_key=1, eos_id=None)


# --- the models --------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """The committed HF fixture with ``max_seq_len`` 256 in both packages
    (f32 weights and compute)."""
    jmodel, jparams = load_qwen3(
        FIXTURE, dtype=jnp.float32,
        config_overrides={"compute_dtype": "float32", "max_seq_len": 256})
    cfg = Qwen3Config.from_dict(jmodel.cfg.to_dict())
    pmodel = Qwen3(cfg, device="cpu")
    pmodel.load_state(params_from_jax(jax.tree.map(np.asarray, jparams),
                                      cfg))
    return jmodel, jparams, pmodel


# --- the bodies --------------------------------------------------------------


def _kv(pmodel, seed, rows=4, length=64):
    cfg = pmodel.config
    rng = np.random.default_rng(seed)
    shape = (rows, length, cfg.n_kv_head, cfg.head_dim)
    return [tuple(rng.standard_normal(shape).astype(np.float32)
                  for _ in range(2)) for _ in range(cfg.n_layer)]


def _port_cache(pmodel, kv, index):
    cache = pmodel.init_cache(kv[0][0].shape[0], kv[0][0].shape[1],
                              dtype=torch.float32)
    for layer, (k, v) in zip(cache, kv):
        layer["k"].copy_(torch.from_numpy(k))
        layer["v"].copy_(torch.from_numpy(v))
    return pin_index(cache, torch.from_numpy(index))


def _jax_cache(kv, index):
    return [{"k": jnp.asarray(k), "v": jnp.asarray(v),
             "index": jnp.asarray(index, jnp.int32)} for k, v in kv]


def _assert_kv(cache, jcache, upto):
    for pl, jl in zip(cache, jcache):
        for key in ("k", "v"):
            got, want = pl[key].numpy(), np.asarray(jl[key])
            for s, n in enumerate(upto):
                np.testing.assert_allclose(got[s, :n], want[s, :n],
                                           rtol=KV_TOL, atol=KV_TOL)


def _walk(auto, text):
    cur = auto.start
    for ch in text:
        cur = auto.step(cur, ord(ch))
    return cur


def _row_masks():
    """(4, vocab) masks: the schema's start state, inside the name
    string, a zero (unconstrained) row, and where the age's digits go."""
    auto = constrain.compile_request_constraint(
        response_format=_rf(SCHEMA), vocab=VOCAB_STRS, eos_id=None)
    g = np.zeros((4, VOCAB), np.float32)
    g[0] = auto.mask(auto.start)
    g[1] = auto.mask(_walk(auto, '{"name":"a'))
    g[3] = auto.mask(_walk(auto, '{"name":"a","age":'))
    return auto, g


def test_masked_decode_scan_equals_jax(models):
    jmodel, jparams, pmodel = models
    kv = _kv(pmodel, 0)
    index = np.array([10, 20, 5, 30], np.int64)
    tokens = np.array([3, 40, 77, 9], np.int64)
    _, g = _row_masks()
    greedy = np.ones(4, bool)
    samp = (np.ones(4, np.float32), np.zeros(4, np.int64),
            np.ones(4, np.float32), greedy)
    toks, cache = decode_scan(
        pmodel, _port_cache(pmodel, kv, index), torch.from_numpy(tokens),
        *map(torch.from_numpy, samp), n=1, all_greedy=True,
        gmask=torch.from_numpy(g))
    jfn = jax.jit(jax_decode_scan, static_argnums=0, static_argnames="n")
    jtoks, jcache = jfn(jmodel, jparams, _jax_cache(kv, index),
                        jnp.asarray(tokens, jnp.int32), jax.random.PRNGKey(0),
                        *map(jnp.asarray, samp), n=1, gmask=jnp.asarray(g))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    # the masked argmax: '{' at the start, a digit or '-' for the age
    assert chr(int(toks[0, 0])) == "{"
    assert chr(int(toks[3, 0])) in "-0123456789"
    assert g[1, int(toks[1, 0])] == 0.0
    _assert_kv(cache, jcache, index + 1)
    with pytest.raises(ValueError, match="n=1"):
        decode_scan(pmodel, _port_cache(pmodel, kv, index),
                    torch.from_numpy(tokens), *map(torch.from_numpy, samp),
                    n=2, all_greedy=True, gmask=torch.from_numpy(g))
    with pytest.raises(ValueError, match="n=1"):
        jax_decode_scan(jmodel, jparams, _jax_cache(kv, index),
                        jnp.asarray(tokens, jnp.int32),
                        jax.random.PRNGKey(0), *map(jnp.asarray, samp), n=2,
                        gmask=jnp.asarray(g))


def test_masked_mixed_step_equals_jax(models):
    jmodel, jparams, pmodel = models
    kv = _kv(pmodel, 1)
    chunk = 8
    # row 2 prefills its chunk at 12; the others decode one masked token
    starts = np.array([10, 20, 12, 30], np.int64)
    lens = np.array([0, 0, 5, 0], np.int64)
    advance = np.array([1, 1, 0, 1], np.int64)
    chunk_ids = np.zeros((4, chunk), np.int64)
    chunk_ids[2, :5] = [50, 51, 52, 53, 54]
    tokens = np.array([3, 40, 77, 9], np.int64)
    _, g = _row_masks()
    g[2] = 0.0
    samp = (np.ones(4, np.float32), np.zeros(4, np.int64),
            np.ones(4, np.float32), np.ones(4, bool))
    fn = make_mixed_step(pmodel)
    last, toks, cache = fn(
        _port_cache(pmodel, kv, starts), *map(torch.from_numpy, (
            chunk_ids, starts, lens, advance, tokens)),
        *map(torch.from_numpy, samp), n=1, all_greedy=True,
        gmask=torch.from_numpy(g))
    jfn = jax.jit(jax_make_masked_mixed_step(jmodel), static_argnames="n")
    jlast, jtoks, jcache = jfn(
        jparams, _jax_cache(kv, starts),
        *[jnp.asarray(a, jnp.int32) for a in (chunk_ids, starts, lens,
                                              advance, tokens)],
        jax.random.PRNGKey(0), *map(jnp.asarray, samp), jnp.asarray(g), n=1)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(last[2].numpy(), np.asarray(jlast)[2],
                               rtol=1e-4, atol=1e-4)
    index = cache[0]["index"].numpy()
    np.testing.assert_array_equal(index, np.asarray(jcache[0]["index"]))
    np.testing.assert_array_equal(index, starts + lens + advance)
    _assert_kv(cache, jcache, index)


def test_masked_spec_verify_equals_jax(models):
    """At ``m`` 0: row 0's drafts are forced by the grammar (all
    accepted), row 1 carries a grammar-forbidden third draft (its
    acceptance stops there), row 2 is unconstrained, row 3 masked off."""
    jmodel, jparams, pmodel = models
    kv = _kv(pmodel, 2)
    base = np.array([10, 20, 5, 30], np.int64)
    mask = np.array([1, 1, 1, 0], np.int64)
    auto = constrain.compile_request_constraint(
        response_format=_rf(SCHEMA), vocab=VOCAB_STRS, eos_id=None)
    drafts = ['{"na', '{"X"', None, '{"na']
    tokens = np.zeros((4, K + 1), np.int64)
    tokens[:, 0] = [3, 40, 77, 9]
    rng = np.random.default_rng(3)
    tokens[2, 1:] = rng.integers(0, 128, K)
    gm = np.zeros((4, K + 1, VOCAB), np.float32)
    for r, d in enumerate(drafts):
        if d is None:
            continue
        tokens[r, 1:] = [ord(c) for c in d]
        cur = auto.start
        for j in range(K + 1):          # the engine's staging
            gm[r, j] = auto.mask(cur)
            if j == K:
                break
            cur = auto.step(cur, int(tokens[r, j + 1]))
            if cur is None:
                break
    out, n_acc, extra, cache = spec_verify_block(
        pmodel, _port_cache(pmodel, kv, base), torch.from_numpy(tokens),
        torch.from_numpy(base), torch.from_numpy(mask), m=0,
        gmasks=torch.from_numpy(gm))
    jfn = jax.jit(jax_spec_verify_block, static_argnums=0,
                  static_argnames="m")
    jout, jn_acc, jextra, jcache = jfn(
        jmodel, jparams, _jax_cache(kv, base),
        jnp.asarray(tokens, jnp.int32), jnp.asarray(base),
        jnp.asarray(mask), m=0, gmasks=jnp.asarray(gm))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(jn_acc))
    np.testing.assert_array_equal(extra.numpy(), np.asarray(jextra))
    assert extra.shape == (4, 0)
    assert int(n_acc[0]) == K and int(n_acc[1]) == 2
    assert chr(int(out[1, 2])) == "n"   # the masked bonus, not the 'X'
    index = cache[0]["index"].numpy()
    np.testing.assert_array_equal(index, np.asarray(jcache[0]["index"]))
    np.testing.assert_array_equal(index, base + (n_acc.numpy() + 1) * mask)
    _assert_kv(cache, jcache, index)


# --- the engine in lockstep with JAX ----------------------------------------

SHORT = TOK.encode("name, age, tags: ")
PLAIN = [5, 6, 7, 8] * 3
LONG = [(i * 7 + 3) % 128 for i in range(30)]     # 4 chunks of 8
MASKED_KINDS = {"mdecode", "pmdecode", "mmixed", "pmmixed", "mspec",
                "pmspec"}
ENGINE = dict(max_slots=4, cache_len=128, chunked_prefill=8, decode_steps=2,
              speculative_k=K, mixed_step=True)


@pytest.fixture(scope="module")
def engine_pairs(models):
    """One port engine and one JAX engine per layout, each with the
    target as its own draft (the ngram and spec-off cases switch it off),
    built at first use."""
    jmodel, jparams, pmodel = models
    pairs = {}

    def get(layout):
        if layout not in pairs:
            kw = dict(ENGINE)
            if layout == "paged":
                kw.update(kv_layout="paged", kv_page_size=PAGE)
            port = InferenceEngine(pmodel, cache_dtype=torch.float32,
                                   draft_model=pmodel, **kw)
            jeng = JaxEngine(jmodel, jparams, cache_dtype=jnp.float32,
                             draft_model=jmodel, draft_params=jparams, **kw)
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


def _watermarks(eng) -> np.ndarray:
    valid = np.zeros((eng.max_slots,), np.int64)
    for s, req in enumerate(eng.slot_req):
        if req is not None and eng.slot_ready[s]:
            valid[s] = eng.slot_len[s]
    for s, st in eng.slot_prefill.items():
        valid[s] = st["done"]
    return valid


def _kv_rows(eng, slot, valid):
    if eng.paged is not None:
        bt = eng.paged.block_tables
        t = np.arange(valid)
        rows = bt[slot, t // PAGE] * PAGE + t % PAGE
        return [tuple(np.asarray(layer[key])[rows] for key in ("k", "v"))
                for layer in eng.paged.kv]
    return [tuple(np.asarray(layer[key])[slot, :valid]
                  for key in ("k", "v")) for layer in eng.cache]


def _assert_same_state(port, jeng, where, canon):
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
        assert _cursor_view(port.slot_constraint[s], canon) == \
            _cursor_view(jeng.slot_constraint[s], canon), (where, s)
    for c in ("spec_grammar_rejects", "spec_rounds", "spec_proposed",
              "spec_accepted"):
        assert getattr(port, c) == getattr(jeng, c), (where, c)
    if port.paged is not None:
        np.testing.assert_array_equal(port.paged.block_tables,
                                      jeng.paged.block_tables, err_msg=where)
    for s in range(port.max_slots):
        for got, want in zip(_kv_rows(port, s, valid[s]),
                             _kv_rows(jeng, s, valid[s])):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=KV_TOL, atol=KV_TOL,
                                           err_msg=f"{where}: slot {s}")


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("proposer", ["off", "ngram", "self"])
def test_lockstep_matches_jax_engine(engine_pairs, layout, proposer):
    """A constrained greedy request beside a plain one, then a prompt
    chunk-prefilling (the fused mixed step's masked twin runs)."""
    pa, ja = _autos(response_format=_rf(SCHEMA))
    canon = {}
    kinds = []
    with _configured(engine_pairs(layout), proposer) as (port, jeng):
        rejects0, rounds0 = port.spec_grammar_rejects, port.spec_rounds
        mixed0 = port.mixed_blocks
        run = port.graphs.run

        def spy(kind, n, **kw):
            masked = "gmask" in kw or "gmasks" in kw
            kinds.append((kind, n, masked,
                          port._constrained_active(port._ready_slots())))
            return run(kind, n, **kw)

        port.graphs.run = spy
        hp = [port.submit(SHORT, SamplingParams(greedy=True, max_tokens=100,
                                                constraint=pa)),
              port.submit(PLAIN, SamplingParams(greedy=True, max_tokens=40))]
        hj = [jeng.submit(SHORT, JaxParams(greedy=True, max_tokens=100,
                                           constraint=ja)),
              jeng.submit(PLAIN, JaxParams(greedy=True, max_tokens=40))]
        assert port.step() and jeng.step()
        hp.append(port.submit(LONG, SamplingParams(greedy=True,
                                                   max_tokens=8)))
        hj.append(jeng.submit(LONG, JaxParams(greedy=True, max_tokens=8)))
        _assert_same_state(port, jeng, "after the first step", canon)
        steady = []
        for i in itertools.count():
            assert i < 200, "the load never drained"
            rolls = port.draft_rolls_run + port.draft_chunks_run
            busy = port.step()
            assert busy == jeng.step(), f"step {i}"
            _assert_same_state(port, jeng, f"step {i}", canon)
            if not busy:
                break
            if (not port.slot_prefill and port.slot_constraint[0] is not None
                    and port.slot_ready[0]):
                steady.append(port.last_step_dispatches
                              - (port.draft_rolls_run
                                 + port.draft_chunks_run - rolls))
        outs = [r.result() for r in hp]
        assert outs == [r.result() for r in hj]
        assert [r.finish_reason for r in hp] == \
            [r.finish_reason for r in hj]
        assert hp[0].finish_reason == "stop"
        value = json.loads(TOK.decode(outs[0]))
        assert constrain.validate_instance(value, SCHEMA), value
        assert hp[0].constraint_state.violations == 0
        assert hp[1].finish_reason == "length" and len(outs[1]) == 40
        # a steady step with a constrained slot: one target dispatch
        assert steady and set(steady) == {1}, steady
        assert port.grammar_mask_seconds_total > 0
        if proposer != "off":
            assert port.spec_rounds > rounds0
        if proposer == "self":
            # the target's unmasked drafts break the grammar somewhere
            assert port.spec_grammar_rejects > rejects0
        if port.paged is not None:
            port.paged.pool.check_leaks(0)
            jeng.paged.pool.check_leaks(0)
        del port.graphs.run
        assert all(s is None for s in port.slot_constraint)
    # the masked kinds ran, at n 1 (m 0), exactly while a ready slot was
    # constrained, each with its mask; the fused step's twin among them
    assert port.mixed_blocks > mixed0
    pre = "p" if layout == "paged" else ""
    ran = {k for k, _, _, _ in kinds}
    assert {pre + "mdecode", pre + "mmixed"} <= ran or \
        {pre + "mspec", pre + "mmixed"} <= ran, ran
    if proposer != "off":
        assert pre + "mspec" in ran, ran
    for kind, n, masked, constrained in kinds:
        if kind == "droll":
            continue
        assert masked == constrained == (kind in MASKED_KINDS), kind
        if masked:
            assert n == (0 if kind.endswith("spec") else 1), (kind, n)


# --- conformance, json_object, preemption ------------------------------------


@pytest.fixture
def plain_jax_engine(engine_pairs):
    """The contiguous JAX engine of the lockstep cases, speculation off
    (its programs are compiled already)."""
    with _configured(engine_pairs("contiguous"), "off") as (_, jeng):
        yield jeng


@pytest.mark.parametrize("schema", range(len(FUZZ_SCHEMAS)))
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_schema_conformance_fuzz(models, plain_jax_engine, schema,
                                 temperature):
    """Every completion, greedy and sampled over several seeds, parses
    and validates with no violation; greedy ones equal JAX's tokens."""
    _, _, pmodel = models
    sch = FUZZ_SCHEMAS[schema]
    pa, ja = _autos(response_format=_rf(sch))
    for seed in (0, 1, 2):
        eng = InferenceEngine(pmodel, max_slots=4, cache_len=128, seed=seed,
                              cache_dtype=torch.float32)
        sp = SamplingParams(greedy=temperature == 0.0,
                            temperature=max(temperature, 1e-6),
                            max_tokens=200, constraint=pa)
        req = eng.submit(SHORT, sp)
        while eng.step():
            pass
        out = req.result()
        assert req.finish_reason == "stop", TOK.decode(out)
        value = json.loads(TOK.decode(out))
        assert constrain.validate_instance(value, sch), TOK.decode(out)
        assert req.constraint_state.violations == 0
        if temperature == 0.0:
            jout = plain_jax_engine.generate(SHORT, JaxParams(
                greedy=True, max_tokens=200, constraint=ja))
            assert out == jout
            break                   # greedy does not depend on the seed


def test_json_object_mode(models, plain_jax_engine):
    _, _, pmodel = models
    pa, ja = _autos(response_format={"type": "json_object"})
    assert pa.kind == "json_object"
    eng = InferenceEngine(pmodel, max_slots=4, cache_len=128,
                          cache_dtype=torch.float32)
    prompt = TOK.encode("an object: ")
    out = eng.generate(prompt, SamplingParams(greedy=True, max_tokens=200,
                                              constraint=pa))
    assert isinstance(json.loads(TOK.decode(out)), dict)
    assert out == plain_jax_engine.generate(prompt, JaxParams(
        greedy=True, max_tokens=200, constraint=ja))


def test_contiguous_prefix_hit_samples_under_its_own_grammar(
        models, plain_jax_engine):
    """A constrained request's prompt stored in the contiguous prefix
    cache keeps unmasked logits: a later full hit on the same prompt,
    plain or under another schema, equals a cold engine's stream and
    JAX's."""
    _, _, pmodel = models
    kw = dict(max_slots=4, cache_len=128, cache_dtype=torch.float32)
    warm = InferenceEngine(pmodel, prefix_cache=True, **kw)
    cold = InferenceEngine(pmodel, **kw)
    cases = [(_autos(response_format=_rf(SCHEMA)), 200),
             ((None, None), 12),
             (_autos(response_format=_rf(FUZZ_SCHEMAS[1])), 200)]
    for (pa, ja), max_tokens in cases:
        sp = SamplingParams(greedy=True, max_tokens=max_tokens, constraint=pa)
        out = warm.generate(SHORT, sp)
        assert out == cold.generate(SHORT, sp) == plain_jax_engine.generate(
            SHORT, JaxParams(greedy=True, max_tokens=max_tokens,
                             constraint=ja))
    assert warm.prefix_cache.full_hits == 2


def test_preempt_resume_under_grammar_equals_free_pool_and_jax(
        models, plain_jax_engine):
    """A pool sized to preempt while grammars are active: every resumed
    stream equals the free pool's and the JAX engine's, and validates
    (the cursor rides the request through the requeue)."""
    _, _, pmodel = models
    pa, ja = _autos(response_format=_rf(SCHEMA))
    prompts = [TOK.encode(f"request {j} wants json: ") for j in range(3)]
    kw = dict(max_slots=4, cache_len=128, kv_layout="paged",
              kv_page_size=PAGE, prefix_cache=True)
    tight = InferenceEngine(pmodel, cache_dtype=torch.float32,
                            kv_pool_tokens=120, **kw)
    sp = SamplingParams(greedy=True, max_tokens=80, constraint=pa)
    hs = [tight.submit(p, sp) for p in prompts]
    while tight.step():
        pass
    assert tight.preemptions > 0
    free = InferenceEngine(pmodel, cache_dtype=torch.float32,
                           **dict(kw, prefix_cache=False))
    for p, h in zip(prompts, hs):
        assert h.finish_reason == "stop"
        out = h.result()
        assert out == free.generate(p, sp) == plain_jax_engine.generate(
            p, JaxParams(greedy=True, max_tokens=80, constraint=ja))
        assert constrain.validate_instance(json.loads(TOK.decode(out)),
                                           SCHEMA)
        assert h.constraint_state.violations == 0
    tight.prefix_cache.clear()
    tight.paged.pool.check_leaks(0)


# --- the API -----------------------------------------------------------------


@pytest.fixture(scope="module")
def server(models):
    _, _, pmodel = models
    engine = InferenceEngine(pmodel, max_slots=2, cache_len=256,
                             cache_dtype=torch.float32)
    srv = OpenAIServer(engine, TOK, model_name="structured-test")
    port = srv.serve(host="127.0.0.1", port=0, background=True)
    try:
        yield srv, f"http://127.0.0.1:{port}"
    finally:
        srv.shutdown()


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _chat(**extra):
    return {"model": "structured-test",
            "messages": [{"role": "user", "content": "json please"}],
            "max_tokens": 120, "temperature": 0.0, **extra}


def _stream_text(raw):
    lines = [ln for ln in raw.decode().split("\n") if ln.startswith("data: ")]
    assert lines[-1] == "data: [DONE]"
    events = [json.loads(ln[len("data: "):]) for ln in lines[:-1]]
    text = "".join(e["choices"][0]["delta"].get("content", "")
                   for e in events)
    return text, events[-1]["choices"][0]["finish_reason"]


def test_api_json_schema_round_trip_streamed_and_not(server):
    srv, base = server
    status, raw = _post(base + "/v1/chat/completions",
                        _chat(response_format=_rf(SCHEMA)))
    assert status == 200, raw
    choice = json.loads(raw)["choices"][0]
    assert choice["finish_reason"] == "stop"
    content = choice["message"]["content"]
    assert constrain.validate_instance(json.loads(content), SCHEMA)
    status, raw = _post(base + "/v1/chat/completions",
                        _chat(response_format=_rf(SCHEMA), stream=True))
    assert status == 200
    text, finish = _stream_text(raw)
    assert (text, finish) == (content, "stop")


@pytest.mark.parametrize("choice", [
    {"type": "function", "function": {"name": "lookup"}}, "required"])
def test_api_tool_choice_gives_tool_calls(server, choice):
    _, base = server
    status, raw = _post(base + "/v1/chat/completions",
                        _chat(tools=TOOLS, tool_choice=choice))
    assert status == 200, raw
    out = json.loads(raw)["choices"][0]
    assert out["finish_reason"] == "tool_calls"
    assert out["message"]["content"] is None
    (call,) = out["message"]["tool_calls"]
    assert call["type"] == "function" and call["id"].startswith("call_")
    name = call["function"]["name"]
    args = json.loads(call["function"]["arguments"])
    params = {t["function"]["name"]: t["function"]["parameters"]
              for t in TOOLS}
    if isinstance(choice, dict):
        assert name == "lookup"
    assert constrain.validate_instance(args, params[name])


def test_api_tools_with_auto_is_served_unconstrained(server):
    _, base = server
    status, raw = _post(base + "/v1/chat/completions",
                        _chat(tools=TOOLS, tool_choice="auto",
                              max_tokens=12))
    assert status == 200, raw
    _, plain = _post(base + "/v1/chat/completions", _chat(max_tokens=12))
    assert json.loads(raw)["choices"] == json.loads(plain)["choices"]


def test_api_422_and_structured_counts(server):
    srv, base = server
    before = dict(srv.structured_counts)
    status, raw = _post(base + "/v1/chat/completions", _chat(
        response_format=_rf({"type": "integer", "minimum": 2})))
    assert status == 422
    assert json.loads(raw)["error"]["code"] == "invalid_constraint"
    for bad in ({"response_format": {"type": "yaml"}},
                {"response_format": {"type": "json_schema"}},
                {"tools": {"name": "f"}},
                {"tool_choice": "required"},
                {"tools": TOOLS, "tool_choice": 3}):
        status, raw = _post(base + "/v1/chat/completions", _chat(**bad))
        assert status == 422, bad
        assert "code" not in json.loads(raw)["error"]
    status, raw = _post(base + "/v1/chat/completions", _chat(
        tools=TOOLS, tool_choice={"type": "function",
                                  "function": {"name": "nope"}}))
    assert status == 422
    assert json.loads(raw)["error"]["code"] == "invalid_constraint"
    status, _ = _post(base + "/v1/chat/completions", _chat(
        response_format={"type": "json_schema",
                         "json_schema": {"schema": FUZZ_SCHEMAS[1]}},
        max_tokens=60))
    assert status == 200
    after = srv.structured_counts
    assert after["json_schema"] == before["json_schema"] + 1
    assert after["json_object"] == before["json_object"]
    assert srv.constraints.compiles >= 1 and srv.vocab_seconds > 0


# --- arrivals ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_arrivals_equal_jax(seed):
    kw = dict(seed=seed, n_requests=64, mean_iat_s=0.02, cv=2.0,
              prompt_tokens=(8, 48), max_tokens=(72, 128))
    mine, theirs = arrivals.synthesize(**kw), jax_arrivals.synthesize(**kw)
    assert [dataclasses.astuple(a) for a in mine] == \
        [dataclasses.astuple(a) for a in theirs]
    assert arrivals.describe(mine) == jax_arrivals.describe(theirs)
    for cv, iat in ((0.0, 0.01), (1.0, 0.0), (1.0, 0.05)):
        kw2 = dict(kw, cv=cv, mean_iat_s=iat)
        assert [dataclasses.astuple(a) for a in arrivals.synthesize(**kw2)] \
            == [dataclasses.astuple(a)
                for a in jax_arrivals.synthesize(**kw2)]
    skw = dict(seed=seed, n_sessions=6, adapters=["a", "b"])
    ms, ts = (arrivals.synthesize_sessions(**skw),
              jax_arrivals.synthesize_sessions(**skw))
    assert [dataclasses.astuple(a) for a in ms] == \
        [dataclasses.astuple(a) for a in ts]
    assert arrivals.describe_sessions(ms) == \
        jax_arrivals.describe_sessions(ts)
    late = list(np.random.default_rng(seed).uniform(0, 0.1, 20))
    assert arrivals.lateness_stats(late) == jax_arrivals.lateness_stats(late)
    with pytest.raises(ValueError):
        arrivals.synthesize(seed=seed, n_requests=0, mean_iat_s=0.1)


def test_arrival_replay_order_and_lateness():
    sched = arrivals.synthesize(seed=3, n_requests=40, mean_iat_s=0.001)
    late = []
    got = arrivals.replay(sched, lambda a: a.prompt_tokens, workers=4,
                          lateness=late)
    assert got == [a.prompt_tokens for a in sched]
    assert len(late) == 40 and min(late) >= 0.0
