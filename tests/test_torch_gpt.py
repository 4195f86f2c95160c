"""PyTorch port: the GPT family (``models/gpt.py``, the blocks of
``models/layers.py``), A10's dense attention arguments
(``ops/attention.py``), ``sinusoidal_embeddings`` and the interleaved
RoPE (``ops/rope.py``), ``data/chardata.py`` and the remat repair,
against the JAX package.

Weights are drawn from a numpy seed in the flax tree's shapes and
carried across with ``gpt_params_from_jax``; everything runs in f32.

- The forward equals JAX ``GPT.apply`` at 1e-5 over learned / sinusoidal
  / rope positions x pre-LN / post-LN x tied / untied heads; a cached
  prefill plus decode equals the uncached forward and JAX's cached
  forward; ``return_hidden`` plus ``head`` equals the logits.
- ``dense_attention`` with ``causal=False``, a bias, ``kv_length`` and
  ``scale`` equals JAX's at 1e-6; ``pick_impl``'s dispatch table; the
  dropout law (binomial keep fraction, ``1 / (1 - p)`` scaling, ``p = 0``
  the identity).
- ``char_lm_examples`` equals JAX's array for array.
- Gradients of ``apply(state, x)`` under ``remat=True`` equal those of
  ``remat=False`` and JAX's, for Qwen3 and the GPT, at 1e-5; a dropout
  generator is replayed for the recompute.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_in_practise_tpu.data.chardata import char_lm_examples as jax_char
from llm_in_practise_tpu.models.gpt import GPT as JaxGPT
from llm_in_practise_tpu.models.gpt import GPTConfig as JaxGPTConfig
from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.ops.attention import dense_attention as jax_dense
from llm_in_practise_tpu.ops.rope import sinusoidal_embeddings as jax_sinus

from llm_in_practise_tpu_torch.data.chardata import char_lm_examples
from llm_in_practise_tpu_torch.models import layers
from llm_in_practise_tpu_torch.models.convert import (
    gpt_params_from_jax,
    gpt_params_to_jax,
    params_from_jax,
)
from llm_in_practise_tpu_torch.models.gpt import (
    GPT,
    GPTConfig,
    gptlike_config,
    minigpt_config,
    minigpt_v1_config,
)
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
from llm_in_practise_tpu_torch.ops import attention
from llm_in_practise_tpu_torch.ops.rope import sinusoidal_embeddings

from torch_port_util import numpy_params

VOCAB = 61
TINY = dict(vocab_size=VOCAB, seq_len=32, n_layer=2, n_head=2, embed_dim=32,
            dropout=0.1)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_gpt(seed: int = 0, **kw):
    """A JAX GPT, its numpy-seeded params, and the port's GPT on the CPU
    carrying the same weights."""
    d = {**TINY, **kw}
    jm = JaxGPT(JaxGPTConfig(**d))
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if name.endswith("scale"):
            v = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            v = 0.2 * rng.standard_normal(leaf.shape)
        return v.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)["params"]
    cfg = GPTConfig(**d)
    pm = GPT(cfg, device="cpu")
    pm.load_state(gpt_params_from_jax(params, cfg))
    return jm, params, pm


def ids(shape, seed=1):
    return np.random.default_rng(seed).integers(0, VOCAB, shape)


@pytest.mark.parametrize("pos,norm_first,tie", list(itertools.product(
    ["learned", "sinusoidal", "rope"], [True, False], [True, False])))
def test_forward_matches_jax(pos, norm_first, tie):
    jm, params, pm = seeded_gpt(pos_embedding=pos, norm_first=norm_first,
                                tie_weights=tie)
    x = ids((2, 16))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the functional call over the same state gives the same logits
    state = dict(pm.named_parameters())
    torch.testing.assert_close(
        GPT(pm.cfg, device="meta").apply(state, torch.from_numpy(x)),
        torch.from_numpy(got), rtol=0, atol=0)


@pytest.mark.parametrize("pos", ["learned", "rope"])
def test_cached_prefill_and_decode_match_uncached_and_jax(pos):
    jm, params, pm = seeded_gpt(seed=3, pos_embedding=pos)
    x = ids((2, 12), seed=4)
    full = pm(torch.from_numpy(x)).numpy()
    cache = pm.init_cache(2, 32, dtype=torch.float32)
    pre, cache = pm(torch.from_numpy(x[:, :8]), cache=cache)
    steps = [pre.numpy()]
    for t in range(8, 12):
        lg, cache = pm(torch.from_numpy(x[:, t:t + 1]), cache=cache)
        steps.append(lg.numpy())
    cached = np.concatenate(steps, axis=1)
    np.testing.assert_allclose(cached, full, rtol=1e-5, atol=1e-5)
    assert cache[0]["index"] == 12
    jcache = jm.init_cache(2, 32, dtype=jnp.float32)
    jpre, jcache = jm.apply({"params": params}, jnp.asarray(x[:, :8]),
                            cache=jcache)
    np.testing.assert_allclose(steps[0], np.asarray(jpre), rtol=1e-5,
                               atol=1e-5)
    for i, t in enumerate(range(8, 12)):
        jl, jcache = jm.apply({"params": params}, jnp.asarray(x[:, t:t + 1]),
                              cache=jcache)
        np.testing.assert_allclose(steps[i + 1], np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
    # continuous batching: a (B,) index vector puts each row at its depth
    cache = pm.init_cache(2, 32, dtype=torch.float32)
    for layer in cache:
        layer["index"] = torch.tensor([0, 0])
    _, cache = pm(torch.from_numpy(x[:, :8]), cache=cache)
    lg, _ = pm(torch.from_numpy(x[:, 8:9]), cache=cache)
    np.testing.assert_allclose(lg.numpy(), full[:, 8:9], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("tie", [True, False])
def test_return_hidden_then_head_is_the_logits(tie):
    jm, params, pm = seeded_gpt(seed=5, tie_weights=tie)
    x = torch.from_numpy(ids((2, 8)))
    hidden = pm(x, return_hidden=True)
    want_h = np.asarray(jm.apply({"params": params}, jnp.asarray(x.numpy()),
                                 return_hidden=True))
    np.testing.assert_allclose(hidden.numpy(), want_h, rtol=1e-5, atol=1e-5)
    assert hidden.dtype == torch.float32
    logits = pm.head(hidden)
    torch.testing.assert_close(logits, pm(x), rtol=0, atol=0)
    if not tie:   # the untied head carries its bias
        bias = pm.lm_head.bias
        torch.testing.assert_close(
            logits, hidden @ pm.lm_head.kernel + bias, rtol=1e-6, atol=1e-6)


def test_converters_round_trip_the_flax_tree():
    _, params, pm = seeded_gpt(seed=6, tie_weights=False)
    tree = gpt_params_to_jax(dict(pm.named_parameters()), pm.cfg)
    assert sorted(jax.tree_util.tree_structure(params).node_data()[1]) == \
        sorted(tree)
    back = jax.tree_util.tree_leaves_with_path(params)
    for path, leaf in back:
        node = tree
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.detach().numpy(), leaf)
    with pytest.raises(ValueError, match="does not match"):
        gpt_params_from_jax({**params, "extra": np.zeros(2)}, pm.cfg)


def test_presets_and_config_dict():
    assert minigpt_config(65).to_dict() == JaxGPT(
        JaxGPTConfig(vocab_size=65, seq_len=256, n_layer=4, n_head=4,
                     embed_dim=128, norm_first=False)).config.to_dict()
    g = gptlike_config(800, seq_len=64, n_layer=2, embed_dim=128, n_head=4,
                       dropout=0.0)
    assert (g.n_layer, g.embed_dim, g.head_dim, g.tie_weights,
            g.norm_first) == (2, 128, 32, True, True)
    assert minigpt_v1_config(10).head_dim == 32
    assert GPTConfig.from_dict({**g.to_dict(), "unknown": 1}) == g
    assert g.replace(n_layer=6).n_layer == 6


def test_sinusoidal_table_matches_jax():
    np.testing.assert_allclose(sinusoidal_embeddings(256, 64).numpy(),
                               np.asarray(jax_sinus(256, 64)), rtol=0,
                               atol=2e-6)


# --- A10: the dense attention arguments ---------------------------------------


def _qkv(b, lq, lk, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, lq, h, d), (b, lk, h, d), (b, lk, h, d))]


@pytest.mark.parametrize("case", ["noncausal", "bias", "kv_length", "scale",
                                  "offset_vector", "all"])
def test_dense_attention_arguments_match_jax(case):
    q, k, v = _qkv(2, 5, 9, 3, 8, seed=11)
    rng = np.random.default_rng(12)
    kw = {}
    if case in ("noncausal", "all"):
        kw["causal"] = False
    if case in ("bias", "all"):
        kw["bias"] = rng.standard_normal((2, 3, 5, 9)).astype(np.float32)
    if case in ("kv_length", "all"):
        kw["kv_length"] = np.array([4, 9], np.int32)
    if case in ("scale", "all"):
        kw["scale"] = 0.7
    if case == "offset_vector":
        kw["q_offset"] = np.array([2, 4], np.int32)
    want = np.asarray(jax_dense(*map(jnp.asarray, (q, k, v)), **{
        n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
        for n, a in kw.items()}))
    got = attention.dense_attention(*map(torch.from_numpy, (q, k, v)), **{
        n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
        for n, a in kw.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the entry point takes the same arguments (dense on the CPU)
    got2 = attention.dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), **{
            n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
            for n, a in kw.items()}).numpy()
    np.testing.assert_array_equal(got2, got)


def test_grouped_attention_refuses_a_bias():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 4, 4, 8, seed=1))
    with pytest.raises(ValueError, match="no bias"):
        attention.dense_attention(q, k[:, :, :2], v[:, :, :2],
                                  bias=torch.zeros(1, 4, 4, 4))


class _OnCuda:
    """A stand-in with a CUDA device for the dispatch rule (nothing
    launches)."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda", 0)


# (dtype, head_dim, kwargs, q_offset, expected)
PICK_TABLE = [
    (torch.bfloat16, 64, {}, None, "flash"),
    (torch.bfloat16, 128, {}, None, "flash"),
    (torch.bfloat16, 32, {}, None, "dense"),     # minigpt / hermetic heads
    (torch.float32, 64, {}, None, "dense"),      # the GPT's f32 default
    (torch.float16, 128, {}, None, "dense"),
    (torch.bfloat16, 64, {}, 3, "dense"),        # cached
    (torch.bfloat16, 64, {"causal": False}, None, "dense"),
    (torch.bfloat16, 64, {"bias": 0}, None, "dense"),
    (torch.bfloat16, 64, {"kv_length": 0}, None, "dense"),
    (torch.bfloat16, 64, {"dropout_rate": 0.1}, None, "dense"),
    (torch.bfloat16, 64, {"dropout_rate": 0.0}, None, "flash"),
]


@pytest.mark.parametrize("dtype,head_dim,kw,q_offset,want", PICK_TABLE)
def test_pick_impl_table(dtype, head_dim, kw, q_offset, want):
    q = _OnCuda((2, 16, 8, head_dim), dtype)
    k = _OnCuda((2, 16, 8, head_dim), dtype)
    assert attention.pick_impl(q, k, q_offset, **kw) == want
    # the CPU is always dense
    qc = torch.zeros((2, 16, 8, head_dim), dtype=dtype)
    assert attention.pick_impl(qc, qc, q_offset, **kw) == "dense"


def test_dropout_law():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    p = 0.3
    y = layers.dropout(x, p, deterministic=False, generator=g)
    kept = (y != 0).float()
    n = x.numel()
    frac = float(kept.mean())
    # six standard deviations of a binomial keep count
    assert abs(frac - (1 - p)) <= 6 * np.sqrt(p * (1 - p) / n)
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0],
                                                          1 / (1 - p)))
    assert layers.dropout(x, 0.0, deterministic=False, generator=g) is x
    assert layers.dropout(x, p, deterministic=True, generator=g) is x
    assert float(layers.dropout(x, 1.0, deterministic=False).abs().sum()) == 0
    # the same seed draws the same mask; attention dropout follows the law
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    torch.testing.assert_close(
        layers.dropout(x[:100], p, deterministic=False, generator=g1),
        layers.dropout(x[:100], p, deterministic=False, generator=g2))
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 64, 2, 8, seed=3))
    ones = torch.ones_like(v)
    out = attention.dense_attention(q, k, ones, dropout_rate=0.5,
                                    generator=torch.Generator().manual_seed(1))
    base = attention.dense_attention(q, k, ones)
    # rows of probabilities sum to 1; dropout keeps the expectation
    assert abs(float(out.mean()) - float(base.mean())) < 0.05
    # a GPT in training mode with dropout 0 is the deterministic forward
    _, _, pm = seeded_gpt(seed=8, dropout=0.0)
    xi = torch.from_numpy(ids((2, 8)))
    torch.testing.assert_close(
        pm(xi, deterministic=False, generator=torch.Generator()), pm(xi),
        rtol=0, atol=0)


def test_char_lm_examples_match_jax():
    for text, seq, rep in (("hello world, hello tpu", 5, 1), ("ab", 8, 3),
                           ("TPUs are matrix machines. " * 4, 64, 1)):
        x, y, tok = char_lm_examples(text, seq, repeat=rep)
        jx, jy, jtok = jax_char(text, seq, repeat=rep)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert x.dtype == jx.dtype and tok.stoi == jtok.stoi
        assert tok.decode(tok.encode(text)) == text
        assert type(tok).from_dict(tok.to_dict()).stoi == tok.stoi
    with pytest.raises(ValueError, match="outside vocab"):
        tok.encode("~")


# --- the remat repair ---------------------------------------------------------


def _grads(model, state, x, y):
    s = {n: t.clone().requires_grad_(True) for n, t in state.items()}
    logits = model.apply(s, x)
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), y.reshape(-1))
    return loss.detach(), dict(zip(s, torch.autograd.grad(loss,
                                                          list(s.values()))))


def _jax_grads(jm, params, x, y):
    def loss_fn(p):
        logits = jm.apply({"params": p}, x)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.take_along_axis(logp, y[..., None], -1)[..., 0].mean()
    return jax.jit(jax.value_and_grad(loss_fn))(params)


@pytest.mark.parametrize("family", ["gpt", "qwen3"])
def test_remat_under_apply_matches_no_remat_and_jax(family):
    x = ids((2, 16), seed=9)
    y = np.roll(x, -1, axis=1)
    if family == "gpt":
        jm, params, pm = seeded_gpt(seed=10, dropout=0.0,
                                    pos_embedding="rope")
        cfg, make = pm.cfg, GPT
        state = gpt_params_from_jax(params, cfg)
        to_port = lambda tree: gpt_params_from_jax(tree, cfg)  # noqa: E731
    else:
        from llm_in_practise_tpu.models.qwen3 import qwen3_config as jcfg

        jm = JaxQwen3(jcfg(vocab_size=VOCAB, n_layer=2,
                           compute_dtype="float32"))
        params = numpy_params(jm, seed=10)
        cfg = Qwen3Config.from_dict(jm.cfg.to_dict())
        make = Qwen3
        state = params_from_jax(params, cfg)
        to_port = lambda tree: params_from_jax(tree, cfg)  # noqa: E731
    xt, yt = torch.from_numpy(x).long(), torch.from_numpy(y).long()
    loss0, g0 = _grads(make(cfg, device="meta"), state, xt, yt)
    loss1, g1 = _grads(make(cfg.replace(remat=True), device="meta"), state,
                       xt, yt)
    torch.testing.assert_close(loss1, loss0, rtol=0, atol=0)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=0)
    jloss, jg = _jax_grads(jm, params, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(float(loss1), float(jloss), rtol=1e-5)
    jg = to_port(jax.tree.map(np.asarray, jg))
    for n in g1:
        np.testing.assert_allclose(g1[n].numpy(), jg[n], rtol=1e-5,
                                   atol=1e-5, err_msg=n)


def test_remat_replays_the_dropout_masks():
    _, params, _ = seeded_gpt(seed=12, dropout=0.3)
    x = torch.from_numpy(ids((2, 16), seed=13)).long()
    y = torch.roll(x, -1, 1)
    out = []
    for remat in (False, True):
        cfg = GPTConfig(**{**TINY, "dropout": 0.3, "remat": remat})
        gen = torch.Generator().manual_seed(5)
        state = {n: t.requires_grad_(True) for n, t in
                 gpt_params_from_jax(params, cfg).items()}
        logits = GPT(cfg, device="meta").apply(
            state, x, deterministic=False, generator=gen)
        loss = torch.nn.functional.cross_entropy(logits.reshape(-1, VOCAB),
                                                 y.reshape(-1))
        grads = torch.autograd.grad(loss, list(state.values()))
        out.append((loss.detach(), grads, gen.get_state()))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    # the generator ends where the plain forward leaves it
    assert torch.equal(out[0][2], out[1][2])
