"""PyTorch port: the PPL gate and the eval step against JAX's.

The HF fixture in f32 through both packages, the same numpy-seeded id
sequences: ``make_batches`` gives equal arrays; ``evaluate_ppl`` (the
reference's mean of per-sample PPLs), ``compare_quantized`` (fp against
an int8-dequantized tree), ``make_eval_step`` and ``perplexity`` agree
within 1e-5 relative, token counts and verdicts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from llm_in_practise_tpu.quant import int8 as jax_int8
from llm_in_practise_tpu.quant import ppl as jax_ppl
from llm_in_practise_tpu.quant.awq import dequantize_tree as jax_dequantize
from llm_in_practise_tpu.train import losses as jax_losses
from llm_in_practise_tpu.train.step import make_eval_step as jax_eval_step
from llm_in_practise_tpu_torch.models.convert import params_from_jax
from llm_in_practise_tpu_torch.quant import int8, ppl
from llm_in_practise_tpu_torch.quant.awq import dequantize_tree
from llm_in_practise_tpu_torch.train import losses
from llm_in_practise_tpu_torch.train.step import TrainState, make_eval_step

from torch_port_util import load_fixture_both

REL = 1e-5


@pytest.fixture(scope="module")
def fixture():
    jmodel, jparams, pmodel = load_fixture_both()
    state = dict(pmodel.named_parameters())
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 160, n).tolist()
            for n in (1, 9, 40, 2, 17, 33, 64, 70, 12, 5, 3)]
    japply = jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                               deterministic=True))
    return jmodel, jparams, pmodel, state, seqs, japply


def test_make_batches_equal(fixture):
    seqs = fixture[4]
    for bs, max_len in ((4, 48), (8, 512), (3, 8)):
        got = ppl.make_batches(seqs, batch_size=bs, max_len=max_len)
        want = jax_ppl.make_batches(seqs, batch_size=bs, max_len=max_len)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ppl.make_batches(seqs, batch_size=4, device="cpu")[0][0].dtype \
        == torch.int64


def _reports_equal(got, want):
    np.testing.assert_allclose(got.per_sample_ppl, want.per_sample_ppl,
                               rtol=REL)
    np.testing.assert_allclose(got.mean_ppl, want.mean_ppl, rtol=REL)
    assert got.n_tokens == want.n_tokens
    assert got.passed == want.passed and got.threshold == want.threshold


@pytest.mark.parametrize("threshold", [9.0, 1e4])
def test_evaluate_ppl_matches_jax(fixture, threshold):
    _, jparams, pmodel, state, seqs, japply = fixture
    jb = jax_ppl.make_batches(seqs, batch_size=4, max_len=48)
    pb = ppl.make_batches(seqs, batch_size=4, max_len=48)
    want = jax_ppl.evaluate_ppl(japply, jparams, jb, threshold=threshold)
    got = ppl.evaluate_ppl(pmodel.apply, state, pb, threshold=threshold)
    _reports_equal(got, want)
    assert got.passed == (threshold > 9.0)
    # the verdict's wording; the numbers within the tolerance above
    assert got.summary().split(":")[1] == want.summary().split(":")[1]


def test_compare_quantized_matches_jax(fixture):
    _, jparams, pmodel, state, seqs, japply = fixture
    jq = jax_int8.quantize_tree(
        jparams, predicate=lambda k, leaf: leaf.ndim == 2 and "embed" not in k)
    jdeq = jax_dequantize(jq, jnp.float32)
    deq = dequantize_tree(int8.quantize_tree(
        state, lambda n, leaf: leaf.ndim == 2 and "embed" not in n),
        torch.float32)
    jb = jax_ppl.make_batches(seqs, batch_size=8, max_len=64)
    pb = ppl.make_batches(seqs, batch_size=8, max_len=64)
    want = jax_ppl.compare_quantized(japply, jparams, jdeq, jb,
                                     threshold=200.0)
    got = ppl.compare_quantized(pmodel.apply, state, deq, pb,
                                threshold=200.0)
    for key in ("fp_ppl", "quant_ppl"):
        np.testing.assert_allclose(got[key], want[key], rtol=REL)
    np.testing.assert_allclose(got["degradation"], want["degradation"],
                               rtol=1e-3, atol=REL * want["fp_ppl"])
    assert got["passed"] == want["passed"]
    _reports_equal(got["report"], want["report"])
    assert got["fp_ppl"] != got["quant_ppl"]


def test_eval_step_and_perplexity_match_jax(fixture):
    jmodel, jparams, pmodel, _, _, _ = fixture
    rng = np.random.default_rng(1)
    x = rng.integers(0, 160, (3, 24))
    y = np.roll(x, -1, axis=1)
    y[:, -5:] = losses.IGNORE_INDEX
    jstate = train_state.TrainState.create(apply_fn=jmodel.apply,
                                           params=jparams, tx=optax.sgd(0.0))
    want = jax_eval_step()(jstate, (jnp.asarray(x), jnp.asarray(y)))
    state = TrainState(pmodel, [], None, {})
    got = make_eval_step()(state, (torch.from_numpy(x), torch.from_numpy(y)))
    assert set(got) == {"loss", "n_valid"}
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=REL)
    assert int(got["n_valid"]) == int(want["n_valid"]) == 3 * 19
    assert not got["loss"].requires_grad and state.step == 0
    np.testing.assert_allclose(float(losses.perplexity(got["loss"])),
                               float(jax_losses.perplexity(want["loss"])),
                               rtol=REL)
