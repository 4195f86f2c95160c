"""PyTorch port: the GPTQ solver and the calibration stats against JAX's.

Inputs come from numpy with a fixed seed and go to both packages.

- ``hessian`` and ``_cholesky_inv_upper`` within 1e-5 of the largest
  entry (both factor a damped f32 inverse; JAX symmetrizes it first, and
  so does the port).
- ``gptq_quantize_matrix`` at group sizes 32 and 64, symmetric and
  asymmetric, on a Hessian from seeded activations with a spread of
  channel scales. The port sweeps a group's rows, then carries the
  group's errors into the later rows with one matmul (the lazy batch
  update); JAX updates every later row after each row. Equal in exact
  arithmetic, so: scales and zeros within 1e-4 relative, codes equal in
  at least 99.5% of entries and every mismatch one step apart (a
  rounding tie flipped by the summation order), the calibration error
  ``tr(A^T H A)`` within 1% of JAX's. With ``H = c * I`` no error
  propagates, and the codes equal ``rtn_quantize``'s exactly.
- ``accumulate_dense_stats`` on a tiny Qwen3, tied and untied: the key
  set equals JAX's (flax paths; ``lm_head/kernel`` only when untied), the
  Gram and abs-sum within 1e-5 relative, the counts equal; kernels fed
  one tensor share one Gram.
- ``quantize_model_gptq``: the same leaves quantized, codes as above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.models.qwen3 import qwen3_config as jax_qwen3_config
from llm_in_practise_tpu.quant import gptq as jax_gptq
from llm_in_practise_tpu_torch.models.convert import (
    flax_path,
    params_from_jax,
    quant_from_like,
)
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
from llm_in_practise_tpu_torch.quant import gptq
from llm_in_practise_tpu_torch.quant import int4
from llm_in_practise_tpu_torch.quant.int4 import Int4Tensor

from torch_port_util import numpy_params

MODEL_KW = dict(hidden_size=64, intermediate_size=128, n_layer=2, n_head=4,
                n_kv_head=2, head_dim=16, max_seq_len=64,
                compute_dtype="float32")


def codes(t) -> np.ndarray:
    """The (in, out) int4 codes of an Int4Tensor of either package."""
    p = np.asarray(t.packed).astype(np.int32)
    return np.stack([p >> 4, p & 0xF], axis=1).reshape(-1, p.shape[1])[
        : t.shape[0]]


def calib_error(w: np.ndarray, wq: np.ndarray, h: np.ndarray) -> float:
    a = w.astype(np.float64) - wq.astype(np.float64)
    return float(np.sum(a * (h.astype(np.float64) @ a)))


def assert_codes_close(got: Int4Tensor, want: Int4Tensor, w, h, *,
                       min_equal=0.995):
    """``want``: JAX's tensor carried into the port's type."""
    np.testing.assert_allclose(got.scales.numpy(), want.scales.numpy(),
                               rtol=1e-4, atol=0)
    np.testing.assert_allclose(got.zeros.numpy(), want.zeros.numpy(),
                               rtol=1e-4, atol=0)
    cg, cw = codes(got), codes(want)
    assert (cg == cw).mean() >= min_equal, (cg != cw).sum()
    assert np.abs(cg - cw).max() <= 1
    e_got = calib_error(w, int4.decode(got, torch.float32).numpy(), h)
    e_want = calib_error(w, int4.decode(want, torch.float32).numpy(), h)
    assert abs(e_got - e_want) <= 0.01 * e_want


@pytest.fixture(scope="module")
def problem():
    """A (128, 48) kernel and the Hessian of 512 activation rows whose
    channels differ in scale (as a layer's inputs do)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((512, 128))
         * np.exp(rng.standard_normal(128))[None, :]).astype(np.float32)
    w = (0.05 * rng.standard_normal((128, 48))).astype(np.float32)
    h = np.asarray(jax_gptq.hessian(jnp.asarray(x)))
    return x, w, h.copy()


def test_hessian_and_cholesky_factor_match_jax(problem):
    x, _, h = problem
    got = gptq.hessian(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, h, rtol=0, atol=1e-5 * np.abs(h).max())
    h = h.copy()
    h[5, :] = h[:, 5] = 0.0   # a dead input channel
    u_jax = np.asarray(jax_gptq._cholesky_inv_upper(jnp.asarray(h), 0.01))
    u = gptq._cholesky_inv_upper(torch.from_numpy(h), 0.01).numpy()
    assert np.allclose(np.tril(u, -1), 0.0)
    np.testing.assert_allclose(u, u_jax, rtol=0,
                               atol=1e-5 * np.abs(u_jax).max())


@pytest.mark.parametrize("gs", [32, 64])
@pytest.mark.parametrize("sym", [True, False])
def test_gptq_matrix_matches_jax(problem, gs, sym):
    _, w, h = problem
    cfg_j = jax_gptq.GPTQConfig(group_size=gs, sym=sym)
    want = quant_from_like(jax.tree.map(np.asarray, jax_gptq
                                        .gptq_quantize_matrix_jit(
                                            jnp.asarray(w), jnp.asarray(h),
                                            cfg_j)))
    got = gptq.gptq_quantize_matrix(torch.from_numpy(w), torch.from_numpy(h),
                                    gptq.GPTQConfig(group_size=gs, sym=sym))
    assert got.group_size == gs and tuple(got.shape) == w.shape
    assert_codes_close(got, want, w, h)
    # GPTQ beats round-to-nearest on its own objective
    rtn = int4.rtn_quantize(w, group_size=gs, sym=sym)
    assert (calib_error(w, int4.decode(got, torch.float32).numpy(), h)
            < calib_error(w, int4.decode(rtn, torch.float32).numpy(), h))


@pytest.mark.parametrize("sym", [True, False])
def test_gptq_with_identity_hessian_is_rtn_exactly(problem, sym):
    _, w, _ = problem
    h = 3.0 * torch.eye(w.shape[0])
    got = gptq.gptq_quantize_matrix(torch.from_numpy(w), h,
                                    gptq.GPTQConfig(group_size=32, sym=sym))
    rtn = int4.rtn_quantize(w, group_size=32, sym=sym)
    assert torch.equal(got.packed, rtn.packed)
    assert torch.equal(got.scales, rtn.scales)
    assert torch.equal(got.zeros, rtn.zeros)
    with pytest.raises(ValueError, match="not divisible"):
        gptq.gptq_quantize_matrix(torch.from_numpy(w[:100]), h[:100, :100],
                                  gptq.GPTQConfig(group_size=32))


def _tiny(tied: bool, seed: int):
    jcfg = jax_qwen3_config(96, tie_word_embeddings=tied, **MODEL_KW)
    jmodel = JaxQwen3(jcfg)
    params = numpy_params(jmodel, seed)
    cfg = Qwen3Config.from_dict(jcfg.to_dict())
    state = params_from_jax(params, cfg)
    return jmodel, params, Qwen3(cfg, device="meta"), state


def _batches(seed: int):
    rng = np.random.default_rng(seed)
    # one length: the JAX interceptor runs un-jitted, compiling each op
    # once per shape
    return [rng.integers(0, 96, (1, 16)).astype(np.int32) for _ in range(3)]


@pytest.mark.parametrize("tied", [False, True])
def test_dense_stats_match_jax(tied):
    jmodel, params, model, state = _tiny(tied, 1)
    batches = _batches(2)
    want = jax_gptq.accumulate_dense_stats(
        jmodel, params, [jnp.asarray(b) for b in batches])
    got = gptq.accumulate_dense_stats(
        model, state, [torch.from_numpy(b).long() for b in batches])
    assert set(got) == set(want)
    assert ("lm_head/kernel" in got) == (not tied)
    assert len(got) == 7 * 2 + (not tied)
    for key, st in got.items():
        ref = want[key]
        assert st.count == ref.count == 48
        for a, b in ((st.gram, ref.gram), (st.abs_sum, ref.abs_sum)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-5 * np.abs(b).max())
    # q/k/v read one tensor, gate/up another: one Gram each
    assert got["block_0/attn/q_proj/kernel"].gram is got[
        "block_0/attn/v_proj/kernel"].gram
    assert got["block_1/mlp/gate_proj/kernel"].gram is got[
        "block_1/mlp/up_proj/kernel"].gram
    assert got["block_1/mlp/up_proj/kernel"].gram is not got[
        "block_1/mlp/down_proj/kernel"].gram
    assert gptq.stats_nbytes(got) == 4 * (2 * (3 * 64 * 64 + 128 * 128
                                               + 3 * 64 + 128)
                                          + (0 if tied else 64 * 64 + 64))
    only = gptq.accumulate_dense_stats(
        model, state, [torch.from_numpy(batches[0]).long()],
        target=lambda k: "mlp" in k)
    assert sorted(only) == sorted(k for k in want if "mlp" in k)


def test_quantize_model_gptq_matches_jax():
    jmodel, params, model, state = _tiny(False, 3)
    batches = _batches(4)
    cfg_j = jax_gptq.GPTQConfig(group_size=32)
    want = jax_gptq.quantize_model_gptq(
        jmodel, params, [jnp.asarray(b) for b in batches], cfg_j)
    want = params_from_jax(jax.tree.map(np.asarray, want), model.cfg)
    stats = gptq.accumulate_dense_stats(
        model, state, [torch.from_numpy(b).long() for b in batches])
    timings = {}
    got = gptq.quantize_model_gptq(
        model, state, [torch.from_numpy(b).long() for b in batches],
        gptq.GPTQConfig(group_size=32), timings=timings)
    quantized = sorted(n for n, v in got.items() if isinstance(v, Int4Tensor))
    assert quantized == sorted(n for n, v in want.items()
                               if isinstance(v, Int4Tensor))
    assert len(quantized) == 15 and "lm_head.kernel" in quantized
    assert len(timings) == 15 and all(s >= 0 for s in timings.values())
    for name in quantized:
        h = stats[flax_path(name)].hessian.numpy()
        assert_codes_close(got[name], want[name], state[name].numpy(), h)
    assert got["tok_embed.weight"] is state["tok_embed.weight"]
