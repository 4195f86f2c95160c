"""PyTorch port: the AWQ scale search against JAX's.

Inputs come from numpy with a fixed seed and go to both packages; the
stats (``gram = X^T X``, ``mean|x|``) come from activations whose
channels differ in scale, as a layer's inputs do.

- The loss of every alpha on the grid (20 points) within 1e-4 relative
  of the same expression over JAX's ``_rtn_values`` (JAX's
  ``awq_search_from_stats`` returns only the minimum, so the test spells
  out its per-alpha loss), the chosen alpha equal, the best scale and
  loss equal to ``awq_search_from_stats``' within 1e-5 / 1e-4.
- Alpha 0 is on the grid and its loss equals RTN's exactly (``s = 1``:
  the codes of ``rtn_quantize``), so the chosen loss never exceeds it.
- ``awq_search_matrix`` / ``awq_quantize_matrix`` from raw activations,
  and ``quantize_model_awq`` on a tiny Qwen3 (default target: all but
  ``lm_head``): the same leaves quantized, ``inv_scale`` within 1e-5
  relative, codes equal in at least 99.5% of entries, one step apart at
  most.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_in_practise_tpu.models.qwen3 import Qwen3 as JaxQwen3
from llm_in_practise_tpu.models.qwen3 import qwen3_config as jax_qwen3_config
from llm_in_practise_tpu.quant import awq as jax_awq
from llm_in_practise_tpu_torch.models.convert import (
    params_from_jax,
    quant_from_like,
)
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3, Qwen3Config
from llm_in_practise_tpu_torch.quant import awq, int4
from llm_in_practise_tpu_torch.quant.awq import AWQTensor

from torch_port_util import numpy_params

MODEL_KW = dict(hidden_size=64, intermediate_size=128, n_layer=2, n_head=4,
                n_kv_head=2, head_dim=16, max_seq_len=64,
                compute_dtype="float32")


def codes(t) -> np.ndarray:
    p = t.packed.numpy().astype(np.int32)
    return np.stack([p >> 4, p & 0xF], axis=1).reshape(-1, p.shape[1])[
        : t.shape[0]]


def assert_awq_close(got: AWQTensor, want: AWQTensor, min_equal=0.995):
    np.testing.assert_allclose(got.inv_scale.numpy(), want.inv_scale.numpy(),
                               rtol=1e-5, atol=0)
    cg, cw = codes(got.q), codes(want.q)
    assert (cg == cw).mean() >= min_equal
    assert np.abs(cg - cw).max() <= 1


def jax_alpha_losses(w, gram, mean_abs, cfg):
    """JAX ``awq_search_from_stats``' per-alpha loss, over its
    ``_rtn_values``."""
    w = jnp.asarray(w, jnp.float32)
    s_x = jnp.maximum(jnp.asarray(mean_abs), 1e-8)

    def loss_for_alpha(alpha):
        s = s_x ** alpha
        s = s / jnp.sqrt(jnp.max(s) * jnp.min(s))
        s = jnp.maximum(s, 1e-6)
        wq = jax_awq._rtn_values(w * s[:, None], cfg.group_size, cfg.sym)
        a = w - wq / s[:, None]
        return jnp.sum(a * (jnp.asarray(gram) @ a))

    return np.asarray(jax.lax.map(loss_for_alpha,
                                  jnp.linspace(0.0, 1.0, cfg.n_grid)))


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((400, 128))
         * np.exp(rng.standard_normal(128))[None, :]).astype(np.float32)
    w = (0.05 * rng.standard_normal((128, 40))).astype(np.float32)
    return x, w, (x.T @ x).astype(np.float32), np.abs(x).mean(0)


@pytest.mark.parametrize("gs,sym", [(32, True), (64, False)])
def test_alpha_losses_and_choice_match_jax(problem, gs, sym):
    _, w, gram, mean_abs = problem
    cfg = awq.AWQConfig(group_size=gs, sym=sym)
    cfg_j = jax_awq.AWQConfig(group_size=gs, sym=sym)
    alphas, losses = awq.awq_losses(torch.from_numpy(w),
                                    torch.from_numpy(gram),
                                    torch.from_numpy(mean_abs), cfg)
    want = jax_alpha_losses(w, gram, mean_abs, cfg_j)
    assert len(losses) == 20 and float(alphas[0]) == 0.0
    np.testing.assert_allclose(losses.numpy(), want, rtol=1e-4, atol=0)
    assert int(torch.argmin(losses)) == int(np.argmin(want))
    scale, best = awq.awq_search_from_stats(
        torch.from_numpy(w), torch.from_numpy(gram),
        torch.from_numpy(mean_abs), cfg)
    scale_j, best_j = jax_awq.awq_search_from_stats(
        jnp.asarray(w), jnp.asarray(gram), jnp.asarray(mean_abs), cfg_j)
    np.testing.assert_allclose(scale.numpy(), np.asarray(scale_j), rtol=1e-5)
    np.testing.assert_allclose(float(best), float(best_j), rtol=1e-4)
    # alpha 0 is RTN, exactly: s = 1 and the codes of rtn_quantize
    rtn = int4.decode(int4.rtn_quantize(w, group_size=gs, sym=sym),
                      torch.float32)
    a = torch.from_numpy(w) - rtn
    assert float(losses[0]) == float(torch.sum(a * (torch.from_numpy(gram)
                                                    @ a)))
    assert float(best) <= float(losses[0])


def test_search_and_quantize_from_activations_match_jax(problem):
    x, w, _, _ = problem
    cfg, cfg_j = awq.AWQConfig(group_size=32), jax_awq.AWQConfig(group_size=32)
    scale, err = awq.awq_search_matrix(torch.from_numpy(w),
                                       torch.from_numpy(x), cfg)
    scale_j, err_j = jax_awq.awq_search_matrix(jnp.asarray(w), jnp.asarray(x),
                                               cfg_j)
    np.testing.assert_allclose(scale.numpy(), np.asarray(scale_j), rtol=1e-5)
    np.testing.assert_allclose(float(err), float(err_j), rtol=1e-4)
    got = awq.awq_quantize_matrix(torch.from_numpy(w), torch.from_numpy(x),
                                  cfg)
    want = quant_from_like(jax.tree.map(np.asarray, jax_awq
                                        .awq_quantize_matrix_jit(
                                            jnp.asarray(w), jnp.asarray(x),
                                            cfg_j)))
    assert isinstance(got, AWQTensor) and got.q.group_size == 32
    assert_awq_close(got, want)
    np.testing.assert_allclose(
        awq.decode(got, torch.float32).numpy(),
        np.asarray(jax_awq.decode(jax.tree.map(jnp.asarray, jax_awq
                                               .awq_quantize_matrix_jit(
                                                   jnp.asarray(w),
                                                   jnp.asarray(x), cfg_j)),
                                  jnp.float32)), rtol=0,
        atol=1e-5 * np.abs(w).max())


def test_quantize_model_awq_matches_jax():
    jcfg = jax_qwen3_config(96, **MODEL_KW)
    jmodel = JaxQwen3(jcfg)
    params = numpy_params(jmodel, 5)
    cfg = Qwen3Config.from_dict(jcfg.to_dict())
    state = params_from_jax(params, cfg)
    model = Qwen3(cfg, device="meta")
    rng = np.random.default_rng(6)
    batches = [rng.integers(0, 96, (1, 16)).astype(np.int32)
               for _ in range(3)]
    want = jax_awq.quantize_model_awq(
        jmodel, params, [jnp.asarray(b) for b in batches],
        jax_awq.AWQConfig(group_size=32))
    want = params_from_jax(jax.tree.map(np.asarray, want), cfg)
    timings = {}
    got = awq.quantize_model_awq(
        model, state, [torch.from_numpy(b).long() for b in batches],
        awq.AWQConfig(group_size=32), timings=timings)
    quantized = sorted(n for n, v in got.items() if isinstance(v, AWQTensor))
    assert quantized == sorted(n for n, v in want.items()
                               if isinstance(v, AWQTensor))
    assert len(quantized) == 14 and "lm_head.kernel" not in quantized
    assert len(timings) == 14
    for name in quantized:
        assert_awq_close(got[name], want[name])
    assert got["lm_head.kernel"] is state["lm_head.kernel"]
    deq = awq.dequantize_tree(got, torch.float32)
    assert all(isinstance(v, torch.Tensor) for v in deq.values())
