"""PyTorch port: int8 codec and W8A16 matmul against the JAX package.

Inputs come from numpy with a fixed seed and go to both frameworks.

- Codec: ``quantize`` (2-D and 3-D), ``decode`` and ``quantize_tree`` give
  the JAX package's bytes and values exactly.
- Op: the JAX ``int8_matmul`` runs as ``tests/test_int8.py`` runs it (the
  Pallas kernel in interpret mode on the CPU), at shapes its ``_plan``
  accepts (asserted), and ``jax.vjp`` gives its backward. The port's CPU
  path is the plain version of the CUDA kernels (bf16 x, f32 sums, the
  scale on the f32 sum; backward ``bf16(f32(dy) * scale) @ q^T``) through
  ``Int8Matmul``: only the summation order differs, hence
  ``1e-3 * max|ref|``.
- The backward's rounding point is pinned exactly: with one non-zero q per
  row the sum has one term, so dx reads ``bf16(dy * scale) * q`` bit for
  bit, which rounding dy first or scaling after the sum does not give.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_in_practise_tpu.ops.int8_matmul import _plan
from llm_in_practise_tpu.ops.int8_matmul import int8_matmul as jax_int8_matmul
from llm_in_practise_tpu.quant import int8 as jax_int8
from llm_in_practise_tpu_torch.models.convert import quant_from_like
from llm_in_practise_tpu_torch.ops import int8_matmul as port_mm
from llm_in_practise_tpu_torch.quant import int8 as port_int8
from llm_in_practise_tpu_torch.quant.int8 import Int8Tensor

OP_TOL = 1e-3


def _carry(t):
    return quant_from_like(jax.tree.map(np.asarray, t))


@pytest.mark.parametrize("shape", [(256, 96), (3, 64, 40)])
def test_codec_bytes_match_jax(shape):
    w = np.random.default_rng(len(shape)).normal(0, 0.02, shape).astype(
        np.float32)
    jt = jax_int8.quantize(w)
    pt = port_int8.quantize(w)
    assert tuple(pt.shape) == tuple(jt.shape)
    np.testing.assert_array_equal(pt.q.numpy(), np.asarray(jt.q))
    np.testing.assert_array_equal(pt.scale.numpy(), np.asarray(jt.scale))
    carried = _carry(jt)
    assert isinstance(carried, Int8Tensor)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            port_int8.decode(carried, dtype).float().numpy(),
            np.asarray(jax_int8.decode(jt, jdtype).astype(jnp.float32)))
    with pytest.raises(ValueError, match="2-D/3-D"):
        port_int8.quantize(np.ones(8, np.float32))
    x = np.random.default_rng(9).normal(0, 1, (3, shape[-2])).astype(
        np.float32)
    np.testing.assert_allclose(
        port_int8.dequant_matmul(torch.from_numpy(x), carried).numpy(),
        np.asarray(jax_int8.dequant_matmul(jnp.asarray(x), jt)), rtol=1e-5,
        atol=1e-6)


def test_quantize_tree_matches_jax():
    rng = np.random.default_rng(1)
    state = {"blocks.0.mlp.up_proj.kernel": rng.normal(0, 0.02, (64, 128)),
             "ln_f.scale": np.ones(64)}
    state = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in state.items()}
    got = port_int8.quantize_tree(state)
    assert isinstance(got["blocks.0.mlp.up_proj.kernel"], Int8Tensor)
    assert got["ln_f.scale"] is state["ln_f.scale"]
    want = jax_int8.quantize(state["blocks.0.mlp.up_proj.kernel"].numpy())
    np.testing.assert_array_equal(got["blocks.0.mlp.up_proj.kernel"].q.numpy(),
                                  np.asarray(want.q))


@pytest.mark.parametrize("m,k,n", [(16, 256, 512), (8, 512, 256)])
def test_matmul_and_backward_match_jax_kernel(m, k, n):
    rng = np.random.default_rng(m + k)
    jt = jax_int8.quantize(rng.normal(0, 0.02, (k, n)).astype(np.float32))
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    dy = rng.normal(0, 1, (m, n)).astype(np.float32)
    assert _plan(jt, m) is not None  # the Pallas kernel, not its fallback
    ref, vjp = jax.vjp(lambda v: jax_int8_matmul(v, jt), jnp.asarray(x))
    (dref,) = vjp(jnp.asarray(dy))
    before = (port_mm.int8_matmul.launches,
              port_mm.int8_matmul_backward.launches)
    t = _carry(jt)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port_mm.int8_matmul(xt, t)
    y.backward(torch.from_numpy(dy))
    ref, dref = np.asarray(ref), np.asarray(dref)
    got, dgot = y.detach().numpy(), xt.grad.numpy()
    assert got.shape == (m, n) and dgot.shape == (m, k)
    assert np.max(np.abs(got - ref)) <= OP_TOL * np.max(np.abs(ref))
    assert np.max(np.abs(dgot - dref)) <= OP_TOL * np.max(np.abs(dref))
    assert (port_mm.int8_matmul.launches,
            port_mm.int8_matmul_backward.launches) == before


def test_backward_rounding_point_is_pinned():
    m, k = 8, 128
    rng = np.random.default_rng(2)
    # q = 127 * identity: each dx entry is one product, dys * 127, exact
    q = np.zeros((k, k), np.int8)
    np.fill_diagonal(q, 127)
    scale = rng.uniform(0.5, 1.5, k).astype(np.float32)
    dy = rng.normal(0, 1, (m, k)).astype(np.float32)
    jt = jax_int8.Int8Tensor(jnp.asarray(q), jnp.asarray(scale), (k, k))
    pt = _carry(jt)
    assert _plan(jt, m) is not None
    _, vjp = jax.vjp(lambda v: jax_int8_matmul(v, jt),
                     jnp.zeros((m, k), jnp.float32))
    (want,) = vjp(jnp.asarray(dy))
    got = port_mm.int8_matmul_backward(torch.from_numpy(dy), pt).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    dys = torch.from_numpy(dy * scale).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, dys * 127)
    # the other orders give other numbers
    dy_first = (torch.from_numpy(dy).to(torch.bfloat16).float().numpy()
                * scale * 127)
    assert np.any(got != dy_first)


def test_stacked_leaf_raises_on_the_kernel_path():
    """A stacked leaf has no single weight: the kernel path raises
    ``ValueError`` naming ``unstack_layer_params``, whose layers each run."""
    from llm_in_practise_tpu_torch.models.convert import unstack_layer_params

    w = np.random.default_rng(3).normal(0, 0.02, (2, 64, 32)).astype(
        np.float32)
    t = port_int8.quantize(w)
    with pytest.raises(ValueError, match="unstack_layer_params"):
        port_mm.int8_matmul(torch.zeros(4, 64), t)
    with pytest.raises(ValueError, match="unstack_layer_params"):
        port_mm.int8_matmul_backward(torch.zeros(4, 32), t)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (4, 64)).astype(np.float32))
    layers = unstack_layer_params({"blocks/block/k": t}, 2)
    for i in range(2):
        layer = layers[f"block_{i}/k"]
        assert layer.shape == (64, 32)
        assert torch.equal(port_mm.int8_matmul(x, layer),
                           port_mm.int8_matmul(x, port_int8.quantize(w[i])))
