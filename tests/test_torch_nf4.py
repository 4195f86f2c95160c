"""PyTorch port: NF4 codec and fused matmul against the JAX package.

Inputs come from numpy with a fixed seed and go to both frameworks. The
JAX matmul is run as ``tests/test_nf4_matmul.py`` runs it: on the CPU it
is the Pallas kernel in interpret mode, and every shape here is one its
``_plan`` accepts (asserted), so the comparison is against the kernel and
not its dequant+matmul fallback. The port's CPU path is the plain version
of the CUDA kernel (bf16 operands, f32 sums): only the summation order
differs from the Pallas kernel, hence ``1e-3 * max|ref|``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_in_practise_tpu.ops.nf4_matmul import _plan
from llm_in_practise_tpu.ops.nf4_matmul import nf4_matmul as jax_nf4_matmul
from llm_in_practise_tpu.quant import nf4 as jax_nf4
from llm_in_practise_tpu_torch.models.convert import nf4_from_like
from llm_in_practise_tpu_torch.ops import nf4_matmul as port_mm
from llm_in_practise_tpu_torch.quant import nf4 as port_nf4


def _carry(t):
    """A JAX NF4Tensor as the port's NF4Tensor (numpy in between)."""
    return nf4_from_like(jax.tree.map(np.asarray, t))


@pytest.mark.parametrize("shape,layout", [((256, 512), "kblock"),
                                          ((100, 30), "flat")])
def test_quantize_bytes_match_jax(shape, layout):
    w = np.random.default_rng(0).normal(0, 0.02, shape).astype(np.float32)
    jt = jax_nf4.quantize(w)
    pt = port_nf4.quantize(w)
    assert jt.layout == pt.layout == layout
    assert tuple(pt.shape) == tuple(jt.shape)
    np.testing.assert_array_equal(pt.packed.numpy(), np.asarray(jt.packed))
    np.testing.assert_array_equal(pt.absmax_q.numpy(), np.asarray(jt.absmax_q))
    np.testing.assert_allclose(pt.absmax_scale.numpy(),
                               np.asarray(jt.absmax_scale), rtol=1e-6)
    np.testing.assert_allclose(float(pt.absmax_offset),
                               float(jt.absmax_offset), rtol=1e-6)


@pytest.mark.parametrize("shape", [(256, 512), (100, 30)])
def test_dequantize_of_carried_tensor_matches_jax(shape):
    w = np.random.default_rng(1).normal(0, 0.02, shape).astype(np.float32)
    jt = jax_nf4.quantize(w)
    want = np.asarray(jax_nf4.dequantize(jt, jnp.float32))
    got = port_nf4.dequantize(_carry(jt), torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # kblock_arrays decodes the same absmax the kernel decodes
    if jt.layout == "kblock":
        _, jam = jax_nf4.kblock_arrays(jt)
        _, pam = port_nf4.kblock_arrays(_carry(jt))
        np.testing.assert_allclose(pam.numpy(), np.asarray(jam), rtol=1e-6)


@pytest.mark.parametrize("m,k,n", [(16, 256, 512), (5, 128, 256),
                                   (1, 384, 512)])
def test_matmul_matches_jax_kernel(m, k, n):
    rng = np.random.default_rng(2)
    w = rng.normal(0, 0.02, (k, n)).astype(np.float32)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    jt = jax_nf4.quantize(w)
    assert _plan(jt, None, m) is not None  # the Pallas kernel, not fallback
    ref = np.asarray(jax_nf4_matmul(jnp.asarray(x), jt))
    before = port_mm.nf4_matmul.launches
    got = port_mm.nf4_matmul(torch.from_numpy(x), _carry(jt)).numpy()
    assert got.shape == (m, n)
    assert np.max(np.abs(got - ref)) <= 1e-3 * np.max(np.abs(ref))
    # the CPU path is the plain version: it launches nothing
    assert port_mm.nf4_matmul.launches == before


def test_matmul_leading_dims_and_out_dtype():
    rng = np.random.default_rng(3)
    t = port_nf4.quantize(rng.normal(0, 0.02, (128, 256)).astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (2, 3, 128)).astype(np.float32))
    out = port_mm.nf4_matmul(x, t, torch.bfloat16)
    assert out.shape == (2, 3, 256) and out.dtype == torch.bfloat16
    ref = port_mm.nf4_matmul_reference(x.reshape(6, 128), t, torch.float32)
    assert torch.allclose(out.reshape(6, 256).float(), ref, rtol=1e-2,
                          atol=1e-2)


def test_split_k_keeps_thin_calls_busy():
    # decode widths of Qwen3-8B on 132 SMs: enough blocks, >= 4 chunks/split
    for k, n in [(4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096)]:
        s = port_mm.split_k_for(8, k, n, 132)
        cap = (k // 64) // 4
        assert 1 <= s <= cap
        assert (n // 2 // 32) * s >= 4 * 132 or s == cap
    # wide prefill calls need no split
    assert port_mm.split_k_for(512, 4096, 12288, 132) == 1


def test_flat_layout_is_refused_on_cuda_path():
    t = port_nf4.quantize(np.ones((100, 30), np.float32))
    with pytest.raises(ValueError, match="kblock"):
        port_mm._check(torch.zeros(2, 100), t)
