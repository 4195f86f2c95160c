"""PyTorch port: int4 codec, W4A16 matmul and AWQ dispatch against JAX.

Inputs come from numpy with a fixed seed and go to both frameworks.

- Codec: ``encode``, ``decode``, ``rtn_quantize``, ``quant_params_for_group``
  and ``quantize_column`` give the JAX package's bytes and values exactly
  (symmetric and asymmetric, group sizes 32, 64 and 128, an odd K).
- Op: the JAX ``int4_matmul`` runs as ``tests/test_int4_matmul.py`` runs it
  (the Pallas kernel in interpret mode on the CPU), at shapes its ``_plan``
  accepts (asserted), and ``jax.vjp`` gives its backward. The port's CPU
  path is the plain version of the CUDA kernels (bf16 operands, the weight
  rounded once to bf16, f32 sums), through ``Int4Matmul``: only the
  summation order differs, hence ``1e-3 * max|ref|``. At K = 96 JAX's
  ``_plan`` declines and JAX multiplies the unrounded f32 x by the bf16
  weight while the port's kernel rounds x to bf16 too: a bf16 tolerance,
  ``1e-2 * max|ref|``.
- AWQ: a JAX ``AWQTensor`` through ``fused_kernel_matmul`` against the
  port's dispatch (``x * inv_scale``, then the int4 matmul) at
  ``1e-3 * max|ref|``; ``dequantize_tree`` and ``dequant_matmul`` (the
  materialized forms) against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_in_practise_tpu.ops.int4_matmul import _plan
from llm_in_practise_tpu.ops.int4_matmul import int4_matmul as jax_int4_matmul
from llm_in_practise_tpu.peft.fused import (
    fused_kernel_matmul as jax_fused_kernel_matmul,
)
from llm_in_practise_tpu.quant import awq as jax_awq
from llm_in_practise_tpu.quant import int4 as jax_int4
from llm_in_practise_tpu.quant import int8 as jax_int8
from llm_in_practise_tpu.quant.awq import AWQTensor as JaxAWQTensor
from llm_in_practise_tpu_torch.models.convert import quant_from_like
from llm_in_practise_tpu_torch.ops import int4_matmul as port_mm
from llm_in_practise_tpu_torch.quant import awq as port_awq
from llm_in_practise_tpu_torch.quant import int4 as port_int4
from llm_in_practise_tpu_torch.quant.awq import AWQTensor
from llm_in_practise_tpu_torch.serve.quantized import fused_kernel_matmul

OP_TOL = 1e-3


def _carry(t):
    """A JAX quantized leaf as the port's leaf (numpy in between)."""
    return quant_from_like(jax.tree.map(np.asarray, t))


def _assert_same(pt, jt):
    assert tuple(pt.shape) == tuple(jt.shape)
    assert pt.group_size == jt.group_size
    np.testing.assert_array_equal(pt.packed.numpy(), np.asarray(jt.packed))
    np.testing.assert_array_equal(pt.scales.numpy(), np.asarray(jt.scales))
    np.testing.assert_array_equal(pt.zeros.numpy(), np.asarray(jt.zeros))


@pytest.mark.parametrize("k,n,gs,sym", [(256, 96, 32, True),
                                        (256, 96, 64, False),
                                        (384, 64, 128, True),
                                        (99, 40, 32, False)])
def test_codec_bytes_match_jax(k, n, gs, sym):
    w = np.random.default_rng(k + gs).normal(0, 0.02, (k, n)).astype(
        np.float32)
    jt = jax_int4.rtn_quantize(jnp.asarray(w), group_size=gs, sym=sym)
    pt = port_int4.rtn_quantize(w, group_size=gs, sym=sym)
    _assert_same(pt, jt)
    # encode with fractional zeros (AWQ's affine grid) and decode
    zeros = np.asarray(jt.zeros) + 0.37
    jt2 = jax_int4.encode(jnp.asarray(w), jt.scales, jnp.asarray(zeros), gs)
    pt2 = port_int4.encode(torch.from_numpy(w), pt.scales,
                           torch.from_numpy(zeros), gs)
    _assert_same(pt2, jt2)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = port_int4.decode(_carry(jt2), dtype).float().numpy()
        want = np.asarray(jax_int4.decode(jt2, jdtype).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sym", [True, False])
def test_group_params_and_column_snap_match_jax(sym):
    w = np.random.default_rng(5).normal(0, 0.02, (64, 48)).astype(np.float32)
    js, jz = jax_int4.quant_params_for_group(jnp.asarray(w), sym=sym)
    ps, pz = port_int4.quant_params_for_group(torch.from_numpy(w), sym=sym)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pz.numpy(), np.asarray(jz))
    col = w[3]
    np.testing.assert_array_equal(
        port_int4.quantize_column(torch.from_numpy(col), ps, pz).numpy(),
        np.asarray(jax_int4.quantize_column(jnp.asarray(col), js, jz)))


def _op_case(m, k, n, gs, sym, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.02, (k, n)).astype(np.float32)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    dy = rng.normal(0, 1, (m, n)).astype(np.float32)
    return jax_int4.rtn_quantize(jnp.asarray(w), group_size=gs, sym=sym), x, dy


def _port_fwd_bwd(fn, x, dy):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fn(xt)
    y.backward(torch.from_numpy(dy))
    return y.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("m,k,n,gs,sym", [(16, 256, 512, 64, True),
                                          (8, 512, 256, 128, False)])
def test_matmul_and_backward_match_jax_kernel(m, k, n, gs, sym):
    jt, x, dy = _op_case(m, k, n, gs, sym, seed=m + gs)
    assert _plan(jt, m) is not None  # the Pallas kernel, not its fallback
    ref, vjp = jax.vjp(lambda v: jax_int4_matmul(v, jt), jnp.asarray(x))
    (dref,) = vjp(jnp.asarray(dy))
    before = (port_mm.int4_matmul.launches,
              port_mm.int4_matmul_backward.launches)
    t = _carry(jt)
    got, dgot = _port_fwd_bwd(lambda v: port_mm.int4_matmul(v, t), x, dy)
    ref, dref = np.asarray(ref), np.asarray(dref)
    assert got.shape == (m, n) and dgot.shape == (m, k)
    assert np.max(np.abs(got - ref)) <= OP_TOL * np.max(np.abs(ref))
    assert np.max(np.abs(dgot - dref)) <= OP_TOL * np.max(np.abs(dref))
    # the CPU path is the plain version: it launches nothing
    assert (port_mm.int4_matmul.launches,
            port_mm.int4_matmul_backward.launches) == before


def test_k96_against_jax_fallback():
    jt, x, dy = _op_case(4, 96, 64, 32, True, seed=3)
    assert _plan(jt, 4) is None  # JAX: dequant + matmul
    ref, vjp = jax.vjp(lambda v: jax_int4_matmul(v, jt), jnp.asarray(x))
    (dref,) = vjp(jnp.asarray(dy))
    t = _carry(jt)
    got, dgot = _port_fwd_bwd(lambda v: port_mm.int4_matmul(v, t), x, dy)
    ref, dref = np.asarray(ref), np.asarray(dref)
    assert np.max(np.abs(got - ref)) <= 1e-2 * np.max(np.abs(ref))
    assert np.max(np.abs(dgot - dref)) <= 1e-2 * np.max(np.abs(dref))
    # the port's plain version is the CUDA kernel's arithmetic at any K
    np.testing.assert_allclose(
        got, port_mm.int4_matmul_reference(torch.from_numpy(x), t).numpy())


def test_awq_dispatch_matches_jax():
    rng = np.random.default_rng(11)
    k, n = 256, 384
    w = rng.normal(0, 0.02, (k, n)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, k).astype(np.float32)
    q = jax_int4.rtn_quantize(jnp.asarray(w * s[:, None]), group_size=32,
                              sym=False)
    assert _plan(q, 8) is not None
    jt = JaxAWQTensor(q, jnp.asarray(1.0 / s))
    x = rng.normal(0, 1, (8, k)).astype(np.float32)
    want = np.asarray(jax_fused_kernel_matmul(jnp.asarray(x), jt,
                                              jnp.float32))
    pt = _carry(jt)
    assert isinstance(pt, AWQTensor)
    np.testing.assert_array_equal(pt.inv_scale.numpy(), 1.0 / s)
    got = fused_kernel_matmul(torch.from_numpy(x), pt, torch.float32).numpy()
    assert np.max(np.abs(got - want)) <= OP_TOL * np.max(np.abs(want))
    # the materialized forms: AWQ, int4 and int8 leaves and a plain tensor
    j8 = jax_int8.quantize(w)
    dense = port_awq.dequantize_tree(
        {"awq": pt, "int4": pt.q, "int8": _carry(j8),
         "plain": torch.ones(3)}, torch.float32)
    for key, jt_ in (("awq", jt), ("int4", q), ("int8", j8)):
        np.testing.assert_array_equal(
            dense[key].numpy(),
            np.asarray(jax_awq.dequantize_tree({"k": jt_}, jnp.float32)["k"]))
    assert torch.equal(dense["plain"], torch.ones(3))
    np.testing.assert_allclose(
        port_int4.dequant_matmul(torch.from_numpy(x), pt.q).numpy(),
        np.asarray(jax_int4.dequant_matmul(jnp.asarray(x), q)), rtol=1e-5,
        atol=1e-5)


def test_leading_dims_out_dtype_and_no_grad_path():
    t = port_int4.rtn_quantize(
        np.random.default_rng(4).normal(0, 0.02, (128, 64)).astype(
            np.float32), group_size=64)
    x = torch.from_numpy(
        np.random.default_rng(5).normal(0, 1, (2, 3, 128)).astype(np.float32))
    out = port_mm.int4_matmul(x, t, torch.bfloat16)
    assert out.shape == (2, 3, 64) and out.dtype == torch.bfloat16
    ref = port_mm.int4_matmul_reference(x.reshape(6, 128), t, torch.float32)
    torch.testing.assert_close(out.reshape(6, 64).float(), ref, rtol=1e-2,
                               atol=1e-2)
    dx = port_mm.int4_matmul_backward(torch.ones(2, 3, 64), t)
    assert dx.shape == (2, 3, 128) and dx.dtype == torch.float32


@pytest.mark.parametrize("k,gs,match", [(99, 32, "even K"),
                                        (96, 3, "even group size")])
def test_cuda_path_refuses_odd_shapes(k, gs, match):
    w = np.random.default_rng(6).normal(0, 0.02, (k, 32)).astype(np.float32)
    t = port_int4.rtn_quantize(w, group_size=gs)
    with pytest.raises(ValueError, match=match):
        port_mm._check_weight(t, torch.device("cpu"), "int4_matmul")


def _chip_smoke():
    """chip_smoke.py's module (its top level imports only the standard
    library), for the shapes it runs on the card."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (M, K, N, group size) -> the forward kernel chip_smoke's shapes take
_ROUTES = {
    # decode (the thin-M kernel) and the crossover table below WGMMA_MIN_M
    (1, 4096, 4096, 128): "thin", (8, 4096, 12288, 128): "thin",
    (8, 12288, 4096, 128): "thin", (16, 4096, 1024, 128): "thin",
    (64, 4096, 4096, 128): "thin", (128, 12288, 4096, 128): "thin",
    (17, 4096, 4096, 128): "thin", (255, 4096, 4096, 128): "thin",
    (8, 4096, 4096, 32): "thin", (1, 12288, 4096, 32): "thin",
    # from WGMMA_MIN_M up: prefill, the int4 step (2 x 1024 rows), training
    (256, 4096, 4096, 128): "wgmma", (512, 4096, 1024, 128): "wgmma",
    (1024, 4096, 12288, 128): "wgmma", (2048, 12288, 4096, 128): "wgmma",
    (8192, 4096, 4096, 32): "wgmma", (8191, 4096, 4096, 128): "wgmma",
    # ragged shapes: K 96 at gs 32, N 48 and 1040 take wgmma; K 10 (2K
    # bytes no 16-byte multiple) takes the thin kernel at any M
    (333, 4096, 4096, 128): "wgmma",
    (333, 96, 4096, 32): "wgmma", (333, 4096, 48, 128): "wgmma",
    (333, 4096, 1040, 128): "wgmma", (333, 10, 4096, 2): "thin",
    # shapes the wgmma forward does not take, at any M
    (8192, 4096, 40, 128): "thin", (8192, 4100, 4096, 128): "thin",
    (8192, 4096, 4096, 96): "thin", (8192, 4096, 4096, 2): "wgmma",
}


@pytest.mark.parametrize("m,k,n,gs", sorted(_ROUTES))
def test_route_table(m, k, n, gs):
    assert port_mm._route(m, k, n, gs) == _ROUTES[(m, k, n, gs)]


def test_route_table_covers_the_chip_smoke_shapes():
    cs = _chip_smoke()
    assert port_mm.WGMMA_MIN_M == 256
    shapes = set(cs.PROJ_SHAPES.values())
    for m in (cs.CHECK_M + cs.THIN_CROSSOVER_M + cs.PTQ_CHECK_M
              + cs.DECODE_M):
        for k, n in shapes:
            want = "wgmma" if m >= port_mm.WGMMA_MIN_M else "thin"
            assert port_mm._route(m, k, n, cs.INT4_GS) == want, (m, k, n)
            assert port_mm._route(m, k, n, cs.AWQ_GS) == want, (m, k, n)
    # every ragged forward shape is in the table above
    assert set(cs.FWD_EDGE_SHAPES) <= set(_ROUTES)
    assert port_mm._route(cs.STEP_BATCH * cs.TRAIN_SEQ, 4096, 4096,
                          cs.INT4_GS) == "wgmma"
