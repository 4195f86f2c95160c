"""PyTorch port: the NF4 backward (dx = dy @ dequant(W)^T) against JAX.

The JAX side is ``_call_bwd``, the Pallas ``_bwd_kernel`` in interpret
mode, at shapes its ``_plan`` covers (asserted), and ``jax.vjp`` through
the JAX ``nf4_matmul``'s ``custom_vjp``. The port's CPU path is the
plain version of the CUDA kernel (bf16 operands, f32 sums): only the
summation order differs, hence ``1e-3 * max|ref|``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_in_practise_tpu.ops.nf4_matmul import _call_bwd, _layout_arrays, _plan
from llm_in_practise_tpu.ops.nf4_matmul import nf4_matmul as jax_nf4_matmul
from llm_in_practise_tpu.quant import nf4 as jax_nf4
from llm_in_practise_tpu_torch.models.convert import nf4_from_like
from llm_in_practise_tpu_torch.ops import nf4_matmul as port_mm
from llm_in_practise_tpu_torch.quant import nf4 as port_nf4

REL = 1e-3


def _carry(t):
    return nf4_from_like(jax.tree.map(np.asarray, t))


def _close(got, want):
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= REL * np.max(np.abs(want))


@pytest.mark.parametrize("m,k,n", [(128, 256, 512), (256, 512, 256),
                                   (33, 192, 192), (17, 256, 320)])
def test_backward_matches_jax_kernel(m, k, n):
    """The Pallas kernel where its ``_plan`` takes the shape; where it does
    not (N % 128 == 64: N/2 is no multiple of 128, the shapes on which the
    CUDA kernel's last high-half stage straddles into the low half), the
    JAX package's fallback, ``dy @ dequantize(t)^T`` in dy's dtype. The
    fallback multiplies an f32 dy, so dy is given in bf16 values there:
    the port's dx takes bf16 operands, as the kernel does."""
    rng = np.random.default_rng(10)
    w = rng.normal(0, 0.02, (k, n)).astype(np.float32)
    dy = rng.normal(0, 1, (m, n)).astype(np.float32)
    jt = jax_nf4.quantize(w)
    plan = _plan(jt, None, m)
    assert (plan is None) == (n % 128 == 64)
    if plan is None:
        dy = torch.from_numpy(dy).to(torch.bfloat16).float().numpy()
        _, vjp = jax.vjp(lambda a: jax_nf4_matmul(a, jt),
                         jnp.zeros((m, k), jnp.float32))
        want = np.asarray(vjp(jnp.asarray(dy))[0])
    else:
        bm, bnh, bk = plan
        packed, absmax3 = _layout_arrays(jt)
        want = np.asarray(_call_bwd(jnp.asarray(dy), packed, absmax3, bm=bm,
                                    bnh=bnh, bk=bk, out_dtype=jnp.float32,
                                    interpret=True))
    t = _carry(jt)
    _close(port_mm.nf4_matmul_backward_reference(
        torch.from_numpy(dy), t, torch.float32).numpy(), want)
    # through autograd: the Function's backward is the port's dx
    x = torch.zeros(m, k, requires_grad=True)
    port_mm.nf4_matmul(x, t).backward(torch.from_numpy(dy))
    _close(x.grad.numpy(), want)
    # the CUDA kernel takes the shape (K % 64 == 0, N % 64 == 0)
    assert port_mm._check_backward(torch.zeros(m, n), t) == (k, n)


def test_autograd_matches_jax_vjp():
    rng = np.random.default_rng(11)
    w = rng.normal(0, 0.02, (256, 512)).astype(np.float32)
    x = rng.normal(0, 1, (2, 64, 256)).astype(np.float32)
    dy = rng.normal(0, 1, (2, 64, 512)).astype(np.float32)
    jt = jax_nf4.quantize(w)
    y, vjp = jax.vjp(lambda a: jax_nf4_matmul(a, jt), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port_mm.nf4_matmul(xt, _carry(jt))
    _close(out.detach().numpy(), np.asarray(y))
    out.backward(torch.from_numpy(dy))
    _close(xt.grad.numpy(), np.asarray(want))


def test_backward_leading_dims_and_out_dtype():
    rng = np.random.default_rng(12)
    t = port_nf4.quantize(rng.normal(0, 0.02, (128, 256)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(0, 1, (2, 3, 256)).astype(np.float32))
    dx = port_mm.nf4_matmul_backward(dy, t, torch.bfloat16)
    assert dx.shape == (2, 3, 128) and dx.dtype == torch.bfloat16
    ref = port_mm.nf4_matmul_backward_reference(dy.reshape(6, 256), t,
                                                torch.float32)
    assert torch.allclose(dx.reshape(6, 128).float(), ref, rtol=1e-2,
                          atol=1e-2)
    # dx comes back in x's dtype through autograd
    x = torch.zeros(2, 3, 128, dtype=torch.bfloat16, requires_grad=True)
    port_mm.nf4_matmul(x, t, torch.float32).sum().backward()
    assert x.grad.dtype == torch.bfloat16 and x.grad.shape == x.shape


def test_backward_runs_only_where_dx_is_needed(monkeypatch):
    rng = np.random.default_rng(13)
    t = port_nf4.quantize(rng.normal(0, 0.02, (128, 256)).astype(np.float32))
    calls = []
    real = port_mm.nf4_matmul_backward

    def counting(dy, t, out_dtype=None):
        calls.append(tuple(dy.shape))
        return real(dy, t, out_dtype)

    monkeypatch.setattr(port_mm, "nf4_matmul_backward", counting)
    a = torch.zeros(256, 4, requires_grad=True)
    x = torch.from_numpy(rng.normal(0, 1, (5, 128)).astype(np.float32))
    # a frozen input (layer 0's q/k/v): the base path has no backward
    (port_mm.nf4_matmul(x, t) @ a).sum().backward()
    assert calls == [] and a.grad is not None
    xg = x.clone().requires_grad_(True)
    (port_mm.nf4_matmul(xg, t) @ a).sum().backward()
    assert calls == [(5, 256)]


def test_backward_layouts_refused_on_cuda_path():
    flat = port_nf4.quantize(np.ones((100, 30), np.float32))
    with pytest.raises(ValueError, match="kblock"):
        port_mm._check_backward(torch.zeros(2, 30), flat)
    narrow = port_nf4.quantize(np.ones((128, 96), np.float32))
    with pytest.raises(ValueError, match="N % 64"):
        port_mm._check_backward(torch.zeros(2, 96), narrow)
    with pytest.raises(ValueError, match="N="):
        port_mm._check_backward(torch.zeros(2, 64), narrow)
