"""PyTorch port: causal flash attention against the JAX package.

Inputs come from numpy and go to both frameworks. The JAX side is
``flash_attention(..., interpret=True)`` (the Pallas kernels in
interpret mode, with K/V repeated to the query heads, since the JAX entry
point takes equal heads) and the JAX dense attention (grouped natively).
The port runs its plain versions on the CPU, through the same
``torch.autograd.Function`` the kernels use on the card. Tolerances are
``tests/test_flash_attention.py``'s: f32 atol 2e-5 forward and 5e-5 for
gradients, bf16 3e-2. Lengths: one 128 tile, a ragged 200, two tiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_in_practise_tpu.ops.attention import dense_attention as jax_dense
from llm_in_practise_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
)
from llm_in_practise_tpu_torch.ops import flash_attention as port_fa
from llm_in_practise_tpu_torch.ops.attention import (
    dense_attention,
    dot_product_attention,
    pick_impl,
)

H, HKV, D = 4, 2, 32


def _inputs(b, length, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, length, H, D)).astype(dtype)
    k = rng.standard_normal((b, length, HKV, D)).astype(dtype)
    v = rng.standard_normal((b, length, HKV, D)).astype(dtype)
    w = rng.standard_normal((b, length, H, D)).astype(dtype)
    return q, k, v, w


def _jax_flash(q, k, v):
    g = q.shape[2] // k.shape[2]
    return jax_flash(q, jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2),
                     interpret=True)


def _jax_grads(fn, q, k, v, w):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v) * w)

    out = fn(q, k, v)
    return (np.asarray(out),
            [np.asarray(x) for x in jax.grad(loss, (0, 1, 2))(q, k, v)])


def _port_grads(q, k, v, w):
    qt, kt, vt = (torch.from_numpy(np.asarray(x)).requires_grad_(True)
                  for x in (q, k, v))
    out = port_fa.flash_attention(qt, kt, vt)
    (out * torch.from_numpy(np.asarray(w))).sum().backward()
    return (out.detach().numpy(),
            [x.grad.numpy() for x in (qt, kt, vt)])


@pytest.mark.parametrize("length", [128, 200, 256])
def test_forward_and_grads_match_jax_flash_f32(length):
    q, k, v, w = _inputs(1, length, seed=length)
    want_o, want_g = _jax_grads(_jax_flash, *map(jnp.asarray, (q, k, v, w)))
    got_o, got_g = _port_grads(q, k, v, w)
    np.testing.assert_allclose(got_o, want_o, atol=2e-5)
    for got, want in zip(got_g, want_g):
        np.testing.assert_allclose(got, want, atol=5e-5)


def test_matches_jax_dense_grouped_f32():
    q, k, v, w = _inputs(2, 200, seed=5)

    def dense(q, k, v):
        return jax_dense(q, k, v, causal=True)

    want_o, want_g = _jax_grads(dense, *map(jnp.asarray, (q, k, v, w)))
    got_o, got_g = _port_grads(q, k, v, w)
    np.testing.assert_allclose(got_o, want_o, atol=2e-5)
    for got, want in zip(got_g, want_g):
        np.testing.assert_allclose(got, want, atol=5e-5)


def test_bfloat16_matches_jax_flash():
    q, k, v, w = _inputs(1, 200, seed=6)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(_jax_flash(jq, jk, jv), np.float32)
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = port_fa.flash_attention(qt, kt, vt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


def test_lse_and_reference_backward_agree_with_autograd():
    # the plain backward (FA-2 formulas from the saved LSE) equals
    # autograd through the plain forward
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(1, 130, seed=7))
    scale = D ** -0.5
    out, lse = port_fa.flash_forward_reference(q, k, v, scale)
    assert lse.shape == (1, H, 130)
    want = dense_attention(q, k, v)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=0)
    qa, ka, va = (x.clone().requires_grad_(True) for x in (q, k, v))
    (dense_attention(qa, ka, va) * w).sum().backward()
    got = port_fa.flash_backward_reference(q, k, v, out, lse, w, scale)
    for a, b in zip(got, (qa.grad, ka.grad, va.grad)):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=0)
    # the per-kernel wrappers take their plain versions on CPU tensors
    delta = (w * out).sum(-1).permute(0, 2, 1)
    dk, dv = port_fa.flash_backward_dkv(q, k, v, w, lse, delta, scale)
    dq = port_fa.flash_backward_dq(q, k, v, w, lse, delta, scale)
    for a, b in zip((dq, dk, dv), got):
        torch.testing.assert_close(a, b)


def test_noncausal_and_bad_shapes_raise():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 64, seed=8))
    with pytest.raises(NotImplementedError, match="causal"):
        port_fa.flash_attention(q, k, v, causal=False)
    with pytest.raises(ValueError, match="multiple"):
        port_fa.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="matching"):
        port_fa.flash_attention(q, k[:, :32], v[:, :32])


class _OnCuda:
    """The shape, dtype and device of a card tensor: enough for the
    dispatch and the kernels' argument checks, which run before any
    kernel is loaded, so they are checked here without a card."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,head_dim", [(torch.bfloat16, 128),
                                            (torch.float32, 128),
                                            (torch.bfloat16, 32)])
def test_auto_takes_flash_on_cuda_for_every_uncached_call(dtype, head_dim):
    # every uncached causal call the kernels can take: bf16 at head_dim
    # 64 or 128; the rule is decided before any launch, so a dtype or
    # head_dim they cannot take (the GPT family's f32 default, its
    # head_dim 32) is dense
    q = _OnCuda((1, 16, 4, head_dim), dtype)
    k = _OnCuda((1, 16, 2, head_dim), dtype)
    takes = (dtype, head_dim) == (torch.bfloat16, 128)
    assert pick_impl(q, k) == ("flash" if takes else "dense")
    assert pick_impl(q, k, q_offset=3) == "dense"  # cached: dense
    if not takes:
        # asked for explicitly, what the kernels cannot take raises; it
        # never runs plain
        with pytest.raises((TypeError, ValueError),
                           match="flash kernels take"):
            port_fa.flash_forward(q, k, k, head_dim ** -0.5)


def test_dispatch_dense_on_cpu_flash_when_asked():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 64, seed=9))
    assert pick_impl(q, k) == "dense"  # the CPU default, as in the reference
    torch.testing.assert_close(dot_product_attention(q, k, v, impl="flash"),
                               dense_attention(q, k, v), atol=2e-5, rtol=0)
    # a cached (q_offset) call stays dense even when flash is asked for
    out = dot_product_attention(q[:, -1:], k, v, q_offset=63, impl="flash")
    torch.testing.assert_close(out, dense_attention(q[:, -1:], k, v,
                                                    q_offset=63))
    with pytest.raises(ValueError, match="impl"):
        dot_product_attention(q, k, v, impl="ring")


# --- the kernels' input layout (the forward reads q, k, v through 4-D TMA
# tensor maps: strides in 16-byte multiples, a 16-byte aligned base) ---


def _bf16(*shape):
    return torch.from_numpy(
        np.random.default_rng(21).standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)


def test_kernel_input_keeps_a_contiguous_aligned_tensor():
    x = _bf16(2, 16, 4, 64)
    got = port_fa._kernel_input(x, "q")
    assert got.data_ptr() == x.data_ptr() and got.stride() == x.stride()


def test_kernel_input_keeps_strided_views_of_a_fused_qkv():
    h, hkv, d = 4, 2, 64
    fused = _bf16(2, 16, h + 2 * hkv, d)
    for view in (fused[:, :, :h], fused[:, :, h:h + hkv],
                 fused[:, :, h + hkv:]):
        got = port_fa._kernel_input(view, "q")
        # no copy: the kernels read the view through its strides
        assert got.data_ptr() == view.data_ptr()
        assert got.stride() == view.stride() == ((h + 2 * hkv) * 16 * d,
                                                 (h + 2 * hkv) * d, d, 1)


@pytest.mark.parametrize("case", ["stride_not_multiple_of_8", "zero_stride",
                                  "d_not_contiguous"])
def test_kernel_input_copies_strides_the_kernels_cannot_read(case):
    if case == "stride_not_multiple_of_8":
        x = _bf16(2, 16, 4, 68)[..., :64]      # head stride 68 elements
    elif case == "zero_stride":
        x = _bf16(1, 16, 4, 64).expand(3, 16, 4, 64)
    else:
        x = _bf16(2, 16, 64, 4).transpose(2, 3)
    got = port_fa._kernel_input(x, "k")
    assert got.data_ptr() != x.data_ptr() and got.is_contiguous()
    assert all(s % 8 == 0 and s > 0 for s in got.stride()[:3])
    assert torch.equal(got, x)


def test_kernel_input_realigns_an_offset_base():
    buf = _bf16(2 * 16 * 4 * 64 + 1)
    x = buf[1:].view(2, 16, 4, 64)             # 2 bytes past the boundary
    assert x.data_ptr() % 16 != 0
    got = port_fa._kernel_input(x, "v")
    assert got.data_ptr() % 16 == 0 and torch.equal(got, x)


def test_kernel_input_takes_bf16_only():
    with pytest.raises(TypeError, match="take bf16"):
        port_fa._kernel_input(torch.zeros(1, 8, 2, 64), "q")
