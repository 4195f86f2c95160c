"""Serving packed quantized weights: every quantized projection runs a kernel.

Port of ``llm_in_practise_tpu/serve/quantized.py`` with the serving half
of ``peft/fused.py:56-77, 225-233``. Where the JAX package intercepts
flax ``Dense`` calls, the port swaps modules: each :class:`Dense` whose
kernel in the state is a quantized leaf becomes a :class:`QuantizedLinear`
that calls :func:`fused_kernel_matmul`, so the bf16 weight never exists
in device memory:

- NF4 (the QLoRA base, bitsandbytes' format) -> ``nf4_matmul``;
- int4 (GPTQ, RTN) -> ``int4_matmul``;
- AWQ -> ``x * inv_scale``, in x's dtype, then ``int4_matmul``;
- int8 -> ``int8_matmul``.

A tree may mix formats (the JAX package's ``"mixed"`` preset: int8 MLP,
NF4 attention). A quantized leaf that no ``Dense`` consumes raises.
"""

from __future__ import annotations

import torch
from torch import nn

from llm_in_practise_tpu_torch.core.device import resolve_device
from llm_in_practise_tpu_torch.models.layers import Dense
from llm_in_practise_tpu_torch.ops.int4_matmul import int4_matmul
from llm_in_practise_tpu_torch.ops.int8_matmul import int8_matmul
from llm_in_practise_tpu_torch.ops.nf4_matmul import nf4_matmul
from llm_in_practise_tpu_torch.quant.awq import AWQTensor
from llm_in_practise_tpu_torch.quant.int4 import Int4Tensor
from llm_in_practise_tpu_torch.quant.int8 import Int8Tensor
from llm_in_practise_tpu_torch.quant.nf4 import NF4Tensor

QUANT_LEAVES = (NF4Tensor, Int4Tensor, AWQTensor, Int8Tensor)


def fused_kernel_matmul(x: torch.Tensor, t, compute_dtype) -> torch.Tensor:
    """One quantized kernel through its fused matmul. AWQ folds its
    per-input-channel ``inv_scale`` into the activations
    (``x @ diag(s) @ decode(q) == (x * s) @ decode(q)``), then rides the
    int4 kernel."""
    if isinstance(t, NF4Tensor):
        return nf4_matmul(x, t, compute_dtype)
    if isinstance(t, AWQTensor):
        return int4_matmul(x * t.inv_scale.to(x.dtype), t.q, compute_dtype)
    if isinstance(t, Int8Tensor):
        return int8_matmul(x, t, compute_dtype)
    if isinstance(t, Int4Tensor):
        return int4_matmul(x, t, compute_dtype)
    raise TypeError(f"not a quantized leaf: {type(t).__name__}")


class QuantizedLinear(nn.Module):
    """``y = fused_kernel_matmul(x.to(compute), W, compute)``, plus the
    ``bias`` of a biased :class:`Dense` in ``compute`` after the kernel's
    output (JAX ``peft/fused.py:218-220``), back in x's dtype."""

    def __init__(self, weight, compute_dtype: torch.dtype):
        super().__init__()
        self.weight = weight
        self.compute_dtype = compute_dtype
        # a biased Dense's bias, set by swap_quantized_linears
        self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.project(x.to(self.compute_dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.compute_dtype)
        return y if y.dtype == x.dtype else y.to(x.dtype)

    def project(self, xc: torch.Tensor) -> torch.Tensor:
        """The projection of ``xc`` (already in the compute dtype)."""
        return fused_kernel_matmul(xc, self.weight, self.compute_dtype)

    def extra_repr(self) -> str:
        name = type(self.weight).__name__
        return f"{name}, shape={tuple(self.weight.shape)}"


def swap_quantized_linears(model: nn.Module, state: dict, device,
                           make_linear) -> dict:
    """Replace each :class:`Dense` whose ``kernel`` in ``state`` is a
    quantized leaf with ``make_linear(weight_on_device)``; returns the rest
    of ``state``, moved to ``device``, for ``model.load_state``. A
    quantized leaf that no ``Dense`` consumes raises. A biased Dense's
    ``bias`` placeholder moves to its replacement, which ``load_state``
    then fills from ``state``; a replacement that cannot add a bias
    raises."""
    dense_state, unconsumed = {}, []
    for name, value in state.items():
        if not isinstance(value, QUANT_LEAVES):
            dense_state[name] = value.to(device)
            continue
        mod_path, _, attr = name.rpartition(".")
        try:
            mod = model.get_submodule(mod_path)
        except AttributeError:
            mod = None
        if attr != "kernel" or not isinstance(mod, Dense):
            unconsumed.append(name)
            continue
        parent_path, _, child = mod_path.rpartition(".")
        linear = make_linear(value.to(device))
        if mod.bias is not None:
            if not hasattr(linear, "bias"):
                raise NotImplementedError(
                    f"{mod_path}: {type(linear).__name__} cannot add the "
                    "Dense's bias")
            linear.bias = mod.bias
        setattr(model.get_submodule(parent_path), child, linear)
    if unconsumed:
        # a quantized leaf with no Dense to serve it would otherwise
        # leave its module computing against a placeholder
        raise ValueError(
            "quantized kernels not served by a QuantizedLinear (module is "
            f"not a Dense?): {sorted(unconsumed)}")
    return dense_state


class QuantizedModel(nn.Module):
    """Model facade over a packed state: ``model(idx, cache=...)``,
    ``init_cache`` and ``config`` delegate to the wrapped model, whose
    quantized projections are :class:`QuantizedLinear` modules.

    ``model`` may be built on the ``meta`` device: every parameter comes
    from ``state`` (``{name: tensor | quantized leaf}``, see
    :func:`~llm_in_practise_tpu_torch.models.convert.params_from_jax`),
    moved to ``device`` (default: the card).
    """

    def __init__(self, model: nn.Module, state: dict, *,
                 compute_dtype=torch.bfloat16, device=None, mesh=None):
        super().__init__()
        if mesh is not None:
            raise NotImplementedError(
                "sharded (mesh) serving is not ported (ROADMAP.md queue A "
                "item 14)")
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        model.load_state(swap_quantized_linears(
            model, state, device,
            lambda w: QuantizedLinear(w, compute_dtype)))
        self.model = model

    @property
    def config(self):
        return self.model.config

    @property
    def device(self) -> torch.device:
        return self.model.device

    def init_cache(self, *args, **kwargs):
        return self.model.init_cache(*args, **kwargs)

    def head(self, x):
        return self.model.head(x)

    def forward(self, *args, **kwargs):
        return self.model(*args, **kwargs)
