"""Serving packed NF4 weights: every quantized projection runs the kernel.

Port of ``llm_in_practise_tpu/serve/quantized.py`` with the serving half
of ``peft/fused.py:56-77, 225-233``. Where the JAX package intercepts
flax ``Dense`` calls, the port swaps modules: each :class:`Dense` whose
kernel in the state is an :class:`NF4Tensor` becomes an :class:`NF4Linear`
that calls :func:`~llm_in_practise_tpu_torch.ops.nf4_matmul.nf4_matmul`,
so the bf16 weight never exists in device memory. A quantized leaf that
no ``Dense`` consumes raises.
"""

from __future__ import annotations

import torch
from torch import nn

from llm_in_practise_tpu_torch.core.device import resolve_device
from llm_in_practise_tpu_torch.models.qwen3 import Dense
from llm_in_practise_tpu_torch.ops.nf4_matmul import nf4_matmul
from llm_in_practise_tpu_torch.quant.nf4 import NF4Tensor


class NF4Linear(nn.Module):
    """``y = nf4_matmul(x.to(compute), W, compute)``, back in x's dtype."""

    def __init__(self, weight: NF4Tensor, compute_dtype: torch.dtype):
        super().__init__()
        self.weight = weight
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = nf4_matmul(x.to(self.compute_dtype), self.weight,
                       self.compute_dtype)
        return y if y.dtype == x.dtype else y.to(x.dtype)

    def extra_repr(self) -> str:
        return f"shape={self.weight.shape}, layout={self.weight.layout}"


class QuantizedModel(nn.Module):
    """Model facade over a packed state: ``model(idx, cache=...)``,
    ``init_cache`` and ``config`` delegate to the wrapped model, whose
    quantized projections are :class:`NF4Linear` modules.

    ``model`` may be built on the ``meta`` device: every parameter comes
    from ``state`` (``{name: tensor | NF4Tensor}``, see
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
        dense_state, unconsumed = {}, []
        for name, value in state.items():
            if not isinstance(value, NF4Tensor):
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
            parent = model.get_submodule(parent_path)
            setattr(parent, child, NF4Linear(value.to(device), compute_dtype))
        if unconsumed:
            # a quantized leaf with no Dense to serve it would otherwise
            # leave its module computing against a placeholder
            raise ValueError(
                "quantized kernels not served by an NF4Linear (module is "
                f"not a Dense?): {sorted(unconsumed)}")
        model.load_state(dense_state)
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
