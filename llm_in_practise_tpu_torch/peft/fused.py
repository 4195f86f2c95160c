"""Fused QLoRA training: a quantized base streamed through Hopper kernels.

Port of the training half of ``llm_in_practise_tpu/peft/fused.py``
(``qlora_fused_apply`` with ``use_kernels=True``). Where the JAX package
intercepts flax ``Dense`` calls, the port swaps modules, as
``serve/quantized.py`` does
(:func:`~..serve.quantized.swap_quantized_linears`): every
:class:`~..models.qwen3.Dense` whose kernel is a quantized leaf (NF4, or a
PTQ export's int4, AWQ or int8) becomes a :class:`QLoRALinear`, the
serving :class:`~..serve.quantized.QuantizedLinear` plus the LoRA delta,
computing

    ``y = fused_kernel_matmul(x, W_q) + (x @ A) @ B * (alpha / r)``

so the packed weight goes straight into the forward kernel and, in the
backward, into the dx kernel of its format (``NF4Matmul``,
``Int4Matmul``, ``Int8Matmul``); the bf16 base never exists in device
memory in either direction. A LoRA
target whose kernel stays unquantized becomes a :class:`LoRADense`. Only
the LoRA factors require grad; a quantized leaf that no Dense consumes
raises.

The JAX training builders default to ``use_kernels=False`` because XLA
fuses a plain dequant into the consuming matmul on a v5e; eager PyTorch
fuses nothing, so the port's training path always runs the kernels.
"""

from __future__ import annotations

import torch
from torch import nn

from llm_in_practise_tpu_torch.core.device import resolve_device
from llm_in_practise_tpu_torch.models.qwen3 import Dense
from llm_in_practise_tpu_torch.peft.lora import LoRAConfig
from llm_in_practise_tpu_torch.serve.quantized import (
    QuantizedLinear,
    swap_quantized_linears,
)


def _lora_delta(x, a, b, scaling, compute_dtype):
    return (x.to(compute_dtype) @ a.to(compute_dtype)) @ b.to(
        compute_dtype) * scaling


class QLoRALinear(QuantizedLinear):
    """A :class:`QuantizedLinear` plus, once :meth:`attach` gives it factors,
    ``(x @ A) @ B * scaling``, added in ``compute_dtype`` as the JAX
    interceptor adds it."""

    def __init__(self, weight, compute_dtype: torch.dtype):
        super().__init__(weight, compute_dtype)
        self.a: nn.Parameter | None = None
        self.b: nn.Parameter | None = None
        self.scaling = 0.0

    def attach(self, a: nn.Parameter, b: nn.Parameter, scaling: float):
        self.a, self.b, self.scaling = a, b, scaling

    def project(self, xc: torch.Tensor) -> torch.Tensor:
        y = super().project(xc)
        if self.a is None:
            return y
        return y + _lora_delta(xc, self.a, self.b, self.scaling,
                               self.compute_dtype)

    def extra_repr(self) -> str:
        return f"{super().extra_repr()}, lora={self.a is not None}"


class LoRADense(nn.Module):
    """An unquantized :class:`Dense` plus its LoRA delta (the JAX
    interceptor's unquantized-target branch)."""

    def __init__(self, dense: Dense, a: nn.Parameter, b: nn.Parameter,
                 scaling: float, compute_dtype: torch.dtype):
        super().__init__()
        self.dense = dense
        self.a, self.b = a, b
        self.scaling = scaling
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dense(x)
        delta = _lora_delta(x, self.a, self.b, self.scaling,
                            self.compute_dtype)
        return (y + delta).to(y.dtype)


class QLoRAModel(nn.Module):
    """A frozen (partly quantized) base with trainable LoRA factors.

    ``model`` may be built on the ``meta`` device: every base parameter
    comes from ``state`` (``{name: tensor | quantized leaf}``, e.g. from
    :func:`~.qlora.quantize_base`), moved to ``device`` (default: the
    card). ``lora`` is :func:`~.lora.init_lora`'s dict; its factors become
    the only parameters that require grad (:meth:`lora_state` returns
    them). ``model(idx, ...)``, ``config``, ``device`` and ``head``
    delegate to the wrapped model.
    """

    def __init__(self, model: nn.Module, state: dict, lora: dict,
                 cfg: LoRAConfig, *, compute_dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.lora_cfg = cfg
        model.load_state(swap_quantized_linears(
            model, state, device, lambda w: QLoRALinear(w, compute_dtype)))
        for p in model.parameters():
            p.requires_grad_(False)

        self._lora: dict[str, dict[str, nn.Parameter]] = {}
        for name, ab in lora.items():
            mod_path, _, attr = name.rpartition(".")
            mod = model.get_submodule(mod_path)
            a = nn.Parameter(ab["a"].detach().to(device).clone())
            b = nn.Parameter(ab["b"].detach().to(device).clone())
            if attr == "kernel" and isinstance(mod, QLoRALinear):
                mod.attach(a, b, cfg.scaling)
            elif attr == "kernel" and isinstance(mod, Dense):
                parent_path, _, child = mod_path.rpartition(".")
                setattr(model.get_submodule(parent_path), child,
                        LoRADense(mod, a, b, cfg.scaling, compute_dtype))
            else:
                raise ValueError(f"LoRA entry {name!r} names no Dense kernel")
            self._lora[name] = {"a": a, "b": b}
        self.model = model

    def lora_state(self) -> dict[str, dict[str, nn.Parameter]]:
        """The trainable factors, ``{name: {"a", "b"}}`` (live Parameters)."""
        return self._lora

    def lora_parameters(self) -> list[nn.Parameter]:
        return [ab[k] for _, ab in sorted(self._lora.items())
                for k in ("a", "b")]

    @property
    def config(self):
        return self.model.config

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def tok_embed(self):
        return self.model.tok_embed

    @property
    def lm_head(self):
        return self.model.lm_head

    def head(self, x):
        return self.model.head(x)

    def forward(self, *args, **kwargs):
        return self.model(*args, **kwargs)
