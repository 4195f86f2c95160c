"""QLoRA: NF4-quantized frozen base + trainable LoRA factors.

Port of ``llm_in_practise_tpu/peft/qlora.py``: which kernels quantize,
into which format (NF4; int8, the W8A16 serving format of ``convert_hf
--quantization int8``; the ``"mixed"`` serving split; or a per-name
choice), the memory report, and the materialized-dequant path. The
training CLI streams the NF4 base through the kernels (:mod:`.fused`);
:func:`qlora_apply` instead materializes the dequantized base and adds
the LoRA delta, differentiable in the factors only, as the JAX
package's recipe SFT does (``examples/sft_recipe.py``).

The JAX package's ``quantize_base_lowmem`` exists because one jitted
program over the whole tree keeps every leaf's temporaries live at once
on a 16 GiB TPU. Eager PyTorch quantizes leaf by leaf on the leaf's own
device and frees each leaf's temporaries before the next, so
:func:`quantize_base` is that function; a caller that hands over its
leaves one at a time (``convert_hf``) frees each bf16 leaf as its packed
leaf lands. Its ``"mixed"`` and callable formats are
:func:`quantize_base`'s too; its ``cast_rest_above`` (an f32 leaf above a
million elements, the embedding, cast to bf16) is not: a leaf keeps the
dtype it came in.
"""

from __future__ import annotations

from typing import Callable

import torch

from llm_in_practise_tpu_torch.peft import lora as lora_lib
from llm_in_practise_tpu_torch.quant import int8, nf4

_QUANTIZERS = {"nf4": nf4.quantize, "int8": int8.quantize}


def _quant_predicate(name: str, leaf, min_size: int) -> bool:
    """Dense kernels (2-D, or 3-D stacked) of ``min_size``+ elements;
    norms, the embedding and the LM head stay unquantized (bitsandbytes
    and the reference's ``ignore=["lm_head"]``)."""
    if not name.endswith(".kernel"):
        return False
    if getattr(leaf, "ndim", 0) not in (2, 3) or leaf.numel() < min_size:
        return False
    return "embed" not in name and "lm_head" not in name


def mixed_serve_fmt(name: str) -> str:
    """Format of a leaf under the ``"mixed"`` serving preset: **int8 MLP
    + NF4 attention** (the MLP holds most of a layer's bytes, so int8's
    size is paid only where its decode rate pays most). Matches the port
    name's ``.mlp.`` where the JAX package matches ``/mlp/``."""
    return "int8" if ".mlp." in name else "nf4"


def _quantizer(fmt_name: str):
    if fmt_name not in _QUANTIZERS:
        raise ValueError(f"fmt must be one of {sorted(_QUANTIZERS)}, got "
                         f"{fmt_name!r}")
    return _QUANTIZERS[fmt_name]


def _resolve_fmt(fmt) -> Callable:
    """``fmt`` -> ``name -> quantizer``: a format name, the ``"mixed"``
    preset, or a callable ``name -> format name``."""
    if callable(fmt):
        return lambda name: _quantizer(fmt(name))
    if fmt == "mixed":
        return lambda name: _quantizer(mixed_serve_fmt(name))
    quantize = _quantizer(fmt)
    return lambda name: quantize


def quantize_base(state: dict, *, min_size: int = 4096,
                  fmt: str | Callable[[str], str] = "nf4") -> dict:
    """Quantize the Dense kernels of a flat state (see
    :func:`_quant_predicate`) leaf by leaf on each leaf's device;
    everything else passes through. ``fmt``: ``"nf4"`` (the QLoRA base),
    ``"int8"`` (the W8A16 serving format), ``"mixed"``
    (:func:`mixed_serve_fmt`) or a callable ``port name -> format``."""
    pick = _resolve_fmt(fmt)
    return {name: pick(name)(leaf) if _quant_predicate(name, leaf, min_size)
            else leaf for name, leaf in state.items()}


def qlora_apply(qstate: dict, lora: dict, cfg: lora_lib.LoRAConfig,
                dtype=torch.bfloat16) -> dict:
    """The effective state from an NF4 base and LoRA factors: every NF4
    leaf dequantized to ``dtype``, every target kernel plus
    ``scaling * A @ B``. Differentiable in the factors only (the NF4
    leaves are uint8 constants)."""
    return lora_lib.apply_lora(nf4.dequantize_tree(qstate, dtype), lora, cfg)


def make_qlora_loss_fn(qstate: dict, cfg: lora_lib.LoRAConfig,
                       base_loss_fn, dtype=torch.bfloat16):
    """Wrap ``base_loss_fn(state, batch, generator)`` into a loss over the
    LoRA factors only: ``loss(lora, batch, generator)``, closing over the
    NF4 base."""
    def loss_fn(lora, batch, generator=None):
        return base_loss_fn(qlora_apply(qstate, lora, cfg, dtype), batch,
                            generator)

    return loss_fn


def make_qlora_loss_fn_args(cfg: lora_lib.LoRAConfig, base_loss_fn,
                            dtype=torch.bfloat16):
    """As :func:`make_qlora_loss_fn` with the base as an argument:
    ``loss(lora, qstate, batch, generator)`` (the JAX package passes it
    so that a compiled program does not carry the base as constants;
    eager PyTorch has no program, and keeps the signature)."""
    def loss_fn(lora, qstate, batch, generator=None):
        return base_loss_fn(qlora_apply(qstate, lora, cfg, dtype), batch,
                            generator)

    return loss_fn


def memory_report(params: dict, qparams: dict) -> str:
    full = nf4.tree_nbytes(params)
    quant = nf4.tree_nbytes(qparams)
    return (
        f"base {full / 2**20:.1f} MiB -> NF4 {quant / 2**20:.1f} MiB "
        f"({full / max(quant, 1):.2f}x smaller)"
    )
