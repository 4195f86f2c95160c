"""QLoRA: NF4-quantized frozen base + trainable LoRA factors.

Port of ``llm_in_practise_tpu/peft/qlora.py:22-57, 112, 205-211``: which
kernels quantize, into which format, and the memory report. The base is
stored as NF4 and streamed through the kernels (:mod:`.fused`); only the
LoRA factors train. int8 is the W8A16 serving format of
``convert_hf --quantization int8``.

The JAX package's ``quantize_base_lowmem`` exists because one jitted
program over the whole tree keeps every leaf's temporaries live at once
on a 16 GiB TPU. Eager PyTorch quantizes leaf by leaf on the leaf's own
device and frees each leaf's temporaries before the next, so
:func:`quantize_base` is that function; a caller that hands over its
leaves one at a time (``convert_hf``) frees each bf16 leaf as its packed
leaf lands.
"""

from __future__ import annotations

from llm_in_practise_tpu_torch.quant import int8, nf4

_QUANTIZE_TREE = {"nf4": nf4.quantize_tree, "int8": int8.quantize_tree}


def _quant_predicate(name: str, leaf, min_size: int) -> bool:
    """Dense kernels (2-D, or 3-D stacked) of ``min_size``+ elements;
    norms, the embedding and the LM head stay unquantized (bitsandbytes
    and the reference's ``ignore=["lm_head"]``)."""
    if not name.endswith(".kernel"):
        return False
    if getattr(leaf, "ndim", 0) not in (2, 3) or leaf.numel() < min_size:
        return False
    return "embed" not in name and "lm_head" not in name


def quantize_base(state: dict, *, min_size: int = 4096,
                  fmt: str = "nf4") -> dict:
    """Quantize the Dense kernels of a flat state (see
    :func:`_quant_predicate`) to ``fmt`` (``"nf4"``, the QLoRA base, or
    ``"int8"``, the W8A16 serving format), leaf by leaf on each leaf's
    device; everything else passes through."""
    if fmt not in _QUANTIZE_TREE:
        raise ValueError(f"fmt must be one of {sorted(_QUANTIZE_TREE)}, got "
                         f"{fmt!r}")
    return _QUANTIZE_TREE[fmt](
        state, lambda n, leaf: _quant_predicate(n, leaf, min_size))


def memory_report(params: dict, qparams: dict) -> str:
    full = nf4.tree_nbytes(params)
    quant = nf4.tree_nbytes(qparams)
    return (
        f"base {full / 2**20:.1f} MiB -> NF4 {quant / 2**20:.1f} MiB "
        f"({full / max(quant, 1):.2f}x smaller)"
    )
