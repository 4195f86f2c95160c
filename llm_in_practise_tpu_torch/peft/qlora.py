"""QLoRA: NF4-quantized frozen base + trainable LoRA factors.

Port of ``llm_in_practise_tpu/peft/qlora.py:22-40, 205-211``: which
kernels quantize, and the memory report. The base is stored as NF4 and
streamed through the kernels (:mod:`.fused`); only the LoRA factors
train.
"""

from __future__ import annotations

from llm_in_practise_tpu_torch.quant import nf4


def _quant_predicate(name: str, leaf, min_size: int) -> bool:
    """Dense kernels (2-D, or 3-D stacked) of ``min_size``+ elements;
    norms, the embedding and the LM head stay unquantized (bitsandbytes
    and the reference's ``ignore=["lm_head"]``)."""
    if not name.endswith(".kernel"):
        return False
    if getattr(leaf, "ndim", 0) not in (2, 3) or leaf.numel() < min_size:
        return False
    return "embed" not in name and "lm_head" not in name


def quantize_base(state: dict, *, min_size: int = 4096) -> dict:
    """NF4-quantize the Dense kernels of a flat state (see
    :func:`_quant_predicate`); everything else passes through."""
    return nf4.quantize_tree(
        state, lambda n, leaf: _quant_predicate(n, leaf, min_size))


def memory_report(params: dict, qparams: dict) -> str:
    full = nf4.tree_nbytes(params)
    quant = nf4.tree_nbytes(qparams)
    return (
        f"base {full / 2**20:.1f} MiB -> NF4 {quant / 2**20:.1f} MiB "
        f"({full / max(quant, 1):.2f}x smaller)"
    )
