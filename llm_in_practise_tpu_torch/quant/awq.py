"""AWQ-quantized kernels: int4 codes of ``W * s`` plus the fold-in scale.

Port of the format half of ``llm_in_practise_tpu/quant/awq.py``
(``AWQTensor``, ``decode``, ``dequantize_tree``). An AWQ kernel stores
the int4 codes of the channel-scaled weight ``W * s`` and
``inv_scale = 1 / s`` per input channel, so ``W ~ diag(inv_scale) @
decode(q)`` and a layer computes ``(x * inv_scale) @ decode(q)`` with
its calling convention unchanged. The scale search (``awq_quantize``,
``quantize_model_awq``) is not ported (ROADMAP.md queue A item 11).
"""

from __future__ import annotations

import dataclasses

import torch

from llm_in_practise_tpu_torch.quant import int4, int8
from llm_in_practise_tpu_torch.quant.int4 import Int4Tensor
from llm_in_practise_tpu_torch.quant.int8 import Int8Tensor


@dataclasses.dataclass
class AWQTensor:
    q: Int4Tensor
    inv_scale: torch.Tensor  # (in,) f32: multiplies the rows after decode

    @property
    def shape(self):
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.inv_scale.nbytes

    def to(self, device) -> "AWQTensor":
        return AWQTensor(self.q.to(device), self.inv_scale.to(device))


def decode(t: AWQTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (t.inv_scale[:, None] * int4.decode(t.q, torch.float32)).to(dtype)


def dequantize_tree(state: dict, dtype=torch.bfloat16) -> dict:
    """Materialize the AWQ, int4 and int8 leaves of a flat state."""
    def leaf(x):
        if isinstance(x, AWQTensor):
            return decode(x, dtype)
        if isinstance(x, Int4Tensor):
            return int4.decode(x, dtype)
        if isinstance(x, Int8Tensor):
            return int8.decode(x, dtype)
        return x

    return {name: leaf(v) for name, v in state.items()}
