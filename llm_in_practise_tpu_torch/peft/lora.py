"""LoRA: low-rank adaptation over the port's flat state.

Port of ``llm_in_practise_tpu/peft/lora.py``. Factors live in their own
dict ``{port_name: {"a": (d_in, r), "b": (r, d_out)}}`` keyed by the
kernel they adapt; the effective kernel is ``W + (alpha/r) * A @ B``.
Target patterns are the JAX package's (regex or substring, e.g.
``q_proj`` or ``attn/(q_proj|v_proj)``) and match against the flax-style
path of each port name (:func:`~..models.convert.flax_path`), so LoRA
configs carry over unchanged.
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch

from llm_in_practise_tpu_torch.models.convert import flax_path


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """r/alpha/targets mirror the reference's LoraConfig surface."""

    r: int = 8
    alpha: float = 16.0
    dropout: float = 0.0  # reserved; rank-update form has no activation hook
    target_patterns: tuple[str, ...] = ("q_proj", "v_proj")

    @property
    def scaling(self) -> float:
        return self.alpha / self.r

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "LoRAConfig":
        d = dict(d)
        if "target_patterns" in d:
            d["target_patterns"] = tuple(d["target_patterns"])
        return cls(**d)


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape)


def target_paths(state: dict, cfg: LoRAConfig) -> list[str]:
    """Port names of the 2-D (or stacked 3-D) kernels whose flax path
    matches any target pattern, in the order of their flax paths (the
    JAX package's order)."""
    pats = [re.compile(p) for p in cfg.target_patterns]
    hits = []
    for name, leaf in state.items():
        path = flax_path(name)
        if len(_shape(leaf)) in (2, 3) and any(p.search(path) for p in pats):
            hits.append((path, name))
    return [name for _, name in sorted(hits)]


def init_lora(state: dict, cfg: LoRAConfig,
              generator: torch.Generator | None = None,
              dtype=torch.float32, *, device=None) -> dict[str, dict]:
    """LoRA factors ``{name: {"a", "b"}}``: ``a`` ~ N(0, 0.02), ``b`` zeros,
    so the adapted model is exactly the base model at step 0 (peft init
    parity). ``device`` defaults to the generator's (the CPU without
    one)."""
    paths = target_paths(state, cfg)
    if not paths:
        raise ValueError(
            f"no 2-D kernels match target_patterns={cfg.target_patterns}")
    if device is None:
        device = generator.device if generator is not None else "cpu"
    tree = {}
    for name in paths:
        *stack, d_in, d_out = _shape(state[name])
        a = torch.randn((*stack, d_in, cfg.r), generator=generator,
                        device=device, dtype=dtype) * 0.02
        tree[name] = {"a": a,
                      "b": torch.zeros((*stack, cfg.r, d_out), device=device,
                                       dtype=dtype)}
    return tree


def stack_lora_tree(lora: dict, n_layer: int) -> dict:
    """Unrolled LoRA tree -> one entry per target across the layers (JAX
    ``peft/lora.py::stack_lora_tree``): every ``blocks.{i}.<rest>`` entry
    stacks into one ``blocks.block.<rest>`` entry whose ``a`` and ``b``
    gain a leading ``n_layer`` axis; other entries pass through. A target
    must be present in every layer."""
    out: dict = {}
    grouped: dict[str, dict[int, dict]] = {}
    for name, ab in lora.items():
        m = re.match(r"blocks\.(\d+)\.(.*)", name)
        if not m:
            out[name] = ab
            continue
        grouped.setdefault(m.group(2), {})[int(m.group(1))] = ab
    for rest, by_layer in grouped.items():
        if sorted(by_layer) != list(range(n_layer)):
            raise ValueError(
                f"LoRA target {rest!r} present in layers "
                f"{sorted(by_layer)} but stacking needs all "
                f"{n_layer} — scan layers share one program, so every "
                "layer must carry the adapter")
        out[f"blocks.block.{rest}"] = {
            part: torch.stack([torch.as_tensor(by_layer[i][part])
                               for i in range(n_layer)])
            for part in ("a", "b")}
    return out


def apply_lora(state: dict, lora: dict, cfg: LoRAConfig) -> dict:
    """Effective state: target kernels become ``W + scaling * A @ B``;
    differentiable in the factors."""
    out = {}
    for name, leaf in state.items():
        ab = lora.get(name)
        if ab is None:
            out[name] = leaf
            continue
        delta = (ab["a"] @ ab["b"]) * cfg.scaling
        out[name] = leaf + delta.to(leaf.dtype)
    return out


def merge_lora(state: dict, lora: dict, cfg: LoRAConfig) -> dict:
    """``merge_and_unload()`` parity: the adapted weights, detached, on
    the device they were given on, for export or serving."""
    with torch.no_grad():
        return {n: t.detach() for n, t in apply_lora(state, lora, cfg).items()}


def count_params(tree) -> int:
    """Elements of every tensor in a (nested) dict; an NF4Tensor counts
    the parameters it stores."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return math.prod(_shape(tree))


def trainable_report(params: dict, lora: dict) -> str:
    """'trainable params: X || all params: Y || trainable%' -- parity with
    the reference's print_trainable_parameters check."""
    n_lora = count_params(lora)
    n_all = count_params(params) + n_lora
    return (
        f"trainable params: {n_lora:,} || all params: {n_all:,} || "
        f"trainable%: {100 * n_lora / n_all:.4f}"
    )
