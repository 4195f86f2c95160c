"""Weights carried across from the JAX package's flax param trees.

:func:`params_from_jax` takes a flax ``Qwen3`` param tree as nested dicts
(numpy arrays, torch tensors, or quantized leaves of the JAX package or
the port: NF4Tensor, Int4Tensor, AWQTensor and Int8Tensor, recognised by
their fields) and returns the port's flat state ``{name: tensor |
quantized leaf}``, byte for byte. Names map ``block_{i}/attn/q_proj/kernel`` to
``blocks.{i}.attn.q_proj.kernel`` and ``tok_embed/embedding`` to
``tok_embed.weight``; kernels keep their ``(in, out)`` layout.
:func:`lora_from_jax` carries a JAX LoRA tree across the same way.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from llm_in_practise_tpu_torch.quant.awq import AWQTensor
from llm_in_practise_tpu_torch.quant.int4 import Int4Tensor
from llm_in_practise_tpu_torch.quant.int8 import Int8Tensor
from llm_in_practise_tpu_torch.quant.nf4 import NF4Tensor


def to_tensor(a) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) or torch -> CPU torch tensor."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _has(leaf, *fields) -> bool:
    return all(hasattr(leaf, f) for f in fields)


def nf4_from_like(leaf) -> NF4Tensor:
    return NF4Tensor(
        to_tensor(leaf.packed), to_tensor(leaf.absmax_q),
        to_tensor(leaf.absmax_scale),
        to_tensor(leaf.absmax_offset).reshape(()),
        tuple(int(s) for s in leaf.shape), str(leaf.layout))


def int4_from_like(leaf) -> Int4Tensor:
    return Int4Tensor(
        to_tensor(leaf.packed), to_tensor(leaf.scales), to_tensor(leaf.zeros),
        int(leaf.group_size), tuple(int(s) for s in leaf.shape))


def quant_from_like(leaf):
    """A quantized leaf of either package as the port's leaf, byte for
    byte; None for a plain array."""
    if _has(leaf, "packed", "absmax_q", "absmax_scale", "absmax_offset",
            "shape", "layout"):
        return nf4_from_like(leaf)
    if _has(leaf, "q", "inv_scale"):
        return AWQTensor(int4_from_like(leaf.q), to_tensor(leaf.inv_scale))
    if _has(leaf, "packed", "scales", "zeros", "group_size", "shape"):
        return int4_from_like(leaf)
    if _has(leaf, "q", "scale", "shape"):
        return Int8Tensor(to_tensor(leaf.q), to_tensor(leaf.scale),
                          tuple(int(s) for s in leaf.shape))
    return None


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """Nested dicts -> ``{"a/b/c": leaf}`` (non-dict values are leaves)."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(flatten(value, path))
        else:
            out[path] = value
    return out


def port_name(flax_path: str) -> str:
    parts = flax_path.split("/")
    if parts[0].startswith("block_"):
        parts = ["blocks", parts[0][len("block_"):], *parts[1:]]
    if parts == ["tok_embed", "embedding"]:
        parts = ["tok_embed", "weight"]
    return ".".join(parts)


def flax_path(name: str) -> str:
    """The inverse of :func:`port_name`: ``blocks.3.attn.q_proj.kernel``
    -> ``block_3/attn/q_proj/kernel``. LoRA target patterns written for
    the JAX package match against this form."""
    parts = name.split(".")
    if parts == ["tok_embed", "weight"]:
        return "tok_embed/embedding"
    if parts[0] == "blocks":
        parts = [f"block_{parts[1]}", *parts[2:]]
    return "/".join(parts)


def expected_names(cfg) -> set[str]:
    names = {"tok_embed.weight", "ln_f.scale"}
    if not cfg.tie_word_embeddings:
        names.add("lm_head.kernel")
    for i in range(cfg.n_layer):
        p = f"blocks.{i}"
        names |= {f"{p}.ln1.scale", f"{p}.ln2.scale",
                  f"{p}.attn.q_norm.scale", f"{p}.attn.k_norm.scale"}
        names |= {f"{p}.attn.{n}.kernel"
                  for n in ("q_proj", "k_proj", "v_proj", "out_proj")}
        names |= {f"{p}.mlp.{n}.kernel"
                  for n in ("gate_proj", "up_proj", "down_proj")}
    return names


def params_from_jax(tree: Mapping, cfg) -> dict:
    """Flax Qwen3 param tree -> the port's state (see module doc)."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    if "blocks" in tree and not any(k.startswith("block_") for k in tree):
        raise NotImplementedError(
            "stacked scan-layers trees are not ported; unstack them with "
            "the JAX package's unstack_layer_params first")
    state = {}
    for path, leaf in flatten(tree).items():
        quant = quant_from_like(leaf)
        state[port_name(path)] = quant if quant is not None else to_tensor(
            leaf)
    want = expected_names(cfg)
    unknown, missing = sorted(set(state) - want), sorted(want - set(state))
    if unknown or missing:
        raise ValueError(
            f"param tree does not match the config: unknown {unknown[:8]}, "
            f"missing {missing[:8]}")
    return state


def lora_from_jax(tree: Mapping, cfg) -> dict:
    """A JAX LoRA tree ``{"block_i/attn/q_proj/kernel": {"a", "b"}}``
    (numpy or torch leaves) -> the port's ``{port_name: {"a", "b"}}``,
    byte for byte. Every key must name a kernel of ``cfg``'s model."""
    want = expected_names(cfg)
    out = {}
    for path, ab in tree.items():
        name = port_name(path)
        if name not in want or not name.endswith(".kernel"):
            raise ValueError(f"LoRA entry {path!r} names no kernel of the "
                             "model")
        if set(ab) != {"a", "b"}:
            raise ValueError(f"LoRA entry {path!r} must hold 'a' and 'b'")
        out[name] = {"a": to_tensor(ab["a"]), "b": to_tensor(ab["b"])}
    return out
