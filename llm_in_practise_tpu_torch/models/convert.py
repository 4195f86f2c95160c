"""Weights carried across from the JAX package's flax param trees.

:func:`params_from_jax` takes a flax ``Qwen3`` param tree as nested dicts
(numpy arrays, torch tensors, or quantized leaves of the JAX package or
the port: NF4Tensor, Int4Tensor, AWQTensor and Int8Tensor, recognised by
their fields) and returns the port's flat state ``{name: tensor |
quantized leaf}``, byte for byte. Names map ``block_{i}/attn/q_proj/kernel`` to
``blocks.{i}.attn.q_proj.kernel`` and ``tok_embed/embedding`` to
``tok_embed.weight``; kernels keep their ``(in, out)`` layout.
:func:`lora_from_jax` carries a JAX LoRA tree across the same way. A
stacked scan-layout tree (``blocks/block/...`` leaves with a leading
``n_layer`` axis, JAX ``models/qwen3.py:307``) is unstacked on the way
(:func:`unstack_layer_params`): the port runs the unrolled blocks.
:func:`params_to_jax` and :func:`lora_to_jax` are the inverse carriers,
whose trees the JAX package's ``restore_checkpoint``, ``merge_lora`` and
``Qwen3.apply`` take unchanged. :func:`gpt_params_from_jax` and
:func:`gpt_params_to_jax` carry a flax ``GPT`` tree (dense or packed) the
same way: ``pos_embed`` keeps its name, every projection and norm has a
``bias`` beside its ``kernel`` or ``scale``.
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
    scale = to_tensor(leaf.absmax_scale)
    offset = to_tensor(leaf.absmax_offset)
    if scale.ndim == 1:   # one weight (a stacked leaf has one per layer)
        offset = offset.reshape(())
    return NF4Tensor(
        to_tensor(leaf.packed), to_tensor(leaf.absmax_q), scale, offset,
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


def _layer(leaf, i: int):
    """Layer ``i`` of a stacked leaf: every component sliced along axis 0.
    A quantized leaf's ``shape`` drops its layer axis when it has one
    (quantized after stacking keeps the per-layer shape)."""
    if isinstance(leaf, torch.Tensor):
        return leaf[i]
    if isinstance(leaf, AWQTensor):
        return AWQTensor(_layer(leaf.q, i), leaf.inv_scale[i])
    if isinstance(leaf, NF4Tensor):
        if leaf.absmax_scale.ndim != 2:
            raise ValueError(
                "an NF4 leaf quantized over the stacked axis has no layer "
                "boundaries; quantize each layer, then stack")
        parts = (leaf.packed, leaf.absmax_q, leaf.absmax_scale,
                 leaf.absmax_offset)
        return NF4Tensor(*(p[i] for p in parts), leaf.shape, leaf.layout)
    if isinstance(leaf, Int4Tensor):
        shape = leaf.shape[1:] if len(leaf.shape) == 3 else leaf.shape
        return Int4Tensor(leaf.packed[i], leaf.scales[i], leaf.zeros[i],
                          leaf.group_size, tuple(shape))
    if isinstance(leaf, Int8Tensor):
        shape = leaf.shape[1:] if len(leaf.shape) == 3 else leaf.shape
        return Int8Tensor(leaf.q[i], leaf.scale[i], tuple(shape))
    raise TypeError(f"cannot unstack a {type(leaf).__name__}")


def unstack_layer_params(flat: dict, n_layer: int) -> dict:
    """Flat ``{"a/b/c": leaf}`` tree in the scan layout -> the unrolled
    layout (JAX ``models/qwen3.py:349``): each ``blocks/block/<rest>``
    leaf becomes ``block_{i}/<rest>`` for every layer; other entries pass
    through. Leaves are the port's (tensors and quantized leaves)."""
    out, stacked = {}, {}
    for path, leaf in flat.items():
        if path.startswith("blocks/block/"):
            stacked[path[len("blocks/block/"):]] = leaf
        else:
            out[path] = leaf
    for i in range(n_layer):
        for rest, leaf in stacked.items():
            out[f"block_{i}/{rest}"] = _layer(leaf, i)
    return out


def params_from_jax(tree: Mapping, cfg) -> dict:
    """Flax Qwen3 param tree, unrolled or stacked -> the port's state (see
    module doc)."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    flat = {path: quant_from_like(leaf) or to_tensor(leaf)
            for path, leaf in flatten(tree).items()}
    flat = unstack_layer_params(flat, cfg.n_layer)
    state = {port_name(path): leaf for path, leaf in flat.items()}
    _check_names(state, expected_names(cfg), "param tree")
    return state


def lora_from_jax(tree: Mapping, cfg) -> dict:
    """A JAX LoRA tree ``{"block_i/attn/q_proj/kernel": {"a", "b"}}``
    (numpy or torch leaves) -> the port's ``{port_name: {"a", "b"}}``,
    byte for byte. An adapter trained in the scan layout
    (``blocks/block/...`` keys, ``a`` and ``b`` stacked over layers, JAX
    ``peft/lora.py:85-87``) is unstacked. Every key must name a kernel of
    ``cfg``'s model."""
    flat = {}
    for path, ab in tree.items():
        if set(ab) != {"a", "b"}:
            raise ValueError(f"LoRA entry {path!r} must hold 'a' and 'b'")
        flat[f"{path}/a"] = to_tensor(ab["a"])
        flat[f"{path}/b"] = to_tensor(ab["b"])
    flat = unstack_layer_params(flat, cfg.n_layer)
    want = expected_names(cfg)
    out = {}
    for path, t in flat.items():
        kernel, _, part = path.rpartition("/")
        name = port_name(kernel)
        if name not in want or not name.endswith(".kernel"):
            raise ValueError(f"LoRA entry {kernel!r} names no kernel of the "
                             "model")
        out.setdefault(name, {})[part] = t
    return out


def params_to_jax(state: Mapping, cfg) -> dict:
    """The port's state -> a flax Qwen3 param tree (nested dicts,
    ``block_i/attn/q_proj/kernel``), leaves passed through as they are
    (tensors on any device, or quantized leaves)."""
    return _nest(state, expected_names(cfg))


def _nest(state: Mapping, names: set[str]) -> dict:
    """The port's state -> nested dicts under flax paths; every name must
    be one of ``names``."""
    unknown = sorted(set(state) - names)
    if unknown:
        raise ValueError(f"state names no parameter of the config: "
                         f"{unknown[:8]}")
    tree: dict = {}
    for name, leaf in state.items():
        *parents, last = flax_path(name).split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def lora_to_jax(lora: Mapping) -> dict:
    """The port's ``{port_name: {"a", "b"}}`` -> the JAX LoRA tree
    ``{"block_i/attn/q_proj/kernel": {"a", "b"}}`` (detached tensors)."""
    return {flax_path(name): {"a": ab["a"].detach(), "b": ab["b"].detach()}
            for name, ab in lora.items()}


def _check_names(state: Mapping, want: set[str], what: str) -> None:
    unknown, missing = sorted(set(state) - want), sorted(want - set(state))
    if unknown or missing:
        raise ValueError(
            f"{what} does not match the config: unknown {unknown[:8]}, "
            f"missing {missing[:8]}")


def gpt_params_from_jax(tree: Mapping, cfg) -> dict:
    """Flax GPT param tree (numpy or torch leaves, or quantized leaves of
    either package) -> the port's :class:`~.gpt.GPT` state, byte for
    byte. Raises unless the names are exactly those of ``cfg``'s model."""
    from llm_in_practise_tpu_torch.models.gpt import expected_names as names

    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    state = {port_name(path): quant_from_like(leaf) or to_tensor(leaf)
             for path, leaf in flatten(tree).items()}
    _check_names(state, names(cfg), "param tree")
    return state


def gpt_params_to_jax(state: Mapping, cfg) -> dict:
    """The port's GPT state -> a flax GPT param tree (nested dicts),
    leaves passed through as they are; the JAX package's
    ``restore_checkpoint``, ``GPT.apply`` and ``QuantizedModel`` take it
    unchanged."""
    from llm_in_practise_tpu_torch.models.gpt import expected_names as names

    return _nest(state, names(cfg))
