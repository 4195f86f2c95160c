"""Packed quantized checkpoints, in the JAX package's format.

Port of ``llm_in_practise_tpu/quant/io.py:104-181``: one ``packed.npz``
with every component array plus a JSON ``manifest.json`` (format 2)
naming each leaf's type and static fields. :func:`save_packed` writes the
same array names and manifest as the JAX writer, for NF4, int4, AWQ and
int8 leaves and plain arrays; bf16 arrays are stored as their uint16 bits
and listed in ``bf16_arrays``. :func:`load_packed` reads with numpy only and
rebuilt as nested dicts of CPU torch tensors and the port's quantized
leaves (:class:`~.nf4.NF4Tensor`, :class:`~.int4.Int4Tensor`,
:class:`~.awq.AWQTensor`, :class:`~.int8.Int8Tensor`), ready for
:func:`llm_in_practise_tpu_torch.models.convert.params_from_jax`. A bf16
component inside a quantized leaf (format 2's ``bf16_arrays``) reads back
as bf16.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from llm_in_practise_tpu_torch.models.convert import flatten
from llm_in_practise_tpu_torch.quant.awq import AWQTensor
from llm_in_practise_tpu_torch.quant.int4 import Int4Tensor
from llm_in_practise_tpu_torch.quant.int8 import Int8Tensor
from llm_in_practise_tpu_torch.quant.nf4 import NF4Tensor

_MAX_MANIFEST_FORMAT = 2


def _bf16(raw: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(raw.view(np.uint16).copy()).view(torch.bfloat16)


def _rebuild_leaf(entry: dict, key: str, arrays: dict,
                  bf16_names: frozenset) -> object:
    def arr(name):
        full = f"{key}#{name}"
        if full in bf16_names:
            return _bf16(arrays[full])
        return torch.from_numpy(arrays[full].copy())

    kind = entry["type"]
    if kind == "nf4":
        scale, offset = arr("absmax_scale"), arr("absmax_offset")
        if scale.ndim == 1:   # one weight (a stacked leaf has one per layer)
            offset = offset.reshape(())
        return NF4Tensor(arr("packed"), arr("absmax_q"), scale, offset,
                         shape=tuple(entry["shape"]), layout=entry["layout"])
    if kind == "int4":
        return Int4Tensor(arr("packed"), arr("scales"), arr("zeros"),
                          group_size=entry["group_size"],
                          shape=tuple(entry["shape"]))
    if kind == "awq":
        return AWQTensor(
            _rebuild_leaf(entry["int4"], key, arrays, bf16_names),
            arr("inv_scale"))
    if kind == "int8":
        return Int8Tensor(arr("q"), arr("scale"), shape=tuple(entry["shape"]))
    if kind != "array":
        raise ValueError(f"{key}: unknown packed leaf type {kind!r}")
    if entry.get("dtype") == "bfloat16" or key in bf16_names:
        return _bf16(arrays[key])
    return torch.from_numpy(arrays[key].copy())


def _leaf_entries(key: str, leaf) -> tuple[dict, dict]:
    """(manifest entry, {array name: tensor}) for one tree leaf."""
    if isinstance(leaf, Int4Tensor):
        return ({"type": "int4", "group_size": leaf.group_size,
                 "shape": list(leaf.shape)},
                {f"{key}#packed": leaf.packed, f"{key}#scales": leaf.scales,
                 f"{key}#zeros": leaf.zeros})
    if isinstance(leaf, AWQTensor):
        inner, arrays = _leaf_entries(key, leaf.q)
        arrays[f"{key}#inv_scale"] = leaf.inv_scale
        return {"type": "awq", "int4": inner}, arrays
    if isinstance(leaf, NF4Tensor):
        return ({"type": "nf4", "shape": list(leaf.shape),
                 "layout": leaf.layout},
                {f"{key}#packed": leaf.packed,
                 f"{key}#absmax_q": leaf.absmax_q,
                 f"{key}#absmax_scale": leaf.absmax_scale,
                 f"{key}#absmax_offset": leaf.absmax_offset})
    if isinstance(leaf, Int8Tensor):
        return ({"type": "int8", "shape": list(leaf.shape)},
                {f"{key}#q": leaf.q, f"{key}#scale": leaf.scale})
    if leaf.dtype == torch.bfloat16:
        return {"type": "array", "dtype": "bfloat16"}, {key: leaf}
    return {"type": "array"}, {key: leaf}


def save_packed(out_dir: str, qtree: dict, *,
                metadata: dict | None = None) -> str:
    """Write a packed tree (nested dicts in the flax layout, e.g.
    :func:`~..models.convert.params_to_jax` of a quantized state; leaves
    on any device); returns the manifest path."""
    os.makedirs(out_dir, exist_ok=True)
    manifest: dict = {"format": 2, "leaves": {}, "metadata": metadata or {}}
    bf16_names: list[str] = []
    arrays: dict[str, np.ndarray] = {}
    for key, leaf in flatten(qtree).items():
        entry, leaf_arrays = _leaf_entries(key, leaf)
        manifest["leaves"][key] = entry
        for name, t in leaf_arrays.items():
            t = t.detach().to("cpu")
            if t.dtype == torch.bfloat16:
                arrays[name] = t.view(torch.int16).numpy().view(np.uint16)
                bf16_names.append(name)
            else:
                arrays[name] = t.numpy()
    manifest["bf16_arrays"] = bf16_names
    np.savez(os.path.join(out_dir, "packed.npz"), **arrays)
    mpath = os.path.join(out_dir, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
    return mpath


def load_packed(out_dir: str):
    """Read a packed tree back: ``(tree, metadata)``. Raises on manifest
    formats newer than this reader understands."""
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    fmt = int(manifest.get("format", 1))
    if fmt > _MAX_MANIFEST_FORMAT:
        raise ValueError(
            f"{out_dir}: packed manifest format {fmt} is newer than this "
            f"reader understands (<= {_MAX_MANIFEST_FORMAT})")
    with np.load(os.path.join(out_dir, "packed.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files}
    bf16_names = frozenset(manifest.get("bf16_arrays", ()))
    tree: dict = {}
    for key, entry in manifest["leaves"].items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _rebuild_leaf(entry, key, arrays, bf16_names)
    return tree, manifest["metadata"]
