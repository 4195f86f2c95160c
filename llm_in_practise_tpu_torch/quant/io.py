"""Read the packed quantized checkpoints the JAX package writes.

Port of ``llm_in_practise_tpu/quant/io.py:142-181`` (reading side): one
``packed.npz`` with every component array plus a JSON ``manifest.json``
naming each leaf's type and static fields. Read with numpy only and
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
        return NF4Tensor(arr("packed"), arr("absmax_q"), arr("absmax_scale"),
                         arr("absmax_offset").reshape(()),
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
