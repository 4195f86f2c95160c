"""Checkpoint save/restore in flax's msgpack format, without flax.

Port of ``llm_in_practise_tpu/ckpt/checkpoint.py:41-127``: the same file
names (``{prefix}_{step:08d}.msgpack`` plus a ``.json`` metadata sidecar,
or ``{name}.msgpack`` for an unrotated named checkpoint), the same atomic
``.tmp`` + ``os.replace`` write and keep-last-N rotation, and the same
bytes as ``flax.serialization.to_bytes`` of the same tree:

- a tree is nested dicts with string keys, written in insertion order
  (``save_checkpoint`` and ``save_named`` first sort every dict's keys,
  as the JAX package's ``jax.tree_util.tree_map`` over the tree does);
- an array leaf (torch tensor on any device, or numpy array) is msgpack
  ext type 1 holding ``packb((shape, dtype_name, raw_bytes))``; bf16 is
  named ``bfloat16``; a numpy scalar is ext type 3 with the same body;
- an array above ``MAX_CHUNK_SIZE`` bytes is written as flax's chunked
  map ``{"__msgpack_chunked_array__": True, "shape": {"0": ...},
  "chunks": {"0": ..., ...}}`` of flat pieces, and read back whole.

The writer streams leaf by leaf (one leaf on the host at a time, its
bytes written straight from its buffer) and the reader streams the file,
so the host never holds the whole file and the whole tree at once.
:func:`restore_checkpoint` returns nested dicts of CPU torch tensors.

The JAX package writes only on the coordinator process
(``dist.is_coordinator()``); the port runs one process (multi-process
training is ROADMAP.md queue A item 14), so every call writes.
"""

from __future__ import annotations

import json
import math
import os
import re
import struct
from collections.abc import Mapping

import msgpack
import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: msgpack holds at most 2**31 - 1
# bytes in one object, so larger arrays are split into pieces of this size
MAX_CHUNK_SIZE = 2**30

_NDARRAY, _NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"
_CKPT_RE = re.compile(r"^(?P<prefix>.+)_(?P<step>\d{8})\.msgpack$")

_DTYPE_NAMES = {
    torch.float32: "float32", torch.bfloat16: "bfloat16",
    torch.float16: "float16", torch.float64: "float64",
    torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.bool: "bool",
}
_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


def _host_bytes(x) -> tuple[tuple[int, ...], str, memoryview]:
    """(shape, dtype name, C-order bytes) of a tensor or ndarray leaf,
    brought to the host."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        if t.dtype not in _DTYPE_NAMES:
            raise ValueError(f"unsupported leaf dtype {t.dtype}")
        raw = t.reshape(-1).view(torch.uint8).numpy()
        return tuple(t.shape), _DTYPE_NAMES[t.dtype], memoryview(raw)
    arr = np.asarray(x)
    if not arr.flags.c_contiguous:   # (ascontiguousarray makes 0-d 1-d)
        arr = arr.copy(order="C")
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be saved")
    return (arr.shape, arr.dtype.name,
            memoryview(arr.reshape(-1).view(np.uint8)))


def _ext_header(code: int, n: int) -> bytes:
    """msgpack's header for an ext object of ``n`` bytes (the packer's
    own choice of fixext / ext8 / ext16 / ext32)."""
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return struct.pack(">Bb", fixed[n], code)
    if n < 2**8:
        return struct.pack(">BBb", 0xC7, n, code)
    if n < 2**16:
        return struct.pack(">BHb", 0xC8, n, code)
    return struct.pack(">BIb", 0xC9, n, code)


def _bin_header(n: int) -> bytes:
    if n < 2**8:
        return struct.pack(">BB", 0xC4, n)
    if n < 2**16:
        return struct.pack(">BH", 0xC5, n)
    return struct.pack(">BI", 0xC6, n)


def _write_array(f, code: int, shape, name: str, raw: memoryview) -> None:
    # the ext body is packb((shape, name, raw)): a 3-array header, the
    # shape, the name and a bin header, then the raw bytes as they lie
    head = (b"\x93" + msgpack.packb(list(shape)) + msgpack.packb(name)
            + _bin_header(raw.nbytes))
    f.write(_ext_header(code, len(head) + raw.nbytes))
    f.write(head)
    f.write(raw)


def _write_leaf(f, packer, value) -> None:
    if isinstance(value, np.generic):
        _write_array(f, _NPSCALAR, *_host_bytes(np.asarray(value)))
        return
    if not isinstance(value, (torch.Tensor, np.ndarray)):
        f.write(packer.pack(value))   # str, int, float, bool, None
        return
    shape, name, raw = _host_bytes(value)
    if raw.nbytes <= MAX_CHUNK_SIZE:
        _write_array(f, _NDARRAY, shape, name, raw)
        return
    itemsize = raw.nbytes // math.prod(shape)
    step = max(1, MAX_CHUNK_SIZE // itemsize) * itemsize
    n_chunks = -(-raw.nbytes // step)
    f.write(packer.pack_map_header(3))
    f.write(packer.pack(_CHUNKED) + packer.pack(True))
    f.write(packer.pack("shape"))
    f.write(packer.pack({str(i): d for i, d in enumerate(shape)}))
    f.write(packer.pack("chunks") + packer.pack_map_header(n_chunks))
    for i in range(n_chunks):
        piece = raw[i * step:(i + 1) * step]
        f.write(packer.pack(str(i)))
        _write_array(f, _NDARRAY, (piece.nbytes // itemsize,), name, piece)


def _write_tree(f, packer, tree: Mapping) -> None:
    f.write(packer.pack_map_header(len(tree)))
    for key, value in tree.items():
        f.write(packer.pack(str(key)))
        if isinstance(value, Mapping):
            _write_tree(f, packer, value)
        else:
            _write_leaf(f, packer, value)


def write_msgpack(path: str, tree: Mapping) -> None:
    """Write ``tree`` to ``path`` atomically (``.tmp`` then
    ``os.replace``), byte for byte what ``flax.serialization.to_bytes``
    gives for the same tree."""
    tmp = path + ".tmp"
    packer = msgpack.Packer(use_bin_type=True, strict_types=True)
    with open(tmp, "wb") as f:
        _write_tree(f, packer, tree)
    os.replace(tmp, path)


def _ext_hook(code: int, data: bytes):
    if code not in (_NDARRAY, _NPSCALAR):
        return msgpack.ExtType(code, data)
    head = msgpack.Unpacker(raw=True)
    head.feed(data[:256])   # the array header, shape and name; not the bytes
    if head.read_array_header() != 3:
        raise ValueError("malformed array leaf")
    shape, name = head.unpack(), head.unpack().decode()
    if name not in _DTYPES:
        raise ValueError(f"unsupported leaf dtype {name!r}")
    dtype = _DTYPES[name]
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    if nbytes == 0:
        return torch.empty(shape, dtype=dtype)
    buf = bytearray(memoryview(data)[len(data) - nbytes:])
    return torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(shape)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED) is True:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return torch.cat(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_msgpack(path: str) -> dict:
    """The tree of a flax msgpack file as nested dicts of CPU tensors (a
    numpy scalar reads back as a 0-d tensor)."""
    with open(path, "rb") as f:
        # max_buffer_size 0: no limit below msgpack's own 2**32 - 1 bytes
        # per object; the unpacker reads the file in pieces as it goes
        unpacker = msgpack.Unpacker(f, raw=False, ext_hook=_ext_hook,
                                    max_buffer_size=0)
        tree = unpacker.unpack()
    return _unchunk(tree)


def _sorted(tree: Mapping) -> dict:
    """The tree with every dict's keys sorted (a JAX pytree's order)."""
    return {k: _sorted(v) if isinstance(v, Mapping) else v
            for k, v in sorted(tree.items())}


def save_checkpoint(ckpt_dir: str, tree: Mapping, step: int, *,
                    prefix: str = "ckpt", keep: int = 5,
                    metadata: dict | None = None) -> str:
    """Write ``{prefix}_{step:08d}.msgpack`` (+ .json sidecar); rotate old."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{prefix}_{step:08d}.msgpack")
    write_msgpack(path, _sorted(tree))
    meta = dict(metadata or {})
    meta["step"] = int(step)
    with open(path.replace(".msgpack", ".json"), "w") as f:
        json.dump(meta, f, ensure_ascii=False, indent=1, default=str)
    _rotate(ckpt_dir, prefix, keep)
    return path


def save_named(ckpt_dir: str, tree: Mapping, name: str,
               metadata: dict | None = None) -> str:
    """Unrotated named checkpoint, e.g. ``adapter`` / ``model``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{name}.msgpack")
    write_msgpack(path, _sorted(tree))
    if metadata is not None:
        with open(os.path.join(ckpt_dir, f"{name}.json"), "w") as f:
            json.dump(metadata, f, ensure_ascii=False, indent=1, default=str)
    return path


def latest_checkpoint(ckpt_dir: str, prefix: str = "ckpt") -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for fname in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(fname)
        if m and m.group("prefix") == prefix:
            step = int(m.group("step"))
            if best is None or step > best[0]:
                best = (step, os.path.join(ckpt_dir, fname))
    return best[1] if best else None


def restore_checkpoint(path: str) -> tuple[dict, dict]:
    """``(tree, metadata)``: the tree as nested dicts of CPU tensors (bf16
    stays bf16); the metadata ``{}`` when there is no sidecar."""
    tree = read_msgpack(path)
    meta_path = path.replace(".msgpack", ".json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return tree, meta


def _rotate(ckpt_dir: str, prefix: str, keep: int) -> None:
    entries = []
    for fname in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(fname)
        if m and m.group("prefix") == prefix:
            entries.append((int(m.group("step")), fname))
    entries.sort()
    for _, fname in entries[:-keep] if keep > 0 else []:
        os.remove(os.path.join(ckpt_dir, fname))
        sidecar = os.path.join(ckpt_dir, fname.replace(".msgpack", ".json"))
        if os.path.exists(sidecar):
            os.remove(sidecar)
