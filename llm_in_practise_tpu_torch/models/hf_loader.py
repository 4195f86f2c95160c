"""HF safetensors checkpoints of the Qwen3 family, in and out.

Port of ``llm_in_practise_tpu/models/hf_loader.py:34-234``:

- :func:`load_qwen3` reads a sharded ``model-*.safetensors`` +
  ``model.safetensors.index.json`` directory (or a single
  ``model.safetensors``) tensor by tensor, each straight onto the device
  (the card unless the caller asks for the CPU) in the requested dtype,
  so the checkpoint is never held in host memory twice. It returns
  ``(cfg, state)`` with the port's parameter names
  (:func:`~.convert.port_name`).
- :func:`save_qwen3` writes what the JAX package writes: one f32
  ``model.safetensors`` and a ``config.json`` with the same keys. It
  streams tensor by tensor, so the host holds one f32 tensor at a time.

torch ``nn.Linear`` stores ``weight: (out, in)``; the port's kernels are
``(in, out)`` as flax's are, so every Dense weight is transposed on the
way through.
"""

from __future__ import annotations

import json
import os
import re
import struct
from collections.abc import Mapping

import torch

from llm_in_practise_tpu_torch.core.device import resolve_device
from llm_in_practise_tpu_torch.models.convert import (
    flax_path,
    params_from_jax,
    port_name,
)
from llm_in_practise_tpu_torch.models.qwen3 import Qwen3Config

# (HF name, flax path, transpose?); "{}" is the layer index
_NAMES: tuple[tuple[str, str, bool], ...] = (
    ("model.embed_tokens.weight", "tok_embed/embedding", False),
    ("model.layers.{}.self_attn.q_proj.weight", "block_{}/attn/q_proj/kernel", True),
    ("model.layers.{}.self_attn.k_proj.weight", "block_{}/attn/k_proj/kernel", True),
    ("model.layers.{}.self_attn.v_proj.weight", "block_{}/attn/v_proj/kernel", True),
    ("model.layers.{}.self_attn.o_proj.weight", "block_{}/attn/out_proj/kernel", True),
    ("model.layers.{}.self_attn.q_norm.weight", "block_{}/attn/q_norm/scale", False),
    ("model.layers.{}.self_attn.k_norm.weight", "block_{}/attn/k_norm/scale", False),
    ("model.layers.{}.mlp.gate_proj.weight", "block_{}/mlp/gate_proj/kernel", True),
    ("model.layers.{}.mlp.up_proj.weight", "block_{}/mlp/up_proj/kernel", True),
    ("model.layers.{}.mlp.down_proj.weight", "block_{}/mlp/down_proj/kernel", True),
    ("model.layers.{}.input_layernorm.weight", "block_{}/ln1/scale", False),
    ("model.layers.{}.post_attention_layernorm.weight", "block_{}/ln2/scale", False),
    ("model.norm.weight", "ln_f/scale", False),
    ("lm_head.weight", "lm_head/kernel", True),
)


def _pattern(template: str) -> re.Pattern:
    return re.compile("^" + re.escape(template).replace(r"\{\}", r"(\d+)")
                      + "$")


_HF_TO_OURS = tuple((_pattern(hf), ours, t) for hf, ours, t in _NAMES)
_OURS_TO_HF = tuple((_pattern(ours), hf, t) for hf, ours, t in _NAMES)


def map_hf_name(hf_name: str) -> tuple[str, bool] | None:
    """HF tensor name -> ("/"-joined flax path, transpose?). None = skip."""
    for pat, template, transpose in _HF_TO_OURS:
        m = pat.match(hf_name)
        if m:
            return template.format(*m.groups()), transpose
    return None


def _hf_name(name: str) -> tuple[str, bool]:
    """Port name -> (HF tensor name, transpose?)."""
    path = flax_path(name)
    for pat, template, transpose in _OURS_TO_HF:
        m = pat.match(path)
        if m:
            return template.format(*m.groups()), transpose
    raise ValueError(f"{name!r} has no HF Qwen3 name")


def _checkpoint_files(model_dir: str) -> list[str]:
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        return sorted({os.path.join(model_dir, v) for v in weight_map.values()})
    single = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(single):
        return [single]
    raise FileNotFoundError(f"no safetensors checkpoint under {model_dir}")


def load_config(model_dir: str, **overrides) -> Qwen3Config:
    with open(os.path.join(model_dir, "config.json")) as f:
        return Qwen3Config.from_hf_config(json.load(f), **overrides)


def load_qwen3(model_dir: str, *, dtype=torch.bfloat16, device=None,
               config_overrides: dict | None = None,
               scan_layers: bool = False) -> tuple[Qwen3Config, dict]:
    """Load a HF Qwen3 checkpoint directory -> ``(cfg, state)``.

    Each tensor is read with ``safe_open`` straight onto ``device``
    (default: the card), cast to ``dtype`` and, for a Dense weight,
    transposed to ``(in, out)``. A tied config skips ``lm_head``.
    ``scan_layers=True`` returns ``cfg.replace(scan_layers=True)`` and the
    same unrolled state: the port runs the unrolled blocks either way
    (``scan_layers`` is a layout of the JAX param tree)."""
    from safetensors import safe_open

    device = resolve_device(device)
    cfg = load_config(model_dir, **(config_overrides or {}))
    state: dict[str, torch.Tensor] = {}
    for fname in _checkpoint_files(model_dir):
        with safe_open(fname, framework="pt", device=str(device)) as f:
            for hf_name in f.keys():
                mapped = map_hf_name(hf_name)
                if mapped is None:
                    continue
                path, transpose = mapped
                if cfg.tie_word_embeddings and path == "lm_head/kernel":
                    continue
                t = f.get_tensor(hf_name).to(dtype)
                state[port_name(path)] = (t.t().contiguous() if transpose
                                          else t)
    if not state:
        raise ValueError(f"no recognized Qwen3 tensors in {model_dir}")
    if scan_layers:
        cfg = cfg.replace(scan_layers=True)
    return cfg, state


def _write_f32_safetensors(path: str, tensors: dict) -> None:
    """``{name: tensor}`` (any dtype, device or strides) as one f32
    safetensors file, written tensor by tensor."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = 4 * t.numel()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    header["__metadata__"] = {"format": "pt"}
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for t in tensors.values():
            # cast and lay out where the tensor lies, then one copy out
            t = t.to(torch.float32).contiguous().to("cpu")
            f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
    os.replace(tmp, path)


def save_qwen3(state: Mapping, cfg: Qwen3Config, out_dir: str) -> None:
    """Export a state (port names; a flax-form tree, stacked or not, is
    carried across first) to an HF-layout f32 ``model.safetensors`` plus
    ``config.json``."""
    if any(isinstance(v, Mapping) for v in state.values()):
        state = params_from_jax(state, cfg)   # unstacks a scan-layout tree
    os.makedirs(out_dir, exist_ok=True)
    tensors = {}
    for name, value in state.items():
        hf, transpose = _hf_name(name)
        if not (hf == "lm_head.weight" and cfg.tie_word_embeddings):
            tensors[hf] = value.t() if transpose else value
    _write_f32_safetensors(os.path.join(out_dir, "model.safetensors"),
                           tensors)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(
            {
                "architectures": ["Qwen3ForCausalLM"],
                "model_type": "qwen3",
                "vocab_size": cfg.vocab_size,
                "hidden_size": cfg.hidden_size,
                "intermediate_size": cfg.intermediate_size,
                "num_hidden_layers": cfg.n_layer,
                "num_attention_heads": cfg.n_head,
                "num_key_value_heads": cfg.n_kv_head,
                "head_dim": cfg.head_dim,
                "rope_theta": cfg.rope_theta,
                "rms_norm_eps": cfg.rms_norm_eps,
                "max_position_embeddings": cfg.max_seq_len,
                "tie_word_embeddings": cfg.tie_word_embeddings,
                "torch_dtype": "float32",
            },
            f, indent=2,
        )
