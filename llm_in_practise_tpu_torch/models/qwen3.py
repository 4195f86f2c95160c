"""Qwen3 in PyTorch (port of ``llm_in_practise_tpu/models/qwen3.py``).

GQA attention with per-head QK-RMSNorm, RoPE (HF rotate-half layout),
SwiGLU MLP, RMSNorm, no biases. The dtype rules follow the flax model:

- every projection casts its input and kernel to ``compute_dtype``;
- RMSNorm computes in f32 and casts back to its input's dtype;
- RoPE rotates in f32 and returns the compute dtype;
- the KV cache is stored in its own dtype and read back in q's dtype;
- the LM head runs in f32 (a tied head keeps one f32 copy of the
  embedding table rather than casting it on every step).

Unrolled layout only: ``scan_layers=True`` raises. Parameter names follow
the flax paths with ``block_{i}`` written ``blocks.{i}`` (see
:mod:`.convert`); kernels keep the JAX ``(in, out)`` layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from llm_in_practise_tpu_torch.core.device import resolve_device
from llm_in_practise_tpu_torch.models import layers
from llm_in_practise_tpu_torch.ops import rope as rope_ops
from llm_in_practise_tpu_torch.ops.attention import dense_attention

Cache = dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    n_layer: int
    n_head: int
    n_kv_head: int
    head_dim: int
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    max_seq_len: int = 4096
    tie_word_embeddings: bool = False
    attn_impl: str = "auto"
    compute_dtype: str = "bfloat16"
    remat: bool = False
    scan_layers: bool = False
    scan_unroll: int = 1

    def replace(self, **kw) -> "Qwen3Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Qwen3Config":
        return cls(**d)

    @classmethod
    def from_hf_config(cls, hf: dict, **overrides) -> "Qwen3Config":
        """Build from a HF ``config.json`` dict (transformers Qwen3Config)."""
        cfg = cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            n_layer=hf["num_hidden_layers"],
            n_head=hf["num_attention_heads"],
            n_kv_head=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            head_dim=hf.get(
                "head_dim", hf["hidden_size"] // hf["num_attention_heads"]),
            rope_theta=float(hf.get("rope_theta", 1_000_000.0)),
            rms_norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
            max_seq_len=int(hf.get("max_position_embeddings", 4096)),
            tie_word_embeddings=bool(hf.get("tie_word_embeddings", False)),
        )
        return cfg.replace(**overrides)


def qwen3_config(vocab_size: int = 1024, **kw) -> Qwen3Config:
    """Tiny-default constructor for tests and examples."""
    defaults = dict(
        vocab_size=vocab_size, hidden_size=128, intermediate_size=256,
        n_layer=2, n_head=4, n_kv_head=2, head_dim=32, max_seq_len=256,
    )
    defaults.update(kw)
    return Qwen3Config(**defaults)


class RMSNorm(nn.Module):
    """RMSNorm with f32 accumulation (HF Qwen3RMSNorm semantics)."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(var + self.eps)
        return (xf * self.scale).to(x.dtype)


class Dense(nn.Module):
    """Bias-free projection in the JAX layout: ``kernel`` is ``(in, out)``;
    input and kernel are cast to ``compute_dtype`` (flax ``Dense(dtype=)``)."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(
            torch.empty(in_features, out_features, device=device, dtype=dtype),
            requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype) @ self.kernel.to(self.compute_dtype)


def init_cache(cfg: Qwen3Config, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> list[Cache]:
    """Per-layer KV cache holding only the KV heads; slot axis 0."""
    shape = (batch, max_len, cfg.n_kv_head, cfg.head_dim)
    return [
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device),
         "index": 0}
        for _ in range(cfg.n_layer)
    ]


class Qwen3Attention(nn.Module):
    """GQA + QK-RMSNorm + RoPE causal attention."""

    def __init__(self, cfg: Qwen3Config, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        compute = DTYPES[cfg.compute_dtype]
        kw = dict(device=device, dtype=dtype)
        d, hd = cfg.hidden_size, cfg.head_dim
        self.q_proj = Dense(d, cfg.n_head * hd, compute, **kw)
        self.k_proj = Dense(d, cfg.n_kv_head * hd, compute, **kw)
        self.v_proj = Dense(d, cfg.n_kv_head * hd, compute, **kw)
        self.out_proj = Dense(cfg.n_head * hd, d, compute, **kw)
        self.q_norm = RMSNorm(hd, cfg.rms_norm_eps, **kw)
        self.k_norm = RMSNorm(hd, cfg.rms_norm_eps, **kw)

    def forward(self, x, rope_tables, *, cache: Cache | None = None,
                positions=None):
        cfg = self.cfg
        compute = DTYPES[cfg.compute_dtype]
        b, l, _ = x.shape
        q = self.q_proj(x).reshape(b, l, cfg.n_head, cfg.head_dim)
        k = self.k_proj(x).reshape(b, l, cfg.n_kv_head, cfg.head_dim)
        v = self.v_proj(x).reshape(b, l, cfg.n_kv_head, cfg.head_dim)
        q = self.q_norm(q)
        k = self.k_norm(k)

        cos, sin = rope_tables
        if positions is None and cache is not None:
            positions = layers.cache_positions(cache["index"], b, l,
                                               device=x.device)
        q = rope_ops.apply_rotary_emb(q, cos, sin, positions=positions).to(compute)
        k = rope_ops.apply_rotary_emb(k, cos, sin, positions=positions).to(compute)

        q_offset = None
        if cache is not None:
            q_offset = cache["index"]
            k_cache = layers.cache_update(cache["k"], k, cache["index"])
            v_cache = layers.cache_update(cache["v"], v, cache["index"])
            cache = {"k": k_cache, "v": v_cache, "index": cache["index"] + l}
            k, v = k_cache.to(q.dtype), v_cache.to(q.dtype)

        out = dense_attention(q, k, v, q_offset=q_offset)
        out = out.reshape(b, l, cfg.n_head * cfg.head_dim)
        return self.out_proj(out), cache


class Qwen3MLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, cfg: Qwen3Config, *, device=None, dtype=torch.float32):
        super().__init__()
        compute = DTYPES[cfg.compute_dtype]
        kw = dict(device=device, dtype=dtype)
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Dense(d, f, compute, **kw)
        self.up_proj = Dense(d, f, compute, **kw)
        self.down_proj = Dense(f, d, compute, **kw)

    def forward(self, x):
        return self.down_proj(
            nn.functional.silu(self.gate_proj(x)) * self.up_proj(x))


class Qwen3Block(nn.Module):
    def __init__(self, cfg: Qwen3Config, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.attn = Qwen3Attention(cfg, **kw)
        self.ln2 = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.mlp = Qwen3MLP(cfg, **kw)

    def forward(self, x, rope_tables, *, cache=None, positions=None):
        a, cache = self.attn(self.ln1(x), rope_tables, cache=cache,
                             positions=positions)
        x = x + a
        x = x + self.mlp(self.ln2(x))
        return x, cache


class Qwen3(nn.Module):
    """Qwen3 causal LM: ``model(idx) -> logits``; with ``cache=`` returns
    ``(logits, cache)``.

    ``device`` defaults to the card (:func:`resolve_device`); pass
    ``"cpu"`` to run on the CPU, or ``"meta"`` to build the module without
    memory and fill it with :meth:`load_state`. Parameters start
    uninitialized: weights come from :meth:`load_state`.
    """

    def __init__(self, cfg: Qwen3Config, *, device=None, dtype=torch.float32):
        super().__init__()
        if cfg.scan_layers:
            raise NotImplementedError(
                "scan_layers=True is not ported: the PyTorch port runs the "
                "unrolled layout (ROADMAP.md, queue A: later engine paths)")
        if cfg.attn_impl not in ("auto", "dense"):
            raise NotImplementedError(
                f"attn_impl={cfg.attn_impl!r} is not ported: flash attention "
                "waits for its Hopper kernel (ROADMAP.md, queue B)")
        self.cfg = cfg
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.tok_embed.weight.requires_grad_(False)
        self.blocks = nn.ModuleList(
            Qwen3Block(cfg, **kw) for _ in range(cfg.n_layer))
        self.ln_f = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.lm_head = (None if cfg.tie_word_embeddings else
                        Dense(cfg.hidden_size, cfg.vocab_size, torch.float32,
                              **kw))
        self._rope: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}
        self._head_f32: torch.Tensor | None = None

    @property
    def config(self) -> Qwen3Config:
        return self.cfg

    @property
    def device(self) -> torch.device:
        return self.tok_embed.weight.device

    def load_state(self, state: dict[str, torch.Tensor]) -> None:
        """Assign every parameter from ``state`` (names as in
        ``named_parameters``), replacing meta placeholders. Raises on a
        missing or unknown name."""
        have = dict(self.named_parameters())
        unknown = sorted(set(state) - set(have))
        missing = sorted(set(have) - set(state))
        if unknown or missing:
            raise ValueError(
                f"state does not match the model: unknown {unknown[:8]}, "
                f"missing {missing[:8]}")
        for name, value in state.items():
            mod_path, _, attr = name.rpartition(".")
            mod = self.get_submodule(mod_path)
            old = getattr(mod, attr)
            if tuple(value.shape) != tuple(old.shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)} != "
                                 f"{tuple(old.shape)}")
            setattr(mod, attr, nn.Parameter(value, requires_grad=False))
        self._head_f32 = None

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        return init_cache(self.cfg, batch, max_len, dtype, device=self.device)

    def rope_tables(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        tables = self._rope.get(device)
        if tables is None:
            tables = rope_ops.precompute_cos_sin(
                self.cfg.head_dim, self.cfg.max_seq_len, self.cfg.rope_theta,
                device=device)
            self._rope[device] = tables
        return tables

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits from final-norm hidden states."""
        x = x.to(torch.float32)
        if self.lm_head is not None:
            return self.lm_head(x)
        if self._head_f32 is None:
            # one f32 copy of the table, kept (no cast on every step);
            # load_state drops it
            self._head_f32 = self.tok_embed.weight.to(torch.float32)
        return x @ self._head_f32.T

    def forward(self, idx: torch.Tensor, *, cache: list[Cache] | None = None,
                positions=None, return_hidden: bool = False):
        compute = DTYPES[self.cfg.compute_dtype]
        x = self.tok_embed(idx).to(compute)
        rope_tables = self.rope_tables(x.device)
        new_caches: list[Cache] | None = [] if cache is not None else None
        for i, block in enumerate(self.blocks):
            layer_cache = cache[i] if cache is not None else None
            x, layer_cache = block(x, rope_tables, cache=layer_cache,
                                   positions=positions)
            if new_caches is not None:
                new_caches.append(layer_cache)
        x = self.ln_f(x)
        if return_hidden:
            return (x, new_caches) if cache is not None else x
        logits = self.head(x)
        if cache is not None:
            return logits, new_caches
        return logits
