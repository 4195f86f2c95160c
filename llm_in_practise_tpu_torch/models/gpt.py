"""The decoder-only GPT family in PyTorch (port of
``llm_in_practise_tpu/models/gpt.py``): MiniGPT v1 and v2 and GPTLike as
:class:`GPTConfig` presets of one module.

Token embedding, then learned positions (a ``pos_embed`` table indexed by
the absolute positions), a fixed sinusoidal table, or RoPE inside
attention; dropout; ``n_layer`` :class:`~.layers.TransformerBlock` (pre-
or post-LN, biased projections, tanh-approximate GELU); a final
LayerNorm in f32; the LM head, tied to the embedding table or an
``lm_head`` Dense with its bias, in f32. The blocks run in
``compute_dtype`` (f32 by default, as in the reference).

The module has the interface the port's engine and
:mod:`~..infer.generate` call on :class:`~.qwen3.Qwen3`: ``forward(idx,
cache=, positions=, return_hidden=)``, ``head``, ``init_cache``,
``apply``, ``load_state``, ``config`` and ``device``. Its forward reads
no value back to the host, so a decode step captures into a CUDA graph;
positions are not bounds-checked on the host: one past the table reads
its last row on the device, as the reference's clamping gather does, and
the serving engine keeps every position below ``seq_len`` (its
``cache_len`` is clamped to :func:`~..infer.generate.max_positions`).
Parameter names follow the
flax paths with ``block_{i}`` written ``blocks.{i}``
(:func:`~.convert.gpt_params_from_jax`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from llm_in_practise_tpu_torch.core.device import resolve_device
from llm_in_practise_tpu_torch.models import layers
from llm_in_practise_tpu_torch.models.qwen3 import DTYPES
from llm_in_practise_tpu_torch.ops.rope import sinusoidal_embeddings

Cache = dict[str, Any]

POS_EMBEDDINGS = ("learned", "sinusoidal", "rope")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int
    seq_len: int = 256
    n_layer: int = 4
    n_head: int = 4
    embed_dim: int = 128
    mlp_ratio: float = 4.0
    dropout: float = 0.1
    pos_embedding: str = "learned"  # "learned" | "sinusoidal" | "rope"
    norm_first: bool = True
    tie_weights: bool = False
    activation: str = "gelu"
    rope_theta: float = 10000.0
    attn_impl: str = "auto"
    compute_dtype: str = "float32"
    remat: bool = False  # gradient checkpointing: recompute blocks in bwd

    def replace(self, **kw) -> "GPTConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "GPTConfig":
        valid = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in valid})

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.n_head


def minigpt_config(vocab_size: int, **overrides) -> GPTConfig:
    """MiniGPT v2 preset: post-LN, learned positions, untied head."""
    base = dict(seq_len=256, n_layer=4, n_head=4, embed_dim=128, dropout=0.1,
                pos_embedding="learned", norm_first=False, tie_weights=False)
    base.update(overrides)
    return GPTConfig(vocab_size=vocab_size, **base)


def minigpt_v1_config(vocab_size: int, **overrides) -> GPTConfig:
    """MiniGPT v1 preset: the char-level toy, seq 16, d_model 64."""
    base = dict(seq_len=16, n_layer=2, n_head=2, embed_dim=64, dropout=0.1,
                pos_embedding="learned", norm_first=False)
    base.update(overrides)
    return GPTConfig(vocab_size=vocab_size, **base)


def gptlike_config(vocab_size: int, pos_embedding: str = "learned",
                   **overrides) -> GPTConfig:
    """GPTLike preset: 6 layers, 8 heads, d_model 512, block 256, pre-LN,
    weight tying."""
    base = dict(seq_len=256, n_layer=6, n_head=8, embed_dim=512, dropout=0.1,
                pos_embedding=pos_embedding, norm_first=True,
                tie_weights=True)
    base.update(overrides)
    return GPTConfig(vocab_size=vocab_size, **base)


def expected_names(cfg: GPTConfig) -> set[str]:
    """The port's parameter names of a GPT of ``cfg``."""
    names = {"tok_embed.weight", "ln_f.scale", "ln_f.bias"}
    if cfg.pos_embedding == "learned":
        names.add("pos_embed")
    if not cfg.tie_weights:
        names |= {"lm_head.kernel", "lm_head.bias"}
    for i in range(cfg.n_layer):
        p = f"blocks.{i}"
        for mod in ("attn.q_proj", "attn.k_proj", "attn.v_proj",
                    "attn.out_proj", "mlp.fc_in", "mlp.fc_out", "ln1", "ln2"):
            leaves = ("scale", "bias") if mod.startswith("ln") else (
                "kernel", "bias")
            names |= {f"{p}.{mod}.{leaf}" for leaf in leaves}
    return names


class GPT(nn.Module):
    """Decoder-only LM: ``model(idx) -> logits``; with ``cache=`` returns
    ``(logits, cache)``.

    ``device`` defaults to the card (:func:`resolve_device`); pass
    ``"cpu"`` to run on the CPU, or ``"meta"`` to build the module without
    memory and fill it with :meth:`load_state`. Parameters start
    uninitialized: weights come from :meth:`load_state` (a fresh draw:
    :func:`init_params`)."""

    def __init__(self, cfg: GPTConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        if cfg.attn_impl not in ("auto", "dense", "flash"):
            raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
        if cfg.pos_embedding not in POS_EMBEDDINGS:
            raise ValueError(f"unknown pos_embedding {cfg.pos_embedding!r}")
        self.cfg = cfg
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        compute = DTYPES[cfg.compute_dtype]
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim, **kw)
        self.tok_embed.weight.requires_grad_(False)
        self.pos_embed = (
            nn.Parameter(torch.empty(cfg.seq_len, cfg.embed_dim, **kw),
                         requires_grad=False)
            if cfg.pos_embedding == "learned" else None)
        self.blocks = nn.ModuleList(
            layers.TransformerBlock(
                cfg.embed_dim, cfg.n_head, cfg.mlp_ratio, cfg.dropout,
                norm_first=cfg.norm_first, activation=cfg.activation,
                use_rope=cfg.pos_embedding == "rope",
                rope_theta=cfg.rope_theta, max_seq_len=cfg.seq_len,
                attn_impl=cfg.attn_impl, compute_dtype=compute, **kw)
            for _ in range(cfg.n_layer))
        self.ln_f = layers.LayerNorm(cfg.embed_dim, **kw)
        self.lm_head = (None if cfg.tie_weights else
                        layers.Dense(cfg.embed_dim, cfg.vocab_size,
                                     torch.float32, use_bias=True, **kw))
        self._sinusoid: dict[torch.device, torch.Tensor] = {}

    @property
    def config(self) -> GPTConfig:
        return self.cfg

    @property
    def device(self) -> torch.device:
        return self.tok_embed.weight.device

    def load_state(self, state: dict[str, torch.Tensor]) -> None:
        """Assign every parameter from ``state`` (names as in
        ``named_parameters``), replacing meta placeholders; each is a
        parameter with ``requires_grad=False`` (a trainer turns it on).
        Raises on a missing or unknown name or a shape mismatch."""
        layers.assign_state(self, state)

    def apply(self, state: dict[str, torch.Tensor], idx: torch.Tensor,
              **kwargs):
        """The forward with every parameter taken from ``state`` (names as
        in ``named_parameters``), differentiable in its tensors; the
        module's own parameters stay as they are (flax's
        ``model.apply({"params": ...})``). The module may live on
        ``meta``. Under ``cfg.remat`` the checkpointed blocks bind the
        swapped-in tensors (:func:`~.layers.remat_apply`)."""
        return torch.func.functional_call(self, state, (idx,), kwargs,
                                          strict=True)

    def init_cache(self, batch: int, max_len: int | None = None,
                   dtype=torch.bfloat16):
        cfg = self.cfg
        return layers.init_cache(batch, max_len or cfg.seq_len, cfg.n_head,
                                 cfg.head_dim, cfg.n_layer, dtype,
                                 device=self.device)

    def sinusoid(self, device) -> torch.Tensor:
        table = self._sinusoid.get(device)
        if table is None:
            table = sinusoidal_embeddings(self.cfg.seq_len, self.cfg.embed_dim,
                                          device=device)
            self._sinusoid[device] = table
        return table

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits from final-norm hidden states: the tied table's
        ``x @ E^T``, or ``lm_head`` with its bias."""
        x = x.to(torch.float32)
        if self.lm_head is not None:
            return self.lm_head(x)
        return x @ self.tok_embed.weight.to(torch.float32).T

    def forward(self, idx: torch.Tensor, *, cache: list[Cache] | None = None,
                positions=None, return_hidden: bool = False,
                deterministic: bool = True,
                generator: torch.Generator | None = None):
        cfg = self.cfg
        b, l = idx.shape
        x = self.tok_embed(idx)
        if positions is None:
            start = cache[0]["index"] if cache is not None else 0
            positions = layers.cache_positions(start, b, l, device=x.device)
        # a position past the table reads its last row, as the
        # reference's gather clamps an out-of-bounds index (on the
        # device: no host check, no device assert)
        positions = positions.clamp(max=cfg.seq_len - 1)
        if cfg.pos_embedding == "learned":
            x = x + self.pos_embed[positions]
        elif cfg.pos_embedding == "sinusoidal":
            x = x + self.sinusoid(x.device)[positions]
        # "rope" rotates inside attention
        x = layers.dropout(x, cfg.dropout, deterministic=deterministic,
                           generator=generator)
        x = x.to(DTYPES[cfg.compute_dtype])
        block_pos = positions if cfg.pos_embedding == "rope" else None
        kw = dict(deterministic=deterministic, generator=generator)
        new_caches: list[Cache] | None = [] if cache is not None else None
        for i, block in enumerate(self.blocks):
            if cfg.remat and cache is None:
                # gradient checkpointing (the reference's
                # gradient_checkpointing_enable)
                x = layers.remat_apply(block, x, cache=None,
                                       positions=block_pos, **kw)
                continue
            x, layer_cache = block(
                x, cache=cache[i] if cache is not None else None,
                positions=block_pos, **kw)
            if new_caches is not None:
                new_caches.append(layer_cache)
        x = self.ln_f(x.to(torch.float32))
        if return_hidden:
            return (x, new_caches) if cache is not None else x
        logits = self.head(x)
        if cache is not None:
            return logits, new_caches
        return logits


def init_params(cfg: GPTConfig, generator: torch.Generator | None = None,
                *, device=None,
                dtype=torch.float32) -> dict[str, torch.Tensor]:
    """A fresh state for :meth:`GPT.load_state`, drawn as flax draws it (as
    a distribution; the numbers differ): the embedding, the position table
    and every kernel N(0, 0.02), biases 0, norm scales 1. ``device``
    defaults to the card; the generator must live on that device."""
    device = resolve_device(device)
    shapes = {n: tuple(p.shape) for n, p in
              GPT(cfg, device="meta").named_parameters()}
    state = {}
    for name in sorted(expected_names(cfg)):
        t = torch.empty(shapes[name], device=device, dtype=dtype)
        if name.endswith(".scale"):
            t.fill_(1.0)
        elif name.endswith(".bias"):
            t.zero_()
        else:
            t.normal_(0.0, 0.02, generator=generator)
        state[name] = t
    return state
