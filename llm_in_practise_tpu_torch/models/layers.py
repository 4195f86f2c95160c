"""Layer helpers and the shared transformer blocks (port of
``llm_in_practise_tpu/models/layers.py``).

:func:`remat_apply` runs a block under gradient checkpointing. A cache
is a list of per-layer dicts ``{"k", "v", "index"}``; k/v are
``(slots, max_len, n_kv_head, head_dim)``, ``index`` is the write index,
a scalar or a ``(slots,)`` vector (continuous batching: every slot at its
own depth).

:class:`Dense`, :class:`LayerNorm`, :class:`CausalSelfAttention`,
:class:`MLP` and :class:`TransformerBlock` are the GPT family's blocks
(JAX ``models/layers.py:140-293``), with flax's defaults kept where
torch's differ: ``Dense`` has a bias unless ``use_bias=False`` and keeps
the ``(in, out)`` kernel layout, ``LayerNorm`` uses ``epsilon=1e-6`` and
flax's one-pass variance, the ``gelu`` activation is the tanh
approximation, and dropout draws from an explicit ``torch.Generator``.
Parameters are created uninitialized with ``requires_grad=False``; a
model's ``load_state`` fills them, and a trainer turns on the gradients
it wants.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from llm_in_practise_tpu_torch.ops import rope as rope_ops
from llm_in_practise_tpu_torch.ops.attention import dot_product_attention


def remat_apply(block: torch.nn.Module, *args, **call_kwargs):
    """Apply a transformer block under gradient checkpointing: its
    activations are recomputed in the backward instead of saved. As in the
    reference, the block's cache output is dropped (remat runs only on the
    cache-free training forward). Non-reentrant, so inputs that need no
    gradient (layer 0's embedding) and keyword arguments are fine.

    The block's parameters as they stand at forward time are bound as
    explicit inputs of the checkpointed function, which runs the block
    through ``torch.func.functional_call`` on them. Under a functional
    call of the whole model (``Qwen3.apply``, ``GPT.apply``) those are the
    swapped-in state tensors, so the recompute in the backward, which
    runs after the swap has ended, sees the same tensors, and gradients
    flow to the state. A ``generator`` keyword (dropout) is rewound for
    the recompute to its state at forward time, so the recompute draws
    the forward's masks, and is set back afterwards."""
    names, tensors = [], []
    for name, p in block.named_parameters():
        names.append(name)
        tensors.append(p)
    n = len(tensors)
    gen = call_kwargs.get("generator")
    start = gen.get_state() if gen is not None else None
    calls = []

    def run(*flat):
        params = dict(zip(names, flat[:n]))
        if gen is None or not calls:
            calls.append(1)
            return torch.func.functional_call(block, params, flat[n:],
                                              call_kwargs)[0]
        now = gen.get_state()
        gen.set_state(start)
        try:
            return torch.func.functional_call(block, params, flat[n:],
                                              call_kwargs)[0]
        finally:
            gen.set_state(now)

    return checkpoint(run, *tensors, *args, use_reentrant=False)


def cache_positions(index: torch.Tensor | int, batch: int, length: int, *,
                    device=None) -> torch.Tensor:
    """(B, L) absolute positions of the current query block. ``index`` is
    a Python int, a scalar tensor or a ``(B,)`` vector."""
    if isinstance(index, int):
        pos = torch.arange(index, index + length, device=device)
        return pos[None, :].expand(batch, length)
    ar = torch.arange(length, device=index.device)
    if index.ndim == 1:
        return index[:, None] + ar[None, :]
    return (index + ar)[None, :].expand(batch, length)


def to_kv_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in the cache's dtype. A float8 cache saturates: values past
    the format's largest finite value (448 in e4m3fn) store that value,
    where a plain cast gives NaN on the card (and JAX's cast NaN from
    about 464 on). Below it the bytes are the plain cast's."""
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        top = torch.finfo(dtype).max
        x = x.clamp(-top, top)
    return x.to(dtype)


def cache_update(buf: torch.Tensor, new: torch.Tensor,
                 index: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B, L, ...) into ``buf`` (B, max_len, ...) at ``index``.

    The port updates ``buf`` IN PLACE and returns it, where the JAX
    package returns a new buffer (its arrays are immutable; here a copy of
    a multi-GB cache per layer per step would be pure waste). As with
    ``dynamic_update_slice``, a start index that would run past the end is
    clamped to ``max_len - L``.
    """
    b, l = new.shape[:2]
    max_len = buf.shape[1]
    new = to_kv_dtype(new, buf.dtype)
    if isinstance(index, int):
        start = min(max(index, 0), max_len - l)
        buf.narrow(1, start, l).copy_(new)
        return buf
    index = torch.as_tensor(index, device=buf.device)
    start = torch.clamp(index.to(torch.long), 0, max_len - l)
    if start.ndim == 0:
        buf.narrow(1, int(start), l).copy_(new)
        return buf
    rows = torch.arange(b, device=buf.device)[:, None]
    cols = start[:, None] + torch.arange(l, device=buf.device)[None, :]
    buf[rows, cols] = new
    return buf


def assign_state(module: nn.Module, state: dict) -> None:
    """Assign every parameter of ``module`` from ``state`` (names as in
    ``named_parameters``), replacing meta placeholders, each a parameter
    with ``requires_grad=False``. Raises on a missing or unknown name or a
    shape mismatch."""
    have = dict(module.named_parameters())
    unknown = sorted(set(state) - set(have))
    missing = sorted(set(have) - set(state))
    if unknown or missing:
        raise ValueError(
            f"state does not match the model: unknown {unknown[:8]}, "
            f"missing {missing[:8]}")
    for name, value in state.items():
        mod_path, _, attr = name.rpartition(".")
        mod = module.get_submodule(mod_path) if mod_path else module
        old = getattr(mod, attr)
        if tuple(value.shape) != tuple(old.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} != "
                             f"{tuple(old.shape)}")
        setattr(mod, attr, nn.Parameter(value, requires_grad=False))


def init_cache(batch: int, max_len: int, n_kv_head: int, head_dim: int,
               n_layer: int, dtype=torch.bfloat16, *,
               device=None) -> list[dict]:
    """Pre-allocated static-shape KV cache, one entry per layer."""
    shape = (batch, max_len, n_kv_head, head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device),
             "index": 0}
            for _ in range(n_layer)]


def dropout(x: torch.Tensor, rate: float, *, deterministic: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``nn.Dropout``: each element kept with probability ``1 -
    rate`` and scaled by ``1 / (1 - rate)``, the mask drawn from
    ``generator``; the identity when ``deterministic`` or ``rate`` is 0,
    zeros at ``rate`` 1."""
    if deterministic or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    keep.bernoulli_(1.0 - rate, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - rate), 0.0).to(x.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense`` in the JAX layout: ``kernel`` is ``(in, out)``,
    plus a ``bias`` unless ``use_bias=False`` (the Qwen3 projections).
    Input, kernel and bias are cast to ``compute_dtype`` (flax
    ``Dense(dtype=)``) and the bias is added after the product."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype, *, use_bias: bool = False,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(
            torch.empty(in_features, out_features, device=device, dtype=dtype),
            requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(out_features, device=device,
                                              dtype=dtype),
                                  requires_grad=False)
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.compute_dtype
        y = x.to(c) @ self.kernel.to(c)
        if self.bias is not None:
            y = y + self.bias.to(c)
        return y


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: statistics in f32 with the one-pass
    variance ``E[x^2] - E[x]^2`` (clipped at 0), ``epsilon`` 1e-6, a
    ``scale`` and a ``bias``; the result is f32 (flax promotes the input
    with the f32 parameters)."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(dim, device=device, dtype=dtype),
                                  requires_grad=False)
        self.bias = nn.Parameter(torch.empty(dim, device=device, dtype=dtype),
                                 requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        return y + self.bias


def _activation(name: str):
    return {"gelu": lambda h: nn.functional.gelu(h, approximate="tanh"),
            "relu": nn.functional.relu, "silu": nn.functional.silu}[name]


class CausalSelfAttention(nn.Module):
    """Multi-head causal self-attention with optional RoPE (the
    interleaved-pair layout of JAX's default) and KV cache; dropout on the
    attention probabilities and on the output projection."""

    def __init__(self, embed_dim: int, n_head: int, dropout: float = 0.0, *,
                 use_rope: bool = False, rope_theta: float = 10000.0,
                 max_seq_len: int = 2048, attn_impl: str = "auto",
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.embed_dim, self.n_head = embed_dim, n_head
        self.head_dim = embed_dim // n_head
        self.dropout = dropout
        self.use_rope, self.rope_theta = use_rope, rope_theta
        self.max_seq_len = max_seq_len
        self.attn_impl = attn_impl
        kw = dict(use_bias=True, device=device, dtype=dtype)
        self.q_proj = Dense(embed_dim, embed_dim, compute_dtype, **kw)
        self.k_proj = Dense(embed_dim, embed_dim, compute_dtype, **kw)
        self.v_proj = Dense(embed_dim, embed_dim, compute_dtype, **kw)
        self.out_proj = Dense(embed_dim, embed_dim, compute_dtype, **kw)
        self._rope: dict = {}

    def rope_tables(self, device):
        tables = self._rope.get(device)
        if tables is None:
            tables = rope_ops.precompute_cos_sin(
                self.head_dim, self.max_seq_len, self.rope_theta,
                device=device)
            self._rope[device] = tables
        return tables

    def forward(self, x, *, deterministic: bool = True, cache=None,
                positions=None, generator=None):
        b, l, _ = x.shape
        h, hd = self.n_head, self.head_dim
        q = self.q_proj(x).reshape(b, l, h, hd)
        k = self.k_proj(x).reshape(b, l, h, hd)
        v = self.v_proj(x).reshape(b, l, h, hd)
        if self.use_rope:
            cos, sin = self.rope_tables(x.device)
            if positions is None and cache is not None:
                positions = cache_positions(cache["index"], b, l,
                                            device=x.device)
            dt = q.dtype
            q = rope_ops.apply_rotary_emb(q, cos, sin, positions=positions,
                                          interleaved=True).to(dt)
            k = rope_ops.apply_rotary_emb(k, cos, sin, positions=positions,
                                          interleaved=True).to(dt)
        q_offset = None
        if cache is not None:
            q_offset = cache["index"]
            k_cache = cache_update(cache["k"], k, cache["index"])
            v_cache = cache_update(cache["v"], v, cache["index"])
            cache = {"k": k_cache, "v": v_cache, "index": cache["index"] + l}
            k, v = k_cache.to(q.dtype), v_cache.to(q.dtype)
        rate = 0.0 if deterministic else self.dropout
        out = dot_product_attention(q, k, v, causal=True, q_offset=q_offset,
                                    dropout_rate=rate, generator=generator,
                                    impl=self.attn_impl)
        out = self.out_proj(out.reshape(b, l, self.embed_dim))
        return dropout(out, self.dropout, deterministic=deterministic,
                       generator=generator), cache


class MLP(nn.Module):
    """Position-wise FFN: Dense -> activation -> Dense -> dropout."""

    def __init__(self, embed_dim: int, hidden_dim: int, dropout: float = 0.0,
                 activation: str = "gelu", *,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(use_bias=True, device=device, dtype=dtype)
        self.fc_in = Dense(embed_dim, hidden_dim, compute_dtype, **kw)
        self.fc_out = Dense(hidden_dim, embed_dim, compute_dtype, **kw)
        self.act = _activation(activation)
        self.dropout = dropout

    def forward(self, x, *, deterministic: bool = True, generator=None):
        h = self.fc_out(self.act(self.fc_in(x)))
        return dropout(h, self.dropout, deterministic=deterministic,
                       generator=generator)


class TransformerBlock(nn.Module):
    """Attention + FFN with residuals; pre-LN (``norm_first``) or post-LN.
    The norms compute in f32 and hand back the compute dtype, so the
    residual stream stays in it."""

    def __init__(self, embed_dim: int, n_head: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, *, norm_first: bool = True,
                 activation: str = "gelu", use_rope: bool = False,
                 rope_theta: float = 10000.0, max_seq_len: int = 2048,
                 attn_impl: str = "auto",
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, device=device, dtype=dtype)
        self.norm_first = norm_first
        self.compute_dtype = compute_dtype
        self.attn = CausalSelfAttention(
            embed_dim, n_head, dropout, use_rope=use_rope,
            rope_theta=rope_theta, max_seq_len=max_seq_len,
            attn_impl=attn_impl, **kw)
        self.mlp = MLP(embed_dim, int(embed_dim * mlp_ratio), dropout,
                       activation, **kw)
        self.ln1 = LayerNorm(embed_dim, device=device, dtype=dtype)
        self.ln2 = LayerNorm(embed_dim, device=device, dtype=dtype)

    def forward(self, x, *, deterministic: bool = True, cache=None,
                positions=None, generator=None):
        c = self.compute_dtype
        ln1 = lambda v: self.ln1(v).to(c)   # noqa: E731
        ln2 = lambda v: self.ln2(v).to(c)   # noqa: E731
        kw = dict(deterministic=deterministic, generator=generator)
        if self.norm_first:
            a, cache = self.attn(ln1(x), cache=cache, positions=positions,
                                 **kw)
            x = x + a
            x = x + self.mlp(ln2(x), **kw)
        else:   # post-LN (torch TransformerEncoderLayer's default)
            a, cache = self.attn(x, cache=cache, positions=positions, **kw)
            x = ln1(x + a)
            x = ln2(x + self.mlp(x, **kw))
        return x, cache
