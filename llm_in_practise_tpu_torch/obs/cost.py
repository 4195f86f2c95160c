"""The analytic FLOP / HBM-byte cost model and device memory telemetry
(port of ``llm_in_practise_tpu/obs/cost.py``).

- **Card peaks**: :data:`PEAKS` (dense bf16 FLOP/s) and :data:`HBM_BW`
  (bytes/s), data-sheet figures keyed by a substring of
  ``torch.cuda.get_device_name()``; only H100 parts are listed.
  :func:`chip_peak` / :func:`chip_hbm_bw` resolve the attached card, and
  give ``None`` for a device with no entry, the CPU included: there is no
  fallback number, so the utilization gauges carry no samples there.
- **Training model** (JAX ``bench.py``'s per-token FLOPs):
  :func:`matmul_param_count` + :func:`flops_per_token`.
- **Serving model**: :class:`CostModel`, FLOPs and HBM bytes per prefill
  chunk / decode block from the model's geometry and its resident weight
  bytes (:func:`tree_bytes` of the served module: the packed NF4, int4
  or int8 buffers, not a dequantized copy). The engine's
  :class:`~llm_in_practise_tpu_torch.obs.meter.DispatchMeter` turns them
  into the per-phase MFU / bandwidth gauges. The tensor-parallel
  collective attribution of the JAX model waits for sharded serving
  (ROADMAP.md queue A item 14).
- **Device memory telemetry**: :func:`device_memory_stats`, what the
  card's caching allocator reports (bytes in use, the peak, the card's
  total memory), fail-open ``{}`` for a CPU device or a process without
  CUDA, so a scrape never fails on it; :func:`hbm_stats`, the same in the
  benchmark artifacts' shape.

Conventions (the JAX model's): a matmul weight element costs 2 FLOPs per
token forward; causal attention costs ``4·k·D`` per new token attending
``k`` keys (``QKᵀ`` + ``AV``, ``D`` = query width). Utilizations are
useful-work fractions: padding, draft proposals and host work all show
up as lost utilization.
"""

from __future__ import annotations

import dataclasses

import torch

# dense bf16 tensor-core FLOP/s by device-name substring (first match
# wins), from NVIDIA's H100 data sheet (the sparsity figures halved)
PEAKS = (
    ("h100 nvl", 835e12),
    ("h100 pcie", 756e12),
    ("h100", 989e12),        # SXM5, "NVIDIA H100 80GB HBM3"
)
# HBM bandwidth (bytes/s) by the same substrings, same data sheet
HBM_BW = (
    ("h100 nvl", 3.9e12),
    ("h100 pcie", 2.0e12),
    ("h100", 3.35e12),
)


def _lookup(kind: str | None, table) -> float | None:
    if not kind:
        return None
    low = kind.lower()
    for sub, value in table:
        if sub in low:
            return value
    return None


def device_name(device=None) -> str | None:
    """``torch.cuda.get_device_name`` of ``device`` (default ``cuda:0``), or
    None for a CPU device or without CUDA."""
    try:
        dev = torch.device("cuda:0" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return None
        return torch.cuda.get_device_name(dev)
    except Exception:  # noqa: BLE001 — no runtime: no kind, never a raise
        return None


def chip_peak(device=None) -> tuple[str, float] | None:
    """``(device name, dense bf16 FLOP/s)`` of the attached card, or None
    for the CPU, a process without CUDA or a card with no entry."""
    kind = device_name(device)
    peak = _lookup(kind, PEAKS)
    return None if peak is None else (kind, peak)


def chip_hbm_bw(kind: str | None = None) -> float | None:
    """HBM bandwidth (bytes/s) of ``kind`` (default: the attached card), or
    None where there is no entry."""
    if kind is None:
        kind = device_name()
    return _lookup(kind, HBM_BW)


def device_memory_stats(device=None) -> dict:
    """``bytes_in_use`` (``torch.cuda.memory_allocated``),
    ``peak_bytes_in_use`` (``max_memory_allocated``) and ``bytes_limit``
    (the card's total memory, ``mem_get_info``) of ``device`` (default
    ``cuda:0``); ``{}`` for a CPU device or without CUDA. Telemetry fails
    open: it never raises."""
    try:
        dev = torch.device("cuda:0" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return {}
        return {"bytes_in_use": int(torch.cuda.memory_allocated(dev)),
                "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
                "bytes_limit": int(torch.cuda.mem_get_info(dev)[1])}
    except Exception:  # noqa: BLE001 — no runtime, no stats: fail open
        return {}


def hbm_stats() -> dict:
    """:func:`device_memory_stats` as ``hbm_bytes_in_use`` /
    ``hbm_bytes_limit`` / derived headroom in GiB."""
    s = device_memory_stats()
    used, limit = s.get("bytes_in_use"), s.get("bytes_limit")
    out = {}
    if used is not None:
        out["hbm_bytes_in_use"] = used
    if limit is not None:
        out["hbm_bytes_limit"] = limit
    if used is not None and limit is not None:
        out["hbm_headroom_gib"] = round((limit - used) / 2**30, 2)
    return out


def tree_bytes(tree) -> int:
    """Resident bytes of ``tree``: a module's parameters and buffers (each
    storage once: a tied embedding counts once) plus the packed leaves of
    its quantized projections, or every tensor of a nested dict / list /
    tuple (a quantized leaf counts its packed arrays, exactly what a full
    weight read streams)."""
    if isinstance(tree, torch.nn.Module):
        seen = {}
        for t in list(tree.parameters()) + list(tree.buffers()):
            seen[t.data_ptr()] = t.numel() * t.element_size()
        packed = 0
        for m in tree.modules():
            # a quantized projection keeps its leaf (NF4Tensor, ...) as a
            # plain attribute: neither a parameter nor a buffer
            w = m.__dict__.get("weight")
            if w is not None and not isinstance(w, torch.Tensor):
                packed += int(getattr(w, "nbytes", 0) or 0)
        return sum(seen.values()) + packed
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


# --------------------------------------------------------------------------
# Training model (JAX bench.py's per-token FLOP model)
# --------------------------------------------------------------------------


def _matmul_leaves(tree):
    """``(name, logical shape)`` of every weight leaf of ``tree``: a
    module's parameters and its quantized projections' leaves (named as
    the kernel they replace), or a ``{name: tensor | quantized leaf}``
    state."""
    if isinstance(tree, torch.nn.Module):
        for mname, mod in tree.named_modules():
            prefix = mname + "." if mname else ""
            for pname, p in mod.named_parameters(recurse=False):
                yield prefix + pname, tuple(p.shape)
            w = mod.__dict__.get("weight")
            if w is not None and not isinstance(w, torch.Tensor):
                yield prefix + "kernel", tuple(w.shape)
        return
    for name, leaf in tree.items():
        yield name, tuple(getattr(leaf, "shape", ()))


def matmul_param_count(tree, *, tied_head: bool) -> int:
    """Total elements of the kernels that run as matmuls per token: every
    2-D (or stacked 3-D) ``.kernel`` leaf; the embedding gather is not a
    matmul, but a tied head reuses the embedding as one, so it is added
    back once. A quantized leaf counts its logical elements."""
    n = 0
    embed_size = 0
    for name, shape in _matmul_leaves(tree):
        if len(shape) not in (2, 3):
            continue
        size = 1
        for d in shape:
            size *= int(d)
        if "tok_embed" in name:
            embed_size = max(embed_size, size)
        elif name.endswith(".kernel"):
            n += size
    if tied_head:
        n += embed_size
    return n


def flops_per_token(m: int, n_layer: int, seq: int, dim: int,
                    *, train_full: bool) -> float:
    """Per-token FLOPs. ``m`` = matmul param elements (2 FLOPs each fwd);
    attention (causal, avg S/2 keys): QK^T + AV = 4·(S/2)·D per layer fwd.
    Full training = 3× fwd (bwd = dX + dW). QLoRA freezes the base, so the
    weight-gradient matmuls are skipped: 2× fwd for the matmul part, but
    attention backward is still full (no weights there) = 3× its fwd."""
    matmul_fwd = 2.0 * m
    attn_fwd = 2.0 * n_layer * seq * dim  # 4·(S/2)·D per layer
    if train_full:
        return 3.0 * (matmul_fwd + attn_fwd)
    return 2.0 * matmul_fwd + 3.0 * attn_fwd


# --------------------------------------------------------------------------
# Serving model: per-dispatch FLOPs and HBM bytes
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Matmul/attention geometry a serving forward pays per token."""

    matmul_params: int     # weight elements hit by matmuls per token
    n_layer: int
    attn_dim: int          # query width per token (n_head · head_dim)
    kv_dim: int            # KV width per cached token (n_kv_head · head_dim)
    hidden: int = 0        # residual-stream width
    vocab: int = 0


def geometry_from_config(cfg) -> Geometry | None:
    """:class:`Geometry` of a Qwen3 config, or None for a config the
    analytic model does not cover (the gauges then carry no samples).

    Reproduces :func:`matmul_param_count` of the real weights: head
    ``V·d`` (tied or not, the logits matmul runs either way) + per layer
    ``d·q + 2·d·kv`` (QKV) + ``q·d`` (output) + ``3·d·inter`` (MLP)."""
    if cfg is None:
        return None
    n_layer = getattr(cfg, "n_layer", None)
    vocab = getattr(cfg, "vocab_size", None)
    if not n_layer or not vocab:
        return None
    if not (hasattr(cfg, "hidden_size") and hasattr(cfg, "n_kv_head")):
        return None
    d = cfg.hidden_size
    q = cfg.n_head * cfg.head_dim
    kv = cfg.n_kv_head * cfg.head_dim
    inter = cfg.intermediate_size
    m = vocab * d + n_layer * (d * q + 2 * d * kv + q * d + 3 * d * inter)
    return Geometry(m, n_layer, q, kv, hidden=d, vocab=vocab)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """FLOPs/bytes per serving dispatch and the card peaks to divide by.

    ``weight_bytes`` is the RESIDENT model (packed bytes for quantized
    formats); ``kv_bytes_per_token`` is one cached token's KV rows across
    all layers. ``peak_flops`` / ``peak_hbm_bw`` are None on a device with
    no data-sheet entry: :meth:`mfu` and :meth:`hbm_util` then give None.
    Build with :meth:`from_model` (None when the geometry can't be
    derived)."""

    geometry: Geometry
    weight_bytes: int
    kv_bytes_per_token: int
    peak_flops: float | None
    peak_hbm_bw: float | None
    device_kind: str = "unknown"

    @classmethod
    def from_model(cls, model, *, cache_dtype=None,
                   device_kind: str | None = None,
                   peak_flops: float | None = None,
                   peak_hbm_bw: float | None = None) -> "CostModel | None":
        """The cost model of a served module (never raises: a family the
        model does not cover gives None). The peaks default to the
        attached card's (:func:`chip_peak`, :func:`chip_hbm_bw`) or
        ``device_kind``'s; pass them to divide by given numbers."""
        try:
            geom = geometry_from_config(getattr(model, "config", None))
            if geom is None:
                return None
            itemsize = torch.empty(
                (), dtype=cache_dtype or torch.bfloat16).element_size()
            if device_kind is None:
                device_kind = device_name(
                    getattr(model, "device", None)) or "cpu"
            if peak_flops is None:
                peak_flops = _lookup(device_kind, PEAKS)
            if peak_hbm_bw is None:
                peak_hbm_bw = _lookup(device_kind, HBM_BW)
            return cls(
                geometry=geom,
                weight_bytes=tree_bytes(model),
                kv_bytes_per_token=geom.n_layer * 2 * geom.kv_dim * itemsize,
                peak_flops=peak_flops,
                peak_hbm_bw=peak_hbm_bw,
                device_kind=device_kind,
            )
        except Exception:  # noqa: BLE001 — cost modeling must never be
            # able to fail engine construction
            return None

    # -- FLOPs ---------------------------------------------------------------

    def step_flops(self, new_tokens: int, attended_keys: float) -> float:
        """FLOPs of one forward over ``new_tokens`` positions that
        together attend ``attended_keys`` keys (sum over the new tokens
        of each one's visible context, itself included)."""
        g = self.geometry
        return (2.0 * g.matmul_params * new_tokens
                + 4.0 * g.attn_dim * g.n_layer * attended_keys)

    @staticmethod
    def chunk_keys(chunk_len: int, start: int) -> float:
        """``attended_keys`` of a causal prefill chunk of ``chunk_len``
        tokens starting at context offset ``start``."""
        return chunk_len * start + chunk_len * (chunk_len + 1) / 2.0

    @staticmethod
    def block_keys(n_steps: int, context: int) -> float:
        """``attended_keys`` of ``n_steps`` sequential decode steps for ONE
        slot whose context is ``context`` at block start."""
        return n_steps * context + n_steps * (n_steps + 1) / 2.0

    # -- bytes ---------------------------------------------------------------

    def step_bytes(self, weight_passes: float, kv_read_tokens: float,
                   new_tokens: int) -> float:
        """HBM bytes of a dispatch: ``weight_passes`` full weight reads (a
        decode block of n steps reads the weights n times; a prefill chunk
        once), ``kv_read_tokens`` cached tokens' KV rows read by
        attention, plus the writes of the ``new_tokens`` fresh rows.
        Activations are left out (noise next to the weights at serving
        batch sizes)."""
        return (weight_passes * self.weight_bytes
                + self.kv_bytes_per_token * (kv_read_tokens + new_tokens))

    # -- utilizations --------------------------------------------------------

    def mfu(self, flops: float, seconds: float) -> float | None:
        if seconds <= 0 or not self.peak_flops:
            return None
        return flops / seconds / self.peak_flops

    def hbm_util(self, nbytes: float, seconds: float) -> float | None:
        if seconds <= 0 or not self.peak_hbm_bw:
            return None
        return nbytes / seconds / self.peak_hbm_bw
