"""Debug aids: NaN trapping, eager stepping, per-process seeding (port of
``llm_in_practise_tpu/obs/debug.py``).

- :func:`enable_debug` — trap NaNs (and optionally Infs) at the op that
  produces them. Torch has no global flag for this: the calling thread
  enters a ``TorchDispatchMode`` that checks every op's floating outputs
  and raises ``FloatingPointError``, and ``torch.autograd`` anomaly
  detection covers the backward. An engine's thread enters the same mode
  in each ``step()`` while debug is on, so a NaN the server would emit is
  trapped too. ``disable_jit`` makes engines built afterwards run their
  step bodies eagerly instead of capturing CUDA graphs (a mode cannot
  see inside a graph replay).
- :func:`seed_everything` — one seed, offset per process (the
  reference's ``seed + rank``; rank 0 until sharded serving): seeds numpy
  and torch and returns a seeded ``torch.Generator``.
- :func:`tap` — print a tensor with a label and return it; it raises
  inside a CUDA graph capture, where a print would read the capture's
  placeholder, not a replay's values.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class _FloatTrap(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first op whose floating output
    holds a NaN (``nans``) or an infinity (``infs``)."""

    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans = nans
        self.infs = infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not (isinstance(t, torch.Tensor)
                    and (t.is_floating_point() or t.is_complex())):
                continue
            if self.nans and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN produced by {func}")
            if self.infs and bool(torch.isinf(t).any()):
                raise FloatingPointError(f"Inf produced by {func}")
        return out


_state_lock = threading.Lock()
# the settings while debug is on (None: off), and what enable_debug found
_config: dict | None = None        # guarded-by: _state_lock
_saved_anomaly: bool | None = None  # guarded-by: _state_lock
_caller_mode: _FloatTrap | None = None  # the enabling thread's mode


def enable_debug(*, nans: bool = True, infs: bool = False,
                 disable_jit: bool = False) -> None:
    """Turn on op-level NaN trapping (and optionally Inf trapping / eager
    engine steps), on this thread and on every engine's step thread.

    ``infs`` is separate (off by default): inf is a legitimate sentinel
    in parts of this codebase (the samplers mask with ``-inf``), so
    trapping it flags correct inference code. ``disable_jit`` makes
    engines built afterwards step eagerly, so tracebacks map to Python
    lines and the trap sees every op (slow; debugging only). A second
    call replaces the first's settings."""
    global _config, _saved_anomaly, _caller_mode
    with _state_lock:
        if _saved_anomaly is None:   # remember the pre-debug state once
            _saved_anomaly = torch.is_anomaly_enabled()
        _config = {"nans": bool(nans), "infs": bool(infs),
                   "disable_jit": bool(disable_jit)}
        torch.autograd.set_detect_anomaly(bool(nans or infs))
        if _caller_mode is not None:
            _caller_mode.__exit__(None, None, None)
        _caller_mode = None
        if nans or infs:
            _caller_mode = _FloatTrap(nans, infs)
            _caller_mode.__enter__()


def disable_debug() -> None:
    """Restore the state from before the first :func:`enable_debug` call
    (call it on the thread that enabled debug: that thread's mode is the
    one it leaves)."""
    global _config, _saved_anomaly, _caller_mode
    with _state_lock:
        if _caller_mode is not None:
            _caller_mode.__exit__(None, None, None)
            _caller_mode = None
        if _saved_anomaly is not None:
            torch.autograd.set_detect_anomaly(_saved_anomaly)
        _config = None
        _saved_anomaly = None


def graphs_disabled() -> bool:
    """Whether ``enable_debug(disable_jit=True)`` is on: engines built now
    run eager step bodies instead of CUDA graphs."""
    cfg = _config
    return bool(cfg and cfg["disable_jit"])


def step_trap():
    """The context an engine's ``step()`` runs under: the NaN / Inf trap
    while debug traps either, else a no-op."""
    cfg = _config
    if not cfg or not (cfg["nans"] or cfg["infs"]):
        return contextlib.nullcontext()
    return _FloatTrap(cfg["nans"], cfg["infs"])


def seed_everything(seed: int, *, rank: int = 0,
                    device="cpu") -> torch.Generator:
    """Deterministic per-process seeding (the reference's ``seed +
    rank``): seeds numpy's and torch's global generators with ``seed +
    rank`` and returns a ``torch.Generator`` on ``device`` seeded the
    same. ``rank`` is 0 until serving is sharded across processes."""
    s = (int(seed) + int(rank)) % 2**32
    np.random.seed(s)
    torch.manual_seed(s)
    gen = torch.Generator(device=device)
    gen.manual_seed(s)
    return gen


def tap(value: torch.Tensor, label: str = "tap") -> torch.Tensor:
    """Print ``value`` with ``label`` and return it unchanged, so it drops
    into an expression. Raises inside a CUDA graph capture."""
    if (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(
            f"tap({label!r}) inside a CUDA graph capture would print the "
            "capture's placeholder, not a replay's values; run the step "
            "eagerly (enable_debug(disable_jit=True))")
    print(f"{label}: {value}", flush=True)
    return value
