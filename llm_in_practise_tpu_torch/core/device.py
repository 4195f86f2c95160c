"""Device selection: the card unless the caller asks for the CPU.

There is no silent CPU fallback anywhere in the port: a missing CUDA
runtime is an error unless ``device="cpu"`` was passed explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda:0``; an explicit device is returned as given.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and this process has no CUDA runtime.
    """
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available in this process; pass device='cpu' "
                "to run on the CPU (the port never falls back silently)")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev
