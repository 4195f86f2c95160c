"""Logging: env-levelled, coordinator-gated, optional per-process files
(port of ``llm_in_practise_tpu/obs/logging.py``).

``logging.basicConfig`` with an env-settable level, per-rank log files and
console output on the coordinator only. The coordinator is rank 0 of
``torch.distributed`` when a process group is initialized, and this
process otherwise.
"""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False

FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def _rank() -> int:
    """This process's rank in the default process group, or 0 without
    one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def setup_logging(
    *,
    level: str | None = None,
    log_dir: str | None = None,
    force: bool = False,
) -> None:
    """Configure root logging once.

    - ``level`` defaults to env ``LOG_LEVEL``, else INFO.
    - Console handler only on the coordinator process; with ``log_dir``
      every process also writes ``proc_{rank}.log``.
    """
    global _CONFIGURED
    # an explicit call with arguments always reconfigures: get_logger()'s
    # implicit default setup must not turn a later
    # setup_logging(log_dir=...) into a silent no-op
    if _CONFIGURED and not force and level is None and log_dir is None:
        return
    level = (level or os.environ.get("LOG_LEVEL", "INFO")).upper()
    rank = _rank()
    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        root.removeHandler(h)
    if rank == 0:
        console = logging.StreamHandler(sys.stderr)
        console.setFormatter(logging.Formatter(FORMAT))
        root.addHandler(console)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, f"proc_{rank}.log"))
        fh.setFormatter(logging.Formatter(FORMAT))
        root.addHandler(fh)
    if not root.handlers:  # non-coordinator without log_dir: swallow quietly
        root.addHandler(logging.NullHandler())
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    setup_logging()
    return logging.getLogger(name)
