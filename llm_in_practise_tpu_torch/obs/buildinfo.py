"""Build/version identity for the serving fleet — ``llm_build_info`` (a
copy of ``llm_in_practise_tpu/obs/buildinfo.py``, which imports no JAX;
the version is the port package's own).

A fleet rollup that compares replicas is meaningless
without knowing WHAT each replica runs: the canary verdict is "per
version", reset detection wants to notice an incarnation change, and a
``BENCH_*.json`` artifact that doesn't record the code that produced it
cannot be compared against the next run. This module is the one
definition of that identity, exposed the way Prometheus ecosystems do
it — an **info gauge**: constant value ``1`` whose labels carry the
facts, so PromQL joins pivot any series by version::

    llm_goodput_tokens_total * on (instance) group_left (version)
        llm_build_info

Three labels, most-stable first:

- ``version`` — the human-facing release name. Resolution order:
  ``LLM_TPU_BUILD_VERSION`` env (deploy manifests set it per rollout
  leg), else ``llm_in_practise_tpu_torch.__version__``, else ``"dev"``.
- ``git_sha`` — short commit id. ``LLM_TPU_BUILD_SHA`` env, else read
  from the repo's ``.git`` (no subprocess: ``HEAD`` → ref file; works
  in containers without a git binary), else ``"unknown"``.
- ``config_hash`` — fingerprint of the server's own effective config
  (engine knobs, routing mode, cache flags …): two replicas on the
  same sha with different flags are different deployments and must not
  share a canary leg's verdict.

Every server passes its config dict to :func:`register_build_info`
from ``_build_registry``; the labels are resolved ONCE at registration
(identity cannot change mid-process) but rendered through the normal
scrape callback, so the family behaves like every other.
"""

from __future__ import annotations

import hashlib
import json
import os


def config_fingerprint(config: object) -> str:
    """Stable 12-hex-char fingerprint of a config mapping/value.

    Canonical-JSON sha256 prefix; anything non-serializable degrades to
    its ``repr`` (the fingerprint must never raise — it runs inside
    server construction)."""
    try:
        canon = json.dumps(config, sort_keys=True, default=repr)
    except (TypeError, ValueError):
        canon = repr(config)
    return hashlib.sha256(canon.encode()).hexdigest()[:12]


def _package_version() -> str:
    try:
        import llm_in_practise_tpu_torch

        got = getattr(llm_in_practise_tpu_torch, "__version__", None)
        return str(got) if got else "dev"
    except Exception:  # noqa: BLE001 — identity is best-effort metadata
        return "dev"


def _git_sha() -> str:
    """Short HEAD sha read straight from ``.git`` (file I/O only)."""
    here = os.path.dirname(os.path.abspath(__file__))
    for _ in range(6):
        git_dir = os.path.join(here, ".git")
        if os.path.isdir(git_dir):
            try:
                with open(os.path.join(git_dir, "HEAD"),
                          encoding="utf-8") as f:
                    head = f.read().strip()
                if head.startswith("ref:"):
                    ref = head.split(None, 1)[1]
                    ref_path = os.path.join(git_dir, *ref.split("/"))
                    if os.path.exists(ref_path):
                        with open(ref_path, encoding="utf-8") as f:
                            return f.read().strip()[:12]
                    packed = os.path.join(git_dir, "packed-refs")
                    if os.path.exists(packed):
                        with open(packed, encoding="utf-8") as f:
                            for line in f:
                                if line.strip().endswith(ref):
                                    return line.split()[0][:12]
                    return "unknown"
                return head[:12]
            except OSError:
                return "unknown"
        parent = os.path.dirname(here)
        if parent == here:
            break
        here = parent
    return "unknown"


def build_info(config: object = None) -> dict:
    """The identity labels: ``{"version", "git_sha", "config_hash"}``.

    Env overrides (``LLM_TPU_BUILD_VERSION`` / ``LLM_TPU_BUILD_SHA``)
    win — the deploy manifest knows the rollout leg better than the
    checkout does."""
    return {
        "version": os.environ.get("LLM_TPU_BUILD_VERSION")
        or _package_version(),
        "git_sha": os.environ.get("LLM_TPU_BUILD_SHA") or _git_sha(),
        "config_hash": config_fingerprint(config) if config is not None
        else "none",
    }


def register_build_info(registry, config: object = None) -> dict:
    """Register the ``llm_build_info`` info gauge on ``registry`` (any
    object with ``gauge_func``) and return the resolved labels.

    The labels resolve once, here: a server's identity is fixed for its
    lifetime, and re-reading env/git on every scrape would let a scrape
    observe an identity the running code never had."""
    labels = build_info(config)

    registry.gauge_func(
        "llm_build_info",
        lambda: [(labels, 1.0)],
        "constant 1; labels carry the build identity "
        "(version / git_sha / config_hash) for per-version joins")
    return labels
