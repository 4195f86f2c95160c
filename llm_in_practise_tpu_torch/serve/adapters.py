"""Serving LoRA adapters as extra model names (vLLM's ``--lora-modules``).

Port of ``llm_in_practise_tpu/serve/adapters.py``. The reference serves
fine-tuned adapters with ``vllm serve ... --enable-lora --lora-modules
name=/path/to/adapter``: one base model, extra model names backed by
LoRA deltas, picked per request by the OpenAI ``model`` field.
:func:`build_adapter_engines` builds one shared
:class:`~.engine.InferenceEngine` with an
:class:`~.multi_lora.AdapterRegistry` and returns engine-shaped
:class:`~.multi_lora.AdapterHandle` views, so every adapter rides the
same dispatch and the base weights are on the card once. The
engine-per-adapter merged-weight path is kept, with a warning, for a
caller that passes per-adapter engine knobs (``engine_kw_for``). Adapters
are the ``adapter.msgpack`` + ``adapter.json`` pairs that either
package's ``save_named`` writes.
"""

from __future__ import annotations

import logging
import os

from llm_in_practise_tpu_torch.serve.engine import InferenceEngine

_log = logging.getLogger(__name__)


def parse_lora_modules(specs: list[str]) -> dict[str, str]:
    """``["name=/path", ...]`` -> ``{name: path}`` (the vLLM CLI syntax)."""
    out = {}
    for spec in specs:
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            raise ValueError(f"expected name=path, got {spec!r}")
        out[name] = path
    return out


def load_adapter(base_params: dict, adapter_path: str, cfg) -> dict:
    """Restore one adapter checkpoint and merge it into ``base_params``
    (the port's dense state of the model of ``cfg``)."""
    from llm_in_practise_tpu_torch.peft.lora import merge_lora
    from llm_in_practise_tpu_torch.serve.multi_lora import load_adapter_tree

    if os.path.isdir(adapter_path):
        adapter_path = os.path.join(adapter_path, "adapter.msgpack")
    lora, lcfg = load_adapter_tree(adapter_path, cfg)
    dev = next(iter(base_params.values())).device
    lora = {n: {k: t.to(dev) for k, t in ab.items()} for n, ab in lora.items()}
    return merge_lora(base_params, lora, lcfg)


def build_adapter_engines(model, base_params: dict | None,
                          modules: dict[str, str], param_transform=None,
                          engine_kw_for=None, **engine_kw) -> dict:
    """Adapter name -> engine-shaped handle, for ``OpenAIServer``.

    Default (registry) path: one shared :class:`~.engine.InferenceEngine`
    over ``model`` with an :class:`~.multi_lora.AdapterRegistry`; each
    name maps to an :class:`~.multi_lora.AdapterHandle` that pins its
    adapter at ``submit``. ``base_params`` is not needed there (the
    weights are the model's).

    Engine-per-adapter path, warned, when ``engine_kw_for`` is given:
    each adapter merged into ``base_params`` (the dense state of
    ``model``), post-processed by ``param_transform`` when given, served
    by its own model and engine with ``engine_kw`` and
    ``engine_kw_for(name)``."""
    if engine_kw_for is not None:
        _log.warning(
            "engine-per-adapter path (per-adapter engine kwargs "
            "requested): each of the %d adapter(s) pays full base-model "
            "memory; the batched multi-LoRA registry "
            "(serve/multi_lora.py) shares one engine across adapters",
            len(modules))
        from llm_in_practise_tpu_torch.models.qwen3 import Qwen3

        if base_params is None:
            raise ValueError("the engine-per-adapter path merges into "
                             "base_params: pass the dense state")
        cfg = model.config
        engines = {}
        for name, path in modules.items():
            merged = load_adapter(base_params, path, cfg)
            if param_transform is not None:
                merged = param_transform(merged)
            m = Qwen3(cfg, device="meta")
            m.load_state(merged)
            engines[name] = InferenceEngine(
                m, **{**engine_kw, **engine_kw_for(name)})
        return engines

    from llm_in_practise_tpu_torch.serve.multi_lora import (
        AdapterHandle,
        AdapterRegistry,
    )

    if param_transform is not None:
        raise NotImplementedError(
            "param_transform places the merged weights of the "
            "engine-per-adapter path; the shared registry engine serves "
            "the model's own weights (tensor-parallel placement is "
            "ROADMAP.md queue A item 14)")
    registry = AdapterRegistry(model)
    engine = InferenceEngine(model, adapter_registry=registry, **engine_kw)
    for name, path in modules.items():
        registry.register(name, path)
    return {name: AdapterHandle(engine, name) for name in modules}
