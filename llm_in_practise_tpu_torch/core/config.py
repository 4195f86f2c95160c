"""Config tree with the reference's precedence semantics (a copy of
``llm_in_practise_tpu/core/config.py``: the port imports nothing of the
JAX package).

- defaults live in the dataclass,
- CLI flags (auto-generated from fields) override defaults,
- a JSON config file overrides CLI — the DeepSpeed precedence rule,
- ``"auto"`` string values are resolved by the consumer (the Trainer fills
  them from runtime facts: dataset size, …),
- mesh/topology is config, not env vars.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import types
import typing
from typing import Any

AUTO = "auto"


def _union_args(typ) -> tuple | None:
    """Arms of a Union, covering both ``Optional[X]`` and PEP 604 ``X | Y``."""
    origin = typing.get_origin(typ)
    if origin is typing.Union or origin is types.UnionType:
        return typing.get_args(typ)
    return None


def _field_types(cls) -> dict[str, Any]:
    hints = typing.get_type_hints(cls)
    return {f.name: hints[f.name] for f in dataclasses.fields(cls)}


def _coerce(value, typ):
    """Best-effort cast of a JSON/CLI value to the field's declared type."""
    if value is None or value == AUTO:
        return value
    arms = _union_args(typ)
    if arms is not None:  # Optional[...] / X | Y — try each arm
        for arm in arms:
            if arm is type(None):
                continue
            try:
                return _coerce(value, arm)
            except (TypeError, ValueError):
                continue
        return value
    if dataclasses.is_dataclass(typ) and isinstance(value, dict):
        return from_dict(typ, value)
    if typ is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    if typ in (int, float, str) and not isinstance(value, typ):
        return typ(value)
    return value


def from_dict(cls, d: dict):
    """Build a (possibly nested) config dataclass from a plain dict.

    Unknown keys raise — a misspelled knob silently ignored is the classic
    config bug the reference's ad-hoc parsing can't catch.
    """
    types = _field_types(cls)
    unknown = set(d) - set(types)
    if unknown:
        raise ValueError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    return cls(**{k: _coerce(v, types[k]) for k, v in d.items()})


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def merge(cfg, overrides: dict):
    """Return ``cfg`` with ``overrides`` applied (nested dicts recurse)."""
    types = _field_types(type(cfg))
    updates = {}
    for k, v in overrides.items():
        if k not in types:
            raise ValueError(f"unknown {type(cfg).__name__} key: {k}")
        current = getattr(cfg, k)
        if dataclasses.is_dataclass(current) and isinstance(v, dict):
            updates[k] = merge(current, v)
        else:
            updates[k] = _coerce(v, types[k])
    return dataclasses.replace(cfg, **updates)


def resolve_auto(cfg, resolvers: dict[str, Any]):
    """Replace ``"auto"`` field values using ``resolvers`` (name -> value or
    zero-arg callable). The DeepSpeed ``"auto"``-deferred-to-Trainer rule."""
    updates = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            updates[f.name] = resolve_auto(v, resolvers)
        elif v == AUTO:
            if f.name not in resolvers:
                raise ValueError(f"no auto-resolver for {f.name!r}")
            r = resolvers[f.name]
            updates[f.name] = r() if callable(r) else r
    return dataclasses.replace(cfg, **updates) if updates else cfg


def add_cli_args(parser: argparse.ArgumentParser, cls, prefix: str = "") -> None:
    """Auto-generate ``--flag``s from dataclass fields (nested: dotted)."""
    for f in dataclasses.fields(cls):
        typ = _field_types(cls)[f.name]
        if dataclasses.is_dataclass(typ):
            add_cli_args(parser, typ, prefix=f"{prefix}{f.name}.")
            continue
        arms = _union_args(typ)
        if arms is not None:
            non_none = [a for a in arms if a is not type(None)]
            typ = non_none[0] if non_none else str
        kind = {int: int, float: float, str: str}.get(typ, str)
        parser.add_argument(f"--{prefix}{f.name}", type=kind, default=None)


def load(
    cls,
    *,
    config_file: str | None = None,
    cli_namespace: argparse.Namespace | None = None,
    auto_resolvers: dict[str, Any] | None = None,
):
    """defaults < CLI < file, then resolve ``"auto"`` values.

    CLI flags left at None don't override; file keys always win over CLI
    (the reference's DeepSpeed-config precedence).
    """
    cfg = cls()
    if cli_namespace is not None:
        nested: dict = {}
        for key, val in vars(cli_namespace).items():
            if val is None:
                continue
            node = nested
            *parents, leaf = key.split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = val
        known = {f.name for f in dataclasses.fields(cls)}
        nested = {k: v for k, v in nested.items() if k in known}
        cfg = merge(cfg, nested)
    if config_file:
        with open(config_file) as f:
            cfg = merge(cfg, json.load(f))
    if auto_resolvers:
        cfg = resolve_auto(cfg, auto_resolvers)
    return cfg
