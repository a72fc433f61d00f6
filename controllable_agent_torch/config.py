"""Config system: dataclass trees + ``key=value`` overrides (mirror of
``controllable_agent_tpu/config.py``)."""

from __future__ import annotations

import dataclasses
import json
import typing as tp

T = tp.TypeVar("T")


def _convert(value: str, target_type: tp.Any) -> tp.Any:
    origin = tp.get_origin(target_type)
    if origin is tp.Union:  # Optional[...]
        args = [a for a in tp.get_args(target_type) if a is not type(None)]
        if value.lower() in ("none", "null"):
            return None
        return _convert(value, args[0])
    if target_type is bool or value.lower() in ("true", "false"):
        return value.lower() == "true"
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    if origin in (tuple, list):
        parsed = json.loads(value) if value.startswith("[") else value.split(",")
        sub = tp.get_args(target_type)
        subtype = sub[0] if sub else str
        seq = [_convert(str(v), subtype) for v in parsed]
        return tuple(seq) if origin is tuple else seq
    return value


def apply_overrides(cfg: T, overrides: tp.Sequence[str]) -> T:
    """Apply ``a.b.c=value`` overrides to a (frozen or mutable) dataclass
    tree, returning a new tree. Unknown keys raise."""
    updates: tp.Dict[str, str] = {}
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override {ov!r} is not of the form key=value")
        key, value = ov.split("=", 1)
        updates[key] = value

    def rec(node: tp.Any, prefix: str) -> tp.Any:
        if not dataclasses.is_dataclass(node):
            return node
        hints = tp.get_type_hints(type(node))
        changes: tp.Dict[str, tp.Any] = {}
        for field in dataclasses.fields(node):
            path = f"{prefix}{field.name}"
            child = getattr(node, field.name)
            if dataclasses.is_dataclass(child):
                new_child = rec(child, path + ".")
                if new_child is not child:
                    changes[field.name] = new_child
            elif path in updates:
                changes[field.name] = _convert(updates.pop(path),
                                               hints.get(field.name, str))
        return dataclasses.replace(node, **changes) if changes else node

    out = rec(cfg, "")
    if updates:
        raise ValueError(f"Unknown override keys: {sorted(updates)}")
    return out


def to_flat_dict(cfg: tp.Any, prefix: str = "") -> tp.Dict[str, tp.Any]:
    """Flatten a dataclass tree to {dotted_key: value}."""
    out: tp.Dict[str, tp.Any] = {}
    for field in dataclasses.fields(cfg):
        value = getattr(cfg, field.name)
        key = f"{prefix}{field.name}"
        if dataclasses.is_dataclass(value):
            out.update(to_flat_dict(value, key + "."))
        else:
            out[key] = value
    return out
