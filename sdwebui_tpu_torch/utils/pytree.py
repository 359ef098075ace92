"""Dotted-key flatten/unflatten between state-dict names and param trees.

Copy of ``sdwebui_tpu/utils/pytree.py``."""

from __future__ import annotations


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict → {'a.b.c': leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat: dict) -> dict:
    """{'a.b.c': leaf} → nested dict keyed by path segments."""
    out: dict = {}
    for key, v in flat.items():
        parts = key.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out
