"""Frozen dataclasses of tensors: the port's counterpart of the flax pytrees.

Weight containers are ``dataclasses.dataclass(frozen=True)`` whose fields are
tensors, nested containers, or tuples of containers. These helpers map over
them and flatten them to ``{"decoder.qkv": tensor, ...}`` dicts whose keys are
the field paths (tuple elements are their indices: ``"stages.0.convt_w"``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch


def map_tensors(obj, fn: Callable, is_leaf: Optional[Callable[[object], bool]] = None):
    """Apply ``fn`` to every tensor leaf (and every node ``is_leaf`` accepts),
    rebuilding the containers."""
    if isinstance(obj, torch.Tensor) or (is_leaf is not None and is_leaf(obj)):
        return fn(obj)
    if isinstance(obj, tuple):
        return tuple(map_tensors(x, fn, is_leaf) for x in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(getattr(obj, f.name), fn, is_leaf)
            for f in dataclasses.fields(obj)})
    raise TypeError(f"not a tensor container: {type(obj).__name__}")


def flatten_tensors(obj, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{field.path: tensor}`` over every leaf, in field order."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    if isinstance(obj, tuple):
        items = [(str(i), x) for i, x in enumerate(obj)]
    elif dataclasses.is_dataclass(obj):
        items = [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)]
    else:
        raise TypeError(f"not a tensor container: {type(obj).__name__}")
    out: Dict[str, torch.Tensor] = {}
    for name, value in items:
        out.update(flatten_tensors(value, f"{prefix}.{name}" if prefix else name))
    return out
