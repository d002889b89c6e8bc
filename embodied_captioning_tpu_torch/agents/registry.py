"""Trainer registry, by the JAX package's trainer names."""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, type] = {}


def register_trainer(name: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        _REGISTRY[name] = cls
        return cls

    return deco


def get_trainer(name: str) -> type:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown trainer {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_trainers():
    return sorted(_REGISTRY)
