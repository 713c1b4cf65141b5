"""Config registry: lazy import of one module per architecture."""
from __future__ import annotations

import importlib
from typing import Callable, Dict

from repro_torch.config import RunConfig

_REGISTRY: Dict[str, Callable[[], RunConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], RunConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> RunConfig:
    if name not in _REGISTRY:
        importlib.import_module(
            "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))
    if name not in _REGISTRY:
        raise KeyError(f"config module for {name!r} did not register itself")
    return _REGISTRY[name]()
