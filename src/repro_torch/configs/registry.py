"""Config registry: lazy import of one module per architecture."""
from __future__ import annotations

import importlib
from typing import Callable, Dict, List

from repro_torch.config import RunConfig

# The archs the port registers: the JAX registry's list, in its order
# (``repro/configs/registry.py``).
ARCHS: List[str] = [
    # assigned pool
    "dbrx-132b",
    "qwen3-moe-235b-a22b",
    "deepseek-7b",
    "minicpm-2b",
    "command-r-plus-104b",
    "starcoder2-15b",
    "internvl2-26b",
    "hubert-xlarge",
    "recurrentgemma-9b",
    "mamba2-130m",
    # paper's own models (for benchmarks vs. the paper's tables)
    "llama2-7b",
    "llama2-13b",
    "llama2-70b",
]

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
