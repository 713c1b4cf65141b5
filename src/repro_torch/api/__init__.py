"""Decode API of the port: Engine → DecodeSession → StepResult, with the
KV cache managers and the chunked-prefill scheduler."""
from repro_torch.api.cache import (CacheSpec, DenseKVCache, KVCacheManager,
                                   PagedKVCache)
from repro_torch.api.session import DecodeSession, Engine
from repro_torch.api.strategies import (DecodeStrategy, DenseStrategy,
                                        SpecEEStrategy, TreeStrategy,
                                        get_strategy)
from repro_torch.api.types import StepResult

__all__ = ["CacheSpec", "DecodeSession", "DecodeStrategy", "DenseKVCache",
           "DenseStrategy", "Engine", "KVCacheManager", "PagedKVCache",
           "SpecEEStrategy", "StepResult", "TreeStrategy", "get_strategy"]
