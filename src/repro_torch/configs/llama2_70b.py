"""Llama2-70B (paper Table 3): 80L d_model=8192 64H (GQA kv=8) d_ff=28672.

Its serving policy is JAX's 2-D tensor parallelism
(``ShardingConfig(policy="tp2d")``). Its 140 GB of bf16 weights do not fit
one card.
"""
from repro_torch.config import (FAMILY_DENSE, ModelConfig, RunConfig,
                                ShardingConfig)
from repro_torch.configs.registry import register


@register("llama2-70b")
def config() -> RunConfig:
    model = ModelConfig(
        name="llama2-70b",
        family=FAMILY_DENSE,
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=32000,
        norm="rmsnorm",
        activation="silu",
    )
    return RunConfig(model=model, sharding=ShardingConfig(policy="tp2d"))
