"""Command R+ 104B — dense GQA, no bias.

[hf:CohereForAI/c4ai-command-r-v01; unverified]
64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.

Its serving policy is JAX's 2-D tensor parallelism
(``ShardingConfig(policy="tp2d")``: 208 GB of bf16 weights).
"""
from repro_torch.config import (FAMILY_DENSE, ModelConfig, RunConfig,
                                ShardingConfig)
from repro_torch.configs.registry import register


@register("command-r-plus-104b")
def config() -> RunConfig:
    model = ModelConfig(
        name="command-r-plus-104b",
        family=FAMILY_DENSE,
        num_layers=64,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        d_ff=33792,
        vocab_size=256000,
        use_bias=False,
        norm="layernorm",
        activation="silu",
        rope_theta=75000000.0,
    )
    return RunConfig(model=model, sharding=ShardingConfig(policy="tp2d"))
