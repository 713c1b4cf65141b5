"""DBRX-132B — fine-grained MoE, 16 experts top-4.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
Its serving policy is JAX's 2-D tensor parallelism with the experts over
the data axis (``ShardingConfig(policy="tp2d")``). Its 264 GB of bf16
weights do not fit one card.
"""
from repro_torch.config import (FAMILY_MOE, ModelConfig, MoEConfig,
                                RunConfig, ShardingConfig)
from repro_torch.configs.registry import register


@register("dbrx-132b")
def config() -> RunConfig:
    model = ModelConfig(
        name="dbrx-132b",
        family=FAMILY_MOE,
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        moe=MoEConfig(num_experts=16, num_experts_per_tok=4,
                      expert_d_ff=10752),
        norm="layernorm",
        activation="silu",
        rope_theta=500000.0,
    )
    return RunConfig(model=model, sharding=ShardingConfig(policy="tp2d"))
