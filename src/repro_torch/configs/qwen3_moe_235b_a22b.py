"""Qwen3-MoE-235B-A22B — 128 experts top-8.

94L d_model=4096 64H (GQA kv=4) head_dim=64 d_ff=1536 vocab=151936, MoE
128e top-8; d_ff=1536 is the per-expert (moe_intermediate) width. Its
serving policy is JAX's 2-D tensor parallelism
(``ShardingConfig(policy="tp2d")``). Its 470 GB of bf16 weights do not fit
one card.
"""
from repro_torch.config import (FAMILY_MOE, ModelConfig, MoEConfig,
                                RunConfig, ShardingConfig)
from repro_torch.configs.registry import register


@register("qwen3-moe-235b-a22b")
def config() -> RunConfig:
    model = ModelConfig(
        name="qwen3-moe-235b-a22b",
        family=FAMILY_MOE,
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        d_ff=1536,
        vocab_size=151936,
        head_dim=64,
        moe=MoEConfig(num_experts=128, num_experts_per_tok=8,
                      expert_d_ff=1536),
        norm="rmsnorm",
        activation="silu",
        rope_theta=1000000.0,
    )
    return RunConfig(model=model, sharding=ShardingConfig(policy="tp2d"))
