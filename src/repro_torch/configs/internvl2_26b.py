"""InternVL2-26B — InternViT frontend (stub) + InternLM2-20B decoder.

Backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553. The
vision tower is a stub: the batch carries precomputed patch embeddings
(batch, frontend_tokens, 1024), projected to d_model and prepended to the
text. Its serving policy is JAX's 2-D tensor parallelism
(``ShardingConfig(policy="tp2d")``). Its 40 GB of bf16 weights fit one
card.
"""
from repro_torch.config import (FAMILY_VLM, ModelConfig, RunConfig,
                                ShardingConfig)
from repro_torch.configs.registry import register


@register("internvl2-26b")
def config() -> RunConfig:
    model = ModelConfig(
        name="internvl2-26b",
        family=FAMILY_VLM,
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=92553,
        frontend="vision_patches",
        frontend_tokens=256,
        norm="rmsnorm",
        activation="silu",
    )
    return RunConfig(model=model, sharding=ShardingConfig(policy="tp2d"))
