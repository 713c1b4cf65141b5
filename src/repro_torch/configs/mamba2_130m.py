"""Mamba2-130M — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]
24L d_model=768 vocab=50280, ssm_state=128, expand=2, head_dim=64.
"""
from repro_torch.config import FAMILY_SSM, ModelConfig, RunConfig, SSMConfig
from repro_torch.configs.registry import register


@register("mamba2-130m")
def config() -> RunConfig:
    model = ModelConfig(
        name="mamba2-130m",
        family=FAMILY_SSM,
        num_layers=24,
        d_model=768,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, conv_kernel=4,
                      chunk_size=64),
        tie_embeddings=True,
        norm="rmsnorm",
    )
    return RunConfig(model=model)
