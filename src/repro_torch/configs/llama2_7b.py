"""Llama2-7B — the paper's primary evaluation model (Table 3).

32L d_model=4096 32H (MHA) d_ff=11008 vocab=32000, 4k context.
"""
from repro_torch.config import FAMILY_DENSE, ModelConfig, RunConfig
from repro_torch.configs.registry import register


@register("llama2-7b")
def config() -> RunConfig:
    model = ModelConfig(
        name="llama2-7b",
        family=FAMILY_DENSE,
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=11008,
        vocab_size=32000,
        norm="rmsnorm",
        activation="silu",
    )
    return RunConfig(model=model)
