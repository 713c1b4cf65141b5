"""Llama2-13B (paper Table 3): 40L d_model=5120 40H d_ff=13824 vocab=32000."""
from repro_torch.config import FAMILY_DENSE, ModelConfig, RunConfig
from repro_torch.configs.registry import register


@register("llama2-13b")
def config() -> RunConfig:
    model = ModelConfig(
        name="llama2-13b",
        family=FAMILY_DENSE,
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        d_ff=13824,
        vocab_size=32000,
        norm="rmsnorm",
        activation="silu",
    )
    return RunConfig(model=model)
