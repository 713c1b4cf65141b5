"""DeepSeek-7B — llama-arch dense MHA.

[arXiv:2401.02954; hf]
30L d_model=4096 32H (kv=32, i.e. MHA) d_ff=11008 vocab=102400.
"""
from repro_torch.config import FAMILY_DENSE, ModelConfig, RunConfig
from repro_torch.configs.registry import register


@register("deepseek-7b")
def config() -> RunConfig:
    model = ModelConfig(
        name="deepseek-7b",
        family=FAMILY_DENSE,
        num_layers=30,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=11008,
        vocab_size=102400,
        norm="rmsnorm",
        activation="silu",
    )
    return RunConfig(model=model)
