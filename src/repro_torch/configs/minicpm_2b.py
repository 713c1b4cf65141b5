"""MiniCPM-2B — llama-like dense, WSD learning-rate schedule.

[arXiv:2404.06395; hf]
40L d_model=2304 36H (kv=36, MHA) d_ff=5760 vocab=122753. Tied embeddings.
"""
from repro_torch.config import (FAMILY_DENSE, ModelConfig, RunConfig,
                                TrainConfig)
from repro_torch.configs.registry import register


@register("minicpm-2b")
def config() -> RunConfig:
    model = ModelConfig(
        name="minicpm-2b",
        family=FAMILY_DENSE,
        num_layers=40,
        d_model=2304,
        num_heads=36,
        num_kv_heads=36,
        d_ff=5760,
        vocab_size=122753,
        tie_embeddings=True,
        norm="rmsnorm",
        activation="silu",
    )
    # MiniCPM's signature Warmup-Stable-Decay schedule
    train = TrainConfig(schedule="wsd", learning_rate=1e-2 * (256 / 2304))
    return RunConfig(model=model, train=train)
