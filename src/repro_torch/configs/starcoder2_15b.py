"""StarCoder2-15B — GQA + RoPE, layernorm + bias.

[arXiv:2402.19173; hf]
40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
"""
from repro_torch.config import FAMILY_DENSE, ModelConfig, RunConfig
from repro_torch.configs.registry import register


@register("starcoder2-15b")
def config() -> RunConfig:
    model = ModelConfig(
        name="starcoder2-15b",
        family=FAMILY_DENSE,
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=4,
        d_ff=24576,
        vocab_size=49152,
        use_bias=True,
        norm="layernorm",
        activation="gelu",
        gated_mlp=False,
        rope_theta=100000.0,
    )
    return RunConfig(model=model)
