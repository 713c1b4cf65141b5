"""HuBERT-XLarge — encoder-only audio transformer (masked unit prediction).

48L d_model=1280 16H (kv=16, MHA) d_ff=5120 vocab=504 (cluster-unit
codebook). Encoder-only: bidirectional attention without RoPE, no decode
step, SpecEE disabled (no autoregressive LM-head search). The conv
waveform frontend is a stub: the batch carries frame embeddings (batch,
seq, d_model), through a learned feature projection.
"""
from repro_torch.config import (FAMILY_AUDIO, ModelConfig, RunConfig,
                                SpecEEConfig)
from repro_torch.configs.registry import register


@register("hubert-xlarge")
def config() -> RunConfig:
    model = ModelConfig(
        name="hubert-xlarge",
        family=FAMILY_AUDIO,
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        causal=False,
        use_bias=True,
        norm="layernorm",
        activation="gelu",
        gated_mlp=False,
        frontend="audio_frames",
        frontend_tokens=0,   # frames ARE the sequence; nothing prepended
    )
    return RunConfig(model=model, specee=SpecEEConfig(enabled=False))
