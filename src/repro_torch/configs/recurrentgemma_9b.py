"""RecurrentGemma-9B — RG-LRU + local attention hybrid, 1 attn : 2 recurrent.

38L d_model=4096 16H (MQA kv=1) head_dim=256 d_ff=12288 vocab=256000,
window 2048. The block pattern repeats (rglru, rglru, local_attention);
38 = 12*3 + 2 extra rglru, so the stack is two segments: twelve
three-block units, then two single RG-LRU units.
"""
from repro_torch.config import (FAMILY_HYBRID, LOCAL_ATTN, RGLRU, ModelConfig,
                                RGLRUConfig, RunConfig)
from repro_torch.configs.registry import register


def _pattern(n: int):
    pat = []
    while len(pat) < n:
        pat.extend((RGLRU, RGLRU, LOCAL_ATTN))
    return tuple(pat[:n])


@register("recurrentgemma-9b")
def config() -> RunConfig:
    model = ModelConfig(
        name="recurrentgemma-9b",
        family=FAMILY_HYBRID,
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        d_ff=12288,
        vocab_size=256000,
        head_dim=256,
        block_pattern=_pattern(38),
        rglru=RGLRUConfig(lru_width=4096, conv_kernel=4, window=2048),
        norm="rmsnorm",
        activation="gelu",
    )
    return RunConfig(model=model)
