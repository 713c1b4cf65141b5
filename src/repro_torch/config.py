"""Configuration for the PyTorch port (counterpart of ``repro/config.py``).

The port keeps its own copy of the configuration dataclasses, holding only
the fields the ported decode and training paths read, so that it never
imports the JAX package. Field names, defaults and ``smoke()`` reductions
are those of ``repro.config``; the tests hold the two against each
other.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

ATTN = "attention"            # global causal (or bidirectional for
#                               encoders) attention
LOCAL_ATTN = "local_attention"  # sliding-window attention
RGLRU = "rglru"               # Real-Gated LRU recurrence (RecurrentGemma)
SSD = "ssd"                   # Mamba2 state-space duality block

FAMILY_DENSE = "dense"
FAMILY_MOE = "moe"
FAMILY_VLM = "vlm"
FAMILY_AUDIO = "audio"
FAMILY_HYBRID = "hybrid"
FAMILY_SSM = "ssm"


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    num_experts_per_tok: int
    # d_ff of each expert (may differ from the dense d_ff field)
    expert_d_ff: int
    # load-balancing loss weight used in training
    router_aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) hyperparameters."""
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_kernel: int = 4
    chunk_size: int = 64

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU hyperparameters."""
    lru_width: Optional[int] = None       # defaults to d_model
    conv_kernel: int = 4
    window: int = 2048                    # local attention window for
    #                                       LOCAL_ATTN blocks


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    block_pattern: Tuple[str, ...] = ()
    causal: bool = True         # False for encoder-only archs
    use_bias: bool = False
    norm: str = "rmsnorm"
    activation: str = "silu"
    rope_theta: float = 10000.0
    gated_mlp: bool = True
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # modality frontend stub: "none" | "vision_patches" | "audio_frames"
    frontend: str = "none"
    frontend_tokens: int = 256  # patches/frames prepended by the stub
    dtype: str = "bfloat16"     # compute/weight dtype on the card

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads == 0:
            return 0
        return self.d_model // self.num_heads

    def is_decoder(self) -> bool:
        return self.causal

    def supports_long_context(self) -> bool:
        """True iff no block is quadratic in sequence length (global
        attention)."""
        return all(b in (SSD, RGLRU, LOCAL_ATTN) for b in self.blocks())

    def blocks(self) -> Tuple[str, ...]:
        if self.block_pattern:
            assert len(self.block_pattern) == self.num_layers
            return self.block_pattern
        kind = SSD if self.family == FAMILY_SSM else ATTN
        return tuple([kind] * self.num_layers)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), as
        ``repro/config.py:129`` counts it."""
        d = self.d_model
        hd = self.resolved_head_dim()
        n_mlp_mats = 3 if self.gated_mlp else 2
        total = self.vocab_size * d              # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d         # lm head
        for kind in self.blocks():
            if kind in (ATTN, LOCAL_ATTN):
                total += (d * self.num_heads * hd
                          + 2 * d * self.num_kv_heads * hd
                          + self.num_heads * hd * d)
                total += self._ffn_count(n_mlp_mats, router=True)
                total += 2 * d                   # two norms
            elif kind == RGLRU:
                w = (self.rglru.lru_width or d) if self.rglru else d
                k = self.rglru.conv_kernel if self.rglru else 4
                # conv + in/out projections + gates (a, input gate)
                total += 2 * d * w + w * d + 2 * w * w + k * w
                total += self._ffn_count(n_mlp_mats, router=False)
                total += 2 * d
            elif kind == SSD:
                s = self.ssm or SSMConfig()
                di = s.d_inner(d)
                nh = s.n_heads(d)
                # in_proj produces [z, x, B, C, dt]
                total += d * (2 * di + 2 * s.d_state + nh)
                total += s.conv_kernel * (di + 2 * s.d_state)
                total += di * d                  # out proj
                total += 2 * nh + d              # A_log, D, norm
            else:
                raise ValueError(f"no parameter count for block {kind!r}")
        total += d                               # final norm
        return total

    def _ffn_count(self, n_mlp_mats: int, router: bool) -> int:
        """One block's FFN parameters: the expert banks (and, in an
        attention block, the router) under MoE, else the MLP. JAX counts
        no router for an RG-LRU block; the count is its."""
        d = self.d_model
        if self.moe is None:
            return n_mlp_mats * d * self.d_ff
        e = self.moe
        return (e.num_experts * n_mlp_mats * d * e.expert_d_ff
                + (d * e.num_experts if router else 0))

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU tests: ``repro.config``'s
        reduction of every field the port has."""
        kw: Dict[str, Any] = dict(
            name=self.name + "-smoke",
            num_layers=6 if self.block_pattern else min(self.num_layers, 4),
            d_model=128,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=0,
            d_ff=256,
            vocab_size=512,
            head_dim=32 if self.num_heads else 0,
            frontend_tokens=(8 if self.frontend != "none"
                             else self.frontend_tokens),
            dtype="float32")
        # kv == heads (MHA) stays MHA; otherwise kv < heads
        if self.num_heads:
            if self.num_kv_heads == self.num_heads:
                kw["num_kv_heads"] = 4
            elif self.num_kv_heads == 1:
                kw["num_kv_heads"] = 1
            else:
                kw["num_kv_heads"] = 2
        if self.moe is not None:
            kw["moe"] = MoEConfig(
                num_experts=4,
                num_experts_per_tok=min(2, self.moe.num_experts_per_tok),
                expert_d_ff=128)
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(d_state=16, expand=2, head_dim=32,
                                  conv_kernel=4, chunk_size=32)
        if self.rglru is not None:
            kw["rglru"] = RGLRUConfig(lru_width=128, conv_kernel=4, window=64)
        if self.block_pattern:
            n = kw["num_layers"]
            kw["block_pattern"] = tuple(
                self.block_pattern[i % len(self.block_pattern)]
                for i in range(n))
        return replace(self, **kw)


@dataclass(frozen=True)
class SpecEEConfig:
    enabled: bool = True              # serving picks the specee strategy
    num_speculative: int = 4          # k speculative tokens (paper: 4)
    predictor_hidden: int = 512       # MLP hidden dim
    predictor_layers: int = 2         # MLP depth
    exit_threshold: float = 0.5       # sigmoid threshold
    schedule_enabled: bool = True     # T2 two-level scheduling
    online_window: int = 5            # circular queue length
    online_radius: int = 2            # ±radius exit points
    offline_top_frac: float = 0.3     # share of exit points the offline
    #                                   schedule keeps
    tree_depth: int = 3               # T3: draft levels under the root
    tree_branch: int = 3              # T3: top-b expansion per node

    def feature_dim(self) -> int:
        return 3 * self.num_speculative  # logits, local probs, prob variation


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 128
    max_seq_len: int = 32768
    page_size: int = 128             # paged KV block size (api.cache)
    max_new_tokens: int = 256
    greedy: bool = True
    temperature: float = 1.0
    # chunked (Sarathi-style) prefill admission: max prompt tokens the serving
    # scheduler runs per decode tick; 0 = blocking (whole-prompt) admission
    prefill_chunk: int = 512

    def __post_init__(self) -> None:
        if self.page_size <= 0:
            raise ValueError(
                f"ServeConfig.page_size must be > 0, got {self.page_size}")
        if self.max_seq_len % self.page_size:
            raise ValueError(
                f"ServeConfig.page_size ({self.page_size}) must divide "
                f"max_seq_len ({self.max_seq_len}) so pages tile the KV "
                "cache exactly")
        if self.prefill_chunk < 0:
            raise ValueError(
                "ServeConfig.prefill_chunk must be >= 0 (0 = blocking "
                f"admission), got {self.prefill_chunk}")


@dataclass(frozen=True)
class ShardingConfig:
    """The field of JAX's parallelism policy the dry run reads
    (``launch/specs.py``, ``launch/dryrun.py``): the serving policy a mesh
    places the weights by ("tp_dp" | "tp2d"; training takes "fsdp_tp")."""
    policy: str = "tp_dp"


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    microbatch: int = 0              # 0 = no accumulation
    steps: int = 100
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    schedule: str = "cosine"         # cosine | wsd | constant
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    checkpoint_every: int = 50
    keep_checkpoints: int = 3


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    specee: SpecEEConfig = field(default_factory=SpecEEConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)

    def smoke(self) -> "RunConfig":
        return replace(self, model=self.model.smoke(),
                       serve=replace(self.serve, max_batch=2, max_seq_len=128,
                                     page_size=16, max_new_tokens=8,
                                     prefill_chunk=32),
                       train=replace(self.train, global_batch=4, seq_len=32,
                                     steps=2, microbatch=0,
                                     checkpoint_every=1))


# ---------------------------------------------------------------------------
# Input shape cells (JAX's assigned shape set, ``repro/config.py:340-370``)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeCell:
    name: str       # train_4k | prefill_32k | decode_32k | long_500k
    kind: str       # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4096, 256),
    ShapeCell("prefill_32k", "prefill", 32768, 32),
    ShapeCell("decode_32k", "decode", 32768, 128),
    ShapeCell("long_500k", "decode", 524288, 1),
)


def shape_by_name(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def applicable_shapes(model: ModelConfig) -> List[ShapeCell]:
    """Which of the four shapes an arch runs: an encoder has no decode
    step, and only a stack with no global attention runs 500k tokens."""
    out: List[ShapeCell] = []
    for s in SHAPES:
        if s.kind == "decode" and not model.is_decoder():
            continue
        if s.name == "long_500k" and not model.supports_long_context():
            continue
        out.append(s)
    return out
