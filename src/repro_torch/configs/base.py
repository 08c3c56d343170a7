"""Model and generation configuration for the PyTorch port.

A standalone copy of the reference package's config dataclasses (stdlib
only), so the port imports nothing of the JAX package.  Field names, defaults
and derived helpers are identical, which lets a test build the same
configuration in both packages and compare them field by field.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int
    d_ff_expert: int
    router_group_size: int = 512
    capacity_factor: float = 2.0
    aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 64
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str              # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""

    # trunk
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0
    sliding_window: int = 0
    global_every: int = 0
    logit_softcap: float = 0.0

    # feed-forward
    act: str = "silu"                # silu | gelu
    rms_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE
    moe: Optional[MoEConfig] = None
    moe_every: int = 1

    # SSM / hybrid
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0
    attn_offset: int = 0

    # encoder-decoder / cross-attention
    n_encoder_layers: int = 0
    cross_every: int = 0
    cross_offset: int = 0
    d_enc: int = 0
    n_enc_tokens: int = 256

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def q_heads_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def layer_kind(self, l: int) -> str:
        """Structural kind of decoder layer ``l``: attn | ssm | cross."""
        if self.cross_every and l % self.cross_every == self.cross_offset:
            return "cross"
        if self.attn_every:
            return "attn" if l % self.attn_every == self.attn_offset else "ssm"
        if self.family == "ssm":
            return "ssm"
        return "attn"

    def layer_is_moe(self, l: int) -> bool:
        if self.moe is None:
            return False
        return l % self.moe_every == (self.moe_every - 1) if self.moe_every > 1 else True

    def layer_is_global_attn(self, l: int) -> bool:
        """Local:global interleaves (gemma3): True for a full-attention layer."""
        if not self.sliding_window:
            return True
        if not self.global_every:
            return False            # every layer local
        return l % self.global_every == (self.global_every - 1)

    @property
    def pattern_period(self) -> int:
        period = 1
        for p in (self.attn_every, self.cross_every,
                  self.moe_every if self.moe is not None and self.moe_every > 1 else 0):
            if p:
                period = period * p // math.gcd(period, p)
        return period

    def validate(self) -> None:
        if self.family != "ssm":
            if not (self.n_heads > 0 and self.head_dim > 0):
                raise ValueError(f"{self.name}: attention needs heads and head_dim")
            if self.n_heads % max(self.n_kv_heads, 1):
                raise ValueError(f"{self.name}: n_heads not a multiple of n_kv_heads")
        if not (self.vocab_size > 0 and self.d_model > 0 and self.n_layers > 0):
            raise ValueError(f"{self.name}: empty model")
        if self.n_layers % self.pattern_period:
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not divisible "
                             f"by pattern period {self.pattern_period}")


@dataclasses.dataclass(frozen=True)
class SkipStage:
    """Early-skip applied at the *output* of layer ``layer`` with ratio ``ratio``."""

    layer: int
    ratio: float


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    gen_length: int = 256
    block_length: int = 64
    steps_per_block: int = 0          # 0 => block_length (1 token / step)

    mode: str = "es"                  # vanilla | dualcache | es
    alpha: float = 0.5                # Eq. 1 weighting
    skip_stages: tuple[SkipStage, ...] = ()
    indicator: str = "hidden"

    # cache refresh periods (iterations); 0 = never
    prompt_refresh_period: int = 64
    block_refresh_period: int = 4

    # sampling
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    remasking: str = "low_confidence"

    # parallel decoding (Fast-dLLM)
    parallel_decoding: bool = False
    pd_threshold: float = 0.9

    # sparse attention (Sparse-dLLM)
    sparse_attention: bool = False
    sparse_retention: float = 0.5
    sparse_kernel_size: int = 3

    # adaptive cross-iteration feature cache (dLLM-Cache)
    cache_prompt_interval: int = 0
    cache_refresh_fraction: float = 0.25
    cache_variation_threshold: float = 0.0

    # sliding active-window attention
    window_blocks: int = 0

    # block-causal attention
    block_causal: bool = False

    def resolved_steps(self) -> int:
        return self.steps_per_block or self.block_length

    @property
    def adaptive_cache(self) -> bool:
        return self.cache_prompt_interval > 1

    @property
    def windowed(self) -> bool:
        return self.window_blocks > 0


def default_skip_stages(n_layers: int, ratio: float = 0.5) -> tuple[SkipStage, ...]:
    """Paper default: r_{L/8} = r_{L/4} = 0.5 (LLaDA: r_4=r_8, Dream: r_4=r_7)."""
    l1 = max(n_layers // 8, 1)
    l2 = max(n_layers // 4, 2)
    if l2 <= l1:
        l2 = l1 + 1
    return (SkipStage(l1, ratio), SkipStage(l2, ratio))


# ---------------------------------------------------------------------------
# Input shapes (the reference's, which its dry run lowers)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn

    return deco


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[arch_id]()
    cfg.validate()
    return cfg


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
