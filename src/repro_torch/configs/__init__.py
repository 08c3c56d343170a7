"""Architecture config registry of the port: the two paper models, Mamba-2,
the MoE models (OLMoE, Granite-MoE), the dense decoders Gemma-3, Llama-3,
Qwen2 and ChatGLM3, the Jamba hybrid, and the encoder-conditioned
Llama-3.2-Vision and SeamlessM4T (cross-attention).

``get_config(arch_id)`` returns the published configuration; ``reduced(cfg)``
returns the same small variant the reference package's ``reduced`` builds, so
tests can run one configuration through both packages.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (  # noqa: F401  (registers)
    chatglm3_6b,
    dream_7b,
    gemma3_1b,
    granite_moe_1b_a400m,
    jamba_v0_1_52b,
    llada_8b,
    llama3_2_vision_11b,
    llama3_8b,
    mamba2_370m,
    olmoe_1b_7b,
    qwen2_1_5b,
    seamless_m4t_large_v2,
)
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    GenerationConfig,
    InputShape,
    ModelConfig,
    MoEConfig,
    SkipStage,
    SSMConfig,
    default_skip_stages,
    get_config,
    list_archs,
    register,
)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving reduced variant for CPU tests (same rule as the
    reference): 2 layers per period, d_model <= 256, head_dim 32, GQA
    grouping kept, vocab <= 503."""
    period = cfg.pattern_period
    n_layers = 2 * period if period > 1 else 2
    d_model = min(cfg.d_model, 256)
    head_dim = 32
    n_heads = max(d_model // 64, 2)
    n_kv_heads = max(1, min(cfg.n_kv_heads, n_heads))
    if cfg.n_kv_heads and cfg.n_heads and cfg.n_kv_heads < cfg.n_heads:
        n_kv_heads = max(1, n_heads // cfg.q_heads_per_kv)
    while n_heads % n_kv_heads:
        n_kv_heads -= 1
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe,
            n_experts=4,
            experts_per_token=min(2, cfg.moe.experts_per_token),
            d_ff_expert=min(cfg.moe.d_ff_expert, 128),
            router_group_size=64,
        )
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, d_state=16, headdim=16, chunk=16)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads if cfg.family != "ssm" else 0,
        n_kv_heads=n_kv_heads if cfg.family != "ssm" else 0,
        head_dim=head_dim if cfg.family != "ssm" else 0,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 503),
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        global_every=min(cfg.global_every, n_layers) if cfg.global_every else 0,
        moe=moe,
        ssm=ssm,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        d_enc=min(cfg.d_enc, 128) if cfg.d_enc else 0,
        n_enc_tokens=min(cfg.n_enc_tokens, 16),
    )
