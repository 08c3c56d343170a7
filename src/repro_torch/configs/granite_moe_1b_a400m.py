"""Granite-3.0-1B-A400M — fine-grained MoE, 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("granite-moe-1b-a400m")
def granite_moe_1b_a400m() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,                 # per-expert FFN width
        vocab_size=49_155,
        rope_theta=10_000.0,
        act="silu",
        rms_eps=1e-6,
        tie_embeddings=True,
        moe=MoEConfig(n_experts=32, experts_per_token=8, d_ff_expert=512),
    )
