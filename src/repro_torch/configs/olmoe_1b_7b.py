"""OLMoE-1B-7B — 64-expert top-8 MoE, MHA. [arXiv:2409.02060]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("olmoe-1b-7b")
def olmoe_1b_7b() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        source="arXiv:2409.02060 (OLMoE: Open Mixture-of-Experts Language Models)",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1024,               # per-expert
        vocab_size=50_304,
        rope_theta=10_000.0,
        act="silu",
        rms_eps=1e-5,
        moe=MoEConfig(n_experts=64, experts_per_token=8, d_ff_expert=1024),
    )
