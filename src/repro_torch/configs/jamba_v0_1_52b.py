"""Jamba-v0.1-52B — hybrid Mamba + attention at 1:7, with a 16-expert top-2
MoE FFN on every second layer. [arXiv:2403.19887]

As in the reference: Mamba-2 SSD mixers (state 64) stand for Jamba v0.1's
Mamba-1 mixers, and the attention layers apply RoPE, which the paper's do
not.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, register


@register("jamba-v0.1-52b")
def jamba_v0_1_52b() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        source="arXiv:2403.19887 (Jamba)",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,              # per-expert and dense MLP width
        vocab_size=65_536,
        rope_theta=10_000.0,     # Jamba's attention has no RoPE; the reference applies it
        act="silu",
        rms_eps=1e-6,
        attn_every=8,            # layer l is attention iff l % 8 == 3
        attn_offset=3,
        moe=MoEConfig(n_experts=16, experts_per_token=2, d_ff_expert=14336),
        moe_every=2,             # MoE on the odd layers
        ssm=SSMConfig(d_state=64, headdim=64, expand=2, conv_width=4, chunk=64),
    )
