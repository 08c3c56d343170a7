"""Qwen2-1.5B — dense GQA decoder with QKV bias. [arXiv:2407.10671]"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-1.5b")
def qwen2_1_5b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        source="arXiv:2407.10671 (Qwen2 Technical Report)",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151_936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        act="silu",
        rms_eps=1e-6,
        tie_embeddings=True,
    )
