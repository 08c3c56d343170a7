"""ChatGLM3-6B — dense GQA (kv=2) with 2D/partial RoPE (rotary on half the
head dims). [arXiv:2406.12793]
"""
from repro_torch.configs.base import ModelConfig, register


@register("chatglm3-6b")
def chatglm3_6b() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        source="arXiv:2406.12793 (ChatGLM family report)",
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab_size=65_024,
        qkv_bias=True,           # chatglm uses bias on QKV
        rope_theta=10_000.0,
        rope_fraction=0.5,       # 2D RoPE: rotate only half the dims
        act="silu",
        rms_eps=1e-5,
    )
