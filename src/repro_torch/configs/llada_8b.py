"""LLaDA-8B — the paper's primary diffusion LLM (llama-like, MHA,
bidirectional attention). [arXiv:2502.09992]
"""
from repro_torch.configs.base import ModelConfig, register


@register("llada-8b")
def llada_8b() -> ModelConfig:
    return ModelConfig(
        name="llada-8b",
        family="dense",
        source="arXiv:2502.09992 (Large Language Diffusion Models)",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,           # MHA
        head_dim=128,
        d_ff=12288,
        vocab_size=126_464,
        rope_theta=500_000.0,
        act="silu",
        rms_eps=1e-5,
    )
