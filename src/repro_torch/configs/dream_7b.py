"""Dream-7B — the paper's second diffusion LLM (qwen2.5-7b-initialised, GQA).
[arXiv:2508.15487]
"""
from repro_torch.configs.base import ModelConfig, register


@register("dream-7b")
def dream_7b() -> ModelConfig:
    return ModelConfig(
        name="dream-7b",
        family="dense",
        source="arXiv:2508.15487 (Dream 7B)",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152_064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        act="silu",
        rms_eps=1e-6,
    )
