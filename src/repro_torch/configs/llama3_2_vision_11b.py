"""Llama-3.2-11B-Vision language backbone: a cross-attention layer every 5th
layer (3, 8, ..., 38) reads the image tokens.  As in the reference, the ViT
vision encoder is a stub: requests carry patch embeddings of width
``d_enc``. [hf:meta-llama/Llama-3.2-11B-Vision]
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama-3.2-vision-11b")
def llama3_2_vision_11b() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        source="hf:meta-llama/Llama-3.2-11B-Vision",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128_256,
        rope_theta=500_000.0,
        act="silu",
        rms_eps=1e-5,
        cross_every=5,           # layers 3, 8, 13, ... are cross-attention
        cross_offset=3,
        d_enc=4096,              # projected patch embeddings
        n_enc_tokens=1601,       # 1 tile x (40x40 patches + cls)
    )
