"""Gemma-3-1B — 5:1 local:global sliding-window interleave, 262k vocab, MQA.
[hf:google/gemma-3-1b-pt]
"""
from repro_torch.configs.base import ModelConfig, register


@register("gemma3-1b")
def gemma3_1b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        family="dense",
        source="hf:google/gemma-3-1b-pt (Gemma 3 technical report)",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        vocab_size=262_144,
        rope_theta=1_000_000.0,
        act="gelu",
        rms_eps=1e-6,
        tie_embeddings=True,
        sliding_window=512,
        global_every=6,          # layers 5, 11, 17, 23 are global
        logit_softcap=0.0,
    )
