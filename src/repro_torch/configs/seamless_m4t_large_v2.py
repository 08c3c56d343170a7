"""SeamlessM4T-Large-v2 text backbone: encoder-decoder with cross-attention.
As in the reference, the mel/conv audio frontend is a stub (requests carry
frame embeddings of width ``d_enc``), a 6-layer transformer encoder reads
them, and the 24 decoder layers each cross-attend its output.
[arXiv:2308.11596]
"""
from repro_torch.configs.base import ModelConfig, register


@register("seamless-m4t-large-v2")
def seamless_m4t_large_v2() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        source="arXiv:2308.11596 (SeamlessM4T)",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256_206,
        rope_theta=10_000.0,
        act="gelu",
        rms_eps=1e-5,
        n_encoder_layers=6,
        cross_every=1,            # every decoder layer cross-attends
        d_enc=1024,
        n_enc_tokens=256,         # stub: precomputed audio-frame embeddings
    )
