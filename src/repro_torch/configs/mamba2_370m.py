"""Mamba2-370M — attention-free SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register("mamba2-370m")
def mamba2_370m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        source="arXiv:2405.21060 (Transformers are SSMs / Mamba-2)",
        n_layers=48,
        d_model=1024,
        n_heads=0,           # attention-free
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,              # no separate FFN; the mamba mixer is the block
        vocab_size=50_280,
        rms_eps=1e-5,
        tie_embeddings=True,
        ssm=SSMConfig(d_state=128, headdim=64, expand=2, conv_width=4, chunk=64),
    )
