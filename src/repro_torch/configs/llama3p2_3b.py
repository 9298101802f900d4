"""llama3.2-3b [dense]: 28L d_model=3072 24H (kv=8) d_ff=8192
vocab=128256 [hf:meta-llama]."""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=128256,
        rope_theta=500000.0,
        tie_embeddings=True,
    )
