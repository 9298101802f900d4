"""smollm-360m [dense]: 32L d_model=960 15H (kv=5) d_ff=2560
vocab=49152 [hf:HuggingFaceTB]."""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=49152,
        tie_embeddings=True,
        # pure_dp=True was A/B'd for this arch (§Perf): collectives -76%
        # but the as-lowered memory term regressed +10% (full-S² jnp
        # attention tiles per device); default recipe retained.
    )
