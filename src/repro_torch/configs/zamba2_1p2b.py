"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention blocks.

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf].  Shared transformer block applied every 6 mamba
blocks (weights shared across applications — the paper's §4 labeled-map
object dedup).  Sub-quadratic ⇒ runs long_500k.
"""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=32000,
        ssm_state=64,
        ssm_head_dim=64,
        expand=2,
        attn_every=6,
        tie_embeddings=True,
        subquadratic=True,
    )
