"""mamba2-1.3b [ssm]: 48L d_model=2048 attn-free vocab=50280
ssm_state=128 (SSD) [arXiv:2405.21060].  O(1)-state decode ⇒ long_500k."""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=0,
        num_kv_heads=0,
        head_dim=64,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        expand=2,
        tie_embeddings=True,
        subquadratic=True,
    )
