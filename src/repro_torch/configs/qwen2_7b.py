"""qwen2-7b [dense]: 28L d_model=3584 28H (kv=4) d_ff=18944
vocab=152064, QKV bias [arXiv:2407.10671]."""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b",
        family="dense",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1000000.0,
    )
