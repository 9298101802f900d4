"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (kv=8) d_ff=10240
vocab=32000, sliding-window attention [arXiv:2401.16818]."""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        family="dense",
        num_layers=24,
        d_model=3840,
        num_heads=32,
        num_kv_heads=8,
        head_dim=120,
        d_ff=10240,
        vocab_size=32000,
        sliding_window=4096,
    )
