"""llava-next-mistral-7b [vlm]: mistral-7b backbone 32L d_model=4096
32H (kv=8) d_ff=14336 vocab=32000 [hf:llava-hf].  Anyres tiling frontend
is a STUB: ``input_specs`` provides 576 precomputed patch embeddings."""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        sliding_window=4096,
        num_patches=576,
    )
