"""whisper-small [audio/enc-dec]: 12L enc + 12L dec, d_model=768, 12H,
d_ff=3072, vocab=51865 [arXiv:2212.04356].  Conv frontend is a STUB:
``input_specs`` provides precomputed frame embeddings (B, 1504, 768)
(1500 mel frames padded to 1504 for clean sharding).  RoPE replaces the
learned positional table (noted deviation, DESIGN.md §9)."""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="encdec",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        is_encoder_decoder=True,
        num_encoder_layers=12,
        encoder_seq=1504,
    )
