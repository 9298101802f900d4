"""arctic-480b [moe]: 35L d_model=7168 56H (kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual [hf:Snowflake].

Memory recipe for 16 GB/chip HBM: int8 optimizer moments + bf16 master
weights (fp32 Adam math per layer-chunk, rounded back to bf16) + 4-way
gradient accumulation — see repro_torch.optim and EXPERIMENTS.md §Dry-run."""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32000,
        num_experts=128,
        experts_per_token=2,
        moe_d_ff=4864,
        moe_dense_residual=True,
        optimizer_state_dtype="int8",
        param_dtype="bfloat16",
        train_accum_steps=4,
    )
