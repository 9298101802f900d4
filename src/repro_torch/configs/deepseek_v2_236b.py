"""deepseek-v2-236b [moe]: 60L d_model=5120 128H MLA kv_lora=512,
160 routed experts top-6 + 2 shared, moe_d_ff=1536, vocab=102400
[arXiv:2405.04434].  First layer dense (d_ff=12288).  int8 optimizer
states to fit HBM."""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        head_dim=128,
        d_ff=1536,
        vocab_size=102400,
        num_experts=160,
        experts_per_token=6,
        num_shared_experts=2,
        moe_d_ff=1536,
        first_k_dense=1,
        use_mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        optimizer_state_dtype="int8",
        train_accum_steps=4,
    )
