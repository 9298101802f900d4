"""Model / run configuration schema.

One frozen dataclass describes every assigned architecture; family-specific
fields are zero/empty when unused.  ``reduced()`` derives the small smoke
variant of the same family (few layers, narrow width, tiny vocab) used by
CPU tests; the full configs are exercised only via the AOT dry-run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // num_heads

    # --- attention flavour ---
    qkv_bias: bool = False           # qwen2
    sliding_window: int = 0          # SWA (danube3, mistral)
    rope_theta: float = 10000.0

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0      # deepseek-v2: always-on experts
    moe_d_ff: int = 0                # per-expert hidden (deepseek: 1536)
    moe_dense_residual: bool = False # arctic: dense FFN in parallel with MoE
    first_k_dense: int = 0           # deepseek-v2: leading dense layers
    capacity_factor: float = 1.25
    # EP combine under a "model" mesh axis: "a2a" exchanges capacity
    # buckets with all_to_all (default); "psum" replicates tokens over
    # "model" and psums the combine (legacy baseline, and the automatic
    # fallback when seq does not divide the model axis)
    moe_dispatch: str = "a2a"

    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_kernel: int = 4
    expand: int = 2

    # --- hybrid (zamba2): shared attention block every N mamba blocks ---
    attn_every: int = 0

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 0             # precomputed frame embeddings (stub frontend)

    # --- VLM (llava): prefix patch embeddings (stub frontend) ---
    num_patches: int = 0

    # --- numerics / training policy ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"          # compute dtype (per-layer cast)
    param_dtype: str = "float32"     # fp32 master weights
    remat: str = "layer"             # none | layer | dots
    optimizer_state_dtype: str = "float32"   # float32 | int8 (≥100B configs)
    loss_chunk: int = 1024           # sequence-chunked CE loss
    train_accum_steps: int = 1       # gradient accumulation microbatches
    # flash-attention tile OVERRIDES: None (default) lets the trace-time
    # autotuner (repro_torch.kernels.autotune) pick blocks per shape; ints pin
    # a hand-tuned layout (fwd AND bwd tiles).
    attn_block_q: Optional[int] = None
    attn_block_k: Optional[int] = None
    attn_flash_min_seq: int = 2048   # below max(2·block_q, this): dense ref
    use_scan: bool = True            # lax.scan over layers (compile scalability)
    pure_dp: bool = False            # small models: batch over ALL mesh axes,
    #                                  weights replicated (no TP/SP/FSDP)

    # set True on archs where long_500k is runnable (sub-quadratic)
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self) -> "ModelConfig":
        """Small same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 4 if self.family == "hybrid" else 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            capacity_factor=8.0,     # no token dropping in smoke tests
            moe_d_ff=64 if self.moe_d_ff else 0,
            q_lora_rank=64 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_nope_head_dim=16 if self.qk_nope_head_dim else 0,
            qk_rope_head_dim=16 if self.qk_rope_head_dim else 0,
            v_head_dim=32 if self.v_head_dim else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=16,
            attn_every=2 if self.attn_every else 0,
            num_encoder_layers=min(self.num_encoder_layers, 2),
            encoder_seq=24 if self.encoder_seq else 0,
            num_patches=8 if self.num_patches else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            dtype="float32",
            param_dtype="float32",
            loss_chunk=32,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An assigned (input-shape × step-kind) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_by_name(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Cell-applicability rules (see DESIGN.md §Arch-applicability)."""
    if shape.name == "long_500k":
        return cfg.subquadratic          # SSM / hybrid only
    return True
