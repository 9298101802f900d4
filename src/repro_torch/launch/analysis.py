"""Roofline terms of one rank's step on the H100 (the port's counterpart
of ``repro.launch.hlo_analysis``).

``launch.cost`` counts what a rank computes, moves and communicates;
:func:`roofline` turns those counts into the reference's three terms —
compute, memory and collective seconds — with the card's data-sheet
peaks in place of the TPU's.  :func:`param_count` and
:func:`model_flops` (the useful 6·N·D) are framework-free copies of the
reference's.

Hardware model: NVIDIA H100 80GB HBM3 (SXM5), power limit 700 W — 989
TFLOP/s bf16 dense, 67 TFLOP/s fp32, 3.35 TB/s HBM3 (data sheet); a
collective over an axis whose groups lie within one node of 8 cards
moves at NVLink 4's 450 GB/s a direction, any other at 50 GB/s (one 400
Gb/s NIC a card).  The reference's ``links_per_chip`` becomes this
per-axis rate (:func:`axis_rates`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np

# NVIDIA H100 80GB HBM3 (SXM5), 700 W, data sheet, dense
H100_BF16_FLOPS = 989e12       # FLOP/s, bf16 tensor cores
H100_FP32_FLOPS = 67e12        # FLOP/s, fp32 CUDA cores
H100_HBM_BYTES = 3.35e12       # bytes/s, HBM3
H100_NVLINK_BYTES = 450e9      # bytes/s a direction, NVLink 4 (18 links)
H100_NIC_BYTES = 50e9          # bytes/s, one 400 Gb/s NIC a card
H100_NODE_CARDS = 8            # cards an NVLink domain joins (one node)


def axis_rates(mesh) -> Dict[str, float]:
    """{axis name: bytes/s} of a collective over that axis of ``mesh`` (a
    ``MeshLayout`` or anything with ``axis_names`` and ``devices``):
    NVLink where every group of the axis lies within one node of
    :data:`H100_NODE_CARDS` consecutive ranks, else the NIC."""
    ranks = np.asarray(mesh.devices)
    out = {}
    for i, name in enumerate(mesh.axis_names):
        groups = np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i])
        node = groups // H100_NODE_CARDS
        same = bool((node == node[:, :1]).all())
        out[name] = H100_NVLINK_BYTES if same else H100_NIC_BYTES
    return out


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-rank FLOPs
    hbm_bytes: float             # per-rank bytes moved
    coll_bytes: float            # per-rank collective bytes
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float           # 6·N·D useful flops (per rank)
    useful_ratio: float

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def roofline(cost: Dict[str, float], coll: Dict[str, Any],
             model_flops_total: float, num_chips: int,
             rates: Dict[str, float]) -> Roofline:
    """The three-term roofline of one rank's step.

    ``cost`` holds the rank's "flops" and "bytes accessed";
    ``coll["per_kind"]`` its collective bytes by "kind/axis"
    (``dist.sharding.TRAFFIC``), each over its axis's rate in ``rates``
    (:func:`axis_rates`); ``model_flops_total`` is the whole step's useful
    FLOPs, divided by ``num_chips`` for the per-rank ratio."""
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    per_kind = coll["per_kind"]
    coll_b = float(sum(per_kind.values()))
    compute_s = flops / H100_BF16_FLOPS
    memory_s = hbm / H100_HBM_BYTES
    coll_s = sum(float(b) / rates[key.split("/")[-1]]
                 for key, b in per_kind.items())
    dom = max((("compute", compute_s), ("memory", memory_s),
               ("collective", coll_s)), key=lambda kv: kv[1])[0]
    mf = model_flops_total / num_chips
    return Roofline(flops=flops, hbm_bytes=hbm, coll_bytes=coll_b,
                    compute_s=compute_s, memory_s=memory_s,
                    collective_s=coll_s, dominant=dom,
                    model_flops=mf,
                    useful_ratio=(mf / flops if flops else 0.0))


# ------------------------------------------------------- model FLOPs (6·N·D)

def param_count(cfg) -> Tuple[float, float]:
    """Returns (total_params, active_params) analytically from the config."""
    d, v = cfg.d_model, cfg.vocab_size
    emb = v * d
    head = 0 if cfg.tie_embeddings else d * v
    per_attn = (d * cfg.num_heads * cfg.head_dim
                + 2 * d * cfg.num_kv_heads * cfg.head_dim
                + cfg.num_heads * cfg.head_dim * d)
    if cfg.use_mla:
        dn, dr, dv_ = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        per_attn = (d * cfg.q_lora_rank
                    + cfg.q_lora_rank * cfg.num_heads * (dn + dr)
                    + d * (cfg.kv_lora_rank + dr)
                    + cfg.kv_lora_rank * cfg.num_heads * (dn + dv_)
                    + cfg.num_heads * dv_ * d)
    per_mlp = 3 * d * cfg.d_ff
    per_moe_expert = 3 * d * (cfg.moe_d_ff or cfg.d_ff)
    per_shared = 3 * d * (cfg.moe_d_ff or cfg.d_ff) * cfg.num_shared_experts
    per_mamba = 0
    if cfg.ssm_state:
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        per_mamba = (2 * d * di + 2 * d * n + d * h
                     + cfg.conv_kernel * (di + 2 * n) + di * d)

    total = emb + head
    active = emb + head
    L = cfg.num_layers
    fam = cfg.family
    if fam in ("dense", "vlm"):
        total += L * (per_attn + per_mlp)
        active = total
    elif fam == "moe":
        n_moe = L - cfg.first_k_dense
        dense_ff = 12288 if cfg.use_mla and cfg.d_model == 5120 else cfg.d_ff
        total += cfg.first_k_dense * (per_attn + 3 * d * dense_ff)
        active += cfg.first_k_dense * (per_attn + 3 * d * dense_ff)
        per_layer_total = (per_attn + cfg.num_experts * per_moe_expert
                           + per_shared
                           + (per_mlp if cfg.moe_dense_residual else 0))
        per_layer_active = (per_attn
                            + cfg.experts_per_token * per_moe_expert
                            + per_shared
                            + (per_mlp if cfg.moe_dense_residual else 0))
        total += n_moe * per_layer_total
        active += n_moe * per_layer_active
    elif fam == "ssm":
        total += L * per_mamba
        active = total
    elif fam == "hybrid":
        g = L // cfg.attn_every
        total += L * per_mamba + (per_attn + per_mlp)      # shared block once
        active = emb + head + L * per_mamba + g * (per_attn + per_mlp)
    elif fam == "encdec":
        enc_attn = 4 * d * cfg.num_heads * cfg.head_dim
        total += cfg.num_encoder_layers * (enc_attn + 2 * d * cfg.d_ff)
        total += L * (per_attn + enc_attn + 2 * d * cfg.d_ff)
        active = total
    return float(total), float(active)


def model_flops(cfg, shape) -> float:
    """6·N_active·D tokens for train; 2·N_active·D for inference steps."""
    _, active = param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    # decode: one token per sequence
    return 2.0 * active * shape.global_batch
