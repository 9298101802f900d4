"""Dense decoder layer (``kind="dense"`` of ``repro.models.blocks``):
init plus train, prefill and decode application.

Pre-norm residual, as ``repro.models.blocks``.  Attention compute routes
through ``repro_torch.dist.flash``, which picks the kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.dist.flash import causal_attention, decode_update_and_attend
from .attention import gqa_init, gqa_qkv
from .layers import (Params, _dtype, apply_rope, cast_params, mlp, mlp_init,
                     rmsnorm, rmsnorm_init)


def _attn_apply(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
                want_cache: bool = False):
    """Train / prefill attention; with ``want_cache`` returns (out,
    head-major cache (B, KH, S, hd))."""
    q, k, v = gqa_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = causal_attention(q, k, v, cfg=cfg, window=cfg.sliding_window)
    o = torch.einsum("bshk,hkd->bsd", out, p["w_o"])
    if not want_cache:
        return o
    return o, {"k": k.transpose(1, 2).contiguous(),
               "v": v.transpose(1, 2).contiguous()}


def _attn_decode(p: Params, x: torch.Tensor, cfg,
                 cache: Dict[str, torch.Tensor], cur_len: int):
    q, k, v = gqa_qkv(p, x, cfg)
    pos = torch.full((1, 1), cur_len, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    out, kc, vc = decode_update_and_attend(
        q, k, v, cache["k"], cache["v"], cur_len, window=cfg.sliding_window)
    o = torch.einsum("bshk,hkd->bsd", out, p["w_o"])
    return o, {"k": kc, "v": vc}


def decoder_layer_init(gen: torch.Generator, cfg) -> Params:
    dt = _dtype(cfg.param_dtype)
    return {"ln1": rmsnorm_init(cfg.d_model, dt, gen.device),
            "ln2": rmsnorm_init(cfg.d_model, dt, gen.device),
            "attn": gqa_init(gen, cfg),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dt)}


def zero_aux(device=None) -> Dict[str, torch.Tensor]:
    """Zero MoE aux dict (the schema of ``repro.models.moe.zero_aux``):
    what a dense layer adds to the backbone's aux sums."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"loss": z, "dropped": z, "routed": z, "a2a_bytes": z}


def decoder_layer_train(p: Params, x: torch.Tensor, cfg,
                        positions: torch.Tensor
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (x, zero aux).  The fp32 master weights are cast to the
    compute dtype here, inside the layer (and so inside its checkpointed
    region), and gradients flow back through the cast to fp32."""
    p = cast_params(p, cfg.dtype)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + _attn_apply(p["attn"], h, cfg, positions)
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], h), zero_aux(x.device)


def decoder_layer_prefill(p: Params, x: torch.Tensor, cfg,
                          positions: torch.Tensor
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    p = cast_params(p, cfg.dtype)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn, cache = _attn_apply(p["attn"], h, cfg, positions, want_cache=True)
    x = x + attn
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], h), cache


def decoder_layer_decode(p: Params, x: torch.Tensor, cfg,
                         cache: Dict[str, torch.Tensor], cur_len: int
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    p = cast_params(p, cfg.dtype)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn, cache = _attn_decode(p["attn"], h, cfg, cache, cur_len)
    x = x + attn
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], h), cache
