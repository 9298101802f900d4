"""Attention: GQA q/k/v projections, the dense reference attention,
one-token decode attention, the flash threshold, whisper's unmasked
cross attention, and DeepSeek-V2's multi-head latent attention (MLA).

Layout conventions (as in ``repro.models.attention``):
  q            : (batch, seq, n_heads, head_dim)
  k, v         : (batch, seq, n_kv_heads, head_dim)
Sequences longer than :func:`flash_min_seq` take the flash kernel
(``repro_torch.dist.flash``); :func:`full_attention` is the dense path
below it.  MLA's projections are plain einsums, as in the reference
(outside any Pallas kernel there); its attention runs through the same
flash kernels, at q/k width ``qk_nope_head_dim + qk_rope_head_dim`` and v
width ``v_head_dim`` on the model path, or as one latent kv head on the
absorbed route (:func:`_mla_absorbed_flash`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from .layers import (Params, _dtype, apply_rope, dense_init, rmsnorm,
                     rmsnorm_init)

NEG_INF = -1e30
# smallest tile the reference's planner picks; the flash threshold keeps
# room for two such q tiles
MIN_BLOCK = 16


# ------------------------------------------------------------------ GQA params

def gqa_init(gen: torch.Generator, cfg) -> Params:
    d = cfg.d_model
    h, k_, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = _dtype(cfg.param_dtype)
    p = {
        "w_q": dense_init(gen, d, (h, hd), dt),
        "w_k": dense_init(gen, d, (k_, hd), dt),
        "w_v": dense_init(gen, d, (k_, hd), dt),
        "w_o": dense_init(gen, h * hd, (d,), dt).reshape(h, hd, d),
    }
    if cfg.qkv_bias:
        for name, n in (("b_q", h), ("b_k", k_), ("b_v", k_)):
            p[name] = torch.zeros((n, hd), dtype=dt, device=gen.device)
    return p


# ------------------------------------------------------- dense full attention

def _causal_window_mask(sq: int, sk: int, offset: int, window: int,
                        device) -> torch.Tensor:
    """(sq, sk) boolean mask. offset = absolute position of q row 0 minus
    absolute position of k col 0.  window==0 → plain causal."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(sk, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m &= (qi - kj) < window
    return m


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   q_offset: int = 0) -> torch.Tensor:
    """Dense reference attention with GQA head grouping.

    q: (B,Sq,H,hd); k,v: (B,Sk,K,hd) with H = K*G.  Probabilities are cast
    to q's dtype before the PV product, as in the reference.
    """
    b, sq, h, hd = q.shape
    _, sk, kh, _ = k.shape
    hd_v = v.shape[-1]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float()
    scores = scores * (1.0 / np.sqrt(hd))
    if causal:
        mask = _causal_window_mask(sq, sk, q_offset, window, q.device)
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(b, sq, h, hd_v)


def flash_min_seq(cfg) -> int:
    """Sequence length above which training/prefill attention goes flash:
    ``max(2·block_q, cfg.attn_flash_min_seq)`` with the reference's
    smallest planner tile as the default block."""
    bq = getattr(cfg, "attn_block_q", None) or MIN_BLOCK
    return max(2 * bq, getattr(cfg, "attn_flash_min_seq", 2048) or 2048)


# ------------------------------------------------------------ decode attention

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, cur_len,
                     window: int = 0) -> torch.Tensor:
    """One-token attention against a (B, S_max, K, hd) cache.

    cur_len: scalar or (B,) number of valid cache entries (new token
    included), an int or an int tensor.
    """
    b, sq, h, hd = q.shape
    _, smax, kh, _ = k_cache.shape
    g = h // kh
    qg = q.reshape(b, sq, kh, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k_cache).float()
    scores = scores * (1.0 / np.sqrt(hd))
    pos = torch.arange(smax, device=q.device)
    cur = torch.as_tensor(cur_len, device=q.device)
    if cur.ndim == 0:
        valid = pos < cur                           # (smax,), shared
        if window > 0:
            valid &= pos >= torch.clamp(cur - window, min=0)
        mask = valid[None, None, None, None, :]
    else:
        valid = pos[None, :] < cur[:, None]         # (B, smax), per row
        if window > 0:
            valid &= pos[None, :] >= torch.clamp(cur - window, min=0)[:, None]
        mask = valid[:, None, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v_cache)
    return out.reshape(b, sq, h, hd)


# ------------------------------------------------------------------ GQA block

def gqa_qkv(params: Params, x: torch.Tensor, cfg
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = torch.einsum("bsd,dhk->bshk", x, params["w_q"])
    k = torch.einsum("bsd,dhk->bshk", x, params["w_k"])
    v = torch.einsum("bsd,dhk->bshk", x, params["w_v"])
    if "b_q" in params:
        q = q + params["b_q"]
        k = k + params["b_k"]
        v = v + params["b_v"]
    return q, k, v


# ------------------------------------------------------------ cross attention

def cross_attn_init(gen: torch.Generator, cfg) -> Params:
    """Encoder-decoder (whisper) attention weights: MHA (kv heads =
    heads), q from one stream and k / v from another."""
    d = cfg.d_model
    h, hd = cfg.num_heads, cfg.head_dim
    dt = _dtype(cfg.param_dtype)
    return {
        "w_q": dense_init(gen, d, (h, hd), dt),
        "w_k": dense_init(gen, d, (h, hd), dt),
        "w_v": dense_init(gen, d, (h, hd), dt),
        "w_o": dense_init(gen, h * hd, (d,), dt).reshape(h, hd, d),
    }


def cross_attention(params: Params, x: torch.Tensor,
                    enc: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) attends, unmasked, over enc: (B, Se, D) (the
    encoder's self-attention passes enc = x).  Dense torch ops, as the
    reference's jnp: no kernel."""
    q = torch.einsum("bsd,dhk->bshk", x, params["w_q"])
    k = torch.einsum("bsd,dhk->bshk", enc, params["w_k"])
    v = torch.einsum("bsd,dhk->bshk", enc, params["w_v"])
    out = full_attention(q, k, v, causal=False)
    return torch.einsum("bshk,hkd->bsd", out, params["w_o"])


# ----------------------------------------------------------------------- MLA

def mla_init(gen: torch.Generator, cfg) -> Params:
    """DeepSeek-V2 multi-head latent attention: the query's low-rank
    path (``w_dq``, ``q_norm``, ``w_uq``), the shared kv latent and its
    rope key (``w_dkv``, ``kv_norm``), and the per-head up-projections
    ``w_uk``, ``w_uv`` and output ``w_o``, in the reference's names,
    shapes and order."""
    d, h = cfg.d_model, cfg.num_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = _dtype(cfg.param_dtype)
    return {
        "w_dq": dense_init(gen, d, (rq,), dt),
        "q_norm": rmsnorm_init(rq, dt, gen.device),
        "w_uq": dense_init(gen, rq, (h, dn + dr), dt),
        "w_dkv": dense_init(gen, d, (rkv + dr,), dt),
        "kv_norm": rmsnorm_init(rkv, dt, gen.device),
        "w_uk": dense_init(gen, rkv, (h, dn), dt),
        "w_uv": dense_init(gen, rkv, (h, dv), dt),
        "w_o": dense_init(gen, h * dv, (d,), dt).reshape(h, dv, d),
    }


def _mla_queries(params: Params, x: torch.Tensor, cfg,
                 positions: torch.Tensor):
    """(q_nope (b,s,h,dn), q_rope (b,s,h,dr) with RoPE at ``positions``)
    from the query's low-rank path."""
    dn = cfg.qk_nope_head_dim
    cq = rmsnorm(params["q_norm"],
                 torch.einsum("bsd,dr->bsr", x, params["w_dq"]), cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, params["w_uq"])
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_kv_latents(params: Params, x: torch.Tensor, cfg,
                    positions: torch.Tensor):
    """(c_kv (b,s,rkv), k_rope (b,s,1,dr) with RoPE at ``positions``):
    the compressed kv latent and its rope key."""
    rkv = cfg.kv_lora_rank
    dkv = torch.einsum("bsd,dr->bsr", x, params["w_dkv"])
    c_kv = rmsnorm(params["kv_norm"], dkv[..., :rkv], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., None, rkv:], positions, cfg.rope_theta)
    return c_kv, k_rope


def _mla_latents(params: Params, x: torch.Tensor, cfg,
                 positions: torch.Tensor):
    """Shared low-rank projections: q_nope / q_rope per head, the
    compressed kv latent c_kv (b,s,rkv) and its rope key k_rope
    (b,s,1,dr)."""
    q_nope, q_rope = _mla_queries(params, x, cfg, positions)
    c_kv, k_rope = _mla_kv_latents(params, x, cfg, positions)
    return q_nope, q_rope, c_kv, k_rope


def _mla_qkv_full(params: Params, x: torch.Tensor, cfg,
                  positions: torch.Tensor):
    """The model path's per-head q and k (width dn + dr: the rope key
    shared by every head) and v (width dv), with the latents for the
    cache: (q, k, v, c_kv, k_rope)."""
    dr = cfg.qk_rope_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_latents(params, x, cfg, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uv"])
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat(
        [k_nope, k_rope.expand(*k_nope.shape[:-1], dr)], dim=-1)
    return q_full, k_full, v, c_kv, k_rope


def _mla_absorbed_flash(params: Params, x: torch.Tensor, cfg,
                        positions: torch.Tensor, q_offset: int = 0):
    """Absorbed-matrix MLA attention through the differentiable flash
    kernels, as the reference's: one kv head of width rkv + dr (k =
    [c_kv, k_rope], v = c_kv) shared by all the query heads, W_UK folded
    into the query and W_UV applied to the latent output.  The kernels
    scale by 1/√(rkv + dr); q is pre-scaled by √((rkv + dr)/(dn + dr))
    (rounded to q's dtype, as there) for MLA's 1/√(dn + dr).  At full
    width that is (576, 512), one kv head for 128 query heads: on the
    card the kernels' widest compiled pair
    (``csrc/flash_attention_wide.cu``), which reads v as the view of k's
    first ``kv_lora_rank`` columns it is here.  Returns (out (b,s,h,dv),
    c_kv, k_rope)."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    rkv = cfg.kv_lora_rank
    q_nope, q_rope, c_kv, k_rope = _mla_latents(params, x, cfg, positions)
    q_latent = torch.einsum("bshk,rhk->bshr", q_nope, params["w_uk"])
    q_eff = torch.cat([q_latent, q_rope], dim=-1)
    ratio = torch.tensor(np.sqrt((rkv + dr) / (dn + dr)), dtype=q_eff.dtype)
    q_eff = q_eff * ratio.to(q_eff.device)
    k_eff = torch.cat([c_kv[:, :, None, :], k_rope], dim=-1)
    v_eff = k_eff[..., :rkv]   # c_kv's values, as k's prefix: one tile
    # for both in the kernels
    out_latent = kernel_ops.flash_attention(
        q_eff, k_eff, v_eff, q_offset, causal=True,
        block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
    out = torch.einsum("bshr,rhk->bshk", out_latent, params["w_uv"])
    return out, c_kv, k_rope


def _mla_attend(params: Params, x: torch.Tensor, cfg,
                positions: torch.Tensor):
    """(out (b,s,h,dv), c_kv, k_rope): the absorbed flash route above
    ``flash_min_seq``, the dense reference on the full heads below."""
    if x.shape[1] > flash_min_seq(cfg):
        return _mla_absorbed_flash(params, x, cfg, positions)
    q, k, v, c_kv, k_rope = _mla_qkv_full(params, x, cfg, positions)
    return full_attention(q, k, v, causal=True), c_kv, k_rope


def mla_train(params: Params, x: torch.Tensor, cfg,
              positions: torch.Tensor) -> torch.Tensor:
    """The reference's ``mla_train``: absorbed flash above the threshold,
    dense full attention below it.  (The decoder layer runs
    ``blocks._mla_apply`` instead, as the reference's does.)"""
    out, _, _ = _mla_attend(params, x, cfg, positions)
    return torch.einsum("bshk,hkd->bsd", out, params["w_o"])


def mla_prefill(params: Params, x: torch.Tensor, cfg,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """As :func:`mla_train`, with the latent cache {"c_kv" (b,s,rkv),
    "k_rope" (b,s,dr)}."""
    out, c_kv, k_rope = _mla_attend(params, x, cfg, positions)
    o = torch.einsum("bshk,hkd->bsd", out, params["w_o"])
    return o, {"c_kv": c_kv, "k_rope": k_rope[:, :, 0, :]}


def mla_decode(params: Params, x: torch.Tensor, cfg,
               cache: Dict[str, torch.Tensor], cur_len: int
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-matrix MLA decode of one token in the compressed latent
    space (``dist.flash.mla_decode_attend``): W_UK folded into the query,
    W_UV into the output, so a step reads the caches c_kv (B, S_max,
    rkv) and k_rope (B, S_max, dr) and no per-head keys.  The new
    latents are written into the caches in place at ``cur_len``."""
    from repro_torch.dist.flash import mla_decode_attend

    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    pos = torch.full((1, 1), cur_len, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_queries(params, x, cfg, pos)
    c_new, kr_new = _mla_kv_latents(params, x, cfg, pos)
    q_latent = torch.einsum("bshk,rhk->bshr", q_nope, params["w_uk"])
    out_latent, c_kv, k_rope = mla_decode_attend(
        q_latent, q_rope, c_new, kr_new[:, :, 0], cache["c_kv"],
        cache["k_rope"], cur_len, scale=1.0 / np.sqrt(dn + dr))
    out = torch.einsum("bshr,rhk->bshk", out_latent, params["w_uv"])
    o = torch.einsum("bshk,hkd->bsd", out, params["w_o"])
    return o, {"c_kv": c_kv, "k_rope": k_rope}
