"""Attention, dense GQA subset: q/k/v projections, the dense reference
attention, one-token decode attention and the flash threshold.

Layout conventions (as in ``repro.models.attention``):
  q            : (batch, seq, n_heads, head_dim)
  k, v         : (batch, seq, n_kv_heads, head_dim)
Sequences longer than :func:`flash_min_seq` take the flash kernel
(``repro_torch.dist.flash``); :func:`full_attention` is the dense path
below it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .layers import Params, _dtype, dense_init

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
