"""Attention compute for one rank (torch port of ``repro.dist.flash``).

The reference's ``shard_map`` regions decide from the shapes they are
given how attention parallelizes.  In the port the layers decide
(``models.tp``, from the resolved spec of their own leaves) and hand
these functions operands already cut to the rank's share, so nothing
here splits or gathers heads:

* **causal attention** (train, prefill): q / k / v of the rank's heads
  (head-parallel), or a q stripe whose row 0 sits at global position
  ``q_offset`` against k / v that the layer gathered over the sequence
  (context-parallel; their gradients reduce-scatter in
  ``sharding.gather_seq``).  The flash kernels above the length
  threshold (K4f or K1 forward; with the logsumexp and the K4b, K3 or K2
  backward when autograd records the call), the dense reference below
  it; the threshold applies to the stripe.
* **decode** against caches at rest in the layer's layout:
  :func:`decode_update_and_attend` on caches holding the rank's kv heads
  (or every head off the mesh), through K5 on the card, or, for CPU
  tensors, the dense ``decode_attention`` on seq-major views of the
  caches, as the reference's CPU decode takes its jnp oracle;
  :func:`stripe_update_and_attend` on whole-head caches holding the
  rank's stripe of the sequence: the rank that owns the new position
  writes it, and each rank's partial softmax merges over "model"
  through a global max and two sums (the log-sum-exp trick), torch ops
  as the reference's are jnp.

Paged decode over §6 pages of a shared cache pool is torch ops (the
reference has no kernel for it).  MLA decode in the compressed latent
space (``mla_decode_attend``) is torch ops too, on the heads it is given
against latents that every head shares.

The §6 reading: a decode cache is one data block; the sequence stripes
the lse-combine walks are exactly the disjoint partitions
``partition_tree_of`` emits for the cache's ``kv_seq`` sharding.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.attention import (decode_attention, flash_min_seq,
                                          full_attention)
from .sharding import all_reduce, current_ctx

NEG_INF = -1e30


def _attn_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                window: int, block_q: Optional[int] = None,
                block_k: Optional[int] = None, min_seq: int = 2048,
                q_offset: int = 0) -> torch.Tensor:
    """Single-shard causal attention: the flash kernels for sequences
    longer than ``min_seq`` (K4f or K1 forward; under autograd with the
    logsumexp and the K4b, K3 or K2 backward, as the planner says; pinned
    tiles keep it off K4), dense reference for short ones.  ``q_offset``
    is the global position of q row 0."""
    if q.shape[1] > min_seq:
        return kernel_ops.flash_attention(q, k, v, q_offset, causal=True,
                                          window=window, block_q=block_q,
                                          block_k=block_k)
    return full_attention(q, k, v, causal=True, window=window,
                          q_offset=q_offset)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     cfg=None, window: int = 0, q_offset: int = 0
                     ) -> torch.Tensor:
    """Causal (optionally sliding-window) attention of the heads and rows
    it is given.

    q: (B, Sq, H, hd); k, v: (B, S, KH, hd) → (B, Sq, H, hd_v); q row 0
    sits at global position ``q_offset`` (a context-parallel stripe).
    The config's tile pins (``attn_block_q`` / ``attn_block_k``) ride to
    the planner, as the reference's ``_blocks`` carries them.
    """
    return _attn_local(q, k, v, window=window,
                       block_q=getattr(cfg, "attn_block_q", None),
                       block_k=getattr(cfg, "attn_block_k", None),
                       min_seq=flash_min_seq(cfg), q_offset=q_offset)


# ------------------------------------------------------------------- decode

def _decode_local(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, valid: torch.Tensor,
                  window: int) -> torch.Tensor:
    """One-token attention against head-major caches.

    q: (B, 1, H, hd); caches: (B, KH, S, hd); valid: int32 tensor with one
    element, the count of valid cache entries.  A CUDA tensor always
    launches K5 (the kernel masks the ragged tail itself, so no length
    gate).  A CPU tensor takes the dense ``decode_attention`` over
    seq-major views of the caches, as ``repro/dist/flash.py``
    ``_decode_local`` does off the TPU: its probabilities round to q's
    dtype before the PV product, as prefill's ``full_attention`` does, so
    a bf16 decode matches the reference's bit for bit (K5's plain version
    keeps them in fp32, as K5 does).
    """
    if q.device.type == "cpu":
        return decode_attention(q, k_cache.transpose(1, 2),
                                v_cache.transpose(1, 2),
                                cur_len=valid.reshape(()), window=window)
    return kernel_ops.flash_decode(q, k_cache, v_cache, valid, window=window)


def decode_update_and_attend(q: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, cur_len: int, *,
                             window: int = 0):
    """Insert the new token at ``cur_len`` and attend over ``cur_len + 1``.

    q, k_new, v_new: (B, 1, H|KH, hd); caches head-major (B, KH, S, hd),
    every position (under a mesh, of the rank's kv heads); cur_len: int,
    tokens already cached.  The caches are updated in place (the
    reference returns new arrays); returns (out (B, 1, H, hd_v),
    k_cache, v_cache).

    As the reference's ``dynamic_update_slice``, a start at or past the
    cache end clamps to the last slot, which the new token overwrites;
    the attention still counts ``cur_len + 1`` valid entries.
    """
    pos = min(max(cur_len, 0), k_cache.shape[2] - 1)
    k_cache[:, :, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, :, pos] = v_new[:, 0].to(v_cache.dtype)
    valid = torch.full((1,), cur_len + 1, dtype=torch.int32,
                       device=q.device)
    return (_decode_local(q, k_cache, v_cache, valid, window), k_cache,
            v_cache)


def stripe_update_and_attend(q: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, k_stripe: torch.Tensor,
                             v_stripe: torch.Tensor, cur_len: int, *,
                             window: int = 0):
    """:func:`decode_update_and_attend` against whole-head caches that
    hold this rank's stripe of the sequence: (B, KH, C, hd), positions
    ``rank · C`` … of the C · m the cache holds over "model".  The rank
    that owns ``cur_len`` (clamped to the last slot) writes the new
    token; every rank attends over its stripe, and the partials merge
    over "model" (:func:`_lse_combine`).  Returns (out (B, 1, H, hd_v),
    k_stripe, v_stripe)."""
    ctx = current_ctx()
    chunk = k_stripe.shape[2]
    lo = ctx.coord("model") * chunk
    pos = min(max(cur_len, 0), chunk * ctx.model_size - 1) - lo
    if 0 <= pos < chunk:
        k_stripe[:, :, pos] = k_new[:, 0].to(k_stripe.dtype)
        v_stripe[:, :, pos] = v_new[:, 0].to(v_stripe.dtype)
    return (_lse_combine(q, k_stripe, v_stripe, cur_len, window, ctx, lo),
            k_stripe, v_stripe)


def _lse_combine(q: torch.Tensor, k_stripe: torch.Tensor,
                 v_stripe: torch.Tensor, cur_len: int, window: int, ctx,
                 lo: int) -> torch.Tensor:
    """Decode over this rank's §6 stripe of the cache's sequence (the
    positions ``lo`` …): a partial softmax in fp32, merged over "model"
    through a global max and two sums (num, den)."""
    b, _, h, hd = q.shape
    kh, chunk = k_stripe.shape[1], k_stripe.shape[2]
    g = h // kh
    pos = lo + torch.arange(chunk, device=q.device)
    valid = pos < cur_len + 1
    if window > 0:
        valid &= pos >= max(cur_len + 1 - window, 0)
    scale = 1.0 / np.sqrt(hd)
    qg = q[:, 0].reshape(b, kh, g, hd).float()
    s = torch.einsum("bkgh,bksh->bkgs", qg, k_stripe.float()) * scale
    s = torch.where(valid, s, NEG_INF)
    m_all = all_reduce(s.amax(dim=-1), "model", ctx, op="max")
    p = torch.where(valid, torch.exp(s - m_all[..., None]), 0.0)
    num = all_reduce(torch.einsum("bkgs,bksh->bkgh", p, v_stripe.float()),
                     "model", ctx)
    den = all_reduce(p.sum(dim=-1), "model", ctx)
    out = num / torch.clamp(den, min=1e-37)[..., None]
    return out.reshape(b, 1, h, -1).to(q.dtype)


# ------------------------------------------------------------- paged decode

def paged_update_and_attend(q: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, page_table: torch.Tensor,
                            cur_lens: torch.Tensor, active: torch.Tensor, *,
                            window: int = 0):
    """Per-request paged decode over §6 pages of a shared cache pool.

    q, k_new, v_new: (B, 1, H|KH, hd); pools (P, KH, page, hd), updated in
    place; ``page_table`` (B, max_pages) int32 whose unused entries hold
    the sentinel P; ``cur_lens`` (B,) int32 tokens already cached per
    row; ``active`` (B,) bool — inactive rows write nothing and output
    zeros.  Returns (out (B,1,H,hd_v), k_pages, v_pages).

    The reference lets XLA drop out-of-range scatters and clamp
    out-of-range gathers; torch raises on both, so this function states
    them.  A dropped write (inactive row, sentinel page) repeats the
    write of the first live row, or rewrites a slot with its own value
    when no row is live, so every write of the step to one location
    carries the same value.  Gathers clamp to the last page, whose
    positions the mask then zeroes.  Nothing here waits on the host.
    """
    b, _, h, hd = q.shape
    npages, kh, page, _ = k_pages.shape
    g = h // kh
    max_pages = page_table.shape[1]
    scale = 1.0 / np.sqrt(hd)
    cur = cur_lens.long()
    table = page_table.long()
    rows = torch.arange(b, device=q.device)

    # scatter the new token: row i writes page_table[i, cur//page] slot
    # cur%page; dropped rows take over row `first`'s write
    phys = table[rows, torch.clamp(cur // page, max=max_pages - 1)]
    live = active & (phys < npages)
    first = torch.argmax(live.to(torch.int32))     # first live row, else 0
    src = torch.where(live, rows, first)
    tgt = torch.clamp(phys, max=npages - 1)[src]
    slot = (cur % page)[src]
    for pool, new in ((k_pages, k_new), (v_pages, v_new)):
        old = pool[tgt, :, slot]                      # (B, KH, hd)
        val = new[src, 0].to(pool.dtype)
        pool[tgt, :, slot] = torch.where(live[src][:, None, None], val, old)

    # gather each row's page list and softmax across all its pages
    gathered = torch.clamp(table, max=npages - 1)
    kg = k_pages[gathered].float()                  # (B, mp, KH, page, hd)
    vg = v_pages[gathered].float()
    qg = q[:, 0].reshape(b, kh, g, hd).float()
    s = torch.einsum("bkgh,bpksh->bkgps", qg, kg) * scale
    pos = (torch.arange(max_pages, device=q.device)[:, None] * page
           + torch.arange(page, device=q.device)[None, :])     # (mp, page)
    valid = pos[None] < (cur + 1)[:, None, None]
    if window > 0:
        lo = torch.clamp(cur + 1 - window, min=0)
        valid &= pos[None] >= lo[:, None, None]
    vmask = valid[:, None, None]
    s = torch.where(vmask, s, NEG_INF)
    m_all = s.amax(dim=(-2, -1))                     # (B, KH, g)
    p = torch.exp(s - m_all[..., None, None])
    p = torch.where(vmask, p, 0.0)
    num = torch.einsum("bkgps,bpksh->bkgh", p, vg)
    den = p.sum(dim=(-2, -1))
    out = num / torch.clamp(den, min=1e-37)[..., None]
    out = out * active[:, None, None, None]
    return out.reshape(b, 1, h, -1).to(q.dtype), k_pages, v_pages


# ---------------------------------------------------------------- MLA decode

def mla_decode_attend(q_latent: torch.Tensor, q_rope: torch.Tensor,
                      c_new: torch.Tensor, kr_new: torch.Tensor,
                      c_kv: torch.Tensor, k_rope: torch.Tensor,
                      cur_len: int, *, scale: float):
    """Absorbed-matrix MLA decode in the compressed latent space.

    q_latent: (B, 1, H, rkv); q_rope: (B, 1, H, dr) — every head, or under
    a mesh the rank's; new latents c_new (B, 1, rkv) / kr_new (B, 1, dr);
    caches c_kv (B, S, rkv) / k_rope (B, S, dr), shared by every head and
    updated in place at ``cur_len`` (the reference returns new arrays; a
    start past the end clamps to the last slot, as its
    ``dynamic_update_slice`` does).  The scores sum both products in the
    input dtype and are scaled, masked and softmaxed in fp32; the
    probabilities are cast to the input dtype before the product with
    c_kv, as there.  Returns (out_latent (B, 1, H, rkv), c_kv, k_rope).
    """
    pos = min(max(cur_len, 0), c_kv.shape[1] - 1)
    c_kv[:, pos] = c_new[:, 0].to(c_kv.dtype)
    k_rope[:, pos] = kr_new[:, 0].to(k_rope.dtype)
    s = (torch.einsum("bshr,btr->bhst", q_latent, c_kv)
         + torch.einsum("bshk,btk->bhst", q_rope, k_rope)).float()
    s = s * scale
    valid = torch.arange(c_kv.shape[1], device=c_kv.device) < cur_len + 1
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(q_latent.dtype)
    return torch.einsum("bhst,btr->bshr", probs, c_kv), c_kv, k_rope
