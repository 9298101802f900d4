"""Mesh-strategy dispatch for attention compute (torch port of
``repro.dist.flash``).

One place decides how attention parallelizes, so the model blocks never
mention the mesh.  Under an active mesh (``dist.sharding.use_mesh``) the
reference's ``shard_map`` regions run as the port's region functions
(``sharding.split`` / ``whole`` / ``gather``) around the same local
functions as one device, with collectives over the "model" group:

* **head-parallel** — when the head and kv-head counts both divide the
  "model" axis, each rank runs the local kernel on its heads; the output
  heads are gathered.  No collective inside (attention is independent
  per head).
* **context/sequence-parallel** — otherwise, when the sequence divides
  the "model" axis: q shards over sequence, k/v stay whole, and each rank
  computes its q stripe against the full context with ``q_offset`` =
  rank · S/m (a Python int from the mesh coordinate) keeping the causal
  mask globally positioned.  The flash threshold applies to the stripe.
  Each rank's k/v gradient is a partial sum, summed once over "model" in
  the backward.  Used for training and prefill.
* **lse-combine flash decode** — one-token decode against a cache whose
  *sequence* dim stripes over "model" (when the heads do not divide it):
  each rank computes a partial softmax over its §6 stripe, and the
  partials combine through a global max and two sums (the log-sum-exp
  trick), torch ops as the reference's are jnp.
* **single device** — no mesh (or ``pure_dp``): the flash kernels above
  the length threshold (K4f or K1 forward; with the logsumexp and the
  K4b, K3 or K2 backward when autograd records the call), the dense
  reference below it; contiguous-cache decode through K5 on the card, or,
  for CPU tensors, the dense ``decode_attention`` on seq-major views of
  the caches, as the reference's CPU decode takes its jnp oracle.

Paged decode over §6 pages of a shared cache pool is torch ops (the
reference has no kernel for it).  MLA decode in the compressed latent
space (``mla_decode_attend``) is torch ops too, its heads sharded over
"model" when they divide it.  Decode caches stay whole on every rank and
update in place; the mesh branches read the rank's heads or stripe.

The §6 reading: a decode cache is one data block; the sequence stripes
the lse-combine path walks are exactly the disjoint partitions
``partition_tree_of`` emits for the cache's ``kv_seq`` sharding.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.attention import (decode_attention, flash_min_seq,
                                          full_attention)
from .sharding import all_gather, all_reduce, current_ctx, gather, split, whole

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
                     cfg=None, window: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) attention.

    q: (B, S, H, hd); k, v: (B, S, KH, hd) → (B, S, H, hd_v).  The
    config's tile pins (``attn_block_q`` / ``attn_block_k``) ride to the
    planner, as the reference's ``_blocks`` carries them.  Under a mesh:
    head-parallel, else context-parallel, else local (module docs).
    """
    ctx = current_ctx()
    s, h = q.shape[1], q.shape[2]
    kh = k.shape[2]
    m = ctx.model_size

    def local(ql, kl, vl, q_offset=0):
        return _attn_local(ql, kl, vl, window=window,
                           block_q=getattr(cfg, "attn_block_q", None),
                           block_k=getattr(cfg, "attn_block_k", None),
                           min_seq=flash_min_seq(cfg), q_offset=q_offset)

    if not ctx.active or ctx.pure_dp or m <= 1:
        return local(q, k, v)
    if h % m == 0 and kh % m == 0:
        out = local(*(split(t, 2, "model", ctx) for t in (q, k, v)))
        return gather(out, 2, "model", ctx)
    if s % m == 0:
        off = ctx.coord("model") * (s // m)
        out = local(split(q, 1, "model", ctx), whole(k, "model", ctx),
                    whole(v, "model", ctx), q_offset=off)
        return gather(out, 1, "model", ctx)
    return local(q, k, v)


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

    q, k_new, v_new: (B, 1, H|KH, hd); caches head-major (B, KH, S, hd);
    cur_len: int, tokens already cached.  The caches are updated in place
    (the reference returns new arrays); returns (out (B, 1, H, hd_v),
    k_cache, v_cache).

    As the reference's ``dynamic_update_slice``, a start at or past the
    cache end clamps to the last slot, which the new token overwrites;
    the attention still counts ``cur_len + 1`` valid entries.

    Under a mesh the caches are whole on every rank (each writes the new
    token into its copy): head-parallel takes the rank's kv heads
    (contiguous copies, which K5 needs), else the lse-combine over the
    rank's sequence stripe, else the local decode.
    """
    pos = min(max(cur_len, 0), k_cache.shape[2] - 1)
    k_cache[:, :, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, :, pos] = v_new[:, 0].to(v_cache.dtype)
    valid = torch.full((1,), cur_len + 1, dtype=torch.int32,
                       device=q.device)
    ctx = current_ctx()
    h, kh, smax = q.shape[2], k_cache.shape[1], k_cache.shape[2]
    m = ctx.model_size
    if not ctx.active or ctx.pure_dp or m <= 1:
        out = _decode_local(q, k_cache, v_cache, valid, window)
    elif h % m == 0 and kh % m == 0:
        r = ctx.coord("model")
        hl, khl = h // m, kh // m
        out = _decode_local(
            q[:, :, r * hl:(r + 1) * hl].contiguous(),
            k_cache[:, r * khl:(r + 1) * khl].contiguous(),
            v_cache[:, r * khl:(r + 1) * khl].contiguous(), valid, window)
        out = all_gather(out, 2, "model", ctx)
    elif smax % m == 0:
        out = _lse_combine(q, k_cache, v_cache, cur_len, window, ctx)
    else:
        out = _decode_local(q, k_cache, v_cache, valid, window)
    return out, k_cache, v_cache


def _lse_combine(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cur_len: int, window: int, ctx
                 ) -> torch.Tensor:
    """Decode over this rank's §6 stripe of the cache's sequence: a partial
    softmax in fp32, merged over "model" through a global max and two
    sums (num, den)."""
    b, _, h, hd = q.shape
    kh, smax = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    chunk = smax // ctx.model_size
    lo = ctx.coord("model") * chunk
    pos = lo + torch.arange(chunk, device=q.device)
    valid = pos < cur_len + 1
    if window > 0:
        valid &= pos >= max(cur_len + 1 - window, 0)
    scale = 1.0 / np.sqrt(hd)
    qg = q[:, 0].reshape(b, kh, g, hd).float()
    s = torch.einsum("bkgh,bksh->bkgs", qg,
                     k_cache[:, :, lo:lo + chunk].float()) * scale
    s = torch.where(valid, s, NEG_INF)
    m_all = all_reduce(s.amax(dim=-1), "model", ctx, op="max")
    p = torch.where(valid, torch.exp(s - m_all[..., None]), 0.0)
    num = all_reduce(torch.einsum("bkgs,bksh->bkgh", p,
                                  v_cache[:, :, lo:lo + chunk].float()),
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

    q_latent: (B, 1, H, rkv); q_rope: (B, 1, H, dr); new latents c_new
    (B, 1, rkv) / kr_new (B, 1, dr); caches c_kv (B, S, rkv) / k_rope (B,
    S, dr), updated in place at ``cur_len`` (the reference returns new
    arrays; a start past the end clamps to the last slot, as its
    ``dynamic_update_slice`` does).  The scores sum both products in the
    input dtype and are scaled, masked and softmaxed in fp32; the
    probabilities are cast to the input dtype before the product with
    c_kv, as there.  Returns (out_latent (B, 1, H, rkv), c_kv, k_rope).
    Under a mesh whose "model" axis divides H, each rank attends with its
    heads (the caches are head-shared latents: no collective inside) and
    the heads are gathered.
    """
    pos = min(max(cur_len, 0), c_kv.shape[1] - 1)
    c_kv[:, pos] = c_new[:, 0].to(c_kv.dtype)
    k_rope[:, pos] = kr_new[:, 0].to(k_rope.dtype)

    def attend(ql, qr):
        s = (torch.einsum("bshr,btr->bhst", ql, c_kv)
             + torch.einsum("bshk,btk->bhst", qr, k_rope)).float()
        s = s * scale
        valid = torch.arange(c_kv.shape[1], device=c_kv.device) < cur_len + 1
        s = torch.where(valid[None, None, None, :], s, NEG_INF)
        probs = torch.softmax(s, dim=-1).to(ql.dtype)
        return torch.einsum("bhst,btr->bshr", probs, c_kv)

    ctx = current_ctx()
    m = ctx.model_size
    if ctx.active and not ctx.pure_dp and m > 1 and q_latent.shape[2] % m == 0:
        hl = q_latent.shape[2] // m
        r = ctx.coord("model")
        out = attend(q_latent[:, :, r * hl:(r + 1) * hl],
                     q_rope[:, :, r * hl:(r + 1) * hl])
        return all_gather(out, 2, "model", ctx), c_kv, k_rope
    return attend(q_latent, q_rope), c_kv, k_rope
