"""Attention dispatch, single-device branches of ``repro.dist.flash``.

* prefill/training attention: the flash kernels above the length
  threshold (K1 forward; K1 with the logsumexp and the K3 / K2 backward
  when autograd records the call), the dense reference below it;
* contiguous-cache decode: insert the new token, then K5 flash-decode;
* paged decode over §6 pages of a shared cache pool, as torch ops (the
  reference has no kernel for it).

The mesh branches (head-, context-parallel, lse-combine decode) come with
the multi-device slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.attention import flash_min_seq, full_attention

NEG_INF = -1e30


def _attn_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                window: int, min_seq: int = 2048,
                q_offset: int = 0) -> torch.Tensor:
    """Single-shard causal attention: the flash kernels for sequences
    longer than ``min_seq`` (K1 forward; under autograd K1 with the
    logsumexp and the K3/K2 backward), dense reference for short ones.
    ``q_offset`` is the global position of q row 0."""
    if q.shape[1] > min_seq:
        return kernel_ops.flash_attention(q, k, v, q_offset, causal=True,
                                          window=window)
    return full_attention(q, k, v, causal=True, window=window,
                          q_offset=q_offset)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     cfg=None, window: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) attention.

    q: (B, S, H, hd); k, v: (B, S, KH, hd) → (B, S, H, hd_v).
    """
    return _attn_local(q, k, v, window=window, min_seq=flash_min_seq(cfg))


# ------------------------------------------------------------------- decode

def _decode_local(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, valid: torch.Tensor,
                  window: int) -> torch.Tensor:
    """One-token attention against head-major caches.

    q: (B, 1, H, hd); caches: (B, KH, S, hd); valid: int32 tensor with one
    element, the count of valid cache entries.  A CUDA tensor always
    launches K5 (the kernel masks the ragged tail itself, so no length
    gate); a CPU tensor takes its plain version.
    """
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

    Unlike the reference's ``dynamic_update_slice``, which clamps a start
    past the end and so overwrites the last slot, a full cache raises.
    """
    smax = k_cache.shape[2]
    if not 0 <= cur_len < smax:
        raise ValueError(f"decode at position {cur_len} past the cache "
                         f"length {smax}")
    k_cache[:, :, cur_len] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, :, cur_len] = v_new[:, 0].to(v_cache.dtype)
    valid = torch.full((1,), cur_len + 1, dtype=torch.int32,
                       device=q.device)
    out = _decode_local(q, k_cache, v_cache, valid, window)
    return out, k_cache, v_cache


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
