"""Layout adapters from model conventions to the kernels' conventions.

Model layout (B, S, H, hd) becomes the kernels' head-major (B, H, S, hd)
here, not in model code, as in ``repro.kernels.ops``; flat byte buffers
become the copy kernels' (rows, 128) views.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import flash_attention as _fa
from . import flash_decode as _fd
from . import partition_copy as _pc
from . import ssd_scan as _ssd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0, *, causal: bool = True,
                    window: int = 0, block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Model layout: q (B,S,H,hd), k (B,S,KH,hd), v (B,S,KH,hd_v) →
    (B,S,H,hd_v); (hd, hd_v) is one of the widths the kernels take
    (``autotune.kernel_head_dim``), such as MLA's (192, 128).

    Differentiable: the transposes are torch ops outside the kernels'
    autograd Function, so gradients come back in model layout.
    ``q_offset`` is the global position of q row 0 (no gradient).
    ``block_q``/``block_k`` default to the planner; ints pin the tiles,
    which keeps the call off the K4 megakernels (as in the reference).
    Where v is k's first columns (``flash_attention.is_k_prefix``: the
    absorbed MLA route's v = c_kv inside k = [c_kv, k_rope]), v reaches
    the kernels as the same prefix of the transposed k, not as a copy of
    its own; the values, and the gradient's sum into k's columns, are
    the same.
    """
    kt = k.transpose(1, 2).contiguous()
    vt = (kt[..., :v.shape[-1]] if _fa.is_k_prefix(k, v)
          else v.transpose(1, 2).contiguous())
    out = _fa.flash_attention(q.transpose(1, 2).contiguous(), kt, vt,
                              q_offset, causal=causal, window=window,
                              block_q=block_q, block_k=block_k)
    return out.transpose(1, 2)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cur_len: torch.Tensor, *,
                 window: int = 0) -> torch.Tensor:
    """Serving layout: q (B,1,H,hd), head-major caches (B,KH,S,hd).

    Returns (B, 1, H, hd_v).  ``cur_len`` = valid entries incl. the new
    token, an int32 tensor with one element on q's device.
    """
    b, _, h, hd = q.shape
    kh = k_cache.shape[1]
    qg = q.reshape(b, kh, h // kh, hd).contiguous()
    out = _fd.flash_decode(qg, k_cache, v_cache, cur_len, window=window)
    return out.reshape(b, 1, h, out.shape[-1])


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128):
    """Model layout: x (B,S,H,P), dt (B,S,H), B/C (B,S,N).

    Returns (y (B,S,H,P), state (B,H,P,N)).  The kernel reads the
    transposed views through their strides and writes y into a buffer
    laid out as (B,S,H,P), so neither transpose copies.
    """
    y, st = _ssd.ssd_scan(x.transpose(1, 2), dt.transpose(1, 2), A, B, C,
                          chunk=chunk)
    return y.transpose(1, 2), st


# ---------------------------------------------------------- §6.3 copies

def _rows(buf: torch.Tensor, what: str) -> torch.Tensor:
    """The (rows, 128) view of a flat uint8 buffer's whole rows (a
    lane-aligned range never reaches the ragged tail)."""
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise TypeError(f"{what}: want flat uint8 buffers, got {buf.dtype} "
                        f"{tuple(buf.shape)}")
    lanes = _pc.LANES
    return buf[:buf.numel() - buf.numel() % lanes].view(-1, lanes)


def _row_ranges(ranges, nd: int, ns: int) -> np.ndarray:
    """Validate ``(dst_off, src_off, size)`` byte triples as the reference
    does (the first range at fault raises, with the reference's message)
    and turn them into an (n, 3) array of row triples."""
    lanes = _pc.LANES
    r = _pc.as_rows(ranges)
    d, s, n = r.T
    if len(r) and (n.min() <= 0 or r.min() < 0
                   or np.bitwise_or.reduce(r, axis=None) % lanes) \
            or _pc._ends_past(r, nd, ns):
        empty = n <= 0
        misaligned = ((d % lanes) | (s % lanes) | (n % lanes)) != 0
        oob = (d + n > nd) | (s + n > ns) | (d < 0) | (s < 0)
        i = int(np.argmax(empty | misaligned | oob))
        d_off, s_off, size = r[i].tolist()
        if empty[i]:
            raise ValueError(f"empty copy range ({d_off},{s_off},{size})")
        if misaligned[i]:
            raise ValueError(
                f"range ({d_off},{s_off},{size}) not 128-byte aligned")
        raise ValueError(f"range ({d_off},{s_off},{size}) out of bounds "
                         f"(dst {nd}, src {ns})")
    if not _pc.disjoint(d, n):
        raise ValueError("destination ranges overlap")
    return r // lanes


def partition_copy_bytes(dst: torch.Tensor, src: torch.Tensor, *,
                         dst_off: int, src_off: int,
                         size: int) -> torch.Tensor:
    """§6.3 copy of one range on flat uint8 buffers; returns the new dst
    (``dst`` itself is not written) with ``src[src_off:src_off+size]`` at
    ``dst_off``.  Offsets and size need only be lane-aligned (128 B):
    32 KiB-aligned copies take the tile-per-block kernel (K6), anything
    else the multi-range kernel (K7, or K8 above the staging threshold)
    with one range."""
    row_ranges = _row_ranges(((dst_off, src_off, size),), dst.numel(),
                             src.numel())
    d_row, s_row, rows = row_ranges[0].tolist()
    out = dst.clone()
    d2, s2 = _rows(out, "partition_copy_bytes"), _rows(src,
                                                       "partition_copy_bytes")
    tile = _pc.BLOCK_ROWS
    if d_row % tile == 0 and s_row % tile == 0 and rows % tile == 0:
        _pc.partition_copy(d2, s2, d_row, s_row, rows)
    else:
        _pc.multi_partition_copy(d2, s2, row_ranges, checked=True)
    return out


def multi_partition_copy_bytes(dst: torch.Tensor, src: torch.Tensor, ranges,
                               *, block_rows: int = _pc.BLOCK_ROWS
                               ) -> torch.Tensor:
    """Fused §6.3 copy of a whole partition set in one kernel launch.

    dst/src: flat uint8 buffers.  ``ranges`` is a sequence of ``(dst_off,
    src_off, size)`` byte triples, each a multiple of 128 (lane
    granularity).  Destination ranges must be mutually disjoint (overlap
    raises ``ValueError``); sources may overlap (a gather).  Returns the
    new dst; ``dst`` is not written and every range reads the original
    ``src``.
    """
    out = dst.clone()
    return multi_partition_copy_bytes_(out, src, ranges,
                                       block_rows=block_rows)


def multi_partition_copy_bytes_(dst: torch.Tensor, src: torch.Tensor, ranges,
                                *, block_rows: int = _pc.BLOCK_ROWS
                                ) -> torch.Tensor:
    """:func:`multi_partition_copy_bytes` in place on ``dst`` (returned);
    ``src`` must not share memory with it.  The ranges are checked here,
    once, and reach the kernel's wrapper as checked rows."""
    row_ranges = _row_ranges(ranges, dst.numel(), src.numel())
    what = "multi_partition_copy_bytes"
    _pc.multi_partition_copy(_rows(dst, what), _rows(src, what), row_ranges,
                             block_rows=block_rows, checked=True)
    return dst
