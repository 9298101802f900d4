"""Layout adapters from model conventions to the kernels' conventions.

Model layout (B, S, H, hd) becomes the kernels' head-major (B, H, S, hd)
here, not in model code, as in ``repro.kernels.ops``.
"""
from __future__ import annotations

import torch

from . import flash_attention as _fa
from . import flash_decode as _fd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """Model layout: q (B,S,H,hd), k/v (B,S,KH,hd) → (B,S,H,hd_v)."""
    out = _fa.flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), q_offset,
                              causal=causal, window=window)
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
