"""K1: causal / sliding-window GQA flash-attention forward on Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
``_fwd_kernel`` (launched by ``_fwd_call``).  The CUDA source is
``csrc/flash_attention.cu``; its header says how the TPU grid's
sequential kv axis became a loop inside one thread block and how the
tiles fit the card.  Forward only: the logsumexp residual and the
backward kernels come with the training slice.

Conventions kept from the reference so results match: scale 1/√hd folded
into q, masked scores −1e30, denominator floor 1e-37, ``q_offset`` the
global position of q row 0 (the causal and window masks compare global
positions), ragged ``Sk`` masked by index.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# rows of q per block of the plain version: bounds its (rows × Sk) scores
_PLAIN_ROWS = 1024


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_offset: int = 0, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch, fp32 throughout: the CPU
    path of :func:`flash_attention` and its reference on the card.

    q: (B, H, Sq, hd); k, v: (B, KH, Sk, hd) → (B, H, Sq, hd_v).
    """
    b, h, sq, hd = q.shape
    _, kh, sk, _ = k.shape
    g = h // kh
    scale = 1.0 / np.sqrt(hd)
    qf = q.reshape(b, kh, g, sq, hd).float() * scale
    kf, vf = k.float(), v.float()
    cols = torch.arange(sk, device=q.device)
    outs = []
    for r0 in range(0, sq, _PLAIN_ROWS):
        qc = qf[:, :, :, r0:r0 + _PLAIN_ROWS]
        rows = q_offset + r0 + torch.arange(qc.shape[3], device=q.device)
        s = torch.einsum("bkgqh,bksh->bkgqs", qc, kf)
        mask = torch.ones(rows.shape[0], sk, dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = cols[None, :] <= rows[:, None]
        if window > 0:
            mask = mask & (rows[:, None] - cols[None, :] < window)
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-37)
        outs.append(torch.einsum("bkgqs,bksh->bkgqh", p, vf) / den)
    out = torch.cat(outs, dim=3)
    return out.reshape(b, h, sq, vf.shape[-1]).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KH, Sk, hd) → (B, H, Sq, hd).

    CUDA tensors launch K1 on the current stream; CPU tensors take
    :func:`flash_attention_plain`.  ``flash_attention.launches`` counts
    kernel launches.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_offset, causal=causal,
                                     window=window)
    b, h, sq, hd = q.shape
    _, kh, sk, _ = k.shape
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must share one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} (want one of "
                        f"{list(_DTYPES)} on all of q, k, v)")
    if hd not in _HEAD_DIMS or k.shape[-1] != hd or v.shape != k.shape:
        raise ValueError(f"flash_attention: head_dim {hd} (want one of "
                         f"{_HEAD_DIMS}, equal for q, k, v)")
    if h % kh or k.shape[0] != b:
        raise ValueError(f"flash_attention: {h} q heads over {kh} kv heads")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be contiguous and "
                         "16-byte aligned")
    out = torch.empty_like(q)
    lib = _build.load()
    err = lib.repro_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, kh, sq, sk, hd, int(q_offset), int(causal), int(window),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
