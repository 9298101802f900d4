"""K1, K2, K3: causal / sliding-window GQA flash attention on Hopper,
forward and backward.

Replaces the Pallas TPU kernels of ``repro/kernels/flash_attention.py``:

* K1 ``_fwd_kernel`` (``csrc/flash_attention.cu``): the forward, with the
  per-row logsumexp as an optional output (``with_lse``);
* K2 ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``
  (``csrc/flash_attention_bwd.cu``): the split backward, dq per q tile
  and dk/dv per kv tile with the GQA group sum inside one block — no
  atomics, bit-reproducible;
* K3 ``_bwd_fused_kernel`` (same source): dq, dk and dv on one tile
  visit, dq summed into an fp32 buffer with atomics.

The CUDA sources' headers say how the TPU grids' sequential axes became
loops inside one thread block and how the tiles fit the card.  Each
kernel has a wrapper with a ``launches`` counter and a plain PyTorch
version, which the wrapper takes for CPU tensors; a CUDA tensor launches
the kernel or raises.

:func:`flash_attention` is differentiable.  The reference's custom VJP
becomes an autograd Function: its forward runs K1 with the logsumexp and
saves q, k, v, o and lse (never the S × S matrix); its backward computes
``delta = rowsum(dO · O)`` in fp32 and runs K3, or K2 when
``torch.are_deterministic_algorithms_enabled()`` (or when the caller pins
``fused_bwd``, the counterpart of the reference plan's field).  Without
autograd (serving, ``torch.no_grad``) K1 runs without the logsumexp.

Conventions kept from the reference so results match: scale 1/√hd folded
into q, masked scores −1e30, denominator floor 1e-37,
``lse = m + log(max(l, 1e-37))``, ``P = exp(s − lse)``,
``dS = P·(dP − delta)·scale``, ``q_offset`` the global position of q row
0 (the causal and window masks compare global positions; it takes no
gradient), ragged lengths masked by index.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# rows of q per block of the plain versions: bounds their (rows × Sk)
# score tiles
_PLAIN_ROWS = 1024


# ------------------------------------------------------------ plain versions

def _plain_tiles(q, k, q_offset, causal, window):
    """Per block of ≤ _PLAIN_ROWS q rows: (row slice, fp32 scaled q tile
    (B,KH,G,rows,hd), masked fp32 scores (B,KH,G,rows,Sk)) — the
    reference's scale-into-q and −1e30 masking, shared by the plain
    forward and backward."""
    b, h, sq, hd = q.shape
    _, kh, sk, _ = k.shape
    scale = 1.0 / np.sqrt(hd)
    qf = q.reshape(b, kh, h // kh, sq, hd).float() * scale
    kf = k.float()
    cols = torch.arange(sk, device=q.device)
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
        yield slice(r0, r0 + qc.shape[3]), qc, torch.where(mask, s, NEG_INF)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_offset: int = 0, *, causal: bool = True,
                          window: int = 0, with_lse: bool = False):
    """K1's function in plain PyTorch, fp32 throughout: the CPU path of
    the forward and its reference on the card.

    q: (B, H, Sq, hd); k, v: (B, KH, Sk, hd) → out (B, H, Sq, hd_v), and
    with ``with_lse`` also lse (B, H, Sq) fp32.
    """
    b, h, sq, _ = q.shape
    vf = v.float()
    outs, lses = [], []
    for _rows, _qc, s in _plain_tiles(q, k, q_offset, causal, window):
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-37)
        outs.append(torch.einsum("bkgqs,bksh->bkgqh", p, vf) / den)
        lses.append((m + torch.log(den))[..., 0])
    out = torch.cat(outs, dim=3).reshape(b, h, sq, vf.shape[-1]).to(q.dtype)
    if not with_lse:
        return out
    return out, torch.cat(lses, dim=3).reshape(b, h, sq)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              q_offset: int = 0, causal: bool = True,
                              window: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernels' function in plain PyTorch, fp32 throughout:
    ``delta = rowsum(do · o)``, then P recomputed from ``lse`` tile by
    tile with the reference's masking, as ``_bwd_dq_kernel`` /
    ``_bwd_dkv_kernel`` do.

    Returns (dq like q, dk like k, dv like v).
    """
    delta = (do.float() * o.float()).sum(-1)
    return _bwd_plain(q, k, v, do, lse, delta, q_offset, causal, window)


def _bwd_plain(q, k, v, do, lse, delta, q_offset, causal, window):
    """:func:`flash_attention_bwd_plain` from ``delta``: the CPU path of
    the K2 and K3 wrappers.  dK takes ``P·(dP − delta)`` against the
    pre-scaled q, as the kernels do; the reference's ``dS·q`` is the same
    product."""
    b, h, sq, hd = q.shape
    _, kh, sk, _ = k.shape
    g = h // kh
    scale = 1.0 / np.sqrt(hd)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(b, kh, g, sq, -1)
    lse5 = lse.reshape(b, kh, g, sq, 1)
    delta5 = delta.reshape(b, kh, g, sq, 1)
    dq = torch.empty(b, kh, g, sq, hd, device=q.device)
    dk = torch.zeros(b, kh, sk, hd, device=q.device)
    dv = torch.zeros(b, kh, sk, vf.shape[-1], device=q.device)
    for rows, qc, s in _plain_tiles(q, k, q_offset, causal, window):
        p = torch.exp(s - lse5[:, :, :, rows])
        do_c = dof[:, :, :, rows]
        dp = torch.einsum("bkgqh,bksh->bkgqs", do_c, vf)
        ds = p * (dp - delta5[:, :, :, rows])
        dq[:, :, :, rows] = torch.einsum("bkgqs,bksh->bkgqh", ds * scale, kf)
        dv += torch.einsum("bkgqs,bkgqh->bksh", p, do_c)
        dk += torch.einsum("bkgqs,bkgqh->bksh", ds, qc)
    return (dq.reshape(b, h, sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ----------------------------------------------------------------- wrappers

def _check(name, q, k, v, *rest):
    b, h, _sq, hd = q.shape
    _, kh, _sk, _ = k.shape
    tensors = (q, k, v, *rest)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: every tensor must lie on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} (want one of "
                        f"{list(_DTYPES)} on all of q, k, v)")
    if hd not in _HEAD_DIMS or k.shape[-1] != hd or v.shape != k.shape:
        raise ValueError(f"{name}: head_dim {hd} (want one of "
                         f"{_HEAD_DIMS}, equal for q, k, v)")
    if h % kh or k.shape[0] != b:
        raise ValueError(f"{name}: {h} q heads over {kh} kv heads")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous and 16-byte "
                         "aligned")


def _check_bwd(name, q, k, v, do, lse, delta):
    _check(name, q, k, v, do, lse, delta)
    b, h, sq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{name}: do must match q in shape and dtype")
    for t in (lse, delta):
        if t.shape != (b, h, sq) or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse and delta must be fp32 (B, H, Sq)")


def _dims(q, k, q_offset, causal, window):
    b, h, sq, hd = q.shape
    _, kh, sk, _ = k.shape
    return (b, h, kh, sq, sk, hd, int(q_offset), int(causal), int(window),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)


def _fwd_kernel(q, k, v, q_offset, causal, window, lse):
    _check("flash_attention", q, k, v)
    out = torch.empty_like(q)
    dims = _dims(q, k, q_offset, causal, window)
    err = _build.load().repro_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), *dims)
    _build.check(err, "flash_attention launch")
    return out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_offset: int = 0, *, causal: bool = True,
                        window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 with the logsumexp: (out (B, H, Sq, hd), lse (B, H, Sq) fp32).

    CUDA tensors launch K1 (``flash_attention_fwd.launches`` counts them);
    CPU tensors take :func:`flash_attention_plain`.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_offset, causal=causal,
                                     window=window, with_lse=True)
    b, h, sq, _ = q.shape
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    out = _fwd_kernel(q, k, v, q_offset, causal, window, lse)
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, q_offset: int = 0, *,
                           causal: bool = True, window: int = 0
                           ) -> torch.Tensor:
    """K2's dq pass: dq (B, H, Sq, hd) like q.  ``delta`` is
    rowsum(do · out) in fp32, (B, H, Sq).  CPU tensors take the plain
    backward."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, q_offset, causal,
                          window)[0]
    _check_bwd("flash_attention_bwd_dq", q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    err = _build.load().repro_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_dims(q, k, q_offset, causal, window))
    _build.check(err, "flash_attention_bwd_dq launch")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, q_offset: int = 0, *,
                            causal: bool = True, window: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's dk/dv pass: (dk, dv) like k, summed over each kv head's G
    query heads inside one block (no atomics)."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, q_offset, causal,
                          window)[1:]
    _check_bwd("flash_attention_bwd_dkv", q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _build.load().repro_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_dims(q, k, q_offset, causal, window))
    _build.check(err, "flash_attention_bwd_dkv launch")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_fused(q, k, v, do, lse, delta, q_offset: int = 0, *,
                              causal: bool = True, window: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """K3: (dq, dk, dv) in one launch.  dk and dv equal K2's bit for bit;
    dq is summed in fp32 with atomics (order varies run to run) and cast
    to q's dtype afterwards, as the reference casts K3's dk/dv outside
    its kernel."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, q_offset, causal,
                          window)
    _check_bwd("flash_attention_bwd_fused", q, k, v, do, lse, delta)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _build.load().repro_flash_bwd_fused(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *_dims(q, k, q_offset, causal, window))
    _build.check(err, "flash_attention_bwd_fused launch")
    flash_attention_bwd_fused.launches += 1
    return dq_acc.to(q.dtype), dk, dv


for _fn in (flash_attention_fwd, flash_attention_bwd_dq,
            flash_attention_bwd_dkv, flash_attention_bwd_fused):
    _fn.launches = 0


# ---------------------------------------------------- autograd and public

class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: forward K1 with lse, saving
    (q, k, v, o, lse); backward K3 or K2 (plain versions for CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, causal, window, fused_bwd):
        out, lse = flash_attention_fwd(q, k, v, q_offset, causal=causal,
                                       window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (q_offset, causal, window, fused_bwd)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        q_offset, causal, window, fused_bwd = ctx.opts
        do = do.contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(
                q, k, v, out, lse, do, q_offset, causal, window)
        else:
            delta = (do.float() * out.float()).sum(-1)
            fused = (not torch.are_deterministic_algorithms_enabled()
                     if fused_bwd is None else fused_bwd)
            if fused:
                dq, dk, dv = flash_attention_bwd_fused(
                    q, k, v, do, lse, delta, q_offset, causal=causal,
                    window=window)
            else:
                dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, q_offset,
                                            causal=causal, window=window)
                dk, dv = flash_attention_bwd_dkv(
                    q, k, v, do, lse, delta, q_offset, causal=causal,
                    window=window)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0, *, causal: bool = True,
                    window: int = 0, fused_bwd: Optional[bool] = None
                    ) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KH, Sk, hd) → (B, H, Sq, hd).

    Differentiable in q, k, v.  When autograd records this call, the
    forward is K1 with the logsumexp (counted by
    ``flash_attention_fwd.launches``) and the backward K3 by default, K2
    in deterministic mode or with ``fused_bwd=False``.  Otherwise CUDA
    tensors launch K1 alone (counted by ``flash_attention.launches``)
    and CPU tensors take :func:`flash_attention_plain`.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        # decided here: autograd is off inside Function.forward
        return _FlashAttention.apply(q, k, v, int(q_offset), bool(causal),
                                     int(window), fused_bwd)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_offset, causal=causal,
                                     window=window)
    out = _fwd_kernel(q, k, v, q_offset, causal, window, None)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
