"""K1, K2, K3, K4f, K4b: causal / sliding-window GQA flash attention on
Hopper, forward and backward.

Replaces the Pallas TPU kernels of ``repro/kernels/flash_attention.py``:

* K1 ``_fwd_kernel`` (``csrc/flash_attention.cu``): the forward, with the
  per-row logsumexp as an optional output (``with_lse``); bf16 on the
  tensor cores — ``wgmma`` on TMA-fed tiles at the pairs (64, 64) and
  (128, 128) (``csrc/flash_attention_hopper.cu``), ``mma.sync`` at
  (192, 128), the (576, 512) pair's own ``wgmma`` kernels
  (``csrc/flash_attention_wide.cu``) —, fp32 on the CUDA cores
  (``autotune.attn_route``);
* K2 ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``
  (``csrc/flash_attention_bwd.cu``; dk/dv at (64, 64) and (128, 128) in
  bf16 the ``wgmma`` kernel of ``csrc/flash_attention_hopper.cu``): the
  split backward, dq per q tile and dk/dv per kv tile with the GQA group
  sum inside one block — no atomics, bit-reproducible;
* K3 ``_bwd_fused_kernel`` (same sources): dq, dk and dv on one tile
  visit, dq summed into an fp32 buffer with atomics (TMA reduce-adds of
  a staged fp32 tile at (64, 64) and (128, 128) in bf16; at the (576,
  512) pair in bf16, from a stored dS in a fixed order instead);
* K4f ``_fwd_mega_kernel`` and K4b ``_bwd_mega_kernel`` (and their
  batch-tiled ``_bt`` variants; ``csrc/flash_attention_mega.cu``): the
  same functions for short sequences, one block per (batch, kv head)
  holding the whole K and V, read once for the whole GQA group — a
  backward that owns every query row of its kv head, so it writes whole
  dq rows and sums dk/dv in a fixed order without atomics; bf16 on the
  tensor cores (K1's online softmax and K2's two passes over the
  resident K and V), fp32 on the CUDA cores (a softmax over whole rows).

The CUDA sources' headers say how the TPU grids' sequential axes became
loops inside one thread block and how the tiles fit the card.  Each
kernel has a wrapper with a ``launches`` counter and a plain PyTorch
version, which the wrapper takes for CPU tensors; a CUDA tensor launches
the kernel or raises.  A meta tensor (the dry run, ``launch.cost``)
takes the meta route: the checks, the outputs and the scratch the CUDA
route allocates (lse, K3's fp32 dq accumulator), at their shapes and
dtypes, and no launch.  Both routes add the kernel's FLOPs and bytes to
``kernels.counts.KERNELS`` on every call.

:func:`flash_attention` is differentiable and plans each call from its
shapes, dtype and tile pins (``kernels/autotune.plan_attention``), as the
reference plans inside its ``flash_attention``: K4f where the plan says
``mega_fwd``, else K1; K4b where it says ``mega_bwd``, else K3 or K2.
The reference's custom VJP becomes an autograd Function: its forward
runs K4f or K1 with the logsumexp and saves q, k, v, o and lse (never
the S × S matrix); its backward computes ``delta = rowsum(dO · O)`` in
fp32 and runs K4b, or K3, or K2 when
``torch.are_deterministic_algorithms_enabled()`` (or when the caller pins
``fused_bwd``, the counterpart of the reference plan's field).  K4b is
deterministic, so it stays in deterministic mode.  Without autograd
(serving, ``torch.no_grad``) K4f or K1 runs without the logsumexp.

Conventions kept from the reference so results match: scale 1/√hd in
fp32 (folded into q where q is fp32 in the kernel, applied to the fp32
scores where the tensor cores take bf16 q), masked scores −1e30, denominator floor 1e-37,
``lse = m + log(max(l, 1e-37))`` (one convention for K1 and K4f, so
either forward feeds any backward), ``P = exp(s − lse)``,
``dS = P·(dP − delta)·scale``, ``q_offset`` the global position of q row
0 (the causal and window masks compare global positions; it takes no
gradient), ragged lengths masked by index.

Head widths: q and k have width hd, v and the output hd_v.  K1, K2 and
K3 take any pair of multiples of 8 that one of their compiled pairs
(64, 64), (128, 128), (192, 128) and (576, 512) holds
(``autotune.kernel_head_dim``; hd 32 for the ``reduced()`` configs, 120
for h2o-danube3-4b, (192, 128) for DeepSeek-V2's MLA heads, (48, 32) for
its narrow test variant and (576, 512) for its absorbed route, one
latent kv head for all 128 query heads; ``csrc/flash_attention_wide.cu``
holds that pair's kernels, whose dk/dv pass sums head slices through an
fp32 workspace that the K2 and K3 wrappers allocate, and whose bf16 K3
sums dq from a dS workspace, :func:`_ds_workspace`).  At that pair v
may be k's first 512 columns (:func:`is_k_prefix`, the absorbed route's
v = c_kv inside k = [c_kv, k_rope]): the kernels then read v through k's
row stride, and the bf16 K1 and K3 load one tile for both.  They zero-fill
the columns past the true widths in shared memory, so the tensors stay
unpadded; the wrapper passes the scale 1/√hd of the true q/k width.  A
pair past (576, 512) raises ``ValueError`` naming both widths.  The bf16
K4f and K4b take the widths
up to 128 the same way (``autotune.mega_width``), with hd_v == hd; the
fp32 ones take hd 64 and 128 only (``autotune.HEAD_DIMS``): the planner
keeps other shapes off them, and a K4 wrapper given one on the card
raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build, autotune, counts

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
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
    """K1's and K4f's function in plain PyTorch, fp32 throughout: the CPU
    path of both forwards and their reference on the card.  It takes
    K4f's form — a softmax over whole score rows, blocks of query rows —
    and K1's online softmax computes the same function.

    q: (B, H, Sq, hd); k: (B, KH, Sk, hd); v: (B, KH, Sk, hd_v) → out
    (B, H, Sq, hd_v), and with ``with_lse`` also lse (B, H, Sq) fp32.
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
    the K2, K3 and K4b wrappers.  dK takes ``P·(dP − delta)`` against the
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
    if q.device.type not in ("cuda", "meta") or any(
            t.device != q.device for t in tensors):
        raise ValueError(f"{name}: every tensor must lie on one CUDA device "
                         "(or all on meta)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} (want one of "
                        f"{list(_DTYPES)} on all of q, k, v)")
    check_head_dim(name, q, k, v)
    if h % kh or k.shape[0] != b:
        raise ValueError(f"{name}: {h} q heads over {kh} kv heads")
    if not (v.is_contiguous() or is_k_prefix(k, v)):
        raise ValueError(f"{name}: v must be contiguous, or k's first "
                         f"{autotune.WIDE_PAIR[1]} columns at "
                         f"{autotune.WIDE_PAIR}")
    if q.device.type == "cuda" and not all(
            (t.is_contiguous() or t is v) and t.data_ptr() % 16 == 0
            for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous and 16-byte "
                         "aligned")


def is_k_prefix(k: torch.Tensor, v: torch.Tensor) -> bool:
    """True where v is k's first ``v.shape[-1]`` columns — k's storage
    start, k's strides and sizes but the last — at the widths whose
    kernels take v so (:data:`autotune.WIDE_PAIR`, v 512 wide): the
    absorbed MLA route's v = c_kv inside k = [c_kv, k_rope].  A pure
    function of the two tensors' layout, in either the model's or the
    kernels' order of dims."""
    hd, hd_v = k.shape[-1], v.shape[-1]
    return (v.dim() == k.dim() == 4 and v.shape[:-1] == k.shape[:-1]
            and v.stride() == k.stride() and k.stride(-1) == 1
            and v.data_ptr() == k.data_ptr()
            and v.storage_offset() == k.storage_offset()
            and hd_v == autotune.WIDE_PAIR[1]
            and hd_v <= hd <= autotune.WIDE_PAIR[0] and hd % 8 == 0)


def _ldv(k, v):
    """v's row stride in elements: k's where v is k's prefix."""
    return k.shape[-1] if is_k_prefix(k, v) else v.shape[-1]


def check_head_dim(name, q, k, v):
    """Raise ``ValueError`` unless k has q's head width hd, v is (B, KH,
    Sk, hd_v) under k's (B, KH, Sk), and a compiled pair of the tiled
    kernels holds (hd, hd_v) (``autotune.kernel_head_dim``).  A pure
    function of the shapes."""
    hd, hd_v = q.shape[-1], v.shape[-1]
    try:
        autotune.kernel_head_dim(hd, hd_v)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if k.shape[-1] != hd or v.ndim != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"{name}: head_dim {hd}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: k as wide as q, v (B, KH, Sk) "
                         "as k")


def _check_bwd(name, q, k, v, do, lse, delta):
    _check(name, q, k, v, do, lse, delta)
    b, h, sq, _ = q.shape
    if do.shape != (b, h, sq, v.shape[-1]) or do.dtype != q.dtype:
        raise ValueError(f"{name}: do must be (B, H, Sq, hd_v) in q's "
                         "dtype")
    for t in (lse, delta):
        if t.shape != (b, h, sq) or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse and delta must be fp32 (B, H, Sq)")


def _dims(q, k, q_offset, causal, window, v=None):
    """The launch's shape ints; with ``v`` (the tiled kernels) hd_v and
    v's row stride follow hd."""
    b, h, sq, hd = q.shape
    _, kh, sk, _ = k.shape
    widths = (hd,) if v is None else (hd, v.shape[-1], _ldv(k, v))
    return (b, h, kh, sq, sk, *widths, int(q_offset), int(causal),
            int(window), _DTYPES[q.dtype])


def _scale(q):
    """1/√hd of the true head width: the tiled kernels may run it at a
    wider compiled one."""
    return 1.0 / np.sqrt(q.shape[-1])


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def _count(name, q, k, v, q_offset, causal, window) -> bool:
    """Add kernel ``name``'s work on these shapes to ``counts.KERNELS``;
    True where the call launches it (a CUDA tensor), False on meta."""
    b, h, sq, hd = q.shape
    _, kh, sk, _ = k.shape
    counts.count(name, counts.attention_work(
        name, b, h, kh, sq, sk, hd, v.shape[-1], int(q_offset), causal,
        window, q.element_size()))
    return q.device.type == "cuda"


def _fwd_kernel(q, k, v, q_offset, causal, window, lse):
    _check("flash_attention", q, k, v)
    out = q.new_empty((*q.shape[:3], v.shape[-1]))
    if not _count("k1" if lse is None else "k1_lse", q, k, v, q_offset,
                  causal, window):
        return out
    err = _build.load().repro_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *_dims(q, k, q_offset, causal, window, v), _scale(q), _stream(q))
    _build.check(err, "flash_attention launch")
    return out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_offset: int = 0, *, causal: bool = True,
                        window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 with the logsumexp: (out (B, H, Sq, hd_v), lse (B, H, Sq)
    fp32).

    CUDA tensors launch K1 (``flash_attention_fwd.launches`` counts them);
    CPU tensors take :func:`flash_attention_plain`.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_offset, causal=causal,
                                     window=window, with_lse=True)
    b, h, sq, _ = q.shape
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    out = _fwd_kernel(q, k, v, q_offset, causal, window, lse)
    flash_attention_fwd.launches += q.device.type == "cuda"
    return out, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, q_offset: int = 0, *,
                           causal: bool = True, window: int = 0
                           ) -> torch.Tensor:
    """K2's dq pass: dq (B, H, Sq, hd) like q; ``do`` is (B, H, Sq,
    hd_v) like the output.  ``delta`` is rowsum(do · out) in fp32, (B, H,
    Sq).  CPU tensors take the plain backward."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, q_offset, causal,
                          window)[0]
    _check_bwd("flash_attention_bwd_dq", q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    if not _count("k2_dq", q, k, v, q_offset, causal, window):
        return dq
    err = _build.load().repro_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_dims(q, k, q_offset, causal, window, v), _scale(q), _stream(q))
    _build.check(err, "flash_attention_bwd_dq launch")
    flash_attention_bwd_dq.launches += 1
    return dq


def _dkv_workspace(q, k, v):
    """(fp32 workspace, head slices) of the dk/dv pass: at
    ``autotune.WIDE_PAIR`` the kernel's blocks take slices of each kv
    head's query heads (``autotune.wide_dkv_splits``) and write their
    partial dK, dV there, (splits, B·KH·Sk, hd) then (splits, B·KH·Sk,
    hd_v), summed in slice order by the same launch; (None, 0) at the
    other pairs, whose blocks sum every query head themselves."""
    b, h, _sq, hd = q.shape
    _, kh, sk, _ = k.shape
    hd_v = v.shape[-1]
    if autotune.kernel_head_dim(hd, hd_v) != autotune.WIDE_PAIR:
        return None, 0
    splits = autotune.wide_dkv_splits(b * kh, h // kh, sk, q.element_size())
    ws = torch.empty(splits * b * kh * sk * (hd + hd_v), dtype=torch.float32,
                     device=q.device)
    return ws, splits


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, q_offset: int = 0, *,
                            causal: bool = True, window: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's dk/dv pass: (dk like k, dv like v), summed over each kv
    head's G query heads in a fixed order (no atomics): inside one block,
    or at the (576, 512) pair over head slices through an fp32 workspace
    (:func:`_dkv_workspace`)."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, q_offset, causal,
                          window)[1:]
    _check_bwd("flash_attention_bwd_dkv", q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), v.new_empty(v.shape)
    ws, splits = _dkv_workspace(q, k, v)
    if not _count("k2_dkv", q, k, v, q_offset, causal, window):
        return dk, dv
    err = _build.load().repro_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if ws is None else ws.data_ptr(), splits,
        *_dims(q, k, q_offset, causal, window, v), _scale(q), _stream(q))
    _build.check(err, "flash_attention_bwd_dkv launch")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def _ds_workspace(q, k, v, q_offset, causal, window):
    """(bf16 dS workspace, passes as a ctypes int array, their count) of
    K3 at ``autotune.WIDE_PAIR`` in bf16, whose dq kernel sums dq from the
    dS tile pairs the dk kernel stores, pass by pass
    (``autotune.wide_ds_passes``: the workspace holds the largest pass,
    under ``autotune.WIDE_DS_CAP``); (None, None, 0) elsewhere, where K3
    sums dq into an fp32 buffer with atomics."""
    b, h, sq, hd = q.shape
    if (q.dtype != torch.bfloat16
            or autotune.kernel_head_dim(hd, v.shape[-1])
            != autotune.WIDE_PAIR):
        return None, None, 0
    passes = autotune.wide_ds_passes(b * h, sq, k.shape[2], int(q_offset),
                                     bool(causal), int(window))
    most = max((p[2] for p in passes), default=0)
    ds = torch.empty(max(1, b * h * most * autotune.WIDE_DS_PAIR_BYTES // 2),
                     dtype=torch.bfloat16, device=q.device)
    flat = [x for p in passes for x in p]
    return ds, (ctypes.c_int * max(1, len(flat)))(*flat), len(passes)


def flash_attention_bwd_fused(q, k, v, do, lse, delta, q_offset: int = 0, *,
                              causal: bool = True, window: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """K3: (dq, dk, dv) in one launch.  dk and dv equal K2's bit for bit
    (the same code and, at the (576, 512) pair, the same head slices);
    dq is summed in fp32 with atomics (order varies run to run) and cast
    to q's dtype afterwards, as the reference casts K3's dk/dv outside
    its kernel — except at the (576, 512) pair in bf16, where a second
    kernel sums dq from the stored dS in a fixed order
    (:func:`_ds_workspace`): the same bits on every run."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, q_offset, causal,
                          window)
    _check_bwd("flash_attention_bwd_fused", q, k, v, do, lse, delta)
    ds, passes, n_pass = _ds_workspace(q, k, v, q_offset, causal, window)
    dq_acc = (torch.empty_like(q) if ds is not None else
              torch.zeros(q.shape, dtype=torch.float32, device=q.device))
    dk, dv = torch.empty_like(k), v.new_empty(v.shape)
    ws, splits = _dkv_workspace(q, k, v)
    if not _count("k3", q, k, v, q_offset, causal, window):
        return dq_acc.to(q.dtype), dk, dv
    err = _build.load().repro_flash_bwd_fused(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), None if ws is None else ws.data_ptr(), splits,
        None if ds is None else ds.data_ptr(), passes, n_pass,
        *_dims(q, k, q_offset, causal, window, v), _scale(q), _stream(q))
    _build.check(err, "flash_attention_bwd_fused launch")
    flash_attention_bwd_fused.launches += 1
    return dq_acc.to(q.dtype), dk, dv


def _mega_same_width(name, k, v):
    """K4 is compiled for v as wide as k: raise for any other v (the
    planner sends it none)."""
    if v.shape != k.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "K4 takes v shaped as k")


def _mega_block(name, bwd, sk, hd, dtype):
    """(strip or tile rows, shared-memory bytes) of the K4 block: the
    planner's gate, ``autotune.mega_rows`` and ``mega_smem_bytes``, which
    the launch takes as they are.  Raises where K4 does not take the head
    width (``autotune.mega_width``: bf16 any multiple of 8 up to 128,
    fp32 ``autotune.HEAD_DIMS``) or no block fits the shared memory."""
    if autotune.mega_width(hd, dtype.itemsize) == 0:
        raise ValueError(f"{name}: head_dim {hd} in {dtype} (K4 takes a "
                         "multiple of 8 up to 128 in bf16, "
                         f"{autotune.HEAD_DIMS} in fp32)")
    rows = autotune.mega_rows(bwd, sk, hd, dtype.itemsize)
    if rows == 0:
        raise ValueError(f"{name}: Sk {sk} at head_dim {hd} {dtype} does "
                         "not fit one block's shared memory")
    return rows, autotune.mega_smem_bytes(bwd, rows, sk, hd, dtype.itemsize)


def flash_attention_mega_fwd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, q_offset: int = 0, *,
                             causal: bool = True, window: int = 0,
                             with_lse: bool = False):
    """K4f: K1's function with one block per (batch, kv head) over the
    whole sequence, for v as wide as k.  Returns out (B, H, Sq, hd), and
    with ``with_lse`` also lse (B, H, Sq) fp32.

    CUDA tensors launch K4f (``flash_attention_mega_fwd.launches`` counts
    every launch, ``.lse_launches`` those with the logsumexp); CPU tensors
    take :func:`flash_attention_plain`, which computes K4f's function in
    K4f's own form, a softmax over whole rows.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_offset, causal=causal,
                                     window=window, with_lse=with_lse)
    name = "flash_attention_mega_fwd"
    _check(name, q, k, v)
    _mega_same_width(name, k, v)
    rows, smem = _mega_block(name, False, k.shape[2], q.shape[3], q.dtype)
    out = q.new_empty((*q.shape[:3], v.shape[-1]))
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if with_lse else None)
    if not _count("k4f_lse" if with_lse else "k4f", q, k, v, q_offset,
                  causal, window):
        return (out, lse) if with_lse else out
    err = _build.load().repro_flash_mega_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *_dims(q, k, q_offset, causal, window), rows, smem, _stream(q))
    _build.check(err, f"{name} launch")
    flash_attention_mega_fwd.launches += 1
    if not with_lse:
        return out
    flash_attention_mega_fwd.lse_launches += 1
    return out, lse


def flash_attention_mega_bwd(q, k, v, do, lse, delta, q_offset: int = 0, *,
                             causal: bool = True, window: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """K4b: (dq like q, dk and dv like k) in one launch, one block per
    (batch, kv head).  Whole dq rows are written once and dk/dv are summed
    in fp32 in a fixed order: no atomics, the same bits on every run.
    ``delta`` is rowsum(do · out) in fp32, (B, H, Sq).  CPU tensors take
    the plain backward, which is K4b's function in its own form (the
    whole-row P of each block of query rows)."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, q_offset, causal, window)
    name = "flash_attention_mega_bwd"
    _check_bwd(name, q, k, v, do, lse, delta)
    _mega_same_width(name, k, v)
    rows, smem = _mega_block(name, True, k.shape[2], q.shape[3], q.dtype)
    dq = torch.empty_like(q)
    # no query rows: no block runs, and dk, dv are zero
    alloc = torch.zeros_like if q.shape[2] == 0 else torch.empty_like
    dk, dv = alloc(k), alloc(v)
    if not _count("k4b", q, k, v, q_offset, causal, window):
        return dq, dk, dv
    err = _build.load().repro_flash_mega_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *_dims(q, k, q_offset, causal, window), rows, smem,
        _stream(q))
    _build.check(err, f"{name} launch")
    flash_attention_mega_bwd.launches += 1
    return dq, dk, dv


def mega_occupancy(bwd: bool, sk: int, hd: int,
                   dtype: torch.dtype) -> Tuple[int, int, int]:
    """(strip or tile rows, shared-memory bytes, blocks per SM) of the K4f
    (``bwd=False``) or K4b block at this Sk, head_dim and dtype, the last
    from the CUDA runtime's occupancy calculator for the compiled kernel
    on the current device; builds the kernels.  Raises where no strip
    fits."""
    rows, smem = _mega_block("mega_occupancy", bwd, sk, hd, dtype)
    blocks = ctypes.c_int(0)
    err = _build.load().repro_flash_mega_occupancy(
        int(bwd), hd, _DTYPES[dtype], rows, smem, ctypes.byref(blocks))
    _build.check(err, "mega_occupancy")
    return rows, smem, blocks.value


def fwd_occupancy(hd: int, dtype: torch.dtype,
                  hd_v: Optional[int] = None) -> int:
    """Blocks per SM of K1 at these head widths (``hd_v`` defaults to
    ``hd``) and dtype (bf16: the tensor-core kernel), from the CUDA
    runtime's occupancy calculator for the compiled kernel on the current
    device; builds the kernels."""
    blocks = ctypes.c_int(0)
    err = _build.load().repro_flash_fwd_occupancy(
        *autotune.kernel_head_dim(hd, hd_v), _DTYPES[dtype],
        ctypes.byref(blocks))
    _build.check(err, "fwd_occupancy")
    return blocks.value


def hopper_ranges(which: str, cases) -> np.ndarray:
    """The wgmma kernels' own tile ranges (``csrc/flash_attention_hopper.cu``,
    run on the host), which ``autotune`` mirrors: ``which`` "kv_tiles"
    takes (q0, Sq, Sk, q_offset, causal, window) cases and gives K1's
    (first kv row, tiles) (:func:`autotune.hopper_kv_tiles`); "q_tiles"
    takes (k0, ...) and gives the dk/dv block's (first q row, tiles)
    (:func:`autotune.hopper_q_tiles`); "q_order" takes (y, blocks) and
    gives K1's q row of block row y first (:func:`autotune.hopper_q_order`).
    (n, 2) int32; builds the kernels."""
    args = np.zeros((len(cases), 6), dtype=np.int32)
    for i, case in enumerate(cases):
        args[i, :len(case)] = case
    out = np.zeros((len(cases), 2), dtype=np.int32)
    err = _build.load().repro_hopper_ranges(
        ("kv_tiles", "q_tiles", "q_order").index(which), len(cases),
        args.ctypes.data, out.ctypes.data)
    _build.check(err, "hopper_ranges")
    return out


def bwd_occupancy(which: str, hd: int, dtype: torch.dtype,
                  hd_v: Optional[int] = None) -> int:
    """Blocks per SM of the backward kernel ``which`` ("dq", "dkv" or
    "fused") at these head widths (``hd_v`` defaults to ``hd``) and
    dtype, from the CUDA runtime's occupancy calculator for the compiled
    kernel on the current device; builds the kernels."""
    blocks = ctypes.c_int(0)
    err = _build.load().repro_flash_bwd_occupancy(
        ("dq", "dkv", "fused").index(which),
        *autotune.kernel_head_dim(hd, hd_v), _DTYPES[dtype],
        ctypes.byref(blocks))
    _build.check(err, "bwd_occupancy")
    return blocks.value


for _fn in (flash_attention_fwd, flash_attention_bwd_dq,
            flash_attention_bwd_dkv, flash_attention_bwd_fused,
            flash_attention_mega_fwd, flash_attention_mega_bwd):
    _fn.launches = 0
flash_attention_mega_fwd.lse_launches = 0


# ------------------------------------------------------------- planning

@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def attention_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   block_q: Optional[int] = None,
                   block_k: Optional[int] = None) -> autotune.AttnPlan:
    """``autotune.plan_attention`` for these tensors: their shapes and
    dtype, the tile pins, the SM count of q's card (read once per device;
    an H100's 132 for CPU tensors, so the CPU takes the routes the card
    would) and the card's measured K4 times, ``autotune.MEGA_TIMINGS``
    as it stands at the call."""
    b, _h, _sq, hd = q.shape
    _, kh, sk, _ = k.shape
    sm = (_sm_count(q.device.index) if q.device.type == "cuda"
          else autotune.SM_COUNT)
    bits = {torch.bfloat16: 16, torch.float32: 32}.get(q.dtype, 0)
    return autotune.plan_attention(sk, hd, v.shape[-1], kh, b, bits,
                                   block_q=block_q, block_k=block_k,
                                   sm_count=sm,
                                   timings=autotune.MEGA_TIMINGS)


# ---------------------------------------------------- autograd and public

class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: forward K4f or K1 with lse,
    saving (q, k, v, o, lse); backward K4b, K3 or K2 (plain versions for
    CPU), as ``plan`` says."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, causal, window, fused_bwd, plan):
        kw = dict(causal=causal, window=window)
        if plan.mega_fwd:
            out, lse = flash_attention_mega_fwd(q, k, v, q_offset,
                                                with_lse=True, **kw)
        else:
            out, lse = flash_attention_fwd(q, k, v, q_offset, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (q_offset, causal, window, fused_bwd, plan)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        q_offset, causal, window, fused_bwd, plan = ctx.opts
        do = do.contiguous()
        if q.device.type == "cpu" and not plan.mega_bwd:
            dq, dk, dv = flash_attention_bwd_plain(
                q, k, v, out, lse, do, q_offset, causal, window)
            return dq, dk, dv, None, None, None, None, None
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta, q_offset)
        kw = dict(causal=causal, window=window)
        if plan.mega_bwd:          # deterministic: kept in that mode too
            dq, dk, dv = flash_attention_mega_bwd(*args, **kw)
        elif (not torch.are_deterministic_algorithms_enabled()
              if fused_bwd is None else fused_bwd):
            dq, dk, dv = flash_attention_bwd_fused(*args, **kw)
        else:
            dq = flash_attention_bwd_dq(*args, **kw)
            dk, dv = flash_attention_bwd_dkv(*args, **kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0, *, causal: bool = True,
                    window: int = 0, fused_bwd: Optional[bool] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k: (B, KH, Sk, hd); v: (B, KH, Sk, hd_v) →
    (B, H, Sq, hd_v).

    Differentiable in q, k, v.  Each call is planned by
    :func:`attention_plan`; ``block_q`` / ``block_k`` are the config's
    tile pins, which turn K4 off (K1–K3 keep their own tiles).  When
    autograd records this call, the forward is K4f or K1 with the
    logsumexp (``flash_attention_mega_fwd.lse_launches``,
    ``flash_attention_fwd.launches``) and the backward K4b, else K3 by
    default and K2 in deterministic mode or with ``fused_bwd=False``.
    Otherwise CUDA tensors launch K4f or K1 alone (counted by
    ``flash_attention_mega_fwd.launches`` / ``flash_attention.launches``)
    and CPU tensors take :func:`flash_attention_plain`.
    """
    plan = attention_plan(q, k, v, block_q=block_q, block_k=block_k)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        # decided here: autograd is off inside Function.forward
        return _FlashAttention.apply(q, k, v, int(q_offset), bool(causal),
                                     int(window), fused_bwd, plan)
    if plan.mega_fwd:
        return flash_attention_mega_fwd(q, k, v, q_offset, causal=causal,
                                        window=window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_offset, causal=causal,
                                     window=window)
    out = _fwd_kernel(q, k, v, q_offset, causal, window, None)
    flash_attention.launches += q.device.type == "cuda"
    return out


flash_attention.launches = 0
