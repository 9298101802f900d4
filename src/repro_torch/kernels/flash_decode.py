"""K5: one-token GQA flash-decode against a head-major cache on Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_decode.py``
``_decode_kernel`` (launched by ``flash_decode``).  The CUDA source is
``csrc/flash_decode.cu``: a split-sequence decode (Flash-Decoding), in
which ``autotune.decode_splits`` blocks per (batch, kv head) each run
the online softmax over a share of the live span and write their
partial (m, l, acc) in fp32, and a second kernel combines the partials
in split order (:func:`combine_partials_plain` is its plain version).
``cur_len`` (valid cache entries, the new token included) stays on the
device, so a decode loop never waits on the host; the kernel skips cache
rows at or past ``cur_len`` and, with a window, rows before
``cur_len − window``, and masks the ragged edge by index.  It takes any
head width that is a multiple of 8 up to 128
(``autotune.kernel_head_dim`` over ``autotune.DECODE_PAIRS``): compiled
at 64 and 128, it zero-fills
the columns past hd in shared memory, and the wrapper passes 1/√hd.
A meta tensor (the dry run) takes the meta route: the checks, the
output and the split partials at their shapes, no launch.  Both routes
add K5's work to ``kernels.counts.KERNELS``, over every cache position
(or the window): the wrapper never reads ``cur_len``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build, autotune, counts
from .flash_attention import _sm_count

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 8          # query heads per kv head one block holds


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, cur_len: torch.Tensor, *,
                       window: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch, fp32 throughout: the CPU
    path of :func:`flash_decode` and its reference on the card.

    q: (B, KH, G, hd); caches (B, KH, S, hd); cur_len: int32 tensor with
    one element → (B, KH, G, hd_v).
    """
    hd = q.shape[-1]
    s = torch.einsum("bkgh,bksh->bkgs", q.float(), k_cache.float())
    s = s * (1.0 / np.sqrt(hd))
    cur = cur_len.reshape(()).to(q.device)
    pos = torch.arange(k_cache.shape[2], device=q.device)
    mask = pos < cur
    if window > 0:
        mask = mask & (pos >= cur - window)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-37)
    out = torch.einsum("bkgs,bksh->bkgh", p, v_cache.float()) / den
    return out.to(q.dtype)


def combine_partials_plain(m: torch.Tensor, l: torch.Tensor,
                           acc: torch.Tensor) -> torch.Tensor:
    """The lse-combine of partial softmaxes, in plain PyTorch: K5's
    second kernel.

    m, l: (..., NS, G) fp32, each split's running max and denominator;
    acc: (..., NS, G, hd) fp32, its unnormalised p·v → (..., G, hd) fp32:
    ``m* = max mᵢ``, ``o = Σ accᵢ·e^{mᵢ−m*} / max(Σ lᵢ·e^{mᵢ−m*}, 1e-37)``,
    summed in split order.  A split with no live key holds (−1e30, 0, 0):
    its weight is exactly 0, so it changes no bit of the result.
    """
    m_all = m[..., 0, :]
    for i in range(1, m.shape[-2]):
        m_all = torch.maximum(m_all, m[..., i, :])
    den = torch.zeros_like(m_all)
    num = torch.zeros_like(acc[..., 0, :, :])
    for i in range(m.shape[-2]):
        w = torch.exp(m[..., i, :] - m_all)
        den = den + l[..., i, :] * w
        num = num + acc[..., i, :, :] * w[..., None]
    return num / torch.clamp(den, min=1e-37)[..., None]


def check_shapes(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the caches are (B, KH, S, hd) under q's
    (B, KH, G, hd) with a head width K5 takes (a multiple of 8 up to
    128) and 1 ≤ G ≤ ``MAX_GROUP``.  A pure function of the shapes."""
    b, kh, g, hd = q.shape
    try:
        autotune.kernel_head_dim(hd, pairs=autotune.DECODE_PAIRS)
    except ValueError as e:
        raise ValueError(f"flash_decode: {e}") from None
    if k_cache.shape[:2] != (b, kh) or k_cache.shape[3] != hd \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} vs caches "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"flash_decode: group {g} outside 1..{MAX_GROUP}")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cur_len: torch.Tensor, *,
                 window: int = 0) -> torch.Tensor:
    """q: (B, KH, G, hd); caches (B, KH, S, hd); cur_len: int32 tensor
    with one element, on q's device → (B, KH, G, hd).

    CUDA tensors launch K5 on the current stream (its split kernel over
    ``autotune.decode_splits`` blocks per (batch, kv head), planned for
    the card's SM count, then the combine); CPU tensors take :func:`flash_decode_plain`.
    ``flash_decode.launches`` counts the calls that launched K5 and
    ``flash_decode.last_splits`` holds the split count of the last one.
    """
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, cur_len, window=window)
    b, kh, g, hd = q.shape
    s = k_cache.shape[2]
    if q.device.type not in ("cuda", "meta") or any(
            t.device != q.device for t in (k_cache, v_cache, cur_len)):
        raise ValueError("flash_decode: all operands must share one CUDA "
                         "device (or all lie on meta)")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_decode: dtype {q.dtype} (want one of "
                        f"{list(_DTYPES)} on q and both caches)")
    if cur_len.dtype != torch.int32 or cur_len.numel() != 1:
        raise TypeError("flash_decode: cur_len must be one int32 element")
    check_shapes(q, k_cache, v_cache)
    meta = q.device.type == "meta"
    if not meta and not all(t.is_contiguous() and t.data_ptr() % 16 == 0
                            for t in (q, k_cache, v_cache)):
        raise ValueError("flash_decode: q and caches must be contiguous and "
                         "16-byte aligned")
    splits = autotune.decode_splits(
        b, kh, s, int(window),
        autotune.SM_COUNT if meta else _sm_count(q.device.index))
    out = torch.empty_like(q)
    # per split and query row: acc (hd), then m, then l, all fp32
    part = torch.empty(b * kh * splits * g * (hd + 2), dtype=torch.float32,
                       device=q.device)
    counts.count("k5", counts.decode_work(
        b, kh, g, counts.decode_span(s, int(window)), hd, q.element_size()))
    if meta:
        return out
    err = _build.load().repro_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cur_len.data_ptr(), out.data_ptr(), part.data_ptr(), b, kh, g, s,
        hd, int(window), splits, autotune.DECODE_TILE, _DTYPES[q.dtype],
        1.0 / np.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_decode launch")
    flash_decode.launches += 1
    flash_decode.last_splits = splits
    return out


flash_decode.launches = 0
flash_decode.last_splits = 0
