"""The work each kernel does, counted from its shapes.

Every kernel wrapper adds one call, the FLOPs its function needs and the
bytes it must move (each input read once, each output written once) to
:data:`KERNELS` under the kernel's name, from the shapes of the call: on
the card as a host-side add beside each launch, and on the meta device
(``launch.cost``, the dry run) in place of the launch.  The same
functions give ``chip_smoke.py`` the operations and bytes behind each
kernel's bound, so the kernel table's bounds and the dry run's roofline
read the same numbers.

Names: ``k1`` (forward), ``k1_lse`` (forward with the logsumexp),
``k2_dq`` / ``k2_dkv`` (the deterministic backward), ``k3`` (the fused
backward), ``k4f`` / ``k4f_lse`` / ``k4b`` (the megakernels), ``k5``
(decode), ``k9`` (the SSD scan) and ``k9b`` (its backward).

Attention FLOPs are 2 × the width of each product per live (query, key)
pair (:func:`live_pairs`): S and P·V forward; S, dP, dV, dK and dQ in
the backward.  K5 cannot read ``cur_len`` (it stays on the device), so
its count is the dense decode's: every cache position, or the window.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# {kernel name: [calls, flops, bytes]}
KERNELS: Dict[str, List[int]] = {}


def count(name: str, work: Tuple[int, int]) -> None:
    """One call of kernel ``name`` doing ``work`` = (flops, bytes)."""
    entry = KERNELS.setdefault(name, [0, 0, 0])
    entry[0] += 1
    entry[1] += int(work[0])
    entry[2] += int(work[1])


def reset() -> None:
    KERNELS.clear()


def live_pairs(sq: int, sk: int, q_offset: int, causal: bool,
               window: int) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    pos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(pos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = (np.maximum(pos - window + 1, 0) if window > 0
          else np.zeros(sq, np.int64))
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _attn_sizes(b, h, kh, sq, sk, hd, hd_v, el):
    """Bytes of q, k, v, the output (and dO) and one fp32 row vector."""
    return (b * h * sq * hd * el, b * kh * sk * hd * el,
            b * kh * sk * hd_v * el, b * h * sq * hd_v * el, b * h * sq * 4)


def attention_work(name: str, b: int, h: int, kh: int, sq: int, sk: int,
                   hd: int, hd_v: int, q_offset: int, causal: bool,
                   window: int, el: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of attention kernel ``name`` ("k1", "k1_lse",
    "k2_dq", "k2_dkv", "k3", "k4f", "k4f_lse", "k4b") on these shapes;
    ``el`` is the element size of q, k and v."""
    live = b * h * live_pairs(sq, sk, q_offset, causal, window)
    qb, kb, vb, ob, rowb = _attn_sizes(b, h, kh, sq, sk, hd, hd_v, el)
    work = {
        "k1": (2 * (hd + hd_v) * live, qb + kb + vb + ob),
        "k1_lse": (2 * (hd + hd_v) * live, qb + kb + vb + ob + rowb),
        "k2_dq": (2 * (2 * hd + hd_v) * live,
                  2 * qb + kb + vb + ob + 2 * rowb),
        "k2_dkv": (2 * (2 * hd + 2 * hd_v) * live,
                   qb + 2 * kb + 2 * vb + ob + 2 * rowb),
        "k3": (2 * (3 * hd + 2 * hd_v) * live,
               2 * qb + 2 * kb + 2 * vb + ob + 2 * rowb),
        # K4 takes v as wide as k: the output is q-sized, v k-sized
        "k4f": (2 * (hd + hd_v) * live, 2 * qb + 2 * kb),
        "k4f_lse": (2 * (hd + hd_v) * live, 2 * qb + 2 * kb + rowb),
        "k4b": (2 * (3 * hd + 2 * hd_v) * live, 3 * qb + 4 * kb + 2 * rowb),
    }
    return work[name]


def decode_work(b: int, kh: int, g: int, span: int, hd: int, el: int
                ) -> Tuple[int, int]:
    """(FLOPs, bytes) of K5 over ``span`` cache positions: q·k and p·v per
    position and query head; q read and the output written, k and v of
    the span read once."""
    return (4 * b * kh * g * span * hd,
            (2 * b * kh * g * hd + 2 * b * kh * span * hd) * el)


def decode_span(s: int, window: int) -> int:
    """The positions K5 is counted over: the whole cache, or the window."""
    return min(s, window) if window > 0 else s


def ssd_work(b: int, h: int, s: int, p: int, n: int, chunk: int, el: int
             ) -> Tuple[int, int]:
    """(FLOPs, bytes) K9's function needs: per chunk of v positions the
    causal half of C·Bᵀ and att·x, v(v+1)(N+P), and the two state
    products 4vNP; x read and y written once, B, C, dt, A read once, the
    fp32 state written once."""
    q = min(chunk, s)
    flops = 0
    for c0 in range(0, s, q):
        v = min(q, s - c0)
        flops += b * h * (v * (v + 1) * (n + p) + 4 * v * n * p)
    nbytes = (2 * b * h * s * p * el + 2 * b * s * n * el + 4 * b * h * s
              + 4 * h + 4 * b * h * p * n)
    return flops, nbytes


def ssd_bwd_work(b: int, h: int, s: int, p: int, n: int, chunk: int,
                 el: int) -> Tuple[int, int]:
    """(FLOPs, bytes) the scan's VJP needs: per chunk of v positions and
    head, the causal half of dy·xᵀ and attᵀ·dy, 2v(v+1)P, and six vPN
    products (the entering states, their gradients, G·Bᵀ, S·Cᵀ and the
    state terms of dC and dB), 12vPN; per chunk and batch row, the causal
    half of C·Bᵀ, dCB·B and dCBᵀ·C, 3v(v+1)N.  x, dy, B, C, dt, A read
    once, dx, dB, dC, ddt, dA written once."""
    q = min(chunk, s)
    flops = 0
    for c0 in range(0, s, q):
        v = min(q, s - c0)
        flops += b * h * (2 * v * (v + 1) * p + 12 * v * p * n)
        flops += b * 3 * v * (v + 1) * n
    nbytes = (3 * b * h * s * p * el + 4 * b * s * n * el + 8 * b * h * s
              + 8 * h)
    return flops, nbytes
