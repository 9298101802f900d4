"""K9: the Mamba2 SSD chunked scan on Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py``
``_ssd_kernel`` (launched by ``ssd_scan``).  The CUDA source is
``csrc/ssd_scan.cu``: one block per (batch, head) loops over the chunks
in order with the (P, N) state in shared memory, where the TPU kernel
carried it across the sequential axis of its grid.

Layouts, as the reference kernel's:
  x: (B, H, S, P)   dt: (B, H, S) fp32   A: (H,) fp32   B, C: (B, S, N)
  → y (B, H, S, P) in x's dtype, final state (B, H, P, N) fp32.

The chunk is ``min(chunk, S)``; a ragged S is padded to whole chunks by
dt = 0 steps (decay 1, no input) and y sliced back, as
``repro.models.mamba.ssd_chunked`` does, so the state stays exact.  The
kernel reads x, dt and y through their strides, so a transposed view of
the model's (B, S, H, P) tensors costs no copy.

There is no backward kernel yet: on a CUDA tensor the autograd Function
around K9 raises in its backward; on the CPU autograd differentiates the
plain version.
"""
from __future__ import annotations

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_P, MAX_N = 128, 64, 128


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128):
    """The kernel's function in plain PyTorch, fp32 throughout: the CPU
    path of :func:`ssd_scan` and its reference on the card.  A loop over
    chunks, each computing the TPU kernel's four terms for every
    (batch, head) at once."""
    b, h, s, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, s)
    pad = -s % chunk
    xf, dtf = x.float(), dt.float()
    Bf, Cf = B.float(), C.float()
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))
        dtf = torch.nn.functional.pad(dtf, (0, pad))
        Bf = torch.nn.functional.pad(Bf, (0, 0, 0, pad))
        Cf = torch.nn.functional.pad(Cf, (0, 0, 0, pad))
    a = A.float()[None, :, None]                              # (1, H, 1)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=x.device))
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s + pad, chunk):
        xc = xf[:, :, c0:c0 + chunk]                          # (B, H, Q, P)
        dtc = dtf[:, :, c0:c0 + chunk]                        # (B, H, Q)
        bc, cc = Bf[:, c0:c0 + chunk], Cf[:, c0:c0 + chunk]   # (B, Q, N)
        cum = torch.cumsum(dtc * a, dim=-1)
        total = cum[..., -1:]
        cb = torch.einsum("bqn,btn->bqt", cc, bc)[:, None]    # (B, 1, Q, Q)
        decay = torch.exp(cum[..., :, None] - cum[..., None, :])
        # select, not multiply: the masked decay overflows to inf
        att = torch.where(tri, cb * decay * dtc[..., None, :], 0.0)
        y = att @ xc
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bqn,bhpn->bhqp", cc, state)
        w = torch.exp(total - cum) * dtc                      # (B, H, Q)
        state = (torch.exp(total)[..., None] * state
                 + torch.einsum("bhqp,bqn->bhpn", xc * w[..., None], bc))
        ys.append(y)
    y = torch.cat(ys, dim=2)[:, :, :s]
    return y.to(x.dtype), state


def _check(x, dt, A, B, C, chunk):
    b, h, s, p = x.shape
    n = B.shape[-1]
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (dt, A, B, C)):
        raise ValueError("ssd_scan: all operands must share one CUDA device")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, B, C dtypes {x.dtype}, {B.dtype}, "
                        f"{C.dtype} (want one of {list(_DTYPES)} on all three)")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("ssd_scan: dt and A must be float32")
    if dt.shape != (b, h, s) or A.shape != (h,) or B.shape != (b, s, n) \
            or C.shape != B.shape:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)},"
                         f" A {tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}")
    if not (8 <= p <= MAX_P and p % 8 == 0 and 8 <= n <= MAX_N
            and n % 8 == 0 and 1 <= chunk and s >= 1):
        raise ValueError(f"ssd_scan: P={p}, N={n}, chunk={chunk}: the kernel "
                         f"takes P and N multiples of 8 up to {MAX_P} and "
                         f"{MAX_N}, and chunk >= 1")
    if min(chunk, s) > MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {min(chunk, s)} > {MAX_CHUNK}")
    if x.stride(3) != 1 or B.stride(2) != 1 or C.stride(2) != 1 \
            or not A.is_contiguous():
        raise ValueError("ssd_scan: the last dimension of x, B and C must "
                         "be unit-stride, A contiguous")


def _launch(x, dt, A, B, C, chunk):
    _check(x, dt, A, B, C, chunk)
    b, h, s, p = x.shape
    n = B.shape[-1]
    # empty_like keeps x's strides when x is a dense view, so a transposed
    # view of the model layout gets its output in the model layout too
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    err = _build.load().repro_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), state.data_ptr(), b, h, s, p, n, chunk,
        *x.stride()[:3], *y.stride()[:3], *dt.stride(), *B.stride()[:2],
        *C.stride()[:2], _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_scan launch")
    ssd_scan.launches += 1
    return y, state


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        return _launch(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        raise NotImplementedError("K9 backward: not ported yet")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128):
    """x: (B, H, S, P); dt: (B, H, S) fp32; A: (H,) fp32; B/C: (B, S, N)
    → (y (B, H, S, P) in x's dtype, final state (B, H, P, N) fp32).

    CUDA tensors launch K9 on the current stream (x, dt may be strided
    views; P and N multiples of 8 up to 64 and 128, chunk up to 128,
    anything else raises); CPU tensors take :func:`ssd_scan_plain`.
    ``ssd_scan.launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    return _SSDScan.apply(x, dt, A, B, C, chunk)


ssd_scan.launches = 0
