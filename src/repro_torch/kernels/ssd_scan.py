"""K9: the Mamba2 SSD chunked scan on Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py``
``_ssd_kernel`` (launched by ``ssd_scan``).  The CUDA source is
``csrc/ssd_scan.cu``, with two routes that :func:`route` picks from the
dtype and shape alone (``ssd_scan.last_route`` holds the last launch's):

* ``"tc"`` — bf16, P and N multiples of 16 up to 64 and 128 (mamba2's
  P 64 / N 128, zamba2's P 64 / N 64): chunk-parallel on the tensor
  cores, two launches.  K9s walks the chunks of each (b, h, 32 state
  rows) in order and stores the state *entering* every chunk to a
  scratch (B, H, nc, 2, P, N) bf16, a hi + lo pair; K9y then computes
  every chunk's y at once, C·Bᵀ once for :func:`tc_group` heads.  The
  scratch is B·H·nc·P·N·4 bytes, 268 MB at mamba2's 4 × 4096 and at
  1 × 16384, allocated per call and freed when it returns.
  :func:`ssd_chunk_states_plain` and :func:`ssd_chunk_scan_plain` are
  the two stages in plain PyTorch.
* ``"fp32"`` — fp32, and bf16 shapes outside that range: one block per
  (batch, head) loops over the chunks in order with the (P, N) state in
  shared memory, where the TPU kernel carried it across the sequential
  axis of its grid; fp32 FMAs.

Layouts, as the reference kernel's:
  x: (B, H, S, P)   dt: (B, H, S) fp32   A: (H,) fp32   B, C: (B, S, N)
  → y (B, H, S, P) in x's dtype, final state (B, H, P, N) fp32.

The chunk is ``min(chunk, S)``; a ragged S is padded to whole chunks by
dt = 0 steps (decay 1, no input) and y sliced back, as
``repro.models.mamba.ssd_chunked`` does, so the state stays exact.  The
kernel reads x, dt and y through their strides, so a transposed view of
the model's (B, S, H, P) tensors costs no copy.

The backward, K9b (``csrc/ssd_scan_bwd.cu``), has no TPU kernel to
port: the reference differentiates the jnp ``ssd_chunked``, and K9b
computes the same gradients on a CUDA tensor (:func:`ssd_scan_bwd_plain`
is its plain version, staged as :func:`ssd_chunk_dstates_plain` and
:func:`ssd_chunk_grads_plain`).  The forward saves only its inputs; the
backward recomputes the states entering each chunk and runs a reverse
state pass for the gradient of the state leaving each chunk, then the
chunk-parallel gradients, every sum over heads in a fixed order (two
calls give the same bits).  On the tc route all of it runs on the tensor
cores: K9s and K9s reversed (K9bs) into bf16 hi + lo scratches, then
K9bx (dx, ddt, dA, dCB) and K9bc (dB, dC) on ``mma.sync``; the fp32
route runs K9b's CUDA-core kernels.  The scratches (the states and their
gradients, B·H·nc·P·N·4 bytes each, 268 MB at mamba2's 4 × 4096) are
allocated per call and freed when it returns.  On the CPU autograd
differentiates the plain forward.

A meta tensor (the dry run) takes the meta route: the checks, the
outputs and the scratches each route allocates at their shapes, no
launch.  Both routes add K9's and K9b's work to
``kernels.counts.KERNELS`` (``"k9"``, ``"k9b"``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, counts
from .autotune import SM_COUNT
from .flash_attention import _sm_count

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_P, MAX_N = 128, 64, 128
TC_MAX_GROUP = 8               # K9y's heads per block (csrc TC_MAX_G)


def route(dtype: torch.dtype, p: int, n: int, chunk: int) -> str:
    """The kernel route of a call: ``"tc"`` for bf16 with P and N
    multiples of 16 up to :data:`MAX_P` / :data:`MAX_N` and a chunk
    (``min(chunk, S)``) up to :data:`MAX_CHUNK`, else ``"fp32"``."""
    if dtype == torch.bfloat16 and 16 <= p <= MAX_P and p % 16 == 0 \
            and 16 <= n <= MAX_N and n % 16 == 0 and 1 <= chunk <= MAX_CHUNK:
        return "tc"
    return "fp32"


# a K9y block's fixed work (C, B and dt loaded, C·Bᵀ) in heads' worth of
# its per-head work, fitted to the H100's K9y times at G = 1, 2, 4 and 8
# (PERF.md)
TC_BLOCK_HEADS = 0.55


def tc_group(b: int, h: int, nc: int, sm_count: int = SM_COUNT) -> int:
    """Heads per K9y block, G in 8, 4, 2, 1: the fewest waves of one block
    an SM on a card of ``sm_count`` SMs times a block's work
    (``TC_BLOCK_HEADS + G`` heads' worth).  More heads share a block's
    C·Bᵀ; fewer fill the card's last wave."""
    def cost(g):
        return -(-b * nc * -(-h // g) // sm_count) * (TC_BLOCK_HEADS + g)
    return min((TC_MAX_GROUP, 4, 2, 1), key=cost)


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
        # select before the exp: the masked decay overflows to inf, and
        # autograd's inf · 0 at those entries would make ddt and dA NaN
        decay = torch.exp(torch.where(
            tri, cum[..., :, None] - cum[..., None, :], -torch.inf))
        att = cb * decay * dtc[..., None, :]
        y = att @ xc
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bqn,bhpn->bhqp", cc, state)
        w = torch.exp(total - cum) * dtc                      # (B, H, Q)
        state = (torch.exp(total)[..., None] * state
                 + torch.einsum("bhqp,bqn->bhpn", xc * w[..., None], bc))
        ys.append(y)
    y = torch.cat(ys, dim=2)[:, :, :s]
    return y.to(x.dtype), state


def _chunked(x, dt, A, chunk, *bc):
    """fp32 views by chunk, ragged S padded with dt = 0 steps: x (B, H,
    nc, Q, P), dt (B, H, nc, Q), the in-chunk cumsum of dt·A, and each
    of ``bc`` (B, S, N) as (B, nc, Q, N)."""
    b, h, s, p = x.shape
    q = min(chunk, s)
    pad = -s % q
    nc = (s + pad) // q
    F = torch.nn.functional
    xf = F.pad(x.float(), (0, 0, 0, pad)).reshape(b, h, nc, q, p)
    dtf = F.pad(dt.float(), (0, pad)).reshape(b, h, nc, q)
    cum = torch.cumsum(dtf * A.float()[None, :, None, None], dim=-1)
    return (xf, dtf, cum, *(F.pad(t.float(), (0, 0, 0, pad)).reshape(
        b, nc, q, -1) for t in bc))


def ssd_chunk_states_plain(x: torch.Tensor, dt: torch.Tensor,
                           A: torch.Tensor, B: torch.Tensor, *,
                           chunk: int = 128):
    """K9s's function in plain PyTorch, fp32: (the state entering each
    chunk (B, H, nc, P, N), the final state (B, H, P, N)).  Every chunk's
    own contribution at once, then the carry over the chunks."""
    xf, dtf, cum, Bf = _chunked(x, dt, A, chunk, B)
    b, h, nc, _, p = xf.shape
    total = cum[..., -1:]
    w = torch.exp(total - cum) * dtf                       # (B, H, nc, Q)
    contrib = torch.einsum("bhcqp,bcqn->bhcpn", xf * w[..., None], Bf)
    decay = torch.exp(total[..., 0])                       # (B, H, nc)
    state = torch.zeros((b, h, p, Bf.shape[-1]), dtype=torch.float32,
                        device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = decay[:, :, c, None, None] * state + contrib[:, :, c]
    return torch.stack(entering, dim=2), state


def ssd_chunk_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         B: torch.Tensor, C: torch.Tensor,
                         states: torch.Tensor, *, chunk: int = 128
                         ) -> torch.Tensor:
    """K9y's function in plain PyTorch, fp32 sums: y (B, H, S, P) in x's
    dtype from the entering ``states`` (B, H, nc, P, N) of
    :func:`ssd_chunk_states_plain`, every chunk at once."""
    s = x.shape[2]
    xf, dtf, cum, Bf, Cf = _chunked(x, dt, A, chunk, B, C)
    b, h, nc, q, p = xf.shape
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    cb = torch.einsum("bcqn,bctn->bcqt", Cf, Bf)[:, None]  # (B,1,nc,Q,Q)
    decay = torch.exp(cum[..., :, None] - cum[..., None, :])
    # select, not multiply: the masked decay overflows to inf
    att = torch.where(tri, cb * decay * dtf[..., None, :], 0.0)
    y = att @ xf + torch.exp(cum)[..., None] * torch.einsum(
        "bcqn,bhcpn->bhcqp", Cf, states.float())
    return y.reshape(b, h, nc * q, p)[:, :, :s].to(x.dtype)


def ssd_chunk_dstates_plain(dt: torch.Tensor, A: torch.Tensor,
                            C: torch.Tensor, dy: torch.Tensor,
                            dstate: torch.Tensor = None, *,
                            chunk: int = 128):
    """K9bs's function in plain PyTorch, fp32: (the gradient of the state
    *leaving* each chunk (B, H, nc, P, N), the gradient of the initial
    state (B, H, P, N)).  Every chunk's own contribution
    Σ_q e^{cum_q} dy_qᵀ C_q at once, then the carry backwards over the
    chunks, G_c = e^{total_c} G_{c+1} + contribution_c, from ``dstate``
    (the final state's gradient; zeros if None)."""
    dyf, dtf, cum, Cf = _chunked(dy, dt, A, chunk, C)
    b, h, nc, _, p = dyf.shape
    total = cum[..., -1]                                   # (B, H, nc)
    contrib = torch.einsum("bhcqp,bcqn->bhcpn",
                           dyf * torch.exp(cum)[..., None], Cf)
    g = (torch.zeros((b, h, p, Cf.shape[-1]), dtype=torch.float32,
                     device=dy.device) if dstate is None else dstate.float())
    leaving = [None] * nc
    for c in reversed(range(nc)):
        leaving[c] = g
        g = torch.exp(total[:, :, c])[..., None, None] * g + contrib[:, :, c]
    return torch.stack(leaving, dim=2), g


def ssd_chunk_grads_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                          B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                          states: torch.Tensor, dstates: torch.Tensor, *,
                          chunk: int = 128):
    """K9bx's function in plain PyTorch, fp32 sums: (dx, ddt, dA, dB, dC)
    from the states entering each chunk (:func:`ssd_chunk_states_plain`)
    and the gradients of the states leaving them
    (:func:`ssd_chunk_dstates_plain`), every chunk at once.  dx, dB and
    dC come out in the inputs' dtypes, ddt and dA in fp32.

    Per chunk, with att[q,t] = C_q·B_t e^{cum_q − cum_t} dt_t (t ≤ q,
    selected), dAtt[q,t] = dy_q·x_t, w_t = e^{total − cum_t} dt_t and G
    the leaving state's gradient: dx_t = Σ_q att[q,t] dy_q + w_t G B_t;
    dC and dB from dCB = dAtt e^{cum_q − cum_t} dt_t summed over the
    heads, plus e^{cum_q} Sᵀ dy_q and w_t Gᵀ x_t; dcum collects
    ±(dAtt∘att) row and column sums, dy_q·y_off_q, −w_t x_t·G B_t and,
    on the chunk's last row, Σ_t w_t x_t·G B_t + e^{total}⟨G, S⟩; then
    ddt_t gains A Σ_{q≥t} dcum_q and dA Σ_q dcum_q Σ_{t≤q} dt_t."""
    b, h, s, p = x.shape
    xf, dtf, cum, Bf, Cf = _chunked(x, dt, A, chunk, B, C)
    _, _, nc, q, _ = xf.shape
    dyf = torch.nn.functional.pad(dy.float(), (0, 0, 0, nc * q - s)
                                  ).reshape(b, h, nc, q, p)
    S, G = states.float(), dstates.float()                # (B, H, nc, P, N)
    total = cum[..., -1:]                                  # (B, H, nc, 1)
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    cb = torch.einsum("bcqn,bctn->bcqt", Cf, Bf)[:, None]  # (B,1,nc,Q,Q)
    # select, not multiply: the masked decay overflows to inf
    decay = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                        0.0)
    dtt = dtf[..., None, :]                                # dt_t by column
    att = cb * decay * dtt
    datt = dyf @ xf.transpose(-1, -2)                      # dy_q·x_t
    w = torch.exp(total - cum) * dtf                       # (B, H, nc, Q)
    gb = torch.einsum("bcqn,bhcpn->bhcqp", Bf, G)          # G B_t
    u = (xf * gb).sum(-1)                                  # x_t·G B_t
    v = (dyf * torch.einsum("bcqn,bhcpn->bhcqp", Cf, S)).sum(-1)
    dx = att.transpose(-1, -2) @ dyf + w[..., None] * gb
    da = datt * att
    dcum = da.sum(-1) - da.sum(-2) + torch.exp(cum) * v - w * u
    dcum[..., -1] += (w * u).sum(-1) + torch.exp(total[..., 0]) * (
        G * S).sum((-1, -2))
    rev = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
    ddt = ((datt * cb * decay).sum(-2) + torch.exp(total - cum) * u
           + A.float()[None, :, None, None] * rev)
    dA = (dcum * torch.cumsum(dtf, -1)).sum((0, 2, 3))
    dcb = (datt * decay * dtt).sum(1)                      # (B, nc, Q, Q)
    dC = dcb @ Bf + torch.einsum("bhcqp,bhcpn->bcqn",
                                 dyf * torch.exp(cum)[..., None], S)
    dB = dcb.transpose(-1, -2) @ Cf + torch.einsum(
        "bhcqp,bhcpn->bcqn", xf * w[..., None], G)
    n = Bf.shape[-1]
    return (dx.reshape(b, h, nc * q, p)[:, :, :s].to(x.dtype),
            ddt.reshape(b, h, nc * q)[:, :, :s], dA,
            dB.reshape(b, nc * q, n)[:, :s].to(B.dtype),
            dC.reshape(b, nc * q, n)[:, :s].to(C.dtype))


def ssd_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                       dstate: torch.Tensor = None, *, chunk: int = 128):
    """The scan's VJP in plain PyTorch, fp32 and without autograd: K9b's
    reference on the card.  dy (B, H, S, P) is y's gradient, ``dstate``
    (B, H, P, N) the final state's (None: zeros).  Returns (dx, ddt, dA,
    dB, dC) in the kernel layout, dx / dB / dC in the inputs' dtypes.
    A ragged S is padded with dt = 0 steps, as the forward does."""
    states, _ = ssd_chunk_states_plain(x, dt, A, B, chunk=chunk)
    dstates, _ = ssd_chunk_dstates_plain(dt, A, C, dy, dstate, chunk=chunk)
    return ssd_chunk_grads_plain(x, dt, A, B, C, dy, states, dstates,
                                 chunk=chunk)


def _check(x, dt, A, B, C, chunk):
    b, h, s, p = x.shape
    n = B.shape[-1]
    dev = x.device
    if dev.type not in ("cuda", "meta") or any(
            t.device != dev for t in (dt, A, B, C)):
        raise ValueError("ssd_scan: all operands must share one CUDA device "
                         "(or all lie on meta)")
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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if every row of its last dimension starts on 16 bytes
    (the tc kernels copy rows by 16-byte cp.async), else a dense copy."""
    ok = t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for st in t.stride()[:-1])
    return t if ok else t.contiguous()


def _strides(x, y, dt, B, C):
    return (*x.stride()[:3], *y.stride()[:3], *dt.stride(), *B.stride()[:2],
            *C.stride()[:2])


def _launch_tc(x, dt, A, B, C, chunk, stages, scratch=None):
    """The tc route's launches on checked bf16 operands: ``stages`` 1 runs
    K9s (returns the scratch and the final state), 2 runs K9y on a given
    scratch (returns y), 3 both (returns y, state)."""
    b, h, s, p = x.shape
    n = B.shape[-1]
    nc = -(-s // min(chunk, s))
    meta = x.device.type == "meta"
    if not meta:
        x, B, C = _aligned(x), _aligned(B), _aligned(C)
    # y in x's layout, as the fp32 route's; the state only where K9s runs
    y = torch.empty_like(x) if stages & 2 else x
    state = torch.empty((b, h, p, n) if stages & 1 else (0,),
                        dtype=torch.float32, device=x.device)
    if scratch is None:
        scratch = torch.empty((b, h, nc, 2, p, n), dtype=torch.bfloat16,
                              device=x.device)
    if meta:
        return {1: (scratch, state), 2: y, 3: (y, state)}[stages]
    err = _build.load().repro_ssd_scan_tc(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), state.data_ptr(), scratch.data_ptr(), b,
        h, s, p, n, chunk, tc_group(b, h, nc, _sm_count(x.device.index)),
        *_strides(x, y, dt, B, C),
        stages, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_scan launch")
    return {1: (scratch, state), 2: y, 3: (y, state)}[stages]


def _check_tc(x, dt, A, B, C, chunk):
    _check(x, dt, A, B, C, chunk)
    p, n = x.shape[-1], B.shape[-1]
    if route(x.dtype, p, n, min(chunk, x.shape[2])) != "tc":
        raise ValueError(f"ssd_scan: {x.dtype} P={p} N={n} is not on the "
                         f"tc route")


def chunk_states_tc(x, dt, A, B, C, *, chunk: int = 128):
    """K9s alone (the tc route's shapes only): (the entering states as
    the scratch's (B, H, nc, 2, P, N) hi + lo pairs, the final state).
    For checks and timing; it leaves ``ssd_scan.launches`` alone."""
    _check_tc(x, dt, A, B, C, chunk)
    return _launch_tc(x, dt, A, B, C, chunk, 1)


def chunk_scan_tc(x, dt, A, B, C, scratch, *, chunk: int = 128):
    """K9y alone on the scratch of :func:`chunk_states_tc`: y."""
    _check_tc(x, dt, A, B, C, chunk)
    return _launch_tc(x, dt, A, B, C, chunk, 2, scratch)


def states_from_scratch(scratch: torch.Tensor) -> torch.Tensor:
    """The tc route's entering states as fp32 (B, H, nc, P, N): hi + lo."""
    return scratch[:, :, :, 0].float() + scratch[:, :, :, 1].float()


def _launch(x, dt, A, B, C, chunk):
    _check(x, dt, A, B, C, chunk)
    b, h, s, p = x.shape
    n = B.shape[-1]
    counts.count("k9", counts.ssd_work(b, h, s, p, n, chunk,
                                       x.element_size()))
    which = route(x.dtype, p, n, min(chunk, s))
    meta = x.device.type == "meta"
    if not meta:
        ssd_scan.last_route = which
        ssd_scan.route_launches[which] += 1
    if which == "tc":
        out = _launch_tc(x, dt, A, B, C, chunk, 3)
        ssd_scan.launches += not meta
        return out
    # empty_like keeps x's strides when x is a dense view, so a transposed
    # view of the model layout gets its output in the model layout too
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if meta:
        return y, state
    err = _build.load().repro_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), state.data_ptr(), b, h, s, p, n, chunk,
        *_strides(x, y, dt, B, C), _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_scan launch")
    ssd_scan.launches += 1
    return y, state


def _dstates_tc(dy, dt, A, C, dstate, chunk):
    """K9s reversed (K9bs on the tc route): the gradient of the state
    leaving each chunk as a (B, H, nc, 2, P, N) bf16 hi + lo scratch."""
    b, h, s, p = dy.shape
    n = C.shape[-1]
    nc = -(-s // min(chunk, s))
    dy, C = _aligned(dy), _aligned(C)
    scratch = torch.empty((b, h, nc, 2, p, n), dtype=torch.bfloat16,
                          device=dy.device)
    if dy.device.type == "meta":
        return scratch
    err = _build.load().repro_ssd_dstates_tc(
        dy.data_ptr(), dt.data_ptr(), A.data_ptr(), C.data_ptr(),
        0 if dstate is None else dstate.data_ptr(), scratch.data_ptr(), b, h,
        s, p, n, chunk, *dy.stride()[:3], *dt.stride(), *C.stride()[:2],
        torch.cuda.current_stream(dy.device).cuda_stream)
    _build.check(err, "ssd_scan backward: reverse state pass")
    return scratch


def _launch_bwd(x, dt, A, B, C, dy, dstate, chunk):
    """K9b on the forward's (checked) operands: (dx, ddt, dA, dB, dC).
    On the tc route the entering states come from K9s again and their
    gradients from K9s reversed, both as bf16 hi + lo scratches; the fp32
    route's K9b computes both itself.  ``dy`` is read through its strides
    where its last dimension is unit-stride."""
    b, h, s, p = x.shape
    n = B.shape[-1]
    if dy.shape != x.shape or dy.device != x.device or (
            dstate is not None and dstate.shape != (b, h, p, n)):
        raise ValueError(f"ssd_scan backward: dy {tuple(dy.shape)}, dstate "
                         f"{None if dstate is None else tuple(dstate.shape)}"
                         f" for x {tuple(x.shape)}, N={n}")
    if dy.dtype != x.dtype:
        raise TypeError(f"ssd_scan backward: dy {dy.dtype}, y {x.dtype}")
    if dy.stride(3) != 1:
        dy = dy.contiguous()
    if dstate is not None:
        dstate = dstate.float().contiguous()
    states = dstates = None
    if route(x.dtype, p, n, min(chunk, s)) == "tc":
        states, _ = _launch_tc(x, dt, A, B, C, chunk, 1)
        dstates = _dstates_tc(dy, dt, A, C, dstate, chunk)
    meta = x.device.type == "meta"
    if meta:
        nbytes = bwd_workspace_bytes(b, h, s, p, n, chunk, states is None)
    else:
        lib = _build.load()
        size = ctypes.c_longlong(0)
        _build.check(lib.repro_ssd_scan_bwd_workspace(
            b, h, s, p, n, chunk, int(states is None), ctypes.byref(size)),
            "ssd_scan backward workspace")
        nbytes = size.value
    work = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    dB = torch.empty_like(B, memory_format=torch.contiguous_format)
    dC = torch.empty_like(C, memory_format=torch.contiguous_format)

    counts.count("k9b", counts.ssd_bwd_work(b, h, s, p, n, chunk,
                                            x.element_size()))
    if meta:
        return dx, ddt, dA, dB, dC

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    err = lib.repro_ssd_scan_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), dy.data_ptr(), ptr(dstate), ptr(states), ptr(dstates),
        work.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), b, h, s, p, n, chunk,
        int(states is not None), *x.stride()[:3], *dy.stride()[:3],
        *dx.stride()[:3], *dt.stride(), *ddt.stride(), *B.stride()[:2],
        *C.stride()[:2], *dB.stride()[:2], *dC.stride()[:2],
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_scan backward launch")
    ssd_scan.bwd_launches += 1
    return dx, ddt, dA, dB, dC


def bwd_workspace_bytes(b: int, h: int, s: int, p: int, n: int, chunk: int,
                        own_states: bool) -> int:
    """Bytes of K9b's fp32 workspace, as ``repro_ssd_scan_bwd_workspace``
    (``csrc/ssd_scan_bwd.cu``) sizes it: with ``own_states`` (the fp32
    route) the states, their gradients and the K9bg → K9bx handoff, then
    dCB per (batch, chunk, group of 8 heads) at the padded chunk and the
    dA shares; each piece rounded up to 64 floats."""
    def up(k):
        return (k + 63) // 64 * 64
    q = min(chunk, s)
    nc = -(-s // q)
    bhc = b * h * nc
    qp = 16 if q <= 16 else -(-q // 32) * 32
    groups = -(-h // min(h, 8))
    total = (2 * up(bhc * p * n) + up(bhc * q * p) + 2 * up(bhc * q)
             + up(bhc) if own_states else 0)
    total += up(b * nc * groups * qp * qp) + up(bhc)
    return total * 4


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        y, state = _launch(x, dt, A, B, C, chunk)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        # the caller usually drops the final state: its gradient is None
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C = ctx.saved_tensors
        if dy is None and dstate is None:
            return (None,) * 6
        if dy is None:
            dy = torch.zeros_like(x)
        return (*_launch_bwd(x, dt, A, B, C, dy, dstate, ctx.chunk), None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128):
    """x: (B, H, S, P); dt: (B, H, S) fp32; A: (H,) fp32; B/C: (B, S, N)
    → (y (B, H, S, P) in x's dtype, final state (B, H, P, N) fp32).

    CUDA tensors launch K9 on the current stream (x, dt may be strided
    views; P and N multiples of 8 up to 64 and 128, chunk up to 128,
    anything else raises) on the route :func:`route` gives, recorded in
    ``ssd_scan.last_route`` and counted in ``ssd_scan.route_launches``;
    their backward launches K9b.  CPU tensors take :func:`ssd_scan_plain`,
    which autograd differentiates.  ``ssd_scan.launches`` counts calls
    that launched K9 (one per call, though the tc route is two kernel
    launches), ``ssd_scan.bwd_launches`` backward calls that launched K9b
    (one per call, five to six kernels).
    """
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    return _SSDScan.apply(x, dt, A, B, C, chunk)


ssd_scan.launches = 0
ssd_scan.bwd_launches = 0
ssd_scan.last_route = None
ssd_scan.route_launches = {"tc": 0, "fp32": 0}
