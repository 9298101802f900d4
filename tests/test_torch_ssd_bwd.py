"""The scan's backward in plain PyTorch (K9b's reference on the card)
against the JAX package: ``ssd_scan_bwd_plain`` and its two stages,
``ssd_chunk_dstates_plain`` and ``ssd_chunk_grads_plain``, against
``jax.vjp`` of ``repro.models.mamba.ssd_chunked`` and against autograd of
the port's ``ssd_scan_plain``, on the same numpy inputs.

Tolerance: 1e-4 of each gradient's largest |value| (fp32, the same
function in another summation order; dA sums products that cancel and
sees ~1e-5 of it here).

The reference's gradient of ``ssd_chunked`` turns NaN in ddt and dA once
a masked decay e^(cum_q - cum_t), t > q, overflows fp32 (autodiff's
inf · 0 through ``jnp.where``), so the inputs held against ``jax.vjp``
keep every chunk's Σ|dt·A| well below 88 (checked); inputs past that are
held against autograd of ``ssd_scan_plain``, which selects before the
exp and stays finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba import ssd_chunked as jssd_chunked
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as tssd

RTOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _inputs(b, s, h, p, n, seed, dt_shift=-1.0):
    """Model layout: x (b,s,h,p), dt = softplus(randn + dt_shift),
    A = -exp(0.3 randn), B/C (b,s,n); dy (b,s,h,p); dstate (b,h,p,n)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h) + dt_shift)).astype(np.float32)
    A = (-np.exp(rng.randn(h) * 0.3)).astype(np.float32)
    B = rng.randn(b, s, n).astype(np.float32)
    C = rng.randn(b, s, n).astype(np.float32)
    dy = rng.randn(b, s, h, p).astype(np.float32)
    ds = rng.randn(b, h, p, n).astype(np.float32)
    return x, dt, A, B, C, dy, ds


def _kernel(x, dt, A, B, C, dy, ds=None):
    """The kernel layout as torch tensors: x, dy (b,h,s,p), dt (b,h,s)."""
    t = torch.from_numpy
    return (t(np.ascontiguousarray(x.transpose(0, 2, 1, 3))),
            t(np.ascontiguousarray(dt.transpose(0, 2, 1))), t(A), t(B), t(C),
            t(np.ascontiguousarray(dy.transpose(0, 2, 1, 3))),
            None if ds is None else t(ds))


def _close(got, want, name=""):
    want = np.asarray(want, dtype=np.float32)
    got = np.asarray(got, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=name)


def _jax_vjp(x, dt, A, B, C, dy, ds, chunk, init=None):
    """The reference's gradients (model layout) of Σ dy·y + Σ ds·state,
    and of the initial state when ``init`` is given."""
    s = x.shape[1]
    q = min(chunk, s)
    args = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    if init is None:
        f = lambda *a: jssd_chunked(*a, q)  # noqa: E731
    else:
        args.append(jnp.asarray(init))
        f = lambda *a: jssd_chunked(*a[:5], q, a[5])  # noqa: E731
    (_, st), vjp = jax.vjp(f, *args)
    cot = jnp.zeros_like(st) if ds is None else jnp.asarray(ds)
    grads = [np.asarray(g) for g in vjp((jnp.asarray(dy), cot))]
    assert all(np.isfinite(g).all() for g in grads), "reference overflowed"
    return grads


def _to_kernel_layout(grads):
    dx, ddt, dA, dB, dC = grads[:5]
    return (dx.transpose(0, 2, 1, 3), ddt.transpose(0, 2, 1), dA, dB, dC)


CASES = [  # b, s, h, p, n, chunk, dstate
    (2, 64, 3, 8, 4, 16, False),
    (2, 65, 8, 32, 16, 16, False),     # the reduced configs' shape, ragged
    (1, 37, 2, 16, 8, 16, True),       # ragged, dstate
    (2, 100, 4, 32, 16, 32, True),     # 32 does not divide 100
    (1, 10, 2, 8, 8, 128, False),      # S < chunk: one chunk of 10
    (2, 48, 2, 8, 8, 16, True),        # whole chunks, dstate
]


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_ds", CASES)
def test_plain_backward_matches_jax_vjp(b, s, h, p, n, chunk, with_ds):
    x, dt, A, B, C, dy, ds = _inputs(b, s, h, p, n, s + h)
    ds = ds if with_ds else None
    want = _to_kernel_layout(_jax_vjp(x, dt, A, B, C, dy, ds, chunk))
    got = tssd.ssd_scan_bwd_plain(*_kernel(x, dt, A, B, C, dy, ds),
                                  chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        _close(g, w, name)


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_ds", CASES)
def test_stages_compose_to_autograd_of_the_plain_scan(b, s, h, p, n, chunk,
                                                      with_ds):
    """The entering states, their gradients and the per-chunk gradients,
    staged as K9b runs them, against autograd of ``ssd_scan_plain``."""
    x, dt, A, B, C, dy, ds = _kernel(*_inputs(b, s, h, p, n, 3 * s + h))
    ds = ds if with_ds else None
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    y, st = tssd.ssd_scan_plain(*leaves, chunk=chunk)
    loss = (y * dy).sum() + (0 if ds is None else (st * ds).sum())
    want = torch.autograd.grad(loss, leaves)
    states, final = tssd.ssd_chunk_states_plain(x, dt, A, B, chunk=chunk)
    dstates, _ = tssd.ssd_chunk_dstates_plain(dt, A, C, dy, ds, chunk=chunk)
    nc = -(-s // min(chunk, s))
    assert states.shape == dstates.shape == (b, h, nc, p, n)
    torch.testing.assert_close(dstates[:, :, -1], torch.zeros_like(final)
                               if ds is None else ds)
    got = tssd.ssd_chunk_grads_plain(x, dt, A, B, C, dy, states, dstates,
                                     chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name)


@pytest.mark.parametrize("s,chunk,c", [(64, 16, 1), (64, 16, 3), (37, 16, 1),
                                       (100, 32, 2)])
def test_dstates_are_the_gradient_of_the_state_entering_a_chunk(s, chunk, c):
    """G_c, the gradient of the state leaving chunk c - 1, is jax.vjp's
    gradient of the initial state of ``ssd_chunked`` run from chunk c on
    with the state entering chunk c; G_0 that of the whole sequence."""
    b, h, p, n = 2, 3, 16, 8
    x, dt, A, B, C, dy, ds = _inputs(b, s, h, p, n, s + c)
    kx, kdt, kA, kB, kC, kdy, kds = _kernel(x, dt, A, B, C, dy, ds)
    states, _ = tssd.ssd_chunk_states_plain(kx, kdt, kA, kB, chunk=chunk)
    dstates, g0 = tssd.ssd_chunk_dstates_plain(kdt, kA, kC, kdy, kds,
                                               chunk=chunk)
    t0 = c * chunk
    tail = [a[:, t0:] for a in (x, dt, B, C, dy)]
    want = _jax_vjp(tail[0], tail[1], A, tail[2], tail[3], tail[4], ds,
                    chunk, init=states[:, :, c].numpy())[5]
    _close(dstates[:, :, c - 1], want)
    want0 = _jax_vjp(x, dt, A, B, C, dy, ds, chunk,
                     init=np.zeros((b, h, p, n), np.float32))[5]
    _close(g0, want0)


def test_padded_rows_give_zero_gradients():
    """A ragged S padded by hand with dt = 0 steps (x, B and C anything,
    dy zero there) to whole chunks: the padded rows' dx, dB, dC and ddt
    are zero, the real rows' gradients and dA are the ragged call's."""
    b, s, h, p, n, chunk, pad = 2, 37, 3, 16, 8, 16, 11
    x, dt, A, B, C, dy, _ = _inputs(b, s + pad, h, p, n, 5)
    dt[:, s:] = 0.0
    dy[:, s:] = 0.0
    full = tssd.ssd_scan_bwd_plain(*_kernel(x, dt, A, B, C, dy), chunk=chunk)
    ragged = tssd.ssd_scan_bwd_plain(*_kernel(
        x[:, :s], dt[:, :s], A, B[:, :s], C[:, :s], dy[:, :s]), chunk=chunk)
    dx, ddt, dA, dB, dC = full
    for g in (dx[:, :, s:], ddt[:, :, s:], dB[:, s:], dC[:, s:]):
        assert g.abs().max().item() == 0.0
    for name, g, r in zip(NAMES, (dx[:, :, :s], ddt[:, :, :s], dA,
                                  dB[:, :s], dC[:, :s]), ragged):
        _close(g, r, name)


@pytest.mark.parametrize("s,chunk", [(128, 128), (300, 128), (100, 32)])
def test_plain_backward_stays_finite_where_the_masked_decay_overflows(
        s, chunk):
    """dt·A ≈ -2 a step: masked decays of e^250 and more.  The plain
    backward selects them away and equals autograd of ``ssd_scan_plain``
    (which selects before the exp); both stay finite."""
    x, dt, A, B, C, dy, ds = _kernel(*_inputs(1, s, 2, 8, 8, 17,
                                              dt_shift=2.0))
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    y, st = tssd.ssd_scan_plain(*leaves, chunk=chunk)
    want = torch.autograd.grad((y * dy).sum() + (st * ds).sum(), leaves)
    got = tssd.ssd_scan_bwd_plain(x, dt, A, B, C, dy, ds, chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert torch.isfinite(g).all() and torch.isfinite(w).all(), name
        _close(g, w, name)


def test_bf16_outputs_take_the_inputs_dtypes():
    x, dt, A, B, C, dy, _ = _kernel(*_inputs(1, 40, 2, 16, 8, 23))
    bf = torch.bfloat16
    got = tssd.ssd_scan_bwd_plain(x.to(bf), dt, A, B.to(bf), C.to(bf),
                                  dy.to(bf), chunk=16)
    assert [g.dtype for g in got] == [bf, torch.float32, torch.float32,
                                      bf, bf]
    want = tssd.ssd_scan_bwd_plain(x.to(bf).float(), dt, A,
                                   B.to(bf).float(), C.to(bf).float(),
                                   dy.to(bf).float(), chunk=16)
    for name, g, w in zip(NAMES, got, want):
        d = (g.float() - w).abs()
        assert (d <= 2.0 ** -8 * w.abs() + 1e-6).all(), name


def test_cpu_tensors_take_autograd_of_the_plain_scan():
    """On the CPU the wrapper launches nothing: autograd differentiates
    ``ssd_scan_plain`` through the model-layout ``ops.ssd_scan``, and its
    gradients are the plain backward's."""
    x, dt, A, B, C, dy, _ = _inputs(2, 50, 3, 16, 8, 29)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, B, C)]
    before = tssd.ssd_scan.bwd_launches
    y, _ = tops.ssd_scan(*leaves, chunk=16)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), leaves)
    assert tssd.ssd_scan.bwd_launches == before
    want = tssd.ssd_scan_bwd_plain(*_kernel(x, dt, A, B, C, dy), chunk=16)
    got = (grads[0].transpose(1, 2), grads[1].transpose(1, 2), *grads[2:])
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name)
