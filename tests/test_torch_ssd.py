"""K9's plain version and CPU wrapper against the JAX package: the Pallas
``ssd_scan`` in interpret mode, the sequential oracle and
``ssd_chunked`` at a ragged length, on the same numpy inputs.

fp32 tolerance: 1e-4 relative, with the absolute part scaled by the
largest |value| (summation order only; the state sums up to S terms).
bf16: the two sides round fp32 results of different summation orders
to bf16 once, so they may differ by one bf16 ulp (2^-7 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.mamba import ssd_chunked as jssd_chunked
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as tssd

RTOL = 1e-4


def _inputs(b, s, h, p, n, seed):
    """Model layout: x (b,s,h,p), dt (b,s,h) > 0, A (h,) < 0, B/C (b,s,n)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h))).astype(np.float32)
    A = (-np.exp(rng.randn(h) * 0.5)).astype(np.float32)
    B = rng.randn(b, s, n).astype(np.float32)
    C = rng.randn(b, s, n).astype(np.float32)
    return x, dt, A, B, C


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, dtype=np.float32)
    got = np.asarray(got, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _kernel_layout(x, dt):
    return (torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))),
            torch.from_numpy(np.ascontiguousarray(dt.transpose(0, 2, 1))))


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 4, 32, 16, 32),
    (1, 96, 2, 64, 32, 32),
    (2, 64, 8, 8, 64, 64),          # chunk == seq (single chunk)
])
def test_plain_and_wrapper_match_pallas_interpret(b, s, h, p, n, chunk):
    x, dt, A, B, C = _inputs(b, s, h, p, n, b + s + h)
    yj, stj = jops.ssd_scan(*map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk,
                            interpret=True)
    yj_k = np.asarray(yj).transpose(0, 2, 1, 3)          # kernel layout
    xt, dtt = _kernel_layout(x, dt)
    At, Bt, Ct = map(torch.from_numpy, (A, B, C))
    before = tssd.ssd_scan.launches
    for fn in (tssd.ssd_scan_plain, tssd.ssd_scan):
        y, st = fn(xt, dtt, At, Bt, Ct, chunk=chunk)
        assert y.shape == (b, h, s, p) and st.shape == (b, h, p, n)
        assert y.dtype == torch.float32 and st.dtype == torch.float32
        _close(y, yj_k)
        _close(st, stj)
    assert tssd.ssd_scan.launches == before      # CPU tensors launch nothing


def test_ops_matches_sequential_oracle():
    x, dt, A, B, C = _inputs(2, 64, 2, 8, 4, 11)
    yj, stj = jref.ssd_scan_sequential(*map(jnp.asarray, (x, dt, A, B, C)))
    y, st = tops.ssd_scan(*map(torch.from_numpy, (x, dt, A, B, C)), chunk=16)
    assert y.shape == x.shape
    _close(y, yj)
    _close(st, stj)


@pytest.mark.parametrize("s,chunk", [(100, 32), (37, 16), (10, 128)])
def test_ragged_length_matches_ssd_chunked(s, chunk):
    """S not a multiple of the chunk (and S < chunk): the port pads with
    dt = 0 steps, as ``ssd_chunked`` does, with chunk = min(chunk, S)."""
    x, dt, A, B, C = _inputs(2, s, 3, 16, 8, s)
    yj, stj = jssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)),
                           min(chunk, s))
    y, st = tops.ssd_scan(*map(torch.from_numpy, (x, dt, A, B, C)),
                          chunk=chunk)
    _close(y, yj)
    _close(st, stj)


def test_bf16_inputs_round_once():
    x, dt, A, B, C = _inputs(1, 64, 2, 16, 8, 5)
    xb, Bb, Cb = (jnp.asarray(a, jnp.bfloat16) for a in (x, B, C))
    yj, stj = jops.ssd_scan(xb, jnp.asarray(dt), jnp.asarray(A), Bb, Cb,
                            chunk=16, interpret=True)
    as_t = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
            for a in (xb, Bb, Cb)]
    y, st = tops.ssd_scan(as_t[0], torch.from_numpy(dt), torch.from_numpy(A),
                          as_t[1], as_t[2], chunk=16)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    want = np.asarray(yj.astype(jnp.float32))
    d = np.abs(y.float().numpy() - want)
    assert (d <= 2.0 ** -7 * np.abs(want) + 1e-3 * np.abs(want).max()).all()
    _close(st, stj)


def test_plain_version_stays_finite_where_the_masked_decay_overflows():
    """One chunk of 128 steps with dt·A ≈ -1 each: exp(cum_q − cum_t)
    above the diagonal is ~e^127, inf in fp32; the select keeps it out."""
    b, s, h, p, n = 1, 128, 2, 8, 8
    x, _, _, B, C = _inputs(b, s, h, p, n, 3)
    dt = np.full((b, s, h), 1.0, np.float32)
    A = np.full((h,), -1.0, np.float32)
    y, st = tops.ssd_scan(*map(torch.from_numpy, (x, dt, A, B, C)), chunk=128)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    yj, stj = jssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), 128)
    _close(y, yj)
    _close(st, stj)


def test_cpu_autograd_differentiates_the_plain_version():
    """On the CPU the wrapper is the plain version, so its gradients are
    autograd's; they equal jax.grad of the reference's ssd_chunked."""
    x, dt, A, B, C = _inputs(1, 40, 2, 8, 8, 7)
    wy = np.random.RandomState(8).randn(*x.shape).astype(np.float32)
    ws = np.random.RandomState(9).randn(1, 2, 8, 8).astype(np.float32)

    def jloss(*args):
        y, st = jssd_chunked(*args, 16)
        return jnp.sum(y * wy) + jnp.sum(st * ws)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, dt, A, B, C)))
    targs = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, B, C)]
    y, st = tops.ssd_scan(*targs, chunk=16)
    ((y * torch.from_numpy(wy)).sum()
     + (st * torch.from_numpy(ws)).sum()).backward()
    for t, g in zip(targs, jg):
        _close(t.grad, g)


def test_ops_model_layout_is_the_kernel_layout_transposed():
    x, dt, A, B, C = _inputs(2, 48, 3, 16, 8, 12)
    y, st = tops.ssd_scan(*map(torch.from_numpy, (x, dt, A, B, C)), chunk=16)
    xt, dtt = _kernel_layout(x, dt)
    yk, stk = tssd.ssd_scan_plain(xt, dtt, *map(torch.from_numpy, (A, B, C)),
                                  chunk=16)
    assert torch.equal(y, yk.transpose(1, 2)) and torch.equal(st, stk)


def test_cuda_wrapper_raises_without_a_card_on_non_cpu_tensors(
        monkeypatch):
    """A tensor that is not on the CPU never takes the plain version: on
    the meta device the wrapper takes its meta route (the dry run's:
    outputs of the kernel's shapes, no launch), and operands split
    between the meta device and the CPU raise instead of falling back."""
    def no_plain(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(tssd, "ssd_scan_plain", no_plain)
    x = torch.empty((1, 2, 16, 8), device="meta")
    dt = torch.empty((1, 2, 16), device="meta")
    bc = torch.empty((1, 16, 8), device="meta")
    y, st = tssd.ssd_scan(x, dt, torch.empty(2, device="meta"), bc, bc,
                          chunk=16)
    assert y.device.type == "meta" and y.shape == x.shape
    assert st.shape == (1, 2, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan(x, dt, torch.empty(2), bc, bc, chunk=16)
