"""Kernel modules on the CPU: the plain versions behind the K1 and K5
wrappers against the JAX package's Pallas kernels in interpret mode and
its jnp oracles, plus the paged decode against its JAX counterpart."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import flash as jflash
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.dist import flash as tflash
from repro_torch.kernels import ops as tops

TOL = 3e-5      # fp32, as tests/test_kernels.py holds the Pallas kernels


def _np(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("b,sq,sk,h,kh,hd,window,q_offset,bq,bk", [
    (2, 100, 100, 4, 4, 32, 0, 0, 32, 16),     # G=1, ragged
    (1, 75, 75, 6, 2, 16, 0, 0, 16, 32),       # G=3, ragged
    (2, 64, 64, 8, 2, 32, 20, 0, 16, 16),      # G=4, window
    (1, 90, 90, 6, 2, 16, 33, 0, 32, 16),      # G=3, window, ragged
    (1, 40, 104, 4, 1, 32, 0, 64, 16, 32),     # q stripe at offset 64
    (2, 48, 96, 6, 2, 16, 24, 48, 16, 16),     # offset + window
])
def test_flash_attention_plain_vs_pallas(b, sq, sk, h, kh, hd, window,
                                         q_offset, bq, bk):
    q, k, v = (_np(b, sq, h, hd, seed=1), _np(b, sk, kh, hd, seed=2),
               _np(b, sk, kh, hd, seed=3))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), float(q_offset), causal=True,
                                window=window, block_q=bq, block_k=bk,
                                interpret=True)
    got = tops.flash_attention(_t(q), _t(k), _t(v), q_offset, causal=True,
                               window=window)
    assert got.shape == (b, sq, h, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("cur,window,block_s", [
    (37, 0, 64), (256, 0, 64), (100, 48, 32), (1, 0, 128), (255, 16, 64),
])
def test_flash_decode_plain_vs_pallas(cur, window, block_s):
    b, kh, g, hd, s = 2, 2, 3, 32, 256
    q, kc, vc = (_np(b, 1, kh * g, hd, seed=cur), _np(b, kh, s, hd, seed=4),
                 _np(b, kh, s, hd, seed=5))
    args = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(cur))
    kernel = jops.flash_decode(*args, window=window, block_s=block_s,
                               interpret=True)
    oracle = jref.flash_decode_ref(*args, window=window)
    got = tops.flash_decode(_t(q), _t(kc), _t(vc),
                            torch.tensor([cur], dtype=torch.int32),
                            window=window)
    for want in (kernel, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("cur", [0, 5, 15, 16, 17])   # 16 = S: at the end
@pytest.mark.parametrize("window", [0, 6])
def test_decode_update_and_attend(cur, window):
    b, kh, g, hd, s = 2, 2, 2, 16, 16
    q, kn, vn = (_np(b, 1, kh * g, hd, seed=6), _np(b, 1, kh, hd, seed=7),
                 _np(b, 1, kh, hd, seed=8))
    kc, vc = _np(b, kh, s, hd, seed=9), _np(b, kh, s, hd, seed=10)
    want = jflash.decode_update_and_attend(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(cur, jnp.int32), window=window)
    got = tflash.decode_update_and_attend(
        _t(q), _t(kn), _t(vn), _t(kc.copy()), _t(vc.copy()), cur,
        window=window)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=TOL,
                                   rtol=TOL)


def test_decode_past_the_cache_raises():
    """A decode at or past the cache end no longer raises: as the
    reference's ``dynamic_update_slice``, the write clamps to the last
    slot and the slots before it keep their contents."""
    for cur in (4, 5):
        kc = torch.zeros(1, 1, 4, 16)
        x = torch.full((1, 1, 1, 16), float(cur))
        out, kc, vc = tflash.decode_update_and_attend(x, x, x, kc, kc.clone(),
                                                      cur)
        assert (kc[0, 0, :3] == 0).all() and (kc[0, 0, 3] == cur).all()
        assert torch.equal(kc, vc) and torch.isfinite(out).all()


@pytest.mark.parametrize("npages,window", [(10, 0), (10, 5), (3, 0)])
def test_paged_update_and_attend_vs_jax(npages, window):
    """Sentinel page ids, an inactive row and a pool smaller than the batch:
    the port must drop the same writes and clamp the same gathers as
    XLA does."""
    b, kh, g, hd, page, mp = 4, 2, 3, 16, 4, 3
    q, kn, vn = (_np(b, 1, kh * g, hd, seed=11), _np(b, 1, kh, hd, seed=12),
                 _np(b, 1, kh, hd, seed=13))
    kp, vp = (_np(npages, kh, page, hd, seed=14),
              _np(npages, kh, page, hd, seed=15))
    table = np.full((b, mp), npages, np.int32)
    cur = np.array([6, 0, 9, 3], np.int32)
    active = np.array([True, True, False, True])
    if npages >= 7:
        table[0, :2] = [4, 1]        # page 1 written at slot 2
        table[1, :1] = [7]
        table[2, :3] = [0, 2, 5]     # inactive: writes nothing
        table[3, :1] = [9]           # last page
    else:
        table[0, :2] = [0, 1]
        table[1, :1] = [2]
        table[3, :1] = [npages]      # sentinel where the token would land
    want = jflash.paged_update_and_attend(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(table), jnp.asarray(cur),
        jnp.asarray(active), window=window)
    got = tflash.paged_update_and_attend(
        _t(q), _t(kn), _t(vn), _t(kp.copy()), _t(vp.copy()), _t(table),
        _t(cur), _t(active), window=window)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=TOL,
                                   rtol=TOL)
