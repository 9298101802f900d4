"""Kernel modules on the CPU: the plain versions behind the K1 and K5
wrappers against the JAX package's Pallas kernels in interpret mode and
its jnp oracles, K5's split planning and lse-combine against its plain
version, plus the contiguous and paged decodes against their JAX
counterparts."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import flash as jflash
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.dist import flash as tflash
from repro_torch.kernels import autotune
from repro_torch.kernels import flash_decode as tfd
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


# (B, KH, S, window) of every K5 shape chip_smoke.py runs
SMOKE_DECODES = [(4, 5, 2624, 0), (4, 5, 2624, 512), (2, 2, 700, 0),
                 (1, 8, 6016, 4096), (2, 2, 5008, 4096), (2, 2, 320, 0),
                 (2, 2, 320, 16)]


@pytest.mark.parametrize("s,window", [
    (s, w) for s in (1, 63, 64, 129, 300, 2624, 6016, 8300, 16400, 65536)
    for w in (0, 16, 512, 4096)] + [(s, w) for _, _, s, w in SMOKE_DECODES])
def test_decode_splits_fill_the_card_without_empty_splits(s, window):
    """At the longest live span the shapes allow, every one of K5's splits
    gets rows (the kernel's own chunk rule, ``decode_chunk``), together
    they cover the span, the count is at least 1 and at most the cap, and
    it reaches the two-wave target wherever the span gives each split
    128 rows within the cap."""
    span = min(s, window) if window else s
    for bkh in range(1, 65):
        n = autotune.decode_splits(bkh, 1, s, window)
        assert n == autotune.decode_splits(1, bkh, s, window)
        assert 1 <= n <= autotune.MAX_DECODE_SPLITS
        chunk = autotune.decode_chunk(span, n)
        assert chunk % autotune.DECODE_TILE == 0
        assert (n - 1) * chunk < span <= n * chunk
        target = min(-(-2 * autotune.SM_COUNT // bkh),
                     span // autotune.DECODE_MIN_ROWS,
                     autotune.MAX_DECODE_SPLITS)
        assert n >= target or (-(-span // autotune.DECODE_MIN_ROWS)
                               > autotune.MAX_DECODE_SPLITS)


def test_decode_splits_at_the_smoke_shapes():
    """The timed shapes launch at least one block per SM: danube's 8
    (b, kh) take 32 splits of 128 rows, smollm's 20 take 14 of 192."""
    assert autotune.decode_splits(1, 8, 6016, 4096) == 32
    assert autotune.decode_chunk(4096, 32) == 128
    assert autotune.decode_splits(4, 5, 2624, 0) == 14
    assert autotune.decode_chunk(2600, 14) == 192
    for b, kh, s, w in SMOKE_DECODES:
        assert 1 <= autotune.decode_splits(b, kh, s, w) <= 32


def _split_partials(q, kc, vc, cur, window, splits):
    """Each split's (m, l, acc) as K5's split kernel computes them: its
    rows of the live span by ``decode_chunk``, fp32 online softmax; a
    split with no live row holds (-1e30, 0, 0)."""
    b, kh, g, hd = q.shape
    s = kc.shape[2]
    end, start = min(cur, s), (max(0, cur - window) if window else 0)
    span = max(0, end - start)
    chunk = autotune.decode_chunk(span, splits)
    sc = torch.einsum("bkgh,bksh->bkgs", q, kc) * (1.0 / np.sqrt(hd))
    ms, ls, accs = [], [], []
    for i in range(splits):
        lo, hi = start + i * chunk, min(end, start + (i + 1) * chunk)
        if lo >= hi:
            ms.append(torch.full((b, kh, g), -1e30))
            ls.append(torch.zeros(b, kh, g))
            accs.append(torch.zeros(b, kh, g, hd))
            continue
        m = sc[..., lo:hi].amax(-1)
        p = torch.exp(sc[..., lo:hi] - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgs,bksh->bkgh", p, vc[:, :, lo:hi]))
    return (torch.stack(ms, 2), torch.stack(ls, 2), torch.stack(accs, 2))


@pytest.mark.parametrize("splits", [1, 3, 32])
@pytest.mark.parametrize("cur,window", [(2050, 0), (2050, 700), (1, 0),
                                        (2101, 64)])
def test_combine_partials_plain_is_flash_decode_plain(splits, cur, window):
    """Split partials lse-combined in split order equal the one-pass fp32
    decode (K5's plain version) up to summation order, empty splits
    included (32 splits of a short span, cur 1); and an empty split
    inserted anywhere changes no bit of the combine."""
    b, kh, g, hd, s = 2, 2, 3, 32, 2100
    q = _t(_np(b, kh, g, hd, seed=21))
    kc, vc = _t(_np(b, kh, s, hd, seed=22)), _t(_np(b, kh, s, hd, seed=23))
    m, l, acc = _split_partials(q, kc, vc, cur, window, splits)
    got = tfd.combine_partials_plain(m, l, acc)
    want = tfd.flash_decode_plain(q, kc, vc,
                                  torch.tensor([cur], dtype=torch.int32),
                                  window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    for at in (0, m.shape[2] // 2, m.shape[2]):
        m2 = torch.cat([m[:, :, :at], torch.full((b, kh, 1, g), -1e30),
                        m[:, :, at:]], 2)
        l2 = torch.cat([l[:, :, :at], torch.zeros(b, kh, 1, g), l[:, :, at:]],
                       2)
        a2 = torch.cat([acc[:, :, :at], torch.zeros(b, kh, 1, g, hd),
                        acc[:, :, at:]], 2)
        assert torch.equal(tfd.combine_partials_plain(m2, l2, a2), got)


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


@pytest.mark.parametrize("cur", [0, 15, 150])
@pytest.mark.parametrize("window", [0, 64])
def test_decode_update_and_attend_bf16_is_the_references(cur, window):
    """In bf16 the CPU decode rounds its probabilities to bf16 before the
    PV product, as the reference's CPU decode (the jnp
    ``decode_attention``) does: the port's output equals the reference's
    bit for bit, and so do the updated caches."""
    b, kh, g, hd, s = 2, 2, 3, 64, 160
    bf = jnp.bfloat16
    q, kn, vn = (_np(b, 1, kh * g, hd, seed=16), _np(b, 1, kh, hd, seed=17),
                 _np(b, 1, kh, hd, seed=18))
    kc, vc = _np(b, kh, s, hd, seed=19), _np(b, kh, s, hd, seed=20)
    want = jflash.decode_update_and_attend(
        *(jnp.asarray(a, bf) for a in (q, kn, vn, kc, vc)),
        jnp.asarray(cur, jnp.int32), window=window)
    got = tflash.decode_update_and_attend(
        *(_t(a).to(torch.bfloat16) for a in (q, kn, vn, kc, vc)), cur,
        window=window)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.bfloat16
        np.testing.assert_array_equal(g_.float().numpy(),
                                      np.asarray(w_.astype(jnp.float32)))


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
