"""The port's differentiable flash attention against the reference's
custom VJP: forward, logsumexp and ``torch.autograd.grad`` against
``jax.vjp`` of ``repro.kernels.ops.flash_attention`` (Pallas kernels in
interpret mode), at the shapes of ``tests/test_flash_vjp.py``: ragged
lengths against the reference's tiles, sliding windows, GQA / MQA / MHA
groupings and ``q_offset`` stripes, head dim 16.  On the CPU the port
runs the plain versions of K1 (with lse) and of its backward kernels.

Tolerance: fp32 on both sides, the same arithmetic in another summation
order (tiles of 16–48 against 1024-row blocks), so 2e-5 absolute and
relative on O(1) values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

TOL = 2e-5


def _inputs(seed, b, sq, sk, h, kh, hd):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, sk, kh, hd), (b, sk, kh, hd),
                      (b, sq, h, hd))]


def _jax_lse(q, k, v, q_offset, window):
    """The reference kernel's lse output (``_fwd_call(with_lse=True)``),
    with the public wrapper's planning and padding; (B, H, Sq)."""
    qt, kt, vt = (jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))
                  for x in (q, k, v))
    b, h, sq, hd = qt.shape
    kh, sk = kt.shape[1], kt.shape[2]
    plan = autotune.plan_attention(sq, sk, hd, hd, h // kh, kh, b, 32, True,
                                   window, sk, backend="interpret")
    sq_p = -(-sq // plan.block_q) * plan.block_q
    sk_p = -(-sk // plan.block_k) * plan.block_k
    qt = jnp.pad(qt, ((0, 0), (0, 0), (0, sq_p - sq), (0, 0)))
    kt = jnp.pad(kt, ((0, 0), (0, 0), (0, sk_p - sk), (0, 0)))
    vt = jnp.pad(vt, ((0, 0), (0, 0), (0, sk_p - sk), (0, 0)))
    offs = jnp.asarray([q_offset], jnp.int32)
    _, lse = jfa._fwd_call(qt.reshape(b, kh, h // kh, sq_p, hd), kt, vt,
                           offs, causal=True, window=window, plan=plan,
                           kv_len=sk, interpret=True, with_lse=True)
    return np.asarray(lse).reshape(b, h, sq_p)[:, :, :sq]


def _check(seed, b, sq, sk, h, kh, hd, window, q_offset, block_q=None,
           block_k=None):
    q, k, v, do = _inputs(seed, b, sq, sk, h, kh, hd)

    def jf(q_, k_, v_):
        return jops.flash_attention(q_, k_, v_, jnp.float32(q_offset),
                                    causal=True, window=window,
                                    block_q=block_q, block_k=block_k)

    jout, vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tout = tops.flash_attention(tq, tk, tv, q_offset, causal=True,
                                window=window)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=TOL, rtol=TOL)
    for name, got, want in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL, err_msg=f"d{name}")

    heads = [torch.from_numpy(x).transpose(1, 2).contiguous()
             for x in (q, k, v)]
    _out, lse = tfa.flash_attention_fwd(*heads, q_offset, causal=True,
                                        window=window)
    np.testing.assert_allclose(lse.numpy(),
                               _jax_lse(q, k, v, q_offset, window),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("seed,sq,g,kh,window,block_q,block_k", [
    (0, 100, 2, 2, 0, 32, 32),      # ragged vs both block sizes, GQA
    (1, 65, 1, 2, 0, 16, 48),       # sq % block_k != 0, MHA
    (2, 96, 3, 1, 24, 32, 32),      # sliding window, MQA group 3
    (3, 50, 2, 2, 13, 16, 32),      # window + ragged
])
def test_vjp_matches_reference(seed, sq, g, kh, window, block_q, block_k):
    _check(seed, 1, sq, sq, g * kh, kh, 16, window, 0, block_q, block_k)


@pytest.mark.parametrize("seed,sq,off,window", [
    (0, 32, 64, 0), (1, 24, 40, 9), (2, 17, 32, 0),
])
def test_vjp_q_offset_stripe(seed, sq, off, window):
    """A q stripe at global offset ``off`` against a longer context: the
    masks of both directions sit at global positions."""
    _check(seed, 2, sq, sq + off, 4, 2, 16, window, off, 16, 16)


def test_backward_wrappers_on_cpu_give_the_plain_backward():
    """K2's and K3's wrappers take the plain backward for CPU tensors,
    fed delta = rowsum(do · out); every route gives the same gradients."""
    q, k, v, do = (torch.from_numpy(x).transpose(1, 2).contiguous()
                   for x in _inputs(5, 2, 40, 40, 6, 2, 16))
    out, lse = tfa.flash_attention_fwd(q, k, v, 0, window=7)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, 0, True, 7)
    delta = (do * out).sum(-1)
    kw = dict(causal=True, window=7)
    counters = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_fused,
                tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv)
    before = [f.launches for f in counters]
    fused = tfa.flash_attention_bwd_fused(q, k, v, do, lse, delta, 0, **kw)
    split = (tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, 0, **kw),
             *tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, 0, **kw))
    for a, b, c in zip(want, fused, split):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert [f.launches for f in counters] == before   # no kernel ran
    with torch.no_grad():              # serving: the forward alone
        assert torch.equal(tfa.flash_attention(q, k, v, window=7), out)
