"""The Mamba2 block (``repro_torch.models.mamba``) against
``repro.models.mamba`` on the same numpy inputs and weights (fp32, CPU).

Tolerance: 1e-4 relative with the absolute part scaled by the largest
|value| — the two sides differ only in summation order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import mamba as jm
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import mamba as tm

RTOL = 1e-4


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-6))


def _cfgs(**over):
    return (dataclasses.replace(jget("mamba2-1.3b").reduced(), **over),
            dataclasses.replace(tget("mamba2-1.3b").reduced(), **over))


def _params(jcfg, seed=0):
    jp = jm.mamba_init(jax.random.PRNGKey(seed), jcfg)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


def _x(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(np.shape(v))
            for k, v in tree.items()}


def test_init_has_the_reference_names_and_shapes():
    jcfg, tcfg = _cfgs()
    jp = jm.mamba_init(jax.random.PRNGKey(0), jcfg)
    tp = tm.mamba_init(torch.Generator().manual_seed(0), tcfg)
    assert _shapes(tp) == _shapes(jp)
    for name in ("A_log", "D", "dt_bias"):
        assert tp[name].dtype == torch.float32
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))


def test_softplus_has_no_threshold():
    """jax.nn.softplus is log(1 + e^x) everywhere; F.softplus turns
    linear above 20, which differs in fp32 between 20 and ~40."""
    v = np.array([-30.0, -1.0, 0.0, 3.0, 19.0, 20.5, 25.0, 60.0], np.float32)
    np.testing.assert_array_equal(tm._softplus(torch.from_numpy(v)).numpy(),
                                  np.asarray(jax.nn.softplus(v)))


@pytest.mark.parametrize("s,k", [(9, 4), (3, 4), (16, 2)])
def test_causal_conv(s, k):
    x = _x((2, s, 12), 1)
    w, b = _x((k, 12), 2), _x((12,), 3)
    got = tm._causal_conv(*map(torch.from_numpy, (x, w, b)))
    _close(got, jm._causal_conv(*map(jnp.asarray, (x, w, b))))


@pytest.mark.parametrize("s,chunk,init", [(64, 16, False), (50, 16, False),
                                          (48, 16, True), (7, 16, False)])
def test_ssd_chunked_and_reference(s, chunk, init):
    """The port's scan (``ops.ssd_scan`` in the model layout; on the CPU
    K9's plain version) against the reference's jnp ``ssd_chunked`` and
    its sequential oracle ``ssd_reference``.  With ``init`` the reference
    starts from the port's state after the first half of the sequence:
    its second half and final state must be the port's."""
    b, h, p, n = 2, 3, 8, 4
    x = _x((b, s, h, p), 4)
    dt = np.log1p(np.exp(_x((b, s, h), 5))).astype(np.float32)
    A = -np.exp(_x((h,), 6, 0.5))
    B, C = _x((b, s, n), 7), _x((b, s, n), 8)
    y, st = kernel_ops.ssd_scan(*map(torch.from_numpy, (x, dt, A, B, C)),
                                chunk=chunk)
    lo, st0 = 0, None
    if init:
        lo = s // 2
        _, half = kernel_ops.ssd_scan(
            *(torch.from_numpy(a[:, :lo]) for a in (x, dt)),
            torch.from_numpy(A),
            *(torch.from_numpy(a[:, :lo]) for a in (B, C)), chunk=chunk)
        st0 = jnp.asarray(half.numpy())
    jx, jdt, jB, jC = (jnp.asarray(a[:, lo:]) for a in (x, dt, B, C))
    yj, sj = jm.ssd_chunked(jx, jdt, jnp.asarray(A), jB, jC, chunk, st0)
    _close(y[:, lo:], yj)
    _close(st, sj)
    yr, sr = jm.ssd_reference(jx, jdt, jnp.asarray(A), jB, jC, st0)
    _close(y[:, lo:], yr)      # the chunked scan equals the recurrence
    _close(st, sr)


@pytest.mark.parametrize("s", [40, 37, 16])
def test_mamba_prefill_output_and_cache(s):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x((2, s, jcfg.d_model), 10)
    jout, jcache = jm.mamba_prefill(jp, jnp.asarray(x), jcfg)
    tout, tcache = tm.mamba_prefill(tp, torch.from_numpy(x), tcfg)
    _close(tout, jout)
    assert set(tcache) == set(jcache)
    for name in jcache:
        assert tuple(tcache[name].shape) == jcache[name].shape
        _close(tcache[name], jcache[name])


def test_prefill_cache_holds_only_the_tails():
    """The conv tails are copies: a view of the (B, S, C) projection
    would keep all of it alive for as long as the cache lives."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    _, cache = tm.mamba_prefill(tp, torch.from_numpy(_x((2, 40, jcfg.d_model),
                                                        10)), tcfg)
    for name in ("conv_x", "conv_B", "conv_C"):
        t = cache[name]
        assert t.shape[1] == jcfg.conv_kernel - 1
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


def test_conv_step():
    tail, new = _x((2, 3, 12), 11), _x((2, 1, 12), 12)
    w, b = _x((4, 12), 13), _x((12,), 14)
    jo, jt = jm._conv_step(*map(jnp.asarray, (tail, new, w, b)))
    to, tt = tm._conv_step(*map(torch.from_numpy, (tail, new, w, b)))
    _close(to, jo)
    _close(tt, jt)


def test_mamba_decode_updates_the_cache_in_place():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x((2, 20, jcfg.d_model), 15)
    _, jcache = jm.mamba_prefill(jp, jnp.asarray(x), jcfg)
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    buffers = dict(tcache)
    for i in range(3):
        tok = _x((2, 1, jcfg.d_model), 16 + i)
        jout, jcache = jm.mamba_decode(jp, jnp.asarray(tok), jcfg, jcache)
        tout, tcache = tm.mamba_decode(tp, torch.from_numpy(tok), tcfg, tcache)
        _close(tout, jout)
        for name in jcache:
            assert tcache[name] is buffers[name]       # same storage
            _close(tcache[name], jcache[name])


@pytest.mark.parametrize("s", [32, 37])
def test_mamba_train_forward(s):
    """The CPU training path (``ops.ssd_scan``, whose CPU version is
    ``ssd_scan_plain``) against the reference's (``use_kernel=False``:
    its jnp chunked scan)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=1)
    x = _x((2, s, jcfg.d_model), 20)
    want = jm.mamba_train(jp, jnp.asarray(x), jcfg, use_kernel=False)
    _close(tm.mamba_train(tp, torch.from_numpy(x), tcfg), want)
