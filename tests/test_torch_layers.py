"""Layers and dense attention: the port against the JAX reference on the
same numpy inputs, fp32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

ATOL = 1e-5      # fp32, same math; only the summation order differs


def _np(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=atol, rtol=atol)


def test_rmsnorm():
    x, s = _np(2, 5, 32, seed=1), _np(32, seed=2)
    want = jlayers.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x), 1e-5)
    got = tlayers.rmsnorm({"scale": torch.from_numpy(s)}, torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope(theta):
    x = _np(2, 7, 3, 16, seed=3)
    pos = np.arange(7)[None, :] + np.array([[0], [40]])
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, want)


def test_mlp():
    p = {"w_gate": _np(32, 48, seed=4, scale=0.2),
         "w_up": _np(32, 48, seed=5, scale=0.2),
         "w_down": _np(48, 32, seed=6, scale=0.2)}
    x = _np(2, 5, 32, seed=7)
    want = jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x))
    got = tlayers.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x))
    _close(got, want)


def test_cast_params_casts_fp32_leaves_only():
    p = {"a": {"w": torch.ones(2)}, "router": torch.ones(2),
         "b": torch.ones(2, dtype=torch.bfloat16)}
    out = tlayers.cast_params(p, "bfloat16")
    assert out["a"]["w"].dtype == torch.bfloat16
    assert out["router"].dtype == torch.float32
    assert out["b"].dtype == torch.bfloat16


@pytest.mark.parametrize("bias", [False, True])
def test_gqa_qkv(bias):
    class Cfg:
        pass
    p = {"w_q": _np(32, 4, 8, seed=8), "w_k": _np(32, 2, 8, seed=9),
         "w_v": _np(32, 2, 8, seed=10)}
    if bias:
        p.update(b_q=_np(4, 8, seed=11), b_k=_np(2, 8, seed=12),
                 b_v=_np(2, 8, seed=13))
    x = _np(2, 5, 32, seed=14)
    want = jattn.gqa_qkv({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), Cfg)
    got = tattn.gqa_qkv({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), Cfg)
    for g, w in zip(got, want):
        _close(g, w, atol=3e-5)


@pytest.mark.parametrize("sq,sk,h,kh,window,q_offset", [
    (9, 9, 4, 2, 0, 0), (9, 9, 6, 2, 4, 0), (5, 12, 4, 1, 0, 7),
    (6, 6, 3, 3, 2, 0),
])
def test_full_attention(sq, sk, h, kh, window, q_offset):
    q, k, v = _np(2, sq, h, 16, seed=15), _np(2, sk, kh, 16, seed=16), \
        _np(2, sk, kh, 16, seed=17)
    want = jattn.full_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                q_offset=q_offset)
    got = tattn.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True,
                               window=window, q_offset=q_offset)
    _close(got, want)


@pytest.mark.parametrize("cur,window", [(5, 0), (11, 0), (11, 4)])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention(cur, window, per_row):
    q, k, v = _np(2, 1, 6, 16, seed=18), _np(2, 12, 2, 16, seed=19), \
        _np(2, 12, 2, 16, seed=20)
    cur_a = np.array([cur, cur - 3], np.int32) if per_row else np.int32(cur)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), cur_len=jnp.asarray(cur_a),
                                  window=window)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 cur_len=torch.from_numpy(np.asarray(cur_a)),
                                 window=window)
    _close(got, want)


@pytest.mark.parametrize("block_q,min_seq", [(None, 2048), (None, 8),
                                             (64, 8), (None, 4096)])
def test_flash_min_seq_rule(block_q, min_seq):
    import dataclasses

    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    jcfg = dataclasses.replace(jget("smollm-360m").reduced(),
                               attn_block_q=block_q, attn_flash_min_seq=min_seq)
    tcfg = dataclasses.replace(tget("smollm-360m").reduced(),
                               attn_block_q=block_q, attn_flash_min_seq=min_seq)
    assert tattn.flash_min_seq(tcfg) == jattn.flash_min_seq(jcfg)


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
