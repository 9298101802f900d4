"""The absorbed MLA route at DeepSeek-V2's full attention widths on the
CPU, against the JAX package on the same numpy inputs and weights.

On that route ``_mla_absorbed_flash`` sends one latent kv head of width
rkv + dr = 512 + 64 = 576, with v = c_kv of width 512, shared by every
query head, through the flash kernels: on the card their widest compiled
pair, (576, 512) (``csrc/flash_attention_wide.cu``), whose plain versions
the CPU runs.

(a) ``flash_attention_plain`` (with its lse) and the autograd
    ``flash_attention`` at (576, 512), H 128, KH 1 (G 128), B 2, against
    the reference's ``ops.flash_attention`` in interpret mode (``jax.vjp``
    for the gradients): S 48 in fp32 and bf16, a ragged S 40 (against
    the reference's 16 / 32 tiles) and a q stripe of 24 rows at q_offset
    32 over 56 keys; and the card's dk/dv head slices at that pair
    (``autotune.wide_dkv_splits``), a pure function of the shapes.
(b) ``mla_train`` (the output, and the loss sum(sin(out)) with the
    gradients of every parameter and of x) and ``mla_prefill`` (output
    and latent caches) with kv_lora_rank 512, qk_rope_head_dim 64,
    qk_nope_head_dim 128, v_head_dim 128 and 128 heads, S 48 above
    ``attn_flash_min_seq`` 16, against the reference's functions.  Cut
    for CPU time from deepseek-v2-236b: d_model 5120 → 128 and
    q_lora_rank 1536 → 64 (``reduced()``'s), which leave the attention
    widths as they are.

Tolerances, as ``tests/test_torch_mla.py``: fp32 1e-4 for outputs and
the kernels' gradients (summation order), 1e-3 for the route's
parameter gradients (W_UK and W_UV reassociated), 1e-5 for the latent
caches (the same arithmetic); bf16 2e-2 (a few bf16 ulps of O(1)
values), the gradients' bf16 2e-2 of each one's largest entry.

On the card: ``tests/test_torch_cuda.py`` (K1, K1-lse, K2 and K3 at
(576, 512) against their plain versions, and this route on the card
against the CPU) and ``chip_smoke.py``'s ``phase_mla_absorbed``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import ops as jops
from repro.models import attention as JA
from repro_torch.configs import get_config as tget
from repro_torch.kernels import autotune
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as TA

ARCH = "deepseek-v2-236b"
H, HD, HD_V = 128, 576, 512
# the attention widths at full size; d_model and q_lora_rank stay cut
FULL_WIDTHS = {"kv_lora_rank": 512, "qk_rope_head_dim": 64,
               "qk_nope_head_dim": 128, "v_head_dim": 128, "num_heads": 128,
               "attn_flash_min_seq": 16}
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SEQ, BATCH = 48, 2


def _np(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        dtype).requires_grad_(grad)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), _f32(want),
                               rtol=tol, atol=tol)


def _close_to_max(got, want, tol):
    """|got - want| within tol of want's largest entry: bf16 gradients
    that sum 128 heads' rounded terms."""
    want = _f32(want)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), err


# ---------------------------------------- (a) the kernels at (576, 512)

@pytest.mark.parametrize("dtype,sq,sk,q_offset", [
    ("fp32", 48, 48, 0),
    ("bf16", 48, 48, 0),
    ("fp32", 40, 40, 0),      # ragged against the reference's tiles
    ("fp32", 24, 56, 32),     # a q stripe at offset 32
])
def test_flash_attention_at_the_absorbed_width(dtype, sq, sk, q_offset):
    """The plain forward (and lse) and the autograd flash_attention at
    (576, 512), G 128, against the reference's Pallas kernel in
    interpret mode: the output (B, S, H, 512), dq like q, dk like k, dv
    like v."""
    assert autotune.kernel_head_dim(HD, HD_V) == (HD, HD_V)
    jdt, tdt = DTYPES[dtype]
    tol = 1e-4 if dtype == "fp32" else 2e-2
    q, k, v, do = (_np(BATCH, sq, H, HD, seed=1),
                   _np(BATCH, sk, 1, HD, seed=2),
                   _np(BATCH, sk, 1, HD_V, seed=3),
                   _np(BATCH, sq, H, HD_V, seed=4))

    def jf(q_, k_, v_):
        return jops.flash_attention(q_, k_, v_, jnp.float32(q_offset),
                                    causal=True, block_q=16, block_k=32,
                                    interpret=True)

    jout, vjp = jax.vjp(jf, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do, jdt))
    plain, lse = tfa.flash_attention_plain(
        *(_t(x, tdt).transpose(1, 2) for x in (q, k, v)), q_offset,
        with_lse=True)
    assert tuple(plain.shape) == (BATCH, H, sq, HD_V)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (BATCH, H, sq)
    _close(plain.transpose(1, 2), jout, tol)
    tq, tk, tv = (_t(x, tdt, grad=True) for x in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, q_offset)
    assert tuple(out.shape) == (BATCH, sq, H, HD_V)
    _close(out, jout, tol)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(do, tdt))
    for name, got, want, ref in zip("qkv", grads, jgrads, (q, k, v)):
        assert got.shape == ref.shape and got.dtype == tdt, name
        if dtype == "fp32":
            _close(got, want, tol)
        else:
            _close_to_max(got, want, tol)


@pytest.mark.parametrize("bkv,g,sk,itemsize,splits", [
    (1, 128, 4096, 2, 9),     # deepseek's micro-batch: 64 kv tiles
    (4, 128, 4096, 2, 3),     # its prefill batch: 256 tiles
    (1, 128, 2180, 4, 4),     # the fp32 check: 137 tiles of 16 rows
    (1, 16, 300, 2, 16),      # few tiles: one head a slice
    (64, 128, 4096, 2, 1),    # enough tiles already
])
def test_wide_dkv_splits(bkv, g, sk, itemsize, splits):
    """The dk/dv pass's head slices at (576, 512): about four blocks an
    SM of the H100's 132, never more slices than heads, a pure function
    of the shapes (the sum's order, hence K2's bits, follows from it)."""
    assert autotune.wide_dkv_splits(bkv, g, sk, itemsize) == splits
    tiles = bkv * -(-sk // autotune.WIDE_DKV_ROWS[itemsize])
    assert splits == g or splits * tiles >= 4 * autotune.SM_COUNT


# ------------------------------------- (b) mla_train and mla_prefill

def _setup():
    """(jcfg, tcfg, numpy params, numpy x, numpy positions) at the full
    attention widths."""
    jcfg = dataclasses.replace(jget(ARCH).reduced(), **FULL_WIDTHS)
    tcfg = dataclasses.replace(tget(ARCH).reduced(), **FULL_WIDTHS)
    assert SEQ > TA.flash_min_seq(tcfg) and SEQ > JA.flash_min_seq(jcfg)
    assert (tcfg.kv_lora_rank + tcfg.qk_rope_head_dim,
            tcfg.kv_lora_rank) == (HD, HD_V)
    params = jax.tree_util.tree_map(
        np.asarray, JA.mla_init(jax.random.PRNGKey(0), jcfg))
    x = _np(BATCH, SEQ, jcfg.d_model, seed=5)
    pos = np.broadcast_to(np.arange(SEQ)[None], (BATCH, SEQ)).copy()
    return jcfg, tcfg, params, x, pos


def _tparams(params, dtype=torch.float32, grad=False):
    return {k: _tparams(v, dtype, grad) if isinstance(v, dict)
            else _t(v, dtype, grad) for k, v in params.items()}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mla_train_and_prefill_outputs_at_full_width(dtype):
    """``mla_train``'s output and ``mla_prefill``'s output and caches on
    the absorbed route, 128 heads of (576, 512), against the
    reference's."""
    jcfg, tcfg, params, x, pos = _setup()
    jdt, tdt = DTYPES[dtype]
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
    jx, tx = jnp.asarray(x, jdt), _t(x, tdt)
    tp = _tparams(params, tdt)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    out_tol = 1e-4 if dtype == "fp32" else 2e-2
    cache_tol = 1e-5 if dtype == "fp32" else 2e-2
    _close(TA.mla_train(tp, tx, tcfg, tpos),
           JA.mla_train(jp, jx, jcfg, jpos), out_tol)
    got, gcache = TA.mla_prefill(tp, tx, tcfg, tpos)
    want, wcache = JA.mla_prefill(jp, jx, jcfg, jpos)
    assert tuple(got.shape) == want.shape == (BATCH, SEQ, jcfg.d_model)
    _close(got, want, out_tol)
    assert set(gcache) == set(wcache) == {"c_kv", "k_rope"}
    for name in wcache:
        assert tuple(gcache[name].shape) == wcache[name].shape
        _close(gcache[name], wcache[name], cache_tol)


def test_mla_train_gradients_at_full_width():
    """The loss sum(sin(mla_train)) and its gradients in every parameter
    and in x, fp32, through the absorbed route's flash VJP (K1-lse and
    K3's plain versions here) against ``jax.value_and_grad`` of the
    reference's."""
    jcfg, tcfg, params, x, pos = _setup()

    def jloss(p, x_):
        return jnp.sum(jnp.sin(JA.mla_train(p, x_, jcfg, jnp.asarray(pos))))

    jval, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tp, tx = _tparams(params, grad=True), _t(x, grad=True)
    loss = torch.sin(TA.mla_train(tp, tx, tcfg, torch.from_numpy(pos))).sum()
    leaves = [tp[k]["scale"] if isinstance(tp[k], dict) else tp[k]
              for k in sorted(tp)]
    grads = torch.autograd.grad(loss, leaves + [tx])
    np.testing.assert_allclose(float(loss.detach()), float(jval), atol=1e-3,
                               rtol=1e-5)
    want = [jgp[k]["scale"] if isinstance(jgp[k], dict) else jgp[k]
            for k in sorted(jgp)] + [jgx]
    assert len(grads) == len(want) == 9
    for name, got, w in zip(sorted(tp) + ["x"], grads, want):
        assert tuple(got.shape) == w.shape, name
        np.testing.assert_allclose(got.numpy(), _f32(w), atol=1e-3,
                                   rtol=1e-3, err_msg=name)


def test_absorbed_route_hands_v_as_k_prefix(monkeypatch):
    """``_mla_absorbed_flash`` hands the kernels v as a view of k's first
    ``kv_lora_rank`` columns (k's storage start and strides), not a copy
    of c_kv: the wrappers then read one tile for both."""
    _, tcfg, params, x, pos = _setup()
    seen = []
    real = tfa.flash_attention

    def record(q, k, v, *a, **kw):
        seen.append((k, v))
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(tfa, "flash_attention", record)
    TA._mla_absorbed_flash(_tparams(params), _t(x), tcfg,
                           torch.from_numpy(pos))
    (k, v), = seen
    assert k.shape[-1] == HD and v.shape[-1] == HD_V == tcfg.kv_lora_rank
    assert v.data_ptr() == k.data_ptr() and v.stride() == k.stride()
    assert tfa.is_k_prefix(k, v) and not v.is_contiguous()
