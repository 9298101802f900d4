"""DeepSeek-V2's multi-head latent attention in the port
(``repro_torch.models.attention`` MLA functions and
``repro_torch.dist.flash.mla_decode_attend``) against the reference's
on the same numpy inputs and weights (CPU), on reduced deepseek-v2-236b
(q/k 16 + 16 = 32, v 32) and a variant with q/k 32 + 16 = 48 and v 32, so
that the v width differs from the q/k width; in fp32 and bf16.

Also: the flash kernels' plain version and the autograd
``flash_attention`` at hd 48, hd_v 32 against the reference's
``ops.flash_attention`` in interpret mode (forward and gradients); the
absorbed route as the reference's ``test_autotune`` holds it (above the
threshold ``mla_train`` never reaches ``full_attention``, and its loss,
gradients, prefill output and caches match the dense route's); and the
pure width checks (``autotune.kernel_head_dim``, ``check_head_dim``),
which take the absorbed route's full width (576, 512) at the fourth
compiled pair (``tests/test_torch_mla_absorbed.py`` holds that width
against the reference).

Tolerances: fp32 1e-5 for the projections and the latents (the same
arithmetic), 1e-4 for outputs through attention (summation order), as
the reference's own flash tests (3e-5 against its oracle) and
``test_autotune`` (1e-3 for the absorbed route's gradients, which
reassociate W_UK and W_UV); bf16 2e-2 (a few bf16 ulps of O(1) values:
XLA and torch round the same products at the same places, in other
summation orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.dist import flash as jflash
from repro.kernels import ops as jops
from repro.models import attention as JA
from repro_torch.configs import get_config as tget
from repro_torch.dist import flash as tflash
from repro_torch.kernels import autotune
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as TA

ARCH = "deepseek-v2-236b"
# the reduced config (hd 32 = hd_v 32) and the narrow-v variant (hd 48,
# hd_v 32), as the reference's test_flash_mla_dims
VARIANTS = {"reduced": {},
            "hd48": {"qk_nope_head_dim": 32, "qk_rope_head_dim": 16,
                     "v_head_dim": 32}}
DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2, 2e-2)}
SEQ, BATCH = 48, 2


def _cfgs(variant, **over):
    over = {**VARIANTS[variant], **over}
    return (dataclasses.replace(jget(ARCH).reduced(), **over),
            dataclasses.replace(tget(ARCH).reduced(), **over))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        dtype).requires_grad_(grad)


def _tree(tree, dtype=torch.float32, grad=False):
    return {k: _tree(v, dtype, grad) if isinstance(v, dict)
            else _t(v, dtype, grad) for k, v in tree.items()}


def _jtree(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               rtol=tol, atol=tol)


def _setup(variant, dtype="fp32", seq=SEQ, **over):
    """(jcfg, tcfg, numpy params, numpy x, numpy positions)."""
    jcfg, tcfg = _cfgs(variant, **over)
    params = jax.tree_util.tree_map(
        np.asarray, JA.mla_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(1)
    x = rng.randn(BATCH, seq, jcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(seq)[None], (BATCH, seq)).copy()
    return jcfg, tcfg, params, x, pos


def _inputs(params, x, pos, dtype):
    jdt, tdt, _, _ = DTYPES[dtype]
    return ((_jtree(params, jdt), jnp.asarray(x, jdt), jnp.asarray(pos)),
            (_tree(params, tdt), _t(x, tdt), torch.from_numpy(pos)))


# ------------------------------------------------------------- layout

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mla_init_layout(variant):
    """``mla_init`` gives the reference's names and shapes, in fp32."""
    jcfg, tcfg, params, _x, _pos = _setup(variant)
    got = TA.mla_init(torch.Generator().manual_seed(0), tcfg)

    def shapes(tree):
        return [(k, shapes(v) if isinstance(v, dict) else tuple(v.shape))
                for k, v in sorted(tree.items())]
    assert shapes(got) == shapes(params)
    assert got["w_uq"].shape[-1] == (tcfg.qk_nope_head_dim
                                     + tcfg.qk_rope_head_dim)
    assert all(v.dtype == torch.float32 for v in got.values()
               if isinstance(v, torch.Tensor))


# --------------------------------------------------- projections, routes

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mla_latents_and_full_heads_match_reference(variant, dtype):
    """``_mla_latents`` and ``_mla_qkv_full``: every output."""
    jcfg, tcfg, params, x, pos = _setup(variant)
    (jp, jx, jpos), (tp, tx, tpos) = _inputs(params, x, pos, dtype)
    tol = DTYPES[dtype][2]
    for got, want in zip(TA._mla_latents(tp, tx, tcfg, tpos),
                         JA._mla_latents(jp, jx, jcfg, jpos)):
        assert tuple(got.shape) == want.shape
        _close(got, want, tol)
    got = TA._mla_qkv_full(tp, tx, tcfg, tpos)
    want = JA._mla_qkv_full(jp, jx, jcfg, jpos)
    hd = tcfg.qk_nope_head_dim + tcfg.qk_rope_head_dim
    assert got[0].shape[-1] == got[1].shape[-1] == hd
    assert got[2].shape[-1] == tcfg.v_head_dim
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mla_absorbed_flash_matches_reference(variant, dtype):
    """The absorbed route: one latent kv head of width rkv + dr, q
    pre-scaled; the port's flash call (plain version on the CPU) against
    the reference's Pallas kernel in interpret mode."""
    jcfg, tcfg, params, x, pos = _setup(variant)
    (jp, jx, jpos), (tp, tx, tpos) = _inputs(params, x, pos, dtype)
    got = TA._mla_absorbed_flash(tp, tx, tcfg, tpos)
    want = JA._mla_absorbed_flash(jp, jx, jcfg, jpos)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, DTYPES[dtype][3])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mla_train_and_prefill_match_reference(variant, flash, dtype):
    """``mla_train`` and ``mla_prefill`` (output and latent caches) on
    the absorbed flash route (threshold 16 < 48) and the dense one."""
    over = {"attn_flash_min_seq": 16 if flash else 1 << 20}
    jcfg, tcfg, params, x, pos = _setup(variant, **over)
    assert (SEQ > TA.flash_min_seq(tcfg)) == flash
    (jp, jx, jpos), (tp, tx, tpos) = _inputs(params, x, pos, dtype)
    tol = DTYPES[dtype][3]
    _close(TA.mla_train(tp, tx, tcfg, tpos),
           JA.mla_train(jp, jx, jcfg, jpos), tol)
    got, gcache = TA.mla_prefill(tp, tx, tcfg, tpos)
    want, wcache = JA.mla_prefill(jp, jx, jcfg, jpos)
    _close(got, want, tol)
    assert set(gcache) == set(wcache) == {"c_kv", "k_rope"}
    for k in wcache:
        assert tuple(gcache[k].shape) == wcache[k].shape
        _close(gcache[k], wcache[k], DTYPES[dtype][2])


def _decode_setup(variant, dtype, cur):
    jcfg, tcfg, params, x, pos = _setup(variant, seq=1)
    rng = np.random.RandomState(4)
    smax = 24
    c_kv = rng.randn(BATCH, smax, jcfg.kv_lora_rank).astype(np.float32)
    k_rope = rng.randn(BATCH, smax, jcfg.qk_rope_head_dim).astype(np.float32)
    c_kv[:, cur + 1:] = 0.0
    k_rope[:, cur + 1:] = 0.0
    (jp, jx, _), (tp, tx, _) = _inputs(params, x, pos, dtype)
    jdt, tdt = DTYPES[dtype][:2]
    return (jcfg, tcfg, (jp, jx), (tp, tx),
            {"c_kv": jnp.asarray(c_kv, jdt), "k_rope": jnp.asarray(k_rope, jdt)},
            {"c_kv": _t(c_kv, tdt), "k_rope": _t(k_rope, tdt)})


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cur", [0, 13, 30])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mla_decode_matches_reference(variant, cur, dtype):
    """``mla_decode`` against the reference's, the caches updated in
    place at ``cur_len`` (30 lies past the 24-slot cache: the write
    clamps to the last slot, as ``dynamic_update_slice`` does)."""
    jcfg, tcfg, (jp, jx), (tp, tx), jc, tc = _decode_setup(variant, dtype,
                                                           cur)
    c_kv, k_rope = tc["c_kv"], tc["k_rope"]
    got, gcache = TA.mla_decode(tp, tx, tcfg, tc, cur)
    want, wcache = JA.mla_decode(jp, jx, jcfg, jc, jnp.asarray(cur))
    _close(got, want, DTYPES[dtype][3])
    assert gcache["c_kv"] is c_kv and gcache["k_rope"] is k_rope
    for k in wcache:
        _close(gcache[k], wcache[k], DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mla_decode_attend_matches_reference(variant, dtype):
    """``mla_decode_attend`` on the same latents: the output, and the
    caches with the new latents written at ``cur_len``."""
    jcfg, _tcfg, _jw, _tw, jc, tc = _decode_setup(variant, dtype, 9)
    jdt, tdt, ftol, tol = DTYPES[dtype]
    rng = np.random.RandomState(5)
    h, rkv, dr = jcfg.num_heads, jcfg.kv_lora_rank, jcfg.qk_rope_head_dim
    ql, qr = rng.randn(BATCH, 1, h, rkv), rng.randn(BATCH, 1, h, dr)
    cn, kn = rng.randn(BATCH, 1, rkv), rng.randn(BATCH, 1, dr)
    scale = 1.0 / np.sqrt(jcfg.qk_nope_head_dim + dr)
    got = tflash.mla_decode_attend(_t(ql, tdt), _t(qr, tdt), _t(cn, tdt),
                                   _t(kn, tdt), tc["c_kv"], tc["k_rope"], 9,
                                   scale=scale)
    want = jflash.mla_decode_attend(
        *(jnp.asarray(a, jdt) for a in (ql, qr, cn, kn)), jc["c_kv"],
        jc["k_rope"], 9, scale=scale)
    assert got[0].dtype == tdt and tuple(got[0].shape) == want[0].shape
    _close(got[0], want[0], tol)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, ftol)


# ------------------------------ the absorbed route (reference test_autotune)

def _port_setup(variant):
    _jcfg, tcfg, params, x, pos = _setup(variant)
    flash_cfg = dataclasses.replace(tcfg, attn_flash_min_seq=16)
    dense_cfg = dataclasses.replace(tcfg, attn_flash_min_seq=1 << 20)
    return flash_cfg, dense_cfg, params, x, torch.from_numpy(pos)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mla_train_flash_path_never_reaches_dense(variant, monkeypatch):
    """Above the threshold ``mla_train`` takes the absorbed flash route
    and never reaches ``full_attention``; below it, it does."""
    flash_cfg, dense_cfg, params, x, pos = _port_setup(variant)

    def boom(*a, **kw):
        raise AssertionError("dense full_attention reached on flash path")
    monkeypatch.setattr(TA, "full_attention", boom)
    out = TA.mla_train(_tree(params), _t(x), flash_cfg, pos)
    assert out.shape == x.shape
    with pytest.raises(AssertionError, match="dense full_attention"):
        TA.mla_train(_tree(params), _t(x), dense_cfg, pos)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mla_flash_bwd_matches_dense(variant):
    """Loss and gradients (parameters and activations) of the absorbed
    route match the dense route's: the absorption is exact up to fp32
    reassociation."""
    flash_cfg, dense_cfg, params, x, pos = _port_setup(variant)

    def run(cfg):
        p, xx = _tree(params, grad=True), _t(x, grad=True)
        loss = torch.sin(TA.mla_train(p, xx, cfg, pos)).sum()
        leaves = [p[k]["scale"] if isinstance(p[k], dict) else p[k]
                  for k in sorted(p)] + [xx]
        return loss, torch.autograd.grad(loss, leaves)

    (lf, gf), (ld, gd) = run(flash_cfg), run(dense_cfg)
    np.testing.assert_allclose(float(lf.detach()), float(ld.detach()),
                               atol=1e-3, rtol=1e-5)
    for a, b in zip(gf, gd):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-3,
                                   rtol=1e-3)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mla_prefill_flash_matches_dense(variant):
    """``mla_prefill`` on both routes: the same output and latent
    caches."""
    flash_cfg, dense_cfg, params, x, pos = _port_setup(variant)
    out_f, cache_f = TA.mla_prefill(_tree(params), _t(x), flash_cfg, pos)
    out_d, cache_d = TA.mla_prefill(_tree(params), _t(x), dense_cfg, pos)
    np.testing.assert_allclose(out_f.numpy(), out_d.numpy(), atol=1e-4,
                               rtol=1e-4)
    assert set(cache_f) == set(cache_d) == {"c_kv", "k_rope"}
    for k in cache_f:
        np.testing.assert_allclose(cache_f[k].numpy(), cache_d[k].numpy(),
                                   atol=1e-5, rtol=1e-5)


# ------------------------- the kernels at hd_v != hd (reference test_kernels)

@pytest.mark.parametrize("kh", [4, 2, 1])
def test_flash_mla_dims(kh):
    """hd 48, hd_v 32 (and GQA, and one latent kv head as on the
    absorbed route): the plain version and the autograd
    ``flash_attention`` against the reference's ``ops.flash_attention``
    in interpret mode, forward and gradients; the output is (B, S, H,
    hd_v), dq like q, dk like k, dv like v."""
    rng = np.random.RandomState(9)
    b, s, h, hd, hd_v = 2, 128, 4, 48, 32
    q = rng.randn(b, s, h, hd).astype(np.float32)
    k = rng.randn(b, s, kh, hd).astype(np.float32)
    v = rng.randn(b, s, kh, hd_v).astype(np.float32)
    w = rng.randn(b, s, h, hd_v).astype(np.float32)

    def jloss(q_, k_, v_):
        out = jops.flash_attention(q_, k_, v_, block_q=64, block_k=64,
                                   interpret=True)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    plain = tfa.flash_attention_plain(*(_t(a).transpose(1, 2)
                                        for a in (q, k, v)))
    assert tuple(plain.shape) == (b, h, s, hd_v)
    _close(plain.transpose(1, 2), jout, 3e-5)
    tq, tk, tv = _t(q, grad=True), _t(k, grad=True), _t(v, grad=True)
    out = tops.flash_attention(tq, tk, tv)
    assert tuple(out.shape) == (b, s, h, hd_v)
    _close(out, jout, 3e-5)
    grads = torch.autograd.grad((out * _t(w)).sum(), (tq, tk, tv))
    for got, want, ref in zip(grads, jg, (q, k, v)):
        assert got.shape == ref.shape
        _close(got, want, 1e-4)


# ------------------------------------------------------ the width checks

@pytest.mark.parametrize("hd,hd_v,pair", [
    (32, 32, (64, 64)), (48, 32, (64, 64)), (64, 64, (64, 64)),
    (120, 120, (128, 128)), (128, 128, (128, 128)), (64, 128, (128, 128)),
    (192, 128, (192, 128)), (136, 64, (192, 128)),
    (576, 512, (576, 512)), (192, 192, (576, 512)), (200, 128, (576, 512)),
    (52, 32, None), (48, 36, None), (136, 136, (576, 512)),
    (512, 512, (576, 512)), (584, 512, None), (64, 520, None)])
def test_kernel_head_dim_pairs(hd, hd_v, pair):
    """``kernel_head_dim`` returns the first compiled pair that holds
    both widths — the absorbed route's (576, 512) and every pair of
    multiples of 8 under it past (192, 128) at the fourth pair — or
    raises ``ValueError`` naming both; one width means v as wide as q
    and k.  K5's pairs stop at 128."""
    if pair is None:
        with pytest.raises(ValueError, match=f"head_dim {hd}, v head_dim "
                           f"{hd_v}"):
            autotune.kernel_head_dim(hd, hd_v)
    else:
        assert autotune.kernel_head_dim(hd, hd_v) == pair
    assert autotune.ATTN_PAIRS == ((64, 64), (128, 128), (192, 128),
                                   (576, 512))
    assert autotune.WIDE_PAIR == (576, 512)
    if hd == hd_v and hd <= 128:
        assert autotune.kernel_head_dim(hd) == pair
        assert autotune.kernel_head_dim(
            hd, pairs=autotune.DECODE_PAIRS) == pair
    elif hd == hd_v:
        with pytest.raises(ValueError, match=f"head_dim {hd}"):
            autotune.kernel_head_dim(hd, pairs=autotune.DECODE_PAIRS)


@pytest.mark.parametrize("q,k,v,ok", [
    ((2, 4, 8, 192), (2, 4, 8, 192), (2, 4, 8, 128), True),
    ((2, 8, 8, 48), (2, 2, 16, 48), (2, 2, 16, 32), True),
    ((2, 128, 8, 576), (2, 1, 8, 576), (2, 1, 8, 512), True),
    ((2, 128, 8, 584), (2, 1, 8, 584), (2, 1, 8, 512), False),
    ((2, 128, 8, 576), (2, 1, 8, 576), (2, 1, 8, 520), False),
    ((2, 4, 8, 192), (2, 4, 8, 192), (2, 2, 8, 128), False),
    ((2, 4, 8, 192), (2, 4, 8, 192), (1, 4, 8, 128), False),
    ((2, 4, 8, 192), (2, 4, 8, 192), (2, 4, 9, 128), False),
    ((2, 4, 8, 192), (2, 4, 8, 128), (2, 4, 8, 128), False)])
def test_check_head_dim(q, k, v, ok):
    """``check_head_dim``, a pure function of the shapes: v (B, KH, Sk,
    hd_v) under k's (B, KH, Sk), k as wide as q, and a compiled pair
    (the absorbed route's (576, 512) is one; (584, 512) and (576, 520)
    are past it)."""
    q, k, v = (torch.empty(s, device="meta") for s in (q, k, v))
    if ok:
        tfa.check_head_dim("flash_attention", q, k, v)
    else:
        with pytest.raises(ValueError, match="flash_attention: head_dim"):
            tfa.check_head_dim("flash_attention", q, k, v)


def test_k4_planner_stays_off_mla_widths():
    """``plan_attention`` keeps K4 off hd_v != hd and widths past 128,
    even where a timing says K4 would win (the reference's planner sizes
    K4 by hd + hd_v instead)."""
    for hd, hd_v in ((192, 128), (48, 32), (64, 32)):
        timings = (autotune.MegaTiming(256, hd, 16, 160, 1, 0.1, 1.0, 0.1,
                                       1.0, "test"),)
        plan = autotune.plan_attention(256, hd, hd_v, 1, 160, 16,
                                       timings=timings)
        assert not plan.mega_fwd and not plan.mega_bwd
