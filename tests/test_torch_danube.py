"""h2o-danube3-4b's head width, 120, on the CPU: the width the tiled
kernels K1, K2, K3 and K5 now take (any multiple of 8 up to 128, run at
the next compiled width of 64 or 128 with the columns past hd
zero-filled), held against the JAX package.

(a) The plain versions of K1 (with its lse), of the backward and of K5 at
    hd 120 with a sliding window and a q stripe, against the reference's
    Pallas kernels in interpret mode (``jax.vjp`` for the gradients) and
    its decode oracle.
(b) The identity the kernels' zero-fill rests on: zero columns appended
    to q, k and v change no score and give zero output columns, so
    attention at width 128 with the scale of width 120, cut back to 120
    columns, is attention at width 120.
(c) The wrappers' head-width check, a pure function of the shapes:
    32, 64, 120 and 128 pass, 100 and 136 raise for K5 (and 100 for the
    tiled kernels, which run 136 at their widest pair, (576, 512)).
(d) A danube-shaped tiny model (``reduced()`` danube with head_dim 120,
    2 layers, window 16, 48 tokens, ``attn_flash_min_seq`` lowered so
    that both packages take the flash route): prefill logits and caches,
    three decode steps, and one step's gradients, from the same weights
    (``params_from_numpy``) and tokens.

Tolerances: kernels 3e-5 absolute and relative (fp32 on both sides,
another summation order, as ``tests/test_kernels.py`` holds the Pallas
kernels); model logits and caches 1e-4; gradients 1e-5 of each leaf's
largest entry (as ``tests/test_torch_mega.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import flash_min_seq as jflash_min_seq
from repro.models.model import LanguageModel as JModel
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import autotune
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops
from repro_torch.models.model import LanguageModel as TModel
from repro_torch.optim.adamw import iter_leaves

HD = 120
KERNEL_TOL = 3e-5
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-5


def _np(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------ (a) kernels at hd 120

@pytest.mark.parametrize("sq,sk,window,q_offset", [
    (72, 72, 16, 0),       # the window bites, ragged against the tiles
    (40, 104, 24, 64),     # a q stripe at offset 64 with a window
    (50, 50, 0, 0),        # causal only
])
def test_flash_attention_and_vjp_at_hd_120(sq, sk, window, q_offset):
    b, h, kh = 1, 8, 2                      # danube's G = 4
    q, k, v, do = (_np(b, sq, h, HD, seed=1), _np(b, sk, kh, HD, seed=2),
                   _np(b, sk, kh, HD, seed=3), _np(b, sq, h, HD, seed=4))

    def jf(q_, k_, v_):
        return jops.flash_attention(q_, k_, v_, jnp.float32(q_offset),
                                    causal=True, window=window, block_q=16,
                                    block_k=32)

    jout, vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tout = tops.flash_attention(tq, tk, tv, q_offset, causal=True,
                                window=window)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)
    for name, got, want in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=KERNEL_TOL, rtol=KERNEL_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("cur,window", [(37, 0), (100, 48), (128, 16)])
def test_flash_decode_at_hd_120(cur, window):
    b, kh, g, s = 2, 2, 4, 128
    q, kc, vc = (_np(b, 1, kh * g, HD, seed=cur), _np(b, kh, s, HD, seed=5),
                 _np(b, kh, s, HD, seed=6))
    args = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(cur))
    kernel = jops.flash_decode(*args, window=window, block_s=32,
                               interpret=True)
    oracle = jref.flash_decode_ref(*args, window=window)
    got = tops.flash_decode(*(torch.from_numpy(x) for x in (q, kc, vc)),
                            torch.tensor([cur], dtype=torch.int32),
                            window=window)
    for want in (kernel, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=KERNEL_TOL, rtol=KERNEL_TOL)


# ------------------------------------------ (b) the zero-fill identity

def test_zero_columns_at_the_true_scale_give_the_narrow_head():
    """What the kernels do at hd 120: compute at 128 with columns 120..127
    zero and the scale 1/sqrt(120), store 120 columns.  The plain
    versions take the scale from the width they see, so q carries the
    ratio sqrt(128/120) here; forward, lse, backward and decode agree."""
    b, h, kh, s, wide = 1, 8, 2, 60, 128
    q, k, v, do = (torch.from_numpy(_np(b, n, s, HD, seed=i))
                   for i, n in enumerate((h, kh, kh, h)))

    def pad(x):
        return torch.nn.functional.pad(x, (0, wide - HD))

    ratio = float(np.sqrt(wide / HD))
    kw = dict(causal=True, window=16)
    out, lse = tfa.flash_attention_plain(q, k, v, 5, with_lse=True, **kw)
    out_w, lse_w = tfa.flash_attention_plain(pad(q) * ratio, pad(k), pad(v),
                                             5, with_lse=True, **kw)
    torch.testing.assert_close(out_w[..., :HD], out, rtol=1e-5, atol=1e-6)
    assert not out_w[..., HD:].any()
    torch.testing.assert_close(lse_w, lse, rtol=1e-5, atol=1e-5)

    grads = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, 5, **kw)
    grads_w = tfa.flash_attention_bwd_plain(pad(q) * ratio, pad(k), pad(v),
                                            out_w, lse_w, pad(do), 5, **kw)
    dq_w = grads_w[0] * ratio            # d/dq of the scaled copy
    for got, want in zip((dq_w, *grads_w[1:]), grads):
        torch.testing.assert_close(got[..., :HD], want, rtol=1e-4,
                                   atol=1e-5)
        assert not got[..., HD:].any()

    qd = q[:, :, -1].reshape(b, kh, h // kh, HD)
    cur = torch.tensor([s], dtype=torch.int32)
    dec = tfd.flash_decode_plain(qd, k, v, cur, window=16)
    dec_w = tfd.flash_decode_plain(pad(qd) * ratio, pad(k), pad(v), cur,
                                   window=16)
    torch.testing.assert_close(dec_w[..., :HD], dec, rtol=1e-5, atol=1e-6)


# ---------------------------------------------- (c) the width check

@pytest.mark.parametrize("hd,takes", [(32, True), (64, True), (120, True),
                                      (128, True), (100, False),
                                      (136, False)])
def test_wrappers_take_multiples_of_8_up_to_128(hd, takes):
    q = torch.empty((1, 4, 8, hd), device="meta")
    k = torch.empty((1, 2, 8, hd), device="meta")
    qd = torch.empty((1, 2, 2, hd), device="meta")
    k5 = (lambda: tfd.check_shapes(qd, k, k),
          lambda: autotune.kernel_head_dim(hd, pairs=autotune.DECODE_PAIRS))
    tiled = (lambda: tfa.check_head_dim("flash_attention", q, k, k),
             lambda: autotune.kernel_head_dim(hd))
    # K5 takes the multiples of 8 up to 128, the tiled kernels every
    # multiple of 8 up to 576 (136 at their widest pair)
    for check in k5 + (() if hd % 8 == 0 else tiled):
        if takes:
            check()
        else:
            with pytest.raises(ValueError, match="head_dim"):
                check()
    if hd % 8 == 0:
        for check in tiled:
            check()
    if takes:
        w = 64 if hd <= 64 else 128
        assert autotune.kernel_head_dim(hd) == (w, w)
    elif hd % 8 == 0:
        assert autotune.kernel_head_dim(hd) == autotune.WIDE_PAIR
    # K4 keeps its compiled widths: the planner sends it nothing else
    plan = autotune.plan_attention(
        40, hd, hd, 2, 66, 32,
        timings=(autotune.MegaTiming(40, hd, 32, 66, 2, 0.1, 1.0, 0.1, 1.0,
                                     "test"),))
    assert plan.mega_fwd == (hd in autotune.HEAD_DIMS)


# -------------------------------------------- (d) the tiny danube model

OVER = {"head_dim": HD, "attn_flash_min_seq": 8}
SEQ = 48


def _pair():
    jcfg = dataclasses.replace(jget("h2o-danube-3-4b").reduced(), **OVER)
    tcfg = dataclasses.replace(tget("h2o-danube-3-4b").reduced(), **OVER)
    assert tcfg.sliding_window == 16 and tcfg.num_layers == 2
    assert SEQ > jflash_min_seq(jcfg)           # both take the flash route
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           device="cpu")
    return jm, jp, TModel(tcfg, device="cpu"), tp


def _spy_flash(monkeypatch):
    calls = []
    plain = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    return calls


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_danube_prefill_and_decode_match_reference(monkeypatch):
    jm, jp, tm, tp = _pair()
    calls = _spy_flash(monkeypatch)
    steps = 3
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, jm.cfg.vocab_size, (2, SEQ)).astype(np.int32)
    jlog, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens)})
    tlog, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()})
    assert len(calls) == jm.cfg.num_layers       # the flash route
    _close(tlog, jlog)
    for name in ("k", "v"):
        _close(tcache["layers"][name], jcache["layers"][name])
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.pad(a, [(0, 0)] * (a.ndim - 2) + [(0, steps), (0, 0)]),
        jcache)
    tcache = tm.alloc_cache(2, SEQ + steps, init=tcache)
    jstep = jax.jit(jm.decode_step)
    for i in range(steps):
        tok = rng.randint(0, jm.cfg.vocab_size, (2, 1)).astype(np.int32)
        jlog, jcache = jstep(jp, jcache, jnp.asarray(tok),
                             jnp.asarray(SEQ + i, jnp.int32))
        tlog, tcache = tm.decode_step(tp, tcache,
                                      torch.from_numpy(tok).long(), SEQ + i)
        _close(tlog, jlog)


def test_danube_train_gradients_match_reference(monkeypatch):
    jm, jp, tm, tp = _pair()
    calls = _spy_flash(monkeypatch)
    rng = np.random.RandomState(8)
    toks = rng.randint(0, jm.cfg.vocab_size, (2, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    (jl, _), jg = jax.value_and_grad(jm.train_loss, has_aux=True)(
        jp, {k: jnp.asarray(x) for k, x in batch.items()})
    leaves = [x.requires_grad_() for _p, x in iter_leaves(tp)]
    tl, _ = tm.train_loss(tp, {k: torch.from_numpy(x)
                               for k, x in batch.items()})
    tg = torch.autograd.grad(tl, leaves)
    assert calls                                   # the flash route
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jg)]
    for (path, _x), got, want in zip(iter_leaves(tp), tg, jleaves):
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg=str(path))
