"""The whole-sequence attention megakernels K4f and K4b: the port's
plain versions against the reference's mega kernels, the Hopper planner's
decisions and routing, and a short-sequence model whose reference runs
K4 (CPU).

(a) The reference's mega plans, forced by ``dataclasses.replace`` of its
    interpret-mode plan (``mega_fwd``/``mega_bwd`` and, separately, the
    batch-tiled ``mega_fwd_bt``/``mega_bwd_bt``, as
    ``tests/test_autotune.py`` does), run its Pallas mega kernels in
    interpret mode; the port's K4 wrappers take their plain versions on
    CPU tensors.  Forward, lse and ``torch.autograd.grad`` against
    ``jax.vjp``: causal, window, q_offset, ragged Sq against the plan's
    block, G in {1, 2, 4}, hd 32 and 64.
(b) ``kernels/autotune.plan_attention``'s rule — K4 only at a shape
    where a time measured on the card says it wins; the default plan at
    each measured shape is what ``autotune.MEGA_TIMINGS`` says — its
    gates (bf16 takes any width the tiled kernels take, fp32 64 and 128)
    and budget arithmetic (held with a measured table in which K4 wins,
    so that each gate is what refuses), and that ``flash_attention`` (and
    its autograd Function) call the K4 wrappers exactly when the plan
    says so, pinned tiles included.
(c) A reduced smollm with ``attn_flash_min_seq=32`` at B 2, S 64, where
    the reference's interpret planner picks ``mega_fwd`` and
    ``mega_bwd``: ``train_loss`` gradients against ``jax.grad``, prefill
    and decode logits and caches against the JAX model.

Tolerances (fp32 on both sides, the same arithmetic in another summation
order): 2e-5 absolute and relative per kernel call on O(1) values, as
``test_torch_flash_vjp.py``; model gradients 1e-5 of each leaf's largest
entry; logits and caches 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import autotune as jautotune
from repro.kernels import flash_attention as jfa
from repro.models.model import LanguageModel as JModel
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.dist import flash as tdist
from repro_torch.kernels import autotune
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models.model import LanguageModel as TModel
from repro_torch.optim.adamw import iter_leaves

TOL = 2e-5
GRAD_TOL = 1e-5
LOGIT_TOL = 1e-4


def _inputs(seed, b, sq, sk, h, kh, hd):
    """q, k, v, do in the kernels' head-major layout."""
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32)
            for s in ((b, h, sq, hd), (b, kh, sk, hd), (b, kh, sk, hd),
                      (b, h, sq, hd))]


def _forced_plan(b, sq, sk, h, kh, hd, window, batch_tiled):
    base = jautotune.plan_attention(sq, sk, hd, hd, h // kh, kh, b, 32,
                                    True, window, sk, backend="interpret")
    return dataclasses.replace(base, mega_fwd=not batch_tiled,
                               mega_bwd=not batch_tiled,
                               mega_fwd_bt=batch_tiled,
                               mega_bwd_bt=batch_tiled)


def _jax_lse(plan, q, k, v, q_offset, window):
    """The reference mega kernel's lse (``_fwd_call(with_lse=True)``)
    under the public wrapper's padding; (B, H, Sq)."""
    qt, kt, vt = (jnp.asarray(x) for x in (q, k, v))
    b, h, sq, hd = qt.shape
    kh, sk = kt.shape[1], kt.shape[2]
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


def _spy(monkeypatch, name):
    calls = []
    fn = getattr(tfa, name)
    monkeypatch.setattr(tfa, name,
                        lambda *a, **k: calls.append(k) or fn(*a, **k))
    return calls


# ----------------------------------------- (a) the reference's K4 kernels

MEGA_CASES = [  # seed, B, Sq, Sk, H, KH, hd, window, q_offset
    (0, 2, 64, 64, 4, 2, 32, 0, 0),          # causal, G = 2
    (1, 1, 80, 80, 4, 1, 32, 24, 0),         # window, G = 4 (MQA)
    (2, 2, 40, 72, 2, 2, 64, 0, 32),         # q_offset stripe, G = 1
    (3, 1, 100, 100, 4, 2, 64, 0, 0),        # Sq ragged against block 64
    (4, 1, 33, 65, 8, 2, 32, 20, 32),        # window + offset + ragged, G 4
    (5, 3, 50, 50, 3, 3, 32, 0, 0),          # G = 1, ragged
]


@pytest.mark.parametrize("batch_tiled", [False, True], ids=["mega", "bt"])
@pytest.mark.parametrize("case", MEGA_CASES, ids=lambda c: f"seed{c[0]}")
def test_mega_matches_reference_kernels(case, batch_tiled, monkeypatch):
    seed, b, sq, sk, h, kh, hd, window, off = case
    q, k, v, do = _inputs(seed, b, sq, sk, h, kh, hd)
    plan = _forced_plan(b, sq, sk, h, kh, hd, window, batch_tiled)
    assert (plan.mega_fwd or plan.mega_fwd_bt) and (plan.mega_bwd
                                                    or plan.mega_bwd_bt)

    def jf(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, float(off), causal=True,
                                   window=window, interpret=True, plan=plan)

    jout, vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    jlse = _jax_lse(plan, q, k, v, off, window)

    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    kw = dict(causal=True, window=window)
    out = tfa.flash_attention_mega_fwd(tq, tk, tv, off, **kw)
    out_l, lse = tfa.flash_attention_mega_fwd(tq, tk, tv, off,
                                              with_lse=True, **kw)
    for got, want in ((out, jout), (out_l, jout), (lse, jlse)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)

    # autograd through the port's K4 route (its plan forced as well)
    monkeypatch.setattr(tfa, "attention_plan", lambda *a, **kw_: (
        autotune.AttnPlan(mega_fwd=True, mega_bwd=True)))
    fwd_calls = _spy(monkeypatch, "flash_attention_mega_fwd")
    bwd_calls = _spy(monkeypatch, "flash_attention_mega_bwd")
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    tout = tfa.flash_attention(*leaves, off, **kw)
    tgrads = torch.autograd.grad(tout, leaves, torch.from_numpy(do))
    assert len(fwd_calls) == 1 and fwd_calls[0]["with_lse"]
    assert len(bwd_calls) == 1
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=TOL, rtol=TOL)
    for name, got, want in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL, err_msg=f"d{name}")


# -------------------------------------------- (b) the Hopper planner

def _wins(sk, hd, kh, b, bits):
    """A measured table in which K4f and K4b beat K1 and K3 at this shape
    (and only there)."""
    return (autotune.MegaTiming(sk, hd, bits, b, kh, k4f_ms=0.1, k1_ms=1.0,
                                k4b_ms=0.1, k3_ms=1.0, card="test"),)


def _plan(sk, hd, kh, b, bits, **kw):
    """The plan where the card's times say K4 wins at this shape: what
    remains are the gates."""
    return autotune.plan_attention(sk, hd, hd, kh, b, bits,
                                   timings=_wins(sk, hd, kh, b, bits), **kw)


@pytest.fixture
def k4_wins(monkeypatch):
    """The card's table says K4 wins at MEGA_SHAPE (fp32), as
    ``attention_plan`` reads it."""
    b, s, _h, kh, hd = MEGA_SHAPE
    monkeypatch.setattr(autotune, "MEGA_TIMINGS", _wins(s, hd, kh, b, 32))


def _measured(sk, hd, bits, b, kh):
    """The card's table entry at this shape: (K4f wins, K4b wins)."""
    hit = [t for t in autotune.MEGA_TIMINGS
           if (t.sk, t.hd, t.dtype_bits, t.batch, t.kh) == (sk, hd, bits, b,
                                                             kh)]
    assert len(hit) == 1 and "H100" in hit[0].card
    return hit[0].k4f_ms < hit[0].k1_ms, hit[0].k4b_ms < hit[0].k3_ms


def test_plan_training_shape_takes_both_megakernels():
    """smollm-360m at 64 x 256 tokens: B·KH = 320 blocks, bf16, hd 64.
    The default plan is what the card's times there say; the
    megakernels take both passes wherever a measured time says they both
    win, and a win measured at another shape does not carry over."""
    default = autotune.plan_attention(256, 64, 64, 5, 64, 16)
    assert (default.mega_fwd, default.mega_bwd) == _measured(256, 64, 16,
                                                             64, 5)
    # where K4 is measured faster, both passes take it
    plan = _plan(256, 64, 5, 64, 16)
    assert plan.mega_fwd and plan.mega_bwd
    assert plan.describe() == "forward K4f, backward K4b"
    # a measured win at another shape does not carry over
    assert not autotune.plan_attention(
        256, 64, 64, 5, 64, 16, timings=_wins(384, 64, 5, 64, 16)).mega_fwd
    # the bf16 tiles the wrappers take at that shape
    assert (autotune.mega_rows(False, 256, 64, 2),
            autotune.mega_rows(True, 256, 64, 2)) == (64, 64)


@pytest.mark.parametrize("b", [64, 32], ids=["train-64x256",
                                             "serve-32x256"])
def test_default_plan_follows_the_measured_table(b):
    """At both shapes timed on the card (the short training batch and the
    short-serve prefill), each pass of the default plan is K4 exactly
    where the table says K4 beat K1-lse / K3 — whichever way it points —
    and ``attention_plan`` reads the same table for CPU tensors."""
    want = _measured(256, 64, 16, b, 5)
    plan = autotune.plan_attention(256, 64, 64, 5, b, 16)
    assert (plan.mega_fwd, plan.mega_bwd) == want
    q = torch.empty((b, 15, 256, 64), dtype=torch.bfloat16)
    k = torch.empty((b, 5, 256, 64), dtype=torch.bfloat16)
    assert tfa.attention_plan(q, k, k) == plan


@pytest.mark.parametrize("entry,bits,want", [
    (True, 16, True), (False, 16, False), (True, 32, False)],
    ids=["bf16-with-entry", "bf16-without", "fp32-with-entry"])
def test_plan_hd120_passes_the_width_gate_only_with_an_entry(entry, bits,
                                                             want):
    """bf16 K4 takes h2o-danube3-4b's head width 120 (compiled at 128,
    columns past 120 zero-filled), so hd 120 passes the planner's width
    gate, and K4 takes it where a timing entry at hd 120 says it wins;
    the fp32 kernels keep widths 64 and 128."""
    timings = _wins(256, 120, 8, 32, bits) if entry else ()
    plan = autotune.plan_attention(256, 120, 120, 8, 32, bits,
                                   timings=timings)
    assert plan.mega_fwd == plan.mega_bwd == want
    assert autotune.mega_width(120, bits // 8) == (128 if bits == 16 else 0)


@pytest.mark.parametrize("what,args,kw", [
    ("batch 1", (256, 64, 5, 1, 16), {}),
    ("B·KH 130 < 132", (256, 64, 5, 26, 16), {}),
    ("S 2049", (2049, 64, 5, 64, 16), {}),
    ("block_q pinned", (256, 64, 5, 64, 16), {"block_q": 64}),
    ("block_k pinned", (256, 64, 5, 64, 16), {"block_k": 128}),
    ("hd 32", (256, 32, 5, 64, 32), {}),     # fp32 keeps 64 and 128
    ("8-bit inputs", (256, 64, 5, 64, 8), {}),
])
def test_plan_gives_no_megakernel(what, args, kw):
    plan = _plan(*args, **kw)
    assert not plan.mega_fwd and not plan.mega_bwd, what


def test_plan_occupancy_follows_the_sm_count():
    """26 x 5 = 130 blocks fill a 128-SM card but not a 132-SM one."""
    assert not _plan(256, 64, 5, 26, 16).mega_fwd
    plan = _plan(256, 64, 5, 26, 16, sm_count=128)
    assert plan.mega_fwd and plan.mega_bwd


def test_plan_hd128_at_256_takes_the_forward_only():
    """At hd 128 K4f takes a longer kv head than K4b: the bf16 K4b keeps
    dK/dV in registers, so Sk 256 fits both kernels and Sk 384 the
    forward only (K4b: K and V plus 66,560 B of streams)."""
    plan = _plan(384, 128, 5, 64, 16)
    assert plan.mega_fwd and not plan.mega_bwd
    both = _plan(256, 128, 5, 64, 16)
    assert both.mega_fwd and both.mega_bwd


def _longest(bwd, hd, itemsize):
    sk = 1
    while autotune.mega_rows(bwd, sk + 1, hd, itemsize):
        sk += 1
    return sk


def test_plan_fp32_has_tighter_limits():
    """K and V stay in the input dtype in shared memory, the fp32 K4b
    also keeps fp32 dK/dV there and the bf16 one keeps them in
    registers, so fp32 takes a shorter kv head in each kernel."""
    plan = _plan(256, 64, 5, 64, 32)
    assert plan.mega_fwd and not plan.mega_bwd
    for bwd in (False, True):
        for hd in (64, 128):
            assert _longest(bwd, hd, 4) < _longest(bwd, hd, 2)
    # the docstring's longest Sk, bf16 then fp32
    assert [_longest(bwd, hd, item) for item in (2, 4) for hd in (64, 128)
            for bwd in (False, True)] == [832, 640, 384, 320,
                                          417, 208, 214, 105]


@pytest.mark.parametrize("args,want", [
    ((False, 64, 256, 64, 2), 73_728),    # bf16 K4f: K, V + 4 q slices
    ((True, 64, 256, 64, 2), 133_120),    # bf16 K4b: K, V + 2 groups
    ((True, 64, 256, 128, 2), 197_632),   # bf16 K4b hd 128: one group
    ((False, 64, 200, 120, 2), 147_456),  # hd 120 at width 128, Sk to 256
    ((False, 32, 128, 64, 4), 91_136),    # fp32 K4f, 32-row strip
    ((True, 8, 128, 64, 4), 144_448),     # fp32 K4b, 8-row strip
], ids=["k4f", "k4b", "k4b-hd128", "k4f-hd120", "fp32-k4f", "fp32-k4b"])
def test_budget_arithmetic_matches_the_docstring(args, want):
    assert autotune.mega_smem_bytes(*args) == want


def test_budget_rows_match_the_docstring():
    rows = autotune.mega_rows
    assert rows(True, 256, 64, 2) == rows(False, 256, 64, 2) == 64
    # fp32: the strip shrinks before the kernel is refused
    assert (rows(False, 300, 64, 4), rows(False, 350, 64, 4),
            rows(False, 400, 64, 4)) == (32, 16, 8)
    assert rows(False, 2049, 64, 2) == 0


MEGA_SHAPE = (66, 40, 4, 2, 64)   # B, S, H, KH, hd: B·KH = 132, fp32


def _mega_tensors(seed=0, requires_grad=False):
    b, s, h, kh, hd = MEGA_SHAPE
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(seed, b, s, s, h,
                                                          kh, hd))
    if requires_grad:
        q, k, v = (x.requires_grad_() for x in (q, k, v))
    return q, k, v, do


def test_flash_attention_routes_by_the_plan(monkeypatch, k4_wins):
    """CPU tensors at a shape the planner sends to K4: the serving
    forward calls K4f without lse; under autograd the Function calls K4f
    with lse and K4b; pinned tiles call neither and give the same
    numbers (the plain versions are one function)."""
    fwd = _spy(monkeypatch, "flash_attention_mega_fwd")
    bwd = _spy(monkeypatch, "flash_attention_mega_bwd")
    k1 = _spy(monkeypatch, "flash_attention_fwd")
    q, k, v, do = _mega_tensors()
    assert tfa.attention_plan(q, k, v).mega_fwd
    with torch.no_grad():
        served = tfa.flash_attention(q, k, v, window=9)
    assert len(fwd) == 1 and not fwd[0].get("with_lse")
    qg, kg, vg, _ = _mega_tensors(requires_grad=True)
    out = tfa.flash_attention(qg, kg, vg, window=9)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    assert len(fwd) == 2 and fwd[1]["with_lse"] and len(bwd) == 1
    assert not k1
    torch.testing.assert_close(out.detach(), served, rtol=0, atol=0)

    pinned = tfa.flash_attention(qg, kg, vg, window=9, block_q=64)
    pgrads = torch.autograd.grad(pinned, (qg, kg, vg), do)
    assert len(fwd) == 2 and len(bwd) == 1 and len(k1) == 1
    torch.testing.assert_close(pinned.detach(), served, rtol=0, atol=0)
    for a, b_ in zip(grads, pgrads):
        torch.testing.assert_close(a, b_, rtol=TOL, atol=TOL)


def test_deterministic_mode_keeps_k4b(monkeypatch, k4_wins):
    """K4b sums in a fixed order, so deterministic mode, which moves the
    tiled backward from K3 to K2, keeps the plan's K4b."""
    bwd = _spy(monkeypatch, "flash_attention_mega_bwd")
    q, k, v, do = _mega_tensors(3, requires_grad=True)
    torch.use_deterministic_algorithms(True)
    try:
        torch.autograd.grad(tfa.flash_attention(q, k, v), (q, k, v), do)
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(bwd) == 1


def test_mixed_plan_feeds_k4f_lse_to_the_k3_route(monkeypatch):
    """K4f forward with the tiled backward (a legal plan, as in the
    reference): the backward reads K4f's lse."""
    monkeypatch.setattr(tfa, "attention_plan", lambda *a, **kw: (
        autotune.AttnPlan(mega_fwd=True)))
    fwd = _spy(monkeypatch, "flash_attention_mega_fwd")
    bwd = _spy(monkeypatch, "flash_attention_mega_bwd")
    plain_bwd = _spy(monkeypatch, "flash_attention_bwd_plain")
    q, k, v, do = _mega_tensors(1, requires_grad=True)
    grads = torch.autograd.grad(tfa.flash_attention(q, k, v, 3), (q, k, v),
                                do)
    assert len(fwd) == 1 and not bwd and len(plain_bwd) == 1
    out, lse = tfa.flash_attention_plain(q.detach(), k.detach(), v.detach(),
                                         3, with_lse=True)
    want = tfa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                         out, lse, do, 3)
    for a, b_ in zip(grads, want):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


def test_pinned_config_plans_no_megakernel(monkeypatch, k4_wins):
    """The tile pins ride from the config to the planner
    (``dist/flash.causal_attention``), as the reference's ``_blocks``
    carries them, and a pinned config takes no K4 — in both packages'
    planners."""
    b, s, h, kh, hd = MEGA_SHAPE
    base = dataclasses.replace(tget("smollm-360m").reduced(), head_dim=hd,
                               attn_flash_min_seq=16)
    fwd = _spy(monkeypatch, "flash_attention_mega_fwd")
    q, k, v, _ = (x.transpose(1, 2) for x in _mega_tensors(2))
    for pins, want in (({}, 1), ({"attn_block_q": 8}, 0),
                       ({"attn_block_k": 16}, 0)):
        fwd.clear()
        cfg = dataclasses.replace(base, **pins)
        with torch.no_grad():
            tdist.causal_attention(q, k, v, cfg=cfg)
        assert len(fwd) == want, pins
        ref = jautotune.plan_attention(
            s, s, hd, hd, h // kh, kh, b, 32, True, 0, s,
            backend="interpret", block_q=pins.get("attn_block_q"),
            block_k=pins.get("attn_block_k"))
        if pins:
            assert not (ref.mega_fwd or ref.mega_fwd_bt or ref.mega_bwd
                        or ref.mega_bwd_bt)


# ------------------------------------- (c) the short-sequence model

SHORT = {"attn_flash_min_seq": 32}


def _pair(**over):
    jcfg = dataclasses.replace(jget("smollm-360m").reduced(), **over)
    tcfg = dataclasses.replace(tget("smollm-360m").reduced(), **over)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           device="cpu")
    return jm, jp, TModel(tcfg, device="cpu"), tp


def _reference_takes_k4(cfg, b, s):
    from repro.models.attention import flash_min_seq
    assert s > flash_min_seq(cfg)
    plan = jautotune.plan_attention(
        s, s, cfg.head_dim, cfg.head_dim, cfg.num_heads // cfg.num_kv_heads,
        cfg.num_kv_heads, b, 32, True, cfg.sliding_window, s,
        backend="interpret")
    assert plan.mega_fwd and plan.mega_bwd


def test_short_sequence_model_gradients_match_reference():
    jm, jp, tm, tp = _pair(**SHORT)
    b, s = 2, 64
    _reference_takes_k4(jm.cfg, b, s)
    rng = np.random.RandomState(3)
    toks = rng.randint(0, jm.cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    (jl, _), jg = jax.value_and_grad(jm.train_loss, has_aux=True)(
        jp, {k: jnp.asarray(x) for k, x in batch.items()})
    leaves = [x.requires_grad_() for _p, x in iter_leaves(tp)]
    tl, _ = tm.train_loss(tp, {k: torch.from_numpy(x)
                               for k, x in batch.items()})
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jg)]
    for (path, _x), got, want in zip(iter_leaves(tp), tg, jleaves):
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg=str(path))


def test_short_sequence_model_serving_matches_reference():
    jm, jp, tm, tp = _pair(**SHORT)
    b, s, steps = 2, 64, 3
    _reference_takes_k4(jm.cfg, b, s)
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, jm.cfg.vocab_size, (b, s)).astype(np.int32)
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    tlog, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()})

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)

    close(tlog, jlog)
    for name in ("k", "v"):
        close(tcache["layers"][name], jcache["layers"][name])
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.pad(a, [(0, 0)] * (a.ndim - 2) + [(0, steps), (0, 0)]),
        jcache)
    tcache = tm.alloc_cache(b, s + steps, init=tcache)
    for i in range(steps):
        tok = rng.randint(0, jm.cfg.vocab_size, (b, 1)).astype(np.int32)
        jlog, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok),
                                      jnp.asarray(s + i, jnp.int32))
        tlog, tcache = tm.decode_step(tp, tcache,
                                      torch.from_numpy(tok).long(), s + i)
        close(tlog, jlog)
    for name in ("k", "v"):
        close(tcache["layers"][name], jcache["layers"][name])
