"""The port's MoE layer (``repro_torch.models.moe``) against the no-mesh
``repro.models.moe`` on the same numpy inputs (CPU, fp32): routing (an
exact tie included), the balance loss, expert positions, capacity, the
dispatch / combine autograd Functions against the reference's custom
VJPs (and ``torch.autograd.gradcheck`` in float64), the whole
``moe_ffn`` — output, every aux entry and the gradients — on reduced
arctic-480b (dense residual) and reduced deepseek-v2-236b without MLA
(two shared experts), with and without drops, and the earliest-token-
wins drop order.

Tolerances: the functions 1e-5, the layer 1e-4 (fp32, the same
arithmetic in another summation order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import moe as JM
from repro_torch.configs import get_config as tget
from repro_torch.models import moe as TM
from repro_torch.optim.adamw import iter_leaves

FN_TOL = 1e-5
LAYER_TOL = 1e-4

# reduced MoE configs without MLA: arctic (top-2 + dense residual) and
# deepseek (two shared experts, first layer dense)
ARCHS = {"arctic": ("arctic-480b", {}),
         "deepseek": ("deepseek-v2-236b", {"use_mla": False})}


def _cfgs(name, **over):
    arch, base = ARCHS[name]
    return (dataclasses.replace(jget(arch).reduced(), **base, **over),
            dataclasses.replace(tget(arch).reduced(), **base, **over))


def _torch_tree(tree, grad=False):
    return {k: _torch_tree(v, grad) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)).requires_grad_(grad)
            for k, v in tree.items()}


def _close(got, want, tol=FN_TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------- routing

def _tie_logits():
    """Rows with exact ties among the top choices, and a tie across the
    k-th boundary."""
    return np.array([[1.0, 3.0, 3.0, 0.0],
                     [2.0, 2.0, 2.0, 2.0],
                     [0.5, 4.0, 0.5, 4.0],
                     [5.0, 1.0, 1.0, 1.0],
                     [0.0, 0.0, 7.0, 0.0]], np.float32)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("case", ["random", "tie"])
def test_route_matches_reference(case, k):
    logits = (_tie_logits() if case == "tie"
              else np.random.RandomState(0).randn(64, 8).astype(np.float32))
    jg, ji = JM._route(jnp.asarray(logits), k)
    tg, ti = TM._route(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg)
    if case == "tie":   # of equal probabilities the lower expert first
        np.testing.assert_array_equal(ti[1].numpy(), np.arange(k))
        assert ti[0, :2].tolist() == [1, 2][:k]


def test_load_balance_loss_matches_reference():
    rng = np.random.RandomState(1)
    logits = rng.randn(96, 8).astype(np.float32) * 2
    for k in (1, 2, 6):
        _, ji = JM._route(jnp.asarray(logits), k)
        want = JM.load_balance_loss(jnp.asarray(logits), ji, 8)
        got = TM.load_balance_loss(torch.from_numpy(logits),
                                   torch.from_numpy(np.array(ji)).long(), 8)
        _close(got, want)


@pytest.mark.parametrize("n,e", [(1, 4), (64, 4), (300, 16), (1024, 128)])
def test_expert_positions_match_reference(n, e):
    flat_e = np.random.RandomState(n).randint(0, e, n).astype(np.int32)
    want = np.asarray(JM._expert_positions(jnp.asarray(flat_e), n))
    got = TM._expert_positions(torch.from_numpy(flat_e).long(), n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tokens", [1, 4, 32, 8400, 16384])
@pytest.mark.parametrize("over", [{}, {"capacity_factor": 1.0},
                                  {"num_experts": 32}])
def test_capacity_matches_reference(tokens, over):
    jcfg = dataclasses.replace(jget("arctic-480b"), **over)
    tcfg = dataclasses.replace(tget("arctic-480b"), **over)
    assert TM._capacity(tcfg, tokens) == JM._capacity(jcfg, tokens)


# ------------------------------------------------------- dispatch / combine

def _tables(t, e, k, cap, seed):
    """The reference's routing tables (flat expert, slot, token, weight,
    valid) for random logits, as ``_grouped_experts`` builds them."""
    logits = jax.random.normal(jax.random.PRNGKey(seed), (t, e))
    gates, idx = JM._route(logits, k)
    n = t * k
    flat_e = idx.reshape(n).astype(jnp.int32)
    flat_g = gates.reshape(n)
    tok = jnp.repeat(jnp.arange(t, dtype=jnp.int32), k)
    pos = JM._expert_positions(flat_e, n)
    valid = (pos < cap) & (flat_g > 0)
    safe_e = jnp.where(valid, flat_e, 0).astype(jnp.int32)
    safe_pos = jnp.where(valid, pos, cap).astype(jnp.int32)
    w = (flat_g * valid).astype(jnp.float32)
    return safe_e, safe_pos, tok, w, valid


@pytest.mark.parametrize("t,e,k,cap", [(12, 4, 2, 3), (40, 8, 6, 16),
                                       (33, 4, 1, 5)])
def test_dispatch_combine_match_reference_vjps(t, e, k, cap, monkeypatch):
    monkeypatch.setattr(TM, "CHUNK_ROWS", 7)   # several chunks, ragged
    d = 8
    fe, sp, tok, w, valid = _tables(t, e, k, cap, 7)
    assert not bool(valid.all())               # some pairs dropped
    rng = np.random.RandomState(8)
    x = rng.randn(t, d).astype(np.float32)
    yg = rng.randn(e, cap, d).astype(np.float32)
    co = rng.randn(e, cap, d).astype(np.float32)
    ct = rng.randn(t, d).astype(np.float32)
    te, tp = (torch.from_numpy(np.array(a)).long() for a in (fe, sp))
    tw = torch.from_numpy(np.array(w)).requires_grad_()

    def j_dispatch(xx):
        return JM._dispatch(xx, fe, sp, tok, w, e, cap, "float32", t)

    def j_combine(yy, ww):
        return JM._combine(yy, fe, sp, tok, ww, t)

    tx = torch.from_numpy(x).requires_grad_()
    got = TM._dispatch(tx, te, tp, tw, k, e, cap)
    _close(got, j_dispatch(jnp.asarray(x)))
    (gx,) = torch.autograd.grad((got * torch.from_numpy(co)).sum(), tx)
    _close(gx, jax.grad(lambda xx: jnp.sum(j_dispatch(xx) * co))(
        jnp.asarray(x)))

    tyg = torch.from_numpy(yg).requires_grad_()
    got = TM._combine(tyg, te, tp, tw, k)
    _close(got, j_combine(jnp.asarray(yg), w))
    gy, gw = torch.autograd.grad((got * torch.from_numpy(ct)).sum(),
                                 (tyg, tw))
    jy, jw = jax.grad(lambda yy, ww: jnp.sum(j_combine(yy, ww) * ct),
                      argnums=(0, 1))(jnp.asarray(yg), w)
    _close(gy, jy)
    _close(gw, jw)


def test_dispatch_combine_gradcheck(monkeypatch):
    """float64 numerical gradients of both Functions (the combine's gate
    weights included), over several chunks."""
    monkeypatch.setattr(TM, "CHUNK_ROWS", 5)
    t, e, k, cap, d = 12, 4, 2, 3, 5
    fe, sp, _tok, w, _valid = _tables(t, e, k, cap, 7)
    te, tp = (torch.from_numpy(np.array(a)).long() for a in (fe, sp))
    tw = torch.from_numpy(np.array(w)).double().requires_grad_()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(t, d, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    yg = torch.randn(e, cap, d, generator=gen, dtype=torch.float64,
                     requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda xx: TM._dispatch(xx, te, tp, tw.detach(), k, e, cap), (x,))
    assert torch.autograd.gradcheck(
        lambda yy, ww: TM._combine(yy, te, tp, ww, k), (yg, tw))


# ------------------------------------------------------------------- moe_ffn

@pytest.mark.parametrize("cf", [8.0, 1.0])
@pytest.mark.parametrize("name", ["arctic", "deepseek"])
def test_moe_ffn_matches_reference(name, cf):
    jcfg, tcfg = _cfgs(name, capacity_factor=cf)
    jp = JM.moe_init(jax.random.PRNGKey(0), jcfg)
    x = np.random.RandomState(1).randn(2, 16, jcfg.d_model).astype(np.float32)

    def jloss(p, xx):
        y, a = JM.moe_ffn(p, xx, jcfg)
        return jnp.sum(y ** 2) + 0.01 * a["loss"], (y, a)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    tp = _torch_tree(jax.tree_util.tree_map(np.asarray, jp), grad=True)
    tx = torch.from_numpy(x).requires_grad_()
    ty, taux = TM.moe_ffn(tp, tx, tcfg)
    assert set(taux) == set(jaux)
    for key in jaux:
        _close(taux[key], jaux[key], LAYER_TOL)
    assert float(taux["dropped"]) > 0 if cf == 1.0 else \
        float(taux["dropped"]) == 0
    assert ("shared" in tp) == (name == "deepseek")
    assert ("dense_residual" in tp) == (name == "arctic")
    _close(ty, jy, LAYER_TOL)
    leaves = [v for _p, v in iter_leaves(tp)]
    grads = torch.autograd.grad((ty ** 2).sum() + 0.01 * taux["loss"],
                                leaves + [tx])
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgp)]
    want.append(np.asarray(jgx))
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), w, rtol=LAYER_TOL,
                                   atol=LAYER_TOL * np.abs(w).max())


def test_moe_init_stacks_and_scales():
    """``moe_init(layers=n)`` gives the reference's stacked shapes with the
    banks at scale 1/√fan_in; the parameter dtype is the config's."""
    _jcfg, tcfg = _cfgs("arctic")
    tcfg = dataclasses.replace(tcfg, num_experts=8, param_dtype="bfloat16")
    p = TM.moe_init(torch.Generator().manual_seed(0), tcfg, layers=3)
    d, f, e = tcfg.d_model, tcfg.moe_d_ff, tcfg.num_experts
    assert p["w_gate"].shape == (3, e, d, f) == p["w_up"].shape
    assert p["w_down"].shape == (3, e, f, d)
    assert p["router"].shape == (3, d, e) and p["router"].dtype == torch.float32
    assert p["w_gate"].dtype == torch.bfloat16
    assert p["dense_residual"]["w_gate"].shape == (3, d, tcfg.d_ff)
    for name, fan_in in (("w_gate", d), ("w_down", f)):
        std = p[name].float().std().item()
        assert abs(std * np.sqrt(fan_in) - 1) < 0.05, (name, std)
    one = TM.moe_init(torch.Generator().manual_seed(0), tcfg)
    assert one["w_gate"].shape == (e, d, f)


# --------------------------------------------------------------------- drops

def test_overflow_drops_deterministic_and_earliest_win():
    """With a starved capacity factor, repeated runs give the same bits,
    and the stable sort keeps the earliest tokens' slots."""
    _jcfg, tcfg = _cfgs("deepseek", num_experts=4, experts_per_token=2,
                        capacity_factor=0.25, num_shared_experts=0)
    params = TM.moe_init(torch.Generator().manual_seed(0), tcfg)
    x = torch.randn(2, 32, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    y1, a1 = TM.moe_ffn(params, x, tcfg)
    y2, a2 = TM.moe_ffn(params, x, tcfg)
    assert float(a1["dropped"]) > 0
    assert torch.equal(y1, y2) and float(a1["dropped"]) == float(a2["dropped"])

    t, e, k, cap = 16, 4, 2, 2
    logits = torch.randn(t, e, generator=torch.Generator().manual_seed(3))
    gates, idx = TM._route(logits, k)
    flat_e = idx.reshape(-1)
    pos = TM._expert_positions(flat_e, t * k)
    valid = ((pos < cap) & (gates.reshape(-1) > 0)).numpy()
    fe = flat_e.numpy()
    for ex in range(e):
        rows = np.where(fe == ex)[0]           # already in token order
        assert set(rows[valid[rows]].tolist()) == set(rows[:cap].tolist())
