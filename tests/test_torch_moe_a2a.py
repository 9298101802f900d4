"""The port's MoE mesh branches (``repro_torch.models.moe``) against the
no-mesh ``moe_ffn`` of both packages, on the CPU, with 4 gloo rank
processes on a (2, 2) ("data", "model") mesh.

The sharded reference is red on this tree (its ``constrain`` raises under
jax 0.9's explicit mesh axes), so, as the reference's own oracle test
intends (``tests/test_moe_a2a.py``), both dispatches are held against
the single-device oracle: reduced deepseek-v2-236b with 8 experts and
top 2 (capacity factor 8: no drops), y within 2e-4, the loss within rtol
1e-5, every gradient within 5e-3, ``dropped`` 0, and ``a2a_bytes`` > 0
on the a2a path only.  Also: the exchange's backward is the reverse
exchange, and the a2a path with drops (capacity factor 0.5) gives the
same bits twice.  One rank group runs every case, inside
``subprocess.run(..., timeout=...)``.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = 4
GROUP_TIMEOUT_S = 300
OVER = dict(num_experts=8, experts_per_token=2)


def _cfg(get_config, **over):
    return dataclasses.replace(get_config("deepseek-v2-236b").reduced(),
                               **OVER, **over)


def _inputs():
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = _cfg(get_config)
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = np.random.RandomState(1).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    return {k: _np(v) for k, v in params.items()}, x


def _np(v):
    return {k: _np(w) for k, w in v.items()} if isinstance(v, dict) \
        else v.numpy()


def _t(v):
    return {k: _t(w) for k, w in v.items()} if isinstance(v, dict) \
        else torch.from_numpy(v)


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _loss_and_grads(moe, params_np, x_np, cfg):
    params = _t(params_np)
    leaves = [v.requires_grad_() for _p, v in _leaves(params)]
    y, aux = moe.moe_ffn(params, torch.from_numpy(x_np), cfg)
    loss = (y ** 2).sum() + 0.01 * aux["loss"]
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss.detach()), y.detach().numpy(),
            {k: float(v) for k, v in aux.items()},
            [g.numpy() for g in grads])


def _rank_cases(rank, world, path):
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    params_np, x_np = torch.load(os.path.join(path, "inputs.pt"),
                                 weights_only=False)
    mesh = make_host_mesh(model=2)
    out = {}
    for dispatch in ("a2a", "psum"):
        with use_mesh(mesh):
            out[dispatch] = _loss_and_grads(
                moe, params_np, x_np, _cfg(get_config, moe_dispatch=dispatch))
    # the exchange's transpose: <exchange(a), b> == <a, exchange(b)>
    gen = torch.Generator().manual_seed(7 + rank)
    a = torch.randn(2, 3, 5, generator=gen, requires_grad=True)
    b = torch.randn(2, 3, 5, generator=gen)
    with use_mesh(mesh):
        ea = moe._exchange(a)
        (ga,) = torch.autograd.grad((ea * b).sum(), a)
        eb = moe._exchange(b)
    out["exchange"] = (a.detach().numpy(), b.numpy(), ea.detach().numpy(),
                       ga.numpy(), eb.numpy())
    # drops under the mesh: two calls, the same bits
    cfg = _cfg(get_config, capacity_factor=0.5, num_shared_experts=0)
    params = _t(params_np)
    params.pop("shared", None)
    with use_mesh(mesh):
        runs = [moe.moe_ffn(params, torch.from_numpy(x_np), cfg)
                for _ in range(2)]
    out["drops"] = [(y.numpy(), float(a_["dropped"])) for y, a_ in runs]
    return out


def _group_main(path):
    from repro_torch.launch.mesh import spawn
    results = spawn(_rank_cases, RANKS, backend="gloo",
                    devices=["cpu"] * RANKS, args=(path,), timeout_s=120)
    torch.save(results, os.path.join(path, "results.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import moe as jmoe
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    tmp = tmp_path_factory.mktemp("moe_mesh")
    params_np, x_np = _inputs()
    torch.save((params_np, x_np), tmp / "inputs.pt")

    jcfg = _cfg(jget)

    def jloss(p, xx):
        y, a = jmoe.moe_ffn(p, xx, jcfg)
        return jnp.sum(y ** 2) + 0.01 * a["loss"], (y, a)
    (jl, (jy, ja)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params_np), jnp.asarray(x_np))
    reference = (float(jl), np.asarray(jy),
                 {k: float(v) for k, v in ja.items()},
                 [np.asarray(g) for _p, g in _leaves(jg)])
    port = _loss_and_grads(moe, params_np, x_np, _cfg(get_config))

    code = ("import sys; sys.path[:0] = ['src', 'tests']; "
            "import test_torch_moe_a2a as T; T._group_main(sys.argv[1])")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp)], cwd=ROOT,
                          capture_output=True, text=True,
                          timeout=GROUP_TIMEOUT_S,
                          env=dict(os.environ, PYTHONPATH="src"))
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    results = torch.load(tmp / "results.pt", weights_only=False)
    return results, {"reference": reference, "port": port}


@pytest.mark.parametrize("oracle", ["reference", "port"])
@pytest.mark.parametrize("dispatch", ["a2a", "psum"])
def test_dispatch_on_mesh_matches_no_mesh_oracle(runs, dispatch, oracle):
    results, oracles = runs
    o_loss, o_y, o_aux, o_grads = oracles[oracle]
    assert o_aux["dropped"] == 0.0
    for r in results:
        loss, y, aux, grads = r[dispatch]
        np.testing.assert_allclose(y, o_y, atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(loss, o_loss, rtol=1e-5)
        assert aux["dropped"] == 0.0
        assert abs(aux["loss"] - o_aux["loss"]) < 1e-5
        assert (aux["a2a_bytes"] > 0) == (dispatch == "a2a")
        assert len(grads) == len(o_grads)
        for g, og in zip(grads, o_grads):
            np.testing.assert_allclose(g, og, atol=5e-3, rtol=5e-3)


def test_exchange_backward_is_the_reverse_exchange(runs):
    results, _ = runs
    # ranks (d, 0) and (d, 1) exchange over "model": block j goes to peer j
    for d in (0, 1):
        r0, r1 = results[2 * d]["exchange"], results[2 * d + 1]["exchange"]
        (a0, b0, ea0, ga0, eb0), (a1, b1, ea1, ga1, eb1) = r0, r1
        np.testing.assert_array_equal(ea0, np.stack([a0[0], a1[0]]))
        np.testing.assert_array_equal(ea1, np.stack([a0[1], a1[1]]))
        # the gradient of <exchange(a), b> is exchange(b)
        np.testing.assert_array_equal(ga0, eb0)
        np.testing.assert_array_equal(ga1, eb1)


def test_a2a_with_drops_gives_the_same_bits_twice(runs):
    results, _ = runs
    for r in results:
        (y1, d1), (y2, d2) = r["drops"]
        assert d1 > 0
        assert d1 == d2
        np.testing.assert_array_equal(y1, y2)
