"""Data parallelism as the reference runs it, on the CPU, with 4 gloo rank
processes: MoE's global-view dispatch under a "dp" batch split
(``models.moe._global_positions``) and FSDP gradients reduce-scattered
into the shard (``dist.sharding._GatherParam``).

One rank group runs every case (``_rank_cases``), started through
``launch.mesh.spawn`` inside a subprocess with a timeout, as
``tests/test_torch_dist.py`` does.  The oracle is the reference's
no-mesh step or prefill on the same numpy inputs.  Every MoE case lowers
``capacity_factor`` to 0.5, so that the reference's no-mesh step drops
pairs (asserted): only then do slots over the whole batch differ from
slots over a rank's own tokens.

* (a) a train step of reduced arctic-480b on a (4, 1) ("data", "model")
  mesh (no "model" axis: plain data parallelism with FSDP);
* (b) a train step of reduced deepseek-v2-236b (no MLA, int8 moments)
  under ``pure_dp`` on (2, 2);
* (c) a train step of reduced deepseek-v2-236b with 3 experts on (2, 2):
  "model" does not divide them, so each rank routes its stripe of the
  sequence of its rows;
* (d) a prefill of the same 3-expert model on (1, 4): no batch split,
  the stream on its stripe;

  ce_loss 1e-3, parameters 3e-4, logits 2e-4 (``test_torch_dist.py``'s
  limits); ``dropped`` equal, and ``routed`` equal (the train steps'
  overflow rate, dropped / routed in fp32, equal; the prefill's per-layer
  counts recorded on both sides).
* ``_global_positions`` on each rank's block against the slice of
  ``_expert_positions`` over the whole batch, for a (4, 1) row split, a
  (2, 2) row and stripe split and a ``pure_dp`` split; with no split it
  is ``_expert_positions``, bit for bit.
* The gradient of a gathered FSDP leaf on (2, 2) and on a live ("pod",
  "data", "model") mesh of (2, 2, 1): the reduce-scatter's shard equals
  the old all-reduce-then-cut to fp32 rounding; on a (2, 2, 2)
  ``MeshLayout`` the layout pass counts one reduce-scatter over "pod"
  and one over "data", and no all-reduce.
* A train step of reduced llama3.2-3b on (2, 2): ``TRAFFIC`` has one
  ``reduce_scatter/data`` per leaf gathered over "data", of twice the
  gather's bytes, and no all-reduce over "data" carries such a leaf's
  gradient.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_dist import _params_close, _params_np, _tokens

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = 4
GROUP_TIMEOUT_S = 240
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=50)
DROPS = {"capacity_factor": 0.5}
DEEPSEEK = {"use_mla": False, **DROPS}
E3 = {**DEEPSEEK, "num_experts": 3}
STEP_CASES = {  # name: (arch, config overrides, "model" axis, pure_dp, B, S)
    "arctic_data4": ("arctic-480b", DROPS, 1, False, 8, 16),
    "deepseek_pure_dp": ("deepseek-v2-236b", DEEPSEEK, 2, True, 8, 16),
    "deepseek_e3": ("deepseek-v2-236b", E3, 2, False, 4, 32),
}
PREFILL = ("deepseek-v2-236b", E3, 4, 2, 32)   # arch, overrides, m, B, S
# (mesh "model" axis, pure_dp, the split: (dp axes, stripe)) of the
# position cases
POSITION_CASES = {"rows": (1, False, (("data",), False)),
                  "rows_and_stripe": (2, False, (("data",), True)),
                  "pure_dp": (2, True, (("data", "model"), False))}
POS_B, POS_S, POS_K, POS_E = 8, 12, 3, 5


# -------------------------------------------------------- the rank group

def _moe_aux_record():
    """Wraps ``blocks.moe_ffn`` to record each call's (dropped, routed);
    returns the list and an undo."""
    from repro_torch.models import blocks
    rec, real = [], blocks.moe_ffn

    def wrap(*args):
        y, aux = real(*args)
        rec.append((float(aux["dropped"]), float(aux["routed"])))
        return y, aux

    blocks.moe_ffn = wrap
    return rec, lambda: setattr(blocks, "moe_ffn", real)


def _mesh(model, names=("data", "model")):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size()
    shape = (n // model, model) if len(names) == 2 else (2, 2, 1)
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def _positions_cases(rank):
    """Each position case's (rank's global positions, rank's slice of the
    whole batch's positions)."""
    from repro_torch.dist.sharding import chunk_of, use_mesh
    from repro_torch.models.moe import _expert_positions, _global_positions
    g = torch.Generator().manual_seed(7)
    idx = torch.stack([torch.randperm(POS_E, generator=g)[:POS_K]
                       for _ in range(POS_B * POS_S)]).view(POS_B, POS_S,
                                                            POS_K)
    n = idx.numel()
    whole = _expert_positions(idx.reshape(n), n).view(POS_B, POS_S, POS_K)
    out = {}
    for name, (m, pure, (dp, stripe)) in POSITION_CASES.items():
        mesh = _mesh(m)
        with use_mesh(mesh, pure_dp=pure) as ctx:
            mine, want = idx, whole
            for dim, axes in ((0, dp), (1, "model" if stripe else ())):
                if axes:
                    mine = chunk_of(mine, dim, axes, ctx)
                    want = chunk_of(want, dim, axes, ctx)
            local, glob = _global_positions(mine.contiguous(), POS_E, dp,
                                            stripe, ctx)
        out[name] = (glob.view(want.shape).numpy(), want.numpy(),
                     local.numpy())
    return out


def _grad_cases(rank):
    """The shard gradient of ``gather_param`` under a batch split, and the
    old all-reduce-then-cut of the same gradients, on (2, 2) with spec
    ("data", None) and on (2, 2, 1) with spec (("pod", "data"), None)."""
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import (all_reduce, batch_split, chunk_of,
                                           gather_param, use_mesh)
    out = {}
    for name, mesh, spec, dp in (
            ("data", _mesh(2), ("data", None), ("data",)),
            ("pod_data", _mesh(1, ("pod", "data", "model")),
             (("pod", "data"), None), ("pod", "data"))):
        full = torch.randn((8, 6), generator=torch.Generator().manual_seed(3))
        dy = torch.randn((8, 6),
                         generator=torch.Generator().manual_seed(10 + rank))
        with use_mesh(mesh) as ctx:
            shard = chunk_of(full, 0, spec[0], ctx).clone().requires_grad_()
            sharding.reset_traffic()
            with batch_split(dp) as sctx:
                (gather_param(shard, spec, sctx) * dy).sum().backward()
            traffic = {k: v[:2] for k, v in sharding.TRAFFIC.items()}
            old = chunk_of(all_reduce(dy.clone(), dp, ctx), 0, spec[0], ctx)
        out[name] = (shard.grad.numpy(), old.numpy(), traffic)
    return out


def _llama_traffic(rank):
    """A train step of reduced llama on (2, 2): TRAFFIC, each gathered
    leaf's spec and gathered shape, and the shapes all-reduced over
    "data"."""
    import repro_torch.models.model as model_mod
    from repro_torch.configs import get_config
    from repro_torch.convert import place_state
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.steps import make_train_step
    cfg = get_config("llama3.2-3b").reduced()
    model = LanguageModel(cfg, device="cpu")
    oc = OptimizerConfig(**OPT)
    batch = {k: torch.from_numpy(v)
             for k, v in _tokens(cfg.vocab_size, 4, 32, 5).items()}
    p = model.init(torch.Generator().manual_seed(0))
    mesh = _mesh(2)
    state = place_state({"params": p, "opt": init_opt_state(p, oc)}, mesh)
    gathered, reduced = [], []
    real_gather, real_reduce = model_mod.gather_param, sharding.all_reduce

    def gather(x, spec, ctx=None):
        y = real_gather(x, spec, ctx)
        gathered.append((tuple(spec), tuple(y.shape)))
        return y

    def reduce(x, axes, ctx, op="sum"):
        if "data" in sharding._entry_axes(axes):
            reduced.append(tuple(x.shape))
        return real_reduce(x, axes, ctx, op)

    model_mod.gather_param, sharding.all_reduce = gather, reduce
    try:
        sharding.reset_traffic()
        with use_mesh(mesh):
            make_train_step(model, oc)(state, batch)
        traffic = {k: v[:2] for k, v in sharding.TRAFFIC.items()}
    finally:
        model_mod.gather_param, sharding.all_reduce = real_gather, real_reduce
    return {"traffic": traffic, "gathered": gathered, "reduced": reduced}


def _step_case(name, inp):
    from repro_torch.configs import get_config
    from repro_torch.optim import OptimizerConfig
    from test_torch_dist import _step_on_mesh
    arch, over, m, pure, _b, _s = STEP_CASES[name]
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    oc = OptimizerConfig(state_dtype=cfg.optimizer_state_dtype, **OPT)
    try:
        return _step_on_mesh(cfg, inp["params"], inp["batch"], oc, _mesh(m),
                             pure)
    except NotImplementedError as e:
        return ("refused", str(e))


def _prefill_case(inp):
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.models.model import LanguageModel
    arch, over, m, _b, _s = PREFILL
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    model = LanguageModel(cfg, device="cpu")
    params = params_from_numpy(inp["params"], cfg, device="cpu")
    rec, undo = _moe_aux_record()
    try:
        with use_mesh(_mesh(m)):
            logits, _cache = model.prefill(
                params, {"tokens": torch.from_numpy(inp["tokens"])})
    finally:
        undo()
    return logits.numpy(), rec


def _rank_cases(rank, world, path):
    inp = torch.load(os.path.join(path, "inputs.pt"), weights_only=False)
    out = {"positions": _positions_cases(rank), "grads": _grad_cases(rank),
           "llama_traffic": _llama_traffic(rank)}
    for name in STEP_CASES:
        out["step_" + name] = _step_case(name, inp["steps"][name])
    out["prefill"] = _prefill_case(inp["prefill"])
    return out


def _group_main(path):
    from repro_torch.launch.mesh import spawn
    results = spawn(_rank_cases, RANKS, backend="gloo",
                    devices=["cpu"] * RANKS, args=(path,), timeout_s=120)
    torch.save(results, os.path.join(path, "results.pt"))


# ------------------------------------------------------------- the oracle

def _inputs():
    from repro_torch.configs import get_config
    inp = {"steps": {}}
    for i, (name, (arch, over, _m, _p, b, s)) in enumerate(
            STEP_CASES.items()):
        cfg = get_config(arch).reduced()
        inp["steps"][name] = {"params": _params_np(arch, over),
                              "batch": _tokens(cfg.vocab_size, b, s, 70 + i)}
    arch, over, _m, b, s = PREFILL
    rng = np.random.RandomState(80)
    inp["prefill"] = {"params": _params_np(arch, over),
                      "tokens": rng.randint(0, 512, (b, s)).astype(np.int32)}
    return inp


def _reference(inp):
    """The reference's no-mesh train steps and prefill; the prefill's
    (dropped, routed) per MoE layer recorded through a debug callback."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import blocks as jblocks
    from repro.models.model import LanguageModel as JModel
    from repro.optim import OptimizerConfig as JOpt
    from repro.optim import init_opt_state as jinit
    from repro.train.steps import make_train_step as jstep
    ref = {}
    for name, (arch, over, _m, _p, _b, _s) in STEP_CASES.items():
        cfg = dataclasses.replace(jget(arch).reduced(), **over)
        jp = jax.tree_util.tree_map(jnp.asarray, inp["steps"][name]["params"])
        joc = JOpt(state_dtype=cfg.optimizer_state_dtype, **OPT)
        batch = {k: jnp.asarray(v)
                 for k, v in inp["steps"][name]["batch"].items()}
        state, met = jax.jit(jstep(JModel(cfg), joc))(
            {"params": jp, "opt": jinit(jp, joc)}, batch)
        ref["step_" + name] = ({k: float(v) for k, v in met.items()},
                               jax.tree_util.tree_map(np.asarray,
                                                      state["params"]))
    arch, over, _m, _b, _s = PREFILL
    cfg = dataclasses.replace(jget(arch).reduced(), **over)
    rec, real = [], jblocks.moe_ffn

    def wrap(p, h, c):
        y, aux = real(p, h, c)
        jax.debug.callback(lambda d, r: rec.append((float(d), float(r))),
                           aux["dropped"], aux["routed"])
        return y, aux

    jblocks.moe_ffn = wrap
    try:
        jp = jax.tree_util.tree_map(jnp.asarray, inp["prefill"]["params"])
        logits, _cache = jax.jit(JModel(cfg).prefill)(
            jp, {"tokens": jnp.asarray(inp["prefill"]["tokens"])})
        logits = np.asarray(logits)
    finally:
        jblocks.moe_ffn = real
    ref["prefill"] = (logits, rec)
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    inp = _inputs()
    torch.save(inp, tmp / "inputs.pt")
    code = ("import sys; sys.path[:0] = ['src', 'tests']; "
            "import test_torch_dp as T; T._group_main(sys.argv[1])")
    # the rank group runs while the reference computes
    proc = subprocess.Popen([sys.executable, "-c", code, str(tmp)],
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH="src"))
    try:
        ref = _reference(inp)
        out, err = proc.communicate(timeout=GROUP_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, (out[-2000:], err[-4000:])
    return torch.load(tmp / "results.pt", weights_only=False), ref


# ----------------------------------------------------------------- tests

@pytest.mark.parametrize("case", list(STEP_CASES))
def test_moe_train_step_under_dp_matches_reference(runs, case):
    results, ref = runs
    want_m, want_p = ref["step_" + case]
    assert want_m["moe_dropped_tokens"] > 0, want_m
    for r in results:
        got = r["step_" + case]
        assert got[0] != "refused", got
        got_m, got_p = got
        assert abs(got_m["ce_loss"] - want_m["ce_loss"]) < 1e-3
        assert got_m["moe_dropped_tokens"] == want_m["moe_dropped_tokens"]
        # dropped / routed in fp32 on both sides: routed equal
        assert got_m["moe_overflow_rate"] == want_m["moe_overflow_rate"]
        _params_close(got_p, want_p)


def test_moe_prefill_on_stripes_matches_reference(runs):
    results, ref = runs
    want_logits, want_aux = ref["prefill"]
    assert want_aux and all(d > 0 for d, _r in want_aux), want_aux
    for r in results:
        logits, aux = r["prefill"]
        np.testing.assert_allclose(logits, want_logits, atol=2e-4, rtol=2e-4)
        assert aux == want_aux


@pytest.mark.parametrize("case", list(POSITION_CASES))
def test_global_positions_are_the_whole_batch_positions(runs, case):
    """Each rank's global positions are its slice of the positions over
    the whole batch; its local ones are a rank within its own pairs."""
    results, _ref = runs
    for r in results:
        got, want, local = r["positions"][case]
        assert np.array_equal(got, want)
        assert (local.reshape(-1) <= got.reshape(-1)).all()


def test_global_positions_without_a_split_are_expert_positions():
    from repro_torch.models.moe import _expert_positions, _global_positions
    g = torch.Generator().manual_seed(4)
    idx = torch.randint(0, 6, (3, 20, 2), generator=g)
    n = idx.numel()
    local, glob = _global_positions(idx, 6)
    want = _expert_positions(idx.reshape(n), n)
    assert torch.equal(local, want) and torch.equal(glob, want)


@pytest.mark.parametrize("mesh", ["data", "pod_data"])
def test_fsdp_gradient_reduce_scattered_equals_all_reduce_then_cut(runs,
                                                                   mesh):
    results, _ref = runs
    for r in results:
        got, old, traffic = r["grads"][mesh]
        np.testing.assert_allclose(got, old, rtol=1e-6, atol=1e-6)
        assert not any(k.startswith("all_reduce/") for k in traffic), traffic
        for a in mesh.split("_"):
            assert "reduce_scatter/" + a in traffic, traffic


def test_fsdp_gradient_on_a_three_axis_layout():
    """The layout pass of one gathered leaf sharded over ("pod", "data")
    on (2, 2, 2): a reduce-scatter over "pod" of the whole gradient, one
    over "data" of its half, no all-reduce."""
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import (MeshLayout, batch_split,
                                           gather_param, use_mesh)
    layout = MeshLayout((2, 2, 2), ("pod", "data", "model"))
    shard = torch.empty((2, 6), device="meta", requires_grad=True)
    with use_mesh(layout, rank=5):
        sharding.reset_traffic()
        with batch_split(("pod", "data")) as sctx:
            y = gather_param(shard, (("pod", "data"), None), sctx)
            assert y.shape == (8, 6)
            (grad,) = torch.autograd.grad(y, shard, torch.empty_like(y))
    assert grad.shape == (2, 6)
    assert {k: v[:2] for k, v in sharding.TRAFFIC.items()} == {
        "param_gather/data": [1, 2 * 6 * 4], "param_gather/pod": [1, 4 * 6 * 4],
        "reduce_scatter/pod": [1, 8 * 6 * 4],
        "reduce_scatter/data": [1, 4 * 6 * 4]}


def test_train_step_traffic_reduce_scatters_fsdp_leaves(runs):
    results, _ref = runs
    for r in results:
        t = r["llama_traffic"]
        traffic = t["traffic"]
        fsdp = [shape for spec, shape in t["gathered"]
                if any("data" in ((e,) if isinstance(e, str) else e or ())
                       for e in spec)]
        assert fsdp, t["gathered"]
        assert traffic["reduce_scatter/data"] == [
            len(fsdp), 2 * traffic["param_gather/data"][1]], traffic
        assert not set(fsdp) & set(t["reduced"]), (fsdp, t["reduced"])


def test_launch_train_moe_data_parallel_on_cpu():
    """``launch.train --ranks 2 --tp 1``: reduced arctic on (2, 1), each
    rank one row of each of its 4 micro-batches of 2."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--arch", "arctic-480b", "--device", "cpu", "--ranks", "2", "--tp",
         "1", "--backend", "gloo", "--steps", "2", "--batch", "8", "--seq",
         "32"], cwd=ROOT, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH="src"))
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    out = proc.stdout
    assert "mesh=data2xmodel1" in out, out
    assert out.count("  step ") >= 2, out
