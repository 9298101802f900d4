"""The port's §6 sharded checkpoints against the JAX package, on the CPU.

One group of 4 gloo rank processes on a (2, 2) ("data", "model") mesh
runs every rank case (``_rank_cases``), started through
``launch.mesh.spawn`` inside a subprocess with a timeout, as
``tests/test_torch_dist.py`` does.  Beside it one subprocess runs the
reference with 8 forced host devices (``_jax_main``, as
``tests/test_ckpt.py`` does): it saves the tree of ``tests/test_ckpt.py``
under a 4-device (2, 2) and an 8-device (2, 4) ``Mesh``, then waits for
the ranks' save and restores it.  The two exchange checkpoints through
marker files in the shared temporary directory.  Cases:

* the port's (2, 2) save writes the reference's ``manifest.json`` and
  leaf bytes; the reference restores it bit-exact with no shardings and
  on its (1, 2), (1, 1) and ``pure_dp`` meshes;
* the port restores the reference's (2, 4) save onto the (2, 2) mesh
  (each rank ``shard_of`` the whole leaf, bit for bit) and on one rank;
* the save gathers nothing (``full_tensor`` / ``gather_param`` patched
  to raise; ``host_gathers`` 0), its counts are the reference's, an
  identical second save writes nothing, ``crash_at`` commits nothing;
* ``io_cost`` equals the reference's for the (2, 4) and (2, 2) layouts;
* ``Trainer(mesh=)`` fail-stop restarts (synchronous and asynchronous
  saves) on reduced smollm end bit-equal to the uninterrupted mesh run,
  from a restored state bit-equal to the saved one; a restart with no
  mesh ends within the dist tests' 3e-4;
* a state trained one step under tensor parallelism on the (2, 2) mesh
  (reduced llama3.2-3b: each rank computing its heads, hidden units and
  vocab rows) saves sharded, restores on one device with no mesh, and
  matches the no-mesh step within the dist tests' 3e-4;
* ``launch.train --tp 2 --ckpt-dir`` resumes at the saved step.
"""
import os
import pathlib
import pickle
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = 4
GROUP_TIMEOUT_S = 300
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=50)
STAT_KEYS = ("chunks_total", "chunks_written", "chunks_skipped",
             "bytes_written", "io_write_ops", "io_coalesced_writes")
JAX_MESHES = ("none", "1x2", "1x1", "pure_dp")
LAYOUTS = {"2x4": (2, 4), "2x2": (2, 2)}


def _tree(seed=0):
    """The tree of ``tests/test_ckpt.py``'s sharded-save test."""
    rng = np.random.default_rng(seed)
    return {"params": {
        "w_q": rng.normal(size=(32, 8, 16)).astype(np.float32),
        "w_down": rng.normal(size=(64, 32)).astype(np.float32),
        "norm": rng.normal(size=(32,)).astype(np.float32)},
        "opt": {"step": np.asarray(11 + seed, np.int32)}}


def _wait_for(path, timeout_s=240.0):
    end = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.1)


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _tree_np(tree):
    return {"/".join(p): _np(v).copy() for p, v in _leaves(tree)}


# ------------------------------------------------------------ the reference

def _jax_main(tmp):
    """The reference in 8 forced host devices: its (2, 2) and (2, 4)
    saves and its cost model, then its restores of the ranks' save."""
    import jax
    from jax.sharding import Mesh
    from repro import ckpt
    from repro.dist.sharding import ShardCtx, param_shardings
    tree = _tree()
    shapes = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), tree)
    devs = np.array(jax.devices())
    mesh22 = Mesh(devs[:4].reshape(2, 2), ("data", "model"))
    mesh24 = Mesh(devs.reshape(2, 4), ("data", "model"))
    sh22 = param_shardings(shapes, ShardCtx(mesh=mesh22))
    sh24 = param_shardings(shapes, ShardCtx(mesh=mesh24))
    out = {"io_cost": {"2x2": ckpt.io_cost(shapes, sh22),
                       "2x4": ckpt.io_cost(shapes, sh24)}}

    def put(t, sh):
        return jax.tree_util.tree_map(jax.device_put, t, sh)
    d22 = os.path.join(tmp, "ref22")
    out["save"] = ckpt.save(d22, put(tree, sh22), 1, num_writers=4).snapshot()
    out["save_again"] = ckpt.save(d22, put(tree, sh22), 2,
                                  num_writers=4).snapshot()
    ckpt.save(os.path.join(tmp, "ref24"), put(tree, sh24), 1, num_writers=8)
    dc = os.path.join(tmp, "ref_crash")
    ckpt.save(dc, put(_tree(3), sh22), 1, num_writers=4)
    out["crash"] = ckpt.save(dc, put(_tree(4), sh22), 2, num_writers=4,
                             crash_at=0.5).snapshot()
    open(os.path.join(tmp, "jax_saved"), "w").close()

    _wait_for(os.path.join(tmp, "port_saved"))
    mesh12 = Mesh(devs[:2].reshape(1, 2), ("data", "model"))
    mesh11 = Mesh(devs[:1].reshape(1, 1), ("data", "model"))
    targets = {"none": None,
               "1x2": param_shardings(shapes, ShardCtx(mesh=mesh12)),
               "1x1": param_shardings(shapes, ShardCtx(mesh=mesh11)),
               "pure_dp": param_shardings(shapes, ShardCtx(mesh=mesh12,
                                                           pure_dp=True))}
    out["restored"] = {}
    for name, sh in targets.items():
        got, step = ckpt.restore(os.path.join(tmp, "port22"), 1,
                                 shardings=sh)
        out["restored"][name] = (step, _tree_np(got))
    with open(os.path.join(tmp, "jax.pkl"), "wb") as f:
        pickle.dump(out, f)


# -------------------------------------------------------------- the ranks

class _Spy:
    """Wraps ``ckpt.save``: records each step's state as written (numpy
    copies) and makes every leaf gather raise while a save runs."""

    def __init__(self):
        from repro_torch import ckpt
        from repro_torch.ckpt import checkpoint
        from repro_torch.dist import sharding
        self.saved = {}
        self.real = checkpoint.save

        def refuse(*a, **k):
            raise AssertionError("a sharded save gathered a leaf")

        def save(ckpt_dir, state, step, **kw):
            self.saved[step] = _tree_np(state)
            keep = {n: getattr(sharding, n) for n in
                    ("full_tensor", "gather_param", "all_gather")}
            for n in keep:
                setattr(sharding, n, refuse)
            try:
                return self.real(ckpt_dir, state, step, **kw)
            finally:
                for n, f in keep.items():
                    setattr(sharding, n, f)
        checkpoint.save = ckpt.save = save


def _gathered_params(state, cfg, mesh):
    from repro_torch.dist.sharding import (full_tensor, param_shardings,
                                           use_mesh)
    from repro_torch.models.model import param_shapes
    with use_mesh(mesh) as ctx:
        sh = param_shardings(param_shapes(cfg), ctx)
        return {"/".join(p): full_tensor(v, _at(sh, p).spec, ctx).numpy()
                for p, v in _leaves(state["params"])}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _trainer_cases(rank, tmp, mesh, spy):
    """Fail-stop restarts under the mesh, synchronous and asynchronous,
    against the uninterrupted mesh run."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    import torch.distributed as dist
    cfg = get_config("smollm-360m").reduced()
    data = SyntheticTokens(cfg.vocab_size, batch=4, seq=32, seed=3)

    def trainer(**kw):
        return Trainer(LanguageModel(cfg, device="cpu"),
                       OptimizerConfig(**OPT), data, TrainerConfig(**kw),
                       mesh=mesh)

    def fresh(tr):
        return tr.init_or_restore(torch.Generator().manual_seed(0))

    tr = trainer()
    out = {"uninterrupted": _gathered_params(tr.run(fresh(tr), 4), cfg,
                                             mesh)}
    for mode in ("sync", "async"):
        d = os.path.join(tmp, f"trainer_{mode}")
        tc = dict(ckpt_dir=d, ckpt_every=2, async_ckpt=mode == "async")
        spy.saved.clear()
        tr = trainer(fail_at_step=3, **tc)
        tr.run(fresh(tr), 4)
        saved = dict(spy.saved)
        if rank == 0:                  # the no-mesh restart's own copy
            shutil.copytree(os.path.join(d, "step_2"),
                            os.path.join(tmp, f"nomesh_{mode}", "step_2"))
        dist.barrier()
        tr2 = trainer(**tc)
        state = fresh(tr2)
        restored_equal = _tree_np(state).keys() == saved[2].keys() and all(
            np.array_equal(v, saved[2][k]) for k, v in _tree_np(state).items())
        final = tr2.run(state, 4 - tr2.start_step)
        out[mode] = {"start": tr2.start_step,
                     "fail_steps": [h["step"] for h in tr.history],
                     "steps": [h["step"] for h in tr2.history],
                     "saved_steps": sorted(saved),
                     "saves": [(e["step"], e["stats"].committed,
                                e["stats"].host_gathers) for e in tr.saves],
                     "restored_equal": restored_equal,
                     "final": _gathered_params(final, cfg, mesh)}
    return out


def _tp_step(mesh=None):
    """One train step of reduced llama3.2-3b from seeded weights, under
    ``mesh`` (the rank's shards) or on one device: (cfg, oc, state)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import place_state
    from repro_torch.data import SyntheticTokens
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    cfg = get_config("llama3.2-3b").reduced()
    oc = OptimizerConfig(**OPT)
    model = LanguageModel(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(7), oc)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticTokens(
        cfg.vocab_size, batch=4, seq=32, seed=8).get(0).items()}
    if mesh is None:
        return cfg, oc, make_train_step(model, oc)(state, batch)[0]
    state = place_state(state, mesh)
    with use_mesh(mesh):
        return cfg, oc, make_train_step(model, oc)(state, batch)[0]


def _rank_cases(rank, world, tmp):
    from repro_torch import ckpt
    from repro_torch.dist.sharding import (ShardCtx, param_shardings,
                                           shard_tree)
    from repro_torch.launch.mesh import make_host_mesh
    import torch.distributed as dist
    mesh = make_host_mesh(model=2)
    spy = _Spy()

    def local(tree):
        sh = param_shardings(tree, ShardCtx(mesh))
        return shard_tree({k: {n: torch.from_numpy(a) for n, a in v.items()}
                           for k, v in tree.items()}, sh, rank), sh

    mine, sh = local(_tree())
    d = os.path.join(tmp, "port22")
    out = {"save": ckpt.save(d, mine, 1, num_writers=4,
                             shardings=sh).snapshot()}
    if rank == 0:
        open(os.path.join(tmp, "port_saved"), "w").close()
    out["save_again"] = ckpt.save(d, mine, 2, num_writers=4,
                                  shardings=sh).snapshot()
    got, step = ckpt.restore(d, 1, shardings=sh, device="cpu")
    out["own"] = (step, _tree_np(got), _tree_np(mine))

    dc = os.path.join(tmp, "port_crash")
    first, _sh = local(_tree(3))
    ckpt.save(dc, first, 1, num_writers=4, shardings=sh)
    out["crash"] = ckpt.save(dc, local(_tree(4))[0], 2, num_writers=4,
                             shardings=sh, crash_at=0.5).snapshot()
    dist.barrier()
    got, step = ckpt.restore(dc, shardings=sh, device="cpu")
    out["crash_after"] = (ckpt.latest_step(dc),
                          os.path.isdir(os.path.join(dc, "step_2.tmp")),
                          os.path.exists(os.path.join(dc, "step_2.tmp",
                                                      "manifest.json")),
                          step, _tree_np(got), _tree_np(first))

    bf16 = {"params": {"w_q": mine["params"]["w_q"].bfloat16()}}
    try:
        spy.real(os.path.join(tmp, "bf16"), bf16, 1,
                 shardings={"params": {"w_q": sh["params"]["w_q"]}})
        out["bf16"] = "saved"
    except TypeError as e:
        out["bf16"] = str(e)

    _wait_for(os.path.join(tmp, "jax_saved"))
    got, step = ckpt.restore(os.path.join(tmp, "ref24"), shardings=sh,
                             device="cpu")
    out["from_jax"] = (step, _tree_np(got))
    out["trainer"] = _trainer_cases(rank, tmp, mesh, spy)

    from repro_torch.dist.sharding import ShardCtx as Ctx
    from repro_torch.launch.specs import state_shardings
    cfg, oc, state = _tp_step(mesh)
    ckpt.save(os.path.join(tmp, "tp_step"), state, 1,
              shardings=state_shardings(cfg, oc, Ctx(mesh)))
    return out


def _group_main(tmp):
    from repro_torch.launch.mesh import spawn
    results = spawn(_rank_cases, RANKS, backend="gloo",
                    devices=["cpu"] * RANKS, args=(tmp,), timeout_s=120)
    torch.save(results, os.path.join(tmp, "ranks.pt"))


# ------------------------------------------------------------- the fixture

def _start(code, tmp, env=None):
    return subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path[:0] = ['src', 'tests']; "
         "import test_torch_ckpt_sharded as T; " + code, str(tmp)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH="src", **(env or {})))


def _finish(proc, timeout):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, (out[-2000:], err[-4000:])


def _nomesh_restart(tmp, mode):
    """The single-process Trainer resumed from the mesh run's step 2."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.model import LanguageModel
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config("smollm-360m").reduced()
    tr = Trainer(LanguageModel(cfg, device="cpu"), OptimizerConfig(**OPT),
                 SyntheticTokens(cfg.vocab_size, batch=4, seq=32, seed=3),
                 TrainerConfig(ckpt_dir=str(tmp / f"nomesh_{mode}")))
    state = tr.init_or_restore(torch.Generator().manual_seed(5))
    start = tr.start_step
    return start, _tree_np(tr.run(state, 4 - start)["params"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_sharded")
    jax_proc = _start("T._jax_main(sys.argv[1])", tmp, {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    group = _start("T._group_main(sys.argv[1])", tmp)
    try:
        _finish(group, GROUP_TIMEOUT_S)
        _finish(jax_proc, 120)
    finally:
        for p in (group, jax_proc):
            if p.poll() is None:
                p.kill()
                p.communicate()
    with open(tmp / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    ranks = torch.load(tmp / "ranks.pt", weights_only=False)
    nomesh = {m: _nomesh_restart(tmp, m) for m in ("sync", "async")}
    from repro_torch import ckpt
    restored, step = ckpt.restore(str(tmp / "tp_step"))
    nomesh["tp_step"] = (step, restored["params"],
                         _tree_np(_tp_step()[2]["params"]))
    return tmp, ranks, ref, nomesh


def _shard_of(full, sh, rank):
    from repro_torch.dist.sharding import shard_of
    return shard_of(torch.from_numpy(full), sh, rank).numpy()


def _shardings_22():
    from repro_torch.dist.sharding import (MeshLayout, ShardCtx,
                                           param_shardings)
    sh = param_shardings(_tree(), ShardCtx(MeshLayout((2, 2),
                                                      ("data", "model"))))
    return {"/".join(p): s for p, s in _leaves(sh)}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------------ tests

def test_manifest_matches_reference(runs):
    import json
    tmp = runs[0]
    with open(tmp / "port22" / "step_1" / "manifest.json") as f:
        port = json.load(f)
    with open(tmp / "ref22" / "step_1" / "manifest.json") as f:
        ref = json.load(f)
    assert port == ref
    assert all("ranges" in leaf for leaf in port["leaves"])


def test_leaf_files_match_reference(runs):
    tmp = runs[0]
    names = sorted(os.listdir(tmp / "ref22" / "step_1"))
    assert names == sorted(os.listdir(tmp / "port22" / "step_1"))
    for name in names:
        assert (tmp / "port22" / "step_1" / name).read_bytes() == \
            (tmp / "ref22" / "step_1" / name).read_bytes(), name


@pytest.mark.parametrize("mesh", JAX_MESHES)
def test_reference_restores_port_checkpoint(runs, mesh):
    step, got = runs[2]["restored"][mesh]
    assert step == 1
    _assert_same(got, _tree_np(_tree()))


def test_port_restores_reference_save_on_mesh(runs):
    _tmp, ranks, _ref, _n = runs
    want, sh = _tree_np(_tree()), _shardings_22()
    for rank, r in enumerate(ranks):
        step, got = r["from_jax"]
        assert step == 1
        _assert_same(got, {k: _shard_of(v, sh[k], rank)
                           for k, v in want.items()})


def test_port_restores_reference_save_on_one_rank(runs):
    from repro_torch import ckpt
    tmp, ranks, _ref, _n = runs
    whole, step = ckpt.restore(str(tmp / "ref24"))
    assert step == 1
    whole = _tree_np(whole)
    _assert_same(whole, _tree_np(_tree()))
    sh = _shardings_22()
    for rank, r in enumerate(ranks):
        _assert_same(r["from_jax"][1], {k: _shard_of(v, sh[k], rank)
                                        for k, v in whole.items()})


def test_port_restores_its_own_save_on_mesh(runs):
    for r in runs[1]:
        step, got, mine = r["own"]
        assert step == 1
        _assert_same(got, mine)


def test_sharded_save_gathers_nothing(runs):
    ranks = runs[1]
    for r in ranks:
        for key in ("save", "save_again"):
            assert r[key]["host_gathers"] == 0
            assert r[key]["committed"]
            assert r[key] == ranks[0][key]       # every rank, the same


def test_sharded_save_counts_match_reference(runs):
    _tmp, ranks, ref, _n = runs
    for key in ("save", "save_again"):
        assert {k: ranks[0][key][k] for k in STAT_KEYS} == \
            {k: ref[key][k] for k in STAT_KEYS}, key


def test_identical_sharded_save_writes_nothing(runs):
    st = runs[1][0]["save_again"]
    assert st["chunks_written"] == 0 and st["bytes_written"] == 0
    assert st["chunks_skipped"] == st["chunks_total"] > 0


def test_sharded_crash_commits_nothing(runs):
    _tmp, ranks, ref, _n = runs
    assert not ref["crash"]["committed"]
    for rank, r in enumerate(ranks):
        assert not r["crash"]["committed"]
        latest, tmp_left, manifest, step, got, first = r["crash_after"]
        assert latest == 1 and step == 1
        assert tmp_left and not manifest
        _assert_same(got, first)


def test_sharded_save_refuses_bf16_naming_the_leaf(runs):
    for r in runs[1]:
        assert "params/w_q" in r["bf16"] and "bfloat16" in r["bf16"]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_io_cost_matches_reference(runs, layout):
    from repro_torch import ckpt
    from repro_torch.dist.sharding import (MeshLayout, ShardCtx,
                                           param_shardings)
    tree = _tree()
    mesh = MeshLayout(LAYOUTS[layout], ("data", "model"))
    got = ckpt.io_cost(tree, param_shardings(tree, ShardCtx(mesh)))
    assert got == runs[2]["io_cost"][layout]
    assert got["ranges"] > got["nodes"] > 1


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_trainer_restart_on_mesh_is_bit_exact(runs, mode):
    for r in runs[1]:
        t = r["trainer"]
        case = t[mode]
        assert case["fail_steps"] == [0, 1, 2]
        assert case["saved_steps"] == [2]
        assert case["saves"] == [(2, True, 0)]     # Trainer.saves
        assert case["start"] == 2 and case["steps"] == [2, 3]
        assert case["restored_equal"]
        _assert_same(case["final"], t["uninterrupted"])


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_trainer_restart_without_mesh(runs, mode):
    start, params = runs[3][mode]
    want = runs[1][0]["trainer"]["uninterrupted"]
    assert start == 2
    assert sorted(params) == sorted(want)
    for k in want:
        np.testing.assert_allclose(params[k], want[k], atol=3e-4, rtol=3e-4,
                                   err_msg=k)


def test_tp_trained_state_restores_on_one_device(runs):
    step, restored, want = runs[3]["tp_step"]
    assert step == 1
    got = _tree_np(restored)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=3e-4, rtol=3e-4,
                                   err_msg=k)


def test_launch_train_resumes_sharded_checkpoint(tmp_path):
    def train(steps):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
             "--device", "cpu", "--tp", "2", "--backend", "gloo", "--steps",
             str(steps), "--batch", "4", "--seq", "32", "--ckpt-dir",
             str(tmp_path), "--ckpt-every", "2"], cwd=ROOT,
            capture_output=True, text=True, timeout=240,
            env=dict(os.environ, PYTHONPATH="src"))
        assert proc.returncode == 0, (proc.stdout[-2000:],
                                      proc.stderr[-3000:])
        return proc.stdout
    out = train(4)
    assert "mesh=data1xmodel2" in out and "start_step=0" in out, out
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_4"]
    with open(tmp_path / "step_4" / "manifest.json") as f:
        assert '"ranges"' in f.read()
    out = train(6)
    assert "start_step=4" in out, out
    assert "  step     4 " in out and "  step     3 " not in out, out
