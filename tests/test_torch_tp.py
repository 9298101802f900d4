"""Tensor parallelism that splits compute (``repro_torch.models.tp``), on
the CPU.

* The vocab-parallel cross entropy's combine
  (``model.vocab_parallel_stats``) as a pure function of per-shard
  logits, stacked on a leading shard dim with a reduction over it:
  lse, the target's logit and the argmax against ``torch.logsumexp`` /
  ``gather`` / ``argmax`` over the whole vocab, with maxima tied across
  a shard boundary (the smallest global index wins, as ``jnp.argmax``),
  and the gradient of the loss against softmax minus the one-hot.
* On a (2, 2) gloo mesh of 4 rank processes (one small group in a
  subprocess): ``gather_params`` hands ``w_q`` over at its "model" share
  (L, D, H/m, hd) and ``embedding`` at (V/m, D), and no leaf of a train
  step is gathered over "model"; the per-rank GEMM FLOPs of reduced
  llama3.2-3b's train step (``FlopCounterMode``) are at most 0.3 × the
  one-device step's ("dp" halves the rows, "model" the heads, hidden
  units and vocab: 1/4 of it, where replicated compute over "model"
  gave 1/2).
* The dry run's layout pass (``launch.dryrun.train_report``: one rank of
  a ``MeshLayout`` on the meta device, no process) of the same step on
  rank 0 and rank 3 of (2, 2) gives exactly the live rank's aten FLOPs
  (``FlopCounterMode``) and its ``TRAFFIC``: every kind's calls and
  bytes; for reduced mamba2's step on the same group, its ``TRAFFIC``.
* A Mamba mixer on the rank's share projects B and C on its stripe of
  the sequence: on (1, 2) and (1, 4) layout ranks its B / C GEMM FLOPs
  are exactly 1/m of one device's.
"""
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = 4
GROUP_TIMEOUT_S = 240


# ------------------------------------------------ the vocab-parallel combine

def _stacked(full, m):
    """(N, V) → (m, N, V/m) shards and their first global indices."""
    n, v = full.shape
    shards = full.reshape(n, m, v // m).permute(1, 0, 2).contiguous()
    lo = (torch.arange(m) * (v // m))[:, None]
    return shards, lo


def _over_shards(x, op):
    out = {"max": x.amax(0), "sum": x.sum(0), "min": x.amin(0)}[op]
    return out.expand_as(x)


@pytest.mark.parametrize("m", [2, 4])
def test_vocab_parallel_stats_match_the_whole_vocab(m):
    from repro_torch.models.model import vocab_parallel_stats
    g = torch.Generator().manual_seed(0)
    n, v = 12, 32
    full = torch.randn((n, v), generator=g)
    per = v // m
    # ties across a shard boundary: the last column of shard 0 and the
    # first of shard 1 hold the row's maximum (row 0), and the same
    # maximum in two shards far apart (row 1); a tie inside one shard
    # (row 2)
    full[0, per - 1] = full[0, per] = 9.0
    full[1, per + 2] = full[1, v - 1] = 9.0
    full[2, 1] = full[2, 3] = 9.0
    targets = torch.randint(0, v, (n,), generator=g)
    targets[0], targets[1] = per, per - 1
    shards, lo = _stacked(full, m)
    shards.requires_grad_(True)
    lse, ll, pred = vocab_parallel_stats(shards, targets, lo, _over_shards)
    torch.testing.assert_close(lse[0], torch.logsumexp(full, -1))
    torch.testing.assert_close(ll[0], full.gather(-1, targets[:, None])[:, 0])
    assert torch.equal(pred[0], torch.argmax(full, -1))
    assert pred[0, :3].tolist() == [per - 1, per + 2, 1]
    assert all(torch.equal(pred[i], pred[0]) for i in range(m))

    (lse[0] - ll[0]).sum().backward()
    want = torch.softmax(full, -1) - torch.nn.functional.one_hot(targets, v)
    torch.testing.assert_close(shards.grad, _stacked(want, m)[0])


# ------------------------------------------------------------ the rank group

def _rank(rank, world, out_dir):
    """gather_params' shapes and gathers, and one train step's FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode

    import repro_torch.models.model as model_mod
    from repro_torch.configs import get_config
    from repro_torch.convert import place_state
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import (batch_split, current_ctx,
                                           param_shardings, shard_tree,
                                           use_mesh)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import LanguageModel, param_shapes
    from repro_torch.optim import OptimizerConfig
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.steps import make_train_step

    cfg = get_config("llama3.2-3b").reduced()
    model = LanguageModel(cfg, device="cpu")
    oc = OptimizerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=50)
    g = torch.Generator().manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 32), generator=g),
             "targets": torch.randint(0, cfg.vocab_size, (4, 32),
                                      generator=g)}

    def fresh():
        p = model.init(torch.Generator().manual_seed(0))
        return {"params": p, "opt": init_opt_state(p, oc)}

    def flops(state):
        with FlopCounterMode(display=False) as fc:
            make_train_step(model, oc)(state, batch)
        return fc.get_total_flops()

    one = flops(fresh())
    mesh = make_host_mesh(model=2)
    gathered = []
    real = model_mod.gather_param

    def record(x, spec, ctx=None):
        gathered.append(tuple(spec))
        return real(x, spec, ctx)

    model_mod.gather_param = record
    try:
        state = place_state(fresh(), mesh)
        sharding.reset_traffic()
        with use_mesh(mesh):
            per_rank = flops(state)
        traffic = {k: list(v) for k, v in sharding.TRAFFIC.items()}
    finally:
        model_mod.gather_param = real
    with use_mesh(mesh) as ctx:
        local = shard_tree(model.init(torch.Generator().manual_seed(0)),
                           param_shardings(param_shapes(cfg), ctx), rank)
        with batch_split(("data",)):
            got = model_mod.gather_params(local, cfg, current_ctx())
    # a Mamba model's train step on the same mesh: B / C on the stripe
    mcfg = get_config("mamba2-1.3b").reduced()
    mmodel = LanguageModel(mcfg, device="cpu")
    mp = mmodel.init(torch.Generator().manual_seed(0))
    mbatch = {k: torch.randint(0, mcfg.vocab_size, (4, 64), generator=g)
              for k in ("tokens", "targets")}
    mstate = place_state({"params": mp, "opt": init_opt_state(mp, oc)}, mesh)
    sharding.reset_traffic()
    with use_mesh(mesh):
        make_train_step(mmodel, oc)(mstate, mbatch)
    mamba_traffic = {k: list(v) for k, v in sharding.TRAFFIC.items()}
    return {"one": one, "per_rank": per_rank, "gathered": gathered,
            "traffic": traffic, "mamba_traffic": mamba_traffic,
            "w_q": tuple(got["layers"]["attn"]["w_q"].shape),
            "w_k": tuple(got["layers"]["attn"]["w_k"].shape),
            "embedding": tuple(got["embedding"].shape),
            "w_gate": tuple(got["layers"]["mlp"]["w_gate"].shape)}


def _group_main(out_dir):
    from repro_torch.launch.mesh import spawn
    results = spawn(_rank, RANKS, backend="gloo", devices=["cpu"] * RANKS,
                    args=(out_dir,), timeout_s=120)
    torch.save(results, os.path.join(out_dir, "results.pt"))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    code = ("import sys; sys.path[:0] = ['src', 'tests']; "
            "import test_torch_tp as T; T._group_main(sys.argv[1])")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp)], cwd=ROOT,
                          capture_output=True, text=True,
                          timeout=GROUP_TIMEOUT_S,
                          env=dict(os.environ, PYTHONPATH="src"))
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    return torch.load(tmp / "results.pt", weights_only=False)


def test_gather_params_keeps_the_model_share(group):
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-3b").reduced()
    L, d, h, kh, hd = (cfg.num_layers, cfg.d_model, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim)
    for r in group:
        assert r["w_q"] == (L, d, h // 2, hd)
        assert r["w_k"] == (L, d, kh // 2, hd)
        assert r["w_gate"] == (L, d, cfg.d_ff // 2)
        assert r["embedding"] == (cfg.vocab_size // 2, d)
        # every gather of the step runs over "data" (FSDP) alone
        assert r["gathered"], "the step gathered no leaf"
        for spec in r["gathered"]:
            for e in spec:
                assert e is None or "model" not in (
                    (e,) if isinstance(e, str) else e), spec


def test_train_step_flops_per_rank_split_over_model(group):
    for r in group:
        assert r["one"] > 0
        ratio = r["per_rank"] / r["one"]
        assert ratio <= 0.3, (r["per_rank"], r["one"], ratio)


@pytest.mark.parametrize("rank", [0, 3])
def test_layout_pass_equals_the_live_rank(group, rank):
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import MeshLayout
    from repro_torch.launch.dryrun import train_report
    from repro_torch.optim import OptimizerConfig
    cfg = get_config("llama3.2-3b").reduced()
    oc = OptimizerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=50)
    batch = {k: torch.empty((4, 32), dtype=torch.int64, device="meta")
             for k in ("tokens", "targets")}
    rep = train_report(cfg, oc, batch, MeshLayout((2, 2), ("data", "model")),
                       rank)
    live = group[rank]
    assert rep.aten_flops == live["per_rank"]
    assert rep.kernels == {}           # 32 positions: the dense attention
    assert {k: [int(rep.coll_counts[k]), int(v)]
            for k, v in rep.coll_bytes.items()} == \
        {k: v[:2] for k, v in live["traffic"].items()}


@pytest.mark.parametrize("rank", [0, 3])
def test_layout_pass_counts_the_mamba_rank_traffic(group, rank):
    """Reduced mamba2's train step on (2, 2): the layout pass counts the
    collectives a live rank hands gloo, the B / C gather over "model"
    among them (the live CPU rank runs the scan's plain version, so its
    aten FLOPs are not the pass's, which counts K9 / K9b)."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import MeshLayout
    from repro_torch.launch.dryrun import train_report
    from repro_torch.optim import OptimizerConfig
    cfg = get_config("mamba2-1.3b").reduced()
    oc = OptimizerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=50)
    batch = {k: torch.empty((4, 64), dtype=torch.int64, device="meta")
             for k in ("tokens", "targets")}
    rep = train_report(cfg, oc, batch, MeshLayout((2, 2), ("data", "model")),
                       rank)
    live = {k: v[:2] for k, v in group[rank]["mamba_traffic"].items()}
    assert live["all_gather/model"][0] > 0, live
    assert {k: [int(rep.coll_counts[k]), int(v)]
            for k, v in rep.coll_bytes.items()} == live


# ------------------------------------- Mamba's B / C projections on a rank

class _BCGemms(TorchDispatchMode):
    """FLOPs of the GEMMs that produce or contract a width-``n`` operand:
    in a Mamba train step (n = ssm_state) the B / C projections' forward
    and remat recompute (x @ w_B: output n), dX (contracting n) and dW
    (output n)."""

    def __init__(self, n):
        super().__init__()
        self.n, self.flops = n, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            a, b = args[0], args[1]
            if self.n in (a.shape[1], b.shape[1]):
                self.flops += 2 * a.shape[0] * a.shape[1] * b.shape[1]
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("m", [2, 4])
def test_mamba_bc_projections_take_the_rank_share(m):
    """On a (1, m) layout rank (the dry run's pass, meta tensors) a Mamba
    mixer projects B and C on its stripe of the sequence: 1/m of one
    device's B / C GEMM FLOPs (which the reference's GSPMD layout also
    gives a device), where projecting every row on every rank gave all
    of them."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import MeshLayout
    from repro_torch.launch.dryrun import optimizer_config, train_report
    cfg = get_config("mamba2-1.3b").reduced()
    b, s = 4, 64
    batch = {k: torch.empty((b, s), dtype=torch.int64, device="meta")
             for k in ("tokens", "targets")}
    counted = {}
    for shape in ((1, 1), (1, m)):
        with _BCGemms(cfg.ssm_state) as bc:
            rep = train_report(cfg, optimizer_config(cfg), batch,
                               MeshLayout(shape, ("data", "model")), 0)
        counted[shape] = bc.flops
        assert rep.kernels, "the step ran no K9"
    # B and C: forward, remat recompute, dX, dW, each 2 rows D N a layer
    whole = cfg.num_layers * 4 * 2 * 2 * b * s * cfg.d_model * cfg.ssm_state
    assert counted[(1, 1)] == whole
    assert counted[(1, m)] * m == whole, (counted, m)
