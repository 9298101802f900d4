"""Dry run: one rank's real step of every (arch × shape) cell on the
production layouts, on the meta device (the port's counterpart of
``repro.launch.dryrun``).

For each cell this runs the step a rank of the 16 × 16 (or 2 × 16 × 16)
mesh runs — ``make_train_step`` for train shapes, ``prefill`` or
``decode_step`` for serving shapes — through the port's own entry
points, under ``use_mesh(make_production_mesh(), rank=r)``: a
``MeshLayout`` with no process behind it, the rank's shards of the state
as meta tensors, the collectives counted and not sent, the kernels
counted from their shapes and not launched (``launch.cost``).  It
records what that rank computes, moves, communicates and holds, the
roofline terms on the H100 (``launch.analysis``) and, for train shapes,
the checkpoint IO cost of the §5 latency model (``ckpt.io_cost``).
Nothing has storage and no process group starts, so every cell of both
layouts runs on the CPU.

Where the reference lowers and compiles, the port traces eagerly: there
is no compile step and no ``cost_analysis_raw``, and the record says so.
Serving cells keep the weights in the compute dtype, as the reference's
do, and give the rank its batch rows over "dp" (the reference's batch
sharding; the port's live ``prefill`` / ``decode_step`` run every row on
every rank).  ``argument_size_in_bytes`` is each argument's shard on the
rank (the train step takes the whole batch and computes its rows).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all              # 16 x 16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod  # 2 x 16 x 16
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import all_arch_names, get_config
from repro_torch.configs.base import SHAPES, applicable, shape_by_name
from repro_torch.dist.sharding import (NamedSharding, _entry_axes,
                                       _map_with_path, batch_split,
                                       param_shardings, use_mesh)
from repro_torch.launch import analysis as an
from repro_torch.launch import cost
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import LanguageModel
from repro_torch.optim import OptimizerConfig
from repro_torch.train.steps import make_train_step

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "dryrun_torch.json")
NO_COMPILE = ("eager trace on the meta device: no compile step and no "
              "cost_analysis_raw; flops, bytes and collectives counted by "
              "launch.cost")


def _shard_shape(shape, sharding: NamedSharding, rank: int):
    return tuple(len(range(*s.indices(d)))
                 for s, d in zip(sharding.index_of(shape, rank), shape))


def local_tree(tree: Any, shardings: Any, rank: int) -> Any:
    """``rank``'s shard of every meta leaf of ``tree``, as a meta tensor of
    its own (no view of the whole leaf)."""
    if isinstance(tree, dict):
        return {k: local_tree(v, shardings[k], rank) for k, v in tree.items()}
    return torch.empty(_shard_shape(tuple(tree.shape), shardings, rank),
                       dtype=tree.dtype, device="meta")


def shard_bytes(tree: Any, shardings: Any, rank: int) -> int:
    """Bytes of ``rank``'s shards of every leaf of ``tree``."""
    total = 0

    def add(path, leaf):
        nonlocal total
        sh = shardings
        for k in path:
            sh = sh[k]
        n = 1
        for d in _shard_shape(tuple(leaf.shape), sh, rank):
            n *= d
        total += n * leaf.dtype.itemsize

    _map_with_path(add, tree)
    return total


def optimizer_config(cfg) -> OptimizerConfig:
    """The reference's dry-run optimizer: the config's moments and
    accumulation steps, a bf16 accumulator with int8 moments."""
    return OptimizerConfig(
        state_dtype=cfg.optimizer_state_dtype,
        accum_steps=cfg.train_accum_steps,
        accum_dtype="bfloat16" if cfg.optimizer_state_dtype == "int8"
        else "float32")


def train_report(cfg, oc: OptimizerConfig, batch: Dict[str, Any], mesh,
                 rank: int = 0):
    """Rank ``rank``'s ``make_train_step`` on ``mesh`` (a ``MeshLayout``)
    over the whole ``batch`` (meta tensors), its state the rank's shards
    of the config's meta state: the layout pass of a live mesh's train
    step.  Returns the ``CostReport``."""
    with use_mesh(mesh, pure_dp=cfg.pure_dp, rank=rank) as ctx:
        state = local_tree(sp.state_specs(cfg, oc),
                           sp.state_shardings(cfg, oc, ctx), rank)
        model = LanguageModel(cfg, device="meta")
        return cost.measure(make_train_step(model, oc), state, batch)[1]


def trace_cell(cfg, shape, mesh, rank: int = 0):
    """Run rank ``rank``'s step of the cell on ``mesh`` (a ``MeshLayout``;
    one of a single rank stands for one device) and count it.  Returns
    (the ``CostReport``, the argument bytes, the ``(state shapes, state
    shardings)`` pair for the checkpoint cost of a train shape, else
    None)."""
    with use_mesh(mesh, pure_dp=cfg.pure_dp, rank=rank) as ctx:
        return _trace(cfg, shape, ctx, rank)


def _trace(cfg, shape, ctx, rank):
    if shape.kind != "train":
        # serving keeps weights in the compute dtype (no fp32 masters)
        cfg = dataclasses.replace(cfg, param_dtype=cfg.dtype)
    batch = sp.batch_specs(cfg, shape)
    batch_sh = sp.batch_shardings(cfg, shape, ctx)
    if shape.kind == "train":
        oc = optimizer_config(cfg)
        state_shapes = sp.state_specs(cfg, oc)
        state_sh = sp.state_shardings(cfg, oc, ctx)
        args = (shard_bytes(state_shapes, state_sh, rank)
                + shard_bytes(batch, batch_sh, rank))
        report = train_report(cfg, oc, batch, ctx.mesh, rank)
        return report, args, (state_shapes, state_sh)
    model = LanguageModel(cfg, device="meta")
    params_shapes = sp.params_only_specs(cfg)
    params_sh = param_shardings(params_shapes, ctx)
    params = local_tree(params_shapes, params_sh, rank)
    rows = local_tree(batch, batch_sh, rank)
    dp = _entry_axes(batch_sh["tokens"].spec[0])
    b = rows["tokens"].shape[0]
    args = shard_bytes(params_shapes, params_sh, rank)
    with torch.no_grad(), batch_split(dp):
        if shape.kind == "prefill":
            args += shard_bytes(batch, batch_sh, rank)
            _, report = cost.measure(model.prefill, params, rows)
        else:
            cache = model.cache_spec(b, shape.seq_len)
            token = torch.empty((b, 1), dtype=torch.int32, device="meta")
            # the caches as the rank holds them, the tokens and cur_len
            # (an int32 scalar in the reference's signature)
            args += sum(t.numel() * t.element_size()
                        for t in _leaves(cache)) + token.numel() * 4 + 4
            _, report = cost.measure(
                lambda p, c, t: model.decode_step(p, c, t, shape.seq_len - 1),
                params, cache, token)
    return report, args, None


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True) -> Dict[str, Any]:
    """One cell's record: rank 0 of the production layout."""
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rank = 0
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "rank": rank,
        "status": "skipped",
    }
    if not applicable(cfg, shape):
        rec["reason"] = "long_500k needs sub-quadratic arch (DESIGN.md)"
        return rec
    t0 = time.time()
    report, arg_bytes, ckpt_inputs = trace_cell(cfg, shape, mesh, rank)
    ckpt_io = None
    if ckpt_inputs is not None:
        from repro_torch import ckpt as _ckpt
        ckpt_io = _ckpt.io_cost(*ckpt_inputs)
    t_lower = time.time() - t0
    coll = {"per_kind": report.coll_bytes, "counts": report.coll_counts,
            "total": report.coll_total}
    rl = an.roofline({"flops": report.flops, "bytes accessed": report.bytes},
                     coll, an.model_flops(cfg, shape), mesh.size,
                     an.axis_rates(mesh))
    rec.update({
        "status": "ok",
        "lower_s": round(t_lower, 1),
        "compile_s": None,
        "note": NO_COMPILE,
        "memory": {"argument_size_in_bytes": float(arg_bytes),
                   "output_size_in_bytes": float(report.out_bytes),
                   "peak_size_in_bytes": float(report.peak_bytes),
                   "temp_size_in_bytes": float(report.peak_bytes
                                               - report.arg_bytes)},
        "cost": {"aten_flops": report.aten_flops,
                 "kernel_flops": report.kernel_flops,
                 "aten_bytes": report.aten_bytes,
                 "kernel_bytes": report.kernel_bytes,
                 "ops": report.ops, "kernels": report.kernels},
        "collectives": coll,
        "roofline": rl.as_dict(),
    })
    if ckpt_io is not None:
        rec["ckpt_io"] = ckpt_io
    if verbose:
        print(f"== {arch} × {shape_name} × {rec['mesh']} (rank {rank}) ==")
        print("  memory:", json.dumps(rec["memory"]))
        print("  cost: flops={:.4e} (kernels {:.4e}) bytes={:.4e}".format(
            rl.flops, report.kernel_flops, rl.hbm_bytes))
        print("  collectives:", json.dumps(coll["per_kind"]))
        print("  roofline: compute={:.4f}s memory={:.4f}s coll={:.4f}s "
              "dominant={} useful={:.2f}".format(
                  rl.compute_s, rl.memory_s, rl.collective_s, rl.dominant,
                  rl.useful_ratio))
        print(f"  ({t_lower:.1f} s)", flush=True)
    return rec


def load_results(path: str) -> Dict[str, Any]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"cells": {}}


def save_results(path: str, res: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--redo", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    out_path = args.out or os.path.normpath(RESULTS)
    results = load_results(out_path)

    if args.all:
        cells = [(a, s.name) for a in all_arch_names() for s in SHAPES]
    else:
        assert args.arch and args.shape, "--arch and --shape (or --all)"
        cells = [(args.arch, args.shape)]

    failures = []
    for arch, shape_name in cells:
        mesh_name = "2x16x16" if args.multi_pod else "16x16"
        keyname = f"{arch}|{shape_name}|{mesh_name}"
        if not args.redo and results["cells"].get(keyname, {}).get(
                "status") == "ok":
            print(f"-- cached: {keyname}")
            continue
        try:
            rec = run_cell(arch, shape_name, args.multi_pod)
        except Exception as e:  # record failures: they are bugs to fix
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                   "status": "error", "error": f"{type(e).__name__}: {e}"}
            failures.append(keyname)
        results["cells"][keyname] = rec
        save_results(out_path, results)
    print(f"\nwrote {out_path}")
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
