"""End-to-end training driver (torch).

Runs a dense, moe (arctic-480b; deepseek-v2-236b with MLA; both with
their int8 AdamW moments and ``train_accum_steps`` micro-batches), ssm
(mamba2-1.3b) or hybrid (zamba2-1.2b) architecture (reduced or full
config) through the OCR-runtime trainer on ``--device`` (the card by
default): §4 labeled step map, §5 / §6 checkpoints, fail-stop
restart, straggler watchdog.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --smoke --device cpu --steps 100 --batch 8 --seq 128 \\
      [--ckpt-dir /tmp/ckpt]

Under a mesh: ``--tp N`` (and ``--ranks R``, N by default) starts R rank
processes with ``launch.mesh.spawn`` over ``--backend`` (gloo or nccl,
named by the caller: ranks that share a card, as on one H100, run gloo)
and trains on ``make_host_mesh(N)``, (R / N, N) over ("data", "model");
rank 0 prints.  ``--ckpt-dir`` / ``--ckpt-every`` then save sharded
(each rank writes its own §6 ranges), and a rerun resumes from the
newest step on this mesh or another (rank 0's first line gives
``start_step``).  Under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` set) each
process joins the group from the environment instead:

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --tp 2 --backend gloo --steps 4
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --tp 2 --backend gloo
"""
import argparse
import os

import torch

from repro_torch.configs import get_config
from repro_torch.data import FileTokens, SyntheticTokens
from repro_torch.launch.mesh import (check_backend, make_host_mesh,
                                     rank_devices, spawn)
from repro_torch.models.model import LanguageModel
from repro_torch.optim import OptimizerConfig
from repro_torch.optim.adamw import iter_leaves
from repro_torch.train.trainer import Trainer, TrainerConfig


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model trains on")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", default="synthetic",
                    help="synthetic | markov | path to int32 token file")
    ap.add_argument("--tp", type=int, default=1,
                    help="model-parallel size (the mesh's 'model' axis)")
    ap.add_argument("--ranks", type=int, default=0,
                    help="rank processes under a mesh (default: --tp)")
    ap.add_argument("--backend", default="",
                    help="gloo | nccl: the process group's backend, "
                         "required under a mesh")
    return ap.parse_args(argv)


def optimizer_config(cfg, args: argparse.Namespace) -> OptimizerConfig:
    """AdamW as the flags and the config say: the config's moment dtype
    (int8 for arctic and deepseek-v2) and its ``train_accum_steps``
    micro-batches a step (4 for both), as the reference's dry run takes
    them."""
    return OptimizerConfig(peak_lr=args.lr,
                           warmup_steps=max(args.steps // 20, 5),
                           total_steps=args.steps,
                           state_dtype=cfg.optimizer_state_dtype,
                           accum_steps=cfg.train_accum_steps)


def run(args: argparse.Namespace, mesh=None):
    """Train as the flags say; returns (trainer, final state).  Weights
    come from a ``torch.Generator`` seeded with 0 on the model's device;
    under ``mesh`` (inside a rank process) the state is the rank's
    shards."""
    if args.tp > 1 and mesh is None:
        raise ValueError(f"--tp {args.tp} needs a mesh: main() starts the "
                         f"rank processes, or pass mesh= from inside one")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = LanguageModel(cfg, device=args.device)
    oc = optimizer_config(cfg, args)

    if args.data in ("synthetic", "markov"):
        data = SyntheticTokens(cfg.vocab_size, args.batch, args.seq,
                               seed=0, mode="markov" if args.data == "markov"
                               else "uniform")
    else:
        data = FileTokens(args.data, cfg.vocab_size, args.batch, args.seq)

    tc = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every
                       if args.ckpt_dir else 0)
    tr = Trainer(model, oc, data, tc, mesh=mesh)
    state = tr.init_or_restore(
        torch.Generator(device=model.device).manual_seed(0))
    n = sum(p.numel() for _path, p in iter_leaves(state["params"]))
    if _rank() == 0:
        where = "" if mesh is None else f" mesh={_mesh_desc(mesh)}"
        print(f"arch={cfg.name} device={model.device}{where} params="
              f"{n:,}{' (rank 0 shards)' if mesh is not None else ''} "
              f"start_step={tr.start_step}")
    state = tr.run(state, args.steps - tr.start_step)
    return tr, state


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _mesh_desc(mesh) -> str:
    return "x".join(f"{n}{s}" for n, s in zip(mesh.mesh_dim_names,
                                               mesh.mesh.shape))


def report(history, straggler_steps, stats) -> None:
    for h in history[:3] + history[-3:]:
        print(f"  step {h['step']:5d} loss={h['ce_loss']:.4f} "
              f"acc={h['accuracy']:.3f} {h['step_time']*1e3:.0f}ms")
    if straggler_steps:
        print("stragglers:", straggler_steps)
    print(f"runtime: tasks={stats.tasks_executed} msgs={stats.messages_sent} "
          f"creator_calls={stats.creator_calls}")


def rank_main(rank: int, world: int, args: argparse.Namespace):
    """One rank of a mesh run (``launch.mesh.spawn`` or ``torchrun``):
    train on ``make_host_mesh(--tp)``; returns (history, stragglers,
    stats)."""
    tr, _state = run(args, mesh=make_host_mesh(
        args.tp, device_type=torch.device(args.device).type))
    return tr.history, tr.straggler_steps, tr.last_runtime_stats


def main(argv=None) -> None:
    args = parse_args(argv)
    ranks = args.ranks or args.tp
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist
        if not args.backend:
            raise SystemExit("--backend gloo|nccl is required under a mesh")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        devices = rank_devices(args.device, world)
        check_backend(args.backend, devices)
        if torch.device(devices[rank]).type == "cuda":
            torch.cuda.set_device(torch.device(devices[rank]))
        args.device = devices[rank]
        dist.init_process_group(args.backend)
        try:
            out = rank_main(rank, world, args)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            report(*out)
        return
    if ranks > 1 or args.tp > 1:
        if not args.backend:
            raise SystemExit("--backend gloo|nccl is required under a mesh")
        devices = rank_devices(args.device, ranks)
        results = spawn(_spawned, ranks, backend=args.backend,
                        devices=devices, args=(args,))
        report(*results[0])
        return
    tr, _state = run(args)
    report(tr.history, tr.straggler_steps, tr.last_runtime_stats)


def _spawned(rank: int, world: int, args: argparse.Namespace):
    args = argparse.Namespace(**vars(args))
    args.device = rank_devices(args.device, world)[rank]
    return rank_main(rank, world, args)


if __name__ == "__main__":
    main()
