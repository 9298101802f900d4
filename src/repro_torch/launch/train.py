"""End-to-end training driver (torch).

Runs a dense, moe (arctic-480b; deepseek-v2-236b with MLA; both with
their int8 AdamW moments and ``train_accum_steps`` micro-batches), ssm
(mamba2-1.3b) or hybrid (zamba2-1.2b) architecture (reduced or full
config) through the OCR-runtime trainer on ``--device`` (the card by
default): §4 labeled step map, §5 chunked checkpoints, fail-stop
restart, straggler watchdog.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --smoke --device cpu --steps 100 --batch 8 --seq 128 \\
      [--ckpt-dir /tmp/ckpt]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.data import FileTokens, SyntheticTokens
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
                    help="model-parallel size over local devices")
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


def run(args: argparse.Namespace):
    """Train as the flags say; returns (trainer, final state).  Weights
    come from a ``torch.Generator`` seeded with 0 on the model's device."""
    if args.tp > 1:
        raise NotImplementedError("--tp > 1: model parallelism is not "
                                  "ported yet")
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
    tr = Trainer(model, oc, data, tc)
    state = tr.init_or_restore(
        torch.Generator(device=model.device).manual_seed(0))
    n = sum(p.numel() for _path, p in iter_leaves(state["params"]))
    print(f"arch={cfg.name} device={model.device} params={n:,} "
          f"start_step={tr.start_step}")
    state = tr.run(state, args.steps - tr.start_step)
    return tr, state


def main(argv=None) -> None:
    tr, _state = run(parse_args(argv))
    for h in tr.history[:3] + tr.history[-3:]:
        print(f"  step {h['step']:5d} loss={h['ce_loss']:.4f} "
              f"acc={h['accuracy']:.3f} {h['step_time']*1e3:.0f}ms")
    if tr.straggler_steps:
        print("stragglers:", tr.straggler_steps)
    rs = tr.last_runtime_stats
    print(f"runtime: tasks={rs.tasks_executed} msgs={rs.messages_sent} "
          f"creator_calls={rs.creator_calls}")


if __name__ == "__main__":
    main()
