"""Why arctic-480b's router runs away at lr 1e-3 in six steps: the
training dynamics, the int8 AdamW moments, or the port?

``--card`` runs the port on one CUDA card: the Trainer as
``launch.train`` builds it (warmup max(steps // 20, 5), markov data of
seed 0, weights from a generator seeded with 0) for arctic at full
width with 2 layers, 6 steps of 4 x 4096 at lr 1e-3 and at 3e-4:

  * 32 experts, int8 moments (the config's; ``chip_smoke.py``'s MoE
    training phase);
  * 16 experts, int8 moments, and 16 experts, fp32 moments (32 experts
    with fp32 moments need ~106 GB, past one 80 GB card).

``--cpu`` runs the reference's Trainer (JAX) and the port's on the CPU
from the same weights (the JAX init carried across with
``params_from_numpy``): arctic at full width with 2 layers and 4
experts, bf16 parameters and int8 moments, 6 steps of 2 x 1024 at lr
1e-3.  It imports JAX and the reference package, as the tests do; the
``--card`` side imports neither.

Every run prints, per step, ce_loss, aux_loss, moe_overflow_rate and
grad_norm, and appends one JSON line to OUT::

    python3 scripts/moe_lr_witness.py --card OUT.jsonl
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/moe_lr_witness.py \\
        --cpu OUT.jsonl
"""
import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.models.model import LanguageModel  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.optim.adamw import init_opt_state  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

ARCH = "arctic-480b"
STEPS = 6
KEYS = ("ce_loss", "aux_loss", "moe_dropped_tokens", "moe_overflow_rate",
        "grad_norm")


def _opt_kw(lr, state_dtype):
    # launch.train's schedule for a 6-step run
    return dict(peak_lr=lr, warmup_steps=max(STEPS // 20, 5),
                total_steps=STEPS, state_dtype=state_dtype)


def _report(out, row):
    print(f"-- {row['side']}: {row['experts']} experts, {row['moments']} "
          f"moments, lr {row['lr']:g}, {row['batch']} x {row['seq']}")
    for i in range(len(row["ce_loss"])):
        print(f"  step {i + 1}: " + " ".join(
            f"{k} {row[k][i]:.4f}" for k in KEYS))
    with open(out, "a") as f:
        f.write(json.dumps(row) + "\n")


def _history(tr, **info):
    return {**info, **{k: [float(h[k]) for h in tr.history] for k in KEYS}}


def card(out):
    name = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(name.strip())
    b, s = 4, 4096
    for experts, moments, lr in ((32, "int8", 1e-3), (16, "int8", 1e-3),
                                 (16, "float32", 1e-3), (16, "float32", 3e-4)):
        cfg = dataclasses.replace(get_config(ARCH), num_layers=2,
                                  num_experts=experts,
                                  optimizer_state_dtype=moments)
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(LanguageModel(cfg, device="cuda"),
                     OptimizerConfig(**_opt_kw(lr, moments)),
                     SyntheticTokens(cfg.vocab_size, b, s, seed=0,
                                     mode="markov"), TrainerConfig())
        t0 = time.perf_counter()
        state = tr.run(tr.init_or_restore(
            torch.Generator(device="cuda").manual_seed(0)), STEPS)
        torch.cuda.synchronize()
        _report(out, _history(
            tr, side="port, card", card=name.strip(), experts=experts,
            moments=moments, lr=lr, batch=b, seq=s,
            wall_s=time.perf_counter() - t0,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        del tr, state
        gc.collect()          # the Trainer's runtime holds the state in
        torch.cuda.empty_cache()  # a reference cycle


def cpu(out):
    import jax

    from repro.configs import get_config as jget
    from repro.data import SyntheticTokens as JTokens
    from repro.models.model import LanguageModel as JModel
    from repro.optim import OptimizerConfig as JOpt
    from repro.optim import init_opt_state as jinit
    from repro.train.trainer import Trainer as JTrainer
    from repro.train.trainer import TrainerConfig as JTrainerConfig
    from repro_torch.convert import params_from_numpy

    b, s, experts, lr = 2, 1024, 4, 1e-3
    over = dict(num_layers=2, num_experts=experts)
    jcfg = dataclasses.replace(jget(ARCH), **over)
    tcfg = dataclasses.replace(get_config(ARCH), **over)
    moments = jcfg.optimizer_state_dtype
    info = dict(experts=experts, moments=moments, lr=lr, batch=b, seq=s)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           device="cpu")
    joc = JOpt(**_opt_kw(lr, moments))
    jtr = JTrainer(jm, joc, JTokens(jcfg.vocab_size, b, s, seed=0,
                                    mode="markov"), JTrainerConfig())
    jtr.start_step = 0
    t0 = time.perf_counter()
    jtr.run({"params": jp, "opt": jinit(jp, joc)}, STEPS)
    _report(out, _history(jtr, side="reference (JAX), CPU",
                          wall_s=time.perf_counter() - t0, **info))
    del jm, jp, jtr
    gc.collect()
    toc = OptimizerConfig(**_opt_kw(lr, moments))
    ttr = Trainer(LanguageModel(tcfg, device="cpu"), toc,
                  SyntheticTokens(tcfg.vocab_size, b, s, seed=0,
                                  mode="markov"), TrainerConfig())
    ttr.start_step = 0
    t0 = time.perf_counter()
    ttr.run({"params": tp, "opt": init_opt_state(tp, toc)}, STEPS)
    _report(out, _history(ttr, side="port, CPU",
                          wall_s=time.perf_counter() - t0, **info))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    side = ap.add_mutually_exclusive_group(required=True)
    side.add_argument("--card", action="store_true")
    side.add_argument("--cpu", action="store_true")
    ap.add_argument("out")
    args = ap.parse_args()
    (card if args.card else cpu)(args.out)


if __name__ == "__main__":
    main()
