"""End-to-end example on the PyTorch port: train a reduced LM for a few
hundred steps through the fault-tolerant trainer, with §5 chunked
checkpoints, a mid-run simulated node failure + restart, then
greedy-decode from the trained model.

The port's counterpart of ``examples/train_lm.py``, through
``repro_torch.train.trainer.Trainer``: reduced llama3.2-3b on the
``markov`` synthetic stream (the affine chain t → 31 t + 7 mod V),
checkpoints every 50 steps, an injected fail-stop at step 150
(``TrainerConfig.fail_at_step``), a new ``Trainer`` that resumes from the
last committed manifest and trains to step 240, then a greedy decode of
the chain (hits out of 5).  The card is the default; there is no
fallback: without one the model raises.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
"""
import argparse
import os
import shutil
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import ckpt
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokens
from repro_torch.models.model import LanguageModel
from repro_torch.optim import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

STEPS = 240
FAIL_AT = 150
CKPT_EVERY = 50
BATCH, SEQ = 16, 32


def main(device: str = "cuda", steps: int = STEPS, fail_at: int = FAIL_AT,
         ckpt_every: int = CKPT_EVERY, batch: int = BATCH,
         seq: int = SEQ) -> dict:
    """Train, die, resume, decode; prints the reference's lines and
    returns {"died_at", "latest_step", "restart_step", "history" (every
    step's metrics of both runs, in order), "first_loss", "final",
    "preds", "want", "hits", "lines"}."""
    lines = []

    def say(line):
        print(line)
        lines.append(line)

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        cfg = get_config("llama3.2-3b").reduced()
        model = LanguageModel(cfg, device=device)
        oc = OptimizerConfig(peak_lr=5e-3, warmup_steps=10,
                             total_steps=steps, weight_decay=0.0)
        data = SyntheticTokens(cfg.vocab_size, batch=batch, seq=seq,
                               seed=11, mode="markov")

        # ---- phase 1: train with periodic §5 chunked checkpoints; a
        # simulated fail-stop kills the run at step fail_at
        tc = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                           async_ckpt=False, fail_at_step=fail_at)
        tr = Trainer(model, oc, data, tc)
        state = tr.init_or_restore(torch.Generator().manual_seed(0))
        tr.run(state, steps)
        died = max(h["step"] for h in tr.history)
        latest = ckpt.latest_step(ckpt_dir)
        say(f"run 1 died at step {died} (injected failure); last committed "
            f"ckpt = step_{latest}")
        del state

        # ---- phase 2: restart from the last committed manifest and finish
        tc2 = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                            async_ckpt=False)
        tr2 = Trainer(model, oc, data, tc2)
        state = tr2.init_or_restore(torch.Generator().manual_seed(0))
        say(f"restarted from step {tr2.start_step}")
        state = tr2.run(state, steps - tr2.start_step)
        hist = tr2.history
        say(f"final: step {hist[-1]['step']} "
            f"loss={hist[-1]['ce_loss']:.3f} acc={hist[-1]['accuracy']:.3f}")

        # ---- phase 3: serve — the model should have learned the chain
        params = state["params"]
        toks = [7]
        for _ in range(6):
            toks.append((toks[-1] * 31 + 7) % cfg.vocab_size)
        tokens = torch.tensor([toks[:2]], device=device)
        with torch.no_grad():
            logits, cache = model.prefill(params, {"tokens": tokens})
            cache = model.alloc_cache(1, 2 + 8, init=cache)
            cur, tok = 2, torch.argmax(logits, -1)[:, None]
            preds = [int(tok[0, 0])]
            for i in range(4):
                logits, cache = model.decode_step(params, cache, tok, cur + i)
                tok = torch.argmax(logits, -1)[:, None]
                preds.append(int(tok[0, 0]))
        want = toks[2:7]
        hits = sum(p == w for p, w in zip(preds, want))
        say(f"greedy decode follows the learned chain: {hits}/5 "
            f"(pred={preds}, want={want})")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"died_at": died, "latest_step": latest,
            "restart_step": tr2.start_step,
            "history": tr.history + tr2.history,
            "first_loss": tr.history[0]["ce_loss"], "final": hist[-1],
            "preds": preds, "want": want, "hits": hits, "lines": lines}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
