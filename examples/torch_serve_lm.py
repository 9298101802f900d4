"""Batched serving on the PyTorch port across three architecture families.

The port's counterpart of ``examples/serve_lm.py``: prefills a batch of
prompts and greedily decodes tokens for a dense (llama-style), an SSM
(mamba2: O(1) decode state) and a hybrid (zamba2) reduced model through
``repro_torch.models.model.LanguageModel``, and prints tokens/s a
family.  After the prefill each cache is grown to the generated length
with ``alloc_cache(…, init=cache)`` (attention k / v copied into the
first positions, Mamba tails and states whole), where the reference pads
its arrays.

On the card a decode step's attention runs the flash-decode kernel (K5)
and a Mamba layer's prefill the SSD scan (K9); the 24-token prompts stay
below ``attn_flash_min_seq``, so prefill attention is dense, as in the
reference.  The card is the default; there is no fallback: without one
the model raises.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config
from repro_torch.models.model import LanguageModel

B, PROMPT, GEN = 4, 24, 12
ARCHS = ("llama3.2-3b", "mamba2-1.3b", "zamba2-1.2b")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve(arch: str, device: str = "cuda", gen: int = GEN, params=None,
          tokens=None) -> dict:
    """Prefill ``tokens`` (B, PROMPT) and decode ``gen`` − 1 tokens after
    the reference's warm-up step; ``params`` (a ``LanguageModel`` tree on
    ``device``, e.g. from ``convert.params_from_numpy``) and ``tokens``
    default to seeded random ones.  Prints the family's line and returns
    {"arch", "family", "tok_s", "tokens" (B, gen) int64 numpy: the
    prefill's argmax, then each decoded one, "line"}."""
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, param_dtype=cfg.dtype)
    model = LanguageModel(cfg, device=device)
    if params is None:
        params = model.init(torch.Generator().manual_seed(0))
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab_size, (B, PROMPT),
                               generator=torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(np.array(tokens, dtype=np.int64)).to(device)
    b, prompt = tokens.shape
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens})
        cache = model.alloc_cache(b, prompt + gen, init=cache)
        tok = torch.argmax(logits, -1)[:, None]
        out = [tok]
        # the reference's warm-up call: it fills position PROMPT, and the
        # timed loop starts one position on with the same token
        _, cache = model.decode_step(params, cache, tok, prompt)
        _sync(device)
        t0 = time.perf_counter()
        for i in range(1, gen):
            logits, cache = model.decode_step(params, cache, tok, prompt + i)
            tok = torch.argmax(logits, -1)[:, None]
            out.append(tok)
        _sync(device)
        dt = time.perf_counter() - t0
    tok_s = b * (gen - 1) / dt
    state_note = ""
    if cfg.family == "ssm":
        state_note = " (cache size independent of context — SSD state only)"
    line = (f"{arch:16s} [{cfg.family:6s}] {tok_s:7.1f} tok/s"
            f"{state_note}")
    print(line)
    return {"arch": arch, "family": cfg.family, "tok_s": tok_s,
            "tokens": torch.cat(out, 1).cpu().numpy(), "line": line}


def main(device: str = "cuda", archs=ARCHS, gen: int = GEN, params=None,
         tokens=None) -> list:
    """Serve each of ``archs``; ``params`` / ``tokens`` map an arch to its
    tree / prompts (default: seeded random).  Returns :func:`serve`'s
    results in order."""
    params, tokens = params or {}, tokens or {}
    return [serve(a, device, gen, params.get(a), tokens.get(a))
            for a in archs]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
