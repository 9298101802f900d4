"""The paper's §4 wavefront as a *pipeline-parallel* schedule on real
compute, on the PyTorch port.

The port's counterpart of ``examples/wavefront_pipeline.py``: a 2-D
labeled-GUID map of ``repro_torch.core`` over (microbatch × stage) where
each cell runs one torch transformer-stage forward
(``repro_torch.models.blocks.decoder_layer_train``, reduced llama3.2-3b)
on the device and satisfies the pre-slots of its right (next
microbatch, same stage) and down (same microbatch, next stage)
neighbours — the dependence structure of GPipe/1F1B, driven by the
paper's creator-function mechanism.  The schedule runs on the runtime's
virtual clock, so the order and makespan lines do not depend on the
device; the pipeline's outputs must equal the stages run in sequence,
bit for bit.  The card is the default; there is no fallback: without
one the model raises.

Run:  PYTHONPATH=src python examples/torch_wavefront_pipeline.py [--device cpu]
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config
from repro_torch.core import (DbMode, EDT_PROP_MAPPED, NULL_GUID, Runtime,
                              UNINITIALIZED_GUID, spawn_main)
from repro_torch.models import blocks
from repro_torch.models.layers import resolve_device
from repro_torch.models.model import layer_params

MICRO = 4      # microbatches
STAGES = 3     # pipeline stages (layers per stage: 1 smoke layer)
B, S = 2, 32

cfg = get_config("llama3.2-3b").reduced()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def main(device: str = "cuda", params=None, inputs=None) -> dict:
    """Run the pipeline and check it against the sequential stages.
    ``params``: a tree whose ``layers`` stack the STAGES stage layers on
    ``device`` (``convert.params_from_numpy`` of a ``num_layers=STAGES``
    config), default seeded random; ``inputs``: (MICRO, B, S, d_model)
    activations, default seeded random × 0.02.  Prints the reference's
    lines and returns {"cells", "makespan", "order" [(m, s, t)],
    "outputs" [MICRO tensors on ``device``], "max_err", "lines"}."""
    dev = resolve_device(device)
    if params is None:
        stage_params = [_to(blocks.decoder_layer_init(
            torch.Generator().manual_seed(i), cfg, "dense"), dev)
            for i in range(STAGES)]
    else:
        stage_params = [layer_params(params["layers"], i)
                        for i in range(STAGES)]
    if inputs is None:
        inputs = [torch.randn((B, S, cfg.d_model),
                              generator=torch.Generator().manual_seed(100 + m))
                  * 0.02 for m in range(MICRO)]
    positions = torch.arange(S, device=dev)[None, :]

    def stage_fwd(p, x):
        with torch.no_grad():
            y, _ = blocks.decoder_layer_train(p, x, cfg, positions, "dense")
        return y

    lines = []

    def say(line):
        print(line)
        lines.append(line)

    rt = Runtime(num_nodes=STAGES, net_latency=0.5)
    # activations flowing between cells, keyed by (micro, stage)
    acts = {(m, -1): torch.as_tensor(np.array(inputs[m], np.float32)).to(dev)
            for m in range(MICRO)}
    done = []
    state = {}

    def creator(ctx, lid, index, paramv, guidv):
        m, s = index % MICRO, index // MICRO
        deps = [NULL_GUID if m == 0 else UNINITIALIZED_GUID,
                NULL_GUID if s == 0 else UNINITIALIZED_GUID]
        ctx.edt_create(guidv[0], paramv=[index], depv=deps,
                       props=EDT_PROP_MAPPED, placement=s % STAGES)

    def cell(paramv, depv, api):
        idx = paramv[0]
        m, s = idx % MICRO, idx // MICRO
        acts[(m, s)] = stage_fwd(stage_params[s], acts[(m, s - 1)])
        done.append((m, s, api.rt.clock))
        if m + 1 < MICRO:                   # free the right neighbour
            t = api.map_get(state["map"], (m + 1) + s * MICRO)
            api.add_dependence(NULL_GUID, t, 0, DbMode.NULL)
        if s + 1 < STAGES:                  # free the down neighbour
            t = api.map_get(state["map"], m + (s + 1) * MICRO)
            api.add_dependence(NULL_GUID, t, 1, DbMode.NULL)
        return NULL_GUID

    def main_edt(paramv, depv, api):
        tmpl = api.edt_template_create(cell, 1, 2)
        state["map"] = api.map_create(MICRO * STAGES, creator, guidv=[tmpl])
        api.map_get(state["map"], 0)        # seed cell (0, 0)
        return NULL_GUID

    spawn_main(rt, main_edt)
    stats = rt.run()

    say(f"executed {len(done)} cells; virtual makespan={stats.makespan:.1f} "
        f"(critical path = {MICRO + STAGES - 1} waves)")
    say("wavefront order (micro, stage, t):")
    for m, s, t in done:
        say(f"  m{m} s{s} @ {t:5.1f}")

    # numerics check vs running the stages sequentially
    worst = 0.0
    for m in range(MICRO):
        x = acts[(m, -1)]
        for s in range(STAGES):
            x = stage_fwd(stage_params[s], x)
        err = float((x - acts[(m, STAGES - 1)]).abs().max())
        assert err == 0.0, err
        worst = max(worst, err)
    say("pipeline output == sequential output (exact)")
    return {"cells": len(done), "makespan": stats.makespan, "order": done,
            "outputs": [acts[(m, STAGES - 1)] for m in range(MICRO)],
            "max_err": worst, "lines": lines}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
