"""Fault-tolerant trainer orchestrated through the OCR core runtime.

The torch port of ``repro.train.trainer``.  The step sequence is built
with the paper's §4 labeled-GUID map: a map of step tasks indexed by step
number whose creator wires step *i* to depend on step *i−1*'s output
event — the 1-D degenerate case of the paper's 2-D wavefront.
Checkpoint tasks hang off every k-th step and write the host copy of the
state through the §5 chunked file layer (``repro_torch.ckpt``).

Fault tolerance: ``run`` stops cleanly at a simulated failure step
(``kill_node(0)``); a new ``Trainer`` with the same config resumes from
the last *committed* manifest and — because the data pipeline is
stateless per step — replays exactly the batches the lost steps would
have seen.  A step-time watchdog flags stragglers, and every step stamps
the ``train.*`` gauges of the runtime's monitoring registry.

The step runs eagerly on the model's device (there is no ``jit``):
attention above ``cfg.attn_flash_min_seq`` runs the flash kernels, K1
with the logsumexp forward and K3 (K2 in deterministic mode) backward.
Single device only: a ``mesh`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import ckpt
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import (DbMode, EDT_PROP_MAPPED, NULL_GUID,
                              Runtime, UNINITIALIZED_GUID, spawn_main)
from repro_torch.models.model import LanguageModel
from repro_torch.optim import OptimizerConfig
from .steps import init_train_state, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = ""
    ckpt_every: int = 0              # 0 → no checkpoints
    async_ckpt: bool = True
    fail_at_step: int = -1           # inject a failure (tests)
    straggler_factor: float = 3.0    # watchdog threshold × median step time
    log_every: int = 10


class Trainer:
    def __init__(self, model: LanguageModel, oc: OptimizerConfig,
                 data, tc: TrainerConfig, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "the torch trainer runs on one device; meshes are not "
                "ported yet")
        self.model = model
        self.oc = oc
        self.data = data
        self.tc = tc
        self._step_fn = None
        self.history: List[Dict[str, float]] = []
        self.straggler_steps: List[int] = []
        self._ckpt_threads: List[Any] = []

    # ------------------------------------------------------------ lifecycle

    def _build(self):
        if self._step_fn is None:
            self._step_fn = make_train_step(self.model, self.oc)
        return self._step_fn

    def init_or_restore(self, generator: torch.Generator) -> Dict[str, Any]:
        """The last committed checkpoint under ``tc.ckpt_dir`` on the
        model's device, else a fresh state drawn from ``generator``."""
        tc = self.tc
        if tc.ckpt_dir and ckpt.latest_step(tc.ckpt_dir) is not None:
            tree, step = ckpt.restore(tc.ckpt_dir)
            self.start_step = step
            return state_from_numpy(tree, self.model.device)
        self.start_step = 0
        return init_train_state(self.model, generator, self.oc)

    # ----------------------------------------------------------------- run

    def run(self, state: Dict[str, Any], num_steps: int,
            start_step: Optional[int] = None) -> Dict[str, Any]:
        start = self.start_step if start_step is None else start_step
        step_fn = self._build()
        tc = self.tc
        device = self.model.device
        holder = {"state": state}
        durations: List[float] = []

        rt = Runtime(num_nodes=2)
        smap_holder: Dict[str, Any] = {}

        def step_body(paramv, depv, api):
            idx = paramv[0]
            i = start + idx
            if tc.fail_at_step >= 0 and i == tc.fail_at_step:
                api.rt.kill_node(0)      # fail-stop: nothing after this runs
                return NULL_GUID
            t0 = time.perf_counter()
            batch = self.data.get(i)
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()}
            holder["state"], metrics = step_fn(holder["state"], batch)
            # reading the metrics waits for the step's device work
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            durations.append(dt)
            med = float(np.median(durations))
            if len(durations) > 5 and dt > tc.straggler_factor * med:
                self.straggler_steps.append(i)
            m["step"] = i
            m["step_time"] = dt
            self.history.append(m)
            # stamp step metrics into the monitoring registry: the train.*
            # namespace is live alongside the runtime's io.*/spill.* gauges
            reg = rt.registry
            reg.set("train.step", float(i))
            reg.set("train.loss", m.get("loss", 0.0))
            reg.set("train.step_time_s", dt)
            reg.inc("train.steps")
            if rt._mon is not None:
                reg.histogram("train.step_wall_s").observe(dt)
            if tc.ckpt_every and tc.ckpt_dir and (i + 1) % tc.ckpt_every == 0:
                # checkpoint hangs off this step's event; §5 chunked write
                # of the host copy, §3 issue-now/resolve-later
                host = state_to_numpy(holder["state"])
                if tc.async_ckpt:
                    self._ckpt_threads.append(
                        ckpt.async_save(tc.ckpt_dir, host, i + 1))
                else:
                    ckpt.save(tc.ckpt_dir, host, i + 1)
            # the paper's wavefront pattern: this task satisfies the next
            # step task's pre-slot via the §4 labeled map
            if idx + 1 < num_steps:
                nxt = api.map_get(smap_holder["map"], idx + 1)
                api.add_dependence(NULL_GUID, nxt, 0, DbMode.NULL)
            return NULL_GUID

        def creator(ctx_api, object_lid, index, paramv, guidv):
            deps = [NULL_GUID] if index == 0 else [UNINITIALIZED_GUID]
            ctx_api.edt_create(guidv[0], paramv=[index], depv=deps,
                               props=EDT_PROP_MAPPED, mapped_id=object_lid)

        def main(paramv, depv, api):
            tmpl = api.edt_template_create(step_body, 1, 1)
            smap = api.map_create(num_steps, creator, guidv=[tmpl])
            smap_holder["map"] = smap
            api.map_get(smap, 0)     # seed the chain
            return NULL_GUID

        spawn_main(rt, main)
        rt.run()
        for t in self._ckpt_threads:
            t.join()
        if self.history:
            last = self.history[-1]
            rt.stats.moe_dropped_tokens = int(
                last.get("moe_dropped_tokens", 0))
            rt.stats.moe_overflow_rate = float(
                last.get("moe_overflow_rate", 0.0))
            rt.stats.moe_a2a_bytes = int(last.get("moe_a2a_bytes", 0))
        self.last_runtime_stats = rt.stats
        self.registry = rt.registry
        return holder["state"]
