"""Training step: loss + grad + AdamW update, with gradient accumulation.

The train state is a plain nested dict (checkpoint-friendly), with the
reference's leaf names:
  {"params": ..., "opt": {"m", "v", "step"}}

The step runs eagerly (there is no ``jit``) and updates the state in
place: gradients come from ``torch.autograd.grad`` on detached views of
the parameters, and ``adamw_update`` writes the new parameters and
moments into the same tensors, where the reference donates the state
buffers to its jitted step.

Under a mesh (``dist.sharding.use_mesh`` around the call) the state is
this rank's shards (``dist.sharding.state_shardings_of``) and the batch
the whole batch: ``train_loss`` computes the rank's "dp" rows and sums
each shard's gradient over "dp", and ``adamw_update`` takes the
parameters' shardings for the norm and the int8 row scales.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.dist.sharding import current_ctx, param_shardings
from repro_torch.models.model import LanguageModel, param_shapes
from repro_torch.optim import OptimizerConfig, adamw_update, init_opt_state
from repro_torch.optim.adamw import iter_leaves

TrainState = Dict[str, Any]

# metrics summed over micro-batches; the rest are averaged
_SUMMED = ("tokens", "moe_dropped_tokens", "moe_a2a_bytes")


def init_train_state(model: LanguageModel, generator: torch.Generator,
                     oc: OptimizerConfig) -> TrainState:
    params = model.init(generator)
    return {"params": params, "opt": init_opt_state(params, oc)}


def _with_grad(params: Any) -> Any:
    """The parameter tree as detached views that require grad: the
    graph's leaves, sharing storage with the state."""
    return {k: _with_grad(v) if isinstance(v, dict)
            else v.detach().requires_grad_(True) for k, v in params.items()}


def _like(tree: Any, leaves) -> Any:
    it = iter(leaves)

    def build(node):
        return {k: build(node[k]) if isinstance(node[k], dict) else next(it)
                for k in sorted(node)}
    return build(tree)


def make_train_step(model: LanguageModel, oc: OptimizerConfig):
    """Returns train_step(state, batch) -> (state, metrics); the state is
    updated in place and returned."""

    def grads_of(params, batch):
        leaf_params = _with_grad(params)
        loss, metrics = model.train_loss(leaf_params, batch)
        leaves = [leaf for _path, leaf in iter_leaves(leaf_params)]
        grads = torch.autograd.grad(loss, leaves)
        return _like(params, grads), {k: v.detach()
                                      for k, v in metrics.items()}

    def grads_accum(params, batch):
        a = oc.accum_steps
        if a <= 1:
            return grads_of(params, batch)
        acc_dt = (torch.bfloat16 if oc.accum_dtype == "bfloat16"
                  else torch.float32)
        micro = {k: v.reshape(a, v.shape[0] // a, *v.shape[1:])
                 for k, v in batch.items()}
        g_acc = m_acc = None
        for i in range(a):
            g, m = grads_of(params, {k: v[i] for k, v in micro.items()})
            if g_acc is None:
                g_acc = _like(params, [torch.zeros(x.shape, dtype=acc_dt,
                                                   device=x.device)
                                       for _p, x in iter_leaves(g)])
                m_acc = {k: torch.zeros((), dtype=torch.float32,
                                        device=v.device)
                         for k, v in m.items()}
            for (_p, acc), (_q, x) in zip(iter_leaves(g_acc), iter_leaves(g)):
                acc.copy_(acc + x.to(acc.dtype))
            m_acc = {k: m_acc[k] + m[k] for k in m_acc}
        g = _like(params, [x / a for _p, x in iter_leaves(g_acc)])
        return g, {k: v / a if k not in _SUMMED else v
                   for k, v in m_acc.items()}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        grads, metrics = grads_accum(state["params"], batch)
        ctx = current_ctx()
        shardings = (param_shardings(param_shapes(model.cfg), ctx)
                     if ctx.active else None)
        _params, _opt, opt_metrics = adamw_update(
            oc, grads, state["params"], state["opt"], shardings)
        return state, {**metrics, **opt_metrics}

    return train_step
