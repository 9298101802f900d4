"""AdamW with optional int8-quantized moment states.

The semantics of ``repro.optim.adamw``, not ``torch.optim.AdamW``'s:
fp32 bias corrections ``1 − b**t`` from the step counter, a global-norm
clip over every gradient leaf, decoupled weight decay added to the
update before it is scaled by the learning rate, no decay on the leaves
named in ``_NO_DECAY``, and the warmup-then-cosine ``lr_at`` schedule.

``state_dtype="int8"`` stores both moments in 8 bits with per-row
scales, as the reference does for the ≥100B configs:

* ``m`` — signed linear quantization (row max-abs / 127);
* ``v`` — non-negative, huge dynamic range → quartic-root companding:
  ``q = round(255 · (v / vmax)^(1/4))``.

Unlike the reference, which returns new arrays, :func:`adamw_update`
updates the parameters and the optimizer state **in place** (a training
step then needs no second copy of either) and returns the same objects.

Under a mesh it takes each leaf's sharding and updates the rank's local
shards (the update is elementwise).  Two parts are not: the clip's
global norm adds each leaf's local Σ g² over the ranks that split it
(a replicated leaf counts once), and an int8 moment's row scale, a max
over the last axis, takes the max over the ranks that split that axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    state_dtype: str = "float32"      # float32 | int8
    accum_steps: int = 1
    accum_dtype: str = "float32"      # bfloat16 halves the grad accumulator


def lr_at(oc: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = oc.peak_lr * step / max(oc.warmup_steps, 1)
    prog = torch.clamp((step - oc.warmup_steps)
                       / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = oc.min_lr_frac + (1 - oc.min_lr_frac) * 0.5 * (
        1 + torch.cos(np.pi * prog))
    return torch.where(step < oc.warmup_steps, warm, oc.peak_lr * cos)


# ----------------------------------------------------------- int8 compansion

def _row_max(x: torch.Tensor, row_axes) -> torch.Tensor:
    """Max over the last axis, and over the mesh axes that split it."""
    out = x.amax(dim=-1, keepdim=True)
    if row_axes:
        from repro_torch.dist.sharding import all_reduce, current_ctx
        out = all_reduce(out, row_axes, current_ctx(), op="max")
    return out


def _quant_m(m: torch.Tensor, row_axes=()) -> Dict[str, torch.Tensor]:
    scale = _row_max(m.abs(), row_axes) / 127.0
    scale = torch.clamp(scale, min=1e-20)
    q = torch.clamp(torch.round(m / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def _dequant_m(s: Dict[str, torch.Tensor]) -> torch.Tensor:
    return s["q"].float() * s["scale"]


def _quant_v(v: torch.Tensor, row_axes=()) -> Dict[str, torch.Tensor]:
    vmax = torch.clamp(_row_max(v, row_axes), min=1e-30)
    q = torch.round(255.0 * torch.sqrt(torch.sqrt(v / vmax)))
    return {"q": torch.clamp(q, 0, 255).to(torch.uint8),
            "scale": vmax.float()}


def _dequant_v(s: Dict[str, torch.Tensor]) -> torch.Tensor:
    r = s["q"].float() / 255.0
    return torch.square(torch.square(r)) * s["scale"]


def _zeros_like_state(p: torch.Tensor, quant: bool, signed: bool):
    if not quant:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    scale_shape = p.shape[:-1] + (1,) if p.ndim else (1,)
    return {"q": torch.zeros(p.shape, device=p.device,
                             dtype=torch.int8 if signed else torch.uint8),
            "scale": torch.zeros(scale_shape, dtype=torch.float32,
                                 device=p.device)}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def init_opt_state(params: Any, oc: OptimizerConfig) -> Dict[str, Any]:
    quant = oc.state_dtype == "int8"
    device = next(iter_leaves(params))[1].device
    return {"m": _map(lambda p: _zeros_like_state(p, quant, True), params),
            "v": _map(lambda p: _zeros_like_state(p, quant, False), params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def iter_leaves(tree: Any, prefix: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) of a nested dict in sorted-key order — the order
    in which JAX flattens a dict pytree."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from iter_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _at(tree: Any, path: Tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _sum_squares(leaf: torch.Tensor) -> torch.Tensor:
    """fp32 Σ leaf², over pieces of at most ``CHUNK_BYTES`` of fp32 so
    that a large bf16 leaf (a MoE layer stack's expert bank) is never
    held in fp32 whole."""
    flat = leaf.reshape(-1)
    n = max(1, CHUNK_BYTES // 4)
    return sum(torch.sum(torch.square(c.float())) for c in flat.split(n))


def global_norm(tree: Any, shardings: Any = None) -> torch.Tensor:
    """√Σ g² over every leaf.  With ``shardings`` (the leaves are this
    rank's shards) the local sums of the leaves split over the same mesh
    axes are added, then summed over those axes; a replicated leaf's sum
    is its own."""
    if shardings is None:
        return torch.sqrt(sum(_sum_squares(leaf)
                              for _path, leaf in iter_leaves(tree)))
    from repro_torch.dist.sharding import all_reduce, current_ctx
    groups: Dict[Tuple[str, ...], torch.Tensor] = {}
    for path, leaf in iter_leaves(tree):
        axes = _at(shardings, path).sharded_axes()
        groups[axes] = groups.get(axes, 0) + _sum_squares(leaf)
    return torch.sqrt(sum(all_reduce(sq, axes, current_ctx())
                          for axes, sq in groups.items()))


_NO_DECAY = {"scale", "bias", "A_log", "dt_bias", "D", "b_q", "b_k", "b_v",
             "b_in", "b_out", "conv_b_x", "conv_b_B", "conv_b_C"}

# Stacked leaves above this size update layer by layer (and a layer's
# slice that is still above it, such as a MoE layer's (E, D, F) expert
# bank, expert by expert), so the fp32 temporaries stay one slice in
# size; tests may lower it.
CHUNK_BYTES = 128 * 1024 * 1024


def _assign(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]):
    for k, v in src.items():
        dst[k].copy_(v)


def _slice(s, i):
    return {k: v[i] for k, v in s.items()} if isinstance(s, dict) else s[i]


@torch.no_grad()
def adamw_update(oc: OptimizerConfig, grads: Any, params: Any,
                 opt_state: Dict[str, Any], shardings: Any = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place on ``params`` and ``opt_state``.  Returns
    (params, opt_state, metrics) — the same objects, updated.  Under a
    mesh ``shardings`` (the parameters' ``NamedSharding`` tree) says how
    the leaves are cut: the norm and the int8 row scales then run over
    the ranks (module docs)."""
    quant = oc.state_dtype == "int8"
    step = opt_state["step"]
    step += 1
    lr = lr_at(oc, step)
    gnorm = global_norm(grads, shardings)
    clip = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    t = step.float()
    bc1 = 1.0 - torch.pow(oc.b1, t)
    bc2 = 1.0 - torch.pow(oc.b2, t)

    def leaf_update(p, g, m_s, v_s, decay: bool, row_axes):
        g = g.float() * clip
        m = _dequant_m(m_s) if quant else m_s
        v = _dequant_v(v_s) if quant else v_s
        m.mul_(oc.b1).add_((1 - oc.b1) * g)
        v.mul_(oc.b2).add_((1 - oc.b2) * torch.square(g))
        upd = (m / bc1) / (torch.sqrt(v / bc2) + oc.eps)
        if decay:
            upd = upd + oc.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))
        if quant:
            _assign(m_s, _quant_m(m, row_axes))
            _assign(v_s, _quant_v(v, row_axes))

    def chunked_update(p, g, m_s, v_s, decay: bool, row_axes=()):
        # chunk only over a genuine stack dim (small leading extent, ndim
        # >= 3), as the reference does for layers; the update is
        # elementwise and the int8 scales are per row of the last dim, so
        # any slicing of the leading dims gives the same bits
        if p.numel() * 4 > CHUNK_BYTES and p.ndim >= 3 and \
                1 < p.shape[0] <= 256:
            for i in range(p.shape[0]):
                chunked_update(p[i], g[i], _slice(m_s, i), _slice(v_s, i),
                               decay, row_axes)
        else:
            leaf_update(p, g, m_s, v_s, decay, row_axes)

    for path, p in iter_leaves(params):
        g = _at(grads, path)
        m_s, v_s = _at(opt_state["m"], path), _at(opt_state["v"], path)
        decay = bool(oc.weight_decay) and path[-1] not in _NO_DECAY
        row_axes = ()
        if shardings is not None and p.ndim:
            spec = _at(shardings, path).spec[-1]
            row_axes = () if spec is None else (
                (spec,) if isinstance(spec, str) else tuple(spec))
        chunked_update(p, g, m_s, v_s, decay, row_axes)
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
