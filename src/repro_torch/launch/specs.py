"""Shape stand-ins and sharding trees (torch port of
``repro.launch.specs``).

``batch_specs(cfg, shape)`` gives a cell's model inputs as ``meta``
tensors (shapes and dtypes, no storage); the ``*_shardings`` derive
:class:`~repro_torch.dist.sharding.NamedSharding` trees from the logical
rules of ``repro_torch.dist.sharding``.  Parameter and state shapes come
from the port's ``init`` on the meta device, where the reference uses
``jax.eval_shape``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.sharding import (NamedSharding, ShardCtx,
                                       _map_with_path, state_shardings_of)
from repro_torch.models.model import param_shapes
from repro_torch.optim import OptimizerConfig, init_opt_state


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Training / prefill batch of one cell, as meta tensors."""
    b, s = shape.global_batch, shape.seq_len
    bf = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    out: Dict[str, Any] = {}
    s_text = s
    if cfg.family == "vlm":
        s_text = s - cfg.num_patches
        out["patches"] = _meta((b, cfg.num_patches, cfg.d_model), bf)
    if cfg.family == "encdec":
        out["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), bf)
    out["tokens"] = _meta((b, s_text), torch.int32)
    if shape.kind == "train":
        out["targets"] = _meta((b, s_text), torch.int32)
    return out


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, ctx: ShardCtx
                    ) -> Dict[str, Any]:
    """Each batch leaf's leading dim over "dp", the rest replicated."""
    return {k: NamedSharding(ctx.mesh, ctx.spec(
        leaf.shape, "dp", *([None] * (leaf.ndim - 1))))
        for k, leaf in batch_specs(cfg, shape).items()}


def params_only_specs(cfg: ModelConfig) -> Any:
    """The parameter tree on the meta device."""
    return param_shapes(cfg)


def state_specs(cfg: ModelConfig, oc: OptimizerConfig) -> Any:
    """The train state ``{"params", "opt"}`` on the meta device."""
    params = param_shapes(cfg)
    return {"params": params, "opt": init_opt_state(params, oc)}


def state_shardings(cfg: ModelConfig, oc: OptimizerConfig, ctx: ShardCtx
                    ) -> Any:
    return state_shardings_of(state_specs(cfg, oc), ctx)


# ------------------------------------------------------------- decode cache

_CACHE_RULES = {
    # leaf name -> logical axes for the *trailing* dims (leading stack dims None)
    "k": (None, "dp", None, "kv_seq", None),      # head-major (B,K,S,hd)
    "v": (None, "dp", None, "kv_seq", None),
    "c_kv": (None, "dp", "kv_seq", None),
    "k_rope": (None, "dp", "kv_seq", None),
    "cross_k": (None, "dp", None, None, None),
    "cross_v": (None, "dp", None, None, None),
    "conv_x": (None, "dp", None, "tp"),
    "conv_B": (None, "dp", None, None),
    "conv_C": (None, "dp", None, None),
    "state": (None, "dp", "tp", None, None),
}


def cache_shardings(cache_tree: Any, ctx: ShardCtx) -> Any:
    """Shardings of a decode cache tree (``alloc_cache`` layout) by leaf
    name; leaves with no rule replicate."""
    def leaf_sh(path, leaf):
        rule = _CACHE_RULES.get(path[-1])
        shape = tuple(leaf.shape)
        if rule is None:
            return NamedSharding(ctx.mesh, (None,) * len(shape))
        pad = len(shape) - len(rule)
        if pad < 0:
            rule, pad = rule[-len(shape):], 0
        return NamedSharding(ctx.mesh,
                             ctx.spec(shape, *((None,) * pad + rule)))

    return _map_with_path(leaf_sh, cache_tree)
