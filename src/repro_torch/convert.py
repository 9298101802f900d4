"""Parameters from the reference's weight tree.

``params_from_numpy`` takes the reference's parameter pytree with every
leaf already a numpy array (e.g. ``jax.tree_util.tree_map(np.asarray,
params)`` on the reference side) and returns the port's parameters:
the same nested names and shapes, as tensors on ``device``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.layers import resolve_device


def _tensor(leaf: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(leaf)
    if arr.dtype.name == "bfloat16":
        # numpy has no native bf16 (the reference's arrays carry the
        # ml_dtypes extension type): move the raw 16-bit patterns
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def params_from_numpy(tree: Dict[str, Any], cfg, device="cuda") -> Dict[str, Any]:
    """Nested dict of numpy arrays → the same nested dict of tensors.

    ``cfg`` names the model the tree belongs to; the tree must carry the
    stacked decoder layers of a dense model of that width and depth.
    """
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(np.asarray(node), dev)

    out = conv(tree)
    w_q = out["layers"]["attn"]["w_q"]
    want = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim)
    if tuple(w_q.shape) != want:
        raise ValueError(f"layers.attn.w_q is {tuple(w_q.shape)}, config "
                         f"{cfg.name} wants {want}")
    return out
