"""Parameters and train states to and from numpy trees.

``params_from_numpy`` takes the reference's parameter pytree with every
leaf already a numpy array (e.g. ``jax.tree_util.tree_map(np.asarray,
params)`` on the reference side) and returns the port's parameters:
the same nested names and shapes, as tensors on ``device``.

``state_to_numpy`` / ``state_from_numpy`` move a whole train state
(``{"params", "opt": {"m", "v", "step"}}``) between tensors and the host
arrays that ``repro_torch.ckpt`` writes, in the dtypes both packages
checkpoint: fp32 parameters and moments, int8 / uint8 quantized moments
with fp32 scales, and the int32 step.  Any other dtype raises — bf16
leaves would need ``ml_dtypes`` on the host.
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


_STATE_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int8): torch.int8,
                 np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int32): torch.int32}
_STATE_TORCH = set(_STATE_DTYPES.values())


def state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """Train state of tensors → the same nested dict of numpy arrays
    (copied to the host)."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if node.dtype not in _STATE_TORCH:
            raise TypeError(f"train-state leaf of dtype {node.dtype}: only "
                            f"fp32, int8, uint8 and int32 are checkpointed")
        return node.detach().cpu().numpy()
    return conv(state)


def state_from_numpy(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Nested dict of numpy arrays (a restored checkpoint, from either
    package) → the same tree of tensors on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype not in _STATE_DTYPES:
            raise TypeError(f"train-state leaf of dtype {arr.dtype}: only "
                            f"fp32, int8, uint8 and int32 are restored")
        return torch.from_numpy(np.array(arr, copy=True)).to(dev)
    return conv(tree)
