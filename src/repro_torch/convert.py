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
    stacked layers of that family at that width and depth: the decoder
    layers' ``layers.attn.w_q`` (L, D, H, hd) for dense and vlm; for moe
    the MoE layers' ``layers.attn.w_q`` and ``layers.moe.w_gate``
    (L − first_k_dense, D, H, hd) and (…, E, D, moe_d_ff), and with
    ``first_k_dense`` the dense layers' ``dense_layers.attn.w_q``; under
    MLA (deepseek-v2), which has no ``w_q``, ``attn.w_uq`` (…,
    q_lora_rank, H, qk_nope_head_dim + qk_rope_head_dim) and
    ``attn.w_dkv`` (…, D, kv_lora_rank + qk_rope_head_dim) of both stacks
    in its place; the Mamba layers' ``layers.mixer.w_x`` (L, D, d_inner)
    for ssm and hybrid, and for hybrid also the one shared block's
    ``shared_attn.attn.w_q`` (D, H, hd); for encdec (whisper) the encoder
    layers' ``enc_layers.attn.w_q`` (Le, D, H, hd), and the decoder
    layers' ``dec_layers.attn.w_q`` and ``dec_layers.cross.w_q`` (L, D, H,
    hd) and ``dec_layers.mlp.w_in`` (L, D, d_ff).  A mismatch raises.
    """
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(np.asarray(node), dev)

    out = conv(tree)
    L, D = cfg.num_layers, cfg.d_model
    attn = (cfg.num_heads, cfg.head_dim)
    if cfg.family in ("ssm", "hybrid"):
        checks = [(("layers", "mixer", "w_x"), (L, D, cfg.d_inner))]
        if cfg.family == "hybrid":
            checks.append((("shared_attn", "attn", "w_q"), (D, *attn)))
    elif cfg.family == "encdec":
        checks = [(("enc_layers", "attn", "w_q"),
                   (cfg.num_encoder_layers, D, *attn)),
                  (("dec_layers", "attn", "w_q"), (L, D, *attn)),
                  (("dec_layers", "cross", "w_q"), (L, D, *attn)),
                  (("dec_layers", "mlp", "w_in"), (L, D, cfg.d_ff))]
    elif cfg.family == "moe":
        n, k = L - cfg.first_k_dense, cfg.first_k_dense

        def attn_checks(stack, m):
            if not cfg.use_mla:
                return [((stack, "attn", "w_q"), (m, D, *attn))]
            dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            return [((stack, "attn", "w_uq"),
                     (m, cfg.q_lora_rank, cfg.num_heads, dqk)),
                    ((stack, "attn", "w_dkv"),
                     (m, D, cfg.kv_lora_rank + cfg.qk_rope_head_dim))]

        checks = attn_checks("layers", n) + [
            (("layers", "moe", "w_gate"),
             (n, cfg.num_experts, D, cfg.moe_d_ff or cfg.d_ff))]
        if k:
            checks += attn_checks("dense_layers", k)
    else:
        checks = [(("layers", "attn", "w_q"), (L, D, *attn))]
    for path, want in checks:
        node = out
        for key in path:
            if not isinstance(node, dict) or key not in node:
                raise ValueError(f"{'.'.join(path)} is missing: config "
                                 f"{cfg.name} ({cfg.family}) wants {want}")
            node = node[key]
        if tuple(node.shape) != want:
            raise ValueError(f"{'.'.join(path)} is {tuple(node.shape)}, "
                             f"config {cfg.name} wants {want}")
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
    package) → the same tree of tensors on ``device``.  (Under a mesh a
    rank restores only its shards: ``ckpt.restore(shardings=)``.)"""
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


def place_state(state: Dict[str, Any], mesh,
                pure_dp: bool = False) -> Dict[str, Any]:
    """A whole train state of tensors → this rank's shards on ``mesh``
    (contiguous copies on the leaves' device; in ``pure_dp`` mode every
    leaf stays whole).  The whole leaves leave ``state`` as their shards
    are made (``dist.sharding.shard_tree``)."""
    import torch.distributed as dist
    from repro_torch.dist.sharding import (ShardCtx, shard_tree,
                                           state_shardings_of)
    shardings = state_shardings_of(state, ShardCtx(mesh, pure_dp=pure_dp))
    return shard_tree(state, shardings, dist.get_rank())
