"""Shared neural-net layers: norms (RMSNorm, and whisper's LayerNorm),
RoPE, the SwiGLU and GELU MLPs, initializers.

Plain functions on tensors over dict parameter trees whose names and
shapes match ``repro.models.layers``, so one weight set feeds both
packages.  Numerics follow the reference: norms and RoPE run in fp32 and
cast back to the input dtype.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is absent —
    an entry point asked for the card never carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    return dev


# Leaves kept in fp32 regardless of compute dtype (numerics-sensitive).
_FP32_LEAVES = {"A_log", "dt_bias", "D", "router"}


def cast_params(params: Params, dtype_name: str) -> Params:
    """Cast fp32 master weights to the compute dtype at point of use.
    Single device, so a dtype cast only (no sharding constraint)."""
    dt = _dtype(dtype_name)

    def cast(name, leaf):
        if isinstance(leaf, dict):
            return {k: cast(k, v) for k, v in leaf.items()}
        if name in _FP32_LEAVES or leaf.dtype != torch.float32:
            return leaf
        return leaf.to(dt)

    return {k: cast(k, v) for k, v in params.items()}


# ----------------------------------------------------------------- initializers

def stack_trees(trees):
    """Per-layer trees of one structure → one tree of (n, ...) stacks."""
    first = trees[0]
    return {k: stack_trees([t[k] for t in trees]) if isinstance(first[k], dict)
            else torch.stack([t[k] for t in trees]) for k in first}


def dense_init(gen: torch.Generator, in_dim: int, out_shape: Tuple[int, ...],
               dtype: torch.dtype) -> torch.Tensor:
    scale = 1.0 / np.sqrt(in_dim)
    w = torch.randn((in_dim, *out_shape), generator=gen, device=gen.device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    scale = 1.0 / np.sqrt(dim)        # keeps tied-unembedding logits O(1)
    w = torch.randn((vocab, dim), generator=gen, device=gen.device)
    return (w * scale).to(dtype)


# ----------------------------------------------------------------------- norms

def rmsnorm_init(dim: int, dtype: torch.dtype, device) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(dim: int, dtype: torch.dtype, device) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32 with the population variance (``jnp.var``'s),
    scale and bias applied in fp32, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


# ------------------------------------------------------------------------ RoPE

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    # one host-to-device copy per (head_dim, theta, device): a copy per
    # call would make every decode layer wait for the device
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    freqs = _rope_freqs_on(head_dim, float(theta), x.device)
    angles = positions[..., :, None].float() * freqs          # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------------- MLP

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype) -> Params:
    return {
        "w_gate": dense_init(gen, d_model, (d_ff,), dtype),
        "w_up": dense_init(gen, d_model, (d_ff,), dtype),
        "w_down": dense_init(gen, d_ff, (d_model,), dtype),
    }


def mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP (llama/qwen/mistral family): silu in fp32, cast to x's
    dtype, then times the up projection."""
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ params["w_down"]


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype: torch.dtype) -> Params:
    return {
        "w_in": dense_init(gen, d_model, (d_ff,), dtype),
        "b_in": torch.zeros((d_ff,), dtype=dtype, device=gen.device),
        "w_out": dense_init(gen, d_ff, (d_model,), dtype),
        "b_out": torch.zeros((d_model,), dtype=dtype, device=gen.device),
    }


def gelu_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """GELU MLP (whisper): the tanh approximation (``jax.nn.gelu``'s
    default) in fp32, cast to x's dtype."""
    h = x @ params["w_in"] + params["b_in"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ params["w_out"] + params["b_out"]
