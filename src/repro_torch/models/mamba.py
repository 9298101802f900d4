"""Mamba2 (state-space duality) block: chunked scan, prefill and O(1)
decode, as ``repro.models.mamba``.

The SSD scan splits the sequence into chunks of ``ssm_chunk``: the
intra-chunk contribution is a masked matmul, the inter-chunk state a
short loop over chunks.  Prefill and training run it through
``ops.ssd_scan`` — K9 (backward K9b) on the card, its plain version on
the CPU (``repro_torch.kernels.ssd_scan``); the reference's jnp
``ssd_chunked`` computes the same function.  Decode is the
recurrent form: the state (B, H, P, N) and the conv tails are updated in
place per token, so the cache does not grow with the sequence.

Parameter names and shapes match the reference's, so one weight set
feeds both packages.

Under tensor parallelism (``models.tp``) a mixer whose ``w_x`` came as
the rank's share of ``d_inner`` runs a region on its channels and SSM
heads: ``w_z`` / ``w_x`` / ``conv_x`` / ``conv_b_x`` as they came,
``A_log`` / ``D`` / ``dt_bias``, the ``w_dt`` columns and the norm's
scale cut to them (those leaves are stored whole), the gated RMSNorm's
mean square summed over "model", and ``out_proj`` row-parallel.  B and
C are shared by every head, so every rank's scan reads all of them.
Where the stream's rows are the rank's stripe of the sequence, the rank
projects only its stripe (``x @ w_B``, ``x @ w_C``: 1/m of the rows, as
the reference's GSPMD layout gives a device its rows) and one
``gather_seq`` of the two hands every rank every row before the causal
convolutions, which run whole; the gradient reduce-scatters back to the
stripe.  Elsewhere (a stream whose rows do not split, decode) every rank
projects every row.  ``w_B`` / ``w_C`` and the convolutions' leaves see
part of their gradient on each rank either way (``tp.shared``).  Its
caches hold the rank's conv channels and state heads.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (current_ctx, gather_seq, psum, split,
                                       whole)
from repro_torch.kernels import ops as kernel_ops
from . import tp
from .layers import Params, _dtype, dense_init, rmsnorm, rmsnorm_init


def mamba_init(gen: torch.Generator, cfg) -> Params:
    """Projections stored separately per component (z, x, B, C, dt), as
    the reference keeps them for sharding."""
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h, ck = cfg.ssm_heads, cfg.conv_kernel
    dt = _dtype(cfg.param_dtype)
    dev = gen.device

    def conv(width):
        w = torch.randn((ck, width), generator=gen, device=dev)
        return (w / np.sqrt(ck)).to(dt)

    return {
        "w_z": dense_init(gen, d, (di,), dt),
        "w_x": dense_init(gen, d, (di,), dt),
        "w_B": dense_init(gen, d, (n,), dt),
        "w_C": dense_init(gen, d, (n,), dt),
        "w_dt": dense_init(gen, d, (h,), dt),
        "conv_x": conv(di),
        "conv_b_x": torch.zeros((di,), dtype=dt, device=dev),
        "conv_B": conv(n),
        "conv_b_B": torch.zeros((n,), dtype=dt, device=dev),
        "conv_C": conv(n),
        "conv_b_C": torch.zeros((n,), dtype=dt, device=dev),
        "A_log": torch.zeros((h,), dtype=torch.float32, device=dev),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(di, dt, dev),
        "out_proj": dense_init(gen, di, (d,), dt),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, log(1 + e^x) with no threshold (F.softplus turns
    linear above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d then silu, in fp32.  xbc: (B, S, C);
    w: (K, C)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(k):
        out = out + pad[:, i: i + s].float() * w[i].float()
    out = out + b.float()
    return F.silu(out).to(xbc.dtype)


def _bc_proj(params: Params, x: torch.Tensor, xf: torch.Tensor,
             split_: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Br, Cr) on every row.  On a stripe of the sequence (a mixer on the
    rank's share) the rank projects its stripe ``x`` and gathers both
    over "model"; else every row of ``xf`` (module docs)."""
    if not (split_ and tp.rows_split()):
        return xf @ params["w_B"], xf @ params["w_C"]
    n = params["w_B"].shape[-1]
    bc = gather_seq(torch.cat([x @ params["w_B"], x @ params["w_C"]], -1), 1)
    return bc[..., :n], bc[..., n:]


def _mamba_proj(params: Params, x: torch.Tensor, cfg, split_: bool = False):
    """Shared projection + conv for the train and prefill paths.  ``x`` is
    the stream's rows; a mixer on the rank's share enters its region with
    every row (``tp.enter``)."""
    xf = tp.enter(x) if split_ else x
    z = xf @ params["w_z"]
    xr = xf @ params["w_x"]
    Br, Cr = _bc_proj(params, x, xf, split_)
    dt_raw = xf @ params["w_dt"]
    xs = _causal_conv(xr, params["conv_x"], params["conv_b_x"])
    B = _causal_conv(Br, params["conv_B"], params["conv_b_B"])
    C = _causal_conv(Cr, params["conv_C"], params["conv_b_C"])
    dt = _softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    return z, xs, B, C, dt, A, (xr, Br, Cr)


def _mamba_out(params: Params, y_heads: torch.Tensor, xh: torch.Tensor,
               z: torch.Tensor, cfg, lead_shape, split_: bool = False
               ) -> torch.Tensor:
    y = y_heads.float() + params["D"].float()[:, None] * xh.float()
    y = y.reshape(*lead_shape, -1).to(z.dtype)
    y = y * F.silu(z.float()).to(z.dtype)
    if not split_:
        y = rmsnorm(params["norm"], y, cfg.norm_eps)
        return y @ params["out_proj"]
    # the gated RMSNorm over all of d_inner: the mean square of every
    # rank's channels (summed both ways: each rank's use of it is part
    # of its gradient)
    yf = y.float()
    ss = whole(psum(yf.square().sum(dim=-1, keepdim=True), "model"), "model")
    yn = yf * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
    y = (yn * params["norm"]["scale"].float()).to(y.dtype)
    return tp.leave(y @ params["out_proj"])


def _region(params: Params, cfg) -> Tuple[Params, int, bool]:
    """(the mixer's leaves as the layer computes with them, SSM heads,
    whether they are this rank's share): under tensor parallelism, when
    ``w_x`` came split, the per-head and per-channel leaves stored whole
    are cut to the rank's heads and channels and B / C's leaves are
    shared (module docs)."""
    h = cfg.ssm_heads
    if not tp.split_dim(params["w_x"].shape[-1], cfg.d_inner):
        return params, h, False
    m = current_ctx().model_size
    if h % m:
        raise NotImplementedError(
            f"d_inner {cfg.d_inner} splits over 'model' ({m}) but the "
            f"{h} SSM heads do not")
    p = dict(params)
    for name in ("A_log", "D", "dt_bias"):
        p[name] = split(params[name], 0, "model")
    p["w_dt"] = split(params["w_dt"], params["w_dt"].ndim - 1, "model")
    p["norm"] = {"scale": split(params["norm"]["scale"], 0, "model")}
    for name in ("w_B", "w_C", "conv_B", "conv_b_B", "conv_C", "conv_b_C"):
        p[name] = tp.shared(params[name])
    return p, h // m, True


def mamba_train(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence Mamba2 block.  The scan is ``ops.ssd_scan``: K9 on
    a CUDA tensor, whose backward is K9b; its plain chunked version on a
    CPU tensor, which autograd differentiates.  The final state is
    dropped, so the scan's backward sees no state gradient.  A mixer on
    the rank's share takes every row of the stream (``tp.enter``), B and
    C from its stripe (module docs), and hands back its summed output in
    the stream's layout; a whole one
    runs every row on every rank."""
    p, h, split_ = _region(params, cfg)
    if not split_:
        return tp.replicated(lambda xx: _train(p, xx, cfg, h, False), x)
    return _train(p, x, cfg, h, True)


def _train(p: Params, x: torch.Tensor, cfg, h: int, split_: bool):
    z, xs, B, C, dt, A, _ = _mamba_proj(p, x, cfg, split_)
    xh = xs.reshape(*xs.shape[:-1], h, cfg.ssm_head_dim)
    y, _ = kernel_ops.ssd_scan(xh, dt, A, B, C, chunk=cfg.ssm_chunk)
    return _mamba_out(p, y, xh, z, cfg, xs.shape[:-1], split_)


def mamba_prefill(params: Params, x: torch.Tensor, cfg
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill returning the recurrent cache (conv tails + SSD state).
    The scan goes through ``ops.ssd_scan``: K9 on the card, whose final
    state is the cache (the reference runs ``ssd_chunked`` here).  On the
    rank's share, as :func:`mamba_train`; the cache then holds its conv
    channels and state heads."""
    p, h, split_ = _region(params, cfg)
    box = {}

    def run(xx):
        out, box["cache"] = _prefill(p, xx, cfg, h, split_)
        return out

    out = run(x) if split_ else tp.replicated(run, x)
    return out, box["cache"]


def _prefill(p: Params, x: torch.Tensor, cfg, h: int, split_: bool):
    ck = cfg.conv_kernel
    z, xs, B, C, dt, A, (xr, Br, Cr) = _mamba_proj(p, x, cfg, split_)
    xh = xs.reshape(*xs.shape[:-1], h, cfg.ssm_head_dim)
    y, state = kernel_ops.ssd_scan(xh, dt, A, B, C, chunk=cfg.ssm_chunk)
    out = _mamba_out(p, y, xh, z, cfg, xs.shape[:-1], split_)
    # pre-activation conv tails, copied: a view would keep the whole
    # (B, S, C) projection alive for as long as the cache lives
    cache = {
        "conv_x": xr[:, -(ck - 1):, :].clone(),
        "conv_B": Br[:, -(ck - 1):, :].clone(),
        "conv_C": Cr[:, -(ck - 1):, :].clone(),
        "state": state.float(),
    }
    return out, cache


def _conv_step(tail: torch.Tensor, new: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor):
    """One-token causal conv: tail (B, K-1, C), new (B, 1, C) → (out
    (B, C), new tail (B, K-1, C))."""
    win = torch.cat([tail, new], dim=1)                        # (B, K, C)
    out = torch.einsum("bkc,kc->bc", win.float(), w.float())
    out = F.silu(out + b.float())
    return out.to(new.dtype), win[:, 1:, :]


def mamba_decode(params: Params, x: torch.Tensor, cfg,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step.  x: (B, 1, D).  The cache's tensors are
    updated in place (the reference returns new arrays) and returned.  On
    the rank's share (its conv channels and state heads), as
    :func:`mamba_train`."""
    params, h, split_ = _region(params, cfg)
    if split_:
        x = tp.enter(x)
    pdim = cfg.ssm_head_dim
    z = x @ params["w_z"]
    xr = x @ params["w_x"]
    Br = x @ params["w_B"]
    Cr = x @ params["w_C"]
    dt_raw = x @ params["w_dt"]

    xs, conv_x = _conv_step(cache["conv_x"], xr, params["conv_x"],
                            params["conv_b_x"])
    B1, conv_B = _conv_step(cache["conv_B"], Br, params["conv_B"],
                            params["conv_b_B"])
    C1, conv_C = _conv_step(cache["conv_C"], Cr, params["conv_C"],
                            params["conv_b_C"])

    dt = _softplus(dt_raw.float() + params["dt_bias"])[:, 0]  # (B, H)
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(xs.shape[0], h, pdim)                      # (B, H, P)
    dA = torch.exp(dt * A)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, B1.float(), xh.float())
    state = cache["state"]
    state.mul_(dA[:, :, None, None]).add_(dBx)
    y = torch.einsum("bhpn,bn->bhp", state, C1.float())[:, None]  # (B,1,H,P)
    out = _mamba_out(params, y, xh[:, None], z, cfg, (x.shape[0], 1),
                     split_)
    for name, tail in (("conv_x", conv_x), ("conv_B", conv_B),
                       ("conv_C", conv_C)):
        cache[name].copy_(tail)
    return out, cache
