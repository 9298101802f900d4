"""The decoder layer (``kind`` "dense", "moe", "mla_dense" or "mla_moe"
of ``repro.models.blocks``), the Mamba2 layer, and whisper's encoder and
decoder layers: init plus train, prefill and decode application.

Pre-norm residual, as ``repro.models.blocks``.  Attention compute routes
through ``repro_torch.dist.flash``, which picks the kernel.  The MLA
kinds attend with DeepSeek-V2's multi-head latent attention: per-head q
and k of width ``qk_nope_head_dim + qk_rope_head_dim`` and v of width
``v_head_dim`` through the flash kernels in train and prefill, whose
cache is the latents {"c_kv", "k_rope"}, and the absorbed latent-space
decode.  Whisper's layers use LayerNorm and the GELU MLP; its encoder
self-attention and the decoder's cross attention are the unmasked
dense ``cross_attention`` (no kernel), the decoder's self-attention the
same RoPE'd causal GQA path as the decoder layer.

Under tensor parallelism (``models.tp``) each sublayer reads from its
own leaves whether they came as the rank's share: attention on the
rank's heads (with k / v at the kv heads those read when only q split),
the MLPs on its hidden units, the Mamba mixer on its channels, each a
region between ``tp.enter`` and ``tp.leave``; whole leaves compute on
the stream's rows (GQA context-parallel) or on every row (cross
attention, MLA); the norms run on the rows the rank holds.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.dist.flash import (causal_attention, decode_update_and_attend,
                                    stripe_update_and_attend)
from . import tp
from .attention import (_mla_qkv_full, cross_attention, cross_attn_init,
                        full_attention, gqa_init, gqa_qkv, mla_decode,
                        mla_init)
from .layers import (Params, _dtype, apply_rope, cast_params, gelu_mlp_init,
                     layernorm, layernorm_init, mlp_init, rmsnorm,
                     rmsnorm_init, stack_trees)
from .mamba import mamba_decode, mamba_init, mamba_prefill, mamba_train
from .moe import moe_ffn, moe_init, zero_aux


def _heads_split(p: Params, cfg) -> bool:
    """The layer's q heads came as this rank's "model" share."""
    return tp.split_dim(p["w_q"].shape[-2], cfg.num_heads)


def _kv_local(p: Params, cfg) -> Params:
    """Attention leaves whose q heads came split, with k / v at the kv
    heads those q heads read: as they came when the kv heads split too,
    else cut from the whole leaves (each rank's use is part of their
    gradient: ``tp.shared``)."""
    if tp.split_dim(p["w_k"].shape[-2], cfg.num_kv_heads):
        return p
    heads = tp.kv_heads_read(p["w_q"].shape[-2], cfg.num_heads,
                             cfg.num_kv_heads)
    out = dict(p)
    for name in ("w_k", "w_v", "b_k", "b_v"):
        if name in p:
            w = tp.shared(p[name])
            out[name] = tp.kv_select(w, heads, w.ndim - 2)
    return out


def _qkv_roped(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor):
    q, k, v = gqa_qkv(p, x, cfg)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _head_major(k: torch.Tensor, v: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"k": k.transpose(1, 2).contiguous(),
            "v": v.transpose(1, 2).contiguous()}


def _attn_apply(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
                want_cache: bool = False):
    """Train / prefill attention on the stream's rows; ``positions`` are
    the global (1, S).  With ``want_cache`` returns (out, head-major cache
    (B, KH, S, hd)) in the decode layout at rest: under tensor
    parallelism the rank's kv heads, or, for whole heads, its stripe of
    the sequence (``tp.seq_stripe``).

    Heads split: every row enters (``tp.enter``), q / k / v of the rank's
    heads, attention on them, the rank's rows of ``w_o``, the partial
    outputs summed back (``tp.leave``).  Heads whole on a stripe of rows:
    context-parallel, q of the stripe against k / v gathered over the
    sequence."""
    if _heads_split(p, cfg):
        p = _kv_local(p, cfg)
        q, k, v = _qkv_roped(p, tp.enter(x), cfg, positions)
        out = causal_attention(q, k, v, cfg=cfg, window=cfg.sliding_window)
        o = tp.leave(torch.einsum("bshk,hkd->bsd", out, p["w_o"]))
        return (o, _head_major(k, v)) if want_cache else o
    if tp.rows_split():
        p = tp.shared(p)
        q, k_rows, v_rows = _qkv_roped(p, x, cfg,
                                       tp.local_positions(positions))
        out = causal_attention(q, tp.full_rows(k_rows), tp.full_rows(v_rows),
                               cfg=cfg, window=cfg.sliding_window,
                               q_offset=tp.row_offset(x.shape[1]))
        o = torch.einsum("bshk,hkd->bsd", out, p["w_o"])
        return (o, _head_major(k_rows, v_rows)) if want_cache else o
    q, k, v = _qkv_roped(p, x, cfg, positions)
    out = causal_attention(q, k, v, cfg=cfg, window=cfg.sliding_window)
    o = torch.einsum("bshk,hkd->bsd", out, p["w_o"])
    if not want_cache:
        return o
    cache = _head_major(k, v)
    if tp.active():
        cache = {n: tp.seq_stripe(c, 2) for n, c in cache.items()}
    return o, cache


def _attn_decode(p: Params, x: torch.Tensor, cfg,
                 cache: Dict[str, torch.Tensor], cur_len: int):
    """One token against the decode caches at rest (``_attn_apply``'s
    layout): the rank's heads, or whole heads over its sequence stripe
    (the lse-combine) under tensor parallelism."""
    heads = _heads_split(p, cfg)
    if heads:
        p = _kv_local(p, cfg)
        x = tp.enter(x)
    pos = torch.full((1, 1), cur_len, dtype=torch.int32, device=x.device)
    q, k, v = _qkv_roped(p, x, cfg, pos)
    attend = (stripe_update_and_attend if tp.active() and not heads
              else decode_update_and_attend)
    out, kc, vc = attend(q, k, v, cache["k"], cache["v"], cur_len,
                         window=cfg.sliding_window)
    o = torch.einsum("bshk,hkd->bsd", out, p["w_o"])
    return (tp.leave(o) if heads else o), {"k": kc, "v": vc}


# -------------------------------------------------------------- MLA attention

def _mla_heads_split(p: Params, cfg) -> bool:
    return tp.split_dim(p["w_uq"].shape[-2], cfg.num_heads)


def _mla_region(p: Params) -> Params:
    """MLA leaves for a region on the rank's heads: the low-rank
    projections and their norms stay whole (each rank's heads read the
    same latents, so each use is part of their gradient)."""
    out = dict(p)
    for name in ("w_dq", "q_norm", "w_dkv", "kv_norm"):
        out[name] = tp.shared(p[name])
    return out


def _mla_apply(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
               want_cache: bool = False):
    """Train / prefill MLA on the full heads (q/k width dn + dr, v width
    dv), as the reference's decoder layer runs it; with ``want_cache``
    returns (out, latent cache {"c_kv" (B, S, rkv), "k_rope" (B, S,
    dr)}), whole on every rank.  Heads split: a region on the rank's
    heads of ``w_uq`` / ``w_uk`` / ``w_uv`` / ``w_o``; heads whole: every
    row on every rank."""
    def attend(pp, xx):
        q, k, v, c_kv, k_rope = _mla_qkv_full(pp, xx, cfg, positions)
        out = causal_attention(q, k, v, cfg=cfg)
        o = torch.einsum("bshk,hkd->bsd", out, pp["w_o"])
        return o, {"c_kv": c_kv, "k_rope": k_rope[:, :, 0, :]}

    if _mla_heads_split(p, cfg):
        o, cache = attend(_mla_region(p), tp.enter(x))
        o = tp.leave(o)
    elif tp.rows_split():
        box = {}

        def rows(xx):
            out, box["cache"] = attend(p, xx)
            return out
        o, cache = tp.replicated(rows, x), box["cache"]
    else:
        o, cache = attend(p, x)
    return (o, cache) if want_cache else o


def _mla_decode(p: Params, x: torch.Tensor, cfg,
                cache: Dict[str, torch.Tensor], cur_len: int):
    if _mla_heads_split(p, cfg):
        o, cache = mla_decode(_mla_region(p), tp.enter(x), cfg, cache,
                              cur_len)
        return tp.leave(o), cache
    return mla_decode(p, x, cfg, cache, cur_len)


# --------------------------------------------------------------- decoder layer

_KINDS = ("dense", "moe", "mla_dense", "mla_moe")


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(kind)


def _norms_attn_init(gen: torch.Generator, cfg, kind: str) -> Params:
    dt = _dtype(cfg.param_dtype)
    return {"ln1": rmsnorm_init(cfg.d_model, dt, gen.device),
            "ln2": rmsnorm_init(cfg.d_model, dt, gen.device),
            "attn": (mla_init(gen, cfg) if kind.startswith("mla")
                     else gqa_init(gen, cfg))}


def decoder_layer_init(gen: torch.Generator, cfg, kind: str = "dense"
                       ) -> Params:
    """kind ∈ {dense, moe, mla_dense, mla_moe}: the norms and attention
    (GQA, or MLA for the ``mla_`` kinds), then the SwiGLU ``mlp`` or the
    ``moe`` layer."""
    _check_kind(kind)
    p = _norms_attn_init(gen, cfg, kind)
    if kind.endswith("moe"):
        p["moe"] = moe_init(gen, cfg)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff,
                            _dtype(cfg.param_dtype))
    return p


def decoder_stack_init(gen: torch.Generator, cfg, kind: str, n: int
                       ) -> Params:
    """``n`` decoder layers, stacked (n, …).  Dense layers are drawn one
    at a time and stacked; a MoE stack draws its norms and attention
    layer by layer and its MoE leaves through ``moe_init(layers=n)``,
    which fills each expert bank in place, so no bank is held twice."""
    if not kind.endswith("moe"):
        return stack_trees([decoder_layer_init(gen, cfg, kind)
                            for _ in range(n)])
    p = stack_trees([_norms_attn_init(gen, cfg, kind) for _ in range(n)])
    p["moe"] = moe_init(gen, cfg, layers=n)
    return p


def _ffn(p: Params, h: torch.Tensor, cfg, kind: str
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(output, aux) of the layer's feed-forward: the MoE layer, or the
    dense MLP with zero aux."""
    _check_kind(kind)
    if kind.endswith("moe"):
        return moe_ffn(p["moe"], h, cfg)
    return tp.mlp(p["mlp"], h, cfg.d_ff), zero_aux(h.device)


def _attn(p: Params, h: torch.Tensor, cfg, positions: torch.Tensor,
          kind: str, want_cache: bool = False):
    """The layer's train / prefill attention: MLA for the ``mla_`` kinds,
    else GQA."""
    apply = _mla_apply if kind.startswith("mla") else _attn_apply
    return apply(p["attn"], h, cfg, positions, want_cache)


def decoder_layer_train(p: Params, x: torch.Tensor, cfg,
                        positions: torch.Tensor, kind: str = "dense"
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (x, aux) in ``moe.zero_aux``'s schema.  The fp32 master
    weights are cast to the compute dtype here, inside the layer (and so
    inside its checkpointed region), and gradients flow back through the
    cast to fp32."""
    p = cast_params(p, cfg.dtype)
    h = rmsnorm(tp.on_rows(p["ln1"]), x, cfg.norm_eps)
    x = x + _attn(p, h, cfg, positions, kind)
    h = rmsnorm(tp.on_rows(p["ln2"]), x, cfg.norm_eps)
    f, aux = _ffn(p, h, cfg, kind)
    return x + f, aux


def decoder_layer_prefill(p: Params, x: torch.Tensor, cfg,
                          positions: torch.Tensor, kind: str = "dense"
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    p = cast_params(p, cfg.dtype)
    h = rmsnorm(tp.on_rows(p["ln1"]), x, cfg.norm_eps)
    attn, cache = _attn(p, h, cfg, positions, kind, want_cache=True)
    x = x + attn
    h = rmsnorm(tp.on_rows(p["ln2"]), x, cfg.norm_eps)
    return x + _ffn(p, h, cfg, kind)[0], cache


def decoder_layer_decode(p: Params, x: torch.Tensor, cfg,
                         cache: Dict[str, torch.Tensor], cur_len: int,
                         kind: str = "dense"
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    p = cast_params(p, cfg.dtype)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    decode = _mla_decode if kind.startswith("mla") else _attn_decode
    attn, cache = decode(p["attn"], h, cfg, cache, cur_len)
    x = x + attn
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + _ffn(p, h, cfg, kind)[0], cache


# ----------------------------------------------------------------- mamba layer

def mamba_layer_init(gen: torch.Generator, cfg) -> Params:
    dt = _dtype(cfg.param_dtype)
    return {"ln": rmsnorm_init(cfg.d_model, dt, gen.device),
            "mixer": mamba_init(gen, cfg)}


def mamba_layer_train(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    p = cast_params(p, cfg.dtype)
    h = rmsnorm(tp.on_rows(p["ln"]), x, cfg.norm_eps)
    return x + mamba_train(p["mixer"], h, cfg)


def mamba_layer_prefill(p: Params, x: torch.Tensor, cfg
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    p = cast_params(p, cfg.dtype)
    h = rmsnorm(tp.on_rows(p["ln"]), x, cfg.norm_eps)
    y, cache = mamba_prefill(p["mixer"], h, cfg)
    return x + y, cache


def mamba_layer_decode(p: Params, x: torch.Tensor, cfg,
                       cache: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    p = cast_params(p, cfg.dtype)
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    y, cache = mamba_decode(p["mixer"], h, cfg, cache)
    return x + y, cache


# ------------------------------------------------------------- whisper blocks

def enc_layer_init(gen: torch.Generator, cfg) -> Params:
    dt = _dtype(cfg.param_dtype)
    return {"ln1": layernorm_init(cfg.d_model, dt, gen.device),
            "attn": cross_attn_init(gen, cfg),      # MHA weights (q,k,v,o)
            "ln2": layernorm_init(cfg.d_model, dt, gen.device),
            "mlp": gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dt)}


def _self_attn_bidir(p: Params, h: torch.Tensor, cfg) -> torch.Tensor:
    """The encoder's unmasked self-attention: a region on the rank's heads
    when they came split, else every row on every rank."""
    if _heads_split(p, cfg):
        hf = tp.enter(h)
        return tp.leave(cross_attention(p, hf, hf))
    return tp.replicated(lambda hh: cross_attention(p, hh, hh), h)


def _cross_attn(p: Params, h: torch.Tensor, enc: torch.Tensor, cfg
                ) -> torch.Tensor:
    """The decoder's cross attention over ``enc``, every encoder row
    (``model._encode`` hands it in the form its heads' split needs)."""
    if _heads_split(p, cfg):
        return tp.leave(cross_attention(p, tp.enter(h), enc))
    return tp.replicated(lambda hh: cross_attention(p, hh, enc), h)


def enc_layer_apply(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Bidirectional self-attention (``cross_attention`` with enc = h),
    then the GELU MLP."""
    p = cast_params(p, cfg.dtype)
    h = layernorm(tp.on_rows(p["ln1"]), x, cfg.norm_eps)
    x = x + _self_attn_bidir(p["attn"], h, cfg)
    h = layernorm(tp.on_rows(p["ln2"]), x, cfg.norm_eps)
    return x + tp.gelu_mlp(p["mlp"], h, cfg.d_ff)


def dec_layer_init(gen: torch.Generator, cfg) -> Params:
    dt = _dtype(cfg.param_dtype)
    return {"ln1": layernorm_init(cfg.d_model, dt, gen.device),
            "attn": gqa_init(gen, cfg),
            "ln_x": layernorm_init(cfg.d_model, dt, gen.device),
            "cross": cross_attn_init(gen, cfg),
            "ln2": layernorm_init(cfg.d_model, dt, gen.device),
            "mlp": gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dt)}


def dec_layer_train(p: Params, x: torch.Tensor, enc: torch.Tensor, cfg,
                    positions: torch.Tensor) -> torch.Tensor:
    p = cast_params(p, cfg.dtype)
    h = layernorm(tp.on_rows(p["ln1"]), x, cfg.norm_eps)
    x = x + _attn_apply(p["attn"], h, cfg, positions)
    h = layernorm(tp.on_rows(p["ln_x"]), x, cfg.norm_eps)
    x = x + _cross_attn(p["cross"], h, enc, cfg)
    h = layernorm(tp.on_rows(p["ln2"]), x, cfg.norm_eps)
    return x + tp.gelu_mlp(p["mlp"], h, cfg.d_ff)


def _cross_from_cache(p: Params, h: torch.Tensor, ck: torch.Tensor,
                      cv: torch.Tensor, cfg) -> torch.Tensor:
    """Cross attention against the cached K / V (the rank's heads when
    they came split)."""
    def attend(hh):
        q = torch.einsum("bsd,dhk->bshk", hh, p["w_q"])
        out = full_attention(q, ck, cv, causal=False)
        return torch.einsum("bshk,hkd->bsd", out, p["w_o"])

    if _heads_split(p, cfg):
        return tp.leave(attend(tp.enter(h)))
    return tp.replicated(attend, h)


def dec_layer_prefill(p: Params, x: torch.Tensor, enc: torch.Tensor, cfg,
                      positions: torch.Tensor
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (x, cache): the self-attention's head-major {"k", "v"}
    (B, KH, S, hd) and the cross K/V computed once from the encoder
    states, seq-major {"cross_k", "cross_v"} (B, Se, H, hd); under tensor
    parallelism each at rest in the decode layout (the rank's heads)."""
    p = cast_params(p, cfg.dtype)
    h = layernorm(tp.on_rows(p["ln1"]), x, cfg.norm_eps)
    attn, cache = _attn_apply(p["attn"], h, cfg, positions, want_cache=True)
    x = x + attn
    h = layernorm(tp.on_rows(p["ln_x"]), x, cfg.norm_eps)
    ck = torch.einsum("bsd,dhk->bshk", enc, p["cross"]["w_k"])
    cv = torch.einsum("bsd,dhk->bshk", enc, p["cross"]["w_v"])
    x = x + _cross_from_cache(p["cross"], h, ck, cv, cfg)
    h = layernorm(tp.on_rows(p["ln2"]), x, cfg.norm_eps)
    x = x + tp.gelu_mlp(p["mlp"], h, cfg.d_ff)
    return x, {**cache, "cross_k": ck, "cross_v": cv}


def dec_layer_decode(p: Params, x: torch.Tensor, cfg,
                     cache: Dict[str, torch.Tensor], cur_len: int
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token: the self-attention caches updated in place, the cross
    caches read as they are."""
    p = cast_params(p, cfg.dtype)
    h = layernorm(p["ln1"], x, cfg.norm_eps)
    attn, kv = _attn_decode(p["attn"], h, cfg,
                            {"k": cache["k"], "v": cache["v"]}, cur_len)
    x = x + attn
    h = layernorm(p["ln_x"], x, cfg.norm_eps)
    x = x + _cross_from_cache(p["cross"], h, cache["cross_k"],
                              cache["cross_v"], cfg)
    h = layernorm(p["ln2"], x, cfg.norm_eps)
    x = x + tp.gelu_mlp(p["mlp"], h, cfg.d_ff)
    return x, {**kv, "cross_k": cache["cross_k"],
               "cross_v": cache["cross_v"]}
