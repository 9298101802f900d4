"""Serving steps: prefill and single-token decode, plus the paged variants
the continuous-batching engine runs.

The paged steps keep the whole KV cache in per-layer page pools
(L, P, KH, page, hd) indexed through a (B, max_pages) page table — §6's
disjoint-partition decomposition applied to serving.  The steps are
eager functions; pools update in place and are returned as well.
"""
from __future__ import annotations

import torch

from repro_torch.dist.flash import paged_update_and_attend
from repro_torch.models import blocks
from repro_torch.models.attention import gqa_qkv
from repro_torch.models.layers import apply_rope, cast_params, mlp, rmsnorm
from repro_torch.models.model import LanguageModel, layer_params


def make_prefill_step(model: LanguageModel):
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model: LanguageModel):
    def decode_step(params, cache, token, cur_len):
        return model.decode_step(params, cache, token, cur_len)
    return decode_step


# -------------------------------------------------------------- paged steps

def _check_paged(cfg) -> None:
    if cfg.family not in ("dense", "vlm") or getattr(cfg, "use_mla", False):
        raise ValueError(f"paged serving supports dense GQA, not {cfg.family}")


def make_paged_prefill_step(model: LanguageModel, page_size: int):
    """Prefill one request straight into its pages.

    Returned step signature:
      step(params, k_pools, v_pools, tokens, plen, pages)
        tokens: (1, Spad) int, right-padded — Spad a multiple of
          ``page_size``;
        plen: int true prompt length (logits read position plen-1; pad
          positions write KV that stays masked behind ``cur_lens``);
        pages: (Spad//page_size,) int physical page ids for this request
          (unused tail entries hold the pool size and write nothing).
      -> (next_token () int32, logits (V,) f32, k_pools, v_pools)
    """
    cfg = model.cfg
    _check_paged(cfg)

    def step(params, k_pools, v_pools, tokens, plen, pages):
        x = model._embed(params, tokens)
        spad = tokens.shape[1]
        positions = torch.arange(spad, device=x.device)[None, :]
        npool = k_pools.shape[1]
        # logical pages that map into the pool (the rest are sentinels)
        keep = torch.nonzero(pages < npool).squeeze(1)
        phys = pages[keep].long()
        for i in range(cfg.num_layers):
            x, c = blocks.decoder_layer_prefill(
                layer_params(params["layers"], i), x, cfg, positions)
            for pool, kv in ((k_pools, c["k"]), (v_pools, c["v"])):
                # (1, KH, Spad, hd) head-major -> (npg, KH, page, hd)
                kh, hd = kv.shape[1], kv.shape[3]
                paged = kv[0].reshape(kh, spad // page_size, page_size, hd)
                pool[i, phys] = paged.transpose(0, 1)[keep].to(pool.dtype)
        h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = model._logits(params, h[0, int(plen) - 1])
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, k_pools, v_pools

    return step


def make_paged_decode_step(model: LanguageModel):
    """One continuous-batching decode step over the paged pools.

    Returned step signature:
      step(params, k_pools, v_pools, page_table, cur_lens, active, tokens)
        page_table: (B, max_pages) int32; cur_lens: (B,) int32 tokens
        already cached per row; active: (B,) bool; tokens: (B,) int last
        sampled token per row — all tensors on the model's device.
      -> (next_tokens (B,) int32, logits (B, V) f32, k_pools, v_pools,
          cur_lens')
    """
    cfg = model.cfg
    _check_paged(cfg)

    def step(params, k_pools, v_pools, page_table, cur_lens, active, tokens):
        x = model._embed(params, tokens[:, None])           # (B, 1, D)
        pos = cur_lens[:, None]                             # (B, 1) per row
        for i in range(cfg.num_layers):
            p_l = cast_params(layer_params(params["layers"], i), cfg.dtype)
            h = rmsnorm(p_l["ln1"], x, cfg.norm_eps)
            q, k, v = gqa_qkv(p_l["attn"], h, cfg)
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
            out, _, _ = paged_update_and_attend(
                q, k, v, k_pools[i], v_pools[i], page_table, cur_lens,
                active, window=cfg.sliding_window)
            x = x + torch.einsum("bshk,hkd->bsd", out, p_l["attn"]["w_o"])
            h = rmsnorm(p_l["ln2"], x, cfg.norm_eps)
            x = x + mlp(p_l["mlp"], h)
        h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = model._logits(params, h[:, 0])
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        cur_new = cur_lens + active.to(torch.int32)
        return next_tok, logits, k_pools, v_pools, cur_new

    return step
