"""Language model for the dense and VLM (text-only) families.

``LanguageModel(cfg, device)`` exposes:
  init(generator)                              -> params
  prefill(params, batch)                       -> (last_logits, cache)
  decode_step(params, cache, token, cur_len)   -> (logits, cache)
  alloc_cache(batch, seq, init=None)           -> zeroed decode cache

Parameters keep the reference's tree names and stacked shapes
(``layers.attn.w_q`` is (L, D, H, hd)), so one weight set feeds both
packages; layers run as a Python loop over the stack.  Caches are
head-major, (L, B, KH, S, hd).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from . import blocks
from .layers import Params, _dtype, embed_init, resolve_device, rmsnorm, rmsnorm_init


def layer_params(stacked: Params, i: int) -> Params:
    """Layer ``i``'s slice of a stacked (L, ...) parameter tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _stack(trees):
    first = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(first[k], dict)
            else torch.stack([t[k] for t in trees]) for k in first}


class LanguageModel:
    def __init__(self, cfg, device="cuda"):
        if cfg.family not in ("dense", "vlm") or cfg.use_mla:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (dense, vlm only)")
        self.cfg = cfg
        self.device = resolve_device(device)

    # ----------------------------------------------------------------- init

    def init(self, generator: torch.Generator) -> Params:
        """Random weights from ``generator`` (drawn on its device), placed
        on the model's device."""
        cfg = self.cfg
        dt = _dtype(cfg.param_dtype)
        p: Params = {
            "embedding": embed_init(generator, cfg.vocab_size, cfg.d_model, dt),
            "final_norm": rmsnorm_init(cfg.d_model, dt, generator.device),
        }
        if not cfg.tie_embeddings:
            w = torch.randn((cfg.d_model, cfg.vocab_size), generator=generator,
                            device=generator.device)
            p["lm_head"] = (w / np.sqrt(cfg.d_model)).to(dt)
        p["layers"] = _stack([blocks.decoder_layer_init(generator, cfg)
                              for _ in range(cfg.num_layers)])
        return _to(p, self.device)

    # ------------------------------------------------------------ embedding

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embedding"][tokens].to(_dtype(self.cfg.dtype))

    def _unembed_weight(self, params: Params) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embedding"].T
        return params["lm_head"]

    def _logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        """(…, D) final hidden → (…, V) fp32 logits."""
        return (h @ self._unembed_weight(params).to(h.dtype)).float()

    # --------------------------------------------------------------- prefill

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor]):
        """batch["tokens"]: (B, S) int → (last logits (B, V) fp32,
        {"layers": {"k", "v"}} caches (L, B, KH, S, hd))."""
        cfg = self.cfg
        if "patches" in batch:
            raise NotImplementedError("VLM patch prefixes are not ported yet")
        x = self._embed(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        ks, vs = [], []
        for i in range(cfg.num_layers):
            x, c = blocks.decoder_layer_prefill(
                layer_params(params["layers"], i), x, cfg, positions)
            ks.append(c["k"])
            vs.append(c["v"])
        h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        cache = {"layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}
        return self._logits(params, h[:, -1]), cache

    # ---------------------------------------------------------------- decode

    def decode_step(self, params: Params, cache: Any, token: torch.Tensor,
                    cur_len):
        """token: (B, 1) int; cur_len: int (or one-element tensor), tokens
        already cached.  The cache is updated in place and returned."""
        cfg = self.cfg
        cur = int(cur_len)
        x = self._embed(params, token)
        kc, vc = cache["layers"]["k"], cache["layers"]["v"]
        for i in range(cfg.num_layers):
            x, _ = blocks.decoder_layer_decode(
                layer_params(params["layers"], i), x, cfg,
                {"k": kc[i], "v": vc[i]}, cur)
        h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return self._logits(params, h[:, -1]), cache

    # ----------------------------------------------------------------- cache

    def alloc_cache(self, batch: int, seq: int,
                    init: Optional[Any] = None) -> Any:
        """Zeroed head-major decode cache {"layers": {"k", "v"}} of shape
        (L, batch, KH, seq, hd) in the compute dtype; ``init`` (a prefill
        cache of S ≤ seq positions) is copied into the first S."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, seq, cfg.head_dim)
        out = {}
        for name in ("k", "v"):
            buf = torch.zeros(shape, dtype=_dtype(cfg.dtype), device=self.device)
            if init is not None:
                src = init["layers"][name]
                buf[..., : src.shape[-2], :] = src
            out[name] = buf
        return {"layers": out}


def _to(tree: Params, device: torch.device) -> Params:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
