"""Language model for the dense and VLM (text-only) families.

``LanguageModel(cfg, device)`` exposes:
  init(generator)                              -> params
  train_loss(params, batch)                    -> (loss, metrics)
  prefill(params, batch)                       -> (last_logits, cache)
  decode_step(params, cache, token, cur_len)   -> (logits, cache)
  alloc_cache(batch, seq, init=None)           -> zeroed decode cache

Parameters keep the reference's tree names and stacked shapes
(``layers.attn.w_q`` is (L, D, H, hd)), so one weight set feeds both
packages; layers run as a Python loop over the stack.  Caches are
head-major, (L, B, KH, S, hd).  Training follows the reference's
``cfg.remat`` with ``torch.utils.checkpoint`` and its sequence-chunked
cross entropy, which never materializes the full (B, S, V) logits.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import blocks
from .layers import Params, _dtype, embed_init, resolve_device, rmsnorm, rmsnorm_init


def layer_params(stacked: Params, i: int) -> Params:
    """Layer ``i``'s slice of a stacked (L, ...) parameter tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def unstack_layers(stacked: Params, n: int) -> List[Params]:
    """The ``n`` layers' slices of a stacked (L, ...) tree, as views made
    by one ``unbind`` per leaf: autograd then stacks the layer gradients
    once per leaf instead of adding an (L, ...) zero-padded gradient per
    layer."""
    def split(node):
        return ({k: split(v) for k, v in node.items()}
                if isinstance(node, dict) else node.unbind(0))

    parts = split(stacked)
    return [layer_params(parts, i) for i in range(n)]


# matmul outputs kept by remat="dots" (the reference's
# dots_with_no_batch_dims_saveable); everything else is recomputed
_DOT_OPS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(body: Callable, cfg) -> Callable:
    """``cfg.remat`` as ``torch.utils.checkpoint``: "none" saves every
    activation, "layer" recomputes the whole body in the backward, "dots"
    recomputes all but the matmul outputs."""
    if cfg.remat == "none":
        return body
    kw: Dict[str, Any] = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        # the bodies draw no random numbers: no RNG state to replay
        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return run


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
        return params["embedding"][tokens.long()].to(_dtype(self.cfg.dtype))

    def _unembed_weight(self, params: Params) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embedding"].T
        return params["lm_head"]

    def _logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        """(…, D) final hidden → (…, V) fp32 logits."""
        return (h @ self._unembed_weight(params).to(h.dtype)).float()

    # ------------------------------------------------------------ training

    def _backbone_train(self, params: Params, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (final-normed hidden, aux dict summed over layers —
        ``blocks.zero_aux`` schema)."""
        cfg = self.cfg
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        aux = blocks.zero_aux(x.device)

        def body(xx, p_l):
            return blocks.decoder_layer_train(p_l, xx, cfg, positions)

        step = _remat(body, cfg)
        for p_l in unstack_layers(params["layers"], cfg.num_layers):
            x, a = step(x, p_l)
            aux = {k: aux[k] + a[k] for k in aux}
        return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux

    def lm_loss(self, params: Params, h: torch.Tensor, targets: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Sequence-chunked cross entropy: fp32 logits one ``loss_chunk``
        of positions at a time (each chunk under ``_remat``), targets < 0
        masked."""
        cfg = self.cfg
        b, s, d = h.shape
        w = self._unembed_weight(params).to(h.dtype)
        chunk = min(cfg.loss_chunk, s)
        while s % chunk:
            chunk //= 2

        def chunk_fn(h_i, t_i):
            logits = (h_i @ w).float()
            lse = torch.logsumexp(logits, dim=-1)
            safe_t = torch.clamp(t_i, min=0)
            ll = torch.gather(logits, -1, safe_t[..., None])[..., 0]
            mask = (t_i >= 0).float()
            # argmax takes the first maximum, as jnp.argmax does
            pred = torch.argmax(logits, dim=-1)
            return (((lse - ll) * mask).sum(), (lse.square() * mask).sum(),
                    ((pred == safe_t).float() * mask).sum(), mask.sum())

        step = _remat(chunk_fn, cfg)
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        loss_sum = z_sum = correct = count = zero
        targets = targets.long()
        for c0 in range(0, s, chunk):
            l_, z_, c_, n_ = step(h[:, c0:c0 + chunk],
                                  targets[:, c0:c0 + chunk])
            loss_sum, z_sum = loss_sum + l_, z_sum + z_
            correct, count = correct + c_, count + n_
        count = torch.clamp(count, min=1.0)
        loss = loss_sum / count
        metrics = {"ce_loss": loss, "z_loss": z_sum / count,
                   "accuracy": correct / count, "tokens": count}
        return loss, metrics

    def train_loss(self, params: Params, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch["tokens"], batch["targets"]: (B, S) int → (total loss,
        metrics): loss + 0.01·aux + 1e-4·z_loss, with the MoE dispatch
        metrics (zeros for a dense model) as the reference reports them."""
        if "patches" in batch:
            raise NotImplementedError("VLM patch prefixes are not ported yet")
        x = self._embed(params, batch["tokens"])
        h, aux = self._backbone_train(params, x)
        loss, metrics = self.lm_loss(params, h, batch["targets"])
        total = loss + 0.01 * aux["loss"] + 1e-4 * metrics["z_loss"]
        metrics["aux_loss"] = aux["loss"]
        metrics["moe_dropped_tokens"] = aux["dropped"]
        metrics["moe_overflow_rate"] = aux["dropped"] / torch.clamp(
            aux["routed"], min=1.0)
        metrics["moe_a2a_bytes"] = aux["a2a_bytes"]
        metrics["loss"] = total
        return total, metrics

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
