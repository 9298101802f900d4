"""Language model for the dense, VLM, MoE (with or without MLA), SSM,
hybrid and encoder-decoder families.

``LanguageModel(cfg, device)`` exposes:
  init(generator)                              -> params
  train_loss(params, batch)                    -> (loss, metrics)
  prefill(params, batch)                       -> (last_logits, cache)
  decode_step(params, cache, token, cur_len)   -> (logits, cache)
  alloc_cache(batch, seq, init=None)           -> zeroed decode cache

Parameters keep the reference's tree names and stacked shapes
(``layers.attn.w_q`` is (L, D, H, hd), ``layers.mixer.w_x`` (L, D,
d_inner), ``layers.moe.w_gate`` (L, E, D, F)), so one weight set feeds
both packages; layers run as a Python loop over the stack.  A MoE model
(arctic, deepseek-v2) runs its ``first_k_dense`` dense layers
(``dense_layers``, cache ``"dense"``) before its MoE layers
(``layers``), and sums the MoE aux over layers into the train
metrics.  A VLM (llava) batch may carry ``patches`` (B, P, D): their
embeddings go before the text's, so positions and ``cur_len`` count
them, and ``train_loss`` pads the targets with −1 over them.  The
encoder-decoder family (whisper) encodes ``batch["frames"]`` (B, Se, D)
plus sinusoidal positions through ``enc_layers`` and ``enc_norm`` (both
LayerNorm), then runs ``dec_layers``, each with a causal RoPE'd
self-attention and a cross attention over the encoder states, into a
LayerNorm ``final_norm``.  Under ``use_mla`` (deepseek-v2) every
decoder layer attends with multi-head latent attention
(``layers.attn.w_uq`` (L, q_lora_rank, H, dn + dr), …), and the dense
layers' MLP takes the full intermediate size
(:attr:`LanguageModel._dense_cfg`).  The hybrid family (zamba2)
applies one shared attention + MLP block (``params["shared_attn"]``, a
single copy) before each group of ``attn_every`` Mamba layers, then the
remainder layers.  Caches follow the reference's ``cache_spec``:
head-major attention caches (…, B, KH, S, hd) (whisper's cross caches
seq-major (L, B, Se, H, hd)), MLA's latent caches c_kv (…, B, S, rkv)
and k_rope (…, B, S, dr), Mamba conv tails (…, B, K-1, C) and fp32
states (…, B, H, P, N); decode updates them in place.  Training follows
the reference's ``cfg.remat`` with ``torch.utils.checkpoint`` and its
sequence-chunked cross entropy, which never materializes the full
(B, S, V) logits.

Under a mesh an entry point keeps each leaf at its "model" share
(:func:`gather_params`) and splits the residual stream's rows over
"model" where S divides (``dist.sharding.seq_sharded``): the layers
compute the rank's share (``models.tp``), the embedding looks up the
rank's vocab rows and sums them over "model", and the loss combines its
vocab shard's statistics (:func:`vocab_parallel_stats`), as the
reference's GSPMD layout does on each device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.dist.sharding import (_entry_axes, all_gather, all_reduce,
                                      batch_split, chunk_of, current_ctx,
                                      gather_param, installed,
                                      param_shardings, psum, seq_sharded,
                                      split)
from . import blocks, tp
from .layers import (_FP32_LEAVES, Params, _dtype, embed_init, layernorm,
                     layernorm_init, resolve_device, rmsnorm, rmsnorm_init,
                     stack_trees)


def _sinusoid(seq: int, dim: int) -> np.ndarray:
    """Whisper's encoder positions: (seq, dim) fp32, the sin half then the
    cos half."""
    pos = np.arange(seq)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return out.astype(np.float32)


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
    recomputes all but the matmul outputs.  The recomputation runs under
    the sharding context the forward saw, whenever the backward runs."""
    if cfg.remat == "none":
        return body

    def run(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        seen = current_ctx()

        def contexts():
            if cfg.remat == "dots":
                fwd, rec = create_selective_checkpoint_contexts(_dots_policy)
            else:
                fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
            return fwd, _both(rec, installed(seen))

        # the bodies draw no random numbers: no RNG state to replay
        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=contexts)
    return run


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads "meta": ``init`` then
    allocates every leaf on the meta device and draws nothing."""

    @property
    def device(self):
        return torch.device("meta")


@functools.lru_cache(maxsize=None)
def param_shapes(cfg) -> Params:
    """The parameter tree of ``cfg`` on the meta device (shapes and
    dtypes, no storage), as ``jax.eval_shape`` gives the reference's."""
    return LanguageModel(cfg, device="meta").init(_MetaGenerator())


# stacks whose leaves the layers cast to the compute dtype (cast_params)
_CAST_STACKS = ("layers", "dense_layers", "enc_layers", "dec_layers",
                "shared_attn")
_BANKS = ("w_gate", "w_up", "w_down")


def _is_model(entry) -> bool:
    return "model" in _entry_axes(entry)


def gather_params(params: Params, cfg, ctx) -> Params:
    """A mesh entry point's parameters: each leaf that ``param_shardings``
    cuts, given as this rank's shard, gathered over its FSDP entries —
    in the compute dtype where ``cast_params`` would cast it, so the
    gather moves the compute dtype — and kept at its "model" share
    (a whole leaf is cut to it), so the layers compute the rank's heads,
    hidden units, Mamba channels and vocab rows (``models.tp``);
    ``pure_dp`` takes every leaf whole.  The MoE
    expert banks go to the MoE region as they come.  While a training
    step splits its batch, every leaf passes through one gather node,
    whose backward sums the gradient over "dp" (never over "model": a
    local column's gradient is already whole)."""
    shardings = param_shardings(param_shapes(cfg), ctx)
    shapes = param_shapes(cfg)
    dt = _dtype(cfg.dtype)
    keep_model = tp.active(ctx)

    def walk(node, sh, shp, path, cast):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, sh[k], shp[k], path + (k,),
                              cast or k in _CAST_STACKS)
                continue
            if cast and k not in _FP32_LEAVES and v.dtype == torch.float32:
                v = v.to(dt)
            if path and path[-1] == "moe" and k in _BANKS:
                out[k] = v
                continue
            spec = sh[k].spec
            whole = tuple(v.shape) == tuple(shp[k].shape)
            gather = tuple(None if whole or (keep_model and _is_model(e))
                           else e for e in spec)
            if ctx.split_batch or any(e is not None for e in gather):
                v = gather_param(v, gather, ctx)
            if whole and keep_model:
                for d, e in enumerate(spec):
                    if _is_model(e):
                        v = split(v, d, "model", ctx)
            out[k] = v
        return out

    return walk(params, shardings, shapes, (), False)


def vocab_parallel_stats(logits: torch.Tensor, targets: torch.Tensor,
                         lo, reduce: Callable):
    """The cross entropy's per-row statistics from one vocab shard of the
    fp32 logits (…, V_local), whose first column is global vocab index
    ``lo``: (lse, the target's logit, the argmax).  ``reduce(x, op)``
    combines a per-row tensor over the shards ("max", "sum", "min"); the
    "sum" carries the gradient.  lse is the global max (no gradient) plus
    the log of the summed exp; the target's logit is summed from the shard
    that holds it; the argmax is ``jnp.argmax``'s over the whole vocab:
    the largest value and, among equal ones, the smallest global index."""
    nv = logits.shape[-1]
    top = reduce(logits.detach().amax(dim=-1), "max")
    lse = top + torch.log(reduce(torch.exp(logits - top[..., None]).sum(-1),
                                 "sum"))
    t = targets - lo
    inside = (t >= 0) & (t < nv)
    ll = torch.gather(logits, -1, torch.where(inside, t, 0)[..., None])[..., 0]
    ll = reduce(torch.where(inside, ll, 0.0), "sum")
    arg = torch.argmax(logits, dim=-1)
    best = torch.gather(logits, -1, arg[..., None])[..., 0].detach()
    cand = torch.where(best == top, arg + lo,
                       torch.iinfo(torch.int64).max)
    return lse, ll, reduce(cand, "min")


def _model_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """:func:`vocab_parallel_stats`' combine over "model" on a live mesh."""
    if op == "sum":
        return psum(x, "model")
    return all_reduce(x.clone(), "model", current_ctx(), op=op)


class LanguageModel:
    def __init__(self, cfg, device="cuda"):
        if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid",
                              "encdec"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported (dense, vlm, moe, "
                f"ssm, hybrid, encdec only)")
        self.cfg = cfg
        self.device = resolve_device(device)

    @property
    def _kind(self) -> str:
        if self.cfg.family != "moe":
            return "dense"
        return "mla_moe" if self.cfg.use_mla else "moe"

    @property
    def _dense_kind(self) -> str:
        return "mla_dense" if self.cfg.use_mla else "dense"

    @property
    def _dense_cfg(self):
        """The config of a MoE model's leading dense layers: under MLA
        (deepseek-v2) their MLP takes the full intermediate size, 12288 at
        d_model 5120 and otherwise 8 × ``d_ff`` (2048 for the reduced
        config), as the reference's ``_dense_cfg``."""
        cfg = self.cfg
        if cfg.use_mla and cfg.first_k_dense:
            return dataclasses.replace(
                cfg, d_ff=12288 if cfg.d_model == 5120 else cfg.d_ff * 8)
        return cfg

    def _stacked_layers(self) -> int:
        """Layers in ``params["layers"]`` (a MoE model's dense ones sit in
        ``params["dense_layers"]``)."""
        return self.cfg.num_layers - self.cfg.first_k_dense

    def _decoder_segments(self, params: Params):
        """The decoder stacks in the order they run, as (params key, cache
        key, layers, kind, config): a MoE model's ``first_k_dense`` dense
        layers (with :attr:`_dense_cfg`), then the main stack."""
        if "dense_layers" in params:
            yield ("dense_layers", "dense", self.cfg.first_k_dense,
                   self._dense_kind, self._dense_cfg)
        yield "layers", "layers", self._stacked_layers(), self._kind, self.cfg

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
        if cfg.family in ("ssm", "hybrid"):
            p["layers"] = stack_trees([blocks.mamba_layer_init(generator, cfg)
                                       for _ in range(cfg.num_layers)])
        elif cfg.family == "encdec":
            p["enc_layers"] = stack_trees(
                [blocks.enc_layer_init(generator, cfg)
                 for _ in range(cfg.num_encoder_layers)])
            p["dec_layers"] = stack_trees(
                [blocks.dec_layer_init(generator, cfg)
                 for _ in range(cfg.num_layers)])
            p["final_norm"] = layernorm_init(cfg.d_model, dt,
                                             generator.device)
            p["enc_norm"] = layernorm_init(cfg.d_model, dt, generator.device)
        else:
            if cfg.first_k_dense:
                p["dense_layers"] = blocks.decoder_stack_init(
                    generator, self._dense_cfg, self._dense_kind,
                    cfg.first_k_dense)
            p["layers"] = blocks.decoder_stack_init(
                generator, cfg, self._kind, self._stacked_layers())
        if cfg.family == "hybrid":
            p["shared_attn"] = blocks.decoder_layer_init(generator, cfg)
        return _to(p, self.device)

    def _hybrid_segments(self) -> Tuple[int, int]:
        """(groups, remainder layers): the shared attention block runs
        before each of the ``groups`` groups of ``attn_every`` Mamba
        layers; the ``remainder`` layers follow with no attention."""
        cfg = self.cfg
        g = cfg.num_layers // cfg.attn_every
        return g, cfg.num_layers - g * cfg.attn_every

    # ------------------------------------------------------------ embedding

    def _rows(self, seq: int):
        """The context for a stream of ``seq`` positions: its rows split
        over "model" where the reference's ``_sp`` resolves."""
        return seq_sharded(tp.rows_for(seq))

    def _embed(self, params: Params, tokens: torch.Tensor,
               extra: Optional[Dict[str, torch.Tensor]] = None
               ) -> torch.Tensor:
        """Token embeddings in the compute dtype, every row on every rank;
        a VLM batch's ``patches`` (B, P, D) go before them.  An embedding
        that came as the rank's vocab rows looks up the tokens it holds
        and sums the rows over "model" (each token's row is on one
        rank)."""
        emb, dt = params["embedding"], _dtype(self.cfg.dtype)
        lo, nv = tp.vocab_shard(emb.shape[0], self.cfg.vocab_size)
        if nv == self.cfg.vocab_size:
            x = emb[tokens.long()].to(dt)
        else:
            t = tokens.long() - lo
            inside = ((t >= 0) & (t < nv))[..., None]
            x = emb[torch.where(inside[..., 0], t, 0)].to(dt)
            x = psum(torch.where(inside, x, torch.zeros((), dtype=dt,
                                                        device=x.device)),
                     "model")
        if self.cfg.family == "vlm" and extra is not None \
                and "patches" in extra:
            x = torch.cat([extra["patches"].to(x.dtype), x], dim=1)
        return x

    def _encode(self, params: Params, frames: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        """Whisper's encoder: frames (B, Se, D) cast to ``dtype``, plus the
        sinusoid cast to it, through ``enc_layers`` (each under
        ``_remat`` when autograd records) and the LayerNorm ``enc_norm``.
        Under tensor parallelism the encoder's rows split as its own
        stream, and the states come back with every row, entered for
        cross attention on the rank's heads (``tp.enter``) or handed to
        whole-head cross attention as every rank computes it."""
        cfg = self.cfg
        frames = frames.to(dtype)
        pos = torch.from_numpy(_sinusoid(frames.shape[1], cfg.d_model))
        e = frames + pos.to(frames.device)[None].to(dtype)
        step = _remat(lambda xx, p_l: blocks.enc_layer_apply(p_l, xx, cfg),
                      cfg)
        with self._rows(e.shape[1]):
            e = tp.split_rows(e)
            for p_l in unstack_layers(params["enc_layers"],
                                      cfg.num_encoder_layers):
                e = step(e, p_l)
            e = layernorm(tp.on_rows(params["enc_norm"]), e, cfg.norm_eps)
            if not tp.active():
                return e
            cross = params["dec_layers"]["cross"]["w_q"]
            if tp.split_dim(cross.shape[-2], cfg.num_heads):
                return tp.enter(e)
            return tp.gather_rows(e)

    def _final_norm(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """``final_norm``: a LayerNorm for encdec (whisper), else RMSNorm."""
        norm = layernorm if self.cfg.family == "encdec" else rmsnorm
        return norm(tp.on_rows(params["final_norm"]), x, self.cfg.norm_eps)

    def _unembed_weight(self, params: Params) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embedding"].T
        return params["lm_head"]

    def _logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        """(…, D) final hidden, the same on every rank → (…, V) fp32
        logits (a vocab-parallel unembedding gathers the shards)."""
        w = self._unembed_weight(params)
        logits = (h @ w.to(h.dtype)).float()
        if tp.split_dim(w.shape[1], self.cfg.vocab_size):
            logits = all_gather(logits, logits.ndim - 1, "model",
                                current_ctx())
        return logits

    def _last_row(self, x: torch.Tensor) -> torch.Tensor:
        """The stream's last position (B, D), on every rank."""
        if not tp.rows_split():
            return x[:, -1]
        return all_gather(x[:, -1:], 1, "model", current_ctx())[:, -1]

    # ------------------------------------------------------------ training

    def _backbone_train(self, params: Params, x: torch.Tensor,
                        extra: Optional[Dict[str, torch.Tensor]] = None,
                        positions: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (final-normed hidden, aux dict summed over layers —
        ``moe.zero_aux``'s schema), on the stream's rows.  ``extra`` is
        the batch, whose ``frames`` an encoder-decoder model encodes;
        ``positions`` the global (1, S) (default: x's rows)."""
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
        aux = blocks.zero_aux(x.device)

        if cfg.family == "encdec":
            e = self._encode(params, extra["frames"], x.dtype)
            dstep = _remat(lambda xx, ee, p_l: blocks.dec_layer_train(
                p_l, xx, ee, cfg, positions), cfg)
            for p_l in unstack_layers(params["dec_layers"], cfg.num_layers):
                x = dstep(x, e, p_l)
            return self._final_norm(params, x), aux

        if cfg.family in ("ssm", "hybrid"):
            layers = unstack_layers(params["layers"], cfg.num_layers)
            mstep = _remat(lambda xx, p_l: blocks.mamba_layer_train(
                p_l, xx, cfg), cfg)
            start = 0
            if cfg.family == "hybrid":
                g, _ = self._hybrid_segments()
                per = cfg.attn_every
                for gi in range(g):
                    x, _ = blocks.decoder_layer_train(
                        params["shared_attn"], x, cfg, positions)
                    for p_l in layers[gi * per:(gi + 1) * per]:
                        x = mstep(x, p_l)
                start = g * per
            for p_l in layers[start:]:
                x = mstep(x, p_l)
            return self._final_norm(params, x), aux

        for key, _ck, n, kind, scfg in self._decoder_segments(params):
            step = _remat(lambda xx, p_l, kind=kind, scfg=scfg:
                          blocks.decoder_layer_train(p_l, xx, scfg, positions,
                                                     kind), cfg)
            for p_l in unstack_layers(params[key], n):
                x, a = step(x, p_l)
                aux = {k: aux[k] + a[k] for k in aux}
        return self._final_norm(params, x), aux

    def lm_loss(self, params: Params, h: torch.Tensor, targets: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Sequence-chunked cross entropy: fp32 logits one ``loss_chunk``
        of positions at a time (each chunk under ``_remat``), targets < 0
        masked.  ``h`` is on the stream's rows and ``targets`` (B, S) every
        row.  An unembedding that came as the rank's vocab columns takes
        every row (``tp.enter``) and combines its shard's statistics over
        "model" (:func:`vocab_parallel_stats`); a whole one takes the
        rank's rows, and the sums then run over "model" too."""
        cfg = self.cfg
        w = self._unembed_weight(params).to(h.dtype)
        lo, nv = tp.vocab_shard(w.shape[1], cfg.vocab_size)
        vocab = nv != cfg.vocab_size
        rows = tp.rows_split()
        targets = targets.long()
        if vocab:
            h = tp.enter(h)
        elif rows:
            w = tp.shared(w)
            targets = chunk_of(targets, 1, "model", current_ctx())
        b, s, d = h.shape
        chunk = min(cfg.loss_chunk, s)
        while s % chunk:
            chunk //= 2

        def chunk_fn(h_i, t_i):
            logits = (h_i @ w).float()
            safe_t = torch.clamp(t_i, min=0)
            if vocab:
                lse, ll, pred = vocab_parallel_stats(logits, safe_t, lo,
                                                     _model_reduce)
            else:
                lse = torch.logsumexp(logits, dim=-1)
                ll = torch.gather(logits, -1, safe_t[..., None])[..., 0]
                # argmax takes the first maximum, as jnp.argmax does
                pred = torch.argmax(logits, dim=-1)
            mask = (t_i >= 0).float()
            return (((lse - ll) * mask).sum(), (lse.square() * mask).sum(),
                    ((pred == safe_t).float() * mask).sum(), mask.sum())

        step = _remat(chunk_fn, cfg)
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        loss_sum = z_sum = correct = count = zero
        for c0 in range(0, s, chunk):
            l_, z_, c_, n_ = step(h[:, c0:c0 + chunk],
                                  targets[:, c0:c0 + chunk])
            loss_sum, z_sum = loss_sum + l_, z_sum + z_
            correct, count = correct + c_, count + n_
        # every rank's rows: the sums run over the whole batch
        axes = current_ctx().split_batch + (("model",) if rows and not vocab
                                            else ())
        if axes:
            loss_sum, z_sum = psum(loss_sum, axes), psum(z_sum, axes)
            correct = all_reduce(correct.detach().clone(), axes, current_ctx())
            count = all_reduce(count.detach().clone(), axes, current_ctx())
        count = torch.clamp(count, min=1.0)
        loss = loss_sum / count
        metrics = {"ce_loss": loss, "z_loss": z_sum / count,
                   "accuracy": correct / count, "tokens": count}
        return loss, metrics

    def train_loss(self, params: Params, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch["tokens"], batch["targets"]: (B, S) int (with ``patches``
        (B, P, D) for a VLM, ``frames`` (B, Se, D) for encdec) → (total
        loss, metrics): loss + 0.01·aux + 1e-4·z_loss, with the MoE
        dispatch metrics (zeros for a dense model) as the reference
        reports them.  Patch positions carry no next-token loss.

        Under a mesh ``params`` are this rank's shards (or whole leaves)
        and ``batch`` the whole batch, the same on every rank: the rank
        computes its "dp" rows, and within them its "model" share of
        each layer (``gather_params``; the stream's rows split over
        "model" between sublayers); the sums of the loss and its
        statistics run over every rank's rows, and so the returned loss
        is the whole batch's on every rank; the gradient of each shard
        sums over "dp"."""
        ctx = current_ctx()
        if not ctx.active:
            return self._train_loss(params, batch)
        dp = _entry_axes(ctx.resolve("dp", batch["tokens"].shape[0]))
        with batch_split(dp) as sctx:
            if dp:
                batch = {k: chunk_of(v, 0, dp, sctx) for k, v in batch.items()}
            return self._train_loss(gather_params(params, self.cfg, sctx),
                                    batch)

    def _train_loss(self, params: Params, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x = self._embed(params, batch["tokens"], batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        targets = batch["targets"]
        if self.cfg.family == "vlm" and "patches" in batch:
            pad = torch.full((targets.shape[0], batch["patches"].shape[1]),
                             -1, dtype=targets.dtype, device=targets.device)
            targets = torch.cat([pad, targets], dim=1)
        with self._rows(x.shape[1]):
            h, aux = self._backbone_train(params, tp.split_rows(x), batch,
                                          positions)
            loss, metrics = self.lm_loss(params, h, targets)
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
        """batch["tokens"]: (B, S) int (with ``patches`` / ``frames`` as in
        :meth:`train_loss`) → (last logits (B, V) fp32, cache):
        {"layers": {"k", "v"}} (L, B, KH, S, hd) for dense models (and a
        MoE model's MoE layers, with {"dense": {"k", "v"}} for its
        leading dense ones; under MLA {"c_kv", "k_rope"} (L, B, S, rkv |
        dr) in their place), {"layers": mamba} for ssm, {"groups":
        {"attn", "mamba"}, "remainder": mamba} for hybrid, {"layers":
        {"k", "v", "cross_k", "cross_v"}} for encdec (see
        :meth:`alloc_cache`).  A VLM's cache holds the patches' positions
        first: decode continues at ``cur_len`` = P + S.  Under a mesh
        every rank runs every batch row, with its "model" share of each
        layer and its stripe of the sequence (as ``train_loss``); the
        logits are whole on every rank, and each cache is at rest in its
        decode layout (:meth:`alloc_cache`): the rank's kv heads, or its
        stripe of the sequence for whole-head attention; MLA's latents
        whole."""
        cfg = self.cfg
        ctx = current_ctx()
        if ctx.active:
            params = gather_params(params, cfg, ctx)
        x = self._embed(params, batch["tokens"], batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        with self._rows(x.shape[1]):
            x, cache = self._prefill_layers(params, tp.split_rows(x),
                                            positions, batch)
            last = self._last_row(x)
        return self._logits(params, self._final_norm(params, last)), cache

    def _prefill_layers(self, params: Params, x: torch.Tensor,
                        positions: torch.Tensor,
                        batch: Dict[str, torch.Tensor]):
        cfg = self.cfg
        fam = cfg.family

        def mamba_run(x, lo, hi):
            caches = []
            for i in range(lo, hi):
                x, c = blocks.mamba_layer_prefill(
                    layer_params(params["layers"], i), x, cfg)
                caches.append(c)
            return x, stack_trees(caches)

        if fam == "ssm":
            x, layers = mamba_run(x, 0, cfg.num_layers)
            cache = {"layers": layers}
        elif fam == "encdec":
            e = self._encode(params, batch["frames"], x.dtype)
            caches = []
            for i in range(cfg.num_layers):
                x, c = blocks.dec_layer_prefill(
                    layer_params(params["dec_layers"], i), x, e, cfg,
                    positions)
                caches.append(c)
            cache = {"layers": stack_trees(caches)}
        elif fam == "hybrid":
            g, rem = self._hybrid_segments()
            per = cfg.attn_every
            attn, mamba = [], []
            for gi in range(g):
                x, c = blocks.decoder_layer_prefill(
                    params["shared_attn"], x, cfg, positions)
                attn.append(c)
                x, c = mamba_run(x, gi * per, (gi + 1) * per)
                mamba.append(c)
            cache = {"groups": {"attn": stack_trees(attn),
                                "mamba": stack_trees(mamba)}}
            if rem:
                x, cache["remainder"] = mamba_run(x, g * per, cfg.num_layers)
        else:
            cache = {}
            for key, ck, n, kind, scfg in self._decoder_segments(params):
                kv = []
                for i in range(n):
                    x, c = blocks.decoder_layer_prefill(
                        layer_params(params[key], i), x, scfg, positions,
                        kind)
                    kv.append(c)
                cache[ck] = stack_trees(kv)
        return x, cache

    # ---------------------------------------------------------------- decode

    def decode_step(self, params: Params, cache: Any, token: torch.Tensor,
                    cur_len):
        """token: (B, 1) int; cur_len: int (or one-element tensor), tokens
        already cached.  The cache is updated in place and returned.
        Under a mesh, as :meth:`prefill`, on every row (S = 1), against
        the caches :meth:`alloc_cache` lays out."""
        cfg = self.cfg
        cur = int(cur_len)
        ctx = current_ctx()
        if ctx.active:
            params = gather_params(params, cfg, ctx)
        x = self._embed(params, token)
        fam = cfg.family

        def mamba_run(x, lo, hi, caches):
            for i in range(lo, hi):
                x, _ = blocks.mamba_layer_decode(
                    layer_params(params["layers"], i), x, cfg,
                    layer_params(caches, i - lo))
            return x

        if fam == "ssm":
            x = mamba_run(x, 0, cfg.num_layers, cache["layers"])
        elif fam == "encdec":
            for i in range(cfg.num_layers):
                x, _ = blocks.dec_layer_decode(
                    layer_params(params["dec_layers"], i), x, cfg,
                    layer_params(cache["layers"], i), cur)
        elif fam == "hybrid":
            g, rem = self._hybrid_segments()
            per = cfg.attn_every
            groups = cache["groups"]
            for gi in range(g):
                x, _ = blocks.decoder_layer_decode(
                    params["shared_attn"], x, cfg,
                    layer_params(groups["attn"], gi), cur)
                x = mamba_run(x, gi * per, (gi + 1) * per,
                              layer_params(groups["mamba"], gi))
            if rem:
                x = mamba_run(x, g * per, cfg.num_layers, cache["remainder"])
        else:
            for key, ck, n, kind, scfg in self._decoder_segments(params):
                for i in range(n):
                    x, _ = blocks.decoder_layer_decode(
                        layer_params(params[key], i), x, scfg,
                        layer_params(cache[ck], i), cur, kind)
        h = self._final_norm(params, x)
        return self._logits(params, h[:, -1]), cache

    # ----------------------------------------------------------------- cache

    def cache_spec(self, batch: int, seq: int) -> Any:
        """The decode cache tree on the meta device (shapes and dtypes, no
        storage), as the reference's ``cache_spec`` gives it for an AOT
        decode step: :meth:`alloc_cache`'s leaves, names and shapes —
        under a mesh, this rank's share of each."""
        return LanguageModel(self.cfg, device="meta").alloc_cache(batch, seq)

    def alloc_cache(self, batch: int, seq: int,
                    init: Optional[Any] = None) -> Any:
        """Zeroed decode cache in the reference's ``cache_spec`` layout:
        attention k/v (n, batch, KH, seq, hd) in the compute dtype, or
        under MLA the latents c_kv (n, batch, seq, rkv) and k_rope (n,
        batch, seq, dr); Mamba
        conv tails (…, batch, K-1, C) in the compute dtype and states
        (…, batch, H, P, N) in fp32, both independent of ``seq``.  Dense:
        {"layers": kv}; MoE: {"layers": kv} over the MoE layers and, with
        ``first_k_dense``, {"dense": kv}; ssm: {"layers": mamba}; hybrid:
        {"groups": {"attn": kv (g, …), "mamba": mamba (g, per, …)},
        "remainder": mamba (rem, …)}; encdec: {"layers": kv and the cross
        caches "cross_k" / "cross_v" (L, batch, encoder_seq, H, hd)}.  The
        self-attention caches have KH heads, as the prefill makes them
        (the reference's ``cache_spec`` says H for encdec, which differs
        where KH < H).  ``init`` (a prefill cache of S ≤ seq positions)
        is copied in: attention and latent caches into their first S
        positions, Mamba and cross caches whole.

        Under tensor parallelism each cache holds this rank's share, as
        the layers lay it out (:meth:`_kv_share`): the kv heads of its q
        heads (KH/m; when only q splits, the kv heads those read), or,
        for whole-head attention, every kv head over its stripe of
        ⌈seq/m⌉ positions (the lse-combine; ``init``'s stripes are
        gathered and cut again); MLA's latents whole; the cross caches
        the rank's H/m heads; a Mamba mixer's conv tail its channels and
        its state its heads."""
        cfg = self.cfg
        cdt = _dtype(cfg.dtype)
        dev = self.device
        kh, striped = self._kv_share(cfg.num_heads, cfg.num_kv_heads)
        m = current_ctx().model_size
        kv_seq = -(-seq // m) if striped else seq

        def kv(n):
            if cfg.use_mla:
                return {name: torch.zeros((n, batch, seq, width), dtype=cdt,
                                          device=dev)
                        for name, width in (("c_kv", cfg.kv_lora_rank),
                                            ("k_rope", cfg.qk_rope_head_dim))}
            shape = (n, batch, kh, kv_seq, cfg.head_dim)
            return {name: torch.zeros(shape, dtype=cdt, device=dev)
                    for name in ("k", "v")}

        # a mixer on the rank's share: its conv channels and state heads
        ctx = current_ctx()
        mm = m if tp.active(ctx) and ctx.resolve("tp", cfg.d_inner) else 1

        def mamba(*lead):
            ck = cfg.conv_kernel - 1
            z = functools.partial(torch.zeros, device=dev)
            return {"conv_x": z((*lead, batch, ck, cfg.d_inner // mm),
                                dtype=cdt),
                    "conv_B": z((*lead, batch, ck, cfg.ssm_state), dtype=cdt),
                    "conv_C": z((*lead, batch, ck, cfg.ssm_state), dtype=cdt),
                    "state": z((*lead, batch, cfg.ssm_heads // mm,
                                cfg.ssm_head_dim, cfg.ssm_state),
                               dtype=torch.float32)}

        if cfg.family == "ssm":
            out = {"layers": mamba(cfg.num_layers)}
        elif cfg.family == "encdec":
            n, shape = cfg.num_layers, (batch, cfg.encoder_seq,
                                        self._kv_share(cfg.num_heads,
                                                       cfg.num_heads)[0],
                                        cfg.head_dim)
            out = {"layers": {**kv(n), **{
                name: torch.zeros((n, *shape), dtype=cdt, device=dev)
                for name in ("cross_k", "cross_v")}}}
        elif cfg.family == "hybrid":
            g, rem = self._hybrid_segments()
            out = {"groups": {"attn": kv(g), "mamba": mamba(g, cfg.attn_every)}}
            if rem:
                out["remainder"] = mamba(rem)
        else:
            out = {"layers": kv(self._stacked_layers())}
            if cfg.first_k_dense:
                out["dense"] = kv(cfg.first_k_dense)
        if init is not None:
            _fill(out, init, striped)
        return out

    def _kv_share(self, h: int, kh: int) -> Tuple[int, bool]:
        """(kv heads, striped over the sequence) of an attention cache of
        ``h`` / ``kh`` heads at rest: what the layer's leaves give it
        (``blocks._attn_apply``), from the same resolved spec as
        ``gather_params`` ("tp" on the head dim of w_q and w_k)."""
        ctx = current_ctx()
        if not tp.active(ctx):
            return kh, False
        if ctx.resolve("tp", h) is None:
            return kh, True
        if ctx.resolve("tp", kh) is not None:
            return kh // ctx.model_size, False
        return len(tp.kv_heads_read(h // ctx.model_size, h, kh)), False


def _fill(buf: Any, src: Any, striped: bool = False) -> None:
    """Copy a prefill cache into an allocated one: attention k/v and MLA's
    latents into their first S positions along seq (the second-to-last
    dimension of each), every other leaf whole.  ``striped`` k / v hold a
    stripe of the sequence on each rank: the prefill's stripes are
    gathered and this rank's stripe of the new length cut from them."""
    for name, b in buf.items():
        if isinstance(b, dict):
            _fill(b, src[name], striped)
        elif name in ("k", "v") and striped:
            full = all_gather(src[name], src[name].ndim - 2, "model",
                              current_ctx())
            chunk = b.shape[-2]
            lo = current_ctx().coord("model") * chunk
            part = full[..., lo:lo + chunk, :]
            b[..., : part.shape[-2], :] = part
        elif name in ("k", "v", "c_kv", "k_rope"):
            b[..., : src[name].shape[-2], :] = src[name]
        else:
            b.copy_(src[name])


def _to(tree: Params, device: torch.device) -> Params:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}
