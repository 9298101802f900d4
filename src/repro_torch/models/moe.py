"""Mixture-of-Experts layer: the no-mesh and mesh branches of
``repro.models.moe``.

Routing runs in fp32 (top-k of the router's softmax, renormalized);
each (token, choice) pair takes a slot in its expert's bucket of
``C = _capacity(cfg, tokens)`` rows, the earliest tokens first (a stable
sort), and pairs past C are dropped and fall through on the residual
path.  The expert products are batched matmuls over the (E, C, ·)
buckets, and the combine sums each token's gate-weighted rows.  Every
expert's weights are read whatever the routing: the reference's grouped
GEMM over capacity.

Dispatch and combine are ``torch.autograd.Function``s whose backwards
are the mirror scatter / gather, as the reference's custom VJPs.  They
run in chunks of at most ``CHUNK_ROWS`` (token, choice) rows, so the
(T·k, D) gather never materializes whole.  Neither uses atomics: the
dispatch writes each kept pair into its own slot (every dropped pair
writes zeros into the trash row C, which is cut off), and the combine
gathers token t's k rows, which sit at t·k … t·k + k − 1, and sums them
over k in a fixed order.  So the layer gives the same bits on every call
on the card, with no global deterministic switch.  Nothing reads the
card: the capacity comes from shapes, and the dispatch stats stay
tensors until the trainer reads its metrics.

Under a mesh (``dist.sharding.use_mesh``) whose "model" axis divides the
expert count, expert banks shard E → "model" (EP) and the experts run
in a region over the "model" group (the reference's ``shard_map``), on
the same dispatch, expert products and combine:

* ``cfg.moe_dispatch="a2a"`` (the default): tokens shard S → "model";
  each rank packs per-destination-expert capacity buckets (E, C, D) of
  its own tokens (``_a2a_capacity``), :func:`_exchange` (an
  ``all_to_all_single``, whose backward is the reverse exchange) hands
  each peer the §6 range of its experts, the local experts run on the
  received (E/m, m·C, D), and a second exchange brings the results home
  for the combine;
* ``"psum"``: tokens replicate over "model"; every rank computes its
  local experts (global ids from ``e_off = rank · E/m``) against all
  tokens and a sum over "model" combines them.

Banks whose d_model dim is FSDP-sharded are re-gathered over it
(``_gather_banks``).  When a call's batch is whole on every rank, the
region also splits it over "dp", as the reference's ``shard_map`` does,
so each shard's capacity counts its own tokens; a training step that
has split its batch over "dp" already sums the balance loss's means and
the drop counts over "dp".  Without a mesh the reference takes the
no-mesh branch whatever ``cfg.moe_dispatch`` says, and so does the port.

Outside the region (no mesh, a "model" axis of 1, ``pure_dp``, or
experts that "model" does not divide) the reference routes in its
global view: every (token, choice) pair takes its slot in token-major
order over the whole (B, S) batch, at the capacity of B·S tokens.  A
rank that holds only part of the batch — its rows of a training step's
"dp" split, and under tensor parallelism its stripe of the sequence —
computes the same slots (:func:`_global_positions`: its local positions
plus, per expert, the pairs on every earlier (row, stripe) of other
ranks, from one small all-gather of per-row expert counts) and keeps a
pair while its global slot is below that capacity.  Its bucket holds
its own kept pairs only (at most min(C, its tokens) rows an expert), so
the expert products run over the rank's own tokens, and the balance
loss and drop counts sum over the split axes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (_entry_axes, all_gather, all_reduce,
                                      chunk_of, count_traffic, current_ctx,
                                      gather, gather_param, gather_seq,
                                      moe_bucket_ranges, on_layout, psum,
                                      scatter_seq, split, whole)
from . import tp
from .layers import Params, _dtype, dense_init, mlp_init, stack_trees

# (token, choice) rows one chunk of the dispatch / combine loops takes
CHUNK_ROWS = 16384


def _bank(gen: torch.Generator, lead: Tuple[int, ...], fan_in: int,
          fan_out: int, dtype: torch.dtype) -> torch.Tensor:
    """(*lead, fan_in, fan_out) weights of scale 1/√fan_in, allocated
    once and drawn one (fan_in, fan_out) matrix at a time in fp32, cast
    on write: a full-width bank is never held in fp32, nor twice."""
    out = torch.empty((*lead, fan_in, fan_out), dtype=dtype, device=gen.device)
    if out.device.type == "meta":          # shapes only (``launch.specs``)
        return out
    for w in out.view(-1, fan_in, fan_out):
        w.copy_(torch.randn((fan_in, fan_out), generator=gen,
                            device=gen.device) / np.sqrt(fan_in))
    return out


def moe_init(gen: torch.Generator, cfg, layers: Optional[int] = None
             ) -> Params:
    """One MoE layer's parameters — ``router`` (D, E) fp32, the expert
    banks ``w_gate`` / ``w_up`` (E, D, F) and ``w_down`` (E, F, D), the
    ``shared`` experts' MLP (width F · num_shared_experts) and the
    ``dense_residual`` MLP (d_ff) where the config has them — or, with
    ``layers``, the stacked (layers, …) tree of that many."""
    d, e = cfg.d_model, cfg.num_experts
    f = cfg.moe_d_ff or cfg.d_ff
    dt = _dtype(cfg.param_dtype)
    lead = () if layers is None else (layers,)

    def each(init):
        if layers is None:
            return init()
        per = [init() for _ in range(layers)]
        return (stack_trees(per) if isinstance(per[0], dict)
                else torch.stack(per))

    p: Params = {
        "router": each(lambda: dense_init(gen, d, (e,), torch.float32)),
        "w_gate": _bank(gen, (*lead, e), d, f, dt),
        "w_up": _bank(gen, (*lead, e), d, f, dt),
        "w_down": _bank(gen, (*lead, e), f, d, dt),
    }
    if cfg.num_shared_experts > 0:
        p["shared"] = each(lambda: mlp_init(
            gen, d, f * cfg.num_shared_experts, dt))
    if cfg.moe_dense_residual:
        p["dense_residual"] = each(lambda: mlp_init(gen, d, cfg.d_ff, dt))
    return p


def _route(logits: torch.Tensor, k: int, renormalize: bool = True
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing.  logits: (T, E) fp32 → (gates (T, k) fp32, idx (T, k)).

    The top k come from a stable descending sort, so of two equal
    probabilities the lower expert comes first, as in ``jax.lax.top_k``
    (``torch.topk`` promises no order on ties)."""
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    if renormalize:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx


def load_balance_loss(logits: torch.Tensor, idx: torch.Tensor,
                      num_experts: int, dp=()) -> torch.Tensor:
    """Switch-style auxiliary loss over all k routed choices:
    E · Σ_e f_e · P_e, with f_e the fraction of (token, choice) slots
    routed to expert e and P_e its mean router probability.  With ``dp``
    axes (a training step's batch split over them) both means run over
    every rank's tokens."""
    probs = torch.softmax(logits, dim=-1)
    if not dp:
        f = F.one_hot(idx.reshape(-1), num_experts).float().mean(dim=0)
        return num_experts * torch.sum(f * probs.mean(dim=0))
    counts = F.one_hot(idx.reshape(-1), num_experts).float().sum(dim=0)
    n = torch.full((1,), float(idx.shape[0]), device=logits.device)
    n = all_reduce(n, dp, current_ctx())
    f = all_reduce(counts, dp, current_ctx()) / (n * idx.shape[1])
    return num_experts * torch.sum(f * psum(probs.sum(dim=0), dp) / n)


def zero_aux(device=None) -> Dict[str, torch.Tensor]:
    """Zero MoE aux dict: what a dense layer adds to the backbone's sums."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"loss": z, "dropped": z, "routed": z, "a2a_bytes": z}


def _expert_positions(flat_e: torch.Tensor, n: int) -> torch.Tensor:
    """Rank of each (token, choice) within its expert, in token order:
    stable-sort by expert id, then position = index − start of its run,
    where the start propagates by a running maximum."""
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    arange_n = torch.arange(n, device=flat_e.device)
    new_run = torch.ones(n, dtype=torch.bool, device=flat_e.device)
    new_run[1:] = sorted_e[1:] != sorted_e[:-1]
    starts = torch.cummax(torch.where(new_run, arange_n, 0), dim=0).values
    pos = torch.empty_like(arange_n)
    pos[order] = arange_n - starts
    return pos


def _global_positions(idx: torch.Tensor, num_experts: int, dp=(),
                      stripe: bool = False, ctx=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(local, global) position of each (token, choice) pair of idx (b,
    s, k) within its expert.  The local one is :func:`_expert_positions`
    over this rank's pairs; the global one is the reference's global view,
    the rank over the whole (B, S) batch in token-major order, where this
    rank holds a block of rows over the ``dp`` axes and, with ``stripe``,
    a stripe of the sequence over "model".  It adds to the local position
    the pairs of the same expert on every (row, stripe) that comes earlier
    in that order and is not this rank's: an exclusive prefix over a (b,
    E) int32 count table gathered over the axes.  With no split both are
    the same tensor."""
    b, s, k = idx.shape
    n = b * s * k
    flat_e = idx.reshape(n)
    pos = _expert_positions(flat_e, n)
    if not dp and not stripe:
        return pos, pos
    counts = torch.zeros((b, num_experts), dtype=torch.int32,
                         device=idx.device)
    counts.scatter_add_(1, idx.reshape(b, s * k),
                        torch.ones((b, s * k), dtype=torch.int32,
                                   device=idx.device))
    table = counts[:, None]                            # (b, 1, E)
    if stripe:
        table = all_gather(table, 1, "model", ctx)     # (b, m, E)
    if dp:
        table = all_gather(table, 0, dp, ctx)          # (B, m, E)
    flat = table.reshape(-1, num_experts)
    before = (torch.cumsum(flat, 0) - flat).view(table.shape)
    if dp:
        before = chunk_of(before, 0, dp, ctx)
    if stripe:
        before = chunk_of(before, 1, "model", ctx)
    # minus this rank's own earlier rows, which the local position counts
    offset = before[:, 0] - (torch.cumsum(counts, 0) - counts)
    row = torch.arange(b, device=idx.device).repeat_interleave(s * k)
    return pos, pos + offset[row, flat_e]


def _capacity(cfg, tokens: int) -> int:
    """Per-expert bucket capacity over ``tokens`` routing together, a
    multiple of 8 and at least 8 (the reference's psum / no-mesh
    rule)."""
    c = int(np.ceil(cfg.experts_per_token * tokens * cfg.capacity_factor
                    / cfg.num_experts))
    return max(8, int(np.ceil(c / 8) * 8))


def _a2a_capacity(cfg, tokens: int) -> int:
    """The a2a path's per-source bucket capacity: its GEMM batches m·C
    rows, so small buckets stay tight (no rounding to 8)."""
    c = int(np.ceil(cfg.experts_per_token * tokens * cfg.capacity_factor
                    / cfg.num_experts))
    return max(1, c)


def _chunked(t: int, k: int):
    """(first token, end token) of each chunk of ``t`` tokens' ``t·k``
    rows: whole tokens, at most ``CHUNK_ROWS`` rows (one token at least).
    The reference halves its chunk until it divides the rows
    (``lax.scan`` wants equal chunks); a loop takes a shorter last chunk
    instead, so 16,800 rows run as 2 chunks and not 525."""
    step = max(1, min(t * k, CHUNK_ROWS) // k)
    return [(t0, min(t0 + step, t)) for t0 in range(0, t, step)]


class _Dispatch(torch.autograd.Function):
    """x_flat (T, D) → buckets (E, C, D): row t·k + j of the tables is
    token t's j-th choice, whose slot is (e, p); a pair of weight 0 (a
    drop) writes zeros into the trash row C.  The backward gathers each
    token's k slots and sums them over k."""

    @staticmethod
    def forward(ctx, x_flat, e, p, w, k: int, e_loc: int, capacity: int):
        t, d = x_flat.shape
        acc = x_flat.new_zeros((e_loc, capacity + 1, d))
        keep = (w > 0).to(x_flat.dtype)[:, None]
        for t0, t1 in _chunked(t, k):
            r = slice(t0 * k, t1 * k)
            rows = x_flat[t0:t1].repeat_interleave(k, dim=0) * keep[r]
            acc[e[r], p[r]] = rows
        ctx.save_for_backward(e, p, w)
        ctx.k = k
        return acc[:, :capacity]

    @staticmethod
    def backward(ctx, g_out):
        e, p, w = ctx.saved_tensors
        k = ctx.k
        e_loc, _cap, d = g_out.shape
        g_ext = torch.cat([g_out, g_out.new_zeros((e_loc, 1, d))], dim=1)
        keep = (w > 0).to(g_out.dtype)[:, None]
        t = e.shape[0] // k
        dx = g_out.new_empty((t, d))
        for t0, t1 in _chunked(t, k):
            r = slice(t0 * k, t1 * k)
            rows = g_ext[e[r], p[r]] * keep[r]
            dx[t0:t1] = rows.view(t1 - t0, k, d).sum(dim=1)
        return dx, None, None, None, None, None, None


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The combine sums in fp32 (float64 for float64 inputs, as in a
    gradient check)."""
    return torch.promote_types(dtype, torch.float32)


class _Combine(torch.autograd.Function):
    """y_grouped (E, C, D) → y (T, D) in fp32: token t's k slots, each
    times its gate weight, summed over k (a dropped pair reads the zero
    trash row with weight 0).  The backward scatters dy · w into the
    slots and gives each weight its dot product dy · y_slot."""

    @staticmethod
    def forward(ctx, y_grouped, e, p, w, k: int):
        e_loc, _cap, d = y_grouped.shape
        acc = _acc_dtype(y_grouped.dtype)
        y_ext = torch.cat([y_grouped, y_grouped.new_zeros((e_loc, 1, d))],
                          dim=1)
        t = e.shape[0] // k
        y = torch.empty((t, d), dtype=acc, device=y_grouped.device)
        for t0, t1 in _chunked(t, k):
            r = slice(t0 * k, t1 * k)
            rows = y_ext[e[r], p[r]].to(acc) * w[r, None]
            y[t0:t1] = rows.view(t1 - t0, k, d).sum(dim=1)
        ctx.save_for_backward(y_ext, e, p, w)
        ctx.k = k
        return y

    @staticmethod
    def backward(ctx, dy):
        y_ext, e, p, w = ctx.saved_tensors
        k = ctx.k
        e_loc, cap1, d = y_ext.shape
        acc = _acc_dtype(y_ext.dtype)
        dg = torch.zeros((e_loc, cap1, d), dtype=acc, device=dy.device)
        dw = torch.empty_like(w)
        for t0, t1 in _chunked(dy.shape[0], k):
            r = slice(t0 * k, t1 * k)
            dy_rows = dy[t0:t1].to(acc).repeat_interleave(k, dim=0)
            dg[e[r], p[r]] = dy_rows * w[r, None]
            dw[r] = (y_ext[e[r], p[r]].to(acc) * dy_rows).sum(dim=-1)
        return dg[:, :cap1 - 1].to(y_ext.dtype), None, None, dw, None


# (x_flat, e, p, w, k, e_loc, capacity) → (E, C, D) buckets
_dispatch = _Dispatch.apply
# (y_grouped, e, p, w, k) → (T, D) fp32
_combine = _Combine.apply


def _experts(x_grouped: torch.Tensor, w_gate: torch.Tensor,
             w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The SwiGLU expert products over (E, C, D) buckets: silu in fp32,
    cast to the input dtype, times the up projection."""
    g = torch.bmm(x_grouped, w_gate)
    u = torch.bmm(x_grouped, w_up)
    h = F.silu(g.float()).to(x_grouped.dtype) * u
    return torch.bmm(h, w_down)


def _grouped_experts(x_flat: torch.Tensor, gates: torch.Tensor,
                     idx: torch.Tensor, w_gate: torch.Tensor,
                     w_up: torch.Tensor, w_down: torch.Tensor, capacity: int,
                     e_offset: int = 0, positions=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bucketed grouped-GEMM over one shard's local experts,
    global ids ``e_offset`` … ``e_offset + E_loc − 1``.

    x_flat: (T, D); gates / idx: (T, k); w_*: (E_loc, D, F) / (E_loc, F,
    D).  Returns ``(y, kept)``: (T, D) sum of the local experts'
    contributions, pairs past ``capacity`` dropped, and each token's count
    of choices that landed on a local expert and kept their slot.

    ``positions``, when this rank holds part of the batch that routes
    together, is :func:`_global_positions`' (local, global) pair: a pair
    is kept while its global position is below ``capacity``, and its local
    position is its slot in a bucket of min(capacity, T) rows (the kept
    pairs of an expert are its first ones on this rank)."""
    t, _d = x_flat.shape
    k = idx.shape[1]
    e_loc = w_gate.shape[0]
    n = t * k
    flat_e = idx.reshape(n)
    flat_g = gates.reshape(n)
    if positions is None:
        pos = gpos = _expert_positions(flat_e, n)
        bucket = capacity
    else:
        pos, gpos = positions
        bucket = min(capacity, t)
    local_e = flat_e - e_offset
    valid = ((local_e >= 0) & (local_e < e_loc) & (gpos < capacity)
             & (flat_g > 0))
    safe_e = torch.where(valid, local_e, 0)
    safe_pos = torch.where(valid, pos, bucket)            # the trash row
    w = flat_g * valid
    x_grouped = _dispatch(x_flat, safe_e, safe_pos, w, k, e_loc, bucket)
    y_grouped = _experts(x_grouped, w_gate, w_up, w_down)   # (E, C, D)
    y = _combine(y_grouped, safe_e, safe_pos, w, k)
    kept = valid.view(t, k).sum(dim=1).float()
    return y.to(x_flat.dtype), kept


# ------------------------------------------------------ all-to-all exchange

class _Exchange(torch.autograd.Function):
    """Bucket exchange over "model": the leading dim m is the per-peer
    split — peer j receives our block j, we receive every peer's block i
    at position i (source-major).  The backward is the reverse exchange
    (the peer-block permutation is an involution)."""

    @staticmethod
    def forward(ctx, buckets, sctx):
        ctx.sctx = sctx
        return _all_to_all(buckets, sctx)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.sctx), None


def _all_to_all(x: torch.Tensor, sctx) -> torch.Tensor:
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty_like(x)
    count_traffic("all_to_all/model", x)
    if not on_layout(x, sctx):
        dist.all_to_all_single(out, x, group=sctx.group("model"))
    return out


def _exchange(buckets: torch.Tensor, sctx=None) -> torch.Tensor:
    return _Exchange.apply(buckets, sctx or current_ctx())


def _a2a_experts(x_flat: torch.Tensor, gates: torch.Tensor,
                 idx: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, capacity: int, m: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bucketed all-to-all dispatch (inside the "model" region).

    x_flat: (T_loc, D), this rank's disjoint tokens; w_*: the E/m local
    experts.  Packs the routed pairs into per-destination-expert buckets
    (E, C, D) by the same stable-sort positions as
    :func:`_grouped_experts`, exchanges peer j's §6 range (its experts
    [j·E/m, (j+1)·E/m)), runs the local experts on the received (E/m,
    m·C, D) and reverse-exchanges the results for the gate-weighted
    combine.  Returns ``(y (T_loc, D), kept (T_loc,))``."""
    t, d = x_flat.shape
    k = idx.shape[1]
    e_loc = w_gate.shape[0]
    e = e_loc * m
    n = t * k
    flat_e = idx.reshape(n)
    flat_g = gates.reshape(n)
    pos = _expert_positions(flat_e, n)
    valid = (pos < capacity) & (flat_g > 0)
    safe_e = torch.where(valid, flat_e, 0)
    safe_pos = torch.where(valid, pos, capacity)          # row C: trash
    w = flat_g * valid
    buckets = _dispatch(x_flat, safe_e, safe_pos, w, k, e, capacity)
    recv = _exchange(buckets.reshape(m, e_loc, capacity, d))
    x_grouped = recv.movedim(0, 1).reshape(e_loc, m * capacity, d)
    y_grouped = _experts(x_grouped, w_gate, w_up, w_down)  # (E/m, m·C, D)
    back = _exchange(y_grouped.reshape(e_loc, m, capacity, d).movedim(1, 0))
    y = _combine(back.reshape(e, capacity, d), safe_e, safe_pos, w, k)
    kept = valid.view(t, k).sum(dim=1).float()
    return y.to(x_flat.dtype), kept


def moe_ffn(params: Params, x: torch.Tensor, cfg
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MoE feed-forward.  x: (B, S, D) → (y, aux): the balance ``loss``,
    the ``dropped`` and ``routed`` (token, choice) counts and
    ``a2a_bytes`` (the bytes one rank's two exchanges move a layer; 0
    without the a2a); then the shared experts' and the dense residual
    MLPs (tensor-parallel where their hidden units came split) are added
    to y.

    Routing runs on the tokens this rank holds: every token, or under
    tensor parallelism its stripe of the sequence (``tp.rows_split``),
    whose balance-loss means and drop counts then sum over "model".
    Under a mesh whose "model" axis divides E the experts run in the a2a
    or psum region (module docs): the a2a takes a stripe as its own
    split of the sequence, the psum region gathers the stripe's tokens
    (``gather_seq``) and sums its partial outputs back into the stripe
    (``scatter_seq``); elsewhere the rank's pairs take their global-view
    slots (:func:`_global_positions`) at the capacity of the whole
    batch.  y leaves in x's layout.  Expert banks may come whole or as
    this rank's shard (E/m experts, the FSDP dim cut or not)."""
    ctx = current_ctx()
    b, s, d = x.shape
    t = b * s
    k = cfg.experts_per_token
    e = cfg.num_experts
    m = ctx.model_size
    rows = tp.rows_split()
    use_region = ctx.active and m > 1 and e % m == 0 and not ctx.pure_dp
    use_a2a = (use_region and getattr(cfg, "moe_dispatch", "a2a") == "a2a"
               and (rows or ctx.resolve("sp", s) is not None))
    # a training step that split its batch: statistics sum over "dp"
    dp_sum = ctx.split_batch if ctx.active else ()
    stat_axes = dp_sum + (("model",) if rows else ())
    logits = x.reshape(t, d).float() @ tp.on_rows(params["router"])
    gates, idx = _route(logits, k)
    aux = load_balance_loss(logits, idx, e, stat_axes)
    routed = torch.full((), float(t * k), dtype=torch.float32,
                        device=x.device)
    a2a_bytes = torch.zeros((), dtype=torch.float32, device=x.device)

    if not use_region:
        w_gate, w_up, w_down = (tp.on_rows(w) for w in _gather_banks(
            params, d, e, ctx, False, ()))
        # the reference's global view: slots over the whole batch
        positions, parts = None, 1
        if stat_axes:
            positions = _global_positions(idx.view(b, s, k), e, dp_sum,
                                          rows, ctx)
            parts = int(np.prod([ctx.axis_sizes[a] for a in stat_axes]))
        y, kept = _grouped_experts(x.reshape(t, d), gates, idx, w_gate,
                                   w_up, w_down, _capacity(cfg, t * parts),
                                   positions=positions)
        y = y.view(b, s, d)
        kept_sum = kept.sum()
    else:
        # a batch whole on every rank splits over "dp" in the region too
        dp = () if ctx.split_batch else _entry_axes(ctx.resolve("dp", b))
        w_gate, w_up, w_down = _gather_banks(params, d, e, ctx, True, dp)
        xl, gl, il = x, gates.view(b, s, k), idx.view(b, s, k)
        if rows and not use_a2a:        # the psum region takes every token
            xl, gl = gather_seq(xl), gather_seq(gl)
            il = all_gather(il, 1, "model", ctx)
        dims = ((0, dp),)
        if use_a2a and not rows:
            dims += ((1, "model"),)
        for dim, axes in dims:
            if axes:
                xl, gl = split(xl, dim, axes), split(gl, dim, axes)
                il = chunk_of(il, dim, axes, ctx)
        bl, sl, _ = xl.shape
        tl = bl * sl
        if use_a2a:
            cap = _a2a_capacity(cfg, tl)
            ranges = moe_bucket_ranges(e, cap, d, x.element_size(), ctx)
            a2a_bytes = a2a_bytes + 2.0 * sum(sz for _, sz in ranges)
            yl, kept = _a2a_experts(xl.reshape(tl, d), gl.reshape(tl, k),
                                    il.reshape(tl, k), w_gate, w_up, w_down,
                                    cap, m)
        else:
            if not rows:
                # every rank's local experts see all tokens: each use is
                # part of the tokens' gradient, summed over "model"
                xl, gl = whole(xl, "model"), whole(gl, "model")
            yl, kept = _grouped_experts(
                xl.reshape(tl, d), gl.reshape(tl, k), il.reshape(tl, k),
                w_gate, w_up, w_down, _capacity(cfg, tl),
                ctx.coord("model") * (e // m))
            # each choice is kept by exactly one owning shard (or dropped)
            kept = all_reduce(kept, "model", ctx)
            yl = yl.view(bl, sl, d)
            if rows:
                yl = scatter_seq(yl)
                kept = chunk_of(kept.view(bl, sl), 1, "model", ctx)
            else:
                yl = psum(yl, "model")
        y, kept = yl.view(bl, -1, d), kept.reshape(bl, -1)
        for dim, axes in reversed(dims):
            if axes:
                y = gather(y, dim, axes)
                kept = all_gather(kept, dim, axes, ctx)
        kept_sum = kept.sum()
    if stat_axes:
        routed = all_reduce(routed.clone(), stat_axes, ctx)
        kept_sum = all_reduce(kept_sum.clone(), stat_axes, ctx)
    auxd = {"loss": aux, "dropped": routed - kept_sum, "routed": routed,
            "a2a_bytes": a2a_bytes}
    f = cfg.moe_d_ff or cfg.d_ff
    if "shared" in params:
        y = y + tp.mlp(params["shared"], x, f * cfg.num_shared_experts)
    if "dense_residual" in params:
        y = y + tp.mlp(params["dense_residual"], x, cfg.d_ff)
    return y, auxd


def _gather_banks(params: Params, d: int, e: int, ctx, region: bool, dp
                  ) -> Tuple[torch.Tensor, ...]:
    """The three expert banks as the branch computes with them: a whole
    bank (E experts) cut to this rank's E/m in the expert-parallel
    region, an FSDP-cut d_model dim gathered back (the reference's
    ``_gather_banks``), and, when the region splits a whole batch over
    ``dp``, the bank entered whole on those ranks (its gradient sums over
    them)."""
    out = []
    for name, fdim in (("w_gate", 1), ("w_up", 1), ("w_down", 2)):
        w = params[name]
        if region and w.shape[0] == e:
            w = split(w, 0, "model")
        spec = [None] * w.ndim
        if w.shape[fdim] != d:
            spec[fdim] = ctx.resolve("fsdp", d)
        if ctx.active:
            # the leaf's one gather node: a training step's gradient sums
            # over its "dp" axes here (the model's entry leaves banks be)
            w = gather_param(w, tuple(spec))
        if dp:
            w = whole(w, dp)
        out.append(w)
    return tuple(out)
