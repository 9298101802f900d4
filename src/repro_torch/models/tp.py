"""Tensor and sequence parallelism inside a layer: where a sublayer
enters and leaves its region, and which of its leaves came split.

Under a mesh whose "model" axis has m > 1 ranks (not ``pure_dp``), an
entry point hands a layer each leaf at its "model" share, as the
reference's ``_PARAM_RULES`` resolve it (``models.model.gather_params``):
``w_q`` (D, H/m, hd) where m divides the heads, else whole.  A layer
reads its mode from the shapes of its own leaves (:func:`split_dim`),
never from the family's name, so the choice is the resolved spec's.

The residual stream between sublayers holds this rank's stripe of the
sequence when :func:`rows_split` (the model sets it where S % m == 0,
the reference's ``_sp``), else every row on every rank (decode, S = 1).

* A sublayer whose leaves came split runs Megatron's region:
  :func:`enter` gives its column-parallel projections every row
  (``gather_seq`` from the stripe, ``whole`` from replicated rows), and
  :func:`leave` sums its row-parallel output into the stream's layout
  (``scatter_seq`` or ``psum``).  A leaf of the region that stayed whole
  (MLA's latents, the kv projections of a GQA layer whose kv heads do not
  divide m) sees only part of the gradient on each rank, so it goes
  through :func:`shared`.
* A sublayer whose leaves stayed whole computes on the stream's rows as
  they are: on the stripe its leaves' gradients are partial
  (:func:`on_rows`), and attention gathers k / v over the sequence
  (context-parallel; ``dist.flash``).
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (chunk_of, current_ctx, gather, gather_seq,
                                      psum, scatter_seq, split, whole)
from . import layers


def active(ctx=None) -> bool:
    """The "model" axis splits compute: a live mesh, not ``pure_dp``, m > 1."""
    ctx = ctx or current_ctx()
    return ctx.active and not ctx.pure_dp and ctx.model_size > 1


def split_dim(local: int, full: int) -> bool:
    """A leaf dim of size ``local`` whose whole size is ``full`` came as
    this rank's "model" share."""
    return local != full


def rows_split() -> bool:
    """The stream's rows are this rank's stripe of the sequence."""
    return current_ctx().seq_split


def rows_for(seq: int) -> bool:
    """Whether a stream of ``seq`` positions splits its rows over
    "model" (the reference's ``_sp``: "sp" resolves where m divides)."""
    ctx = current_ctx()
    return active(ctx) and ctx.resolve("sp", seq) is not None


def row_offset(local_rows: int) -> int:
    """Global position of this rank's first row (0 when rows are whole)."""
    return current_ctx().coord("model") * local_rows if rows_split() else 0


def local_positions(positions: torch.Tensor) -> torch.Tensor:
    """The rank's stripe of (…, S) global positions."""
    return chunk_of(positions, -1, "model", current_ctx()) if rows_split() \
        else positions


def enter(x: torch.Tensor) -> torch.Tensor:
    """The whole rows for a column-parallel projection (dim 1)."""
    if not active():
        return x
    return gather_seq(x, 1) if rows_split() else whole(x, "model")


def leave(y: torch.Tensor) -> torch.Tensor:
    """A row-parallel projection's partial output summed into the
    stream's layout."""
    if not active():
        return y
    return scatter_seq(y, 1) if rows_split() else psum(y, "model")


def shared(tree: Any) -> Any:
    """Every leaf of ``tree`` entered whole into a region in which each
    rank's use gives part of its gradient (summed over "model")."""
    if not active():
        return tree
    if isinstance(tree, dict):
        return {k: shared(v) for k, v in tree.items()}
    return whole(tree, "model")


def on_rows(tree: Any) -> Any:
    """Leaves used on the stream's rows: partial gradients on a stripe."""
    return shared(tree) if rows_split() else tree


def full_rows(x: torch.Tensor) -> torch.Tensor:
    """Every row of a tensor computed on the stream's rows, for a use
    whose gradient is partial on each rank (k / v of context-parallel
    attention)."""
    return gather_seq(x, 1) if rows_split() else x


def replicated(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` on every row, as one device computes it, handed back in the
    stream's layout: for a sublayer whose leaves stayed whole and which
    has no context-parallel form here (cross attention, MLA).  Its
    leaves' gradients are then the same on every rank."""
    if not rows_split():
        return fn(x)
    return split(fn(gather(x, 1, "model")), 1, "model")


def split_rows(x: torch.Tensor) -> torch.Tensor:
    """A replicated stream cut to this rank's stripe (its gradient is
    gathered back)."""
    return split(x, 1, "model") if rows_split() else x


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """A stream's every row for a consumer that computes them the same on
    every rank (its gradient is cut back to the stripe)."""
    return gather(x, 1, "model") if rows_split() else x


def kv_heads_read(h_local: int, h: int, kh: int) -> List[int]:
    """The kv heads this rank's q heads read when q came split and k / v
    came whole (m divides H but not KH): one head when the rank's q heads
    sit in one group (G % H/m == 0), else one per q head (the rank then
    attends MHA-style)."""
    g = h // kh
    first = current_ctx().coord("model") * h_local
    if g % h_local == 0:
        return [first // g]
    return [(first + i) // g for i in range(h_local)]


def kv_select(w: torch.Tensor, heads: List[int], dim: int) -> torch.Tensor:
    """The kv heads ``heads`` of a whole leaf (a slice for one head)."""
    if len(heads) == 1:
        return w.narrow(dim, heads[0], 1)
    return w.index_select(dim, torch.tensor(heads, device=w.device))


def vocab_shard(local: int, full: int) -> Tuple[int, int]:
    """(first global vocab index, rows) of this rank's vocab shard."""
    if not split_dim(local, full):
        return 0, full
    return current_ctx().coord("model") * local, local


def seq_stripe(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's stripe of ``dim``, padded with zeros to a multiple of
    m: a whole-head decode cache at rest (the layout of
    ``dist.flash.stripe_update_and_attend``)."""
    ctx = current_ctx()
    m, n = ctx.model_size, t.shape[dim]
    chunk = -(-n // m)
    lo = ctx.coord("model") * chunk
    part = t.narrow(dim, min(lo, n), max(0, min(chunk, n - lo)))
    if part.shape[dim] < chunk:
        pad = list(part.shape)
        pad[dim] = chunk - part.shape[dim]
        part = torch.cat([part, part.new_zeros(pad)], dim=dim)
    return part.contiguous()


# ------------------------------------------------------------ the MLPs

def mlp(p: Any, x: torch.Tensor, width: int) -> torch.Tensor:
    """The SwiGLU MLP of hidden ``width``: gate / up columns and down rows
    of the rank's hidden units when they came split, else on the rows."""
    if split_dim(p["w_gate"].shape[-1], width):
        return leave(layers.mlp(p, enter(x)))
    return layers.mlp(on_rows(p), x)


def gelu_mlp(p: Any, x: torch.Tensor, width: int) -> torch.Tensor:
    """Whisper's GELU MLP, as :func:`mlp`; ``b_out`` follows the row-
    parallel ``w_out``, so it is added once, after the sum."""
    if not split_dim(p["w_in"].shape[-1], width):
        return layers.gelu_mlp(on_rows(p), x)
    xf = enter(x)
    h = F.gelu((xf @ p["w_in"] + p["b_in"]).float(),
               approximate="tanh").to(xf.dtype)
    return leave(h @ p["w_out"]) + on_rows(p["b_out"])
