"""Mesh sharding as paper-§6 data-block partitioning (torch port of
``repro.dist.sharding``).

Two halves.

*Layout* (no process group).  :class:`MeshLayout` is a mesh described by
its axis names and sizes, ranks in row-major order (the order the
reference's ``mesh.devices.flat`` visits devices).  On it (or on a live
``DeviceMesh``) :class:`ShardCtx` translates *logical* axis names ("dp",
"tp", "fsdp", "sp", "ep", "vocab", "kv_seq") into physical mesh axes,
dropping any axis whose size does not divide the dimension;
:func:`_resolve_with_priority` maps a parameter's key path to a spec by
suffix rules (the longest matching suffix wins); :func:`param_shardings`
applies them to a tree; :func:`device_ranges_of`,
:func:`partition_tree_of` and :func:`moe_bucket_ranges` lower a sharding
to the disjoint ``(offset, size)`` byte ranges of §6 that ``db_partition``
accepts.  A spec is a tuple with one entry per tensor dim — None, an axis
name, or a tuple of names — compared entry by entry with the reference's
``PartitionSpec``; :meth:`NamedSharding.placements` derives the
``torch.distributed.tensor`` placements from it (a dim sharded over
("pod", "data") is ``Shard(d)`` on both mesh dims, in that order).

*Live* (an initialized process group).  :func:`use_mesh` installs a
``ShardCtx`` over a ``torch.distributed.device_mesh.DeviceMesh`` with the
same dim names.

*A layout rank* (the dry run, ``launch.dryrun``).  ``use_mesh(layout,
rank=r)`` installs a ``ShardCtx`` that stands for rank ``r`` of a
``MeshLayout``: its coordinates come from :func:`rank_coords`, and the
collectives take meta tensors only — they hand back what the live call
would (the same allocations, of the same shapes) and count :data:`TRAFFIC`
as a live rank does, with no process group and no data.  A CPU or CUDA
tensor on a layout raises, and so does a meta tensor on a live mesh.

The port runs a mesh as SPMD over plain local tensors.  Every rank runs
the same program: parameters and moments are stored as the local shards
``param_shardings`` gives (:func:`shard_tree`).  An entry point gathers
each leaf over its FSDP ("pod", "data") entries only
(``models.model.gather_params`` through :func:`gather_param`, in the
compute dtype where the reference's ``cast_params`` casts) and keeps its
"model" entry local, so a rank computes what the reference's GSPMD gives
one device: the q / k / v, gate / up, ``w_in`` and MLA up-projection
columns of its own heads and hidden units, the rows of ``w_o`` /
``w_down`` / ``w_out`` that go with them, and its vocab shard of the
embedding and the logits; the residual stream between sublayers holds
the rank's stripe of the sequence (``ShardCtx.seq_split``, where the
reference's ``("dp", "sp", None)`` constraint resolves).  A dim that
does not divide its axis stays whole, and a layer whose leaf came whole
computes with it whole (``models.tp``).  No tensor is a ``DTensor``: the
collectives are explicit autograd functions over the mesh dim's group,
Megatron's pair for a tensor-parallel region and its sequence-parallel
pair:

  ==============  ====================  ======================
  region call     forward               backward
  ==============  ====================  ======================
  :func:`whole`   identity              all-reduce
  :func:`psum`    all-reduce            identity
  gather_seq      all-gather            reduce-scatter
  scatter_seq     reduce-scatter        all-gather
  :func:`split`   this rank's chunk     all-gather
  :func:`gather`  all-gather            this rank's chunk
  ==============  ====================  ======================

``whole`` / ``gather_seq`` enter a region whose ranks each contribute
part of the input's gradient (a column-parallel projection), ``psum`` /
``scatter_seq`` leave it with the partial outputs summed; ``split`` /
``gather`` cut and rebuild a tensor whose gradient is the same on every
rank (the reference's ``shard_map`` regions in ``dist.flash`` and
``models.moe``).  A parameter gathered for a training step hands its
shard the gradient summed over "dp": reduce-scattered over the "dp" axes
its FSDP dims are sharded over, all-reduced over the rest; a leaf kept
at its "model" share already has the whole gradient of its columns, so
nothing sums it over "model".  :data:`TRAFFIC` counts the calls and the
bytes each collective kind hands the backend on this rank.

Logical → physical axis mapping:

  ==========  =====================================================
  logical     physical
  ==========  =====================================================
  dp          ("pod", "data") — every axis in ``pure_dp`` mode
  fsdp        ("pod", "data") — disabled in ``pure_dp`` mode
  tp / model  ("model",)      — tensor / head parallel
  ep          ("model",)      — expert banks (MoE)
  sp          ("model",)      — sequence dim of activations
  kv_seq      ("model",)      — sequence dim of decode caches
  vocab       ("model",)      — vocab dim of logits
  ==========  =====================================================
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]


# ------------------------------------------------------------------ meshes

class MeshLayout:
    """A mesh as axis names and sizes, with no process behind it: rank
    ``i`` sits at the row-major position ``i`` of ``devices``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.devices = np.arange(int(np.prod(shape))).reshape(shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"MeshLayout({self.shape})"


def mesh_names(mesh) -> Tuple[str, ...]:
    """Axis names of a :class:`MeshLayout` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshLayout):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_ranks(mesh) -> np.ndarray:
    """The mesh's ranks as an array of its shape, row-major."""
    if isinstance(mesh, MeshLayout):
        return mesh.devices
    return mesh.mesh.cpu().numpy()


def rank_coords(mesh, rank: int) -> Dict[str, int]:
    """{axis name: coordinate} of ``rank`` on the mesh."""
    where = np.argwhere(mesh_ranks(mesh) == rank)
    if not len(where):
        raise ValueError(f"rank {rank} is not on the mesh")
    return dict(zip(mesh_names(mesh), (int(c) for c in where[0])))


# --------------------------------------------------------------------- context

@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Ambient sharding context: a mesh plus the logical-axis dictionary.
    ``split_batch`` names the "dp" axes a training entry point has split
    its batch over while it computes its own rows (its parameter
    gradients and loss statistics then sum over them); ``seq_split`` says
    that the residual stream a layer receives holds this rank's stripe
    of the sequence over "model" (``models.tp``).  On a ``MeshLayout``
    ``rank`` is the rank the context stands for (None: no rank, and
    :meth:`coord` raises)."""

    mesh: Any = None
    pure_dp: bool = False
    split_batch: Tuple[str, ...] = ()
    seq_split: bool = False
    rank: Optional[int] = None

    @property
    def active(self) -> bool:
        return self.mesh is not None and mesh_ranks(self.mesh).size > 1

    @property
    def axis_sizes(self) -> Dict[str, int]:
        if self.mesh is None:
            return {}
        return dict(zip(mesh_names(self.mesh), mesh_ranks(self.mesh).shape))

    @property
    def model_size(self) -> int:
        return self.axis_sizes.get("model", 1) if self.active else 1

    # -- logical axes ------------------------------------------------------

    def _physical(self, logical: str) -> Tuple[str, ...]:
        """Mesh axes backing one logical name (existing axes only)."""
        sizes = self.axis_sizes
        if logical == "dp":
            if self.pure_dp:
                return tuple(mesh_names(self.mesh))
            return tuple(a for a in ("pod", "data") if a in sizes)
        if logical == "fsdp":
            if self.pure_dp:
                return ()
            return tuple(a for a in ("pod", "data") if a in sizes)
        if logical in ("tp", "model", "ep", "sp", "kv_seq", "vocab"):
            if self.pure_dp:
                return ()
            return tuple(a for a in ("model",) if a in sizes)
        raise KeyError(f"unknown logical axis {logical!r}")

    def resolve(self, logical: Optional[str], dim: int) -> Axes:
        """Physical axes for ``logical`` on a dimension of size ``dim``:
        one axis name, a tuple of names, or None when the logical axis is
        unmapped or no prefix of its axes divides ``dim`` (e.g. batch 4 on
        pod × data = 8 takes "pod" alone)."""
        if logical is None or not self.active:
            return None
        axes = self._physical(logical)
        if not axes:
            return None
        sizes = self.axis_sizes
        total = int(np.prod([sizes[a] for a in axes]))
        if total <= 1 or dim % total != 0:
            for cut in range(len(axes) - 1, 0, -1):
                t = int(np.prod([sizes[a] for a in axes[:cut]]))
                if t > 1 and dim % t == 0:
                    axes = axes[:cut]
                    break
            else:
                return None
        return axes[0] if len(axes) == 1 else tuple(axes)

    def spec(self, shape: Sequence[int], *logical: Optional[str]) -> Spec:
        """The spec of ``shape`` with one logical name per dim."""
        assert len(logical) == len(shape), (tuple(shape), logical)
        return tuple(self.resolve(l, d) for l, d in zip(logical, shape))

    # -- live mesh ---------------------------------------------------------

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 off the mesh)."""
        if not self.active or axis not in self.axis_sizes:
            return 0
        if isinstance(self.mesh, MeshLayout):
            if self.rank is None:
                raise RuntimeError("a MeshLayout has no live ranks: use_mesh "
                                   "takes a DeviceMesh for a live run, or "
                                   "rank= for the rank a layout pass stands "
                                   "for")
            return rank_coords(self.mesh, self.rank)[axis]
        return int(self.mesh.get_local_rank(axis))

    def group(self, axis: str):
        return self.mesh.get_group(axis)


_NULL_CTX = ShardCtx()
_CTX_STACK: List[ShardCtx] = []


def current_ctx() -> ShardCtx:
    """The innermost :func:`use_mesh` context (inactive ctx outside any)."""
    return _CTX_STACK[-1] if _CTX_STACK else _NULL_CTX


def use_mesh(mesh, pure_dp: bool = False, rank: Optional[int] = None):
    """Install ``mesh`` (a ``DeviceMesh``; None for single-device
    semantics; a ``MeshLayout`` with the ``rank`` a layout pass stands
    for) as the ambient sharding context.  In ``pure_dp`` mode the batch
    shards over every mesh axis and weights stay replicated."""
    if rank is not None and not isinstance(mesh, MeshLayout):
        raise ValueError("rank= names a rank of a MeshLayout; a live mesh "
                         "knows its own")
    return installed(ShardCtx(mesh=mesh, pure_dp=pure_dp, rank=rank))


@contextlib.contextmanager
def installed(ctx: ShardCtx):
    """Install ``ctx`` as it is (also a recomputation re-entering the
    context its forward ran under)."""
    _CTX_STACK.append(ctx)
    try:
        yield ctx
    finally:
        _CTX_STACK.pop()


def seq_sharded(on: bool):
    """The ambient context with the residual stream's rows split over
    "model" (``on``) or whole on every rank."""
    return installed(dataclasses.replace(current_ctx(), seq_split=bool(on)))


def batch_split(axes: Tuple[str, ...]):
    """The ambient context with its batch split over ``axes`` (a training
    entry point computes its own rows): parameters gathered inside sum
    their gradients over them."""
    return installed(dataclasses.replace(current_ctx(),
                                         split_batch=tuple(axes)))


# ------------------------------------------------------------- shardings

def _entry_axes(entry: Axes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: Spec

    def sharded_axes(self) -> Tuple[str, ...]:
        return tuple(a for e in self.spec for a in _entry_axes(e))

    def placements(self):
        """``torch.distributed.tensor`` placements, one per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in mesh_names(self.mesh):
            dims = [d for d, e in enumerate(self.spec)
                    if name in _entry_axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def index_of(self, shape: Sequence[int], rank: int
                 ) -> Tuple[slice, ...]:
        """The slice of a ``shape`` tensor that ``rank`` holds."""
        coords = rank_coords(self.mesh, rank)
        sizes = dict(zip(mesh_names(self.mesh), mesh_ranks(self.mesh).shape))
        out = []
        for d, entry in enumerate(self.spec):
            axes = _entry_axes(entry)
            if not axes:
                out.append(slice(None))
                continue
            n, c = 1, 0
            for a in axes:                 # the first axis is the major one
                c = c * sizes[a] + coords[a]
                n *= sizes[a]
            step = int(shape[d]) // n
            out.append(slice(c * step, (c + 1) * step))
        return tuple(out)

    def devices_indices_map(self, shape: Sequence[int]
                            ) -> Dict[int, Tuple[slice, ...]]:
        return {int(r): self.index_of(shape, int(r))
                for r in mesh_ranks(self.mesh).flat}


# ------------------------------------------------------- param sharding rules

# (key-path suffix) -> logical axes for the *trailing* dims.  Leading stack
# dims (layer stacking) are padded with None.  The longest matching suffix
# wins (`_resolve_with_priority`).
_PARAM_RULES: Tuple[Tuple[Tuple[str, ...], Tuple[Optional[str], ...]], ...] = (
    # MoE expert banks: expert dim is the §6 partition axis (EP); the
    # d_model/d_ff dim re-gathers per layer (FSDP)
    (("moe", "w_gate"), ("ep", "fsdp", None)),
    (("moe", "w_up"), ("ep", "fsdp", None)),
    (("moe", "w_down"), ("ep", None, "fsdp")),
    (("moe", "router"), (None, None)),          # fp32, tiny: replicated
    # attention projections: heads over TP, d_model over FSDP
    (("w_q",), ("fsdp", "tp", None)),
    (("w_k",), ("fsdp", "tp", None)),
    (("w_v",), ("fsdp", "tp", None)),
    (("w_o",), ("tp", None, "fsdp")),
    (("b_q",), ("tp", None)),
    (("b_k",), ("tp", None)),
    (("b_v",), ("tp", None)),
    # MLA low-rank factors
    (("w_dq",), ("fsdp", None)),
    (("w_dkv",), ("fsdp", None)),
    (("w_uq",), (None, "tp", None)),
    (("w_uk",), (None, "tp", None)),
    (("w_uv",), (None, "tp", None)),
    # dense MLPs (SwiGLU + GELU): hidden over TP, d_model over FSDP
    (("w_gate",), ("fsdp", "tp")),
    (("w_up",), ("fsdp", "tp")),
    (("w_down",), ("tp", "fsdp")),
    (("w_in",), ("fsdp", "tp")),
    (("w_out",), ("tp", "fsdp")),
    (("b_in",), ("tp",)),
    # mamba projections: d_inner / heads are TP-aligned, B/C/dt head-shared
    (("w_z",), ("fsdp", "tp")),
    (("w_x",), ("fsdp", "tp")),
    (("out_proj",), ("tp", "fsdp")),
    (("conv_x",), (None, "tp")),
    (("conv_b_x",), ("tp",)),
    # embeddings / unembedding: vocab over TP (vocab-parallel CE loss)
    (("embedding",), ("tp", "fsdp")),
    (("lm_head",), ("fsdp", "tp")),
)


def _resolve_with_priority(keys: Tuple[str, ...], shape: Tuple[int, ...],
                           ctx: ShardCtx) -> Spec:
    """The spec of one param leaf by key-path suffix priority: the longest
    rule suffix matching the end of ``keys`` applies its logical axes to
    the trailing dims (leading stack dims replicate); unmatched leaves
    replicate.  Every axis is divisibility-checked."""
    best: Optional[Tuple[Optional[str], ...]] = None
    best_len = 0
    for suffix, logical in _PARAM_RULES:
        if len(suffix) > best_len and len(suffix) <= len(keys) \
                and tuple(keys[-len(suffix):]) == suffix:
            best, best_len = logical, len(suffix)
    if best is None or len(best) > len(shape):
        return (None,) * len(shape)
    pad = len(shape) - len(best)
    return ctx.spec(shape, *((None,) * pad + best))


def _map_with_path(fn, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(shapes: Any, ctx: ShardCtx) -> Any:
    """:class:`NamedSharding` tree for a params(-like) tree of anything
    with a ``.shape`` (tensors on any device, ``meta`` included)."""
    if ctx.mesh is None:
        raise ValueError("param_shardings requires a ShardCtx with a mesh")
    return _map_with_path(
        lambda path, leaf: NamedSharding(ctx.mesh, _resolve_with_priority(
            path, tuple(leaf.shape), ctx)), shapes)


def state_shardings_of(state: Any, ctx: ShardCtx) -> Any:
    """Shardings of a train state ``{"params", "opt": {"m", "v",
    "step"}}`` (leaves with a ``.shape``): the parameters and fp32 moments
    by :func:`param_shardings`; an int8 moment's ``q`` as its parameter
    and its row ``scale`` as the parameter without its last axis (the
    update then runs on local shards; the reference's suffix rules leave
    these two leaves replicated); the step replicated."""
    params = param_shardings(state["params"], ctx)

    def moments(tree, sh):
        if isinstance(sh, NamedSharding):
            if not isinstance(tree, dict):
                return sh
            return {"q": sh, "scale": NamedSharding(ctx.mesh,
                                                    sh.spec[:-1] + (None,))}
        return {k: moments(tree[k], sh[k]) for k in tree}

    opt = state["opt"]
    return {"params": params,
            "opt": {"m": moments(opt["m"], params),
                    "v": moments(opt["v"], params),
                    "step": NamedSharding(ctx.mesh, ())}}


# ----------------------------------------------------- §6 partition lowering

def device_ranges_of(shape: Tuple[int, ...], itemsize: int,
                     sharding: NamedSharding
                     ) -> List[Tuple[int, List[Tuple[int, int]]]]:
    """Per-rank §6 byte ranges of one row-major buffer under a sharding:
    one range per contiguous run of the rank's shard, in the shard's own
    row-major order; ranks in mesh order, replicated ranks repeating
    ranges (the reference's ``device_ranges_of``)."""
    shape = tuple(int(d) for d in shape)
    ranks = [int(r) for r in mesh_ranks(sharding.mesh).flat]
    if not shape:
        return [(ranks[0], [(0, itemsize)])]
    nelems = int(np.prod(shape))
    total = nelems * itemsize
    if nelems == 0:
        return []
    strides = [itemsize] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]

    out: List[Tuple[int, List[Tuple[int, int]]]] = []
    indices_map = sharding.devices_indices_map(shape)
    for rank in ranks:
        idx = indices_map[rank]
        starts, lens = [], []
        for d, sl in enumerate(idx):
            start = 0 if sl.start is None else int(sl.start)
            stop = shape[d] if sl.stop is None else int(sl.stop)
            starts.append(start)
            lens.append(stop - start)
        k = len(shape)
        while k > 0 and lens[k - 1] == shape[k - 1]:
            k -= 1
        if k == 0:
            out.append((rank, [(0, total)]))
            continue
        run = lens[k - 1] * strides[k - 1]
        base = starts[k - 1] * strides[k - 1]
        outer = [range(s, s + l) for s, l in zip(starts[:k - 1], lens[:k - 1])]
        ranges = []
        for combo in itertools.product(*outer):
            off = base + sum(c * strides[d] for d, c in enumerate(combo))
            ranges.append((off, run))
        out.append((rank, ranges))
    return out


def partition_tree_of(shape: Tuple[int, ...], itemsize: int,
                      sharding: NamedSharding) -> List[Tuple[int, int]]:
    """The §6 ``(offset, size)`` ranges of every rank, in rank order:
    deduplicated, they are disjoint and tile the buffer — what
    ``db_partition`` (§6.2) accepts."""
    return [r for _rank, ranges in device_ranges_of(shape, itemsize, sharding)
            for r in ranges]


def moe_bucket_ranges(num_experts: int, capacity: int, width: int,
                      itemsize: int, ctx: ShardCtx) -> List[Tuple[int, int]]:
    """§6 destination ranges of one shard's ``(E, C, width)`` a2a bucket:
    destination shard j takes the contiguous range of its experts
    [j·E/m, (j+1)·E/m).  Distinct ranges in offset order; without an
    expert-parallel axis the whole block is one range."""
    total = num_experts * capacity * width * itemsize
    ep = ctx.resolve("ep", num_experts) if ctx.mesh is not None else None
    if ep is None:
        return [(0, total)]
    sharding = NamedSharding(ctx.mesh, (ep, None, None))
    return sorted(set(partition_tree_of((num_experts, capacity, width),
                                        itemsize, sharding)))


# ------------------------------------------------------ placing on the mesh

def shard_of(full: torch.Tensor, sharding: NamedSharding,
             rank: int) -> torch.Tensor:
    """``rank``'s shard of ``full``: a contiguous copy in storage of its
    own (a slice of leading rows is already contiguous, and as a view it
    would keep the whole leaf's storage alive)."""
    return full[sharding.index_of(full.shape, rank)].clone(
        memory_format=torch.contiguous_format)


def shard_tree(tree: Any, shardings: Any, rank: int) -> Any:
    """Every leaf of ``tree`` cut to ``rank``'s shard.  Each leaf leaves
    ``tree`` (a dict, emptied) once its shard is made, so a whole state
    is never held beside its shards."""
    if not isinstance(tree, dict):
        return shard_of(tree, shardings, rank)
    out = {}
    for k in list(tree):
        out[k] = shard_tree(tree[k], shardings[k], rank)
        del tree[k]
    return out


# -------------------------------------------------------- collectives

# {"kind/axis": [calls, bytes, largest call's bytes]} this rank handed
# the backend: the input tensor's bytes of each all_reduce, all_gather,
# reduce_scatter and all_to_all, and apart from them the all-gathers of
# a parameter's shard ("param_gather", :func:`gather_param`)
TRAFFIC: Dict[str, List[int]] = {}


def count_traffic(kind: str, x: torch.Tensor) -> None:
    entry = TRAFFIC.setdefault(kind, [0, 0, 0])
    n = x.numel() * x.element_size()
    entry[0] += 1
    entry[1] += n
    entry[2] = max(entry[2], n)


def reset_traffic() -> None:
    TRAFFIC.clear()


def on_layout(x: torch.Tensor, ctx: ShardCtx) -> bool:
    """Whether a collective on ``x`` is a layout rank's (a meta tensor on
    a ``MeshLayout``: no backend call) rather than a live one.  A meta
    tensor on a live mesh, or a real one on a layout, raises."""
    layout = isinstance(ctx.mesh, MeshLayout)
    if (x.device.type == "meta") != layout:
        raise RuntimeError(
            f"a {x.device.type} tensor on a "
            f"{'MeshLayout' if layout else 'live mesh'}: a layout rank "
            f"takes meta tensors only, a live rank real ones")
    return layout


def all_reduce(x: torch.Tensor, axes, ctx: ShardCtx, op: str = "sum"
               ) -> torch.Tensor:
    """In place over every axis of ``axes`` (a name or a tuple); returns
    ``x``.  A backend that refuses the tensor raises."""
    import torch.distributed as dist
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    for a in _entry_axes(axes):
        if ctx.axis_sizes.get(a, 1) > 1:
            count_traffic("all_reduce/" + a, x)
            if not on_layout(x, ctx):
                dist.all_reduce(x, op=red, group=ctx.group(a))
    return x


def all_gather(x: torch.Tensor, dim: int, axes, ctx: ShardCtx,
               kind: str = "all_gather") -> torch.Tensor:
    """Concatenate the shards of every rank of ``axes`` along ``dim``
    (the first axis major, as a spec entry orders them); ``kind`` names
    the call in :data:`TRAFFIC`."""
    import torch.distributed as dist
    for a in reversed(_entry_axes(axes)):
        n = ctx.axis_sizes.get(a, 1)
        if n <= 1:
            continue
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        count_traffic(f"{kind}/{a}", x)
        if not on_layout(x, ctx):
            dist.all_gather(parts, x, group=ctx.group(a))
        x = torch.cat(parts, dim=dim)
    return x


def reduce_scatter(x: torch.Tensor, dim: int, axis: str, ctx: ShardCtx
                   ) -> torch.Tensor:
    """Sum ``x`` over the ranks of ``axis`` and keep this rank's chunk
    along ``dim`` (``dim`` must divide)."""
    import torch.distributed as dist
    n = ctx.axis_sizes.get(axis, 1)
    if n <= 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // n, *front.shape[1:]))
    count_traffic("reduce_scatter/" + axis, front)
    if not on_layout(front, ctx):
        dist.reduce_scatter_tensor(out, front, group=ctx.group(axis))
    return out.movedim(0, dim)


def chunk_of(x: torch.Tensor, dim: int, axes, ctx: ShardCtx) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` over ``axes`` (a view)."""
    n, c = 1, 0
    for a in _entry_axes(axes):
        size = ctx.axis_sizes.get(a, 1)
        c = c * size + ctx.coord(a)
        n *= size
    step = x.shape[dim] // n
    return x.narrow(dim, c * step, step)


# ------------------------------------------------------------ regions

class _Split(torch.autograd.Function):
    """Enter a region with this rank's chunk of a replicated tensor;
    the backward gathers every rank's chunk gradient."""

    @staticmethod
    def forward(ctx, x, dim, axes, sctx):
        ctx.dim, ctx.axes, ctx.sctx = dim, axes, sctx
        return chunk_of(x, dim, axes, sctx).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.axes, ctx.sctx), None, None, None


class _Whole(torch.autograd.Function):
    """Enter a region with the whole of a replicated tensor: each rank's
    use contributes part of its gradient, so the backward sums them."""

    @staticmethod
    def forward(ctx, x, axes, sctx):
        ctx.axes, ctx.sctx = axes, sctx
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.axes, ctx.sctx), None, None


class _Gather(torch.autograd.Function):
    """Leave a region by concatenating every rank's chunk; the backward
    keeps this rank's chunk of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, dim, axes, sctx):
        ctx.dim, ctx.axes, ctx.sctx = dim, axes, sctx
        return all_gather(x, dim, axes, sctx)

    @staticmethod
    def backward(ctx, g):
        return (chunk_of(g, ctx.dim, ctx.axes, ctx.sctx).contiguous(),
                None, None, None)


class _Psum(torch.autograd.Function):
    """Leave a region by summing every rank's partial result; the
    (replicated) gradient passes through to each partial."""

    @staticmethod
    def forward(ctx, x, axes, sctx):
        return all_reduce(x.clone(), axes, sctx)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherSeq(torch.autograd.Function):
    """Enter a column-parallel region from the sequence-sharded stream:
    every rank's rows, concatenated; each rank's gradient is a partial
    sum, so the backward reduce-scatters it."""

    @staticmethod
    def forward(ctx, x, dim, sctx):
        ctx.dim, ctx.sctx = dim, sctx
        return all_gather(x, dim, "model", sctx)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, "model", ctx.sctx), None, None


class _ScatterSeq(torch.autograd.Function):
    """Leave a row-parallel region into the sequence-sharded stream: the
    partial outputs summed, this rank's rows kept; the backward gathers
    every rank's rows of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, sctx):
        ctx.dim, ctx.sctx = dim, sctx
        return reduce_scatter(x, dim, "model", sctx)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, "model", ctx.sctx), None, None


def gather_seq(x: torch.Tensor, dim: int = 1,
               ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    return _GatherSeq.apply(x, dim, ctx or current_ctx())


def scatter_seq(x: torch.Tensor, dim: int = 1,
                ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    return _ScatterSeq.apply(x, dim, ctx or current_ctx())


def split(x: torch.Tensor, dim: int, axes="model",
          ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    return _Split.apply(x, dim, axes, ctx or current_ctx())


def whole(x: torch.Tensor, axes="model",
          ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    return _Whole.apply(x, axes, ctx or current_ctx())


def gather(x: torch.Tensor, dim: int, axes="model",
           ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    return _Gather.apply(x, dim, axes, ctx or current_ctx())


def psum(x: torch.Tensor, axes="model",
         ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    return _Psum.apply(x, axes, ctx or current_ctx())


# ------------------------------------------------------- parameter gather

class _GatherParam(torch.autograd.Function):
    """A parameter's local shard → the whole leaf (or the part the caller
    keeps local): an all-gather over each sharded dim.  The backward
    hands the shard its gradient summed over "dp" when the batch was
    split: a dim sharded over "dp" axes (FSDP) reduce-scatters over them,
    the outer axis first, as :func:`chunk_of` orders the chunks; only
    the "dp" axes that no dim covers (a leaf left whole, ``pure_dp``)
    all-reduce, and any other axis of the spec is cut."""

    @staticmethod
    def forward(ctx, x, spec, sctx):
        ctx.spec, ctx.sctx = spec, sctx
        ctx.dp = sctx.split_batch
        for d, entry in enumerate(spec):
            if entry is not None:
                x = all_gather(x, d, entry, sctx, kind="param_gather")
        return x

    @staticmethod
    def backward(ctx, g):
        summed = set()
        for d, entry in enumerate(ctx.spec):
            for a in _entry_axes(entry):
                if a in ctx.dp:
                    g = reduce_scatter(g, d, a, ctx.sctx)
                    summed.add(a)
                else:
                    g = chunk_of(g, d, a, ctx.sctx)
        rest = tuple(a for a in ctx.dp if a not in summed)
        g = all_reduce(g.clone(), rest, ctx.sctx) if rest else g
        return g.contiguous(), None, None


def gather_param(x: torch.Tensor, spec: Spec,
                 ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """The leaf gathered over every entry of ``spec`` that is not None (a
    no-op spec returns ``x`` through an autograd node all the same, so
    its gradient still sums over "dp")."""
    return _GatherParam.apply(x, tuple(spec), ctx or current_ctx())


def full_tensor(x: torch.Tensor, spec: Spec,
                ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """The whole leaf from its local shard, outside autograd."""
    ctx = ctx or current_ctx()
    with torch.no_grad():
        for d, entry in enumerate(spec):
            if entry is not None:
                x = all_gather(x, d, entry, ctx)
    return x
