"""Chunked + §6-sharded checkpointing on the paper's §5 file-mapped blocks.

The torch port of ``repro.ckpt.checkpoint``.  The manifest format is the
reference's, so a checkpoint written by either package restores into the
other.

Layout of a checkpoint at ``<dir>/step_<N>/``:
  leaf_<i>.bin     one file per pytree leaf, row-major
  manifest.json    tree paths, shapes, dtypes, chunk/range tables, hashes

Two write paths share one manifest format:

* **Chunked (host leaves)** — with no ``shardings``, every leaf is a host
  (numpy) array (``repro_torch.convert.state_to_numpy`` makes them from a
  train state), written as fixed-size disjoint chunks by parallel writer
  EDTs acquiring their chunk data blocks in EW mode; non-overlap is
  *enforced by the runtime* (§5 ``ocrFileGetChunk``), so a buggy writer
  cannot corrupt a neighbour.
* **Sharded (§6 ranges)** — with ``shardings`` (a tree of
  :class:`~repro_torch.dist.sharding.NamedSharding` over the mesh of the
  initialized process group), every leaf is this rank's local shard and
  every rank calls ``save``.  :func:`~repro_torch.dist.sharding.device_ranges_of`
  gives every rank the whole ``(node, offset, size)`` table: a range is
  owned by the first rank in mesh order that holds it (replicas skip),
  and its node is that rank's mesh position modulo ``num_writers``, as in
  the reference.  A rank writes only the ranges it owns, from its own
  shard (one copy of the local tensor to the host; its ranges are
  consecutive run-sized pieces of it): no rank gathers a leaf
  (``CkptStats.host_gathers`` stays 0).

How the ranks of a sharded save coordinate (each runs its own save
``Runtime``; the reference is one process that addresses every shard):

1. Every rank plans every leaf and hashes its own ranges; one
   ``all_gather_object`` of those hashes and of a per-leaf "clean" flag
   (its ranges unchanged since the previous manifest) gives every rank
   the manifest and the AND of the flags.
2. Rank 0 makes ``step_N.tmp``, creates each leaf file at its full size
   (or copies a leaf that every rank found clean), then a barrier.  Only
   after it do the ranks open the files, ``"rb+"`` (``"wb+"`` truncates:
   a second one would wipe another rank's ranges).
3. Each rank's openers map its contiguous spans as file chunks,
   ``db_partition`` each span into its ranges and hang one EW writer EDT
   off every partition; adjacent ranges coalesce at write-back.
4. One more ``all_gather_object`` of each rank's counters and of whether
   its runtime halted (``crash_at``): if any rank halted, nobody commits.
   Else rank 0 writes the manifest and renames the directory (the commit
   point), and a last barrier keeps every rank from returning before it.
   Every rank returns the same :class:`CkptStats` (counts summed over the
   ranks, ``makespan`` their maximum).

Shared properties:
* **Dirty-only** — when the previous checkpoint's manifest is supplied,
  chunks/ranges whose content hash is unchanged are skipped (§5: the
  runtime only writes back chunks that were actually modified).  A
  missing/corrupt previous manifest only disables the skip (warning, on
  every rank), it never poisons the save.
* **Committed** — ``manifest.json`` is written last via atomic rename; a
  crash mid-save (``crash_at``, fail-stop, or a real crash) leaves the
  previous checkpoint intact (``latest_step`` only counts manifests and
  ``step_*.tmp`` directories are ignored).
* **Elastic / reshard-on-restore** — ``restore`` reassembles whole leaves
  from the range tables regardless of writer count or mesh shape; with
  ``shardings=`` each rank instead reads only the byte ranges of its own
  shard under the target sharding, whatever mesh wrote the checkpoint.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import DbMode, NULL_GUID, Runtime, spawn_main
from repro_torch.monitoring import Registry

# legacy CkptStats field → its ckpt.* monitoring-registry slot and zero
_CKPT_FIELDS: Tuple[Tuple[str, str, Any], ...] = (
    ("chunks_total", "ckpt.chunks_total", 0),
    ("chunks_written", "ckpt.chunks_written", 0),
    ("chunks_skipped", "ckpt.chunks_skipped", 0),
    ("bytes_written", "ckpt.bytes_written", 0),
    # host-side full-leaf gathers of device-sharded leaves (the sharded
    # §6 path never performs one; the tests assert 0)
    ("host_gathers", "ckpt.host_gathers", 0),
    # False when the save was halted (crash_at) before the manifest commit
    ("committed", "ckpt.committed", True),
    # §5 IO-queue counters of the save's runtime (virtual time)
    ("io_write_ops", "ckpt.io_write_ops", 0),
    ("io_coalesced_writes", "ckpt.io_coalesced_writes", 0),
    ("makespan", "ckpt.makespan", 0.0),
)


class CkptStats:
    """Field-compatible view over the ``ckpt.*`` registry namespace.

    Same refactor as ``core.runtime.Stats``: the former dataclass fields
    are properties onto dotted monitoring-registry slots.  ``save``
    binds the instance to the save-runtime's registry, so one mid-run
    ``Registry.snapshot()`` shows the checkpoint gauges next to the same
    run's ``io.*`` counters; standalone construction keeps a private
    registry (old dataclass behaviour).
    """

    __slots__ = ("registry",)

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = Registry() if registry is None else registry
        declare = self.registry.declare
        for _field, name, default in _CKPT_FIELDS:
            declare(name, default)

    def snapshot(self) -> Dict[str, Any]:
        vals = self.registry._values
        return {field: vals[name] for field, name, _default in _CKPT_FIELDS}

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v!r}" for k, v in self.snapshot().items())
        return f"CkptStats({body})"


def _ckpt_property(name: str) -> property:
    def _get(self: CkptStats) -> Any:
        return self.registry._values[name]

    def _set(self: CkptStats, value: Any) -> None:
        self.registry._values[name] = value

    return property(_get, _set)


for _field, _name, _default in _CKPT_FIELDS:
    setattr(CkptStats, _field, _ckpt_property(_name))
del _field, _name, _default


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """Leaves in sorted key-path order — *without* materializing them."""
    out: List[Tuple[str, Any]] = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    else:
        out.append((prefix, tree))
    return out


def _unflatten(items: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for path, val in items.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val
    return root


def _chunk_table(nbytes: int, chunk_bytes: int) -> List[Tuple[int, int]]:
    out = []
    off = 0
    while off < nbytes:
        size = min(chunk_bytes, nbytes - off)
        out.append((off, size))
        off += size
    return out or [(0, 0)]


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _load_prev_manifest(ckpt_dir: str) -> Tuple[Optional[str], Dict[str, Any]]:
    """Previous manifest for dirty-range skipping — fail-soft.

    A crashed or corrupt previous save (missing/garbled ``manifest.json``)
    must not poison later saves: dirty tracking is skipped with a warning
    and the save proceeds as a full write.
    """
    prev = latest_step(ckpt_dir)
    if prev is None:
        return None, {}
    prev_dir = os.path.join(ckpt_dir, f"step_{prev}")
    try:
        with open(os.path.join(prev_dir, "manifest.json")) as f:
            pm = json.load(f)
        prev_leaves = {l["path"]: l for l in pm["leaves"]}
    except (OSError, ValueError, KeyError, TypeError) as e:
        warnings.warn(
            f"checkpoint: previous manifest at {prev_dir} is unreadable "
            f"({type(e).__name__}: {e}); dirty-range skipping disabled "
            f"for this save")
        return None, {}
    return prev_dir, prev_leaves


# ---------------------------------------------------------- write plans

@dataclasses.dataclass
class _RangePlan:
    """Write plan for one leaf: disjoint ranges, each owned by one node."""

    table: List[Tuple[int, int, int]]        # (node, offset, size)
    payloads: Dict[int, Any]                 # offset -> bytes to write


def _plan_chunked(arr: np.ndarray, chunk_bytes: int,
                  num_writers: int) -> _RangePlan:
    """Fixed-size chunk plan for a host leaf.

    Chunks are assigned to writer nodes in contiguous blocks (not
    round-robin) so each node's dirty ranges are adjacent and its
    write-backs coalesce into one IO-queue op per node.
    """
    raw = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    chunks = [(off, size)
              for off, size in _chunk_table(arr.nbytes, chunk_bytes)
              if size > 0]
    table = []
    payloads = {}
    for ci, (off, size) in enumerate(chunks):
        table.append((ci * num_writers // len(chunks), off, size))
        payloads[off] = raw[off: off + size]
    return _RangePlan(table=table, payloads=payloads)


def range_owners(shape: Sequence[int], itemsize: int, sharding: Any,
                 num_writers: int
                 ) -> List[Tuple[int, int, int, int, int]]:
    """The §6 write table of one leaf under ``sharding``, pure arithmetic:
    ``(node, offset, size, rank, piece)`` per distinct byte range, in
    offset order.  A range is owned by the first rank in mesh order that
    holds it (replicas skip); its node is that rank's mesh position modulo
    ``num_writers``; its bytes are piece ``piece`` (of ``size`` bytes) of
    the rank's row-major shard (the reference's ``_plan_sharded``)."""
    from repro_torch.dist.sharding import device_ranges_of
    seen: set = set()
    table = []
    for pos, (rank, ranges) in enumerate(
            device_ranges_of(tuple(shape), itemsize, sharding)):
        for piece, r in enumerate(ranges):
            if r in seen:
                continue
            seen.add(r)
            table.append((pos % num_writers, r[0], r[1], rank, piece))
    table.sort(key=lambda t: t[1])
    return table


def _node_spans(ranges: Sequence[Tuple[int, int]]
                ) -> List[Tuple[int, int, List[Tuple[int, int]]]]:
    """Group sorted disjoint ranges into maximal contiguous spans."""
    spans: List[Tuple[int, int, List[Tuple[int, int]]]] = []
    for off, size in sorted(ranges):
        if spans and off == spans[-1][0] + spans[-1][1]:
            start, length, members = spans.pop()
            spans.append((start, length + size, members + [(off, size)]))
        else:
            spans.append((off, size, [(off, size)]))
    return spans


def _prev_hashes(prev_dir: Optional[str], prev_leaves: Dict[str, Any],
                 entry: Dict[str, Any]) -> Optional[List[str]]:
    """The previous save's hashes of this leaf, only against an identical
    table layout (dirty-range skipping)."""
    prev_entry = prev_leaves.get(entry["path"])
    if prev_entry is not None and prev_dir is not None and \
            [list(c) for c in prev_entry.get("chunks", [])] == \
            entry["chunks"]:
        return prev_entry.get("chunk_hashes")
    return None


Table = List[Tuple[int, int, int]]             # (node, offset, size)


def _run_writers(rt: Runtime, plans: List[Tuple[int, str, Table]],
                 payloads: Dict[Tuple[int, int], Any], mode: str,
                 crash_at: Optional[float]) -> bool:
    """The §5/§6 write program over ``(leaf, file, table)`` plans, the
    bytes of each range in ``payloads[(leaf, offset)]``: per (leaf, node)
    one opener EDT on that node, which maps the node's contiguous spans as file chunks,
    partitions each span into the node's ranges and hangs one EW writer
    EDT off every partition.  Files open in ``mode``.  Returns whether
    the run halted (``crash_at``) before it finished."""
    def writer(paramv, depv, api):
        (li, off, size) = paramv
        depv[0].ptr[:size] = np.frombuffer(payloads[(li, off)], np.uint8)
        api.db_destroy(depv[0].guid)   # EW write-back happens here (§5)
        return NULL_GUID

    def opener(paramv, depv, api):
        """Per-(leaf, node) §6 writer fan-out, running *on* that node, so
        each node writes exactly its own byte ranges."""
        (li, node, ranges) = paramv
        fg = api.file_get_guid(depv[0].ptr)
        wt = api.edt_template_create(writer, 3, 1)
        for (span_off, span_size, members) in _node_spans(ranges):
            chunk = api.file_get_chunk(fg, span_off, span_size,
                                       write_only=True)
            parts = api.db_partition(
                chunk, [(off - span_off, size) for (off, size) in members])
            for part, (off, size) in zip(parts, members):
                api.edt_create(wt, paramv=[li, off, size], depv=[part],
                               dep_modes=[DbMode.EW], placement=node)
            api.db_destroy(chunk)      # deferred until partitions retire
        api.file_release(fg)
        api.db_destroy(depv[0].guid)
        return NULL_GUID

    def main(paramv, depv, api):
        ot = api.edt_template_create(opener, 3, 1)
        for li, fpath, table in plans:
            if not table:
                if mode == "wb+":
                    with open(fpath, "wb"):
                        pass           # empty leaf: just create the file
                continue
            by_node: Dict[int, List[Tuple[int, int]]] = {}
            for (node, off, size) in table:
                by_node.setdefault(node, []).append((off, size))
            for node, ranges in sorted(by_node.items()):
                fg, desc = api.file_open(fpath, mode)
                api.edt_create(ot, paramv=[li, node, ranges], depv=[desc],
                               placement=node)
        return NULL_GUID

    spawn_main(rt, main)
    rt.run(until=crash_at)
    return crash_at is not None and not rt.quiescent()


@contextlib.contextmanager
def _collector_paused():
    """A save allocates tens of Python objects per range (plans, hashes,
    the runtime's blocks, tasks and messages) and frees none of them
    before it ends: the cyclic collector's passes would find nothing and
    cost a fifth of the save."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


def _copy_forward(path: str, table: Sequence[Tuple[int, int, int]],
                  clean: Sequence[bool], payloads: Dict[int, Any]) -> None:
    """Unchanged ranges come from the previous file; they still go
    through a writer (the new file must be complete) but do not count as
    dirty.  Seek-read only those ranges — never the whole file."""
    if not any(clean):
        return
    with open(path, "rb") as f:
        for (_n, off, size), c in zip(table, clean):
            if c:
                f.seek(off)
                payloads[off] = f.read(size)


def _finish_stats(stats: CkptStats, rt: Runtime) -> None:
    stats.io_write_ops = rt.stats.io_write_ops
    stats.io_coalesced_writes = rt.stats.io_coalesced_writes
    stats.makespan = rt.stats.makespan


# ------------------------------------------------------------------- save

def save(ckpt_dir: str, state: Any, step: int, *, chunk_bytes: int = 1 << 22,
         num_writers: Optional[int] = None, dirty_skip: bool = True,
         io_latency: float = 1.0, io_mode: str = "async",
         crash_at: Optional[float] = None,
         shardings: Any = None) -> CkptStats:
    """Write a checkpoint through §5 file-mapped blocks / §6 partitions.

    With no ``shardings`` the leaves are host (numpy) arrays, written in
    fixed-size chunks by ``num_writers`` (4) writer nodes.  With
    ``shardings`` (a tree of ``NamedSharding`` matching ``state``) every
    rank of the mesh calls ``save`` with its local shards (tensors on any
    device, or numpy arrays), and each writes exactly its own §6 byte
    ranges; ``num_writers`` defaults to the mesh's size.  ``crash_at``
    halts the save's runtime at that virtual time *before* the manifest
    commit (crash-consistency tests): the returned stats have
    ``committed=False`` and the ``step_N.tmp`` directory is left behind,
    which ``latest_step``/``restore`` ignore.
    """
    with _collector_paused():
        if shardings is not None:
            return _save_sharded(ckpt_dir, state, step, shardings,
                                 chunk_bytes=chunk_bytes,
                                 num_writers=num_writers,
                                 dirty_skip=dirty_skip,
                                 io_latency=io_latency, io_mode=io_mode,
                                 crash_at=crash_at)
        return _save_host(ckpt_dir, state, step, chunk_bytes=chunk_bytes,
                          num_writers=4 if num_writers is None
                          else num_writers, dirty_skip=dirty_skip,
                          io_latency=io_latency, io_mode=io_mode,
                          crash_at=crash_at)


def _save_host(ckpt_dir: str, state: Any, step: int, *, chunk_bytes: int,
               num_writers: int, dirty_skip: bool, io_latency: float,
               io_mode: str, crash_at: Optional[float]) -> CkptStats:
    leaves = _flatten(state)
    out_dir = os.path.join(ckpt_dir, f"step_{step}")
    tmp_dir = out_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)

    prev_dir: Optional[str] = None
    prev_leaves: Dict[str, Any] = {}
    if dirty_skip:
        prev_dir, prev_leaves = _load_prev_manifest(ckpt_dir)

    manifest: Dict[str, Any] = {
        "step": step, "chunk_bytes": chunk_bytes, "leaves": []}

    rt = Runtime(num_nodes=num_writers, io_latency=io_latency,
                 io_mode=io_mode)
    # the save's stats share the save-runtime's registry: ckpt.* gauges
    # land next to its io.* counters in one snapshot namespace
    stats = CkptStats(rt.registry)

    # (leaf_idx, offset) -> payload bytes, consulted by writer EDT bodies
    pending_payloads: Dict[Tuple[int, int], Any] = {}
    pending_files: List[Tuple[str, str]] = []
    plans: List[Tuple[int, str, Table]] = []

    for li, (path, leaf) in enumerate(leaves):
        arr = np.asarray(leaf)
        plan = _plan_chunked(arr, chunk_bytes, num_writers)
        shape, dtype, nbytes = list(arr.shape), str(arr.dtype), arr.nbytes
        hashes = [hashlib.sha1(plan.payloads[off]).hexdigest()
                  for (_n, off, _s) in plan.table]
        fname = f"leaf_{li}.bin"
        entry = {
            "path": path, "file": fname, "shape": shape, "dtype": dtype,
            "nbytes": nbytes,
            "chunks": [[off, size] for (_n, off, size) in plan.table],
            "chunk_hashes": hashes,
        }
        manifest["leaves"].append(entry)
        stats.chunks_total += len(plan.table)

        prev_hashes = _prev_hashes(prev_dir, prev_leaves, entry)
        if prev_hashes == hashes and prev_hashes is not None:
            # §5 dirty tracking: nothing modified → reuse previous file
            stats.chunks_skipped += len(plan.table)
            pending_files.append((os.path.join(prev_dir, fname),
                                  os.path.join(tmp_dir, fname)))
            continue
        clean = [prev_hashes is not None and i < len(prev_hashes)
                 and prev_hashes[i] == h for i, h in enumerate(hashes)]
        if prev_hashes is not None:
            _copy_forward(os.path.join(prev_dir, fname), plan.table, clean,
                          plan.payloads)
        for i, (_n, off, size) in enumerate(plan.table):
            pending_payloads[(li, off)] = plan.payloads[off]
            if clean[i]:
                stats.chunks_skipped += 1
            else:
                stats.chunks_written += 1
                stats.bytes_written += size
        plans.append((li, os.path.join(tmp_dir, fname), plan.table))

    if _run_writers(rt, plans, pending_payloads, "wb+", crash_at):
        # simulated crash mid-flush: in-flight IO-queue writes are lost
        # and the manifest is never committed — step_N.tmp is dead weight
        stats.committed = False
        _finish_stats(stats, rt)
        return stats

    for src, dst in pending_files:
        if os.path.abspath(src) != os.path.abspath(dst):
            with open(src, "rb") as f_in, open(dst, "wb") as f_out:
                f_out.write(f_in.read())
    _commit(manifest, tmp_dir, out_dir)
    _finish_stats(stats, rt)
    return stats


def _commit(manifest: Dict[str, Any], tmp_dir: str, out_dir: str) -> None:
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(out_dir):
        import shutil
        shutil.rmtree(out_dir)
    os.rename(tmp_dir, out_dir)          # commit point


# numpy names of the torch dtypes a checkpoint carries (bf16 has none)
_NP_NAMES = {torch.float64: "float64", torch.float32: "float32",
             torch.float16: "float16", torch.int64: "int64",
             torch.int32: "int32", torch.int16: "int16",
             torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}


def _dtype_of(path: str, leaf: Any) -> np.dtype:
    """The numpy dtype a leaf (array or tensor) is written as."""
    if isinstance(leaf, np.ndarray):
        return leaf.dtype
    if leaf.dtype not in _NP_NAMES:
        raise TypeError(f"checkpoint leaf {path!r} of dtype {leaf.dtype}: "
                        f"only dtypes with a numpy name are checkpointed "
                        f"(bf16 would need ml_dtypes on the host)")
    return np.dtype(_NP_NAMES[leaf.dtype])


def _host_shard(path: str, leaf: Any, copy: bool) -> np.ndarray:
    """This rank's local shard as one contiguous host array: one copy of
    a device tensor to the host (and of a host tensor when ``copy``)."""
    _dtype_of(path, leaf)
    if isinstance(leaf, np.ndarray):
        return np.array(leaf, copy=True) if copy else \
            np.ascontiguousarray(leaf)
    t = leaf.detach().contiguous()
    t = t.to("cpu", copy=True) if copy or t.device.type != "cpu" else t
    return t.numpy()


def _global_shape(local: Sequence[int], sharding: Any) -> Tuple[int, ...]:
    """The whole leaf's shape from a local shard's and its spec."""
    from repro_torch.dist.sharding import _entry_axes, mesh_names, mesh_ranks
    sizes = dict(zip(mesh_names(sharding.mesh),
                     mesh_ranks(sharding.mesh).shape))
    spec = tuple(sharding.spec) + (None,) * (len(local) - len(sharding.spec))
    return tuple(int(n) * int(np.prod([sizes[a] for a in _entry_axes(e)]))
                 for n, e in zip(local, spec))


def _mesh_rank(sharding: Any) -> Tuple[int, int]:
    """(this process's rank, the mesh's size); the mesh spans the group."""
    import torch.distributed as dist
    from repro_torch.dist.sharding import mesh_ranks
    if not dist.is_initialized():
        raise RuntimeError("a sharded save runs on every rank of an "
                           "initialized process group")
    size = int(mesh_ranks(sharding.mesh).size)
    if size != dist.get_world_size():
        raise ValueError(f"the mesh has {size} ranks, the process group "
                         f"{dist.get_world_size()}")
    return dist.get_rank(), size


def _save_sharded(ckpt_dir: str, state: Any, step: int, shardings: Any, *,
                  chunk_bytes: int, num_writers: Optional[int],
                  dirty_skip: bool, io_latency: float, io_mode: str,
                  crash_at: Optional[float]) -> CkptStats:
    import torch.distributed as dist
    from repro_torch.dist.sharding import NamedSharding
    leaves = _flatten(state)
    sh_by_path = dict(_flatten(shardings))
    missing = [p for p, _l in leaves
               if not isinstance(sh_by_path.get(p), NamedSharding)]
    if missing:
        raise ValueError(f"sharded save: no NamedSharding for {missing}")
    rank, mesh_size = _mesh_rank(sh_by_path[leaves[0][0]])
    if num_writers is None:
        num_writers = mesh_size
    out_dir = os.path.join(ckpt_dir, f"step_{step}")
    tmp_dir = out_dir + ".tmp"
    prev_dir: Optional[str] = None
    prev_leaves: Dict[str, Any] = {}
    if dirty_skip:
        prev_dir, prev_leaves = _load_prev_manifest(ckpt_dir)

    # 1. plan every leaf; hash this rank's ranges against the last save
    entries: List[Dict[str, Any]] = []
    tables: List[Table] = []                  # per leaf: every range
    owns: List[Table] = []                    # per leaf: this rank's ranges
    cleans: List[List[bool]] = []             # per leaf: unchanged ranges
    shared = []                 # per leaf: (this rank's hashes, all clean)
    payloads: Dict[Tuple[int, int], Any] = {}
    for li, (path, leaf) in enumerate(leaves):
        sh = sh_by_path[path]
        shape = _global_shape(tuple(leaf.shape), sh)
        dtype = _dtype_of(path, leaf)
        table = range_owners(shape, dtype.itemsize, sh, num_writers)
        owned = [t for t in table if t[3] == rank]
        mine: Dict[int, str] = {}
        if owned:
            raw = memoryview(_host_shard(path, leaf, False).reshape(-1)
                             .view(np.uint8))
            for (_n, off, size, _r, piece) in owned:
                payloads[(li, off)] = raw[piece * size:(piece + 1) * size]
                mine[off] = hashlib.sha1(payloads[(li, off)]).hexdigest()
        entries.append({
            "path": path, "file": f"leaf_{li}.bin", "shape": list(shape),
            "dtype": dtype.name, "nbytes": int(np.prod(shape)) *
            dtype.itemsize,
            "chunks": [[off, size] for (_n, off, size, _r, _p) in table]})
        prev = _prev_hashes(prev_dir, prev_leaves, entries[-1])
        tables.append([(n, off, size) for (n, off, size, _r, _p) in table])
        owns.append([(n, off, size) for (n, off, size, _r, _p) in owned])
        cleans.append([prev is not None and i < len(prev)
                       and prev[i] == mine[t[1]]
                       for i, t in enumerate(table) if t[3] == rank])
        shared.append((mine, prev is not None and all(cleans[-1])))

    # every rank's hashes make the manifest; a leaf whose ranges are all
    # unchanged on every rank reuses the previous file
    everyone = [None] * mesh_size
    dist.all_gather_object(everyone, shared)
    reuse = [all(r[li][1] for r in everyone) for li in range(len(leaves))]
    for li, entry in enumerate(entries):
        by_off: Dict[int, str] = {}
        for r in everyone:
            by_off.update(r[li][0])
        entry["chunk_hashes"] = [by_off[off] for _n, off, _s in tables[li]]
        entry["ranges"] = [list(t) for t in tables[li]]

    # 2. rank 0 lays out step_N.tmp; nobody opens a file before it has
    if rank == 0:
        os.makedirs(tmp_dir, exist_ok=True)
        for li, entry in enumerate(entries):
            dst = os.path.join(tmp_dir, entry["file"])
            if reuse[li]:
                import shutil
                shutil.copyfile(os.path.join(prev_dir, entry["file"]), dst)
            else:
                with open(dst, "wb") as f:
                    f.truncate(entry["nbytes"])
    dist.barrier()

    # 3. each rank writes its own ranges through its own runtime
    rt = Runtime(num_nodes=num_writers, io_latency=io_latency,
                 io_mode=io_mode)
    stats = CkptStats(rt.registry)
    plans: List[Tuple[int, str, Table]] = []
    for li, (entry, own, clean) in enumerate(zip(entries, owns, cleans)):
        stats.chunks_total += len(own)
        if reuse[li]:
            stats.chunks_skipped += len(own)
            continue
        if any(clean):
            forward: Dict[int, Any] = {}
            _copy_forward(os.path.join(prev_dir, entry["file"]), own, clean,
                          forward)
            payloads.update({(li, off): b for off, b in forward.items()})
        for (_n, _off, size), c in zip(own, clean):
            if c:
                stats.chunks_skipped += 1
            else:
                stats.chunks_written += 1
                stats.bytes_written += size
        if own:
            plans.append((li, os.path.join(tmp_dir, entry["file"]), own))
    halted = _run_writers(rt, plans, payloads, "rb+", crash_at)
    _finish_stats(stats, rt)

    # 4. every rank's counters; commit only if no rank halted
    keys = ("chunks_total", "chunks_written", "chunks_skipped",
            "bytes_written", "host_gathers", "io_write_ops",
            "io_coalesced_writes")
    local = {k: getattr(stats, k) for k in keys}
    local.update(makespan=stats.makespan, halted=halted)
    gathered = [None] * mesh_size
    dist.all_gather_object(gathered, local)
    for k in keys:
        setattr(stats, k, sum(g[k] for g in gathered))
    stats.makespan = max(g["makespan"] for g in gathered)
    if any(g["halted"] for g in gathered):
        # a crash on any rank: no manifest, step_N.tmp stays behind
        stats.committed = False
        return stats
    if rank == 0:
        _commit({"step": step, "chunk_bytes": chunk_bytes,
                 "leaves": entries}, tmp_dir, out_dir)
    dist.barrier()
    return stats


# ------------------------------------------------------------ cost model

def _itemsize(dtype: Any) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def _leaf_writes(shape: Tuple[int, ...], itemsize: int, sharding: Any,
                 num_writers: int) -> Tuple[int, int, Dict[int, int]]:
    """(ranges, bytes, {node: write ops}) of one leaf's sharded write:
    :func:`range_owners`' table — each distinct shard's §6 ranges,
    written by the node of the first rank in mesh order that holds it —
    with each node's adjacent ranges coalesced into one op, in numpy
    (the counts of the table, without its millions of tuples)."""
    from repro_torch.dist.sharding import mesh_ranks
    shape = tuple(int(d) for d in shape)
    if not shape:
        return 1, itemsize, {0: 1}
    if int(np.prod(shape)) == 0:
        return 0, 0, {}
    strides = [itemsize] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    nodes: Dict[int, List[Tuple[np.ndarray, int]]] = {}
    seen = set()
    for pos, rank in enumerate(int(r) for r in mesh_ranks(sharding.mesh).flat):
        idx = sharding.index_of(shape, rank)
        starts = [0 if sl.start is None else int(sl.start) for sl in idx]
        lens = [d - st if sl.stop is None else int(sl.stop) - st
                for sl, st, d in zip(idx, starts, shape)]
        if tuple(starts) in seen:            # a replica: its ranges are seen
            continue
        seen.add(tuple(starts))
        k = len(shape)
        while k > 0 and lens[k - 1] == shape[k - 1]:
            k -= 1
        if k == 0:
            offs, run = np.zeros(1, np.int64), int(np.prod(shape)) * itemsize
        else:
            run = lens[k - 1] * strides[k - 1]
            offs = np.full(1, starts[k - 1] * strides[k - 1], np.int64)
            for d in range(k - 1):
                offs = (offs[:, None] + (starts[d] + np.arange(
                    lens[d], dtype=np.int64))[None, :] * strides[d]
                        ).reshape(-1)
        nodes.setdefault(pos % num_writers, []).append((offs, run))
    ranges = nbytes = 0
    ops: Dict[int, int] = {}
    for node, parts in nodes.items():
        offs = np.concatenate([o for o, _ in parts])
        runs = np.concatenate([np.full(len(o), r, np.int64)
                               for o, r in parts])
        order = np.argsort(offs, kind="stable")
        offs, runs = offs[order], runs[order]
        ranges += len(offs)
        nbytes += int(runs.sum())
        ops[node] = 1 + int(np.count_nonzero(offs[1:] != offs[:-1]
                                             + runs[:-1]))
    return ranges, nbytes, ops


def io_cost(shapes: Any, shardings: Any, *, io_latency: float = 1.0,
            num_writers: Optional[int] = None) -> Dict[str, float]:
    """Model a sharded checkpoint write under the §5 latency model.

    Pure arithmetic — no save runs, no rank is needed: ``shapes`` is a
    tree of anything with ``.shape`` and ``.dtype`` (meta tensors, numpy
    arrays), ``shardings`` a matching tree of ``NamedSharding`` on a
    ``MeshLayout`` or a live mesh.  Lowers every leaf to its §6 ranges,
    dedups replicas, assigns ranges to writer nodes (as
    :func:`range_owners`), coalesces each node's adjacent ranges, and
    charges ``io_latency`` per post-coalescing op on per-node disks: the
    virtual write time is the busiest node's op count × the latency (the
    reference's ``io_cost``).
    """
    from repro_torch.dist.sharding import NamedSharding, mesh_ranks
    sh_by_path = dict(_flatten(shardings))
    ranges_total = 0
    bytes_total = 0
    ops_per_node: Dict[int, int] = {}
    for path, leaf in _flatten(shapes):
        sharding = sh_by_path.get(path)
        if not isinstance(sharding, NamedSharding):
            continue
        if num_writers is None:
            num_writers = int(mesh_ranks(sharding.mesh).size)
        ranges, nbytes, ops = _leaf_writes(
            tuple(leaf.shape), _itemsize(leaf.dtype), sharding, num_writers)
        ranges_total += ranges
        bytes_total += nbytes
        for node, n in ops.items():
            ops_per_node[node] = ops_per_node.get(node, 0) + n
    ops = sum(ops_per_node.values())
    return {
        "ranges": ranges_total,
        "io_write_ops": ops,
        "io_coalesced_writes": ranges_total - ops,
        "bytes": bytes_total,
        "nodes": len(ops_per_node),
        "write_time_virtual": (max(ops_per_node.values()) * io_latency
                               if ops_per_node else 0.0),
    }


# ------------------------------------------------------------- async save

class _SaveHandle:
    """Join-able result of :func:`async_save` (thread-API compatible)."""

    def __init__(self, stats: CkptStats):
        self.stats = stats

    def join(self, timeout: Optional[float] = None) -> None:
        return None

    def is_alive(self) -> bool:
        return False


def async_save(ckpt_dir: str, state: Any, step: int, **kw) -> _SaveHandle:
    """Issue-now/resolve-later (§3) save through the §5 IO queue.

    Mutable leaves are snapshot at issue time — host arrays copied; under
    ``shardings=`` each rank's local shards copied to the host, one copy
    of each (the port updates its state in place, so nothing that runs
    after the call may change what is written) — then the write rides the
    runtime's asynchronous IO queue: overlap is modeled by the
    latency-charged subsystem itself rather than an ad-hoc host thread.
    Note the *wall-clock* call is synchronous — the returned handle is
    already complete and ``join()`` is a no-op kept for API parity.
    """
    if kw.get("shardings") is not None:
        snap = {p: _host_shard(p, a, copy=True) for p, a in _flatten(state)}
    else:
        snap = {p: (np.array(a, copy=True) if isinstance(a, np.ndarray)
                    else a)
                for p, a in _flatten(state)}
    return _SaveHandle(save(ckpt_dir, _unflatten(snap), step, **kw))


# ---------------------------------------------------------------- restore

def restore(ckpt_dir: str, step: Optional[int] = None,
            num_readers: int = 4, io_latency: float = 1.0,
            shardings: Any = None, device: Any = "cuda"
            ) -> Tuple[Any, int]:
    """Reassemble the checkpoint tree (elastic: any reader count or mesh).

    With no ``shardings`` every leaf comes back whole as a numpy array:
    ranges are read back as §5 chunks through a ``num_readers``-node
    runtime.  With ``shardings`` (a tree of ``NamedSharding``, on any mesh
    — not necessarily the one that wrote the checkpoint) each leaf that
    has one comes back as this process's local shard (its rank in the
    process group, 0 without one), a tensor on ``device`` (the card
    unless the caller passes ``"cpu"``): only the shard's byte ranges under the target sharding
    (``device_ranges_of``) are read, straight from the row-major leaf
    file.  Leaves without a sharding come back whole, as numpy.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    sh_by_path: Dict[str, Any] = {}
    if shardings is not None:
        sh_by_path = dict(_flatten(shardings))
    items: Dict[str, Any] = {}
    whole = []
    for li, leaf in enumerate(manifest["leaves"]):
        sh = sh_by_path.get(leaf["path"])
        if sh is None:
            whole.append(li)
        else:
            items[leaf["path"]] = _read_shard(d, leaf, sh, device)
    if whole:
        for li, arr in _read_whole(d, manifest, whole, num_readers,
                                   io_latency).items():
            items[manifest["leaves"][li]["path"]] = arr
    return _unflatten(items), manifest["step"]


def _read_units(chunks: Sequence[Sequence[int]], cap: int
                ) -> List[Tuple[int, int]]:
    """The reads of one leaf: its chunk table with adjacent entries joined
    while a read stays within ``cap`` bytes (a host-leaf table is already
    ``chunk_bytes`` a chunk; a sharded one holds a range per row-major run
    of a shard, often a few KiB, read in as few §5 chunks as the cap
    allows).  Empty entries drop out."""
    out: List[Tuple[int, int]] = []
    for off, size in sorted((int(o), int(s)) for o, s in chunks):
        if size == 0:
            continue
        if out and out[-1][0] + out[-1][1] == off and \
                out[-1][1] + size <= cap:
            out[-1] = (out[-1][0], out[-1][1] + size)
        else:
            out.append((off, size))
    return out


def _read_whole(d: str, manifest: Dict[str, Any], which: List[int],
                num_readers: int, io_latency: float
                ) -> Dict[int, np.ndarray]:
    """Whole leaves ``which``, read as §5 chunks by reader EDTs."""
    rt = Runtime(num_nodes=num_readers, io_latency=io_latency)
    buffers: Dict[int, np.ndarray] = {}

    def reader(paramv, depv, api):
        (li, off, size) = paramv
        buffers[li][off: off + size] = depv[0].ptr[:size]
        api.db_destroy(depv[0].guid)
        return NULL_GUID

    def after_open(paramv, depv, api):
        # §5 pattern: runs only once the descriptor DB is satisfied
        li = paramv[0]
        leaf = manifest["leaves"][li]
        fg = api.file_get_guid(depv[0].ptr)
        tmpl = api.edt_template_create(reader, 3, 1)
        for ci, (off, size) in enumerate(_read_units(
                leaf["chunks"], manifest.get("chunk_bytes", 0))):
            chunk = api.file_get_chunk(fg, off, size)
            api.edt_create(tmpl, paramv=[li, off, size], depv=[chunk],
                           dep_modes=[DbMode.RO],
                           placement=ci % num_readers)
        api.file_release(fg)
        api.db_destroy(depv[0].guid)
        return NULL_GUID

    def main(paramv, depv, api):
        otmpl = api.edt_template_create(after_open, 1, 1)
        for li in which:
            leaf = manifest["leaves"][li]
            buffers[li] = np.empty(leaf["nbytes"], np.uint8)
            if leaf["nbytes"] == 0:
                continue
            _, desc = api.file_open(os.path.join(d, leaf["file"]), "rb")
            api.edt_create(otmpl, paramv=[li], depv=[desc])
        return NULL_GUID

    spawn_main(rt, main)
    rt.run()
    return {li: buffers[li].view(np.dtype(manifest["leaves"][li]["dtype"]))
            .reshape(manifest["leaves"][li]["shape"]) for li in which}


def _read_shard(d: str, leaf: Dict[str, Any], sharding: Any,
                device: Any) -> torch.Tensor:
    """This rank's shard of one leaf under ``sharding``: its byte
    ranges, in the shard's row-major order, read into one buffer."""
    import torch.distributed as dist
    from repro_torch.dist.sharding import device_ranges_of
    from repro_torch.models.layers import resolve_device
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = resolve_device(device)
    shape = tuple(leaf["shape"])
    bf16 = leaf["dtype"] == "bfloat16"
    np_dtype = np.dtype(np.uint16 if bf16 else leaf["dtype"])
    local = tuple(len(range(*sl.indices(n))) for sl, n in
                  zip(sharding.index_of(shape, rank), shape))
    buf = np.empty(int(np.prod(local)) * np_dtype.itemsize, np.uint8)
    # a scalar is every rank's whole (device_ranges_of lists it once)
    ranges = ([(0, np_dtype.itemsize)] if not shape else
              dict(device_ranges_of(shape, np_dtype.itemsize,
                                    sharding))[rank])
    pos = 0
    with open(os.path.join(d, leaf["file"]), "rb", buffering=0) as f:
        for off, size in ranges:
            f.seek(off)
            if f.readinto(memoryview(buf)[pos:pos + size]) != size:
                raise OSError(f"{leaf['file']}: short read at {off}")
            pos += size
    t = torch.from_numpy(buf.view(np_dtype).reshape(local))
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(dev)
