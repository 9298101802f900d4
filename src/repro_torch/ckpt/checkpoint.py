"""Chunked checkpointing on the paper's §5 file-mapped blocks (host
leaves).

A copy of ``repro.ckpt.checkpoint``'s host-leaf path with its imports
rewritten to ``repro_torch``.  The manifest format is unchanged, so a
checkpoint written by either package restores into the other.  The §6
sharded path (``_plan_sharded``, ``io_cost`` and restore's
``shardings=``) comes back with the port's sharded checkpoints; until
then every leaf is a host (numpy) array — ``repro_torch.convert``'s
``state_to_numpy`` makes them from a train state.

Layout of a checkpoint at ``<dir>/step_<N>/``:
  leaf_<i>.bin     one file per pytree leaf
  manifest.json    tree paths, shapes, dtypes, chunk tables, hashes

* **Chunked** — a leaf is written as fixed-size disjoint chunks by
  parallel writer EDTs acquiring their chunk data blocks in EW mode;
  non-overlap is *enforced by the runtime* (§5 ``ocrFileGetChunk``), so a
  buggy writer cannot corrupt a neighbour.
* **Dirty-only** — when the previous checkpoint's manifest is supplied,
  chunks whose content hash is unchanged are skipped (§5: the runtime
  only writes back chunks that were actually modified).  A
  missing/corrupt previous manifest only disables the skip (warning),
  it never poisons the save.
* **Committed** — ``manifest.json`` is written last via atomic rename; a
  crash mid-save (``crash_at``, fail-stop, or a real crash) leaves the
  previous checkpoint intact (``latest_step`` only counts manifests and
  ``step_*.tmp`` directories are ignored).
* **Elastic** — restore reassembles full leaves from the chunk tables
  regardless of the writer or reader count.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import DbMode, NULL_GUID, Runtime, spawn_main
from repro_torch.monitoring import Registry

# legacy CkptStats field → its ckpt.* monitoring-registry slot and zero
_CKPT_FIELDS: Tuple[Tuple[str, str, Any], ...] = (
    ("chunks_total", "ckpt.chunks_total", 0),
    ("chunks_written", "ckpt.chunks_written", 0),
    ("chunks_skipped", "ckpt.chunks_skipped", 0),
    ("bytes_written", "ckpt.bytes_written", 0),
    # host-side full-leaf gathers of device-sharded arrays (host leaves
    # need none; kept so the counters match the reference's)
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
    payloads: Dict[int, bytes]               # offset -> bytes to write


def _plan_chunked(arr: np.ndarray, chunk_bytes: int,
                  num_writers: int) -> _RangePlan:
    """Fixed-size chunk plan for a host leaf.

    Chunks are assigned to writer nodes in contiguous blocks (not
    round-robin) so each node's dirty ranges are adjacent and its
    write-backs coalesce into one IO-queue op per node.
    """
    raw = arr.tobytes()
    chunks = [(off, size)
              for off, size in _chunk_table(arr.nbytes, chunk_bytes)
              if size > 0]
    table = []
    payloads = {}
    for ci, (off, size) in enumerate(chunks):
        table.append((ci * num_writers // len(chunks), off, size))
        payloads[off] = raw[off: off + size]
    return _RangePlan(table=table, payloads=payloads)


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


# ------------------------------------------------------------------- save

def save(ckpt_dir: str, state: Any, step: int, *, chunk_bytes: int = 1 << 22,
         num_writers: int = 4, dirty_skip: bool = True,
         io_latency: float = 1.0, io_mode: str = "async",
         crash_at: Optional[float] = None) -> CkptStats:
    """Write a checkpoint of host (numpy) leaves through §5 file-mapped
    blocks, in fixed-size chunks.  ``crash_at`` halts the save's runtime at that
    virtual time *before* the manifest commit (crash-consistency tests):
    the returned stats have ``committed=False`` and the ``step_N.tmp``
    directory is left behind, which ``latest_step``/``restore`` ignore.
    """
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
    pending_payloads: Dict[Tuple[int, int], bytes] = {}
    pending_files: List[Tuple[str, str]] = []
    plans: List[Tuple[int, str, _RangePlan, List[str]]] = []

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

        # dirty-range skipping: only against an identical table layout
        prev_entry = prev_leaves.get(path)
        prev_hashes: Optional[List[str]] = None
        if prev_entry is not None and prev_dir is not None and \
                [list(c) for c in prev_entry.get("chunks", [])] == \
                entry["chunks"]:
            prev_hashes = prev_entry.get("chunk_hashes")
        if prev_hashes == hashes and prev_hashes is not None:
            # §5 dirty tracking: nothing modified → reuse previous file
            stats.chunks_skipped += len(plan.table)
            pending_files.append((os.path.join(prev_dir, fname),
                                  os.path.join(tmp_dir, fname)))
            continue
        clean: List[bool] = [False] * len(plan.table)
        if prev_hashes is not None:
            # copy-forward unchanged ranges from the previous file; they
            # still go through a writer (the new file must be complete)
            # but do not count as dirty.  Seek-read only those ranges —
            # never the whole previous file.
            with open(os.path.join(prev_dir, fname), "rb") as f:
                for i, (_n, off, size) in enumerate(plan.table):
                    if i < len(prev_hashes) and prev_hashes[i] == hashes[i]:
                        f.seek(off)
                        plan.payloads[off] = f.read(size)
                        clean[i] = True
        for i, (_n, off, size) in enumerate(plan.table):
            key = (li, off)
            pending_payloads[key] = plan.payloads[off]
            if clean[i]:
                stats.chunks_skipped += 1
            else:
                stats.chunks_written += 1
                stats.bytes_written += size
        plans.append((li, os.path.join(tmp_dir, fname), plan))

    def writer(paramv, depv, api):
        (li, off, size) = paramv
        data = pending_payloads[(li, off)]
        depv[0].ptr[:size] = np.frombuffer(data, dtype=np.uint8)
        api.db_destroy(depv[0].guid)   # EW write-back happens here (§5)
        return NULL_GUID

    def opener(paramv, depv, api):
        """Per-(leaf, node) §6 writer fan-out, running *on* that node.

        Maps the node's contiguous spans as file chunks, partitions each
        span into the node's individual §6 ranges, and hangs one EW
        writer EDT off every partition — so each node writes exactly its
        own byte ranges, and adjacent ranges coalesce at write-back.
        """
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
        for li, fpath, plan in plans:
            if not plan.table:
                with open(fpath, "wb"):
                    pass               # empty leaf: just create the file
                continue
            by_node: Dict[int, List[Tuple[int, int]]] = {}
            for (node, off, size) in plan.table:
                by_node.setdefault(node, []).append((off, size))
            for node, ranges in sorted(by_node.items()):
                fg, desc = api.file_open(fpath, "wb+")
                api.edt_create(ot, paramv=[li, node, ranges], depv=[desc],
                               placement=node)
        return NULL_GUID

    spawn_main(rt, main)
    rt.run(until=crash_at)
    if crash_at is not None and not rt.quiescent():
        # simulated crash mid-flush: in-flight IO-queue writes are lost
        # and the manifest is never committed — step_N.tmp is dead weight
        stats.committed = False
        stats.io_write_ops = rt.stats.io_write_ops
        stats.io_coalesced_writes = rt.stats.io_coalesced_writes
        stats.makespan = rt.stats.makespan
        return stats

    for src, dst in pending_files:
        if os.path.abspath(src) != os.path.abspath(dst):
            with open(src, "rb") as f_in, open(dst, "wb") as f_out:
                f_out.write(f_in.read())

    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(out_dir):
        import shutil
        shutil.rmtree(out_dir)
    os.rename(tmp_dir, out_dir)          # commit point
    stats.io_write_ops = rt.stats.io_write_ops
    stats.io_coalesced_writes = rt.stats.io_coalesced_writes
    stats.makespan = rt.stats.makespan
    return stats


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

    Mutable host leaves are snapshot at issue time, then the write
    rides the runtime's asynchronous IO queue: overlap is modeled by the
    latency-charged subsystem itself rather than an ad-hoc host thread.
    Note the *wall-clock* call is synchronous — the returned handle is
    already complete and ``join()`` is a no-op kept for API parity.
    """
    snap = {p: (np.array(a, copy=True) if isinstance(a, np.ndarray)
                else a)
            for p, a in _flatten(state)}
    return _SaveHandle(save(ckpt_dir, _unflatten(snap), step, **kw))


# ---------------------------------------------------------------- restore

def restore(ckpt_dir: str, step: Optional[int] = None,
            num_readers: int = 4, io_latency: float = 1.0
            ) -> Tuple[Any, int]:
    """Reassemble the checkpoint tree as numpy leaves (elastic: any
    reader count; ranges of a sharded save reassemble the same way).
    Ranges are read back as §5 chunks into full leaves."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    items: Dict[str, Any] = {}
    rt = Runtime(num_nodes=num_readers, io_latency=io_latency)
    buffers: Dict[int, bytearray] = {}

    def reader(paramv, depv, api):
        (li, off, size) = paramv
        buffers[li][off: off + size] = bytes(depv[0].ptr[:size])
        api.db_destroy(depv[0].guid)
        return NULL_GUID

    def after_open(paramv, depv, api):
        # §5 pattern: runs only once the descriptor DB is satisfied
        li = paramv[0]
        leaf = manifest["leaves"][li]
        fg = api.file_get_guid(depv[0].ptr)
        tmpl = api.edt_template_create(reader, 3, 1)
        for ci, (off, size) in enumerate(leaf["chunks"]):
            if size == 0:
                continue
            chunk = api.file_get_chunk(fg, off, size)
            api.edt_create(tmpl, paramv=[li, off, size], depv=[chunk],
                           dep_modes=[DbMode.RO],
                           placement=ci % num_readers)
        api.file_release(fg)
        api.db_destroy(depv[0].guid)
        return NULL_GUID

    def main(paramv, depv, api):
        otmpl = api.edt_template_create(after_open, 1, 1)
        for li, leaf in enumerate(manifest["leaves"]):
            buffers[li] = bytearray(leaf["nbytes"])
            if leaf["nbytes"] == 0:
                continue
            _, desc = api.file_open(os.path.join(d, leaf["file"]), "rb")
            api.edt_create(otmpl, paramv=[li], depv=[desc])
        return NULL_GUID

    spawn_main(rt, main)
    rt.run()

    for li, leaf in enumerate(manifest["leaves"]):
        arr = np.frombuffer(bytes(buffers[li]),
                            dtype=np.dtype(leaf["dtype"]))
        items[leaf["path"]] = arr.reshape(leaf["shape"])
    return _unflatten(items), manifest["step"]
