"""The OCR-extensions runtime (paper §2–§6).

A deterministic, virtual-time, multi-node simulation of a message-based
distributed OCR implementation:

* Every API call translates to messages (paper §2).  Remote deliveries cost
  ``net_latency`` of virtual time; an optional seeded ``jitter`` perturbs
  delivery order so property tests can explore interleavings.
* **LIDs (§3)** — object-creating calls with ``EDT_PROP_LID`` return a local
  identifier immediately; messages referencing unresolved LIDs are *deferred*
  on the issuing node, patched when the ``MMap`` resolution arrives, and only
  then submitted (the M_create/M_dep/M_map protocol of §3).  ``get_guid`` is
  the single blocking call; each forced resolution costs one round-trip
  (2 × ``net_latency``) and is counted in :class:`Stats`.
* **Labeled maps (§4)** — ``map_get`` returns a fresh LID instantly; the map
  owner runs the creator function exactly once per index, and all LIDs for
  an index resolve to the same GUID.
* **File IO (§5)** — file-mapped data blocks with asynchronously-filled
  descriptor blocks, non-overlapping chunks, dirty-only write-back.  Chunk
  reads/writes ride per-node virtual-time IO queues (``io_queue.IoQueue``):
  reads stream ahead of first acquire, grants defer on IO-pending blocks,
  and adjacent dirty ranges coalesce into one write-back op
  (``Runtime(io_mode="sync")`` keeps the blocking per-chunk baseline).
* **Partitioning (§6)** — disjoint EW partitions of one data block execute
  in parallel; the parent is quiescent while partitions live; parent+child
  in one task raises :class:`PartitionDeadlockError`; ``db_copy`` implements
  the §6.3 zero-copy / copy-on-write path.

Virtual time gives crisp, noise-free benchmarks: a task occupies
``[start, start + duration + blocking_time]``, locks are held for that
interval, and ``Stats.makespan`` is the completion time of the whole graph.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import os
import random
import struct
import tempfile
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .guid import (
    DB_COPY_PARTITION,
    DB_COPY_PARTITION_BACK,
    DB_COPY_PLAIN,
    DB_PROP_NO_ACQUIRE,
    EDT_PROP_LID,
    EDT_PROP_MAPPED,
    GUID_SHARD_BITS,
    OCR_DB_PARTITION_STATIC,
    DbMode,
    EventKind,
    Guid,
    IdType,
    Lid,
    NULL_GUID,
    ObjectKind,
    UNINITIALIZED_GUID,
    id_type,
    is_null,
)
from .io_queue import IoQueue
from ..monitoring import Monitor, Registry
from .messages import (
    MCreate,
    MDbCopy,
    MDep,
    MDestroy,
    MFileOpened,
    MIoDone,
    MMap,
    MMapGet,
    MSatisfy,
    Message,
)
from .objects import (
    ChunkOverlapError,
    DbObj,
    DepEntry,
    EdtObj,
    EventObj,
    FileModeError,
    FileObj,
    MapObj,
    ObjectTable,
    OcrError,
    PartitionDeadlockError,
    PartitionOverlapError,
    PartitionStaticError,
    TemplateObj,
    UNSET,
    spans_overlap,
)

__all__ = [
    "Runtime",
    "TaskCtx",
    "Stats",
    "OcrError",
    "PartitionOverlapError",
    "PartitionDeadlockError",
    "PartitionStaticError",
    "ChunkOverlapError",
    "FileModeError",
]


# Every legacy Stats field, its dotted registry name, and its zero value.
# Declaration order is the dataclass field order Stats used to have, so
# Stats.snapshot() keys come out identical to the old dataclasses.asdict.
_STATS_FIELDS: Tuple[Tuple[str, str, Any], ...] = (
    ("messages_sent", "runtime.messages_sent", 0),
    ("messages_remote", "runtime.messages_remote", 0),
    ("messages_deferred", "runtime.messages_deferred", 0),
    ("deferred_patched", "runtime.deferred_patched", 0),
    ("deferred_rescans", "runtime.deferred_rescans", 0),
    ("blocking_roundtrips", "runtime.blocking_roundtrips", 0),
    ("creator_calls", "runtime.creator_calls", 0),
    ("tasks_executed", "runtime.tasks_executed", 0),
    ("waiter_wakeups", "runtime.waiter_wakeups", 0),
    ("reader_batch_grants", "runtime.reader_batch_grants", 0),
    ("bytes_copied", "copy.bytes_copied", 0),
    ("bytes_zero_copy", "copy.bytes_zero_copy", 0),
    ("file_bytes_read", "io.file_bytes_read", 0),
    ("file_bytes_written", "io.file_bytes_written", 0),
    ("fused_copies", "copy.fused_copies", 0),
    ("io_read_ops", "io.read_ops", 0),
    ("io_write_ops", "io.write_ops", 0),
    ("io_reads_inflight_max", "io.reads_inflight_max", 0),
    ("io_coalesced_writes", "io.coalesced_writes", 0),
    ("io_overlap_ticks", "io.overlap_ticks", 0.0),
    # GUID-table gauges (refreshed when run() returns): live shards across
    # all nodes, shards still holding a buffer-resident object, and data
    # blocks whose buffers currently live in a node spill file
    ("table_shards", "table.shards", 0),
    ("table_hot_shards", "table.hot_shards", 0),
    ("spilled_objects", "spill.objects", 0),
    # fully-tombstoned ONCE-event shards compacted into per-shard
    # satisfied-sets (cumulative — see ObjectTable.retire_event_shards)
    ("tombstone_shards_retired", "table.tombstone_shards_retired", 0),
    # reclaimed-but-uncompacted bytes across all node spill files (the
    # free-list holes), refreshed when run() returns
    ("spill_frag_bytes", "spill.frag_bytes", 0),
    # sanitizer gauges (Runtime(sanitize=...) / REPRO_SANITIZE=1): trace
    # events recorded, hb-races among them, total hard findings, and
    # quiescence advisories (leaks / dangling slots)
    ("san_events", "san.events", 0),
    ("san_races", "san.races", 0),
    ("san_findings", "san.findings", 0),
    ("san_advisories", "san.advisories", 0),
    # spill-file slots handed back out of the free list instead of growing
    # the file (slot reuse — see Runtime._spill_shard)
    ("spill_slots_reused", "spill.slots_reused", 0),
    # on-line spill-file compaction sweeps completed (see
    # Runtime._finish_compact; enabled by spill_compact_threshold)
    ("spill_compactions", "spill.compactions", 0),
    # MoE dispatch gauges (stamped by the Trainer from the last step's
    # metrics): (token, choice) pairs dropped on bucket overflow, their
    # fraction of all routed pairs, and the per-device bytes the two
    # capacity-bucket all_to_all exchanges move per layer
    ("moe_dropped_tokens", "moe.dropped_tokens", 0),
    ("moe_overflow_rate", "moe.overflow_rate", 0.0),
    ("moe_a2a_bytes", "moe.a2a_bytes", 0),
    ("makespan", "runtime.makespan", 0.0),
)


class Stats:
    """Field-compatible view over the ``repro_torch.monitoring`` registry.

    Formerly a dataclass of ~35 counters refreshed only at ``run()``
    return; now every field is a property reading/writing one dotted
    registry slot (``messages_sent`` ↔ ``runtime.messages_sent``), so
    the existing increment sites and committed bench snapshots keep
    working bit-identically while ``Registry.snapshot()`` sees the
    same numbers live, mid-run.  Standalone construction (``Stats()``)
    makes a private registry, preserving the old dataclass behaviour.
    """

    __slots__ = ("registry",)

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = Registry() if registry is None else registry
        declare = self.registry.declare
        for _field, name, default in _STATS_FIELDS:
            declare(name, default)

    def snapshot(self) -> Dict[str, float]:
        vals = self.registry._values
        return {field: vals[name] for field, name, _default in _STATS_FIELDS}

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v!r}" for k, v in self.snapshot().items())
        return f"Stats({body})"


def _stats_property(name: str) -> property:
    def _get(self: Stats) -> Any:
        return self.registry._values[name]

    def _set(self: Stats, value: Any) -> None:
        self.registry._values[name] = value

    return property(_get, _set)


for _field, _name, _default in _STATS_FIELDS:
    setattr(Stats, _field, _stats_property(_name))
del _field, _name, _default


@dataclasses.dataclass
class _Node:
    idx: int
    alive: bool = True
    guid_seq: int = 0
    lid_seq: int = 0
    # GUID table sharded by (kind, seq-range) — see objects.ObjectTable
    objects: ObjectTable = dataclasses.field(default_factory=ObjectTable)
    lid_table: Dict[Lid, Optional[Guid]] = dataclasses.field(default_factory=dict)
    # --- cold-object spill (one private spill file per node) ---
    spill_path: Optional[str] = None
    spill_tail: int = 0               # high-water mark of the spill file
    # freed spill-file holes as (offset, size), first-fit reused by the
    # next spill instead of bumping the tail forever
    spill_free: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    spilled: int = 0                  # blocks currently spilled on this node
    spill_inflight: int = 0           # victims with a spill write in flight
    compact_inflight: bool = False    # a compaction sweep op is on the disk
    spill_scan_at: float = -1.0       # last fruitless-scan timestamp guard
    # blocks owning their buffer (not views, not spilled/unread): kept
    # incrementally so the spill threshold check is O(1), not O(objects)
    resident_dbs: int = 0
    # messages held locally until all their unresolved LIDs are patched;
    # a message is indexed under *every* unresolved LID it references, so
    # one MMap patch releases it iff it was the last unresolved one — no
    # re-deferral rescans (see Message._blocked_on)
    deferred: Dict[Lid, List[Message]] = dataclasses.field(default_factory=dict)
    # count of LIDs allocated on this node that are still unresolved; lets
    # send() skip the lids() allocation+scan entirely on the common path
    unresolved_lids: int = 0


class Runtime:
    """A virtual-time multi-node OCR runtime."""

    def __init__(
        self,
        num_nodes: int = 1,
        net_latency: float = 1.0,
        io_latency: float = 1.0,
        seed: int = 0,
        jitter: float = 0.0,
        trace: bool = False,
        copy_backend: str = "numpy",
        copy_device: str = "cuda",
        reader_batch_bound: int = 8,
        io_mode: str = "async",
        read_ahead: bool = True,
        spill_threshold: Optional[int] = None,
        spill_compact_threshold: Optional[float] = None,
        shard_bits: int = GUID_SHARD_BITS,
        sanitize: Any = None,
        monitor: Any = None,
    ):
        self.num_nodes = num_nodes
        self.net_latency = float(net_latency)
        self.io_latency = float(io_latency)
        self.jitter = float(jitter)
        self.rng = random.Random(seed)
        self.trace = trace
        # "numpy" | "cuda" (§6.3 fallback): "cuda" runs batched copies
        # through the fused partition-copy kernels (the reference's
        # "pallas") on ``copy_device``; "cpu" takes their plain versions
        if copy_backend not in ("numpy", "cuda"):
            raise NotImplementedError(
                f"copy_backend={copy_backend!r}: 'numpy' or 'cuda'")
        self.copy_backend = copy_backend
        self.copy_device = copy_device
        if copy_backend == "cuda":
            self._check_copy_device()
        # §5 file IO discipline: "async" puts chunk reads/writes on the
        # per-node IO queues (overlap with compute, write coalescing);
        # "sync" drives the same latency model blocking, per chunk
        if io_mode not in ("async", "sync"):
            raise ValueError(f"io_mode must be 'async' or 'sync', not {io_mode!r}")
        self.io_mode = io_mode
        # async mode: issue the lazy read already at file_get_chunk time
        # (ahead of the first acquire) instead of at the first grant attempt
        self.read_ahead = read_ahead
        # max RO waiters granted past a blocked FIFO head per wake (bounded
        # barging: 0 disables; keeps writers from starving behind readers)
        self.reader_batch_bound = reader_batch_bound
        # cold-object spill: when a node holds more than this many
        # buffer-resident data blocks, idle unlocked ones spill to the
        # node's spill file through the §5 IO queue (None disables)
        self.spill_threshold = spill_threshold
        # on-line spill-file compaction: when a node's free-list holes
        # exceed this fraction of its bump pointer, live slots rewrite
        # through one IO-queue sweep and the tail shrinks (None disables)
        self.spill_compact_threshold = spill_compact_threshold
        self.shard_bits = shard_bits
        self.nodes = [_Node(i, objects=ObjectTable(shard_bits))
                      for i in range(num_nodes)]
        # one monitoring registry per runtime; Stats is a property view
        # over it, so counters land in the registry whether or not the
        # Monitor hooks below are enabled
        self.registry = Registry()
        self.stats = Stats(self.registry)
        self.clock = 0.0
        self._heap: List[Tuple[float, int, str, Any]] = []
        self._tick = itertools.count()
        self._cancelled: set = set()
        self._placement_rr = 0
        self.shutdown_requested = False
        # lid -> in-flight message that will bind it (for forced resolution)
        self._pending_lid_msg: Dict[Lid, Message] = {}
        # per-DB FIFO waiter queues: blocking db guid -> deque of EdtObj;
        # a release wakes only waiters of the DB whose state changed.
        # EdtObj.waiting_on marks which queue an EDT currently sits in
        # (dedup + O(1) staleness checks without hashing guids).
        self._db_waiters: Dict[Guid, Deque[EdtObj]] = {}
        # db guid -> ancestor chain (parent links only change when a
        # zero-copy §6.3 partition copy assigns one, which invalidates)
        self._ancestor_cache: Dict[Guid, Tuple[Guid, ...]] = {}
        # bumped when a zero-copy partition copy rewires ancestry; EDTs
        # re-run the §6.2 deadlock check lazily when their epoch is stale
        self._partition_epoch = 0
        # §6.3 same-timestamp copy batching (flushed through one fused
        # kernel launch per (src, dst) pair when a partition set materializes)
        self._copy_batch: List[MDbCopy] = []
        self._copy_flush_scheduled = False
        # registry so file descriptors can be decoded from raw pointers (§5)
        self.file_registry: List[Guid] = []
        # §5 async IO subsystem: per-node virtual-time disk queues
        self.io = IoQueue(self)
        # tasks currently occupying a virtual-time window (for
        # Stats.io_overlap_ticks: time IO and compute were both in flight)
        self._running_tasks = 0
        # --- ocrsan (repro_torch.analysis): None when off, so every hook site is
        # one attribute check on the fast path.  The explicit parameter
        # wins over the REPRO_SANITIZE environment variable; "1"/"strict"
        # raise OcrSanError at run() return, anything else truthy records.
        if sanitize is None:
            sanitize = os.environ.get("REPRO_SANITIZE", "")
        self._san = None
        mode = str(sanitize).lower()
        if mode not in ("", "0", "false", "none", "off"):
            from ..analysis.trace import Sanitizer
            self._san = Sanitizer(self, strict=mode in ("1", "strict"))
        # --- monitoring (repro_torch.monitoring): same wiring as the sanitizer —
        # None when off, so live-gauge and histogram hook sites are one
        # attribute check and virtual metrics stay bit-identical either way.
        # The explicit parameter wins over REPRO_MONITOR.
        if monitor is None:
            monitor = os.environ.get("REPRO_MONITOR", "")
        self._mon = None
        mmode = str(monitor).lower()
        if mmode not in ("", "0", "false", "none", "off"):
            self._mon = Monitor(self.registry)

    def san_report(self):
        """The sanitizer's findings so far (``repro_torch.analysis.SanitizerReport``).

        Quiescence lints (lost wakeups, leaks, dangling slots) are
        included only when the event heap is empty.  Raises
        :class:`OcrError` if the runtime was built without ``sanitize``.
        """
        if self._san is None:
            raise OcrError(
                "sanitizer not enabled: pass Runtime(sanitize=True) "
                "or set REPRO_SANITIZE=1")
        return self._san.report()

    # ------------------------------------------------------------------ util

    def _log(self, *args: Any) -> None:
        if self.trace:
            print(f"[t={self.clock:8.2f}]", *args)

    def node(self, i: int) -> _Node:
        return self.nodes[i]

    def _alloc_guid(self, node: int, kind: ObjectKind) -> Guid:
        n = self.nodes[node]
        n.guid_seq += 1
        return Guid(node, n.guid_seq, kind)

    def _alloc_lid(self, node: int) -> Lid:
        n = self.nodes[node]
        n.lid_seq += 1
        lid = Lid(node, n.lid_seq)
        n.lid_table[lid] = None
        n.unresolved_lids += 1
        if self._san is not None:
            self._san.on_lid_alloc(lid)
        return lid

    def _pick_node(self, hint: Optional[int]) -> int:
        if hint is not None:
            n = hint % self.num_nodes
            if not self.nodes[n].alive:
                raise OcrError(
                    f"placement on node {n}: node fail-stopped")
            return n
        for _ in range(self.num_nodes):
            self._placement_rr = (self._placement_rr + 1) % self.num_nodes
            if self.nodes[self._placement_rr].alive:
                return self._placement_rr
        raise OcrError("no alive nodes to place on")

    def lookup(self, gid: Guid) -> Any:
        node = self.nodes[gid.node]
        obj = node.objects.get(gid)
        if obj is None:
            if not node.alive:
                raise OcrError(
                    f"object {gid} lost: node {gid.node} fail-stopped")
            raise OcrError(f"unknown or destroyed object {gid}")
        return obj

    def try_lookup(self, gid: Guid) -> Any:
        return self.nodes[gid.node].objects.get(gid)

    def resolve(self, x: Any) -> Any:
        """LID → GUID if already resolved, else the LID itself."""
        if isinstance(x, Lid):
            g = self.nodes[x.node].lid_table.get(x)
            return g if g is not None else x
        return x

    # ------------------------------------------------------ message transport

    def send(self, msg: Message, src: int, dst: int, at: Optional[float] = None) -> None:
        if self._san is not None:
            self._san.on_send(msg)
        msg.stamp(src, dst)
        when = self.clock if at is None else at
        node = self.nodes[src]
        # Fast path: a node with no outstanding LIDs can never defer, so the
        # lids() allocation+scan is skipped entirely (the common case).
        if node.unresolved_lids == 0:
            self._transmit(msg, when)
            return
        # §3: messages referencing a locally-unresolved LID are deferred on
        # the issuing node.  The *binding* lid of MCreate/MMapGet travels.
        binding = getattr(msg, "lid", None)
        unresolved = {
            l for l in msg.lids()
            if l != binding and l.node == src and node.lid_table.get(l) is None
        }
        if unresolved:
            self.stats.messages_deferred += 1
            self._log("DEFER", type(msg).__name__, "on", sorted(unresolved))
            # index under *every* unresolved lid: the patch that empties
            # _blocked_on transmits; the others just shrink the set
            msg._blocked_on = unresolved       # type: ignore[attr-defined]
            msg._deliver_at = when             # type: ignore[attr-defined]
            for l in unresolved:
                node.deferred.setdefault(l, []).append(msg)
            return
        self._transmit(msg, when)

    def _transmit(self, msg: Message, when: float) -> None:
        self.stats.messages_sent += 1
        lat = 0.0
        if msg.src_node != msg.dst_node:
            self.stats.messages_remote += 1
            lat = self.net_latency
        if self.jitter:
            lat += self.rng.uniform(0.0, self.jitter)
        binding = getattr(msg, "lid", None)
        if binding is not None and isinstance(msg, (MCreate, MMapGet)):
            self._pending_lid_msg[binding] = msg
        heapq.heappush(self._heap, (when + lat, next(self._tick), "msg", msg))

    # --------------------------------------------------------------- run loop

    def run(self, until: Optional[float] = None) -> Stats:
        """Process events until quiescent, shutdown, or ``until``."""
        while self._heap and not self.shutdown_requested:
            t, tick, kind, payload = heapq.heappop(self._heap)
            if until is not None and t > until:
                # preserve the original tick: a fresh one would reorder the
                # event against same-timestamp peers on resume
                heapq.heappush(self._heap, (t, tick, kind, payload))
                break
            if t > self.clock and self.io.inflight > 0 \
                    and self._running_tasks > 0:
                # both a disk op and a task occupy this interval: the IO
                # was hidden behind compute (the §5 overlap the async
                # queue exists to buy)
                self.stats.io_overlap_ticks += t - self.clock
            self.clock = max(self.clock, t)
            if kind == "msg":
                if payload.uid in self._cancelled:
                    continue
                self._dispatch(payload)
            elif kind == "task_end":
                self._task_end(payload)
            elif kind == "task_compute":
                # a sync-mode task finished blocking on its charged IO
                # and is computing from here on
                self._running_tasks += 1
            elif kind == "copy_flush":
                self._flush_copy_batch()
            elif kind == "io_flush":
                self.io.flush_writes()
            elif kind == "failstop_wake":
                # a survivor EDT stranded on a fail-stopped node's DB:
                # retrying the grant reaches _execute's lookup of the lost
                # block, which raises the clean fail-stop OcrError
                if payload.state == "ready" and payload.waiting_on is None \
                        and self.nodes[payload.node].alive:
                    self._try_grant(payload)
            elif kind == "db_copy":
                self._do_db_copy(payload)
        self.stats.makespan = self.clock
        self._refresh_table_stats()
        if self._san is not None:
            self._san.on_run_return()
        return self.stats

    def _refresh_table_stats(self) -> None:
        shards = hot = frag = 0
        for n in self.nodes:
            self.stats.tombstone_shards_retired += \
                n.objects.retire_event_shards()
            shards += n.objects.shard_count()
            hot += n.objects.hot_shard_count()
            frag += sum(sz for _, sz in n.spill_free)
        self.stats.table_shards = shards
        self.stats.table_hot_shards = hot
        self.stats.spill_frag_bytes = frag

    def close(self) -> None:
        """Release host resources (per-node spill files)."""
        for node in self.nodes:
            if node.spill_path is not None:
                try:
                    os.unlink(node.spill_path)
                except OSError:
                    pass
                node.spill_path = None

    def __del__(self) -> None:  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass

    def quiescent(self) -> bool:
        return not self._heap

    def kill_node(self, idx: int) -> None:
        """Fail-stop a node: lose its objects and all in-flight traffic to it.

        Fail-stop actually *loses* the node's objects: the GUID table is
        dropped wholesale (O(shards) — the sharded layout's bulk path),
        the LID table and deferred messages go with it, survivors looking
        the objects up get a clean :class:`OcrError` naming the dead node,
        and the node's spill file is reclaimed from disk.
        """
        if self._san is not None:
            self._san.on_kill_node(idx)
        node = self.nodes[idx]
        node.alive = False
        node.objects.clear()
        node.lid_table.clear()
        node.deferred.clear()
        node.unresolved_lids = 0
        # spilled buffers die with the node: fix the gauge and reclaim disk
        self.stats.spilled_objects -= node.spilled
        node.spilled = 0
        node.spill_inflight = 0
        node.compact_inflight = False
        node.resident_dbs = 0
        node.spill_tail = 0
        node.spill_free.clear()
        if node.spill_path is not None:
            try:
                os.unlink(node.spill_path)
            except OSError:
                pass
            node.spill_path = None
        # waiter queues keyed by the dead node's DBs can never be granted:
        # surviving EDTs parked there are woken so their next grant attempt
        # surfaces the clean fail-stop OcrError instead of hanging silently
        for g in [g for g in self._db_waiters if g.node == idx]:
            for edt in self._db_waiters.pop(g):
                if edt.waiting_on != g or not self.nodes[edt.node].alive:
                    continue
                edt.waiting_on = None
                heapq.heappush(self._heap, (self.clock, next(self._tick),
                                            "failstop_wake", edt))

    # ---------------------------------------------------------- msg dispatch

    def _dispatch(self, msg: Message) -> None:
        if not self.nodes[msg.dst_node].alive:
            if isinstance(msg, MIoDone):
                # the disk died with its node: the op's bytes are lost
                # (crash semantics), but the inflight accounting is not
                self.io.complete(msg.op)
            self._log("DROP (dead node)", type(msg).__name__)
            return
        handler = getattr(self, f"_on_{type(msg).__name__}")
        if self._san is None:
            handler(msg)
            return
        # the handler runs under the sender's clock snapshot (the §2
        # receive edge); handlers never own a vector-clock component
        tok = self._san.msg_begin(msg)
        try:
            handler(msg)
        finally:
            self._san.ctx_end(tok)

    # -- creation ----------------------------------------------------------

    def _on_MCreate(self, msg: MCreate) -> None:
        guid = self._create_object(msg.dst_node, msg.kind, msg.payload)
        if msg.lid is not None:
            self._pending_lid_msg.pop(msg.lid, None)
            self.send(MMap(lid=msg.lid, guid=guid), msg.dst_node, msg.lid.node)

    def _create_object(self, node: int, kind: str, payload: Dict[str, Any]) -> Guid:
        if kind == "edt":
            return self._create_edt(node, payload)
        if kind == "db":
            return self._create_db(node, payload).guid
        if kind == "event":
            return self._create_event(node, payload).guid
        raise OcrError(
            f"unsupported remote-create kind {kind!r}: only EDTs, data "
            f"blocks and events can be created on a remote node — create "
            f"the {kind} locally (or on its owner via placement at the "
            f"API call) and publish its guid, e.g. through a labeled map")

    def _create_db(self, node: int, p: Dict[str, Any]) -> DbObj:
        guid = self._alloc_guid(node, ObjectKind.DATABLOCK)
        size = p["size"]
        no_acq = bool(p.get("props", 0) & DB_PROP_NO_ACQUIRE)
        db = DbObj(guid=guid, size=size, node=node, no_acquire=no_acq)
        db.ready = True
        db.pending_deps = []
        if not no_acq:
            db.buffer = np.zeros(size, dtype=np.uint8)
            self.nodes[node].resident_dbs += 1
        self.nodes[node].objects.insert(db)
        return db

    def _create_event(self, node: int, p: Dict[str, Any]) -> EventObj:
        guid = self._alloc_guid(node, ObjectKind.EVENT)
        ev = EventObj(guid, p.get("kind", EventKind.ONCE),
                      latch_count=p.get("latch_count", 0))
        self.nodes[node].objects.insert(ev)
        return ev

    def _create_edt(self, node: int, p: Dict[str, Any]) -> Guid:
        guid = self._alloc_guid(node, ObjectKind.EDT)
        tmpl_id = self.resolve(p["template"])
        depv = [self.resolve(d) for d in p.get("depv") or []]
        depc = p["depc"]
        edt = EdtObj(
            guid=guid,
            template=tmpl_id,
            paramv=tuple(p.get("paramv") or ()),
            depc=depc,
            node=node,
            slots=[UNSET] * depc,
            modes=[DbMode.RO] * depc,
            pending=depc,
            duration=p.get("duration", 1.0),
        )
        if p.get("output_event") is not None:
            edt.output_event = p["output_event"]
        self.nodes[node].objects.insert(edt)
        if self._san is not None:
            # base clock = creation context; slot satisfies join in later
            # (NULL creation-time deps satisfy during the wiring below)
            self._san.on_task_created(guid)
        # wire creation-time dependences
        modes = p.get("dep_modes") or [DbMode.RO] * len(depv)
        for slot, (dep, mode) in enumerate(zip(depv, modes)):
            if dep is UNSET or dep == UNINITIALIZED_GUID:
                continue
            edt.modes[slot] = mode
            if is_null(dep):
                self._satisfy_slot(edt, slot, NULL_GUID)
            else:
                if isinstance(dep, Guid) and not self.nodes[dep.node].alive:
                    raise OcrError(
                        f"dependence on {dep}: node {dep.node} fail-stopped "
                        f"and its objects are lost")
                self.send(MDep(source=dep, dest=guid, slot=slot, mode=mode),
                          node, dep.node if isinstance(dep, Guid) else node)
        if edt.pending == 0 and edt.state == "created":
            edt.state = "ready"
            if self._mon is not None:
                edt.ready_time = self.clock
            self._try_grant(edt)
        return guid

    def _on_MMap(self, msg: MMap) -> None:
        self._apply_lid_binding(msg.lid, msg.guid)

    def _apply_lid_binding(self, lid: Lid, guid: Guid) -> None:
        if self._san is not None:
            self._san.on_lid_bound(lid, guid)
        node = self.nodes[lid.node]
        if node.lid_table.get(lid) is None and lid in node.lid_table:
            node.unresolved_lids -= 1
        node.lid_table[lid] = guid
        waiting = node.deferred.pop(lid, [])
        for m in waiting:
            self.stats.deferred_patched += 1
            m.patch({lid: guid})
            blocked = m._blocked_on  # type: ignore[attr-defined]
            blocked.discard(lid)
            if blocked:
                # still parked under its remaining lids — no rescan needed
                self.stats.deferred_rescans += 1
            else:
                self._transmit(m, max(self.clock, getattr(m, "_deliver_at", self.clock)))

    # -- dependences & satisfaction -----------------------------------------

    def _on_MDep(self, msg: MDep) -> None:
        src = self.resolve(msg.source)
        if isinstance(src, Lid):
            # §3: a cross-node dependence can reach dispatch before the
            # LID's binding message lands — sender-side deferral only
            # covers the *sender's* unresolved LIDs.  Park the dep at the
            # LID's home node; the binding patch retransmits it.
            home = self.nodes[src.node]
            if src in home.lid_table:
                self.stats.messages_deferred += 1
                msg._blocked_on = {src}            # type: ignore[attr-defined]
                msg._deliver_at = self.clock       # type: ignore[attr-defined]
                home.deferred.setdefault(src, []).append(msg)
                return
        if is_null(src):
            dest = self.resolve(msg.dest)
            self.send(MSatisfy(target=dest, slot=msg.slot, db=NULL_GUID, ),
                      msg.dst_node, dest.node if isinstance(dest, Guid) else msg.dst_node)
            return
        obj = self.lookup(src)
        if isinstance(obj, EventObj):
            if obj.destroyed and not obj.satisfied:
                raise OcrError(f"dependence on destroyed event {src}")
            if obj.satisfied:
                # sticky/latch by definition; once-events via tombstone
                if self._san is not None:
                    # the late dependent inherits the event's full history
                    self._san.on_event_replay(obj.guid)
                self.send(MSatisfy(target=msg.dest, slot=msg.slot, db=obj.payload),
                          msg.dst_node, self._owner(msg.dest))
            else:
                obj.dependents.append((msg.dest, msg.slot, msg.mode))
        elif isinstance(obj, DbObj):
            # §5: descriptor blocks delay satisfaction until the file opens
            if not getattr(obj, "ready", True):
                obj.pending_deps.append((msg.dest, msg.slot, msg.mode))
            else:
                self.send(MSatisfy(target=msg.dest, slot=msg.slot, db=src),
                          msg.dst_node, self._owner(msg.dest))
        else:
            raise OcrError(f"invalid dependence source {src}")
        # record the mode on the destination slot
        dest = self.resolve(msg.dest)
        if isinstance(dest, Guid) and dest.kind == ObjectKind.EDT:
            edt = self.try_lookup(dest)
            if edt is not None and msg.slot < len(edt.modes):
                edt.modes[msg.slot] = msg.mode

    def _owner(self, x: Any) -> int:
        x = self.resolve(x)
        if isinstance(x, Guid):
            return x.node
        if isinstance(x, Lid):
            return x.node
        raise OcrError(f"cannot route to {x}")

    def _on_MSatisfy(self, msg: MSatisfy) -> None:
        target = self.resolve(msg.target)
        obj = self.lookup(target)
        db = self.resolve(msg.db)
        if isinstance(obj, EventObj):
            self._satisfy_event(obj, db)
        elif isinstance(obj, EdtObj):
            self._satisfy_slot(obj, msg.slot, db)
        else:
            raise OcrError(f"cannot satisfy {target}")

    def _satisfy_event(self, ev: EventObj, db: Any) -> None:
        if self._san is not None:
            # accumulate every satisfier's clock (latch decrements included
            # — the fan-out must carry the join of all of them)
            self._san.on_event_satisfied(ev)
        if ev.kind == EventKind.LATCH:
            ev.latch_count -= 1
            if ev.latch_count > 0:
                return
        if ev.satisfied and ev.kind == EventKind.STICKY:
            return
        ev.satisfied = True
        ev.payload = db
        for (dest, slot, _mode) in ev.dependents:
            self.send(MSatisfy(target=dest, slot=slot, db=db),
                      ev.guid.node, self._owner(dest))
        if ev.kind == EventKind.ONCE:
            # fire-once, then leave a satisfiable tombstone: a dependence
            # added after the fire (reordered delivery) still receives the
            # payload instead of racing against destruction
            if not ev.destroyed:
                self.nodes[ev.guid.node].objects.note_tombstone(ev.guid)
            ev.dependents = []
            ev.destroyed = True

    def _satisfy_slot(self, edt: EdtObj, slot: int, db: Any) -> None:
        if edt.slots[slot] is not UNSET:
            raise OcrError(f"slot {slot} of {edt.guid} satisfied twice")
        if self._san is not None:
            # dependence edge: the task's base clock joins this context
            self._san.on_slot_satisfied(edt.guid)
        edt.slots[slot] = db
        edt.pending -= 1
        if edt.pending == 0:
            edt.state = "ready"
            if self._mon is not None:
                edt.ready_time = self.clock
            self._try_grant(edt)

    # -- locks & execution ---------------------------------------------------

    def _dep_dbs(self, edt: EdtObj) -> List[Tuple[DbObj, DbMode]]:
        out = []
        for s, mode in zip(edt.slots, edt.modes):
            if isinstance(s, Guid) and s.kind == ObjectKind.DATABLOCK and mode != DbMode.NULL:
                db = self.try_lookup(s)
                if db is not None:
                    out.append((db, mode))
        return out

    def _ancestors(self, db: DbObj) -> Tuple[Guid, ...]:
        # parent links are fixed at creation and a parent outlives its
        # partitions, so the chain is computed once per DB and cached
        cached = self._ancestor_cache.get(db.guid)
        if cached is not None:
            return cached
        out: List[Guid] = []
        cur = db
        while cur.parent is not None:
            out.append(cur.parent)
            cur = self.lookup(cur.parent)
        chain = tuple(out)
        self._ancestor_cache[db.guid] = chain
        return chain

    def _check_deadlock(self, deps: List[Tuple[DbObj, DbMode]]) -> None:
        guids = {d.guid for d, _ in deps}
        for d, _ in deps:
            if guids.intersection(self._ancestors(d)):
                raise PartitionDeadlockError(
                    f"task acquires data block {d.guid} and one of its ancestors "
                    f"— §6.2 forbids parent+partition in one task (deadlock)")

    def _try_grant(self, edt: EdtObj) -> Optional[Guid]:
        """Grant all locks and execute, or park on the first blocking DB.

        Returns the blocking DB's guid, or None if the task was granted.
        The deadlock check runs once per EDT per partition epoch: slots
        are frozen by the time the task is ready, so the result can only
        change when a zero-copy partition copy rewires ancestry (which
        bumps ``_partition_epoch``).
        """
        deps = self._dep_dbs(edt)
        if edt.deadlock_epoch != self._partition_epoch:
            self._check_deadlock(deps)
            edt.deadlock_epoch = self._partition_epoch
        for db, mode in deps:
            # §6.2 quiescence: a partitioned block is unavailable in any mode
            if db.partitions or not db.available(mode):
                self._enqueue_waiter(edt, db.guid)
                return db.guid
            # §5 async IO: a block whose lazy read has not landed — or
            # whose buffer was spilled cold — defers the grant through the
            # same waiter queue; the grant attempt itself issues the read
            # (file range or spill range) if read-ahead did not already
            if self.io_mode == "async" and db.buffer is None \
                    and (db.io_pending or db.lazy_file_read or db.spilled):
                self._start_read(db)
                self._enqueue_waiter(edt, db.guid)
                return db.guid
        for db, mode in deps:
            db.last_touch = self.clock      # access recency for the spill policy
            if mode in (DbMode.RO, DbMode.CONST):
                db.readers += 1
            elif mode in (DbMode.RW, DbMode.EW):
                db.writer = edt.guid
                db.dirty = True
                db.version += 1     # an in-flight spill snapshot is now stale
        if self._san is not None:
            # birth of the task's vector-clock activity: base = creation ∨
            # slot satisfies ∨ acquired locks' release clocks; its accesses
            # are recorded against the §6 root blocks here
            self._san.on_grant(edt, deps)
        self._execute(edt)
        return None

    def _enqueue_waiter(self, edt: EdtObj, db_guid: Guid) -> None:
        if edt.waiting_on is not None:
            return
        edt.waiting_on = db_guid
        self._db_waiters.setdefault(db_guid, collections.deque()).append(edt)

    def _wake_waiters(self, db_guid: Guid) -> None:
        """Retry waiters of one DB in FIFO order after its state changed.

        Stops at the first waiter that re-blocks on this same DB: the head
        keeps its place (no starvation of writers behind a reader stream)
        and the tail is not pointlessly retried — one release wakes O(1)
        grantable tasks instead of re-running _try_grant for every waiter.
        """
        # re-fetch the queue every iteration: granting a waiter runs its
        # task body synchronously, which can re-enter _wake_waiters for
        # this same DB and replace (or delete) the deque under us
        while True:
            queue = self._db_waiters.get(db_guid)
            if not queue:
                break
            edt = queue[0]
            if edt.waiting_on != db_guid:
                queue.popleft()        # stale: re-queued elsewhere meanwhile
                continue
            queue.popleft()
            edt.waiting_on = None
            if edt.state != "ready":
                continue
            if not self.nodes[edt.node].alive:
                continue               # a fail-stopped node's EDT never runs
            self.stats.waiter_wakeups += 1
            if self._try_grant(edt) == db_guid:
                # re-blocked: _enqueue_waiter appended it; restore its FIFO
                # head position, then stop retrying the rest — except for a
                # bounded batch of RO waiters that can share the block now
                queue = self._db_waiters.get(db_guid)
                if queue and queue[-1] is edt:
                    queue.pop()
                    queue.appendleft(edt)
                self._reader_batch_grant(db_guid)
                break
        queue = self._db_waiters.get(db_guid)
        if queue is not None and not queue:
            self._db_waiters.pop(db_guid, None)

    def _waits_ro_only(self, edt: EdtObj, db_guid: Guid) -> bool:
        modes = [m for s, m in zip(edt.slots, edt.modes)
                 if isinstance(s, Guid) and s == db_guid]
        return bool(modes) and all(m in (DbMode.RO, DbMode.CONST)
                                   for m in modes)

    def _reader_batch_grant(self, db_guid: Guid) -> None:
        """Bounded reader barging (ROADMAP "waiter-queue mode awareness").

        The FIFO head just re-blocked — typically a writer waiting out the
        current readers.  If the DB is readable right now, RO waiters
        queued *behind* that head could share it without delaying the head
        at all (readers don't conflict with readers).  The cap is per
        blocked *head*, not per wake: ``head.barged_past`` accumulates
        across wakes, so at most ``reader_batch_bound`` readers ever
        overtake one waiting task no matter how sustained the reader
        stream is — bounded barging, no starvation.  Each grant counts in
        ``Stats.reader_batch_grants``.
        """
        bound = self.reader_batch_bound
        if bound <= 0:
            return
        db = self.try_lookup(db_guid)
        if db is None or db.partitions or not db.available(DbMode.RO):
            return
        queue = self._db_waiters.get(db_guid)
        if queue is None or len(queue) < 2:
            return
        head = queue[0]
        if head.barged_past >= bound:
            return
        granted = 0
        bound = bound - head.barged_past
        # snapshot a bounded window: grants run task bodies synchronously,
        # which can re-enter the wake machinery and mutate the live deque
        window = list(queue)[1: 1 + 8 * bound]
        for cand in window:
            if granted >= bound:
                break
            if cand.waiting_on != db_guid or cand.state != "ready" \
                    or not self.nodes[cand.node].alive \
                    or not self._waits_ro_only(cand, db_guid):
                continue
            live = self._db_waiters.get(db_guid)
            if live is None:
                break
            try:
                live.remove(cand)
            except ValueError:
                continue
            cand.waiting_on = None
            self.stats.waiter_wakeups += 1
            blocked_on = self._try_grant(cand)
            if blocked_on is None:
                granted += 1
                head.barged_past += 1
                self.stats.reader_batch_grants += 1
            elif blocked_on == db_guid:
                break          # a reentrant wake changed the DB's state
            # else: parked on a different DB; keep scanning
            db = self.try_lookup(db_guid)
            if db is None or db.partitions or not db.available(DbMode.RO):
                break

    def _start_read(self, db: DbObj) -> None:
        """Enqueue the §5 lazy read of ``db`` on its node's IO queue.

        A spilled block re-materializes through the same machinery: the
        read targets the node's spill file instead of a §5 user file, and
        waiters wake from the same ``MIoDone`` an IO-pending chunk uses.
        """
        if db.io_pending or db.buffer is not None:
            return
        if db.spilled:
            node = self.nodes[db.guid.node]
            self.io.submit_read(db, None, path=node.spill_path,
                                offset=db.spill_offset)
            self._log("IO unspill", db.guid, f"[{db.spill_offset},+{db.size})")
            return
        if db.file_guid is None:
            return
        f: FileObj = self.lookup(db.file_guid)
        self.io.submit_read(db, f)
        self._log("IO read", db.guid, f"[{db.file_offset},+{db.size})")

    def _materialize(self, db: DbObj) -> np.ndarray:
        """Synchronous materialization (zero virtual-time charge).

        EDT acquisitions never reach this with an unread file chunk or a
        spilled buffer — the grant defers until the async read lands (or,
        in sync mode, ``_execute`` charges the read to the task's blocking
        time).  The remaining callers (§6.3 copies, ``db_partition``,
        descriptor fill) keep the seed's immediate-read semantics.
        """
        if db.buffer is None:
            if db.spilled:
                node = self.nodes[db.guid.node]
                db.buffer = _read_file_region(node.spill_path,
                                              db.spill_offset, db.size)
                self._clear_spill(db)
            elif db.lazy_file_read and db.file_guid is not None:
                f: FileObj = self.lookup(db.file_guid)
                db.buffer = _read_file_region(f.path, db.file_offset, db.size)
                self.stats.file_bytes_read += db.size
                db.lazy_file_read = False
            else:
                db.buffer = np.zeros(db.size, dtype=np.uint8)
            # views never reach here (they alias a live parent buffer),
            # so the block now owns its buffer
            self.nodes[db.guid.node].resident_dbs += 1
        return db.buffer

    def _clear_spill(self, db: DbObj) -> None:
        """Drop ``db``'s spilled status (re-materialized or destroyed) and
        return its spill-file slot to the node's free list."""
        db.spilled = False
        if self._san is not None:
            self._san.on_unspill(db.guid)
        node = self.nodes[db.guid.node]
        node.spilled = max(0, node.spilled - 1)
        node.objects.note_unspilled(db.guid)
        self.stats.spilled_objects -= 1
        if db.spill_offset >= 0:
            self._spill_release(node, db.spill_offset, db.size)
            db.spill_offset = -1

    def _execute(self, edt: EdtObj) -> None:
        edt.state = "running"
        edt.start_time = self.clock
        tmpl: TemplateObj = self.lookup(edt.template)
        depv = []
        io_wait = 0.0
        for s, mode in zip(edt.slots, edt.modes):
            if isinstance(s, Guid) and s.kind == ObjectKind.DATABLOCK:
                db = self.lookup(s)
                if self.io_mode == "sync" and db.buffer is None:
                    # sync baseline: the reads happen inside the task's
                    # window, charged per chunk to its blocking time.
                    # charge_sync returns (op done - now): ops on one
                    # node's disk queue already serialize against each
                    # other, so the task blocks until the *latest* one —
                    # max, not sum (summing double-counts the queueing).
                    # Spilled blocks charge their spill-file read the
                    # same way, keeping the sync-vs-async comparison fair
                    if db.spilled:
                        sn = self.nodes[db.guid.node]
                        io_wait = max(io_wait, self.io.charge_sync(
                            db, None, "read", path=sn.spill_path,
                            offset=db.spill_offset))
                    elif db.lazy_file_read and db.file_guid is not None:
                        f: FileObj = self.lookup(db.file_guid)
                        io_wait = max(io_wait,
                                      self.io.charge_sync(db, f, "read"))
                buf = self._materialize(db)
                if mode in (DbMode.RO, DbMode.CONST):
                    view = buf.view()
                    view.setflags(write=False)
                else:
                    view = buf
                depv.append(DepEntry(guid=s, ptr=view, mode=mode))
            else:
                depv.append(DepEntry(guid=s if isinstance(s, Guid) else NULL_GUID,
                                     ptr=None, mode=mode))
        ctx = TaskCtx(self, edt.node, edt)
        ctx.blocking_time += io_wait
        if io_wait > 0:
            # the task spends [now, now + io_wait) blocked on its own
            # charged IO — that is not compute, so it must not count
            # toward io_overlap_ticks until the wait elapses
            heapq.heappush(self._heap, (self.clock + io_wait,
                                        next(self._tick), "task_compute", None))
        else:
            self._running_tasks += 1
        self._log("RUN", edt.guid, tmpl.func.__name__)
        if self._san is None:
            ret = tmpl.func(list(edt.paramv), depv, ctx)
        else:
            # the body runs under its own activity; nested synchronous
            # grants (API calls that grant immediately) stack correctly
            tok = self._san.task_begin(edt.guid)
            try:
                ret = tmpl.func(list(edt.paramv), depv, ctx)
            finally:
                self._san.ctx_end(tok)
        self.stats.tasks_executed += 1
        end = edt.start_time + edt.duration + ctx.blocking_time
        edt.end_time = end
        if self._mon is not None:
            # per-EDT-class latency histograms: virtual time spent
            # ready-but-ungranted, and the task's occupied window
            self._mon.on_edt(
                tmpl.func.__name__,
                edt.start_time - edt.ready_time if edt.ready_time >= 0.0
                else 0.0,
                end - edt.start_time)
        heapq.heappush(self._heap, (end, next(self._tick), "task_end", (edt.guid, ret)))

    def _task_end(self, payload: Tuple[Guid, Any]) -> None:
        guid, ret = payload
        self._running_tasks = max(0, self._running_tasks - 1)
        edt: Optional[EdtObj] = self.try_lookup(guid)
        if edt is None:
            # the EDT's node fail-stopped mid-execution (e.g. the body
            # itself called kill_node): nothing retires, nothing satisfies
            # — locks it held on surviving nodes' blocks stay held, the
            # standard fail-stop hazard a recovery layer must handle
            if self._san is not None:
                self._san.task_lost(guid)
            return
        if self._san is None:
            self._task_retire(guid, ret, edt)
            return
        # retirement (lock releases, output-event satisfy, wakes) runs
        # under the task's clock, one tick past the body; the clock then
        # folds into the driver's join set at run() return
        tok = self._san.task_end_begin(guid)
        try:
            self._task_retire(guid, ret, edt)
        finally:
            self._san.task_end_finish(guid, tok)

    def _task_retire(self, guid: Guid, ret: Any, edt: EdtObj) -> None:
        released: List[DbObj] = []
        for db, mode in self._dep_dbs(edt):
            if mode in (DbMode.RO, DbMode.CONST):
                db.readers = max(0, db.readers - 1)
                if self._san is not None:
                    self._san.on_release(db, False)
            elif db.writer == guid:
                db.writer = None
                if self._san is not None:
                    self._san.on_release(db, True)
            if db.pending_destroy and not db.locked():
                self._destroy_db(db)   # wakes its waiters itself
            else:
                released.append(db)
        edt.state = "done"
        # releases can turn blocks spillable: invalidate the fruitless-scan
        # guard of every node whose lock state just changed, and run the
        # spill check there too — a pure data-holder node whose blocks are
        # only ever locked by remote tasks has no retirements of its own
        spill_nodes = {edt.node}
        for db in released:
            self.nodes[db.guid.node].spill_scan_at = -1.0
            spill_nodes.add(db.guid.node)
        if edt.output_event is not None:
            ret_r = self.resolve(ret) if ret is not None else NULL_GUID
            if isinstance(ret_r, Guid) and ret_r.kind == ObjectKind.EVENT and not is_null(ret_r):
                self.send(MDep(source=ret_r, dest=edt.output_event, slot=0,
                               mode=DbMode.RO), edt.node, ret_r.node)
            else:
                self.send(MSatisfy(target=edt.output_event, slot=0,
                                   db=ret_r if isinstance(ret_r, Guid) else NULL_GUID),
                          edt.node, self._owner(edt.output_event))
        self.nodes[edt.node].objects.pop(guid, None)
        # wake only waiters of the DBs whose lock state actually changed
        for db in released:
            self._wake_waiters(db.guid)
        # task retirement is the spill checkpoint: blocks it released are
        # idle now, and no task body is mid-execution anywhere (the DES
        # runs bodies atomically), so buffers snapshot consistently
        for n in sorted(spill_nodes):
            self._maybe_spill(n)

    # -- cold-object spill ---------------------------------------------------

    def spill_check(self, node_idx: int) -> None:
        """Public eviction hook: re-run the spill policy on ``node_idx`` now.

        The serve engine calls this after demoting a session's pages into
        its archive block — the archive is brand-new resident memory the
        task-retirement trigger hasn't seen yet."""
        self.nodes[node_idx].spill_scan_at = -1.0
        self._maybe_spill(node_idx)

    def _maybe_spill(self, node_idx: int) -> None:
        """Spill cold data blocks if ``node_idx`` is over ``spill_threshold``.

        Policy: when a node holds more buffer-resident data blocks than the
        threshold, idle unlocked ones (no lock holders, no waiters, no live
        partitions, not a §6 view, no IO in flight) are written back to the
        node's private spill file, least-recently-granted first, until the
        resident count is back under the threshold or no candidates remain.
        Contiguously-placed victims share one IO-queue write op.  The
        buffer is dropped only when the spill op *completes*, so a halted
        ``run(until)`` or a fail-stop loses exactly the in-flight spill
        ops, never object payloads (the IO queue's crash contract).
        """
        thr = self.spill_threshold
        if thr is None:
            return
        node = self.nodes[node_idx]
        if not node.alive:
            return
        if node.compact_inflight:
            # a compaction sweep owns the file layout (it will clear the
            # free list and shrink the tail at completion); new spills
            # wait for the sweep's MIoDone rather than allocating into it
            return
        # resident_dbs counts blocks owning their buffer (views alias a
        # parent's memory; spilled/unread/write_only/no_acquire hold none)
        # and is maintained incrementally, so this threshold check is O(1)
        # per task retirement; blocks with a spill op already in flight are
        # being drained and don't count against the threshold again
        need = node.resident_dbs - node.spill_inflight - thr
        if need <= 0:
            return
        if node.spill_scan_at == self.clock:
            # the last scan at this timestamp found nothing spillable and
            # nothing was released since (releases clear the guard) —
            # skip the O(objects) victim walk
            return
        # access-recency policy: least-recently-granted first (ties broken
        # by creation order, the old oldest-seq policy).  A hot old block —
        # a long-lived serve session's pages — now outlives colder younger
        # ones instead of being evicted for merely being old.
        cands = []
        for _idx, shard in node.objects.shards(ObjectKind.DATABLOCK):
            cands.extend(o for o in shard.objs.values() if self._spillable(o))
        if not cands:
            node.spill_scan_at = self.clock
            return
        cands.sort(key=lambda d: (d.last_touch, d.guid.seq))
        self._spill_shard(node, cands[:need])   # never spill below threshold

    def _spillable(self, db: Any) -> bool:
        return (isinstance(db, DbObj) and db.buffer is not None
                and not db.spilled and not db.spilling and not db.io_pending
                and not db.locked() and not db.partitions and not db.is_view
                and not db.pending_destroy and not db.destroyed
                and getattr(db, "ready", True)
                and not self._db_waiters.get(db.guid))

    def _spill_alloc(self, node: _Node, size: int) -> int:
        """Place ``size`` spill bytes: first-fit from the free list of
        holes left by re-materialized/destroyed victims, else bump the
        tail.  Reuse counts in ``Stats.spill_slots_reused``."""
        for i, (off, sz) in enumerate(node.spill_free):
            if sz >= size:
                if sz == size:
                    node.spill_free.pop(i)
                else:
                    node.spill_free[i] = (off + size, sz - size)
                self.stats.spill_slots_reused += 1
                return off
        off = node.spill_tail
        node.spill_tail += size
        return off

    def _spill_release(self, node: _Node, off: int, size: int) -> None:
        """Return a spill-file range to the free list, coalescing adjacent
        holes; a hole ending at the tail shrinks the high-water mark."""
        if off < 0 or size <= 0:
            return
        holes = sorted(node.spill_free + [(off, size)])
        merged: List[Tuple[int, int]] = []
        for o, s in holes:
            if merged and merged[-1][0] + merged[-1][1] == o:
                merged[-1] = (merged[-1][0], merged[-1][1] + s)
            else:
                merged.append((o, s))
        if merged and merged[-1][0] + merged[-1][1] == node.spill_tail:
            node.spill_tail = merged.pop()[0]
        node.spill_free = merged
        if self.spill_compact_threshold is not None:
            self._maybe_compact(node)

    def _spill_shard(self, node: _Node, victims: List[DbObj]) -> None:
        """Serialize cold blocks into the node's spill file through the §5
        IO queue.  Offsets come from the free list first (slot reuse),
        then the tail; victims placed contiguously share one disk op."""
        if node.spill_path is None:
            fd, path = tempfile.mkstemp(prefix=f"ocr-spill-n{node.idx}-",
                                        suffix=".bin")
            os.close(fd)
            node.spill_path = path
        placed: List[Tuple[DbObj, int, bytes]] = []
        for db in victims:
            data = db.buffer.tobytes()
            placed.append((db, self._spill_alloc(node, len(data)), data))
            db.spilling = True
        node.spill_inflight += len(victims)
        placed.sort(key=lambda t: t[1])

        def _flush(run: List[Tuple[DbObj, int, bytes]]) -> None:
            meta = [(db.guid, off, len(data), db.version)
                    for db, off, data in run]
            self.io.submit_spill(node.idx, node.spill_path, run[0][1],
                                 b"".join(d for _, _, d in run), meta)

        run: List[Tuple[DbObj, int, bytes]] = []
        for entry in placed:
            if run and run[-1][1] + len(run[-1][2]) != entry[1]:
                _flush(run)
                run = []
            run.append(entry)
        if run:
            _flush(run)
        if self._san is not None:
            self._san.on_spill(len(victims), node.idx)
        self._log("SPILL", len(victims), "blocks ->", node.spill_path)

    def _finish_spill(self, op: Any) -> None:
        """A shard's spill op completed: the OS write happens now, and each
        victim that stayed cold drops its buffer.  Victims that got hot
        again (acquired, destroyed, re-versioned by a write or copy) abort
        — their bytes in the spill file are simply never referenced."""
        if not op.performed and op.data is not None:
            _write_file_region(op.path, op.offset,
                               np.frombuffer(op.data, dtype=np.uint8))
        for gid, off, _size, version in op.victims:
            node = self.nodes[gid.node]
            node.spill_inflight = max(0, node.spill_inflight - 1)
            db = self.try_lookup(gid)
            if db is None or not isinstance(db, DbObj) or not db.spilling:
                if node.alive:      # reclaim the slot reserved at submit
                    self._spill_release(node, off, _size)
                continue
            db.spilling = False
            if (db.version != version or db.locked() or db.partitions
                    or db.buffer is None or db.pending_destroy
                    or self._db_waiters.get(gid)):
                # hot again: keep the live buffer, free the reserved slot
                self._spill_release(node, off, _size)
                continue
            db.buffer = None
            db.spilled = True
            db.spill_offset = off
            node.spilled += 1
            node.resident_dbs -= 1
            node.objects.note_spilled(gid)
            self.stats.spilled_objects += 1
        self._log("SPILLED", len(op.victims), "victims (op done)")

    def _maybe_compact(self, node: _Node) -> None:
        """On-line spill-file compaction (the ROADMAP 'remaining' item):
        when the free-list holes exceed ``spill_compact_threshold`` as a
        fraction of the bump pointer, submit one IO-queue sweep that will
        rewrite every live slot packed from offset 0 and shrink the tail.

        The plan is snapshotted at submit (guid, old offset, new offset,
        size, version per victim) and only attempted when the node is
        quiescent on the spill front — no spill writes in flight, no
        unspill read pending on any live slot — so the sweep either
        applies exactly or aborts wholesale at completion."""
        thr = self.spill_compact_threshold
        if (thr is None or node.compact_inflight or not node.alive
                or node.spilled == 0 or node.spill_inflight > 0
                or node.spill_path is None or node.spill_tail <= 0):
            return
        frag = sum(sz for _off, sz in node.spill_free)
        if frag <= 0 or frag < thr * node.spill_tail:
            return
        live: List[DbObj] = []
        for _idx, shard in node.objects.shards(ObjectKind.DATABLOCK):
            for o in shard.objs.values():
                if isinstance(o, DbObj) and o.spilled and not o.destroyed:
                    if o.io_pending:
                        return      # an unspill read is mid-flight: retry
                    live.append(o)  # on the next release
        if not live:
            return
        live.sort(key=lambda d: d.spill_offset)
        plan: List[Tuple[Guid, int, int, int, int]] = []
        cursor = 0
        for db in live:
            plan.append((db.guid, db.spill_offset, cursor, db.size,
                         db.version))
            cursor += db.size
        if all(old == new for _g, old, new, _s, _v in plan):
            return
        node.compact_inflight = True
        self.io.submit_compact(node.idx, node.spill_path, plan, cursor)
        self._log("COMPACT", node.idx,
                  f"{frag}B holes / {node.spill_tail}B tail,"
                  f" {len(plan)} live slots")

    def _finish_compact(self, op: Any) -> None:
        """The compaction sweep's disk slot completed: re-verify the plan
        (every victim still spilled at its snapshot offset and version,
        no read in flight — any mismatch aborts the whole sweep, since a
        concurrent unspill may be reading the old layout), then move live
        slots down in offset order (moves are strictly downward, so
        in-place is safe), clear the free list, and shrink the tail."""
        node = self.nodes[op.node]
        node.compact_inflight = False
        if not node.alive or node.spill_path is None:
            return
        moves: List[Tuple[DbObj, int, int, int]] = []
        for gid, old, new, size, version in op.victims:
            db = self.try_lookup(gid)
            if (db is None or not isinstance(db, DbObj) or not db.spilled
                    or db.io_pending or db.spill_offset != old
                    or db.version != version):
                self._log("COMPACT abort", node.idx, gid)
                # the layout changed under the sweep (a victim was
                # destroyed or is being read back); re-plan immediately
                # against the current free list — if a read is still in
                # flight the re-plan defers to that read's release
                self._maybe_compact(node)
                return
            moves.append((db, old, new, size))
        for db, old, new, size in moves:
            if new != old:
                data = _read_file_region(node.spill_path, old, size)
                _write_file_region(node.spill_path, new, data)
                db.spill_offset = new
        node.spill_free = []
        node.spill_tail = op.size
        try:
            with open(node.spill_path, "r+b") as f:
                f.truncate(op.size)
        except OSError:
            pass
        self.stats.spill_compactions += 1
        self._refresh_table_stats()
        self._log("COMPACTED", node.idx, f"tail -> {op.size}B")
        # spills deferred while the sweep was in flight can go now
        node.spill_scan_at = -1.0
        self._maybe_spill(node.idx)

    # -- destruction ---------------------------------------------------------

    def _on_MDestroy(self, msg: MDestroy) -> None:
        self.destroy(self.resolve(msg.target))

    def destroy(self, gid: Guid) -> None:
        obj = self.try_lookup(gid)
        if obj is None:
            return
        if isinstance(obj, DbObj):
            if obj.locked() or obj.partitions:
                # acquired by a running task, or has live partitions (§6.2):
                # defer destruction until release / last partition destroyed
                obj.pending_destroy = True
                return
            self._destroy_db(obj)
        else:
            obj.destroyed = True
            self.nodes[gid.node].objects.pop(gid, None)

    def _destroy_db(self, db: DbObj) -> None:
        if db.partitions:
            raise OcrError(f"destroying {db.guid} while partitions are live")
        if self._san is not None:
            # checks §6.2 child-first order against the sanitizer's own
            # registry; a destroyed partition folds its lock history into
            # the parent's release clock (quiescence edge)
            self._san.on_db_destroyed(db)
        if db.spilled:
            if db.file_guid is not None and db.dirty:
                # a dirty §5 chunk must write back its real contents below:
                # re-materialize from the spill file first
                self._materialize(db)
            else:
                self._clear_spill(db)   # accounting only; bytes are dead
        # copies issued before a same-timestamp destroy must land first
        # (batching must not reorder them past the destruction)
        if self._copy_batch and any(
                db.guid in (self.resolve(m.src), self.resolve(m.dst))
                for m in self._copy_batch):
            self._flush_copy_batch()
        # unlink from parent partition table
        if db.parent is not None:
            parent = self.try_lookup(db.parent)
            if parent is not None:
                parent.partitions.pop(db.guid, None)
                if not parent.partitions:
                    parent.static_partitioning = False
                    if parent.pending_destroy and not parent.locked():
                        self._destroy_db(parent)
                    else:
                        # last partition gone: the parent is acquirable again
                        self._wake_waiters(parent.guid)
        # §5 write-back: dirty chunks flush; enlarging chunks enlarge.
        # Async mode enqueues the write on the node's IO queue (adjacent
        # dirty ranges coalesce; the OS write lands at completion time);
        # sync mode writes here, charging the same per-chunk latency.
        if db.file_guid is not None:
            f: FileObj = self.lookup(db.file_guid)
            if db.dirty and f.writable and db.buffer is not None:
                if self.io_mode == "async":
                    self.io.submit_write(db, f)
                else:
                    self.io.charge_sync(db, f, "write")
                    _write_file_region(f.path, db.file_offset, db.buffer)
                    self.stats.file_bytes_written += db.size
            elif f.writable and db.file_offset + db.size > _file_size(f.path):
                _enlarge_file(f.path, db.file_offset + db.size)
            f.drop_chunk(db.guid)
            if f.released and not f.chunks:
                f.closed = True
        db.destroyed = True
        if db.buffer is not None and not db.is_view:
            self.nodes[db.guid.node].resident_dbs -= 1
        self.nodes[db.guid.node].objects.pop(db.guid, None)
        self._ancestor_cache.pop(db.guid, None)
        # waiters parked on a destroyed DB retry with the dep dropped
        self._wake_waiters(db.guid)

    # -- labeled maps (§4) ----------------------------------------------------

    def _on_MMapGet(self, msg: MMapGet) -> None:
        map_id = self.resolve(msg.map_id)
        m = self.try_lookup(map_id) if isinstance(map_id, Guid) else None
        # a map_get racing a map_destroy must fail clean, not touch the
        # destroyed map's entries/creator (AttributeError / stale creator)
        if m is None or not isinstance(m, MapObj) or m.destroyed:
            raise OcrError(
                f"map_get on destroyed or unknown map {map_id} "
                f"(index {msg.index}): the map was destroyed before the "
                f"get arrived")
        if not (0 <= msg.index < m.size):
            raise OcrError(f"map index {msg.index} out of range [0,{m.size})")
        created = msg.index not in m.entries
        if msg.index not in m.entries:
            # exactly-once creation, synchronized at the owning node
            m.creator_calls += 1
            self.stats.creator_calls += 1
            object_lid = self._alloc_lid(m.guid.node)
            ctx = TaskCtx(self, m.guid.node, None)
            ctx._mapped_lid = object_lid
            m.creator(ctx, object_lid, msg.index, list(m.paramv), list(m.guidv))
            bound = self.nodes[m.guid.node].lid_table.get(object_lid)
            if bound is None:
                raise OcrError(
                    "creator function must create the object with "
                    "EDT_PROP_MAPPED binding the provided LID")
            m.entries[msg.index] = bound
        guid = m.entries[msg.index]
        if self._san is not None:
            # §4: exactly-once creation, memoized reuse per index
            self._san.on_map_get(m, msg.index, created, guid)
        if msg.lid is not None:
            self._pending_lid_msg.pop(msg.lid, None)
            self.send(MMap(lid=msg.lid, guid=guid), msg.dst_node, msg.lid.node)

    # -- db copy (§6.3) --------------------------------------------------------

    def _on_MDbCopy(self, msg: MDbCopy) -> None:
        # Materialized range copies (plain, or §6.3 partition copies that do
        # not take the zero-copy view path) are batched: all copies landing
        # at the same virtual timestamp flush together, one fused kernel
        # launch per (src, dst) pair, instead of one launch per partition.
        if self._is_batchable_copy(msg):
            self._copy_batch.append(msg)
            if not self._copy_flush_scheduled:
                self._copy_flush_scheduled = True
                heapq.heappush(self._heap,
                               (self.clock, next(self._tick), "copy_flush", None))
            return
        # a non-batchable copy (zero-copy view, PARTITION_BACK) executes
        # immediately; land earlier-arrived batched copies first so the
        # batch cannot be reordered past it (arrival-order semantics)
        if self._copy_batch:
            self._flush_copy_batch()
        self._do_db_copy(msg)

    def _is_batchable_copy(self, msg: MDbCopy) -> bool:
        if msg.copy_type == DB_COPY_PARTITION_BACK:
            return False       # entails destruction of src: keep synchronous
        if msg.copy_type == DB_COPY_PARTITION:
            dst: DbObj = self.lookup(self.resolve(msg.dst))
            whole_dst = msg.dst_offset == 0 and msg.size == dst.size
            if dst.no_acquire and whole_dst and dst.buffer is None:
                return False   # zero-copy view path: no bytes move
        return True

    def _flush_copy_batch(self) -> None:
        batch, self._copy_batch = self._copy_batch, []
        self._copy_flush_scheduled = False
        if not batch:
            return
        resolved = [(self.resolve(m.src), self.resolve(m.dst), m)
                    for m in batch]
        # Grouping by (src, dst) reorders copies across groups, which is
        # only sound when arrival order cannot matter: no copy reads a DB
        # another copy writes, and no destination byte is written twice.
        # Otherwise replay the batch sequentially (seed semantics:
        # last-writer-wins in arrival order, reads see earlier writes).
        dst_ids = {d for _, d, _ in resolved}
        ordered = any(s in dst_ids for s, _, _ in resolved)
        if not ordered:
            by_dst: Dict[Guid, List[Tuple[int, int]]] = {}
            for _, d, m in resolved:
                by_dst.setdefault(d, []).append(
                    (m.dst_offset, m.dst_offset + m.size))
            ordered = any(spans_overlap(s) for s in by_dst.values())
        if ordered:
            for src_id, dst_id, m in resolved:
                tok = self._san.copy_begin(m) if self._san is not None else None
                try:
                    src = self.lookup(src_id)
                    dst = self.lookup(dst_id)
                    if self._san is not None:
                        self._san.on_copy_access(src, m.src_offset, m.size, False)
                        self._san.on_copy_access(dst, m.dst_offset, m.size, True)
                    sbuf = self._materialize(src)
                    dbuf = self._materialize(dst)
                    dst.version += 1
                    dbuf[m.dst_offset: m.dst_offset + m.size] = \
                        sbuf[m.src_offset: m.src_offset + m.size]
                    self._copy_done(m)
                finally:
                    if tok is not None:
                        self._san.copy_end(tok)
            return
        groups: Dict[Tuple[Guid, Guid], List[MDbCopy]] = {}
        for src_id, dst_id, msg in resolved:
            groups.setdefault((src_id, dst_id), []).append(msg)
        for (src_id, dst_id), msgs in groups.items():
            src: DbObj = self.lookup(src_id)
            dst: DbObj = self.lookup(dst_id)
            sbuf = self._materialize(src)
            dbuf = self._materialize(dst)
            dst.version += 1
            ranges = [(m.dst_offset, m.src_offset, m.size) for m in msgs]
            if not self._fused_copy(dbuf, sbuf, ranges):
                for (d_off, s_off, size) in ranges:
                    dbuf[d_off: d_off + size] = sbuf[s_off: s_off + size]
            for m in msgs:
                if self._san is None:
                    self._copy_done(m)
                    continue
                tok = self._san.copy_begin(m)
                try:
                    self._san.on_copy_access(src, m.src_offset, m.size, False)
                    self._san.on_copy_access(dst, m.dst_offset, m.size, True)
                    self._copy_done(m)
                finally:
                    self._san.copy_end(tok)

    def _copy_done(self, m: MDbCopy) -> None:
        self.stats.bytes_copied += m.size
        ev = self.resolve(m.completion_event)
        if isinstance(ev, Guid) and not is_null(ev):
            self.send(MSatisfy(target=ev, slot=0, db=NULL_GUID),
                      m.dst_node, ev.node)

    def _check_copy_device(self) -> None:
        """A "cuda" copy backend needs its device now: no card, or kernels
        that do not build, raise here instead of at the first copy."""
        import torch

        from ..kernels import _build
        dev = torch.device(self.copy_device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("copy_backend='cuda' on copy_device="
                                   f"{self.copy_device!r}: no CUDA device")
            _build.load()
        elif dev.type != "cpu":
            raise ValueError(f"copy_device={self.copy_device!r}: 'cuda' or "
                             "'cpu'")

    def _fused_copy(self, dbuf: np.ndarray, sbuf: np.ndarray,
                    ranges: List[Tuple[int, int, int]]) -> bool:
        """Route a multi-range copy through the fused partition-copy kernel
        (K7, or K8 above the staging threshold) in one launch.

        Returns False (caller takes the numpy path) unless the backend is
        "cuda", the batch is big enough to amortize a launch, every range
        is lane-aligned (128 B) and non-empty, and destinations are
        disjoint (overlaps need the sequential last-writer-wins semantics
        of the numpy path).  Both buffers move to ``copy_device``, the
        kernel runs, and dst comes back into ``dbuf``.
        """
        if self.copy_backend != "cuda" or len(ranges) < 2:
            return False
        if any(d % 128 or s % 128 or n % 128 or n <= 0 for d, s, n in ranges):
            return False
        if spans_overlap((d, d + n) for d, _, n in ranges):
            return False
        import torch

        from ..kernels import ops
        # copies even on the CPU: a §6 partition's buffer may be a view of
        # the other block's, and every range must read the original src
        host_dst = torch.from_numpy(dbuf)
        dst = host_dst.to(self.copy_device, copy=True)
        src = torch.from_numpy(sbuf).to(self.copy_device, copy=True)
        ops.multi_partition_copy_bytes_(dst, src, tuple(ranges))
        host_dst.copy_(dst)
        self.stats.fused_copies += 1
        return True

    def _do_db_copy(self, msg: MDbCopy) -> None:
        if self._san is None:
            self._do_db_copy_inner(msg)
            return
        tok = self._san.copy_begin(msg)
        try:
            self._do_db_copy_inner(msg)
        finally:
            self._san.copy_end(tok)

    def _do_db_copy_inner(self, msg: MDbCopy) -> None:
        dst: DbObj = self.lookup(self.resolve(msg.dst))
        src: DbObj = self.lookup(self.resolve(msg.src))
        if msg.copy_type == DB_COPY_PARTITION:
            whole_dst = msg.dst_offset == 0 and msg.size == dst.size
            if dst.no_acquire and whole_dst and dst.buffer is None:
                # zero-copy: dst becomes a partition view of src (COW)
                if src.overlaps(msg.src_offset, msg.size):
                    raise PartitionOverlapError(
                        f"copy-partition [{msg.src_offset},+{msg.size}) overlaps "
                        f"a live partition of {src.guid}")
                buf = self._materialize(src)
                dst.buffer = buf[msg.src_offset: msg.src_offset + msg.size]
                dst.is_view = True
                dst.parent = src.guid
                dst.offset_in_parent = msg.src_offset
                src.partitions[dst.guid] = (msg.src_offset, msg.size)
                if self._san is not None:
                    # no bytes move: register the §6 child, no access
                    self._san.on_partition_create(
                        src, [(dst.guid, msg.src_offset, msg.size)],
                        zero_copy=True)
                # the view can mutate src's bytes without touching src's
                # lock state: an in-flight spill snapshot of src is stale
                src.version += 1
                self.stats.bytes_zero_copy += msg.size
                # dst gained an ancestor: cached chains keyed by (or passing
                # through) dst are stale, and every EDT's cached §6.2 result
                # may be too — bump the epoch so retries re-check lazily
                self._ancestor_cache = {
                    g: ch for g, ch in self._ancestor_cache.items()
                    if g != dst.guid and dst.guid not in ch}
                self._partition_epoch += 1
            else:
                if self._san is not None:
                    self._san.on_copy_access(src, msg.src_offset, msg.size, False)
                    self._san.on_copy_access(dst, msg.dst_offset, msg.size, True)
                sbuf = self._materialize(src)
                dbuf = self._materialize(dst)
                dst.version += 1
                dbuf[msg.dst_offset: msg.dst_offset + msg.size] = \
                    sbuf[msg.src_offset: msg.src_offset + msg.size]
                self.stats.bytes_copied += msg.size
        elif msg.copy_type == DB_COPY_PARTITION_BACK:
            aligned_view = (
                src.is_view and src.parent == dst.guid
                and src.offset_in_parent == msg.dst_offset and msg.size == src.size)
            if aligned_view:
                self.stats.bytes_zero_copy += msg.size  # nothing moves
            else:
                if self._san is not None:
                    self._san.on_copy_access(src, msg.src_offset, msg.size, False)
                    self._san.on_copy_access(dst, msg.dst_offset, msg.size, True)
                sbuf = self._materialize(src)
                dbuf = self._materialize(dst)
                dst.version += 1
                dbuf[msg.dst_offset: msg.dst_offset + msg.size] = \
                    sbuf[msg.src_offset: msg.src_offset + msg.size]
                self.stats.bytes_copied += msg.size
            self._destroy_db(src)  # PARTITION_BACK entails destruction of src
        else:
            if self._san is not None:
                self._san.on_copy_access(src, msg.src_offset, msg.size, False)
                self._san.on_copy_access(dst, msg.dst_offset, msg.size, True)
            sbuf = self._materialize(src)
            dbuf = self._materialize(dst)
            dst.version += 1
            dbuf[msg.dst_offset: msg.dst_offset + msg.size] = \
                sbuf[msg.src_offset: msg.src_offset + msg.size]
            self.stats.bytes_copied += msg.size
        ev = self.resolve(msg.completion_event)
        if isinstance(ev, Guid) and not is_null(ev):
            self.send(MSatisfy(target=ev, slot=0, db=NULL_GUID),
                      msg.dst_node, ev.node)

    # -- file IO (§5) -----------------------------------------------------------

    def _on_MIoDone(self, msg: MIoDone) -> None:
        """One async disk op completed: perform the OS IO, wake waiters."""
        op = msg.op
        self.io.complete(op)
        if op.kind == "read":
            db = self.try_lookup(op.db)
            if db is None:
                return                       # destroyed while in flight
            db.io_pending = False
            if not op.performed and db.buffer is None:
                if db.spilled and op.file is None:
                    # re-materialization of a spilled block (spill-file read)
                    db.buffer = _read_file_region(op.path, op.offset, op.size)
                    self._clear_spill(db)
                    self.nodes[db.guid.node].resident_dbs += 1
                elif db.lazy_file_read:
                    db.buffer = _read_file_region(op.path, op.offset, op.size)
                    db.lazy_file_read = False
                    self.stats.file_bytes_read += op.size
                    self.nodes[db.guid.node].resident_dbs += 1
            self._log("IO done (read)", op.db)
            # grants deferred on the IO-pending block retry now
            self._wake_waiters(db.guid)
        elif op.kind == "spill":
            self._finish_spill(op)
        elif op.kind == "compact":
            self._finish_compact(op)
        else:
            if not op.performed and op.data is not None:
                _write_file_region(op.path, op.offset, op.data)
                self.stats.file_bytes_written += op.size
                self._log("IO done (write)",
                          f"{op.path}[{op.offset},+{op.size}) x{op.chunks}")

    def _on_MFileOpened(self, msg: MFileOpened) -> None:
        f: FileObj = self.lookup(msg.file_guid)
        f.size = msg.size
        desc: DbObj = self.lookup(self.resolve(msg.descriptor_db))
        buf = self._materialize(desc)
        key = len(self.file_registry)
        self.file_registry.append(f.guid)
        buf[:16] = np.frombuffer(struct.pack("<QQ", msg.size, key), dtype=np.uint8)
        desc.ready = True
        pend = desc.pending_deps
        desc.pending_deps = []
        for (dest, slot, _mode) in pend:
            self.send(MSatisfy(target=dest, slot=slot, db=desc.guid),
                      desc.guid.node, self._owner(dest))

    # -- forced LID resolution (§3 ocrGetGuid — the one blocking call) -----------

    def force_resolve(self, lid: Lid, ctx: Optional["TaskCtx"] = None) -> Guid:
        node = self.nodes[lid.node]
        g = node.lid_table.get(lid)
        if g is not None:
            return g
        self.stats.blocking_roundtrips += 1
        if ctx is not None:
            ctx.blocking_time += 2 * self.net_latency
        msg = self._pending_lid_msg.pop(lid, None)
        if msg is None:
            # the message may itself be deferred on another lid — resolve those
            for other, queue in list(node.deferred.items()):
                for m in queue:
                    if getattr(m, "lid", None) == lid:
                        self.force_resolve(other, ctx)
                        return self.force_resolve(lid, ctx)
            raise OcrError(f"no pending creation for {lid}")
        self._cancelled.add(msg.uid)
        if not self.nodes[msg.dst_node].alive:
            raise OcrError(
                f"cannot resolve {lid}: its creation targets node "
                f"{msg.dst_node}, which fail-stopped")
        # resolve any other lids the creation itself depends on
        for l in msg.lids():
            if l != lid and isinstance(l, Lid):
                self.force_resolve(l, ctx)
                msg.patch({l: self.nodes[l.node].lid_table[l]})
        if isinstance(msg, MCreate):
            guid = self._create_object(msg.dst_node, msg.kind, msg.payload)
        elif isinstance(msg, MMapGet):
            saved, msg.lid = msg.lid, None
            self._on_MMapGet(msg)
            m: MapObj = self.lookup(self.resolve(msg.map_id))
            guid = m.entries[msg.index]
            msg.lid = saved
        else:
            raise OcrError(f"cannot force-resolve via {type(msg).__name__}")
        self._apply_lid_binding(lid, guid)
        return guid


# ---------------------------------------------------------------- file helpers


def _file_size(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


def _read_file_region(path: str, offset: int, size: int) -> np.ndarray:
    """``size`` bytes at ``offset``; past the end of the file, zeros."""
    buf = np.zeros(size, dtype=np.uint8)
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            f.readinto(buf)
    except OSError:
        pass
    return buf


def _write_file_region(path: str, offset: int, buf) -> None:
    """Write ``buf`` (any contiguous bytes-like) at ``offset``, creating
    the file if it is missing; one open and positioned writes, no copy."""
    data = memoryview(buf).cast("B")
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o666)
    try:
        done = 0
        while done < len(data):
            done += os.pwrite(fd, data[done:], offset + done)
    finally:
        os.close(fd)


def _enlarge_file(path: str, new_size: int) -> None:
    mode = "r+b" if os.path.exists(path) else "w+b"
    with open(path, mode) as f:
        f.truncate(max(new_size, _file_size(path)))


# ------------------------------------------------------------------- Task API


class TaskCtx:
    """The OCR API surface bound to (runtime, node, current task) — the
    ``api`` argument every EDT body receives.  Mirrors the paper's functions
    with pythonic names; all calls are non-blocking except :meth:`get_guid`.
    """

    def __init__(self, rt: Runtime, node: int, edt: Optional[EdtObj]):
        self.rt = rt
        self.node = node
        self.edt = edt
        self.blocking_time = 0.0
        self._mapped_lid: Optional[Lid] = None

    # -- time of the current API call within the task's execution window
    @property
    def now(self) -> float:
        return self.rt.clock + self.blocking_time

    def _ref(self, x: Any) -> Any:
        """§3 scope check (sanitizer): an unbound LID referenced outside
        the scope that allocated it is an escape."""
        if self.rt._san is not None:
            self.rt._san.on_ref(x)
        return x

    # -- templates / EDTs ------------------------------------------------------

    def edt_template_create(self, func: Callable, paramc: int, depc: int) -> Guid:
        g = self.rt._alloc_guid(self.node, ObjectKind.TEMPLATE)
        self.rt.nodes[self.node].objects.insert(TemplateObj(g, func, paramc, depc))
        return g

    def edt_template_destroy(self, tmpl: Guid) -> None:
        self.rt.destroy(tmpl)

    def edt_create(
        self,
        template: Any,
        paramv: Sequence[Any] = (),
        depv: Optional[Sequence[Any]] = None,
        props: int = 0,
        output_event: bool = False,
        placement: Optional[int] = None,
        duration: float = 1.0,
        dep_modes: Optional[Sequence[DbMode]] = None,
        mapped_id: Optional[Lid] = None,
    ) -> Tuple[Any, Optional[Guid]]:
        """``ocrEdtCreate``.  Returns ``(id, output_event_guid)``.

        * default: blocks for the GUID when the target node is remote
          (cost: one round-trip of virtual time);
        * ``EDT_PROP_LID``: returns a LID immediately (§3);
        * ``EDT_PROP_MAPPED``: binds the map-provided ``mapped_id`` (§4).
        """
        tmpl = self.rt.resolve(self._ref(template))
        for d in depv or ():
            self._ref(d)
        depc = None
        t_obj = self.rt.try_lookup(tmpl) if isinstance(tmpl, Guid) else None
        if t_obj is not None:
            depc = t_obj.depc
        if depc is None:
            depc = len(depv or [])
        target = self.rt._pick_node(placement)
        out_ev = None
        if output_event:
            out_ev = self.event_create(EventKind.ONCE)
        payload = dict(template=tmpl, paramv=tuple(paramv), depv=list(depv or []),
                       depc=depc, output_event=out_ev, duration=duration,
                       dep_modes=list(dep_modes) if dep_modes else None)
        if props & EDT_PROP_MAPPED:
            lid = mapped_id if mapped_id is not None else self._mapped_lid
            if lid is None:
                raise OcrError("EDT_PROP_MAPPED requires the map-provided LID")
            guid = self.rt._create_edt(self.node if target is None else target, payload)
            self.rt._apply_lid_binding(lid, guid)
            return lid, out_ev
        if target == self.node:
            # local creation: a real GUID is free (§3: "the runtime may be
            # able to return a real GUID ... even without communication")
            guid = self.rt._create_edt(self.node, payload)
            return guid, out_ev
        if props & EDT_PROP_LID:
            lid = self.rt._alloc_lid(self.node)
            self.rt.send(MCreate(kind="edt", lid=lid, payload=payload),
                         self.node, target, at=self.now)
            return lid, out_ev
        # blocking GUID path: one synchronous round-trip
        self.rt.stats.blocking_roundtrips += 1
        self.blocking_time += 2 * self.rt.net_latency
        guid = self.rt._create_edt(target, payload)
        return guid, out_ev

    # -- events ---------------------------------------------------------------

    def _remote_create(self, kind: str, payload: Dict[str, Any],
                       target: int, props: int) -> Any:
        """§3 remote creation: ``EDT_PROP_LID`` returns a LID immediately
        (the ``MCreate`` travels with it), otherwise the call blocks one
        round-trip for the real GUID — shared by db/event creation."""
        if props & EDT_PROP_LID:
            lid = self.rt._alloc_lid(self.node)
            self.rt.send(MCreate(kind=kind, lid=lid, payload=payload),
                         self.node, target, at=self.now)
            return lid
        self.rt.stats.blocking_roundtrips += 1
        self.blocking_time += 2 * self.rt.net_latency
        return self.rt._create_object(target, kind, payload)

    def event_create(self, kind: EventKind = EventKind.ONCE, latch_count: int = 0,
                     placement: Optional[int] = None, props: int = 0) -> Any:
        """``ocrEventCreate``.  Local by default; with a remote ``placement``
        the event is created through the §3 ``MCreate`` path — ``EDT_PROP_LID``
        returns a LID immediately, otherwise one blocking round-trip."""
        payload = dict(kind=kind, latch_count=latch_count)
        target = self.node if placement is None \
            else self.rt._pick_node(placement)
        if target == self.node:
            return self.rt._create_event(self.node, payload).guid
        return self._remote_create("event", payload, target, props)

    def event_satisfy(self, event: Any, db: Any = NULL_GUID) -> None:
        tgt = self.rt.resolve(self._ref(event))
        self._ref(db)
        self.rt.send(MSatisfy(target=tgt, slot=0, db=self.rt.resolve(db)),
                     self.node, self.rt._owner(tgt), at=self.now)

    def event_destroy(self, event: Any) -> None:
        self.rt.send(MDestroy(target=self.rt.resolve(self._ref(event))),
                     self.node, self.rt._owner(event), at=self.now)

    def add_dependence(self, source: Any, dest: Any, slot: int,
                       mode: DbMode = DbMode.RO) -> None:
        src = self.rt.resolve(self._ref(source))
        dst = self.rt.resolve(self._ref(dest))
        if isinstance(src, Guid) and not is_null(src) \
                and not self.rt.nodes[src.node].alive:
            raise OcrError(
                f"dependence on {src}: node {src.node} fail-stopped "
                f"and its objects are lost")
        route = self.node if (is_null(src) or not isinstance(src, Guid)) \
            else src.node
        self.rt.send(MDep(source=src, dest=dst, slot=slot, mode=mode),
                     self.node, route, at=self.now)

    # -- data blocks ------------------------------------------------------------

    def db_create(self, size: int, props: int = 0,
                  placement: Optional[int] = None,
                  mapped_id: Optional[Lid] = None) -> Tuple[Any, Optional[np.ndarray]]:
        """``ocrDbCreate``.  Returns ``(id, ptr)``.

        Local by default.  With a remote ``placement`` the block is created
        on the target node through the §3 ``MCreate`` path and ``ptr`` is
        None (remote memory is only reachable through an acquire):
        ``EDT_PROP_LID`` returns a LID immediately, otherwise the call
        blocks one round-trip for the GUID.  ``EDT_PROP_MAPPED`` binds the
        map-provided ``mapped_id`` (§4) — a labeled-map creator can hand
        out data blocks (e.g. serve-engine request slots), not just EDTs.
        """
        payload = dict(size=size, props=props)
        target = self.node if placement is None \
            else self.rt._pick_node(placement)
        if props & EDT_PROP_MAPPED:
            lid = mapped_id if mapped_id is not None else self._mapped_lid
            if lid is None:
                raise OcrError("EDT_PROP_MAPPED requires the map-provided LID")
            db = self.rt._create_db(target, payload)
            self.rt._apply_lid_binding(lid, db.guid)
            return lid, db.buffer if target == self.node else None
        if target == self.node:
            db = self.rt._create_db(self.node, payload)
            return db.guid, db.buffer
        return self._remote_create("db", payload, target, props), None

    def db_release(self, db: Any) -> None:
        d: DbObj = self.rt.lookup(self.rt.resolve(self._ref(db)))
        if self.edt is not None and d.writer == self.edt.guid:
            d.writer = None
            if self.rt._san is not None:
                self.rt._san.on_release(d, True)
            self.rt.nodes[d.guid.node].spill_scan_at = -1.0
            if d.pending_destroy and not d.locked():
                self.rt._destroy_db(d)   # wakes its waiters itself
            else:
                self.rt._wake_waiters(d.guid)

    def db_destroy(self, db: Any) -> None:
        self.rt.send(MDestroy(target=self.rt.resolve(self._ref(db))),
                     self.node, self.rt._owner(db), at=self.now)

    def db_partition(self, db: Any, parts: Sequence[Tuple[int, int]],
                     props: int = 0) -> List[Guid]:
        """``ocrDbPartition`` (§6.2): split into disjoint contiguous partitions."""
        parent: DbObj = self.rt.lookup(self.rt.resolve(self._ref(db)))
        if parent.destroyed:
            raise OcrError(f"partitioning destroyed block {parent.guid}")
        if parent.static_partitioning and parent.partitions:
            raise PartitionStaticError(
                f"{parent.guid} has static partitioning; destroy all partitions first")
        # validate: in-bounds, mutually disjoint, disjoint from live partitions
        for i, (o, s) in enumerate(parts):
            if s <= 0 or o < 0 or o + s > parent.size:
                raise PartitionOverlapError(
                    f"partition [{o},+{s}) out of bounds of {parent.guid} (size {parent.size})")
            if parent.overlaps(o, s):
                raise PartitionOverlapError(
                    f"partition [{o},+{s}) overlaps a live partition of {parent.guid}")
            for j, (o2, s2) in enumerate(parts):
                if i < j and o < o2 + s2 and o2 < o + s:
                    raise PartitionOverlapError(
                        f"requested partitions [{o},+{s}) and [{o2},+{s2}) overlap")
        buf = self.rt._materialize(parent)
        # children write through the parent's buffer without touching its
        # lock state or version: abort any in-flight spill snapshot
        parent.version += 1
        out = []
        for (o, s) in parts:
            g = self.rt._alloc_guid(parent.guid.node, ObjectKind.DATABLOCK)
            # partitions of a file-mapped block inherit the file binding:
            # each child writes back exactly its own §6 byte range when
            # destroyed dirty (the sharded-checkpoint write path), instead
            # of the parent rewriting the whole chunk
            child = DbObj(guid=g, size=s, node=parent.guid.node,
                          buffer=buf[o: o + s], parent=parent.guid,
                          offset_in_parent=o, is_view=True,
                          file_guid=parent.file_guid,
                          file_offset=parent.file_offset + o)
            child.ready = True
            child.pending_deps = []
            self.rt.nodes[parent.guid.node].objects.insert(child)
            parent.partitions[g] = (o, s)
            out.append(g)
        if props & OCR_DB_PARTITION_STATIC:
            parent.static_partitioning = True
        if self.rt._san is not None:
            self.rt._san.on_partition_create(
                parent, [(g, o, s) for g, (o, s) in zip(out, parts)])
        return out

    def db_copy(self, dst: Any, dst_offset: int, src: Any, src_offset: int,
                size: int, copy_type: int = DB_COPY_PLAIN) -> Guid:
        """``ocrDbCopy`` (§6.3): asynchronous copy; returns a completion event."""
        ev = self.event_create(EventKind.ONCE)
        self.rt.send(
            MDbCopy(dst=self.rt.resolve(self._ref(dst)), dst_offset=dst_offset,
                    src=self.rt.resolve(self._ref(src)), src_offset=src_offset, size=size,
                    copy_type=copy_type, completion_event=ev),
            self.node, self.rt._owner(src), at=self.now)
        return ev

    # -- labeled maps (§4) ---------------------------------------------------------

    def map_create(self, size: int, creator: Callable, paramv: Sequence[Any] = (),
                   guidv: Sequence[Any] = (), placement: Optional[int] = None) -> Guid:
        node = self.node if placement is None else self.rt._pick_node(placement)
        g = self.rt._alloc_guid(node, ObjectKind.MAP)
        self.rt.nodes[node].objects.insert(MapObj(
            guid=g, size=size, creator=creator,
            paramv=tuple(paramv), guidv=tuple(guidv)))
        return g

    def map_get(self, map_id: Any, index: int) -> Any:
        """``ocrMapGet``: returns a LID immediately; never blocks (§4)."""
        m = self.rt.resolve(self._ref(map_id))
        owner = self.rt._owner(m)
        lid = self.rt._alloc_lid(self.node)
        self.rt.send(MMapGet(map_id=m, index=index, lid=lid),
                     self.node, owner, at=self.now)
        return lid

    def map_destroy(self, map_id: Any) -> None:
        self.rt.send(MDestroy(target=self.rt.resolve(self._ref(map_id))),
                     self.node, self.rt._owner(map_id), at=self.now)

    # -- file IO (§5) -----------------------------------------------------------------

    def file_open(self, path: str, mode: str = "rb") -> Tuple[Guid, Guid]:
        """``ocrFileOpen``: returns (file guid, descriptor-db guid).  The
        descriptor satisfies dependences only once the (async) open completes."""
        if mode not in ("rb", "rb+", "wb+"):
            raise FileModeError(f"unsupported file mode {mode!r}")
        g = self.rt._alloc_guid(self.node, ObjectKind.FILE)
        f = FileObj(guid=g, path=path, mode=mode)
        if mode == "wb+":
            with open(path, "w+b"):
                pass
        self.rt.nodes[self.node].objects.insert(f)
        desc, _ = self.db_create(16)
        d: DbObj = self.rt.lookup(desc)
        d.ready = False
        f.descriptor_db = desc
        size = _file_size(path)
        self.rt.send(MFileOpened(file_guid=g, descriptor_db=desc, size=size),
                     self.node, self.node, at=self.now + self.rt.io_latency)
        return g, desc

    @staticmethod
    def file_get_size(descriptor_ptr: np.ndarray) -> int:
        size, _ = struct.unpack("<QQ", bytes(descriptor_ptr[:16]))
        return size

    def file_get_guid(self, descriptor_ptr: np.ndarray) -> Guid:
        _, key = struct.unpack("<QQ", bytes(descriptor_ptr[:16]))
        return self.rt.file_registry[key]

    def file_get_chunk(self, file: Any, offset: int, size: int,
                       write_only: bool = False) -> Guid:
        """``ocrFileGetChunk``: map a contiguous file range into a data block.

        ``write_only`` chunks skip the lazy read entirely (the caller
        promises to overwrite the whole range — e.g. checkpoint writers),
        so no read op is charged for ranges whose prior contents are dead.
        """
        f: FileObj = self.rt.lookup(self.rt.resolve(self._ref(file)))
        if f.closed:
            raise OcrError(f"file {f.guid} already closed")
        if f.chunk_overlaps(offset, size):
            raise ChunkOverlapError(
                f"chunk [{offset},+{size}) overlaps a live chunk of {f.guid}")
        if offset + size > f.size and not f.writable:
            raise FileModeError(
                f"chunk [{offset},+{size}) extends past EOF of read-only file")
        g = self.rt._alloc_guid(self.node, ObjectKind.DATABLOCK)
        db = DbObj(guid=g, size=size, node=self.node, file_guid=f.guid,
                   file_offset=offset, lazy_file_read=not write_only)
        db.ready = True
        db.pending_deps = []
        self.rt.nodes[self.node].objects.insert(db)
        f.add_chunk(g, offset, size)
        if db.lazy_file_read and self.rt.io_mode == "async" \
                and self.rt.read_ahead:
            # §5 read-ahead: the fetch streams on the node's IO queue from
            # the moment the mapping exists, ahead of the first acquire
            self.rt.io.submit_read(db, f, at=self.now)
        return g

    def file_release(self, file: Any) -> None:
        f: FileObj = self.rt.lookup(self.rt.resolve(file))
        f.released = True
        if not f.chunks:
            f.closed = True

    # -- identity (§3) -------------------------------------------------------------------

    @staticmethod
    def get_id_type(x: Any) -> IdType:
        return id_type(x)

    def get_guid(self, x: Any) -> Guid:
        """``ocrGetGuid`` — the single blocking call of the API (§3)."""
        if isinstance(x, Guid):
            return x
        if isinstance(x, Lid):
            self._ref(x)
            return self.rt.force_resolve(x, self)
        raise OcrError(f"not an identifier: {x!r}")

    # -- control --------------------------------------------------------------------------

    def shutdown(self) -> None:
        self.rt.shutdown_requested = True


def spawn_main(rt: Runtime, func: Callable, paramv: Sequence[Any] = (),
               node: int = 0, duration: float = 1.0) -> Guid:
    """Create and immediately schedule the ``mainEdt`` equivalent."""
    ctx = TaskCtx(rt, node, None)
    tmpl = ctx.edt_template_create(func, len(paramv), 0)
    guid, _ = ctx.edt_create(tmpl, paramv=paramv, depv=[], duration=duration,
                             placement=node)
    return guid
