"""Runtime object model: events, EDTs, templates, data blocks, maps, files.

Data blocks carry the §6 partitioning state (parent / live partitions /
static flag) and the §5 file binding (file guid + offset + dirty bit).
Locking state implements the acquire-mode semantics that make partitioning
observable: RO/CONST are shared, RW/EW are exclusive *per data block* — so
two tasks in EW on two disjoint partitions run in parallel while the same
two tasks in RW on the whole parent serialize.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from .guid import (DbMode, EventKind, GUID_SHARD_BITS, Guid, Lid, NULL_GUID,
                   ObjectKind)

UNSET = object()  # pre-slot not yet satisfied
_MISSING = object()


class OcrError(RuntimeError):
    pass


class PartitionOverlapError(OcrError):
    pass


class PartitionDeadlockError(OcrError):
    pass


class PartitionStaticError(OcrError):
    pass


class ChunkOverlapError(OcrError):
    pass


class FileModeError(OcrError):
    pass


class _Shard:
    """One ``(kind, seq-range)`` shard of a node's GUID table.

    ``objs`` keys by the bare ``seq`` int: within a per-node, per-kind table
    a Guid's seq is unique, so probes never hash or compare full Guid
    triples — int keys keep every dict operation at C level.  ``destroyed``
    counts objects removed from this shard over its lifetime; ``spilled``
    counts members whose buffers currently live in the node's spill file;
    ``tombstones`` counts fired ONCE-event tombstones still parked in
    ``objs`` (see :meth:`ObjectTable.retire_event_shards`).
    """

    __slots__ = ("objs", "destroyed", "spilled", "tombstones")

    def __init__(self) -> None:
        self.objs: Dict[int, Any] = {}
        self.destroyed = 0
        self.spilled = 0
        self.tombstones = 0

    def hot(self) -> bool:
        """A shard is hot while it holds any buffer-resident live object."""
        return len(self.objs) > self.spilled


class ObjectTable:
    """Per-node GUID table, sharded by ``(ObjectKind, seq-range)``.

    The paper's GUIDs encode creation-time structure (§2) precisely so the
    runtime can exploit it; this table is that exploitation on the storage
    side.  Routing is O(1) arithmetic on fields the :class:`Guid` already
    carries — ``kind`` picks the kind map, ``seq >> shard_bits`` picks the
    shard — so lookups avoid both the Guid tuple hash and the Python-level
    ``Guid.__eq__`` a flat ``Dict[Guid, Any]`` pays on every probe of a
    message-decoded (non-identical) identifier.  Hot working sets stay in
    a handful of small int-keyed dicts instead of scattering across one
    multi-million-entry map, empty shards are reclaimed wholesale, and a
    fail-stop drops the whole table in O(shards), not O(objects).

    Per-shard live (``len(shard.objs)``) / ``destroyed`` / ``spilled``
    counts drive the ``Stats.table_shards`` / ``table_hot_shards`` /
    ``spilled_objects`` gauges and the cold-object spill policy
    (``Runtime(spill_threshold=…)``).
    """

    __slots__ = ("_kinds", "_bits", "_destroyed_dropped", "_retired_events")

    def __init__(self, shard_bits: int = GUID_SHARD_BITS) -> None:
        self._bits = shard_bits
        self._kinds: Dict[ObjectKind, Dict[int, _Shard]] = \
            {k: {} for k in ObjectKind}
        # destroyed counts of shards already reclaimed, aggregated per kind
        self._destroyed_dropped: Dict[ObjectKind, int] = \
            {k: 0 for k in ObjectKind}
        # retired ONCE-event shards compacted to {shard idx: {seq: (guid,
        # payload)}}; a late dependence on a retired event synthesizes its
        # tombstone from this alone (see retire_event_shards)
        self._retired_events: Dict[int, Dict[int, Tuple[Guid, Any]]] = {}

    @property
    def shard_bits(self) -> int:
        return self._bits

    # ------------------------------------------------------------ hot path

    def insert(self, obj: Any) -> None:
        """Insert ``obj`` under ``obj.guid`` (every runtime object has one)."""
        gid = obj.guid
        seq = gid.seq
        shards = self._kinds[gid.kind]
        idx = seq >> self._bits
        sh = shards.get(idx)
        if sh is None:
            sh = shards[idx] = _Shard()
        sh.objs[seq] = obj

    def get(self, gid: Guid, default: Any = None) -> Any:
        seq = gid.seq
        try:
            obj = self._kinds[gid.kind][seq >> self._bits].objs.get(seq, _MISSING)
        except (KeyError, AttributeError):
            # unknown shard, or a non-Guid probe (e.g. an unresolved Lid)
            # — same "not found" answer the flat dict gave
            obj = _MISSING
        if obj is not _MISSING:
            return obj
        if self._retired_events and gid.__class__ is Guid \
                and gid.kind is ObjectKind.EVENT:
            obj = self._retired_hit(seq)
            if obj is not _MISSING:
                return obj
        return default

    def _retired_hit(self, seq: int, remove: bool = False) -> Any:
        """Synthesize the tombstone of a retired ONCE event (or _MISSING)."""
        idx = seq >> self._bits
        r = self._retired_events.get(idx)
        if r is None or seq not in r:
            return _MISSING
        guid, payload = r.pop(seq) if remove else r[seq]
        if remove and not r:
            del self._retired_events[idx]
        return EventObj(guid, EventKind.ONCE,
                        satisfied=True, payload=payload, destroyed=True)

    def pop(self, gid: Guid, default: Any = None) -> Any:
        try:
            seq = gid.seq
            shards = self._kinds[gid.kind]
            idx = seq >> self._bits
            sh = shards[idx]
            obj = sh.objs.pop(seq)
        except (KeyError, AttributeError):
            if self._retired_events and gid.__class__ is Guid \
                    and gid.kind is ObjectKind.EVENT:
                obj = self._retired_hit(gid.seq, remove=True)
                if obj is not _MISSING:
                    return obj   # already counted destroyed at retirement
            return default
        sh.destroyed += 1
        if not sh.objs:
            # reclaim the empty shard; its destroyed count survives in the
            # per-kind aggregate
            self._destroyed_dropped[gid.kind] += sh.destroyed
            del shards[idx]
        return obj

    # ----------------------------------------------------- dict-compat API

    def __getitem__(self, gid: Guid) -> Any:
        obj = self.get(gid, _MISSING)
        if obj is _MISSING:
            raise KeyError(gid)
        return obj

    def __setitem__(self, gid: Guid, obj: Any) -> None:
        self.insert(obj)

    def __contains__(self, gid: Guid) -> bool:
        return self.get(gid, _MISSING) is not _MISSING

    def __len__(self) -> int:
        return sum(len(sh.objs) for shards in self._kinds.values()
                   for sh in shards.values())

    def values(self) -> Iterator[Any]:
        for shards in self._kinds.values():
            for idx in sorted(shards):
                yield from shards[idx].objs.values()

    def items(self) -> Iterator[Tuple[Guid, Any]]:
        for obj in self.values():
            yield obj.guid, obj

    def __iter__(self) -> Iterator[Guid]:
        for obj in self.values():
            yield obj.guid

    def clear(self) -> None:
        """Drop every shard wholesale (fail-stop: O(shards), not O(objects))."""
        for kind, shards in self._kinds.items():
            for sh in shards.values():
                self._destroyed_dropped[kind] += sh.destroyed + len(sh.objs)
            shards.clear()
        # retired entries were already counted destroyed at retirement
        self._retired_events.clear()

    # ------------------------------------------------- shard introspection

    def shards(self, kind: ObjectKind) -> List[Tuple[int, _Shard]]:
        """Live shards of ``kind`` in ascending seq-range order (oldest
        first — the cold end the spill policy scans from)."""
        shards = self._kinds[kind]
        return [(idx, shards[idx]) for idx in sorted(shards)]

    def shard_count(self) -> int:
        return sum(len(shards) for shards in self._kinds.values())

    def hot_shard_count(self) -> int:
        """Data-block shards still holding ≥1 buffer-resident block.

        Only DATABLOCK shards are counted: other kinds hold no buffers,
        so "hot" (= spill has not drained it) is meaningless for them —
        counting them would make ``Stats.table_hot_shards`` track shard
        population instead of memory residency.
        """
        return sum(1 for sh in self._kinds[ObjectKind.DATABLOCK].values()
                   if sh.hot())

    def live_count(self, kind: ObjectKind) -> int:
        """Live objects of ``kind`` (O(shards of that kind), not O(1) —
        callers poll it per spill check, not per table op)."""
        return sum(len(sh.objs) for sh in self._kinds[kind].values())

    def destroyed_count(self, kind: ObjectKind) -> int:
        """Objects of ``kind`` destroyed over the table's lifetime
        (including those whose shard was since reclaimed)."""
        return self._destroyed_dropped[kind] + \
            sum(sh.destroyed for sh in self._kinds[kind].values())

    def note_tombstone(self, gid: Guid) -> None:
        """A ONCE event in this table fired and became a tombstone (§3)."""
        sh = self._kinds[gid.kind].get(gid.seq >> self._bits)
        if sh is not None:
            sh.tombstones += 1

    def retire_event_shards(self) -> int:
        """Compact fully-tombstoned ONCE-event shards (ROADMAP follow-on).

        A fired ONCE event leaves a satisfiable tombstone in the table so
        reordered late dependences still receive the payload — but a shard
        holding *only* tombstones pays per-object dict storage for what is
        semantically a satisfied-set.  Once such a shard's fan-out has
        quiesced (every member is a tombstone), its ``{seq: (guid,
        payload)}`` map replaces the shard: late dependences synthesize
        the tombstone from it, everything else sees the events as
        destroyed.  Returns the number of shards retired by this call;
        the runtime accumulates it into ``Stats.tombstone_shards_retired``.
        """
        shards = self._kinds[ObjectKind.EVENT]
        retired = 0
        for idx in [i for i, sh in shards.items()
                    if sh.objs and sh.tombstones >= len(sh.objs)]:
            sh = shards[idx]
            # tombstones can overcount if a tombstone was later popped
            # (explicit destroy): verify before compacting, resync if stale
            if not all(isinstance(o, EventObj) and o.destroyed and o.satisfied
                       and o.kind == EventKind.ONCE
                       for o in sh.objs.values()):
                sh.tombstones = sum(
                    1 for o in sh.objs.values()
                    if isinstance(o, EventObj) and o.destroyed
                    and o.satisfied and o.kind == EventKind.ONCE)
                continue
            self._retired_events[idx] = {
                seq: (o.guid, o.payload) for seq, o in sh.objs.items()}
            self._destroyed_dropped[ObjectKind.EVENT] += \
                sh.destroyed + len(sh.objs)
            del shards[idx]
            retired += 1
        return retired

    def note_spilled(self, gid: Guid) -> None:
        sh = self._kinds[gid.kind].get(gid.seq >> self._bits)
        if sh is not None:
            sh.spilled += 1

    def note_unspilled(self, gid: Guid) -> None:
        sh = self._kinds[gid.kind].get(gid.seq >> self._bits)
        if sh is not None and sh.spilled > 0:
            sh.spilled -= 1


def spans_overlap(spans) -> bool:
    """True if any of the half-open ``(start, end)`` spans intersect.

    Shared by the §6.3 copy batching (runtime) and the fused kernel
    wrapper (kernels.ops) so destination-disjointness means the same
    thing everywhere; touching spans (``end == start``) do not overlap.
    """
    ordered = sorted(spans)
    return any(b[0] < a[1] for a, b in zip(ordered, ordered[1:]))


@dataclasses.dataclass
class EventObj:
    guid: Guid
    kind: EventKind
    # (dest guid, slot, mode) registered before satisfaction
    dependents: List[Tuple[Guid, int, DbMode]] = dataclasses.field(default_factory=list)
    satisfied: bool = False
    payload: Any = NULL_GUID  # db guid delivered on satisfaction
    latch_count: int = 0
    destroyed: bool = False


@dataclasses.dataclass
class TemplateObj:
    guid: Guid
    func: Callable[..., Any]
    paramc: int
    depc: int
    destroyed: bool = False


@dataclasses.dataclass
class EdtObj:
    guid: Guid
    template: Guid
    paramv: Tuple[Any, ...]
    depc: int
    node: int
    slots: List[Any] = dataclasses.field(default_factory=list)       # db guid | NULL_GUID | UNSET
    modes: List[DbMode] = dataclasses.field(default_factory=list)
    pending: int = 0
    output_event: Optional[Guid] = None
    duration: float = 1.0
    state: str = "created"   # created -> ready -> running -> done
    # stamped at the created→ready transition when monitoring is on, so
    # the grant-wait histogram (start_time - ready_time) measures virtual
    # time spent ready-but-ungranted behind locks / IO deferrals
    ready_time: float = -1.0
    start_time: float = -1.0
    end_time: float = -1.0
    destroyed: bool = False
    # §6.2 ancestor-deadlock check runs once per EDT per partition epoch:
    # slots are frozen when the task becomes ready, so retries skip it
    # unless a zero-copy partition copy changed some ancestry since
    # (Runtime._partition_epoch)
    deadlock_epoch: int = -1
    # the blocking DB guid whose waiter queue this EDT currently sits in
    waiting_on: Optional[Guid] = None
    # RO waiters granted past this EDT while it was a blocked FIFO head;
    # capped at Runtime.reader_batch_bound over the EDT's whole wait (EDTs
    # run once, so the cap needs no reset) — bounded barging, no starvation
    barged_past: int = 0


@dataclasses.dataclass
class DbObj:
    guid: Guid
    size: int
    node: int
    buffer: Optional[np.ndarray] = None            # uint8 view or owned array
    no_acquire: bool = False                       # DB_PROP_NO_ACQUIRE (§6.3)
    # --- partitioning state (§6) ---
    parent: Optional[Guid] = None
    offset_in_parent: int = 0
    partitions: Dict[Guid, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    static_partitioning: bool = False
    is_view: bool = False                          # zero-copy partition view
    # --- file binding (§5) ---
    file_guid: Optional[Guid] = None
    file_offset: int = 0
    dirty: bool = False
    lazy_file_read: bool = False                   # contents read at first acquire
    io_pending: bool = False                       # async §5 read in flight
    # --- cold-object spill state ---
    spilling: bool = False                         # spill write-back in flight
    spilled: bool = False                          # buffer lives in the spill file
    spill_offset: int = -1                         # offset in the node's spill file
    # virtual time of the last grant touching this block: the spill policy
    # evicts least-recently-granted first (a hot old block — e.g. a serve
    # session's archive — outlives colder younger ones)
    last_touch: float = 0.0
    # bumped whenever the buffer can change (RW/EW grant, copy into this
    # block): a spill completion whose snapshot predates the current
    # version aborts instead of dropping fresher bytes
    version: int = 0
    # --- lock state ---
    readers: int = 0
    writer: Optional[Guid] = None                  # holding EDT guid
    destroyed: bool = False
    pending_destroy: bool = False                  # destroy deferred until release

    def overlaps(self, offset: int, size: int) -> bool:
        for (o, s) in self.partitions.values():
            if offset < o + s and o < offset + size:
                return True
        return False

    def locked(self) -> bool:
        return self.readers > 0 or self.writer is not None

    def available(self, mode: DbMode) -> bool:
        """Can an acquisition in ``mode`` be granted right now (locally)?"""
        if mode == DbMode.NULL:
            return True
        if mode in (DbMode.RO, DbMode.CONST):
            return self.writer is None
        return self.readers == 0 and self.writer is None


@dataclasses.dataclass
class MapObj:
    """Labeled-GUID map (§4)."""

    guid: Guid
    size: int
    creator: Callable[..., Any]
    paramv: Tuple[Any, ...]
    guidv: Tuple[Any, ...]
    entries: Dict[int, Guid] = dataclasses.field(default_factory=dict)
    creator_calls: int = 0
    destroyed: bool = False


@dataclasses.dataclass
class FileObj:
    """File-mapped data block source (§5)."""

    guid: Guid
    path: str
    mode: str                   # "rb" | "rb+" | "wb+"
    size: int = 0
    descriptor_db: Optional[Guid] = None
    chunks: Dict[Guid, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    released: bool = False
    closed: bool = False
    # the live chunks again, sorted by offset (``chunks`` keeps them by guid)
    spans: "SpanIndex" = dataclasses.field(default_factory=lambda: SpanIndex())

    @property
    def writable(self) -> bool:
        return "+" in self.mode or self.mode.startswith("w")

    def chunk_overlaps(self, offset: int, size: int) -> bool:
        return any(True for _ in self.spans.overlapping(offset, size))

    def add_chunk(self, guid: Guid, offset: int, size: int) -> None:
        self.chunks[guid] = (offset, size)
        self.spans.add(guid, offset, size)

    def drop_chunk(self, guid: Guid) -> None:
        if self.chunks.pop(guid, None) is not None:
            self.spans.remove(guid)


class SpanIndex:
    """Live ``(offset, size)`` spans under hashable keys, sorted by offset.

    Finds the spans that overlap or touch a range by bisection instead of
    a scan of every live span (a checkpoint maps tens of thousands of
    chunks of one file).  A query scans the spans whose offset lies within
    the largest live size of the range, so it is exact for any spans.
    """

    def __init__(self) -> None:
        self._order = itertools.count()
        self._sorted: List[Tuple[int, int]] = []     # (offset, order)
        self._by_order: Dict[int, Tuple[Any, int]] = {}  # order -> (key, size)
        self._where: Dict[Any, Tuple[int, int]] = {}     # key -> (offset, order)
        self._max_size = 0

    def __len__(self) -> int:
        return len(self._where)

    def add(self, key: Any, offset: int, size: int) -> None:
        order = next(self._order)
        bisect.insort(self._sorted, (offset, order))
        self._by_order[order] = (key, size)
        self._where[key] = (offset, order)
        self._max_size = max(self._max_size, size)

    def remove(self, key: Any) -> None:
        offset, order = self._where.pop(key)
        del self._sorted[bisect.bisect_left(self._sorted, (offset, order))]
        del self._by_order[order]
        if not self._where:
            self._max_size = 0

    def _from(self, lo: int, hi: int) -> Iterator[Tuple[Any, int, int]]:
        """(key, offset, size) of the spans with ``lo <= offset < hi``."""
        i = bisect.bisect_left(self._sorted, (lo, -1))
        while i < len(self._sorted) and self._sorted[i][0] < hi:
            offset, order = self._sorted[i]
            key, size = self._by_order[order]
            yield key, offset, size
            i += 1

    def overlapping(self, offset: int, size: int) -> Iterator[Any]:
        """Keys of the spans ``(o, s)`` with ``offset < o + s`` and
        ``o < offset + size``."""
        for key, o, s in self._from(offset - self._max_size, offset + size):
            if offset < o + s and o < offset + size:
                yield key

    def touching(self, offset: int, size: int) -> Iterator[Any]:
        """Keys of the spans that end at ``offset`` or start at
        ``offset + size``."""
        for key, o, s in self._from(offset - self._max_size, offset + size + 1):
            if o + s == offset or o == offset + size:
                yield key


@dataclasses.dataclass
class DepEntry:
    """What an EDT body sees per pre-slot (``ocrEdtDep_t``)."""

    guid: Any                    # db guid or NULL_GUID
    ptr: Optional[np.ndarray]    # buffer view honouring the acquire mode
    mode: DbMode = DbMode.RO
