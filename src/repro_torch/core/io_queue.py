"""Latency-modeled asynchronous file IO (§5) — the per-node IO queue.

The paper's §5 file IO builds on data blocks precisely so an implementation
can overlap IO with compute and write back lazily.  This module is that
implementation: every chunk read/write becomes an :class:`IoOp` on the
owning node's virtual-time disk queue instead of a blocking call inside
``Runtime._materialize`` / ``Runtime._destroy_db``.

Model
-----
* Each node owns one disk.  An operation occupies the disk for
  ``Runtime.io_latency`` of virtual time (the per-chunk seek/roundtrip
  cost); requests queue FIFO per node (``start = max(now, disk_free)``).
* **Reads** are issued ahead of use ("read-ahead"): at ``file_get_chunk``
  time when ``Runtime.read_ahead`` is on, else at the first grant attempt
  of an acquiring EDT.  A data block with a read in flight is *IO-pending*:
  EDT grants defer on it through the ordinary waiter queues and resume
  when the :class:`~repro_torch.core.messages.MIoDone` completion lands.
* **Writes** (dirty write-back at release/destroy) buffer for the current
  virtual timestamp and flush together, coalescing *adjacent* dirty ranges
  of one file on one node into a single disk operation — m chunk
  write-backs pay one ``io_latency`` instead of m
  (``Stats.io_coalesced_writes`` counts the absorbed chunks).  An
  *elevator pass* extends the coalescing window past the timestamp: a
  flushed range adjacent to a *queued-but-unstarted* write op of the same
  (node, file) merges into that op instead of paying its own
  ``io_latency`` — staggered write-backs under disk backlog coalesce the
  same way an IO elevator absorbs requests into its pending sweep.
* The **real** OS read/write happens when the completion is delivered, so
  a fail-stopped node (``kill_node``) or a halted run (``run(until)``)
  loses exactly the in-flight operations — the crash semantics the
  checkpoint layer's commit protocol is tested against.

``io_mode="sync"`` drives the same latency model without the overlap: the
read is charged to the acquiring task's blocking time at execution and the
write-back is charged (and performed) synchronously at destroy, one
operation per chunk, no coalescing.  That is the baseline
``benchmarks/bench_fileio.py`` compares the async path against.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Tuple, TYPE_CHECKING

from .objects import SpanIndex

if TYPE_CHECKING:                                       # pragma: no cover
    from .guid import Guid
    from .runtime import Runtime

__all__ = ["IoOp", "IoQueue"]


@dataclasses.dataclass
class IoOp:
    """One disk operation (post-coalescing) on a node's IO queue."""

    kind: str                         # "read" | "write" | "spill" | "compact"
    node: int
    path: str
    offset: int
    size: int
    db: Optional["Guid"] = None       # read target data block
    file: Optional["Guid"] = None     # None for spill-file ops
    data: Optional[bytes] = None      # write payload, snapshot at enqueue
    chunks: int = 1                   # chunk write-backs merged into this op
    performed: bool = False           # sync mode: OS IO already done
    # "spill" only: the shard's victims as (db guid, spill offset, size,
    # db.version at snapshot) — a stale version aborts that victim
    victims: Optional[List[Tuple]] = None
    enqueued_at: float = 0.0
    start: float = 0.0                # disk busy interval [start, done)
    done: float = 0.0
    seq: int = -1                     # submission order of a pending write


class IoQueue:
    """Per-node virtual-time disk queues (§5 async IO subsystem)."""

    def __init__(self, rt: "Runtime"):
        self.rt = rt
        # node -> virtual time its disk becomes free
        self._free_at: Dict[int, float] = {}
        # write-back coalescing window: ops enqueued at the current
        # timestamp flush together (mirrors the §6.3 copy batching)
        self._write_buffer: List[IoOp] = []
        self._flush_scheduled = False
        # elevator pass: submitted write ops whose completion hasn't been
        # seen, by (node, path) and sorted by offset (keyed by ``seq``, the
        # submission order) — later flushes merge into the unstarted ones
        self._pending_writes: Dict[Tuple[int, str], SpanIndex] = {}
        self._pending_ops: Dict[int, IoOp] = {}
        self._seq = itertools.count()
        self.inflight = 0                 # ops submitted, completion not seen
        self.reads_inflight = 0
        # monitoring only (rt._mon is not None): per-node start times of
        # submitted ops, so queue_depth() can count ops still waiting for
        # the disk without scanning the event heap
        self._queued_starts: Dict[int, List[float]] = {}

    # ------------------------------------------------------------ plumbing

    def _service(self, op: IoOp, at: float) -> float:
        """Occupy ``op.node``'s disk for one ``io_latency``; return done."""
        free = self._free_at.get(op.node, 0.0)
        op.enqueued_at = at
        op.start = max(at, free)
        op.done = op.start + self.rt.io_latency
        self._free_at[op.node] = op.done
        return op.done

    def _submit(self, op: IoOp, at: float) -> float:
        from .messages import MIoDone
        done = self._service(op, at)
        self.inflight += 1
        if op.kind == "read":
            self.rt.stats.io_read_ops += 1
            self.reads_inflight += 1
            if self.reads_inflight > self.rt.stats.io_reads_inflight_max:
                self.rt.stats.io_reads_inflight_max = self.reads_inflight
        else:
            self.rt.stats.io_write_ops += 1
        self.rt.send(MIoDone(op=op), op.node, op.node, at=done)
        if op.kind == "write" and not op.performed:
            op.seq = next(self._seq)
            self._pending_ops[op.seq] = op
            self._pending_writes.setdefault(
                (op.node, op.path), SpanIndex()).add(op.seq, op.offset,
                                                     op.size)
        if self.rt._mon is not None:
            # publish the io.* gauges live at submit (not at run() return)
            self._queued_starts.setdefault(op.node, []).append(op.start)
            self.rt._mon.on_io(self)
        return done

    def complete(self, op: IoOp) -> None:
        """Bookkeeping when an op's MIoDone is delivered (or dropped)."""
        if self.rt._san is not None:
            self.rt._san.on_io_done(op)
        self.inflight = max(0, self.inflight - 1)
        if op.kind == "read":
            self.reads_inflight = max(0, self.reads_inflight - 1)
        elif op.kind == "write":
            pend = self._pending_writes.get((op.node, op.path))
            if pend is not None:
                if self._pending_ops.pop(op.seq, None) is op:
                    pend.remove(op.seq)
                if not len(pend):
                    del self._pending_writes[(op.node, op.path)]
        if self.rt._mon is not None:
            lst = self._queued_starts.get(op.node)
            if lst is not None:
                try:
                    lst.remove(op.start)
                except ValueError:
                    pass
                if not lst:
                    del self._queued_starts[op.node]
            self.rt._mon.on_io(self)

    def queue_depth(self, node: Optional[int] = None) -> int:
        """Submitted ops whose disk service hasn't started yet (queued
        behind the platter, as opposed to ``inflight`` which also counts
        the op currently being serviced).  Monitoring-only — the start
        lists are maintained iff ``Runtime(monitor=...)`` is on."""
        now = self.rt.clock
        if node is not None:
            return sum(1 for s in self._queued_starts.get(node, ()) if s > now)
        return sum(1 for lst in self._queued_starts.values()
                   for s in lst if s > now)

    # --------------------------------------------------------------- reads

    def submit_read(self, db, f, at: Optional[float] = None,
                    path: Optional[str] = None,
                    offset: Optional[int] = None) -> float:
        """Enqueue the §5 lazy read of ``db``'s file range (idempotent).

        With ``path``/``offset`` overrides (``f`` may then be None) the read
        targets the node's spill file instead of a §5 user file — the
        re-materialization of a spilled block rides the same queue, defers
        grants the same way, and wakes waiters through the same ``MIoDone``.
        """
        if db.io_pending:
            return 0.0
        db.io_pending = True
        op = IoOp(kind="read", node=db.node,
                  path=f.path if path is None else path,
                  offset=db.file_offset if offset is None else offset,
                  size=db.size, db=db.guid,
                  file=None if f is None else f.guid)
        return self._submit(op, self.rt.clock if at is None else at)

    # -------------------------------------------------------------- spill

    def submit_spill(self, node: int, path: str, offset: int, data: bytes,
                     victims: List[Tuple], at: Optional[float] = None) -> float:
        """Enqueue one shard's cold-object write-back (one disk op for the
        whole shard's victims; payloads are concatenated at ``offset``).

        Accounted as a write op (``Stats.io_write_ops``) but kept out of
        the §5 elevator/coalescing registries: spill ops target the node's
        private spill file and never merge with user-file write-backs.
        """
        op = IoOp(kind="spill", node=node, path=path, offset=offset,
                  size=len(data), data=data, victims=victims,
                  chunks=len(victims))
        return self._submit(op, self.rt.clock if at is None else at)

    def submit_compact(self, node: int, path: str, plan: List[Tuple],
                       live_bytes: int, at: Optional[float] = None) -> float:
        """Enqueue a spill-file compaction sweep: one disk op for the
        whole rewrite (the elevator's bulk-sweep analogue).  ``plan``
        holds (db guid, old offset, new offset, size, version) per live
        slot; ``Runtime._finish_compact`` re-verifies it at completion.
        Accounted as a write op, kept out of the §5 elevator like spills.
        """
        op = IoOp(kind="compact", node=node, path=path, offset=0,
                  size=live_bytes, victims=plan, chunks=len(plan))
        return self._submit(op, self.rt.clock if at is None else at)

    # -------------------------------------------------------------- writes

    def submit_write(self, db, f, at: Optional[float] = None) -> None:
        """Buffer a dirty-range write-back for same-timestamp coalescing."""
        op = IoOp(kind="write", node=db.node, path=f.path,
                  offset=db.file_offset, size=db.size,
                  db=db.guid, file=f.guid, data=db.buffer.tobytes())
        self._write_buffer.append(op)
        if not self._flush_scheduled:
            self._flush_scheduled = True
            heapq.heappush(self.rt._heap,
                           (self.rt.clock if at is None else at,
                            next(self.rt._tick), "io_flush", None))

    def _elevator_merge(self, op: IoOp) -> bool:
        """Absorb ``op`` into a queued-but-unstarted write of the same
        (node, file) when the ranges are adjacent (ROADMAP
        "cross-timestamp write coalescing").

        Only ops whose disk slot is strictly in the future are candidates:
        an op with ``start <= now`` is already on the platter.  The merged
        op's completion is untouched — the absorbed chunks ride the
        already-charged ``io_latency``, exactly like same-timestamp
        coalescing, and count in ``Stats.io_coalesced_writes``.

        Ordering hazard (the same class the §6.3 copy batching replays
        sequentially): if any pending write op overlaps ``op``'s range —
        a re-written chunk whose stale write-back is still queued — the
        newest payload must land *last*, so ``op`` takes a fresh disk
        slot (FIFO per node puts it behind every queued op) instead of
        riding an earlier one.
        """
        now = self.rt.clock
        pend = self._pending_writes.get((op.node, op.path))
        if pend is None:
            return False
        for _seq in pend.overlapping(op.offset, op.size):
            return False
        # the first candidate in submission order takes the op
        for seq in sorted(pend.touching(op.offset, op.size)):
            prior = self._pending_ops[seq]
            if prior.performed or prior.data is None or prior.start <= now:
                continue
            if op.offset == prior.offset + prior.size:
                prior.data = prior.data + (op.data or b"")
            elif op.offset + op.size == prior.offset:
                prior.data = (op.data or b"") + prior.data
                prior.offset = op.offset
            else:
                continue
            prior.size += op.size
            pend.remove(seq)
            pend.add(seq, prior.offset, prior.size)
            prior.chunks += op.chunks
            self.rt.stats.io_coalesced_writes += op.chunks
            return True
        return False

    def flush_writes(self) -> None:
        """Coalesce the buffered write-backs and put them on the disks.

        Ranges are adjacent-merged per ``(node, path)``: §5 chunks of one
        file never overlap, so a sorted linear sweep suffices, and the
        merged payload is the concatenation in offset order.  A merged run
        then takes the elevator: if it is adjacent to a queued-but-
        unstarted write op from an earlier timestamp it joins that op
        instead of occupying its own disk slot.
        """
        buf, self._write_buffer = self._write_buffer, []
        self._flush_scheduled = False
        if not buf:
            return
        groups: Dict[Tuple[int, str], List[IoOp]] = {}
        for op in buf:
            groups.setdefault((op.node, op.path), []).append(op)
        for (_node, _path), ops in sorted(groups.items()):
            ops.sort(key=lambda o: o.offset)
            merged = ops[0]
            for op in ops[1:]:
                if op.offset == merged.offset + merged.size:
                    merged.data = (merged.data or b"") + (op.data or b"")
                    merged.size += op.size
                    merged.chunks += op.chunks
                    self.rt.stats.io_coalesced_writes += op.chunks
                else:
                    if not self._elevator_merge(merged):
                        self._submit(merged, self.rt.clock)
                    merged = op
            if not self._elevator_merge(merged):
                self._submit(merged, self.rt.clock)

    # ---------------------------------------------------------- sync mode

    def charge_sync(self, db, f, kind: str, path: Optional[str] = None,
                    offset: Optional[int] = None) -> float:
        """``io_mode="sync"``: same disk model, no overlap, no coalescing.

        The caller performs the OS IO immediately; this occupies the disk
        and returns the virtual time the caller must block
        (``done - now``).  The pre-``performed`` completion still flows
        through the queue so the makespan covers the disk busy interval.
        ``path``/``offset`` overrides (``f`` then None) charge a spill-file
        read the same way the async path does.
        """
        op = IoOp(kind=kind, node=db.node,
                  path=f.path if path is None else path,
                  offset=db.file_offset if offset is None else offset,
                  size=db.size, db=db.guid,
                  file=None if f is None else f.guid, performed=True)
        done = self._submit(op, self.rt.clock)
        return done - self.rt.clock
