"""The sanitizer facade: event recorder + checker driver (``ocrsan``).

One :class:`Sanitizer` instance hangs off a ``Runtime(sanitize=...)``.
The runtime calls the ``on_*`` hooks from its own choke points (send,
dispatch, grant, release, destroy, partition, copy, map-get, LID
alloc/bind, kill, run-return); every hook is behind a single
``if self._san is not None`` so the disabled path costs one attribute
check.

The recorder keeps a bounded structured trace (``trace_events``), feeds
the vector-clock engine (:mod:`repro_torch.analysis.hb`) and the invariant
lints (:mod:`repro_torch.analysis.invariants`), and accumulates
:class:`~repro_torch.analysis.report.Finding` objects.  Activity / clock
bookkeeping:

- one **driver** activity per runtime (ambient ``TaskCtx`` calls between
  ``run()`` phases); at every ``run()`` return it joins the clocks of
  everything that retired — single-threaded DES makes that join
  physically sound, so cross-phase driver programs are never flagged;
- one activity per **granted EDT** (created at grant, base clock = join
  of creation context, slot satisfies, and acquired locks' release
  clocks);
- one activity per executed **db_copy** (forked from the issuing
  message's clock; the completion event inherits the copy's tick, so
  readers gated on the completion event are ordered and readers that
  skip it race — §6.3's actual contract).

Scope tokens (for §3 LID attribution) are orthogonal to clocks: the
driver token, the owning EDT's guid inside a task body, or the message
object during a handler.  A LID referenced before binding from any scope
other than the one that allocated it is an escape.
"""
from __future__ import annotations

import collections
import json
from typing import Any, Deque, Dict, List, Optional, Tuple
import weakref

from repro_torch.core.guid import DbMode, Guid, Lid, ObjectKind
from repro_torch.core.objects import DbObj, EdtObj, EventObj

from .hb import Access, Clock, RaceDetector, join
from .invariants import quiescence_advisories, quiescence_lost_wakeups
from .report import (
    Finding,
    GUID_DOUBLE_CREATE,
    GUID_NON_MEMOIZED,
    HB_RACE,
    LID_ESCAPE,
    OcrSanError,
    PARTITION_OVERLAP,
    PARENT_BEFORE_CHILDREN,
    SanitizerReport,
    fmt_clock,
    summarize,
)

_EXCL = (DbMode.RW, DbMode.EW)

# sanitizers with potentially-unreported findings (for the CI conftest
# fixture: after each test, anything recorded but never surfaced fails)
_ACTIVE: "weakref.WeakSet[Sanitizer]" = weakref.WeakSet()


def active_sanitizers() -> List["Sanitizer"]:
    return list(_ACTIVE)


class Sanitizer:
    """Happens-before race detector + OCR-invariant checker."""

    TRACE_CAP = 200_000

    def __init__(self, rt: Any, strict: bool = False) -> None:
        self.rt = rt
        self.strict = strict
        # --- activities & clocks ---
        self._next_act = 0
        self.names: Dict[int, str] = {}
        self._driver = self._new_act("driver")
        self._driver_clock: Clock = {self._driver: 0}
        self.cur: Clock = self._driver_clock
        self.cur_act: Optional[int] = self._driver
        self.cur_scope: Any = self          # driver scope token
        self._task_clock: Dict[Guid, Clock] = {}
        self._task_act: Dict[Guid, int] = {}
        self._ev_clock: Dict[Guid, Clock] = {}
        self._rel_excl: Dict[Guid, Clock] = {}
        self._rel_shared: Dict[Guid, Clock] = {}
        # §6.3 copy streams: copies touching one root DB execute in
        # arrival order at its owner (the runtime's documented
        # last-writer-wins / reads-see-earlier-writes batch semantics),
        # so successive copies chain through this per-root clock
        self._copy_seq: Dict[Guid, Clock] = {}
        self._done: Clock = {}             # retired work, joined at run() return
        # --- checkers ---
        self.races = RaceDetector()
        self._race_count = 0
        self._children: Dict[Guid, Dict[Guid, Tuple[int, int]]] = {}
        self._lid_scope: Dict[Lid, Any] = {}
        self._map_entries: Dict[Tuple[Guid, int], Guid] = {}
        self._map_creates: Dict[Tuple[Guid, int], int] = {}
        # --- findings & trace ---
        self.findings: List[Finding] = []
        self._keys: set = set()
        self._consumed = 0                 # hard findings already surfaced
        self.n_events = 0
        self.trace_events: Deque[Tuple] = collections.deque(maxlen=self.TRACE_CAP)
        self._copy_n = 0
        _ACTIVE.add(self)

    # ------------------------------------------------------------ plumbing

    def _new_act(self, name: str) -> int:
        a = self._next_act
        self._next_act = a + 1
        self.names[a] = name
        return a

    def _enter(self, clock: Clock, act: Optional[int], scope: Any):
        tok = (self.cur, self.cur_act, self.cur_scope)
        self.cur, self.cur_act, self.cur_scope = clock, act, scope
        return tok

    def _exit(self, tok) -> None:
        self.cur, self.cur_act, self.cur_scope = tok

    def _ev(self, kind: str, *info: Any) -> None:
        self.n_events += 1
        self.trace_events.append((self.rt.clock, kind) + info)

    def _add(self, key: Tuple, f: Finding) -> None:
        if key in self._keys:
            return
        self._keys.add(key)
        self.findings.append(f)

    def _scope_name(self, scope: Any) -> str:
        if scope is self:
            return "driver"
        if isinstance(scope, Guid):
            return f"edt {scope.node}:{scope.seq}"
        return f"handler {type(scope).__name__}#{getattr(scope, 'uid', '?')}"

    def _root(self, db: DbObj, off: int = 0) -> Tuple[Guid, int]:
        """Map ``db`` (+ local offset) to (root guid, offset in root)."""
        rt = self.rt
        while db.parent is not None:
            off += db.offset_in_parent
            p = rt.try_lookup(db.parent)
            if p is None:
                break
            db = p
        return db.guid, off

    # --------------------------------------------------- message transport

    def on_send(self, msg: Any) -> None:
        if self.cur_act is not None:
            # program order within an activity: each send is a fresh tick
            self.cur[self.cur_act] = self.cur.get(self.cur_act, 0) + 1
        msg._san_clock = dict(self.cur)

    def msg_begin(self, msg: Any):
        clk = msg._san_clock
        return self._enter(dict(clk) if clk is not None else {}, None, msg)

    def ctx_end(self, tok) -> None:
        self._exit(tok)

    # --------------------------------------------------------- task edges

    def on_task_created(self, guid: Guid) -> None:
        self._task_clock[guid] = dict(self.cur)

    def on_slot_satisfied(self, guid: Guid) -> None:
        base = self._task_clock.get(guid)
        if base is not None:
            join(base, self.cur)
        self._ev("satisfy-slot", guid)

    def on_event_satisfied(self, ev: EventObj) -> None:
        ec = self._ev_clock.setdefault(ev.guid, {})
        join(ec, self.cur)
        # the fan-out (if this satisfy fires the event) must carry the
        # join of *every* satisfier — latches accumulate across calls
        join(self.cur, ec)
        self._ev("satisfy-event", ev.guid)

    def on_event_replay(self, guid: Guid) -> None:
        # late dependence on an already-satisfied event (sticky / §3
        # tombstone): the dependent inherits the event's full history
        ec = self._ev_clock.get(guid)
        if ec:
            join(self.cur, ec)

    def on_grant(self, edt: EdtObj, deps: List[Tuple[DbObj, DbMode]]) -> None:
        g = edt.guid
        base = self._task_clock.pop(g, None)
        if base is None:
            base = dict(self.cur)
        act = self._new_act(f"edt {g.node}:{g.seq}")
        base[act] = 1
        for db, mode in deps:
            # lock-order edges: any acquisition orders after past exclusive
            # releases; an exclusive acquisition also orders after past
            # shared releases (§6 acquire protocol)
            rc = self._rel_excl.get(db.guid)
            if rc:
                join(base, rc)
            if mode in _EXCL:
                rs = self._rel_shared.get(db.guid)
                if rs:
                    join(base, rs)
        snap = dict(base)
        t = self.rt.clock
        for db, mode in deps:
            excl = mode in _EXCL
            root, b = self._root(db)
            d = db.guid
            label = (f"edt {g.node}:{g.seq} {mode.name} "
                     f"db {d.node}:{d.seq}[{b}:{b + db.size}) @t={t:g}")
            hit = self.races.record(
                root, Access(act, 1, snap, excl, b, b + db.size, label, t))
            if hit is not None:
                self._race(root, hit)
        self._task_act[g] = act
        self._task_clock[g] = base
        self._ev("grant", g, tuple(d.guid for d, _ in deps))

    def task_begin(self, guid: Guid):
        return self._enter(self._task_clock[guid], self._task_act[guid], guid)

    def task_end_begin(self, guid: Guid):
        clock = self._task_clock.get(guid)
        act = self._task_act.get(guid)
        if clock is None or act is None:      # defensive: unseen grant
            clock, act = dict(self.cur), None
        else:
            clock[act] = clock.get(act, 0) + 1
        return self._enter(clock, act, guid)

    def task_end_finish(self, guid: Guid, tok) -> None:
        self._exit(tok)
        done = self._task_clock.pop(guid, None)
        if done:
            join(self._done, done)
        self._task_act.pop(guid, None)

    def task_lost(self, guid: Guid) -> None:
        self._task_clock.pop(guid, None)
        self._task_act.pop(guid, None)

    # -------------------------------------------------------- locks & DBs

    def on_release(self, db: DbObj, exclusive: bool) -> None:
        tgt = self._rel_excl if exclusive else self._rel_shared
        join(tgt.setdefault(db.guid, {}), self.cur)
        self._ev("release", db.guid, "excl" if exclusive else "shared")

    def on_partition_create(self, parent: DbObj,
                            kids: List[Tuple[Guid, int, int]],
                            zero_copy: bool = False) -> None:
        reg = self._children.setdefault(parent.guid, {})
        rx = self._rel_excl.get(parent.guid)
        rs = self._rel_shared.get(parent.guid)
        for (g, o, s) in kids:
            lo, hi = o, o + s
            for og, (olo, ohi) in reg.items():
                if lo < ohi and olo < hi:
                    self._add(
                        (PARTITION_OVERLAP, parent.guid, g, og),
                        Finding(PARTITION_OVERLAP, (parent.guid, g, og),
                                f"partitions of {parent.guid} overlap: "
                                f"{g}[{lo}:{hi}) vs {og}[{olo}:{ohi}) — §6 "
                                f"partitions must be pairwise disjoint",
                                t=self.rt.clock))
            reg[g] = (lo, hi)
            # children inherit the parent's release order (§6.2): a child
            # writer is ordered after whoever released the parent before
            # the partitioning, and after the partitioning context itself
            ce = dict(self.cur)
            if rx:
                join(ce, rx)
            self._rel_excl[g] = ce
            self._rel_shared[g] = dict(rs) if rs else {}
        self._ev("partition-create", parent.guid, tuple(g for g, _, _ in kids),
                 "zero-copy" if zero_copy else "view")

    def on_db_destroyed(self, db: DbObj) -> None:
        g = db.guid
        kids = self._children.pop(g, None)
        if kids:
            self._add(
                (PARENT_BEFORE_CHILDREN, g),
                Finding(PARENT_BEFORE_CHILDREN, (g,) + tuple(kids),
                        f"{g} destroyed while {len(kids)} partition(s) live "
                        f"({', '.join(str(k) for k in list(kids)[:4])}) — "
                        f"§6.2 requires children released first",
                        t=self.rt.clock))
        p = db.parent
        if p is not None:
            # §6.2 quiescence edge: the child's lifetime (its lock history
            # and its destruction context) folds into the parent's release
            # clock, ordering parent tasks granted after child quiescence
            tgt = self._rel_excl.setdefault(p, {})
            for src in (self._rel_excl.pop(g, None),
                        self._rel_shared.pop(g, None)):
                if src:
                    join(tgt, src)
            join(tgt, self.cur)
            preg = self._children.get(p)
            if preg:
                preg.pop(g, None)
            self._ev("partition-release", g, p)
        else:
            self._rel_excl.pop(g, None)
            self._rel_shared.pop(g, None)
            self._copy_seq.pop(g, None)
            self.races.drop_root(g)
            self._ev("db-destroy", g)

    # ------------------------------------------------------------- copies

    def copy_begin(self, msg: Any):
        clk = dict(msg._san_clock) if msg._san_clock is not None else {}
        self._copy_n += 1
        act = self._new_act(f"copy#{self._copy_n}")
        clk[act] = 1
        return self._enter(clk, act, msg)

    def copy_end(self, tok) -> None:
        join(self._done, self.cur)
        self._exit(tok)

    def on_copy_access(self, db: DbObj, off: int, size: int,
                       write: bool) -> None:
        rc = self._rel_excl.get(db.guid)
        if rc:
            join(self.cur, rc)
        if write:
            rs = self._rel_shared.get(db.guid)
            if rs:
                join(self.cur, rs)
        root, b = self._root(db, off)
        cs = self._copy_seq.get(root)
        if cs:
            join(self.cur, cs)
        act = self.cur_act
        d = db.guid
        t = self.rt.clock
        label = (f"{self.names.get(act, 'copy')} "
                 f"{'write' if write else 'read'} "
                 f"db {d.node}:{d.seq}[{b}:{b + size}) @t={t:g}")
        hit = self.races.record(
            root, Access(act, self.cur.get(act, 1), dict(self.cur),
                         write, b, b + size, label, t))
        if hit is not None:
            self._race(root, hit)
        join(self._copy_seq.setdefault(root, {}), self.cur)
        self._ev("copy", d, off, size, "w" if write else "r")

    def _race(self, root: Guid, hit: Tuple[Access, Access]) -> None:
        old, new = hit
        self._race_count += 1
        self._add(
            (HB_RACE, old.act, old.tick, new.act, new.lo, new.hi),
            Finding(HB_RACE, (root, old.label, new.label),
                    f"unordered conflicting accesses to bytes of {root}: "
                    f"{old.label} vs {new.label}",
                    witness=((old.label, fmt_clock(old.clock, self.names)),
                             (new.label, fmt_clock(new.clock, self.names))),
                    t=self.rt.clock))

    # ------------------------------------------------------ LIDs & maps

    def on_lid_alloc(self, lid: Lid) -> None:
        self._lid_scope[lid] = self.cur_scope

    def on_lid_bound(self, lid: Lid, guid: Guid) -> None:
        self._lid_scope.pop(lid, None)
        self._ev("lid-bind", lid, guid)

    def on_ref(self, x: Any) -> None:
        """§3: an unbound LID is only meaningful in its creating scope.

        The driver scope is exempt as a *referrer*: the main program
        sequence created every task transitively and inspecting a LID
        from a driver-level ``TaskCtx`` (the standard post-``run()``
        poke in tests and benches) is not the concurrent-actor handoff
        §3 warns about — escapes between EDTs, and into message
        handlers, still flag."""
        if type(x) is not Lid:
            return
        if self.cur_scope is self:
            return
        home = self._lid_scope.get(x)
        if home is not None and home is not self.cur_scope:
            self._add(
                (LID_ESCAPE, x, id(self.cur_scope)),
                Finding(LID_ESCAPE, (x,),
                        f"{x} referenced from {self._scope_name(self.cur_scope)} "
                        f"before binding, but its §3 home scope is "
                        f"{self._scope_name(home)}",
                        t=self.rt.clock))

    def on_map_get(self, m: Any, index: int, created: bool,
                   guid: Guid) -> None:
        key = (m.guid, index)
        if created:
            n = self._map_creates.get(key, 0)
            self._map_creates[key] = n + 1
            if n or key in self._map_entries:
                self._add(
                    (GUID_DOUBLE_CREATE, key, n),
                    Finding(GUID_DOUBLE_CREATE, (m.guid, index),
                            f"labeled map {m.guid}[{index}] ran its creator "
                            f"{n + 1} times — §4 requires exactly-once "
                            f"creation per index",
                            t=self.rt.clock))
            self._map_entries[key] = guid
            self._ev("map-create", m.guid, index, guid)
        else:
            prev = self._map_entries.setdefault(key, guid)
            if prev != guid:
                self._add(
                    (GUID_NON_MEMOIZED, key),
                    Finding(GUID_NON_MEMOIZED, (m.guid, index),
                            f"labeled map {m.guid}[{index}] returned {guid} "
                            f"but previously returned {prev} — §4 requires "
                            f"memoized reuse of one GUID per index",
                            t=self.rt.clock))

    # -------------------------------------------------- trace-only events

    def on_io_done(self, op: Any) -> None:
        self._ev("io-done", op.kind, op.path, op.offset, op.size)

    def on_spill(self, victims: int, node: int) -> None:
        self._ev("spill", node, victims)

    def on_unspill(self, guid: Guid) -> None:
        self._ev("unspill", guid)

    def on_kill_node(self, idx: int) -> None:
        self._ev("kill-node", idx)

    # ------------------------------------------------------------ results

    def on_run_return(self) -> None:
        # the driver observes everything that retired: single-threaded DES
        # makes run()-return a real synchronization point for driver code
        join(self._driver_clock, self._done)
        self._done = {}
        if not self.rt._heap:
            quiescence_lost_wakeups(self)
        st = self.rt.stats
        st.san_events = self.n_events
        st.san_races = self._race_count
        st.san_findings = len(self.findings)
        st.san_advisories = len(quiescence_advisories(self)) \
            if not self.rt._heap else 0
        if self.strict and len(self.findings) > self._consumed:
            self._consumed = len(self.findings)
            raise OcrSanError(summarize(self.findings))

    def report(self) -> SanitizerReport:
        if not self.rt._heap:
            quiescence_lost_wakeups(self)
            adv = quiescence_advisories(self)
        else:
            adv = []
        self._consumed = len(self.findings)
        return SanitizerReport(findings=list(self.findings),
                               advisories=adv, events=self.n_events)

    def unconsumed_hard(self) -> List[Finding]:
        return self.findings[self._consumed:]

    def consume(self) -> None:
        self._consumed = len(self.findings)

    def export_trace(self, path: str) -> int:
        """Dump the structured event ring buffer as JSONL for offline
        analysis (one ``{"t", "kind", "info"}`` object per line; Guid /
        Lid / tuple values are tagged so :func:`load_trace` round-trips
        them exactly).  Returns the number of events written — at most
        ``TRACE_CAP``, the ring bound."""
        n = 0
        with open(path, "w") as f:
            for ev in self.trace_events:
                rec = {"t": ev[0], "kind": ev[1],
                       "info": [_enc_trace(x) for x in ev[2:]]}
                f.write(json.dumps(rec) + "\n")
                n += 1
        return n


def _enc_trace(x: Any) -> Any:
    if isinstance(x, Guid):
        return {"guid": [x.node, x.seq, x.kind.value]}
    if isinstance(x, Lid):
        return {"lid": [x.node, x.seq]}
    if isinstance(x, tuple):
        return {"tuple": [_enc_trace(v) for v in x]}
    return x


def _dec_trace(x: Any) -> Any:
    if isinstance(x, dict):
        if "guid" in x:
            node, seq, kind = x["guid"]
            return Guid(node, seq, ObjectKind(kind))
        if "lid" in x:
            return Lid(*x["lid"])
        if "tuple" in x:
            return tuple(_dec_trace(v) for v in x["tuple"])
    return x


def load_trace(path: str) -> List[Tuple]:
    """Read a :meth:`Sanitizer.export_trace` JSONL file back into the
    in-memory event-tuple form (``(t, kind, *info)``)."""
    out: List[Tuple] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            out.append((rec["t"], rec["kind"])
                       + tuple(_dec_trace(x) for x in rec["info"]))
    return out
