"""Quiescence lints: checks that only make sense once the heap drains.

Two tiers:

- :func:`quiescence_lost_wakeups` finds parked waiters nothing will ever
  wake — **hard** findings (the runtime lost a wakeup, or a release path
  forgot ``_wake_waiters``).  Only run when the event heap is empty: a
  waiter with in-flight messages may still be woken.
- :func:`quiescence_advisories` reports leaked objects and dangling
  dependence slots — **advisory** findings, computed fresh on demand and
  never raised, because many programs legitimately end with live DBs the
  driver reads after ``run()`` returns.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, List

from repro_torch.core.guid import DbMode, Guid
from repro_torch.core.objects import DbObj, EdtObj, EventObj

from .report import DANGLING_SLOT, Finding, LEAK, LOST_WAKEUP

if TYPE_CHECKING:  # pragma: no cover
    from .trace import Sanitizer


def _deps_available(rt, edt: EdtObj) -> bool:
    """Would ``_try_grant`` succeed for ``edt`` right now?"""
    for slot, mode in zip(edt.slots, edt.modes):
        if not isinstance(slot, Guid) or mode == DbMode.NULL:
            continue
        db = rt.try_lookup(slot)
        if db is None:
            continue        # grant skips missing DBs too
        if db.partitions:
            return False    # §6.2: parked until children release
        if not db.available(mode):
            return False
    return True


def quiescence_lost_wakeups(san: "Sanitizer") -> None:
    """Flag ready waiters parked on a DB that is free (hard findings).

    At quiescence every queue entry is stale, dead, or lost.  A live,
    ready EDT whose *entire* dependence set is grantable yet still sits
    in a waiter queue means some release path dropped its wakeup.
    """
    rt = san.rt
    for dbg, queue in rt._db_waiters.items():
        for edt in queue:
            if edt.waiting_on != dbg or edt.state != "ready":
                continue    # stale entry (already woken / re-parked)
            if not rt.nodes[edt.node].alive:
                continue
            g = edt.guid
            db = rt.try_lookup(dbg)
            if db is None:
                san._add(
                    (LOST_WAKEUP, g),
                    Finding(LOST_WAKEUP, (g, dbg),
                            f"edt {g.node}:{g.seq} parked on destroyed "
                            f"db {dbg.node}:{dbg.seq} at quiescence — "
                            f"destroy path never woke its waiters",
                            t=rt.clock))
            elif _deps_available(rt, edt):
                san._add(
                    (LOST_WAKEUP, g),
                    Finding(LOST_WAKEUP, (g, dbg),
                            f"edt {g.node}:{g.seq} parked on free "
                            f"db {dbg.node}:{dbg.seq} at quiescence with "
                            f"every dependence grantable — lost wakeup",
                            t=rt.clock))


def quiescence_advisories(san: "Sanitizer") -> List[Finding]:
    """Leaked DBs/events and dangling dependence slots (advisory)."""
    rt = san.rt
    out: List[Finding] = []
    leaked_dbs: List[Guid] = []
    leaked_evs: List[Guid] = []
    dangling: List[Guid] = []
    for node in rt.nodes:
        if not node.alive:
            continue
        for obj in node.objects.values():
            if isinstance(obj, DbObj):
                if not obj.destroyed:
                    leaked_dbs.append(obj.guid)
            elif isinstance(obj, EventObj):
                if not obj.satisfied and not obj.destroyed:
                    leaked_evs.append(obj.guid)
            elif isinstance(obj, EdtObj):
                if obj.state == "created" and obj.pending > 0:
                    dangling.append(obj.guid)

    def _agg(kind: str, guids: List[Guid], what: str) -> None:
        sample = ", ".join(str(g) for g in guids[:4])
        more = f" (+{len(guids) - 4} more)" if len(guids) > 4 else ""
        out.append(Finding(kind, tuple(guids[:16]),
                           f"{len(guids)} {what} at quiescence: "
                           f"{sample}{more}",
                           t=rt.clock))

    if leaked_dbs:
        _agg(LEAK, leaked_dbs, "data block(s) never destroyed")
    if leaked_evs:
        _agg(LEAK, leaked_evs, "event(s) never satisfied nor destroyed")
    if dangling:
        _agg(DANGLING_SLOT, dangling,
             "EDT(s) with unsatisfied dependence slots")
    return out
