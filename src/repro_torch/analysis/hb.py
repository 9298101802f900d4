"""Vector-clock happens-before engine for the OCR sanitizer.

Clocks are sparse dicts mapping an *activity id* (one per executed EDT,
plus one ambient "driver" activity per runtime and one per executed
``db_copy``) to that activity's tick.  Happens-before edges come from
exactly the places the runtime itself creates order:

- **EDT dependence edges** — a task's base clock is the join of its
  creation context and every ``_satisfy_slot`` context.
- **Event satisfaction** — an event accumulates every satisfier's clock
  and releases the join to its dependents (latches included: the fan-out
  only happens once all decrements arrived, so dependents inherit all).
- **Message send/receive** — every message carries a snapshot of its
  sender's clock; the handler runs under it.
- **Lock order** — per-DB release clocks (``rel_excl`` for writers,
  ``rel_shared`` for readers).  A grant joins ``rel_excl`` always and
  ``rel_shared`` for exclusive modes.  This mirrors the §6 acquire
  protocol: two RW tasks on *one* DB are serialized by the runtime's
  lock, which is real order, not a race — but overlapping accesses
  through *different* DbObjs (overlapping partitions, or a ``db_copy``
  landing into a block someone else holds) share no lock and are
  flagged.
- **Partition lifecycle (§6.2)** — children inherit the parent's release
  clocks at ``db_partition``; destroying the last child joins the
  children's clocks back into the parent's, so a parent task granted
  after quiescence is ordered after every child writer.

Accesses are mapped to byte ranges of the *root* DB (walking the §6
view chain), so disjoint partition siblings never conflict and
overlapping ones conflict exactly on the shared bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

Clock = Dict[int, int]


def join(dst: Clock, src: Clock) -> None:
    """In-place elementwise max."""
    for a, t in src.items():
        if dst.get(a, 0) < t:
            dst[a] = t


def ordered(act: int, tick: int, clock: Clock) -> bool:
    """True iff the event ``(act, tick)`` happens-before ``clock``."""
    return clock.get(act, 0) >= tick


@dataclasses.dataclass
class Access:
    act: int          # activity that performed the access
    tick: int         # that activity's tick at access time
    clock: Clock      # snapshot at access time (witness + hb test)
    write: bool
    lo: int           # byte range in root-DB coordinates
    hi: int
    label: str        # e.g. "edt 0:5 EW db 0:3[64:128)"
    t: float          # virtual time


class RaceDetector:
    """Per-root-DB access histories with covered-access pruning."""

    def __init__(self) -> None:
        self._hist: Dict[Any, List[Access]] = {}

    def record(self, root: Any, acc: Access) -> Optional[Tuple[Access, Access]]:
        """Record ``acc`` against root ``root``.

        Returns the first racing (old, new) pair found, or None.  The
        history is pruned: an old access that happens-before the new
        one, is range-covered by it, and is shadowed for conflict
        purposes (the new access writes, or neither writes) can never
        race with anything the old one wouldn't also race with through
        the new access, so it is dropped — serialized chains keep O(1)
        history.
        """
        hist = self._hist.get(root)
        if hist is None:
            self._hist[root] = [acc]
            return None
        race = None
        kept: List[Access] = []
        for old in hist:
            if old.hi > acc.lo and acc.hi > old.lo and \
                    (old.write or acc.write) and \
                    not ordered(old.act, old.tick, acc.clock):
                if race is None:
                    race = (old, acc)
            if ordered(old.act, old.tick, acc.clock) and \
                    old.lo >= acc.lo and old.hi <= acc.hi and \
                    (acc.write or not old.write):
                continue            # covered: prune
            kept.append(old)
        kept.append(acc)
        self._hist[root] = kept
        return race

    def drop_root(self, root: Any) -> None:
        self._hist.pop(root, None)

    def history_len(self, root: Any) -> int:
        return len(self._hist.get(root, ()))
