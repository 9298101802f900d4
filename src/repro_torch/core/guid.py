"""Identifiers for the OCR-extensions runtime.

The paper (§2) assumes GUIDs may encode creation-time information (owning
node, sequence number, object kind) and therefore cannot be pre-allocated
locally.  We implement exactly that representation: a ``Guid`` is a
``(node, seq, kind)`` triple.  A ``Lid`` (§3) is a *local identifier* — a
future for a GUID, valid only for API calls made by the creating task; it
carries the issuing node and a node-local sequence number.
"""
from __future__ import annotations

import dataclasses
import enum


class ObjectKind(enum.Enum):
    EDT = "edt"
    EVENT = "event"
    DATABLOCK = "db"
    TEMPLATE = "template"
    MAP = "map"
    FILE = "file"


class IdType(enum.Enum):
    """Result of ``ocrGetIdType`` (paper §3)."""

    GUID = "guid"
    LID = "lid"
    UNK = "unk"


class EventKind(enum.Enum):
    ONCE = "once"      # satisfied once, then auto-destroyed after fan-out
    STICKY = "sticky"  # stays satisfied; later dependences fire immediately
    LATCH = "latch"    # satisfied when its counter reaches zero


class DbMode(enum.Enum):
    """Data block acquire modes (OCR spec §1.0 + paper §6)."""

    RO = "ro"        # shared read
    CONST = "const"  # shared read, immutable for the whole task graph epoch
    RW = "rw"        # exclusive read/write (runtime must assume full aliasing)
    EW = "ew"        # exclusive write — exclusive, but *disjoint partitions*
    #                  acquired in EW run in parallel (the point of §6)
    NULL = "null"    # pure control dependence, no data access


@dataclasses.dataclass(frozen=True, eq=False)
class Guid:
    node: int
    seq: int
    kind: ObjectKind

    def __lt__(self, other: "Guid") -> bool:
        return (self.node, self.seq, self.kind.value) < \
            (other.node, other.seq, other.kind.value)

    def __post_init__(self) -> None:
        # guids key every object table and waiter queue — precompute the
        # hash once instead of re-hashing the (int, int, enum) tuple per probe
        object.__setattr__(self, "_hash", hash((self.node, self.seq, self.kind)))

    def __hash__(self) -> int:
        return self._hash  # type: ignore[attr-defined]

    def __eq__(self, other: object) -> bool:
        if other is self:
            return True
        if not isinstance(other, Guid):
            return NotImplemented
        return (self.node == other.node and self.seq == other.seq
                and self.kind is other.kind)

    def __repr__(self) -> str:  # compact, stable for traces
        return f"G({self.node}:{self.seq}:{self.kind.value})"


@dataclasses.dataclass(frozen=True, eq=False)
class Lid:
    """A future for a :class:`Guid` (paper §3).

    Only meaningful on ``node``; the runtime patches messages that carry a
    ``Lid`` once the corresponding ``M_map`` resolution arrives.
    """

    node: int
    seq: int

    def __lt__(self, other: "Lid") -> bool:
        return (self.node, self.seq) < (other.node, other.seq)

    def __post_init__(self) -> None:
        object.__setattr__(self, "_hash", hash((self.node, self.seq)))

    def __hash__(self) -> int:
        return self._hash  # type: ignore[attr-defined]

    def __eq__(self, other: object) -> bool:
        if other is self:
            return True
        if not isinstance(other, Lid):
            return NotImplemented
        return self.node == other.node and self.seq == other.seq

    def __repr__(self) -> str:
        return f"L({self.node}:{self.seq})"


# --------------------------------------------------------------- shard routing
#
# GUIDs encode creation-time structure — (node, seq, kind) — precisely so the
# runtime can exploit it (§2).  The per-node object tables
# (``repro_torch.core.objects.ObjectTable``) shard by kind, then by fixed-width seq
# range: routing a Guid to its shard is pure arithmetic on fields the
# identifier already carries (one shift), never a hash of the full triple.

GUID_SHARD_BITS = 8          # 2**8 = 256 seqs per shard


def shard_index(seq: int, bits: int = GUID_SHARD_BITS) -> int:
    """Index of the seq-range shard holding ``seq`` (O(1), one shift)."""
    return seq >> bits


def shard_span(index: int, bits: int = GUID_SHARD_BITS) -> "tuple[int, int]":
    """Half-open ``[lo, hi)`` seq range covered by shard ``index``."""
    return (index << bits, (index + 1) << bits)


def shard_of(gid: Guid, bits: int = GUID_SHARD_BITS) -> "tuple[ObjectKind, int]":
    """The ``(kind, seq-range)`` shard key a Guid routes to."""
    return (gid.kind, gid.seq >> bits)


# Sentinels (mirroring NULL_GUID / UNINITIALIZED_GUID in the paper's listings).
NULL_GUID = Guid(-1, -1, ObjectKind.EVENT)
UNINITIALIZED_GUID = Guid(-2, -2, ObjectKind.EVENT)

OcrId = object  # Guid | Lid | sentinel — informal union alias


def id_type(x: object) -> IdType:
    """``ocrGetIdType`` — classify an identifier (paper §3)."""
    if isinstance(x, Guid):
        return IdType.GUID
    if isinstance(x, Lid):
        return IdType.LID
    return IdType.UNK


def is_null(x: object) -> bool:
    return isinstance(x, Guid) and x == NULL_GUID


# Creation property flags (paper §3/§4 listings).
EDT_PROP_NONE = 0x0
EDT_PROP_LID = 0x1      # return a LID instead of blocking for a GUID
EDT_PROP_MAPPED = 0x2   # GUID parameter is in-out: a map-provided LID to bind
DB_PROP_NO_ACQUIRE = 0x4  # do not allocate/acquire at creation (§6.3)
OCR_DB_PARTITION_STATIC = 0x1  # §6.2: partitioning fixed until all destroyed

# ocrDbCopy copy types (§6.3).
DB_COPY_PLAIN = 0
DB_COPY_PARTITION = 1        # dst becomes a (possibly zero-copy) partition view
DB_COPY_PARTITION_BACK = 2   # write partition back; entails destruction of src
