"""Runtime messages (paper §2/§3).

Every OCR API call translates into one or more messages.  Messages that
reference an unresolved :class:`~repro_torch.core.guid.Lid` are *deferred* on the
receiving side until the ``MMap`` resolution for that LID arrives, at which
point the runtime patches the LID to the real GUID and re-submits the
message — exactly the M_create / M_dep / M_map protocol of §3.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional

from .guid import DbMode, Guid, Lid

_msg_counter = itertools.count()


@dataclasses.dataclass
class Message:
    """Base class; ``uid`` makes scheduler ordering deterministic."""

    src_node: int = dataclasses.field(init=False, default=-1)
    dst_node: int = dataclasses.field(init=False, default=-1)
    uid: int = dataclasses.field(init=False, default=-1)
    # sanitizer-only: sender's vector-clock snapshot, stamped at send time
    # when ``Runtime(sanitize=...)`` is on (class attr keeps the off path
    # allocation-free)
    _san_clock = None

    def stamp(self, src: int, dst: int) -> "Message":
        self.src_node = src
        self.dst_node = dst
        self.uid = next(_msg_counter)
        return self

    def lids(self) -> List[Lid]:
        """LIDs this message references (for deferred patching)."""
        return [x for x in self._id_fields() if isinstance(x, Lid)]

    def _id_fields(self) -> List[Any]:
        return []

    def patch(self, mapping: Dict[Lid, Guid]) -> None:
        """Replace resolved LIDs with GUIDs in-place."""
        raise NotImplementedError


def _patch_one(x: Any, mapping: Dict[Lid, Guid]) -> Any:
    if isinstance(x, Lid) and x in mapping:
        return mapping[x]
    return x


@dataclasses.dataclass
class MCreate(Message):
    """Create an object on ``dst_node``; bind it to ``lid`` (if any)."""

    kind: str = ""                      # "edt" | "event" | "db" | "template" | "map" | "file"
    lid: Optional[Lid] = None           # identity future to resolve
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def _id_fields(self):
        # Creation payloads may embed ids (e.g. template guid, guidv array)
        out: List[Any] = []
        for v in self.payload.values():
            if isinstance(v, (Guid, Lid)):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                out.extend(e for e in v if isinstance(e, (Guid, Lid)))
        return out

    def patch(self, mapping):
        for k, v in list(self.payload.items()):
            if isinstance(v, (Lid, Guid)):
                self.payload[k] = _patch_one(v, mapping)
            elif isinstance(v, list):
                self.payload[k] = [_patch_one(e, mapping) for e in v]
            elif isinstance(v, tuple):
                self.payload[k] = tuple(_patch_one(e, mapping) for e in v)


@dataclasses.dataclass
class MMap(Message):
    """LID → GUID resolution, sent back to the LID's issuing node (§3 step 3)."""

    lid: Optional[Lid] = None
    guid: Optional[Guid] = None

    def patch(self, mapping):
        pass


@dataclasses.dataclass
class MDep(Message):
    """ocrAddDependence: source (event/db) → dest pre-slot."""

    source: Any = None
    dest: Any = None
    slot: int = 0
    mode: DbMode = DbMode.RO

    def _id_fields(self):
        return [self.source, self.dest]

    def patch(self, mapping):
        self.source = _patch_one(self.source, mapping)
        self.dest = _patch_one(self.dest, mapping)


@dataclasses.dataclass
class MSatisfy(Message):
    """ocrEventSatisfy: deliver ``db`` to ``target``'s ``slot``."""

    target: Any = None
    slot: int = 0
    db: Any = None

    def _id_fields(self):
        return [self.target, self.db]

    def patch(self, mapping):
        self.target = _patch_one(self.target, mapping)
        self.db = _patch_one(self.db, mapping)


@dataclasses.dataclass
class MDestroy(Message):
    target: Any = None

    def _id_fields(self):
        return [self.target]

    def patch(self, mapping):
        self.target = _patch_one(self.target, mapping)


@dataclasses.dataclass
class MMapGet(Message):
    """ocrMapGet request: resolve (map, index) to a GUID, binding ``lid``."""

    map_id: Any = None
    index: int = 0
    lid: Optional[Lid] = None

    def _id_fields(self):
        return [self.map_id]

    def patch(self, mapping):
        self.map_id = _patch_one(self.map_id, mapping)


@dataclasses.dataclass
class MDbCopy(Message):
    """ocrDbCopy (§6.3)."""

    dst: Any = None
    dst_offset: int = 0
    src: Any = None
    src_offset: int = 0
    size: int = 0
    copy_type: int = 0
    completion_event: Any = None

    def _id_fields(self):
        return [self.dst, self.src, self.completion_event]

    def patch(self, mapping):
        self.dst = _patch_one(self.dst, mapping)
        self.src = _patch_one(self.src, mapping)
        self.completion_event = _patch_one(self.completion_event, mapping)


@dataclasses.dataclass
class MIoDone(Message):
    """Completion of one asynchronous §5 disk operation (io_queue.IoOp).

    Delivered on the owning node at the op's virtual completion time; the
    real OS read/write happens at delivery, so operations in flight on a
    fail-stopped node (or past a ``run(until)`` horizon) are lost — the
    crash semantics checkpoint commit is built on.
    """

    op: Any = None

    def patch(self, mapping):
        pass


@dataclasses.dataclass
class MFileOpened(Message):
    """Asynchronous completion of ocrFileOpen: fills the descriptor DB (§5)."""

    file_guid: Optional[Guid] = None
    descriptor_db: Any = None
    size: int = 0

    def _id_fields(self):
        return [self.descriptor_db]

    def patch(self, mapping):
        self.descriptor_db = _patch_one(self.descriptor_db, mapping)
