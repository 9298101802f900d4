"""The paper's primary contribution: OCR extensions as a composable runtime.

Local identifiers (§3), labeled GUID maps with creator functions (§4),
file-mapped data blocks (§5), and data block partitioning (§6) — realized
as a deterministic virtual-time multi-node runtime that the higher layers
(trainer, checkpointing, pipeline schedule, serving cache) build on.
"""
from .guid import (
    DB_COPY_PARTITION,
    DB_COPY_PARTITION_BACK,
    DB_COPY_PLAIN,
    DB_PROP_NO_ACQUIRE,
    EDT_PROP_LID,
    EDT_PROP_MAPPED,
    EDT_PROP_NONE,
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
    shard_index,
    shard_of,
    shard_span,
)
from .objects import (
    ChunkOverlapError,
    DepEntry,
    FileModeError,
    ObjectTable,
    OcrError,
    PartitionDeadlockError,
    PartitionOverlapError,
    PartitionStaticError,
)
from .runtime import Runtime, Stats, TaskCtx, spawn_main

__all__ = [
    "Runtime", "TaskCtx", "Stats", "spawn_main",
    "Guid", "Lid", "IdType", "ObjectKind", "EventKind", "DbMode",
    "NULL_GUID", "UNINITIALIZED_GUID", "id_type", "is_null",
    "GUID_SHARD_BITS", "shard_index", "shard_of", "shard_span",
    "ObjectTable",
    "EDT_PROP_NONE", "EDT_PROP_LID", "EDT_PROP_MAPPED",
    "DB_PROP_NO_ACQUIRE", "OCR_DB_PARTITION_STATIC",
    "DB_COPY_PLAIN", "DB_COPY_PARTITION", "DB_COPY_PARTITION_BACK",
    "OcrError", "PartitionOverlapError", "PartitionDeadlockError",
    "PartitionStaticError", "ChunkOverlapError", "FileModeError",
    "DepEntry",
]
