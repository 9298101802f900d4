"""``repro_torch.analysis`` — the OCR sanitizer (``ocrsan``).

A happens-before race detector plus invariant lints over the runtime's
event stream.  Enable with ``Runtime(sanitize=True)`` (record-only),
``Runtime(sanitize="strict")`` (raise :class:`OcrSanError` at ``run()``
return on hard findings), or the ``REPRO_SANITIZE`` environment variable
(``1``/``strict`` → strict, ``record`` → record-only).

See the README "Sanitizer" section for finding kinds and the
vector-clock witness format.
"""
from .hb import Access, Clock, RaceDetector, join, ordered
from .report import (
    DANGLING_SLOT,
    Finding,
    GUID_DOUBLE_CREATE,
    GUID_NON_MEMOIZED,
    HARD_KINDS,
    HB_RACE,
    LEAK,
    LID_ESCAPE,
    LOST_WAKEUP,
    OcrSanError,
    PARTITION_OVERLAP,
    PARENT_BEFORE_CHILDREN,
    SanitizerReport,
)
from .trace import Sanitizer, active_sanitizers, load_trace

__all__ = [
    "Access", "Clock", "RaceDetector", "join", "ordered",
    "Finding", "SanitizerReport", "OcrSanError", "HARD_KINDS",
    "HB_RACE", "LID_ESCAPE", "GUID_DOUBLE_CREATE", "GUID_NON_MEMOIZED",
    "PARTITION_OVERLAP", "PARENT_BEFORE_CHILDREN", "LOST_WAKEUP",
    "LEAK", "DANGLING_SLOT",
    "Sanitizer", "active_sanitizers", "load_trace",
]
