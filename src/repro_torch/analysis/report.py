"""Findings and reports for the OCR sanitizer.

A :class:`Finding` is one detected violation of a paper invariant (or a
happens-before race).  Hard findings fail strict runs; advisory findings
(leaks, dangling slots) are reported but never raise, because many tests
legitimately end with live objects that the driver inspects after
``run()`` returns.

The vector-clock witness attached to a race names the two unordered
accesses with their clocks, so a report reader can see *why* the
sanitizer considers them concurrent: neither clock contains the other
access's ``(activity, tick)`` component.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

from repro_torch.core.objects import OcrError

# ------------------------------------------------------------ finding kinds

HB_RACE = "hb-race"
LID_ESCAPE = "lid-escape"
GUID_DOUBLE_CREATE = "guid-double-create"
GUID_NON_MEMOIZED = "guid-non-memoized"
PARTITION_OVERLAP = "partition-overlap"
PARENT_BEFORE_CHILDREN = "parent-released-before-children"
LOST_WAKEUP = "lost-wakeup"
LEAK = "leak"                      # advisory
DANGLING_SLOT = "dangling-slot"    # advisory

HARD_KINDS = frozenset({
    HB_RACE, LID_ESCAPE, GUID_DOUBLE_CREATE, GUID_NON_MEMOIZED,
    PARTITION_OVERLAP, PARENT_BEFORE_CHILDREN, LOST_WAKEUP,
})


class OcrSanError(OcrError):
    """Raised at ``run()`` return in strict mode when hard findings exist."""


def fmt_clock(clock: Dict[Any, int], names: Dict[int, str]) -> str:
    """Render a vector clock as ``{name@tick, ...}`` with stable order."""
    items = sorted(clock.items())
    return "{" + ", ".join(
        f"{names.get(a, f'act{a}')}@{t}" for a, t in items) + "}"


@dataclasses.dataclass
class Finding:
    kind: str
    objects: Tuple[Any, ...]
    message: str
    # vector-clock witness: list of (label, rendered clock) pairs
    witness: Tuple[Tuple[str, str], ...] = ()
    t: float = 0.0

    @property
    def hard(self) -> bool:
        return self.kind in HARD_KINDS

    def __str__(self) -> str:
        lines = [f"[{self.kind}] t={self.t:g} {self.message}"]
        for label, clk in self.witness:
            lines.append(f"    {label}: {clk}")
        return "\n".join(lines)


@dataclasses.dataclass
class SanitizerReport:
    findings: List[Finding]          # hard findings
    advisories: List[Finding]        # leaks / dangling slots
    events: int = 0                  # trace events recorded

    def kinds(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings + self.advisories:
            out[f.kind] = out.get(f.kind, 0) + 1
        return out

    def __bool__(self) -> bool:
        return bool(self.findings)

    def __str__(self) -> str:
        if not self.findings and not self.advisories:
            return f"ocrsan: clean ({self.events} events)"
        parts = [f"ocrsan: {len(self.findings)} finding(s), "
                 f"{len(self.advisories)} advisory(ies), "
                 f"{self.events} events"]
        parts += [str(f) for f in self.findings]
        parts += [str(f) for f in self.advisories]
        return "\n".join(parts)


def summarize(findings: Sequence[Finding]) -> str:
    kinds: Dict[str, int] = {}
    for f in findings:
        kinds[f.kind] = kinds.get(f.kind, 0) + 1
    body = ", ".join(f"{k}×{n}" for k, n in sorted(kinds.items()))
    head = f"ocrsan: {len(findings)} hard finding(s): {body}"
    detail = "\n".join(str(f) for f in list(findings)[:8])
    return head + ("\n" + detail if detail else "")
