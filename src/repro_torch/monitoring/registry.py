"""One snapshotable metrics registry across every layer of the runtime.

The paper's §5 argument — build file IO by reusing the data-block
concepts instead of inventing a parallel subsystem — applied one level
up: rather than per-layer stats dataclasses refreshed at ``run()``
return, the runtime, IO queue, checkpointer, sanitizer, trainer, and
serve engine all publish into one flat name → value registry that can
be snapshotted *mid-run* without stopping virtual time.

Three metric kinds:

- **counters / gauges** — plain ints/floats in a flat dict keyed by
  dotted names (``io.queue_depth``, ``spill.frag_bytes``, …).  Writers
  use :meth:`Registry.inc` / :meth:`Registry.set`; hot paths that
  already hold a field reference (the ``Stats`` property view) write
  the dict slot directly.
- **histograms** — fixed virtual-time bucket edges (geometric, four
  per decade over 1e-6..1e3 s) so two runs of the same schedule
  produce byte-identical snapshots; quantiles interpolate inside the
  hit bucket deterministically.
- **snapshots** — :meth:`Registry.snapshot` returns a sorted flat dict
  (histograms contribute ``<name>.count/.sum/.p50/.p99``), cheap
  enough to call from inside a serve loop every few virtual ms.

Everything here is deterministic: no wall clocks, no sampling, and the
bucket edges are constants — snapshots of virtual metrics diff clean
across commits, exactly like the ``BENCH_*.json`` files.
"""
from __future__ import annotations

import bisect
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "DEFAULT_LATENCY_EDGES",
    "Histogram",
    "Monitor",
    "Registry",
]

# Four buckets per decade, 1e-6 .. 1e3 virtual seconds.  Fixed at import
# time so histogram snapshots are diffable across runs and commits.
DEFAULT_LATENCY_EDGES: Tuple[float, ...] = tuple(
    10.0 ** (e / 4.0) for e in range(-24, 13)
)


class Histogram:
    """Fixed-edge latency histogram with deterministic quantiles.

    Bucket ``i`` holds observations ``x`` with ``edges[i-1] < x <=
    edges[i]`` (bucket 0 is the underflow ``x <= edges[0]``, the last
    bucket the overflow).  :meth:`quantile` linearly interpolates
    within the hit bucket — underflow interpolates over ``[0,
    edges[0]]``, overflow clamps to ``edges[-1]`` — so the result is a
    pure function of the counts, never of observation order.
    """

    __slots__ = ("name", "edges", "counts", "count", "total")

    def __init__(self, name: str,
                 edges: Sequence[float] = DEFAULT_LATENCY_EDGES):
        self.name = name
        self.edges: Tuple[float, ...] = tuple(float(e) for e in edges)
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.count = 0
        self.total = 0.0

    def observe(self, x: float) -> None:
        self.counts[bisect.bisect_left(self.edges, x)] += 1
        self.count += 1
        self.total += x

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c and cum + c >= rank:
                if i >= len(self.edges):
                    return self.edges[-1]
                lo = 0.0 if i == 0 else self.edges[i - 1]
                hi = self.edges[i]
                return lo + (hi - lo) * (max(rank - cum, 0.0) / c)
            cum += c
        return self.edges[-1]

    def summary(self) -> Dict[str, float]:
        return {
            f"{self.name}.count": self.count,
            f"{self.name}.sum": self.total,
            f"{self.name}.p50": self.quantile(0.50),
            f"{self.name}.p99": self.quantile(0.99),
        }

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Histogram({self.name!r}, count={self.count}, "
                f"p50={self.quantile(0.5):.3g}, p99={self.quantile(0.99):.3g})")


class Registry:
    """Flat dotted-name → scalar store plus named histograms.

    The scalar dict is exposed (``_values``) on purpose: the ``Stats``
    and ``CkptStats`` property views write slots directly so the ~40
    pre-registry increment sites stay one dict store, not a method
    call.  Names are namespaced by convention (``runtime.*``, ``io.*``,
    ``table.*``, ``spill.*``, ``san.*``, ``moe.*``, ``ckpt.*``,
    ``serve.*``, ``train.*``, ``edt.*`` — see the README Monitoring
    table).
    """

    __slots__ = ("_values", "_hists")

    def __init__(self) -> None:
        self._values: Dict[str, Any] = {}
        self._hists: Dict[str, Histogram] = {}

    def declare(self, name: str, initial: Any = 0) -> None:
        self._values.setdefault(name, initial)

    def inc(self, name: str, n: Any = 1) -> None:
        self._values[name] = self._values.get(name, 0) + n

    def set(self, name: str, value: Any) -> None:
        self._values[name] = value

    def value(self, name: str, default: Any = 0) -> Any:
        if name in self._values:
            return self._values[name]
        h = self._hists.get(name)
        return h.count if h is not None else default

    def histogram(self, name: str,
                  edges: Optional[Sequence[float]] = None) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = Histogram(name, edges if edges is not None
                          else DEFAULT_LATENCY_EDGES)
            self._hists[name] = h
        return h

    def snapshot(self, prefix: str = "") -> Dict[str, Any]:
        """Sorted flat view of every metric under ``prefix`` (all when
        empty).  Cheap — no virtual time passes, nothing is reset."""
        out: Dict[str, Any] = {}
        for k, v in self._values.items():
            if k.startswith(prefix):
                out[k] = v
        for k, h in self._hists.items():
            if k.startswith(prefix):
                out.update(h.summary())
        return dict(sorted(out.items()))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Registry({len(self._values)} scalars, "
                f"{len(self._hists)} histograms)")


class Monitor:
    """Hook sink the runtime holds when monitoring is on.

    Mirrors the sanitizer wiring: the runtime keeps ``self._mon
    = None`` when off, and every hook site is a single ``is not None``
    check, so the monitored-off hot path pays one pointer compare and
    the virtual schedule — and therefore every committed bench metric —
    is bit-identical either way.
    """

    __slots__ = ("registry",)

    def __init__(self, registry: Registry):
        self.registry = registry

    def on_edt(self, cls: str, grant_wait: float, execute: float) -> None:
        """Per-EDT-class latency observation at retirement: virtual
        time from ready→grant and from grant→end."""
        reg = self.registry
        reg.histogram("edt.grant_wait." + cls).observe(grant_wait)
        reg.histogram("edt.execute." + cls).observe(execute)

    def on_io(self, queue: Any) -> None:
        """Refresh the live IO gauges off the queue's current state
        (called at submit, at completion, and on demand before a
        snapshot — the gauges are as fresh as the last call)."""
        reg = self.registry
        reg.set("io.inflight_ops", queue.inflight)
        reg.set("io.reads_inflight", queue.reads_inflight)
        reg.set("io.queue_depth", queue.queue_depth())
