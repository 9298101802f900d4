"""``repro_torch.monitoring`` — the live observability plane.

One deterministic metrics registry (counters, gauges, fixed-edge
latency histograms) that every layer publishes into: ``Runtime.stats``
and ``CkptStats`` are field-compatible views over it, the IO queue
refreshes ``io.*`` gauges at submit/completion, the sanitizer's
``san_*`` totals land in ``san.*``, the trainer stamps ``train.*`` per
step, and the serve engine snapshots it mid-run to gate admission on
live queue depth / inflight-IO backpressure.

Enable per-runtime with ``Runtime(monitor=True)`` (or the
``REPRO_MONITOR`` environment variable); off by default — hook sites
follow the sanitizer's one-``is None``-check pattern so virtual
metrics stay bit-identical either way.
"""
from .registry import DEFAULT_LATENCY_EDGES, Histogram, Monitor, Registry

__all__ = ["DEFAULT_LATENCY_EDGES", "Histogram", "Monitor", "Registry"]
