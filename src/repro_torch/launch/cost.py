"""What one rank's step computes, moves, communicates and holds (the
port's counterpart of ``repro.launch.hlo_cost``).

The reference parses post-SPMD HLO text, because ``cost_analysis``
counts a loop body once.  The port runs eagerly, so every layer runs and
the trip counts come for free: :func:`measure` runs a function (a train
step, a prefill, a decode step) under a ``TorchDispatchMode`` and counts
every aten op it executes, and the hand-written kernels count themselves
(``kernels.counts``).  On the meta device — the dry run — nothing has
storage, so a full-width step of one rank of the production mesh runs on
the CPU in seconds; on the card the same counts come from the live step.

A :class:`CostReport` holds:

* ``flops``: the aten ops' FLOPs, by ``torch.utils.flop_counter``'s
  formulas (its registry: matmuls, convolutions, attention ops — what
  ``FlopCounterMode`` counts, without its decomposition of ops it has no
  formula for, which here are elementwise backwards such as
  ``silu_backward``: decomposed, they would add their temporaries to the
  peak), plus the kernels' (``kernel_flops``);
* ``bytes``: operand + result bytes of every aten op and kernel executed
  — the eager, unfused traffic — with views and metadata ops skipped, as
  ``hlo_cost._SKIP_BYTES`` skips parameters, tuples and bitcasts;
* ``coll_bytes`` / ``coll_counts``: the collectives' bytes and calls by
  "kind/axis", from ``dist.sharding.TRAFFIC``;
* ``peak_bytes``: the most bytes live at once on the step's device — a
  tally of its storages, the arguments' from the start, each other one
  from the op that allocates it to the moment it is freed;
* ``arg_bytes`` / ``out_bytes``: the arguments' and the results'
  storages on that device.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.dist import sharding
from repro_torch.kernels import counts

_aten = torch.ops.aten

# allocations and metadata: no bytes move (the reference's _SKIP_BYTES)
_SKIP_BYTES = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.new_empty.default, _aten.new_empty_strided.default,
    _aten.empty_like.default, _aten.detach.default, _aten.lift_fresh.default,
    _aten.alias.default, _aten._local_scalar_dense.default,
}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class CostReport:
    aten_flops: float = 0.0
    kernel_flops: float = 0.0
    aten_bytes: float = 0.0
    kernel_bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernels: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    arg_bytes: int = 0
    out_bytes: int = 0
    peak_bytes: int = 0
    ops: int = 0

    @property
    def flops(self) -> float:
        return self.aten_flops + self.kernel_flops

    @property
    def bytes(self) -> float:
        return self.aten_bytes + self.kernel_bytes

    @property
    def coll_total(self) -> float:
        return sum(self.coll_bytes.values())


class _Tally:
    """Live bytes of the storages on one device: each storage is counted
    from the first op whose result lies in it until its weak reference
    dies."""

    def __init__(self, device: torch.device):
        self.device = device
        self.live: Dict[int, int] = {}
        self.now = self.peak = 0

    def add(self, t: torch.Tensor) -> None:
        if t.device != self.device:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)


class _CostMode(TorchDispatchMode):
    """FLOPs and bytes of every executed op, and the device's storages."""

    def __init__(self, report: CostReport, tally: _Tally):
        super().__init__()
        self.report, self.tally = report, tally

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.report.aten_flops += formula(*args, **kwargs, out_val=out)
        results = _tensors(out)
        for t in results:
            self.tally.add(t)
        if not (func.is_view or func in _SKIP_BYTES):
            self.report.ops += 1
            self.report.aten_bytes += (
                sum(_nbytes(t) for t in _tensors((args, kwargs)))
                + sum(_nbytes(t) for t in results))
        return out


def _storage_bytes(tensors, device) -> int:
    seen = {}
    for t in tensors:
        if t.device == device:
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def measure(fn: Callable, *args, device="meta") -> Tuple[Any, CostReport]:
    """Run ``fn(*args)`` and count it (module docs): returns (its result,
    the :class:`CostReport`).  ``TRAFFIC`` and ``kernels.counts.KERNELS``
    are reset first and read after; ``device`` is the device whose
    storages the peak tallies."""
    device = torch.device(device)
    report = CostReport()
    tally = _Tally(device)
    arg_tensors = _tensors(args)
    for t in arg_tensors:
        tally.add(t)
    report.arg_bytes = tally.now
    sharding.reset_traffic()
    counts.reset()
    with _CostMode(report, tally):
        out = fn(*args)
    report.out_bytes = _storage_bytes(_tensors(out), device)
    report.peak_bytes = tally.peak
    report.kernels = {k: list(v) for k, v in counts.KERNELS.items()}
    report.kernel_flops = float(sum(v[1] for v in counts.KERNELS.values()))
    report.kernel_bytes = float(sum(v[2] for v in counts.KERNELS.values()))
    for key, (calls, nbytes, _big) in sharding.TRAFFIC.items():
        report.coll_counts[key] = float(calls)
        report.coll_bytes[key] = float(nbytes)
    return out, report
