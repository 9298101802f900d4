"""K6, K7, K8: the §6.3 ``ocrDbCopy(DB_COPY_PARTITION)`` copy on Hopper.

Replaces the Pallas TPU kernels of ``repro/kernels/partition_copy.py``:

* :func:`partition_copy` (K6, for ``_copy_kernel``) — one tile-aligned
  contiguous row range;
* :func:`multi_partition_copy_tiles` (K7, for the inner kernel of
  ``_multi_partition_copy_impl``) — a whole partition set of N disjoint
  lane-granular ranges in one launch, one block per ``block_rows`` entry
  of the set's range descriptor;
* :func:`multi_partition_copy_staged` (K8, for the inner kernel of
  ``_multi_partition_copy_dma``) — the same function above
  :data:`DMA_STAGE_BYTES`, chunks staged through shared memory by bulk
  copies with the next chunk's load in flight.

:func:`multi_partition_copy` routes between K7 and K8 by the reference's
rule (:func:`dma_staged`).  The CUDA source is ``csrc/partition_copy.cu``.

K7 and K8 take a partition set as its range descriptor
(:func:`range_descriptor`): four int32 columns over the ranges, from
which each block finds its own entry on the card, in place of the TPU's
per-entry tables.  Up to :data:`MAX_PARAM_RANGES` ranges it travels in
the launch's parameters, past that as one small tensor on the card
(:func:`descriptor_route`); the host work of a call is O(ranges).

Buffers are (rows, 128) uint8 views and the wrappers update ``dst`` in
place (the TPU kernels alias it as their output); ``src`` must not share
memory with ``dst``, and destination ranges must be disjoint.  Unlike the
TPU kernels, which merge an edge tile by a masked read-modify-write that
is safe only because their grid runs in table order, every block here
writes only its valid rows and never reads ``dst``, so blocks may run in
any order.  Each kernel has a plain PyTorch version beside it (range
assignment on the views), which CPU tensors take; CUDA tensors launch
the kernel or raise.  ``<wrapper>.launches`` counts kernel launches and
``<wrapper>.last_route`` names the descriptor route of the last one.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .autotune import SMEM_OPTIN_BYTES, plan_copy_chunk

LANES = 128
BLOCK_ROWS = 256               # K6/K7 tile: 256 rows = 32 KiB

# Buffer size above which multi_partition_copy takes the staged kernel
# (K8), as in the reference.
DMA_STAGE_BYTES = 16 * 2 ** 20

# Ranges a descriptor may hold in the kernels' parameters (csrc's
# ParamRanges: 8 + 16 x 240 B with the kernels' pointers stays under the
# 4 KB parameter limit); a larger set goes to the card as a tensor.
MAX_PARAM_RANGES = 240

_MAX_ROWS = 2 ** 31 - 1        # the kernels take row indices as int32


def dma_staged(dst_bytes: int, src_bytes: int) -> bool:
    """True when a copy over buffers this large takes the staged path
    (either buffer larger than :data:`DMA_STAGE_BYTES`)."""
    return max(dst_bytes, src_bytes) > DMA_STAGE_BYTES


def as_rows(ranges) -> np.ndarray:
    """``(dst_row, src_row, rows)`` triples as an (n, 3) int64 array (an
    array of them is taken as it is)."""
    if isinstance(ranges, np.ndarray):
        return ranges.astype(np.int64, copy=False).reshape(-1, 3)
    return np.fromiter(itertools.chain.from_iterable(ranges),
                       np.int64).reshape(-1, 3)


def range_descriptor(ranges, entry_rows: int):
    """K7's and K8's view of a partition set: ``(cols, total)``.

    ``cols`` is (4, n) int32: each range's dst row, src row, rows and
    first entry, the exclusive prefix of ``ceil(rows / entry_rows)``;
    ``total`` is the number of entries.  Entry ``e`` belongs to the range
    ``i`` with ``first[i] <= e < first[i + 1]`` and holds ``min(entry_rows,
    rows - r0)`` rows from ``r0 = (e - first[i]) * entry_rows`` on: the
    reference's ``_block_tables`` entries, in its order.  An empty range
    has no entry.  One vectorised pass, no loop over entries.
    """
    r = as_rows(ranges)
    cols = np.empty((4, len(r)), np.int32)
    if not len(r):
        return cols, 0
    counts = (r[:, 2] + (entry_rows - 1)) // entry_rows
    cols[:3] = r.T
    cols[3, 0] = 0
    np.cumsum(counts[:-1], out=cols[3, 1:])
    return cols, int(cols[3, -1] + counts[-1])


def descriptor_route(n_ranges: int) -> str:
    """Where a descriptor of ``n_ranges`` ranges reaches the kernel:
    ``"param"`` (by value, in the launch's parameters) up to
    :data:`MAX_PARAM_RANGES`, else ``"device"`` (a tensor on the card)."""
    return "param" if n_ranges <= MAX_PARAM_RANGES else "device"


class Descriptor(NamedTuple):
    """A partition set ready to launch: the host columns, their entry
    count and rows per entry, and the columns on the card on the
    ``"device"`` route (None on ``"param"``)."""
    cols: np.ndarray
    total: int
    entry_rows: int
    on_card: torch.Tensor | None

    @property
    def route(self) -> str:
        return "param" if self.on_card is None else "device"


def descriptor(ranges, entry_rows: int, device,
               route: str | None = None) -> Descriptor:
    """:func:`range_descriptor` of ``ranges`` for a launch on ``device``,
    on :func:`descriptor_route`'s route unless ``route`` names one (a
    ``"param"`` descriptor past :data:`MAX_PARAM_RANGES` is refused at
    launch).  On the ``"device"`` route the columns go there in one
    copy on the current stream, from pinned memory and without blocking
    the host; both buffers come from PyTorch's caching allocators, which
    keep them until the stream's work on them is done, so the caller may
    drop them right after the launch."""
    cols, total = range_descriptor(ranges, entry_rows)
    route = route or descriptor_route(cols.shape[1])
    if route not in ("param", "device"):
        raise ValueError(f"descriptor route {route!r}: 'param' or 'device'")
    on_card = None
    if route == "device":
        device = torch.device(device)
        staged = torch.from_numpy(cols)
        if device.type == "cuda":
            staged = torch.empty(cols.shape, dtype=torch.int32,
                                 pin_memory=True)
            staged.numpy()[...] = cols
        on_card = staged.to(device, non_blocking=True)
    return Descriptor(cols, total, entry_rows, on_card)


def _check_buffers(dst: torch.Tensor, src: torch.Tensor, what: str) -> None:
    """The kernels' preconditions on the buffers, on CPU and CUDA tensors
    alike."""
    for t in (dst, src):
        if t.dtype != torch.uint8 or t.dim() != 2 or t.shape[1] != LANES:
            raise TypeError(f"{what}: want (rows, {LANES}) uint8 views, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.shape[0] > _MAX_ROWS:
            raise ValueError(f"{what}: buffers must be contiguous and under "
                             f"2^31 rows")
    if dst.device != src.device:
        raise ValueError(f"{what}: dst on {dst.device}, src on {src.device}")
    d_lo, s_lo = dst.data_ptr(), src.data_ptr()
    if d_lo < s_lo + src.numel() and s_lo < d_lo + dst.numel():
        raise ValueError(f"{what}: src shares memory with dst")


def disjoint(starts: np.ndarray, sizes: np.ndarray) -> bool:
    """True when no two of the non-empty spans ``[start, start + size)``
    intersect (touching spans do not)."""
    if len(sizes) and sizes.min() <= 0:
        live = sizes > 0
        starts, sizes = starts[live], sizes[live]
    order = starts.argsort()
    s = starts[order]
    return bool((s[1:] >= (s + sizes[order])[:-1]).all())


def _ends_past(r: np.ndarray, nd: int, ns: int) -> bool:
    """Whether a range of ``r`` ends past ``nd`` (dst) or ``ns`` (src)."""
    if not len(r):
        return False
    end_d, end_s = (r[:, :2] + r[:, 2:]).max(axis=0).tolist()
    return end_d > nd or end_s > ns


def _check_ranges(rows: np.ndarray, nd: int, ns: int, what: str) -> None:
    """Row ranges in bounds of ``nd`` / ``ns`` rows, destinations
    disjoint; the first range at fault is named."""
    d, s, n = rows.T
    if len(rows) and rows.min() < 0 or _ends_past(rows, nd, ns):
        bad = (n < 0) | (d < 0) | (s < 0) | (d + n > nd) | (s + n > ns)
        d0, s0, n0 = rows[int(np.argmax(bad))].tolist()
        raise ValueError(f"{what}: row range ({d0},{s0},{n0}) out of "
                         f"bounds (dst {nd}, src {ns} rows)")
    if not disjoint(d, n):
        raise ValueError(f"{what}: destination ranges overlap")


def _check(dst: torch.Tensor, src: torch.Tensor, ranges, what: str,
           checked: bool = False) -> np.ndarray:
    """The kernels' preconditions; returns the ranges as rows.  With
    ``checked`` the caller has already held the ranges against these
    buffers (:func:`repro_torch.kernels.ops.multi_partition_copy_bytes_`
    does, in bytes), and only the buffers are checked."""
    _check_buffers(dst, src, what)
    rows = as_rows(ranges)
    if not checked:
        _check_ranges(rows, dst.shape[0], src.shape[0], what)
    return rows


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernels' library, its descriptor capacity held against
    :data:`MAX_PARAM_RANGES` (and its size against the packed layout)."""
    lib = _build.load()
    out = (ctypes.c_int * 2)()
    _build.check(lib.repro_copy_param_ranges(ctypes.addressof(out)),
                 "copy descriptor layout")
    if tuple(out) != (MAX_PARAM_RANGES, 8 + 16 * MAX_PARAM_RANGES):
        raise RuntimeError(f"csrc/partition_copy.cu's ParamRanges (capacity "
                           f"{out[0]}, {out[1]} B) differs from "
                           f"MAX_PARAM_RANGES {MAX_PARAM_RANGES}")
    return lib


def _cuda_args(dst: torch.Tensor, what: str):
    if dst.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {dst.device}, want cuda or cpu")
    if dst.data_ptr() % 16:
        raise ValueError(f"{what}: buffers must be 16-byte aligned")
    return _lib(), torch.cuda.current_stream(dst.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _desc_args(desc: Descriptor):
    """The C entries' (cols_host, cols_dev, n) of a descriptor."""
    if desc.on_card is None:
        return desc.cols.ctypes.data, None, desc.cols.shape[1]
    return None, desc.on_card.data_ptr(), desc.cols.shape[1]


# ------------------------------------------------------------------- K6

def partition_copy_plain(dst: torch.Tensor, src: torch.Tensor,
                         dst_off_rows: int, src_off_rows: int, rows: int, *,
                         block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """K6's function in plain PyTorch: ``rows`` rows of ``src`` from
    ``src_off_rows`` into ``dst`` at ``dst_off_rows``, in place."""
    dst[dst_off_rows:dst_off_rows + rows] = \
        src[src_off_rows:src_off_rows + rows]
    return dst


def partition_copy(dst: torch.Tensor, src: torch.Tensor, dst_off_rows: int,
                   src_off_rows: int, rows: int, *,
                   block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """Copy ``rows`` rows (of 128 B) of ``src`` from ``src_off_rows`` into
    ``dst`` at ``dst_off_rows``, in place; returns ``dst``.

    As in the reference, offsets and length are multiples of the tile,
    ``min(block_rows, rows)`` rows (the §6.2 partition granularity);
    :func:`repro_torch.kernels.ops.partition_copy_bytes` routes anything
    else to :func:`multi_partition_copy`.  CUDA tensors launch K6, one
    block per tile; CPU tensors take :func:`partition_copy_plain`.
    """
    block_rows = min(block_rows, rows)
    if rows <= 0 or rows % block_rows or dst_off_rows % block_rows \
            or src_off_rows % block_rows:
        raise ValueError(f"partition_copy: rows {rows} and offsets "
                         f"({dst_off_rows}, {src_off_rows}) must be "
                         f"multiples of the {block_rows}-row tile")
    _check(dst, src, ((dst_off_rows, src_off_rows, rows),), "partition_copy")
    if dst.device.type == "cpu":
        return partition_copy_plain(dst, src, dst_off_rows, src_off_rows, rows)
    lib, stream = _cuda_args(dst, "partition_copy")
    err = lib.repro_partition_copy(dst.data_ptr(), src.data_ptr(),
                                   dst_off_rows, src_off_rows, rows,
                                   block_rows, stream)
    _build.check(err, "partition_copy launch")
    partition_copy.launches += 1
    return dst


partition_copy.launches = 0


# --------------------------------------------------------------- K7, K8

def multi_partition_copy_plain(dst: torch.Tensor, src: torch.Tensor,
                               ranges) -> torch.Tensor:
    """K7's and K8's function in plain PyTorch: one ``copy_`` per
    ``(dst_row, src_row, rows)`` range, in place."""
    for (d0, s0, rows) in as_rows(ranges).tolist():
        dst[d0:d0 + rows].copy_(src[s0:s0 + rows])
    return dst


def multi_partition_copy_tiles(dst: torch.Tensor, src: torch.Tensor, ranges,
                               *, block_rows: int = BLOCK_ROWS,
                               checked: bool = False) -> torch.Tensor:
    """K7: a whole partition set in one launch, in place; returns ``dst``.

    ``ranges`` are ``(dst_row, src_row, rows)`` triples, lane (row)
    granular, destinations disjoint.  One block per ``block_rows`` entry
    of the set's descriptor; each writes only its valid rows.  With
    ``checked`` the ranges were already held against these buffers (see
    :func:`_check`).  CPU tensors take :func:`multi_partition_copy_plain`.
    """
    rows = _check(dst, src, ranges, "multi_partition_copy_tiles", checked)
    if dst.device.type == "cpu":
        return multi_partition_copy_plain(dst, src, rows)
    return launch_tiles(dst, src, descriptor(rows, block_rows, dst.device))


def launch_tiles(dst: torch.Tensor, src: torch.Tensor,
                 desc: Descriptor) -> torch.Tensor:
    """Launch K7 on checked CUDA buffers with a :func:`descriptor` of
    ``block_rows``-row entries (the wrapper's device step)."""
    lib, stream = _cuda_args(dst, "multi_partition_copy_tiles")
    if desc.total == 0:
        return dst
    err = lib.repro_multi_partition_copy_tiles(
        dst.data_ptr(), src.data_ptr(), *_desc_args(desc), desc.total,
        desc.entry_rows, stream)
    _build.check(err, "multi_partition_copy_tiles launch")
    multi_partition_copy_tiles.launches += 1
    multi_partition_copy_tiles.last_route = desc.route
    return dst


multi_partition_copy_tiles.launches = 0
multi_partition_copy_tiles.last_route = None


def multi_partition_copy_staged(dst: torch.Tensor, src: torch.Tensor, ranges,
                                *, chunk: int | None = None,
                                checked: bool = False) -> torch.Tensor:
    """K8: K7's function for large buffers, in place; returns ``dst``.

    The ranges are cut into ``chunk``-row descriptor entries (default
    :func:`~repro_torch.kernels.autotune.plan_copy_chunk` of the total
    rows); a persistent grid of one block per SM walks them, each block
    loading its next entry into one of two shared-memory slots while it
    stores the current one.  ``checked`` as in
    :func:`multi_partition_copy_tiles`.  CPU tensors take
    :func:`multi_partition_copy_plain`.
    """
    rows = _check(dst, src, ranges, "multi_partition_copy_staged", checked)
    if dst.device.type == "cpu":
        return multi_partition_copy_plain(dst, src, rows)
    if chunk is None:
        chunk = plan_copy_chunk(int(rows[:, 2].sum()))
    return launch_staged(dst, src, descriptor(rows, chunk, dst.device))


def launch_staged(dst: torch.Tensor, src: torch.Tensor,
                  desc: Descriptor) -> torch.Tensor:
    """Launch K8 on checked CUDA buffers with a :func:`descriptor` whose
    entries are chunks (the wrapper's device step)."""
    chunk = desc.entry_rows
    if chunk < 1 or 2 * chunk * LANES > SMEM_OPTIN_BYTES:
        raise ValueError(f"multi_partition_copy_staged: chunk {chunk} rows "
                         f"(two slots must fit {SMEM_OPTIN_BYTES} B)")
    lib, stream = _cuda_args(dst, "multi_partition_copy_staged")
    if desc.total == 0:
        return dst
    grid = min(desc.total, _sm_count(dst.device))
    err = lib.repro_multi_partition_copy_staged(
        dst.data_ptr(), src.data_ptr(), *_desc_args(desc), desc.total, chunk,
        grid, stream)
    _build.check(err, "multi_partition_copy_staged launch")
    multi_partition_copy_staged.launches += 1
    multi_partition_copy_staged.last_route = desc.route
    return dst


multi_partition_copy_staged.launches = 0
multi_partition_copy_staged.last_route = None


def multi_partition_copy(dst: torch.Tensor, src: torch.Tensor, ranges, *,
                         block_rows: int = BLOCK_ROWS,
                         checked: bool = False) -> torch.Tensor:
    """Copy a partition set of ``(dst_row, src_row, rows)`` ranges in one
    kernel launch, in place: K8 when either buffer exceeds
    :data:`DMA_STAGE_BYTES` (:func:`dma_staged`), else K7.  ``checked``
    as in :func:`multi_partition_copy_tiles`."""
    if dma_staged(dst.numel(), src.numel()):
        return multi_partition_copy_staged(dst, src, ranges, checked=checked)
    return multi_partition_copy_tiles(dst, src, ranges, block_rows=block_rows,
                                      checked=checked)
