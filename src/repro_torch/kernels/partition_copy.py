"""K6, K7, K8: the §6.3 ``ocrDbCopy(DB_COPY_PARTITION)`` copy on Hopper.

Replaces the Pallas TPU kernels of ``repro/kernels/partition_copy.py``:

* :func:`partition_copy` (K6, for ``_copy_kernel``) — one tile-aligned
  contiguous row range;
* :func:`multi_partition_copy_tiles` (K7, for the inner kernel of
  ``_multi_partition_copy_impl``) — a whole partition set of N disjoint
  lane-granular ranges in one launch, one block per ``block_rows`` tile
  of the (dst_row, src_row, valid_rows) tables;
* :func:`multi_partition_copy_staged` (K8, for the inner kernel of
  ``_multi_partition_copy_dma``) — the same function above
  :data:`DMA_STAGE_BYTES`, chunks staged through shared memory by bulk
  copies with the next chunk's load in flight.

:func:`multi_partition_copy` routes between K7 and K8 by the reference's
rule (:func:`dma_staged`).  The CUDA source is ``csrc/partition_copy.cu``.

Buffers are (rows, 128) uint8 views and the wrappers update ``dst`` in
place (the TPU kernels alias it as their output); ``src`` must not share
memory with ``dst``, and destination ranges must be disjoint.  Unlike the
TPU kernels, which merge an edge tile by a masked read-modify-write that
is safe only because their grid runs in table order, every block here
writes only its valid rows and never reads ``dst``, so blocks may run in
any order.  Each kernel has a plain PyTorch version beside it (range
assignment on the views), which CPU tensors take; CUDA tensors launch
the kernel or raise.  ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from ..core.objects import spans_overlap
from .autotune import SMEM_OPTIN_BYTES, plan_copy_chunk

LANES = 128
BLOCK_ROWS = 256               # K6/K7 tile: 256 rows = 32 KiB

# Buffer size above which multi_partition_copy takes the staged kernel
# (K8), as in the reference.
DMA_STAGE_BYTES = 16 * 2 ** 20

_MAX_ROWS = 2 ** 31 - 1        # the kernels take row indices as int32


def dma_staged(dst_bytes: int, src_bytes: int) -> bool:
    """True when a copy over buffers this large takes the staged path
    (either buffer larger than :data:`DMA_STAGE_BYTES`)."""
    return max(dst_bytes, src_bytes) > DMA_STAGE_BYTES


def _block_tables(ranges, block_rows: int):
    """Flatten row ranges into per-block (dst, src, valid-rows) tables."""
    d_tab, s_tab, n_tab = [], [], []
    for (d0, s0, rows) in ranges:
        nb = -(-rows // block_rows)
        for b in range(nb):
            d_tab.append(d0 + b * block_rows)
            s_tab.append(s0 + b * block_rows)
            n_tab.append(min(block_rows, rows - b * block_rows))
    return (np.asarray(d_tab, np.int32), np.asarray(s_tab, np.int32),
            np.asarray(n_tab, np.int32))


def _check(dst: torch.Tensor, src: torch.Tensor, ranges, what: str) -> None:
    """The kernels' preconditions, on CPU and CUDA tensors alike."""
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
    nd, ns = dst.shape[0], src.shape[0]
    for (d0, s0, rows) in ranges:
        if rows < 0 or d0 < 0 or s0 < 0 or d0 + rows > nd or s0 + rows > ns:
            raise ValueError(f"{what}: row range ({d0},{s0},{rows}) out of "
                             f"bounds (dst {nd}, src {ns} rows)")
    if spans_overlap((d0, d0 + rows) for d0, _, rows in ranges if rows):
        raise ValueError(f"{what}: destination ranges overlap")


def _cuda_args(dst: torch.Tensor, what: str):
    if dst.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {dst.device}, want cuda or cpu")
    if dst.data_ptr() % 16:
        raise ValueError(f"{what}: buffers must be 16-byte aligned")
    return _build.load(), torch.cuda.current_stream(dst.device).cuda_stream


def tables(ranges, rows_per_entry: int, device) -> torch.Tensor:
    """The (3, n) int32 tables of K7/K8 on ``device``: dst rows, src rows
    and valid rows of each ``rows_per_entry``-row entry."""
    return torch.from_numpy(np.stack(_block_tables(ranges, rows_per_entry))
                            ).to(device)


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
    for (d0, s0, rows) in ranges:
        dst[d0:d0 + rows].copy_(src[s0:s0 + rows])
    return dst


def multi_partition_copy_tiles(dst: torch.Tensor, src: torch.Tensor, ranges,
                               *, block_rows: int = BLOCK_ROWS
                               ) -> torch.Tensor:
    """K7: a whole partition set in one launch, in place; returns ``dst``.

    ``ranges`` are ``(dst_row, src_row, rows)`` triples, lane (row)
    granular, destinations disjoint.  One block per ``block_rows`` tile of
    any range; each writes only its valid rows.  CPU tensors take
    :func:`multi_partition_copy_plain`.
    """
    _check(dst, src, ranges, "multi_partition_copy_tiles")
    if dst.device.type == "cpu":
        return multi_partition_copy_plain(dst, src, ranges)
    return launch_tiles(dst, src, tables(ranges, block_rows, dst.device))


def launch_tiles(dst: torch.Tensor, src: torch.Tensor,
                 tabs: torch.Tensor) -> torch.Tensor:
    """Launch K7 on checked CUDA buffers with tables from :func:`tables`
    (the wrapper's device step; the tables are built on the host)."""
    lib, stream = _cuda_args(dst, "multi_partition_copy_tiles")
    if tabs.shape[1] == 0:
        return dst
    err = lib.repro_multi_partition_copy_tiles(
        dst.data_ptr(), src.data_ptr(), tabs.data_ptr(), tabs.shape[1],
        stream)
    _build.check(err, "multi_partition_copy_tiles launch")
    multi_partition_copy_tiles.launches += 1
    return dst


multi_partition_copy_tiles.launches = 0


def multi_partition_copy_staged(dst: torch.Tensor, src: torch.Tensor, ranges,
                                *, chunk: int | None = None) -> torch.Tensor:
    """K8: K7's function for large buffers, in place; returns ``dst``.

    The ranges are cut into ``chunk``-row table entries (default
    :func:`~repro_torch.kernels.autotune.plan_copy_chunk` of the total
    rows); a persistent grid of one block per SM walks them, each block
    loading its next entry into one of two shared-memory slots while it
    stores the current one.  CPU tensors take
    :func:`multi_partition_copy_plain`.
    """
    _check(dst, src, ranges, "multi_partition_copy_staged")
    if dst.device.type == "cpu":
        return multi_partition_copy_plain(dst, src, ranges)
    if chunk is None:
        chunk = plan_copy_chunk(int(sum(r for (_, _, r) in ranges)))
    return launch_staged(dst, src, tables(ranges, chunk, dst.device), chunk)


def launch_staged(dst: torch.Tensor, src: torch.Tensor, tabs: torch.Tensor,
                  chunk: int) -> torch.Tensor:
    """Launch K8 on checked CUDA buffers with ``chunk``-row tables from
    :func:`tables` (the wrapper's device step)."""
    if chunk < 1 or 2 * chunk * LANES > SMEM_OPTIN_BYTES:
        raise ValueError(f"multi_partition_copy_staged: chunk {chunk} rows "
                         f"(two slots must fit {SMEM_OPTIN_BYTES} B)")
    lib, stream = _cuda_args(dst, "multi_partition_copy_staged")
    n = tabs.shape[1]
    if n == 0:
        return dst
    grid = min(n, torch.cuda.get_device_properties(
        dst.device).multi_processor_count)
    err = lib.repro_multi_partition_copy_staged(
        dst.data_ptr(), src.data_ptr(), tabs.data_ptr(), n, chunk, grid,
        stream)
    _build.check(err, "multi_partition_copy_staged launch")
    multi_partition_copy_staged.launches += 1
    return dst


multi_partition_copy_staged.launches = 0


def multi_partition_copy(dst: torch.Tensor, src: torch.Tensor, ranges, *,
                         block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """Copy a partition set of ``(dst_row, src_row, rows)`` ranges in one
    kernel launch, in place: K8 when either buffer exceeds
    :data:`DMA_STAGE_BYTES` (:func:`dma_staged`), else K7."""
    if dma_staged(dst.numel(), src.numel()):
        return multi_partition_copy_staged(dst, src, ranges)
    return multi_partition_copy_tiles(dst, src, ranges, block_rows=block_rows)
