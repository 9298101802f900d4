"""Block sizes of the Hopper kernels that the TPU planner sized from VMEM.

Only the staged partition copy (K8) needs a plan here.  The reference's
``repro.kernels.autotune.plan_copy_chunk`` sizes its chunk from a VMEM
budget and TPU constants; on the H100 the budget is the shared memory one
block may opt into, 227 KB (232,448 B), and the stage holds two source
slots (the current chunk and the prefetched next one).
"""
from __future__ import annotations

import functools

LANES = 128
SMEM_OPTIN_BYTES = 232_448     # H100 per-block opt-in shared memory
MIN_CHUNK = 16                 # rows; the reference planner's MIN_BLOCK


@functools.lru_cache(maxsize=64)
def plan_copy_chunk(total_rows: int, smem_budget: int | None = None) -> int:
    """Rows per chunk of the staged ``multi_partition_copy``: two chunk
    slots of ``chunk × 128`` bytes fit the shared-memory budget, and the
    copy has at least two chunks where it is large enough, so that a
    prefetch overlaps a store (the reference's rule).  A power of two, at
    least ``MIN_CHUNK``."""
    budget = SMEM_OPTIN_BYTES if smem_budget is None else smem_budget
    cap = max(budget // (2 * LANES), MIN_CHUNK)
    chunk = MIN_CHUNK
    while chunk * 2 <= cap and chunk * 4 <= max(total_rows, MIN_CHUNK * 4):
        chunk *= 2
    return chunk
