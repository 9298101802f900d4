"""Plans of the Hopper kernels that the TPU planner sized from VMEM.

* :func:`plan_copy_chunk`, the staged partition copy's (K8) chunk.  The
  reference's ``repro.kernels.autotune.plan_copy_chunk`` sizes its chunk
  from a VMEM budget and TPU constants; on the H100 the budget is the
  shared memory one block may opt into, 227 KB (232,448 B), and the
  stage holds two source slots (the current chunk and the prefetched
  next one).
* :func:`plan_attention`, whether an attention call takes the
  whole-sequence megakernels K4f / K4b (``csrc/flash_attention_mega.cu``)
  or the tiled K1 / K2 / K3, and the strip of query rows each K4 kernel
  holds.  The reference's planner (``repro/kernels/autotune.py:291``)
  takes a megakernel only where its cost model says it beats the tiled
  grid; its VMEM budgets and TPU step costs do not carry over.  Here the
  costs are times measured on the card (:data:`MEGA_TIMINGS`), and the
  fits are the card's: the kv head's whole K and V (and, for K4b, its
  fp32 dK and dV) must sit in one block's shared memory, and one block
  per (batch, kv head) must fill the SMs;
* :func:`kernel_head_dim`, the compiled width at which the tiled kernels
  K1, K2, K3 and the decode kernel K5 run a head;
* :func:`decode_splits`, how many blocks the split-sequence decode
  kernel K5 (``csrc/flash_decode.cu``) gives each (batch, kv head), and
  :func:`decode_chunk`, the rows each split takes.  The reference's
  decode grid walks the cache in order on one core; on the card the
  live span is split across blocks so that the SMs fill.

All are pure functions of ints, cached, with no device query: callers
pass the SM count.
"""
from __future__ import annotations

import dataclasses
import functools

LANES = 128
SMEM_OPTIN_BYTES = 232_448     # H100 per-block opt-in shared memory
MIN_CHUNK = 16                 # rows; the reference planner's MIN_BLOCK
SM_COUNT = 132                 # H100 SXM streaming multiprocessors
HEAD_DIMS = (64, 128)          # the head widths K4f / K4b take
# query rows per strip of K4f / K4b, largest first: 8 warps of 4, 2 or 1
# rows each (``csrc/flash_attention_mega.cu``'s RPT)
MEGA_ROWS = (32, 16, 8)


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


# --------------------------------------------------------------- attention

def kernel_head_dim(hd: int) -> int:
    """The compiled width (64 or 128) at which K1, K2, K3 and K5 run a
    head of width ``hd``: the next one at or above it.  The kernels load
    hd columns and zero-fill the rest in shared memory, so the tensors
    stay unpadded.  ``hd`` must be a multiple of 8 (whole 16-byte
    vectors a row in bf16) from 8 to 128; raises ``ValueError`` for any
    other width."""
    if hd % 8 or not 8 <= hd <= 128:
        raise ValueError(f"head_dim {hd}: the attention kernels take a "
                         "multiple of 8 from 8 to 128")
    return 64 if hd <= 64 else 128


# K5's tile and split cap.  The wrapper passes DECODE_TILE to every
# launch and ``csrc/flash_decode.cu`` refuses one that is not its BS, and
# a split count above its MAX_SPLITS: so the chunk rule below and the
# kernel's cannot drift apart unseen.
DECODE_TILE = 64          # cache rows a K5 block loads at once (its BS)
DECODE_MIN_ROWS = 128     # least rows a split takes at the full span
MAX_DECODE_SPLITS = 128   # the most K5 takes (its MAX_SPLITS)


def decode_chunk(span: int, splits: int) -> int:
    """Rows of the live span each of ``splits`` K5 blocks takes: its
    share, ``ceil(span / splits)``, rounded up to the tile.  Split i
    covers ``[i·chunk, (i+1)·chunk)`` of the span, so the last splits may
    get fewer rows or none.  K5 computes the same from ``cur_len`` on the
    device."""
    share = -(-span // splits)
    return -(-share // DECODE_TILE) * DECODE_TILE


@functools.lru_cache(maxsize=1024)
def decode_splits(b: int, kh: int, s: int, window: int,
                  sm_count: int = SM_COUNT) -> int:
    """Splits of the live span per (batch, kv head) for K5, from the
    shapes alone (never from ``cur_len``, which stays on the device).

    The longest live span is ``min(s, window)`` (``s`` without a
    window).  The target is enough splits that ``b · kh · splits`` fills
    two waves of ``sm_count`` SMs, as far as the span gives each split
    at least ``DECODE_MIN_ROWS`` rows, and at most
    ``MAX_DECODE_SPLITS``.  The count taken is that of the widest
    tile-multiple chunk that still gives the target or more splits, so
    the shares land on tile boundaries; then as many as
    :func:`decode_chunk` leaves rows for at that span, so no split is
    empty there.  At least 1.  h2o-danube3-4b (B=1, KH=8, window 4096)
    takes 32 splits of 128 rows (256 blocks); smollm-360m's B=4, KH=5
    decode over 2624 cache rows 14 of 192 (280 blocks).
    """
    span = min(s, window) if window > 0 else s
    want = -(-2 * sm_count // max(1, b * kh))
    target = min(want, span // DECODE_MIN_ROWS, MAX_DECODE_SPLITS)
    if target <= 1:
        return 1
    chunk = (span - 1) // (target - 1) // DECODE_TILE * DECODE_TILE
    n = min(-(-span // chunk), MAX_DECODE_SPLITS)
    return -(-span // decode_chunk(span, n))


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def mega_smem_bytes(bwd: bool, rows: int, sk: int, hd: int,
                    itemsize: int) -> int:
    """Dynamic shared memory of one K4f (``bwd=False``) or K4b block with
    a ``rows``-row strip.  The launch allocates this sum as it is, and
    each block of ``csrc/flash_attention_mega.cu`` traps if it is less
    than the block's layout needs.

    Every array starts on a 16-byte boundary.  K and V keep the input
    dtype, rows padded by one 32-bit word (hd + 2 bf16, hd + 1 fp32
    values) so that lanes reading one column each hit distinct banks.
    K4f adds the strip's pre-scaled q (rows × hd fp32) and its scores
    (rows × sk fp32); K4b adds fp32 dK and dV (sk × hd each), q and dO
    (rows × hd fp32 each), P and dS (rows × sk fp32 each) and the strip's
    lse and delta (rows fp32 each).
    """
    ldk = hd + (2 if itemsize == 2 else 1)
    total = 2 * _align16(sk * ldk * itemsize)
    if bwd:
        total += 2 * _align16(sk * hd * 4)
        total += 2 * _align16(rows * hd * 4)
        total += 2 * _align16(rows * sk * 4)
        total += 2 * _align16(rows * 4)
    else:
        total += _align16(rows * hd * 4) + _align16(rows * sk * 4)
    return total


@functools.lru_cache(maxsize=1024)
def mega_rows(bwd: bool, sk: int, hd: int, itemsize: int) -> int:
    """The largest strip of ``MEGA_ROWS`` whose block fits the opt-in
    shared memory, or 0 when not even 8 rows do (no K4 for this shape)."""
    for rows in MEGA_ROWS:
        if mega_smem_bytes(bwd, rows, sk, hd, itemsize) <= SMEM_OPTIN_BYTES:
            return rows
    return 0


@dataclasses.dataclass(frozen=True)
class MegaTiming:
    """K4f and K4b against the tiled kernels at one shape (kv length,
    head width, dtype bits, batch, kv heads), each timed on the card in
    one process: K4f with its logsumexp against K1 with it, K4b against
    K3.  ``card`` names the card and its power limit."""
    sk: int
    hd: int
    dtype_bits: int
    batch: int
    kh: int
    k4f_ms: float
    k1_ms: float
    k4b_ms: float
    k3_ms: float
    card: str


# Every shape at which K4 has been timed against the tiled kernels, from
# chip_smoke.py's phase 4a (B=64, H=15, KH=5, S=256, hd 64, bf16 causal,
# K1 and K3 on tensor cores).  The planner takes a megakernel only at a
# shape listed here where it won.
MEGA_TIMINGS = (
    MegaTiming(256, 64, 16, 64, 5, k4f_ms=0.7498, k1_ms=0.1020,
               k4b_ms=3.6323, k3_ms=0.3453,
               card="NVIDIA H100 80GB HBM3, 700.00 W"),
)


@dataclasses.dataclass(frozen=True)
class AttnPlan:
    """Which kernels one attention shape takes.  ``mega_fwd`` / ``mega_bwd``
    keep the reference plan's names; its batch-tiled ``_bt`` variants
    fold into them (one block per (b, kh) is batch-tiled already).  The
    K4 strips are :func:`mega_rows` of the shape, which the kernels'
    wrappers read; K1–K3 choose their own tiles, so the reference's tile
    fields have no counterpart."""
    mega_fwd: bool = False
    mega_bwd: bool = False

    def describe(self) -> str:
        return (f"forward {'K4f' if self.mega_fwd else 'K1'}, backward "
                f"{'K4b' if self.mega_bwd else 'K3/K2'}")


@functools.lru_cache(maxsize=4096)
def plan_attention(sk: int, hd: int, hd_v: int, kh: int, batch: int,
                   dtype_bits: int, *, block_q: int | None = None,
                   block_k: int | None = None, sm_count: int = SM_COUNT,
                   timings: tuple | None = None) -> AttnPlan:
    """Choose K4f / K4b or K1 / K3 (K2) for one attention shape.

    ``block_q`` / ``block_k`` are the config's tile pins
    (``cfg.attn_block_q`` / ``attn_block_k``): a pinned tile turns both
    megakernels off, as in the reference.  Otherwise each K4 kernel is
    its own gate (K4f with K3 is a legal plan), and takes the shape only
    where all of these hold:

    * a time measured on the card says it wins there: ``timings``
      (default :data:`MEGA_TIMINGS`; the cache keys on the tuple passed)
      has an entry at this (sk, hd, dtype_bits, batch, kh) with K4f
      faster than K1 (for ``mega_fwd``) or K4b faster than K3 (for
      ``mega_bwd``), as the reference takes its megakernels only where
      its cost model says they beat the tiled grid
      (``repro/kernels/autotune.py:433-454``).  The one shape measured so
      far is smollm-360m's short training shape, B=64, H=15, KH=5,
      S=256, hd 64, bf16 causal, on an NVIDIA H100 80GB HBM3 at 700 W
      (``chip_smoke.py`` phase 4a, K1 and K3 on tensor cores):

      =========  =================  ===========================
      pass       K4                 tiled kernel
      =========  =================  ===========================
      forward    K4f-lse 0.7498 ms  K1-lse 0.1020 ms
      backward   K4b 3.6323 ms      K3 0.3453 ms
      =========  =================  ===========================

      so no shape takes K4 today, and that shape plans K1 + K3;

    * the block fits: the kv head's K and V for the whole ``sk`` in the
      input dtype, plus a strip of at least 8 query rows, fit the
      232,448 B of shared memory an H100 block may opt into —
      :func:`mega_smem_bytes` has the sum.  At hd 64, bf16,
      sk 256: K and V take 2 · 256 · 66 · 2 = 67,584 B; K4f's 32-row
      strip adds 8,192 B of q and 32,768 B of scores (108,544 B in all,
      two blocks an SM); K4b adds fp32 dK and dV, 131,072 B, and an
      8-row strip of q, dO, P, dS, lse and delta, 20,544 B (219,200 B,
      one block an SM; 16 rows would need 239,744 B).  The longest sk
      each kernel takes (bf16 / fp32): K4f 778 / 417 at hd 64, 413 / 214
      at hd 128; K4b 271 / 208 at hd 64, 139 / 105 at hd 128;
    * one block per (batch, kv head) fills the card:
      ``batch · kh ≥ sm_count`` (the caller passes the device's
      ``multi_processor_count``; 132 on an H100 SXM);
    * the kernels take the shape: hd in ``HEAD_DIMS``, ``hd_v == hd``,
      and ``dtype_bits`` 16 (bf16) or 32 (fp32); callers pass 0 for any
      other dtype.

    The query length and the group size do not enter: the strip loop
    covers any number of query rows.  Pure and cached; no device query.
    """
    if (block_q is not None or block_k is not None or hd not in HEAD_DIMS
            or hd_v != hd or dtype_bits not in (16, 32)
            or batch * kh < sm_count):
        return AttnPlan()
    key = (sk, hd, dtype_bits, batch, kh)
    won = [t for t in (MEGA_TIMINGS if timings is None else timings)
           if (t.sk, t.hd, t.dtype_bits, t.batch, t.kh) == key]
    if not won:
        return AttnPlan()
    t, itemsize = won[0], dtype_bits // 8
    return AttnPlan(
        mega_fwd=t.k4f_ms < t.k1_ms and mega_rows(False, sk, hd, itemsize) > 0,
        mega_bwd=t.k4b_ms < t.k3_ms and mega_rows(True, sk, hd, itemsize) > 0)
