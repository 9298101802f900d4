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
  fits are the card's: the kv head's whole K and V (and, for the fp32
  K4b, its fp32 dK and dV) must sit in one block's shared memory, and
  one block per (batch, kv head) must fill the SMs;
* :func:`kernel_head_dim`, the compiled (q/k width, v width) pair at
  which the tiled kernels K1, K2, K3 and the decode kernel K5 run a
  head, :func:`attn_route`, which kernels run it, the host-side mirrors
  of the wgmma kernels' tiles at the first two pairs
  (:func:`hopper_smem_bytes`, :func:`hopper_kv_tiles`,
  :func:`hopper_q_tiles`, :func:`hopper_q_order`), :func:`wide_dkv_splits`, the head slices of the dk/dv pass at
  the widest pair, (576, 512), and :func:`wide_ds_passes`, the runs of
  query tiles over which K3 there holds its dS workspace under
  :data:`WIDE_DS_CAP`;
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
HEAD_DIMS = (64, 128)          # the head widths the fp32 K4f / K4b take
# query rows per strip of the fp32 K4f / K4b, largest first: 8 warps of
# 4, 2 or 1 rows each (``csrc/flash_attention_mega.cu``'s RPT)
MEGA_ROWS = (32, 16, 8)
# the bf16 K4f / K4b (``csrc/flash_attention_mega.cu``'s TC_TILE, TC_NW,
# SLICE): 64-row kv tiles, to which the resident K and V are rounded up;
# four warps, each walking 16-row query slices of its own
MEGA_TILE = 64
MEGA_WARPS = 4
MEGA_SLICE = 16


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

# The (q/k width, v width) pairs K1, K2 and K3 are compiled for, in the
# order ``attn_pair`` in ``csrc/common.cuh`` tries them: (192, 128) is
# DeepSeek-V2's MLA head (q/k 128 + 64, v 128), (576, 512) its absorbed
# route (one latent kv head: k = [c_kv 512, k_rope 64], v = c_kv), whose
# kernels are ``csrc/flash_attention_wide.cu``.  K5 takes the first two.
ATTN_PAIRS = ((64, 64), (128, 128), (192, 128), (576, 512))
WIDE_PAIR = ATTN_PAIRS[-1]
DECODE_PAIRS = ATTN_PAIRS[:2]


def kernel_head_dim(hd: int, hd_v: int | None = None,
                    pairs: tuple = ATTN_PAIRS) -> tuple:
    """The compiled pair (HD, HD_V) at which K1, K2 and K3 (``pairs``
    :data:`ATTN_PAIRS`) or K5 (:data:`DECODE_PAIRS`) run q/k heads of
    width ``hd`` and v heads of width ``hd_v`` (default ``hd``): the
    first of ``pairs`` that holds both, so every pair of multiples of 8
    up to (576, 512) has one.  The kernels load the true columns and
    zero-fill the rest in shared memory, so the tensors stay unpadded.
    Both widths must be multiples of 8 (whole 16-byte vectors a row in
    bf16) from 8; raises ``ValueError`` naming both widths where no pair
    holds them (e.g. (584, 512))."""
    hd_v = hd if hd_v is None else hd_v
    if hd % 8 == 0 and hd_v % 8 == 0 and hd >= 8 and hd_v >= 8:
        for pair in pairs:
            if hd <= pair[0] and hd_v <= pair[1]:
                return pair
    raise ValueError(f"head_dim {hd}, v head_dim {hd_v}: the attention "
                     "kernels take multiples of 8 held by one of the "
                     f"compiled pairs {pairs}")


# kv rows of one block of the dk/dv pass at WIDE_PAIR, by element size
# (``csrc/flash_attention_wide.cu``: KV_T in bf16, 16 in fp32)
WIDE_DKV_ROWS = {2: 64, 4: 16}


@functools.lru_cache(maxsize=1024)
def wide_dkv_splits(bkv: int, g: int, sk: int, itemsize: int) -> int:
    """Slices of the G query heads of each kv head that the dk/dv pass
    (K2's, and K3's) at :data:`WIDE_PAIR` spreads across blocks, from the
    shapes alone.  One block per (slice, kv tile, batch × kv head) holds
    one SM (its tiles take most of the shared memory); the target is
    about four blocks for each of an H100's :data:`SM_COUNT` SMs, so
    that the causal kv tiles' unequal q ranges even out, and at most G
    slices.  Each block sums its slice's heads into an fp32 workspace,
    which the pass adds in slice order: the same bits for the same
    shapes on any card.  deepseek-v2-236b's
    absorbed route, B 1, KH 1, G 128 at 1 × 4096 in bf16 (64 kv tiles):
    9 slices of 15 heads, 576 blocks."""
    tiles = bkv * -(-sk // WIDE_DKV_ROWS[itemsize])
    want = -(-4 * SM_COUNT // max(1, tiles))
    return max(1, min(g, want))


# The bf16 wgmma kernels at WIDE_PAIR (``csrc/flash_attention_wide.cu``):
# kv rows of a K1 stage and q rows of a dK stage, by whether v is k's
# first 512 columns (one tile for both) or a tensor apart; q rows of a dV
# stage.  Their tiles are 64-column boxes (128 bytes a row).
WIDE_K1_ROWS = {True: 48, False: 32}
WIDE_DK_ROWS = {True: 32, False: 16}
WIDE_DV_ROWS = 32


def wide_smem_bytes() -> dict:
    """Shared memory of each bf16 wgmma kernel's tile plan at
    :data:`WIDE_PAIR`, by (kernel, v is k's prefix): the sums that
    ``csrc/flash_attention_wide.cu``'s k1_bytes / dv_bytes / dk_bytes /
    dq_bytes make (a 1 KB alignment slack and the mbarriers included),
    each held there against the 232,448 B opt-in by a static_assert.  A
    pure function of the constants."""
    row, q, kv, hd_boxes, v_boxes = 64 * 2, 64, 64, 9, 8
    out = {}
    for sv in (True, False):
        bk, tq = WIDE_K1_ROWS[sv], WIDE_DK_ROWS[sv]
        out[("k1", sv)] = (1024 + q * hd_boxes * row
                           + 2 * bk * (hd_boxes + (0 if sv else v_boxes)) * row
                           + 2 * q * bk * 4 + 64)
        out[("dk", sv)] = (1024 + kv * (hd_boxes + (0 if sv else v_boxes)) * row
                           + 2 * tq * (hd_boxes + v_boxes) * row
                           + kv * tq * 4 + kv * tq * 2 * 2 + 4 * tq * 4 + 64)
        out[("dv", sv)] = (1024 + kv * hd_boxes * row
                           + 2 * WIDE_DV_ROWS * (hd_boxes + v_boxes) * row
                           + 2 * kv * WIDE_DV_ROWS * 4 + 64)
        out[("dq", sv)] = 1024 + 2 * (2 * 64 * 64 + kv * hd_boxes * 64) * 2 + 64
    return out


# The bf16 wgmma kernels at the first two pairs, (64, 64) and (128, 128)
# (``csrc/flash_attention_hopper.cu``): K1's block takes HOPPER_Q_ROWS q
# rows (two consumer warpgroups of 64) over kv tiles of HOPPER_K1_ROWS rows
# a stage; the dk/dv block of K2 and K3 takes HOPPER_KV_ROWS kv rows (two
# consumers of 64) over q tiles of HOPPER_Q_TILE rows.  K2's dq pass keeps
# its mma.sync kernel at every pair but WIDE_PAIR.
HOPPER_PAIRS = ATTN_PAIRS[:2]
HOPPER_Q_ROWS = 128
HOPPER_K1_ROWS = 128
HOPPER_KV_ROWS = 128
HOPPER_Q_TILE = 64


def attn_route(hd: int, hd_v: int, itemsize: int) -> str:
    """Which kernels run K1, K2's dk/dv and K3 for these head widths and
    element size: "wgmma" (``csrc/flash_attention_hopper.cu``) in bf16 at
    :data:`HOPPER_PAIRS`, "mma.sync" (``csrc/flash_attention.cu``,
    ``flash_attention_bwd.cu``) in bf16 at (192, 128), "wide" (the wgmma
    kernels of ``csrc/flash_attention_wide.cu``) in bf16 at
    :data:`WIDE_PAIR`, "cuda_cores" in fp32 at every pair.  Raises
    ``ValueError`` where no pair holds the widths
    (:func:`kernel_head_dim`)."""
    pair = kernel_head_dim(hd, hd_v)
    if itemsize == 4:
        return "cuda_cores"
    if pair == WIDE_PAIR:
        return "wide"
    return "wgmma" if pair in HOPPER_PAIRS else "mma.sync"


def hopper_smem_bytes(kernel: str, hd: int) -> int:
    """Shared memory of one block of the wgmma kernel ``kernel`` ("k1",
    "k2_dkv" or "k3") at the compiled width ``hd`` (64 or 128): the sums
    of ``csrc/flash_attention_hopper.cu``'s fwd_bytes / bwd_bytes, held
    there by static_asserts (a 1 KB alignment slack and the ring's
    mbarriers included).  K1: Q and two stages of K and V; the dk/dv
    block: K and V, two stages of Q and dO, four 64 x 64 bf16 dS^T tiles
    (hi and lo of each consumer), two stages of lse and delta, and for K3
    two 64 x 64 fp32 dQ staging tiles a consumer."""
    if hd not in (64, 128):
        raise ValueError(f"hopper_smem_bytes: compiled width {hd}")
    slack = 1024 + 64
    if kernel == "k1":
        return slack + HOPPER_Q_ROWS * hd * 2 + 2 * 2 * HOPPER_K1_ROWS * hd * 2
    dkv = (slack + 2 * HOPPER_KV_ROWS * hd * 2 + 2 * 2 * HOPPER_Q_TILE * hd * 2
           + 4 * 64 * 64 * 2 + 2 * 2 * HOPPER_Q_TILE * 4)
    if kernel == "k2_dkv":
        return dkv
    if kernel == "k3":
        return dkv + 4 * 64 * 64 * 4
    raise ValueError(f"hopper_smem_bytes: kernel {kernel!r}")


def hopper_kv_tiles(q0: int, sq: int, sk: int, q_offset: int, causal: bool,
                    window: int, rows: int = HOPPER_K1_ROWS) -> tuple:
    """(first kv row, tiles) that K1's block of the q tile at ``q0`` walks
    at the wgmma pairs: the ``rows``-row kv tiles that some real row of
    the tile (``q0`` up to ``min(q0 + HOPPER_Q_ROWS, sq)``) meets under
    the causal mask, the window and ``q_offset``."""
    row0 = q_offset + q0
    kv_begin, kv_end = 0, sk
    if causal:
        kv_end = min(sk, q_offset + min(q0 + HOPPER_Q_ROWS, sq))
    if window > 0:
        kv_begin = max(0, row0 - window + 1)
    kt0 = kv_begin // rows * rows
    return kt0, (-(-(kv_end - kt0) // rows) if kv_end > kv_begin else 0)


def hopper_q_tiles(k0: int, sq: int, sk: int, q_offset: int, causal: bool,
                   window: int) -> tuple:
    """(first q row, tiles) that the dk/dv block of K2 / K3 at kv row
    ``k0`` walks for each query head at the wgmma pairs: the
    :data:`HOPPER_Q_TILE`-row q tiles with a row that meets one of the
    block's real kv rows (``k0`` up to ``min(k0 + HOPPER_KV_ROWS,
    sk)``)."""
    kv_rows = min(HOPPER_KV_ROWS, sk - k0)
    q_lo, q_hi = 0, sq
    if causal:
        q_lo = max(0, k0 - q_offset)
    if window > 0:
        q_hi = min(sq, k0 + kv_rows - 1 + window - q_offset)
    qt0 = q_lo // HOPPER_Q_TILE * HOPPER_Q_TILE
    return qt0, (-(-(q_hi - qt0) // HOPPER_Q_TILE) if q_hi > q_lo else 0)


def hopper_q_order(sq: int) -> tuple:
    """The first q row of each of K1's blocks in launch order at the wgmma
    pairs (``blockIdx.y`` 0, 1, ...): the last q tile first, the one
    with the most kv tiles under the causal mask."""
    n = -(-sq // HOPPER_Q_ROWS)
    return tuple((n - 1 - y) * HOPPER_Q_ROWS for y in range(n))


# K3 at WIDE_PAIR in bf16 stores dS for its dq kernel: one tile pair of
# WIDE_DS_TILE q rows by WIDE_DS_TILE kv rows for every (batch x head, q
# tile, kv tile) the masks keep, as a bf16 hi + lo pair
# (``csrc/flash_attention_wide.cu``: tc_bwd_dk_wide_kernel writes it,
# tc_bwd_dq_ds_wide_kernel reads it).  WIDE_DS_CAP bounds the workspace:
# deepseek-v2-236b's absorbed micro-batch, 1 x 4096 at 128 heads (2,080
# causal pairs a head, 4.36 GB), takes one pass.
WIDE_DS_TILE = 64
WIDE_DS_PAIR_BYTES = 2 * WIDE_DS_TILE * WIDE_DS_TILE * 2
WIDE_DS_CAP = 9 << 29          # 4.5 GiB


def wide_kv_tiles(q0: int, q_offset: int, sk: int, causal: bool,
                  window: int) -> tuple:
    """The WIDE_DS_TILE-row kv tiles [lo, hi) that the query tile whose
    first row is ``q0`` meets under the causal and window masks (the
    kernels' ``ds_kv_tiles``)."""
    row0 = q_offset + q0
    kv_begin, kv_end = 0, sk
    if causal:
        kv_end = min(sk, row0 + WIDE_DS_TILE)
    if window > 0:
        kv_begin = max(0, row0 - window + 1)
    lo = kv_begin // WIDE_DS_TILE
    return (lo, -(-kv_end // WIDE_DS_TILE) if kv_end > kv_begin else lo)


@functools.lru_cache(maxsize=1024)
def wide_ds_passes(bh: int, sq: int, sk: int, q_offset: int, causal: bool,
                   window: int, cap: int | None = None) -> tuple:
    """The passes of K3 at :data:`WIDE_PAIR` in bf16: (first q row, end q
    row, tile pairs) triples of whole WIDE_DS_TILE-row query tiles, from
    the last tiles down (the order in which the dk blocks walk them), each
    as many tiles as keep the pass's dS workspace, ``bh`` × pairs ×
    :data:`WIDE_DS_PAIR_BYTES`, within ``cap`` (default
    :data:`WIDE_DS_CAP`).  The wrapper allocates the largest pass's
    workspace and runs the dk and dq kernels once a pass.  Raises
    ``ValueError`` where one query tile alone would pass the cap."""
    cap = WIDE_DS_CAP if cap is None else cap
    per = bh * WIDE_DS_PAIR_BYTES
    passes, end, pairs = [], -(-sq // WIDE_DS_TILE), 0
    for qt in range(end - 1, -1, -1):
        lo, hi = wide_kv_tiles(qt * WIDE_DS_TILE, q_offset, sk, causal,
                               window)
        n = hi - lo
        if n * per > cap:
            raise ValueError(
                f"K3 at {WIDE_PAIR}: one {WIDE_DS_TILE}-row query tile of "
                f"{bh} heads holds {n * per} B of dS, past the cap {cap}")
        if (pairs + n) * per > cap:
            passes.append(((qt + 1) * WIDE_DS_TILE, end * WIDE_DS_TILE,
                           pairs))
            end, pairs = qt + 1, 0
        pairs += n
    if end > 0:
        passes.append((0, end * WIDE_DS_TILE, pairs))
    return tuple(passes)


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


def mega_width(hd: int, itemsize: int) -> int:
    """The compiled width at which K4f / K4b run a head of width ``hd``,
    or 0 where they do not take it.  bf16 (``itemsize`` 2) takes the
    widths up to 128 that the tiled kernels take, at their compiled
    width (:func:`kernel_head_dim`; columns past hd zero-filled in shared
    memory); fp32 (4) takes ``HEAD_DIMS`` as they are."""
    if itemsize == 2:
        return kernel_head_dim(hd)[0] if hd % 8 == 0 and 8 <= hd <= 128 \
            else 0
    return hd if itemsize == 4 and hd in HEAD_DIMS else 0


def mega_smem_bytes(bwd: bool, rows: int, sk: int, hd: int,
                    itemsize: int) -> int:
    """Dynamic shared memory of one K4f (``bwd=False``) or K4b block with
    a ``rows``-row strip (fp32) or tile (bf16: ``MEGA_TILE``).  The launch
    allocates this sum as it is, and each block of
    ``csrc/flash_attention_mega.cu`` traps if it is less than the
    block's layout needs.

    bf16, at the compiled width w (:func:`mega_width`): K and V for sk
    rounded up to ``MEGA_TILE`` rows, unpadded (the kernels swizzle the
    16-byte chunks of a row); K4f adds each warp's 16-row q slice; K4b
    adds the larger of its two phases' streams, which share the room:
    phase 1's two stages of q and dO tiles (64 rows at w 64, 32 at w
    128) with their lse and delta, phase 2's two stages per warp of a
    16-row slice of q, dO, lse and delta.

    fp32: every array starts on a 16-byte boundary.  K and V rows are
    padded by one 32-bit word (hd + 1 values) so that lanes reading one
    column each hit distinct banks.  K4f adds the strip's pre-scaled q
    (rows × hd) and its scores (rows × sk); K4b adds dK and dV (sk × hd
    each), q and dO (rows × hd each), P and dS (rows × sk each) and the
    strip's lse and delta (rows each).
    """
    if itemsize == 2:
        w = mega_width(hd, itemsize)
        total = 2 * (-(-sk // MEGA_TILE) * MEGA_TILE) * w * 2
        if not bwd:
            return total + MEGA_WARPS * MEGA_SLICE * w * 2
        tq, groups = (64, 2) if w == 64 else (32, 1)
        phase1 = groups * 2 * (2 * tq * w * 2 + 2 * tq * 4)
        phase2 = 4 * groups * 2 * (2 * MEGA_SLICE * w * 2
                                   + 2 * MEGA_SLICE * 4)
        return total + max(phase1, phase2)
    ldk = hd + 1
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
    """The rows a K4 block takes at once: ``MEGA_TILE`` in bf16, the
    largest strip of ``MEGA_ROWS`` in fp32, whose block fits the opt-in
    shared memory; 0 where none fits or K4 does not take the width (no
    K4 for this shape)."""
    if mega_width(hd, itemsize) == 0:
        return 0
    for rows in ((MEGA_TILE,) if itemsize == 2 else MEGA_ROWS):
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


# Every shape at which K4 has been timed against the tiled kernels
# (MEGA_TIMED of chip_smoke.py: H=15, KH=5, S=256, hd 64, bf16 causal):
# smollm-360m's short training batch (B=64) and its short-serve prefill
# (B=32).  Since the tiled kernels moved to wgmma, the times are
# scripts/torch_attention_ab.py --tiled's device-only medians (after a
# device spin; two runs of the tree averaged) against K1-lse and K3 on
# wgmma.  The planner takes a megakernel only at a shape listed here
# where it won.
MEGA_TIMINGS = (
    MegaTiming(256, 64, 16, 64, 5, k4f_ms=0.0974, k1_ms=0.1228,
               k4b_ms=0.3001, k3_ms=0.3062,
               card="NVIDIA H100 80GB HBM3, 700.00 W"),
    MegaTiming(256, 64, 16, 32, 5, k4f_ms=0.0701, k1_ms=0.0679,
               k4b_ms=0.2045, k3_ms=0.1645,
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
      (``repro/kernels/autotune.py:433-454``).  Measured so far:
      smollm-360m's short training batch and its short-serve prefill,
      H=15, KH=5, S=256, hd 64, bf16 causal, on an NVIDIA H100 80GB
      HBM3 at 700 W (device-only medians of
      ``scripts/torch_attention_ab.py --tiled``; K1-lse and K3 on
      wgmma):

      =====  =========  =================  ===================
      B      pass       K4                 tiled kernel
      =====  =========  =================  ===================
      64     forward    K4f-lse 0.0974 ms  K1-lse 0.1228 ms
      64     backward   K4b 0.3001 ms      K3 0.3062 ms
      32     forward    K4f-lse 0.0701 ms  K1-lse 0.0679 ms
      32     backward   K4b 0.2045 ms      K3 0.1645 ms
      =====  =========  =================  ===================

      so B=64 plans K4f + K4b (320 blocks: K4f fills 396 slots in one
      wave; the wgmma K1-lse's 128-row q tiles leave 2 a head at S 256)
      and B=32 K1 + K3;

    * the block fits: the kv head's K and V for the whole ``sk`` in the
      input dtype, plus the kernel's streams (bf16) or a strip of at
      least 8 query rows (fp32), fit the 232,448 B of shared memory an
      H100 block may opt into — :func:`mega_smem_bytes` has the sum.  At
      hd 64, bf16, sk 256: K and V take 2 · 256 · 64 · 2 = 65,536 B; K4f
      adds four 16-row q slices, 8,192 B (73,728 B in all, three blocks
      an SM); K4b adds its two four-warp groups' q / dO streams, 67,584 B
      (133,120 B, one eight-warp block an SM; at hd 128, one group:
      197,632 B).  hd 120 runs at width 128: K4f at sk 200 takes
      147,456 B.  fp32 at sk 128: K4f with a 32-row strip 91,136 B, K4b
      with an 8-row strip 144,448 B.  The longest sk each kernel takes
      (bf16 / fp32): K4f 832 / 417 at hd 64, 384 / 214 at hd 128; K4b
      640 / 208 at hd 64, 320 / 105 at hd 128;
    * one block per (batch, kv head) fills the card:
      ``batch · kh ≥ sm_count`` (the caller passes the device's
      ``multi_processor_count``; 132 on an H100 SXM);
    * the kernels take the shape (:func:`mega_width`): bf16
      (``dtype_bits`` 16) at any hd that is a multiple of 8 up to 128,
      fp32 (32) at hd 64 or 128, and ``hd_v == hd``; callers pass 0
      for any other dtype.  So MLA's heads (hd 192, hd_v 128) never
      reach K4, where the reference's planner sizes its megakernels by
      ``hd + hd_v`` and would take them.

    The query length and the group size do not enter: the kernels walk
    any number of query rows.  Pure and cached; no device query.
    """
    if (block_q is not None or block_k is not None
            or mega_width(hd, dtype_bits // 8) == 0 or hd_v != hd
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
