// K6, K7, K8: the §6.3 partition copy (ocrDbCopy(DB_COPY_PARTITION)) for
// sm_90a.
//
// Replaces the Pallas TPU kernels of repro/kernels/partition_copy.py:
//   K6  _copy_kernel (partition_copy, pallas_call at :74): one tile-aligned
//       contiguous row range;
//   K7  the inner kernel of _multi_partition_copy_impl (:151): N disjoint
//       lane-granular ranges in one launch, one grid step per 256-row tile
//       of the (dst_row, src_row, valid_rows) tables;
//   K8  the inner kernel of _multi_partition_copy_dma (:204): K7's function
//       for buffers over 16 MiB, each table entry (a chunk) staged through
//       a double-buffered VMEM slot by async DMA.
// Buffers are (rows, 128) uint8 views: a row is 128 B, eight 16-byte
// vectors.  Row indices are int32 (the wrapper checks < 2^31 rows);
// addresses are computed in 64 bits.
//
// The hazard not carried over.  The TPU kernels merge an edge tile by a
// masked read-modify-write of the whole tile: rows past valid_rows are
// written back with what dst held when the tile was read, which is safe
// only because the grid runs in table order.  CUDA blocks run in no order,
// so a stale write-back would tear an adjacent range's fresh rows.  Here
// every block writes only its valid rows and never reads dst: the result
// equals range-by-range assignment in any block order, given disjoint
// destinations and a src that does not alias dst (the wrappers check
// both).  Nothing is padded, and no block touches a row past its range.
//
// The range descriptor, in place of the TPU's per-tile tables.  The TPU
// kernels take one scalar-prefetched (dst, src, valid) triple per grid
// step, which the host builds entry by entry.  Here the host hands over
// the ranges themselves, four int32 columns of n: dst row, src row, rows
// and first, the exclusive prefix of ceil(rows / entry_rows); entry e
// belongs to the range i with first[i] <= e < first[i + 1] and holds rows
// (e - first[i]) * entry_rows.. of it (range_descriptor in
// partition_copy.py; the same entries, in the same order, as the
// reference's _block_tables).  A kernel finds its range by a binary
// search of first (ceil(log2 n) steps).  Up to MAX_PARAM_RANGES ranges the
// columns travel by value, as a __grid_constant__ ParamRanges in the
// kernel's parameter space: the search reads the constant cache, no device
// table exists and the launch copies nothing host to device.  Past it the
// columns go to the card as one (4, n) int32 tensor (DeviceRanges), read
// by the same kernel templates through a pointer.
//
// Bound on the H100: the kernels compute nothing, so the bound is the
// bytes, (rows read + rows written) x 128 B at 3.35 TB/s: 0.080 ms for a
// 128 MiB range, 0.16 ms for a 256 MiB partition set.  A 64-range set of
// a 4 MiB buffer moves 8 MiB in 2.5 us, near the cost of a launch.
//
// K6  one block per 256-row (32 KiB) tile, 256 threads; each thread moves
//     16 B per iteration, eight iterations, all loads issued before the
//     stores.
// K7  the same block body, one block per descriptor entry of entry_rows
//     rows: the block searches its range (in parameter space on the
//     by-value route), then issues its copy loads at once; vectors past
//     the entry's rows are masked.  Tile rows of 64 or 128 and a
//     persistent grid time the same (scripts/torch_copy_ab.py
//     --variants): the 4 MiB set runs in one wave on a ~5.5 us launch
//     floor either way.
// K8  a persistent grid of one block per SM; block b walks entries b,
//     b + grid, ...  Thread 0 searches each entry's range, puts its dst
//     row and row count into shared memory beside the slot and fills a
//     two-slot stage with 1-D bulk copies (cp.async.bulk, completion
//     counted in bytes on one mbarrier per slot) of exactly rows * 128 B;
//     while the block stores one slot to dst with 16-byte vector stores,
//     the next entry's copy into the other slot is in flight.  Chunk rows
//     come from autotune.plan_copy_chunk: two slots of chunk x 128 B fit
//     the 227 KB a block may opt into (512 rows: 128 KiB).

#include <cstring>

#include "common.cuh"

namespace repro {
namespace {

constexpr int ROW_VECS = 8;     // 16-byte vectors in a 128-byte row
constexpr int NT = 256;         // threads per block
constexpr int UNROLL = 8;       // vectors in flight per thread (K6, K7)

// Copy `rows` rows from src to dst, both at the start of their range.
__device__ __forceinline__ void copy_rows(uint4* __restrict__ dst,
                                          const uint4* __restrict__ src,
                                          int rows) {
  const int nvec = rows * ROW_VECS;
  for (int base = 0; base < nvec; base += NT * UNROLL) {
    uint4 v[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int i = base + j * NT + threadIdx.x;
      if (i < nvec) v[j] = __ldg(src + i);
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int i = base + j * NT + threadIdx.x;
      if (i < nvec) dst[i] = v[j];
    }
  }
}

__global__ void __launch_bounds__(NT)
partition_copy_kernel(uint4* __restrict__ dst, const uint4* __restrict__ src,
                      int d_row, int s_row, int rows, int block_rows) {
  const int r0 = blockIdx.x * block_rows;
  copy_rows(dst + ((int64_t)d_row + r0) * ROW_VECS,
            src + ((int64_t)s_row + r0) * ROW_VECS,
            min(block_rows, rows - r0));
}

// The descriptor by value: dst, src, rows and first of up to
// MAX_PARAM_RANGES ranges, 3,848 B, under the 4 KB parameter limit with
// the kernels' two pointers.
constexpr int MAX_PARAM_RANGES = 240;
struct ParamRanges {
  int n, entry_rows;
  int col[4][MAX_PARAM_RANGES];
  __device__ __forceinline__ int get(int c, int i) const { return col[c][i]; }
};
static_assert(sizeof(ParamRanges) == 8 + 16 * MAX_PARAM_RANGES,
              "ParamRanges is packed");
static_assert(sizeof(ParamRanges) + 2 * sizeof(void*) <= 4096,
              "ParamRanges fits the parameter space");

// The descriptor on the card: a (4, n) int32 tensor, one row a column.
struct DeviceRanges {
  const int* cols;
  int n, entry_rows;
  __device__ __forceinline__ int get(int c, int i) const {
    return __ldg(cols + (int64_t)c * n + i);
  }
};

enum { DST = 0, SRC = 1, ROWS = 2, FIRST = 3 };

struct Entry {
  int dst, src, rows;   // first rows of the entry, rows it holds
};

// Entry e of a descriptor: its range is the last i with first[i] <= e
// (first[0] is 0; an empty range shares its first with the next one).
template <class R>
__device__ __forceinline__ Entry find_entry(const R& r, int e) {
  int lo = 0, hi = r.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (r.get(FIRST, mid) <= e) lo = mid; else hi = mid - 1;
  }
  const int r0 = (e - r.get(FIRST, lo)) * r.entry_rows;
  return {r.get(DST, lo) + r0, r.get(SRC, lo) + r0,
          min(r.entry_rows, r.get(ROWS, lo) - r0)};
}

template <class R>
__global__ void __launch_bounds__(NT)
multi_copy_tiles_kernel(uint4* __restrict__ dst,
                        const uint4* __restrict__ src,
                        const __grid_constant__ R r) {
  const Entry t = find_entry(r, blockIdx.x);
  copy_rows(dst + (int64_t)t.dst * ROW_VECS, src + (int64_t)t.src * ROW_VECS,
            t.rows);
}

template <class R>
__global__ void __launch_bounds__(NT)
multi_copy_staged_kernel(uint4* __restrict__ dst,
                         const uint4* __restrict__ src,
                         const __grid_constant__ R r, int total) {
  extern __shared__ __align__(128) uint4 stage[];   // 2 slots of chunk rows
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ int2 slot_rows[2];                     // (dst row, rows) a slot
  const int slot_vecs = r.entry_rows * ROW_VECS;
  // thread 0: the entry's row pair, then its bulk load (the mbarrier
  // arrive releases the pair to the threads that wait on the slot)
  auto issue = [&](int e, int slot) {
    const Entry t = find_entry(r, e);
    slot_rows[slot] = make_int2(t.dst, t.rows);
    bulk_load(stage + slot * slot_vecs, src + (int64_t)t.src * ROW_VECS,
              (uint32_t)t.rows * (ROW_VECS * 16), &bars[slot]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_u32(&bars[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if ((int)blockIdx.x < total) issue(blockIdx.x, 0);
  }
  __syncthreads();

  int k = 0;
  for (int e = blockIdx.x; e < total; e += gridDim.x, ++k) {
    const int slot = k & 1;
    const int next = e + gridDim.x;
    if (threadIdx.x == 0 && next < total) {
      // the other slot's reads finished at the last __syncthreads; order
      // them before the async proxy's writes into it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(next, slot ^ 1);
    }
    mbar_wait(&bars[slot], (k >> 1) & 1);
    const uint4* sp = stage + slot * slot_vecs;
    const int2 rows = slot_rows[slot];
    uint4* dp = dst + (int64_t)rows.x * ROW_VECS;
    const int nvec = rows.y * ROW_VECS;
    for (int i = threadIdx.x; i < nvec; i += NT) dp[i] = sp[i];
    __syncthreads();   // this slot is free before it is refilled
  }
}

// The descriptor of a launch: by value from the host columns (4, n) when
// cols_dev is null and n <= MAX_PARAM_RANGES, else through cols_dev.
inline cudaError_t param_ranges(ParamRanges& p, const int* cols, int n,
                                int entry_rows) {
  if (n > MAX_PARAM_RANGES || cols == nullptr) return cudaErrorInvalidValue;
  p.n = n;
  p.entry_rows = entry_rows;
  for (int c = 0; c < 4; ++c)
    std::memcpy(p.col[c], cols + (size_t)c * n, n * sizeof(int));
  return cudaSuccess;
}

}  // namespace
}  // namespace repro

// K6: rows rows from src row s_row to dst row d_row, one block per
// block_rows tile (the wrapper checks the tile alignment and bounds).
extern "C" int repro_partition_copy(void* dst, const void* src, int d_row,
                                    int s_row, int rows, int block_rows,
                                    void* stream) {
  using namespace repro;
  if (rows <= 0) return cudaSuccess;
  if (block_rows <= 0) return cudaErrorInvalidValue;
  const int grid = (rows + block_rows - 1) / block_rows;
  partition_copy_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(dst), static_cast<const uint4*>(src), d_row, s_row,
      rows, block_rows);
  return cudaGetLastError();
}

// The descriptor's by-value capacity and size, which the wrapper holds
// against its own: out[0] MAX_PARAM_RANGES, out[1] sizeof(ParamRanges).
extern "C" int repro_copy_param_ranges(int* out) {
  using namespace repro;
  out[0] = MAX_PARAM_RANGES;
  out[1] = (int)sizeof(ParamRanges);
  return cudaSuccess;
}

// K7: the descriptor's (4, n) int32 columns (dst rows, src rows, rows,
// first) on the host (cols_dev null: passed by value) or on the card;
// total entries of entry_rows rows, one block each.
extern "C" int repro_multi_partition_copy_tiles(void* dst, const void* src,
                                                const void* cols_host,
                                                const void* cols_dev, int n,
                                                int total, int entry_rows,
                                                void* stream) {
  using namespace repro;
  if (total <= 0) return cudaSuccess;
  if (n <= 0 || entry_rows <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* d = static_cast<uint4*>(dst);
  auto* s = static_cast<const uint4*>(src);
  if (cols_dev != nullptr) {
    const DeviceRanges r{static_cast<const int*>(cols_dev), n, entry_rows};
    multi_copy_tiles_kernel<DeviceRanges><<<total, NT, 0, st>>>(d, s, r);
    return cudaGetLastError();
  }
  ParamRanges p;
  const cudaError_t err =
      param_ranges(p, static_cast<const int*>(cols_host), n, entry_rows);
  if (err != cudaSuccess) return err;
  multi_copy_tiles_kernel<ParamRanges><<<total, NT, 0, st>>>(d, s, p);
  return cudaGetLastError();
}

// K8: the descriptor as K7's with entries of at most chunk rows; grid
// persistent blocks (one per SM).
extern "C" int repro_multi_partition_copy_staged(void* dst, const void* src,
                                                 const void* cols_host,
                                                 const void* cols_dev, int n,
                                                 int total, int chunk,
                                                 int grid, void* stream) {
  using namespace repro;
  if (total <= 0) return cudaSuccess;
  if (n <= 0 || chunk <= 0 || grid <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * (size_t)chunk * ROW_VECS * sizeof(uint4);
  auto* d = static_cast<uint4*>(dst);
  auto* s = static_cast<const uint4*>(src);
  if (cols_dev != nullptr) {
    auto kern = multi_copy_staged_kernel<DeviceRanges>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const DeviceRanges r{static_cast<const int*>(cols_dev), n, chunk};
    kern<<<grid, NT, smem, st>>>(d, s, r, total);
    return cudaGetLastError();
  }
  ParamRanges p;
  cudaError_t err =
      param_ranges(p, static_cast<const int*>(cols_host), n, chunk);
  if (err != cudaSuccess) return err;
  auto kern = multi_copy_staged_kernel<ParamRanges>;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, smem, st>>>(d, s, p, total);
  return cudaGetLastError();
}
