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
// Bound on the H100: the kernels compute nothing, so the bound is the
// bytes, (rows read + rows written) x 128 B at 3.35 TB/s: 0.080 ms for a
// 128 MiB range, 0.16 ms for a 256 MiB partition set.  A 64-range set of
// a 4 MiB buffer moves 8 MiB in 2.5 us, near the cost of a launch.
//
// K6  one block per 256-row (32 KiB) tile, 256 threads; each thread moves
//     16 B per iteration, eight iterations, all loads issued before the
//     stores.
// K7  the same block body, one block per table entry; the tables are read
//     from device memory, vectors past valid_rows * 8 are masked.
// K8  a persistent grid of one block per SM; block b walks table entries
//     b, b + grid, ...  Thread 0 fills a two-slot shared-memory stage with
//     1-D bulk copies (cp.async.bulk, completion counted in bytes on one
//     mbarrier per slot) of exactly valid_rows * 128 B; while the block
//     stores one slot to dst with 16-byte vector stores, the next entry's
//     copy into the other slot is in flight.  Chunk rows come from
//     autotune.plan_copy_chunk: two slots of chunk x 128 B fit the 227 KB
//     a block may opt into (512 rows: 128 KiB).

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

__global__ void __launch_bounds__(NT)
multi_copy_tiles_kernel(uint4* __restrict__ dst,
                        const uint4* __restrict__ src,
                        const int* __restrict__ tab, int n) {
  const int e = blockIdx.x;
  copy_rows(dst + (int64_t)tab[e] * ROW_VECS,
            src + (int64_t)tab[n + e] * ROW_VECS, tab[2 * n + e]);
}

__global__ void __launch_bounds__(NT)
multi_copy_staged_kernel(uint4* __restrict__ dst,
                         const uint4* __restrict__ src,
                         const int* __restrict__ tab, int n, int chunk) {
  extern __shared__ __align__(128) uint4 stage[];   // 2 slots of chunk rows
  __shared__ __align__(8) uint64_t bars[2];
  const int slot_vecs = chunk * ROW_VECS;
  auto issue = [&](int e, int slot) {
    bulk_load(stage + slot * slot_vecs, src + (int64_t)tab[n + e] * ROW_VECS,
              (uint32_t)tab[2 * n + e] * (ROW_VECS * 16), &bars[slot]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_u32(&bars[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if ((int)blockIdx.x < n) issue(blockIdx.x, 0);
  }
  __syncthreads();

  int k = 0;
  for (int e = blockIdx.x; e < n; e += gridDim.x, ++k) {
    const int slot = k & 1;
    const int next = e + gridDim.x;
    if (threadIdx.x == 0 && next < n) {
      // the other slot's reads finished at the last __syncthreads; order
      // them before the async proxy's writes into it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(next, slot ^ 1);
    }
    mbar_wait(&bars[slot], (k >> 1) & 1);
    const uint4* sp = stage + slot * slot_vecs;
    uint4* dp = dst + (int64_t)tab[e] * ROW_VECS;
    const int nvec = tab[2 * n + e] * ROW_VECS;
    for (int i = threadIdx.x; i < nvec; i += NT) dp[i] = sp[i];
    __syncthreads();   // this slot is free before it is refilled
  }
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

// K7: tab is (3, n) int32 on the device: dst rows, src rows, valid rows.
extern "C" int repro_multi_partition_copy_tiles(void* dst, const void* src,
                                                const void* tab, int n,
                                                void* stream) {
  using namespace repro;
  if (n <= 0) return cudaSuccess;
  multi_copy_tiles_kernel<<<n, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(dst), static_cast<const uint4*>(src),
      static_cast<const int*>(tab), n);
  return cudaGetLastError();
}

// K8: tables as K7's with entries of at most chunk rows; grid persistent
// blocks (one per SM).
extern "C" int repro_multi_partition_copy_staged(void* dst, const void* src,
                                                 const void* tab, int n,
                                                 int chunk, int grid,
                                                 void* stream) {
  using namespace repro;
  if (n <= 0) return cudaSuccess;
  if (chunk <= 0 || grid <= 0) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)chunk * ROW_VECS * sizeof(uint4);
  cudaError_t err = cudaFuncSetAttribute(
      multi_copy_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  multi_copy_staged_kernel<<<grid, NT, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(dst), static_cast<const uint4*>(src),
      static_cast<const int*>(tab), n, chunk);
  return cudaGetLastError();
}
