// Shared helpers of the kernels: dtype conversion and the vectorised
// tile loader of the attention kernels, the tensor-core, cp.async and
// bulk-copy (TMA) helpers.  The attention loaders take row-major tensors
// with rows of hd elements, hd a multiple of 8, so each row starts on a
// 16-byte boundary (the wrappers check the base pointers) and a row loads
// as hd*sizeof(T)/16 vectors of 16 B.  A kernel is compiled for a width
// HD (64, 128, or 192 for MLA's q and k) and runs any hd <= HD: the
// loaders zero-fill columns hd..HD in shared memory and the stores write
// the hd real columns only.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float NEG_INF = -1e30f;   // the reference's masked-score value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The reference's _tile_mask for one (query row, key column), both global
// positions; col < Sk masks the ragged kv edge.
__device__ __forceinline__ bool is_live(int row, int col, int Sk, int causal,
                                        int window) {
  return col < Sk && (!causal || col <= row) &&
         (window <= 0 || row - col < window);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

// Copy rows [0, ROWS) of a (rows, hd) tile into shared memory as fp32
// with row stride LDS, times `mul`.  hd, the tensor's row length, is at
// most the compiled width HD and a multiple of 16 / sizeof(T) elements,
// so every row starts on a 16-byte boundary; columns hd..HD (a head
// narrower than HD) and rows at or past `valid_rows` (the ragged edge)
// are written as zeros and never read from global memory.
template <typename T, int HD, int ROWS, int LDS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          int valid_rows, float mul,
                                          int hd = HD, int ld = 0) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = HD / V;
  const size_t rs = ld > 0 ? ld : hd;   // the tensor's row stride
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += NT) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * V;
    float x[V];
    if (r < valid_rows && c < hd) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + r * rs + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = to_float(e[i]) * mul;
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) dst[r * LDS + c + i] = x[i];
  }
}

// The (q/k width, v width) pairs the tiled attention kernels K1, K2 and
// K3 are compiled for: 0 = (64, 64), 1 = (128, 128), 2 = (192, 128)
// (DeepSeek-V2's MLA heads, q/k 128 + 64 and v 128), 3 = (576, 512) (its
// absorbed route: one latent kv head, k = [c_kv 512, k_rope 64], v =
// c_kv; the kernels of flash_attention_wide.cu).  Returns the first pair
// that holds (hd, hd_v), both multiples of 8, or -1 where none does (the
// wrapper's autotune.kernel_head_dim holds the same table).
__host__ __device__ inline int attn_pair(int hd, int hd_v) {
  if (hd % 8 || hd_v % 8 || hd < 8 || hd_v < 8) return -1;
  if (hd <= 64 && hd_v <= 64) return 0;
  if (hd <= 128 && hd_v <= 128) return 1;
  if (hd <= 192 && hd_v <= 128) return 2;
  if (hd <= 576 && hd_v <= 512) return 3;
  return -1;
}

// The (576, 512) pair's kernels (flash_attention_wide.cu), which the
// entry points of flash_attention.cu (K1) and flash_attention_bwd.cu (K2,
// K3: which 0 dq, 1 dk/dv, 2 fused) call for attn_pair 3.  dtype 0 fp32,
// 1 bf16.  v's rows are ldv elements apart: hd_v, or hd where v is k's
// first hd_v columns (v == k).  ws is the dk/dv kernels' fp32 workspace
// of `splits` head slices, (splits, B*KH*Sk, hd) then (splits, B*KH*Sk,
// hd_v).  K3's dq is an fp32 accumulator in fp32; in bf16 it is dq in
// q's dtype, summed from the dS workspace `ds` over n_pass passes (host
// triples of first q row, end q row, tile pairs; autotune.wide_ds_passes).
// With occupancy non-null, report the kernel's blocks per SM instead of
// launching.
cudaError_t wide_fwd(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int H, int KH, int Sq, int Sk,
                     int hd, int hd_v, int ldv, int q_offset, int causal,
                     int window, float scale, int dtype, int* occupancy,
                     cudaStream_t st);
cudaError_t wide_bwd(int which, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, void* dk, void* dv, float* ws, int splits,
                     void* ds, const int* passes, int n_pass, int B, int H,
                     int KH, int Sq, int Sk, int hd, int hd_v, int ldv,
                     int q_offset, int causal, int window, float scale,
                     int dtype, int* occupancy, cudaStream_t st);

// The bf16 wgmma kernels at the pairs (64, 64) and (128, 128)
// (flash_attention_hopper.cu), which the entry points of
// flash_attention.cu (K1) and flash_attention_bwd.cu (K2's dk/dv with
// fused 0, K3 with fused 1) call for attn_pair 0 and 1 in bf16; K3 adds
// dq into the fp32 buffer dq_acc.  With occupancy non-null, report the
// kernel's blocks per SM instead of launching.
cudaError_t hopper_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int KH, int Sq, int Sk,
                       int hd, int hd_v, int q_offset, int causal, int window,
                       float scale, int* occupancy, cudaStream_t st);
cudaError_t hopper_bwd(int fused, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, float* dq_acc,
                       int B, int H, int KH, int Sq, int Sk, int hd, int hd_v,
                       int q_offset, int causal, int window, float scale,
                       int* occupancy, cudaStream_t st);

// ------------------------------------------- CUDA-core tile products
//
// The SSD kernels' fp32 products from shared memory (csrc/ssd_scan.cu's
// fp32 route, csrc/ssd_scan_bwd.cu).

// acc[i][j] += sum_k A(m0 + i*ms, k) * B(n0 + j*ns, k) over k < K, where
// A(m, k) is A[m*lda + k] if A_KC (k contiguous) else A[k*lda + m], and
// likewise for B.  Spreading a thread's rows and columns by ms, ns puts
// the neighbouring threads of a warp on neighbouring rows / columns.
template <int TM, int TN, bool A_KC, bool B_KC>
__device__ __forceinline__ void mac(float (&acc)[TM][TN],
                                    const float* __restrict__ A, int lda,
                                    const float* __restrict__ B, int ldb,
                                    int m0, int ms, int n0, int ns, int K) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + i * ms;
      a[i] = A_KC ? A[m * lda + k] : A[k * lda + m];
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + j * ns;
      b[j] = B_KC ? B[n * ldb + k] : B[k * ldb + n];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// ---------------------------------------------------- tensor-core helpers
//
// bf16 operands for mma.sync.m16n8k16 (fp32 accumulators), loaded from
// shared memory with ldmatrix, and cp.async copies global -> shared.
// Fragment layout of one m16n8k16 product (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major)  a0: (g, 2t..2t+1)   a1: (g+8, 2t..)
//                           a2: (g, 2t+8..)     a3: (g+8, 2t+8..)
//   B (16 x 8, col-major)   b0: (2t..2t+1, g)   b1: (2t+8.., g)
//   C (16 x 8)              c0,c1: (g, 2t..2t+1)  c2,c3: (g+8, 2t..)
// so the C fragments of two neighbouring n8 tiles, packed to bf16 pairs,
// are the A fragment of one k16 step (FlashAttention-2's layout trick).

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------ bulk copies (TMA), 1-D
//
// One thread moves a whole contiguous range between global and shared
// memory; a load completes on an mbarrier (its bytes counted as
// transactions), a store joins the issuing thread's current bulk group.

// Start a bulk copy of `bytes` (a multiple of 16) from global memory into
// shared memory, completing on `bar` (one arrival, plus the bytes).
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem,
                                          uint32_t bytes, uint64_t* bar) {
  const uint32_t b = smem_u32(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(b), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(smem)), "l"(gmem), "r"(bytes), "r"(b) : "memory");
}

// `bytes` (a multiple of 16) from shared to global memory, in the issuing
// thread's current bulk group
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(gmem), "r"(smem_u32(smem)), "r"(bytes) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// 16 bytes global -> shared, asynchronously; with ok false nothing is read
// and the 16 bytes are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes, as above
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i.  Plain: lane gets (row g, cols 2t, 2t+1) of each; trans: (rows
// 2t, 2t+1, col g).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b on the tensor cores, bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as a bf16 pair hi plus a bf16 pair lo with x = hi + lo to
// about 2^-16 relative: hi = bf16(x), lo = bf16(x - hi).  x0 takes the
// low half, the lower column of a fragment.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16_bits(h);
  lo = bf16_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The A operand of one k16 step from the accumulators of two n8 tiles,
// as a hi + lo pair of bf16 fragments.
__device__ __forceinline__ void split_frag(const float (&c0)[4],
                                           const float (&c1)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// c += (hi + lo) . b for the two n8 tiles whose B fragments b holds
__device__ __forceinline__ void mma_pair(float (&c0)[4], float (&c1)[4],
                                         const uint32_t (&hi)[4],
                                         const uint32_t (&lo)[4],
                                         const uint32_t (&b)[4]) {
  mma_bf16(c0, hi, b[0], b[1]);
  mma_bf16(c0, lo, b[0], b[1]);
  mma_bf16(c1, hi, b[2], b[3]);
  mma_bf16(c1, lo, b[2], b[3]);
}

// ldmatrix addresses, for one 16 x 16 step at (r0, c0) of a tile with row
// stride ld: A from a row-major [m][k] tile, B from an [n][k] tile (two
// n8 tiles), and their transposed forms from [k][m] and [k][n] tiles.
__device__ __forceinline__ const bf16* a_addr(const bf16* s, int ld, int r0,
                                              int c0, int lane) {
  return s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 +
         (lane >> 4) * 8;
}
__device__ __forceinline__ const bf16* b_addr(const bf16* s, int ld, int r0,
                                              int c0, int lane) {
  return s + (r0 + (lane & 7) + (lane >> 4) * 8) * ld + c0 +
         ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ const bf16* at_addr(const bf16* s, int ld, int k0,
                                               int m0, int lane) {
  return s + (k0 + (lane & 7) + (lane >> 4) * 8) * ld + m0 +
         ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ const bf16* bt_addr(const bf16* s, int ld, int k0,
                                               int n0, int lane) {
  return s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
         (lane >> 4) * 8;
}

// Rows [0, rows) of a chunk of a (S, cols) bf16 operand (row stride ld
// elements) into shared memory with row stride lds, 16 bytes a copy, by
// a block of NT threads; rows at or past `valid` are zeros.  cols is a
// multiple of 8.
template <int NT = 256>
__device__ __forceinline__ void cp_rows(bf16* dst, int lds, const bf16* src,
                                        long long ld, int rows, int valid,
                                        int cols) {
  // thread i copies column piece i % ch of rows i / ch, + step, ...
  const int ch = cols / 8, step = NT / ch;
  const int r0 = threadIdx.x / ch, c = (threadIdx.x % ch) * 8;
  if (r0 >= step) return;
  bf16* d = dst + r0 * lds + c;
  const bf16* g = src + r0 * ld + c;
  for (int r = r0; r < rows; r += step) {
    const bool ok = r < valid;
    cp_async16(d, ok ? g : src, ok);
    d += step * lds;
    g += step * ld;
  }
}

// (x0, x1) * (w0, w1) from a packed bf16 pair, as a bf16 hi + lo pair
__device__ __forceinline__ void scale_split(uint32_t x, float2 w, uint32_t& hi,
                                            uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  split_bf16(f.x * w.x, f.y * w.y, hi, lo);
}

// the chunk as the tc kernels hold it: whole 16-row tiles
__host__ __device__ constexpr int qpad16(int q) { return (q + 15) / 16 * 16; }

// Rows [0, ROWS) of a bf16 (rows, hd) tile (row stride ld, default hd)
// into shared memory with row stride LD by 16-byte cp.async; rows at or
// past valid_rows and columns hd..HD are zero-filled (nothing is read for
// them).
template <int HD, int ROWS, int LD, int NT>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src,
                                        int valid_rows, int hd, int ld = 0) {
  constexpr int CH = HD / 8;
  const size_t rs = ld > 0 ? ld : hd;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const bool ok = r < valid_rows && c < hd;
    cp_async16(dst + r * LD + c, ok ? src + r * rs + c : src, ok);
  }
}

// N fp32 values (a tile's lse or delta) by 4-byte cp.async, zeros at or
// past `valid`
template <int N, int NT>
__device__ __forceinline__ void cp_vals(float* dst, const float* src,
                                        int valid) {
  for (int i = threadIdx.x; i < N; i += NT)
    cp_async4(dst + i, i < valid ? src + i : src, i < valid);
}

}  // namespace repro
