// K1: flash-attention forward, causal / sliding-window GQA, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// _fwd_kernel (launched by _fwd_call, pallas_call at :437).  That kernel
// walks kv tiles on the innermost sequential grid axis and carries the
// online softmax (m, l, acc) in VMEM scratch from one grid step to the
// next.  CUDA blocks run in no order, so here one block owns a q tile of
// one (batch, head) and walks the kv tiles in a loop, with the carry in
// registers.  Query head h reads kv head h / G.  The loop bounds skip
// every kv tile that the causal mask or the window masks whole (the TPU
// kernel's pl.when skips); the ragged Sq and Sk edges are masked by
// index, the host pads nothing.
//
// Head widths: q and k have width hd, v and the output hd_v.  The
// kernels are compiled for the pairs (HD, HD_V) = (64, 64), (128, 128)
// and (192, 128) (attn_pair in common.cuh) and run any hd, hd_v that are
// multiples of 8 at the first pair that holds both (hd 32 at 64; hd 120,
// h2o-danube3-4b's, at 128; DeepSeek-V2's MLA, q/k 128 + 64 = 192 and v
// 128, at (192, 128); its reduced variant (48, 32) at 64).  The fourth
// pair, (576, 512), MLA's absorbed route, has kernels of its own
// (flash_attention_wide.cu), which dispatch() calls, and so do the bf16
// kernels of the first two (flash_attention_hopper.cu).  The tiles
// load the true columns and zero-fill the rest in shared memory, so the
// padded columns add zeros to every score and yield zeros that the store
// skips; the tensors stay unpadded.  The wrapper passes hd, hd_v and the
// scale 1/sqrt(hd).  The fp32 kernels of the equal-width pairs are built
// twice, SAME (hd_v == hd: the compiler sees one width) and not, as in
// flash_attention_bwd.cu.
//
// Numerics follow the reference: s = (q . k) * 1/sqrt(hd) with fp32
// sums, masked scores -1e30, exp(s - m) and the rescale exp(m_old -
// m_new) in fp32, the denominator floored at 1e-37.  With an lse pointer
// (the reference's with_lse, taken on the differentiated path) the
// kernel also writes lse = m + log(max(l, 1e-37)) in fp32, one store per
// row at the end as the reference's _finalize does; the backward kernels
// (flash_attention_bwd.cu) recompute P from it.  The exponentials stay in
// natural log: folding log2(e) into m would turn the m of a row with no
// live key (-1e30) into -inf in lse.  The bf16 kernel takes the fast
// __expf (ex2.approx of x * log2(e), a few ulp) of the difference s - m,
// taken first so that a masked s = m = -1e30 gives exactly 1, as expf
// does; accurate expf costs ~10 instructions an element, about as much
// issue time as the tile's mma work, and in one A/B on the card __expf
// took 10-14 % off K1 at 1 x 3008, 1 x 6000 and 4 x 4096 (6 % at the
// launch-bound 64 x 256).
//
// Bound on the H100: at the serve shape (B=1, H=15, KH=5, hd=64,
// Sq=Sk=3008, bf16, causal) the live work is 4*hd*H*(live pairs)
// ~ 17.4 GFLOP against ~15.4 MB moved, so the function is compute-bound:
// ~18 us at 989 TFLOP/s of bf16 tensor cores; at training's 4 x 4096,
// 128.9 GFLOP, 0.13 ms.
//
// bf16 inputs at the pairs (64, 64) and (128, 128): the wgmma kernel of
// flash_attention_hopper.cu (TMA-fed tiles, a producer warpgroup and two
// consumers of 64 q rows each), which dispatch() calls.
//
// bf16 at (192, 128): tensor cores (flash_fwd_tc_kernel), FlashAttention-
// 2's layout on mma.sync.  A block of four warps owns a BQ = 64-row q
// tile, 16 rows a warp; q tiles launch heaviest first (the causal
// diagonal's last tiles have the most kv tiles), so the tail wave is
// short.  K and V tiles of BK = 64 rows are double-buffered in shared
// memory by 16-byte cp.async (zero-fill past hd and past Sk), rows padded
// by 16 B (stride HD + 8 bf16) so the eight rows an ldmatrix phase reads
// fall in distinct banks.  Per kv tile each warp computes S = Q K^T (16 x
// 64) with mma.sync.m16n8k16 (bf16 in, fp32 sums), Q's A fragments read
// from the Q tile in shared memory (48 registers a thread held in
// registers would push the block past the 255 the launch bound allows
// beside O) and K's B fragments by ldmatrix, scales the fp32
// accumulators, masks only on tiles that the causal edge, the window edge
// or Sk cuts, runs the online softmax on the accumulator fragments (row
// max and sum across the 4 lanes of a quad by shfl_xor 1 and 2, O
// rescaled in registers), splits P into bf16 A fragments in registers
// (the C layout of two n8 tiles is the A layout of one k16 step) and adds
// P V (V's B fragments by ldmatrix.trans).  P enters P V as a bf16 hi +
// lo pair (P = hi + lo to ~2^-16 relative), as in the backward kernels,
// so P V keeps the reference's fp32 P: rounded once to bf16 (2^-9), P
// moved the output against the plain version by one bf16 ulp of its own
// at every large |o|, and l, which sums the fp32 P, no longer matched the
// numerator.  Shared memory: (BQ + 2 BK) * (HD + 8) * 2 B + 2 BK * (HD_V
// + 8) * 2 B = 111,616 B; 193 registers, no spills, 2 blocks an SM.
//
// fp32 inputs keep the CUDA-core kernel (flash_fwd_kernel): the card's
// fp32 comparisons hold K1 to 1e-4 of the plain version, which TF32
// tensor cores (10-bit mantissa) would not meet.  BQ = BK = 64, 256
// threads; thread (ty, tx) of a 16x16 grid owns q rows 4*ty..4*ty+3,
// score columns tx+16j (j < 4) and output columns tx+16j (j < hd/16).
// Shared memory holds q (scaled), k (rows padded to hd+1 floats so the
// 16 column-owners of a warp hit 16 banks), v and the probability tile,
// all fp32: 66,304 B at hd=64, 115,456 B at hd=128 and 148,224 B at
// (192, 128).  Its products
// are fp32 FMAs out of shared memory, bound by FMA issue and
// shared-memory bandwidth.

#include "common.cuh"

namespace repro {
namespace {

constexpr int BQ = 64, BK = 64, NT = 256;

template <int HD, int HDV>
constexpr size_t fwd_smem_bytes() {
  return (size_t)(BQ * (HD + 1) + BK * (HD + 1) + BK * HDV + BQ * (BK + 1)) *
         sizeof(float);
}

template <typename T, int HD, int HDV, bool SAME>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int G,
                 int Sq, int Sk, int hd, int hd_v, int q_offset, int causal,
                 int window, float scale) {
  if (SAME) hd_v = hd;   // v as wide as q, k: one width for the compiler
  constexpr int LDQ = HD + 1, LDP = BK + 1, NJ = HDV / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                 // BQ x LDQ, pre-scaled
  float* sK = sQ + BQ * LDQ;        // BK x LDQ
  float* sV = sK + BK * LDQ;        // BK x HDV
  float* sP = sV + BK * HDV;        // BQ x LDP probabilities

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;                       // b * H + h
  const int bkv = (bh / H) * (H / G) + (bh % H) / G;  // b * KH + h / G
  const T* kp = k + (size_t)bkv * Sk * hd;
  const T* vp = v + (size_t)bkv * Sk * hd_v;

  load_rows<T, HD, BQ, LDQ, NT>(sQ, q + ((size_t)bh * Sq + q0) * hd,
                                min(BQ, Sq - q0), scale, hd);

  const int row0 = q_offset + q0;   // global position of tile row 0
  int kv_begin = 0, kv_end = Sk;
  if (causal) kv_end = min(Sk, row0 + BQ);
  if (window > 0) kv_begin = max(0, row0 - window + 1);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (kv_begin / BK) * BK; k0 < kv_end; k0 += BK) {
    __syncthreads();   // sQ written; previous tile's sK/sV/sP reads done
    const int kv_rows = min(BK, Sk - k0);
    load_rows<T, HD, BK, LDQ, NT>(sK, kp + (size_t)k0 * hd, kv_rows, 1.f,
                                  hd);
    load_rows<T, HDV, BK, HDV, NT>(sV, vp + (size_t)k0 * hd_v, kv_rows, 1.f,
                                   hd_v);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty * 4 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sK[(tx + 16 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
      float tmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool live = col < Sk && (!causal || col <= row) &&
                          (window <= 0 || row - col < window);
        if (!live) s[i][j] = NEG_INF;
        tmax = fmaxf(tmax, s[i][j]);
      }
      // the 16 lanes sharing ty hold one row: reduce across them
#pragma unroll
      for (int off = 8; off; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty * 4 + i) * LDP + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty * 4 + i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sV[kk * HDV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-37f);
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * Sq + r] = m[i] + logf(den);
    T* op = o + ((size_t)bh * Sq + r) * hd_v;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (tx + 16 * j < hd_v) op[tx + 16 * j] = from_float<T>(acc[i][j] / den);
  }
}

// ------------------------------------------------ bf16: tensor cores

constexpr int TC_NT = 128, TC_BQ = 64, TC_BK = 64;

template <int HD, int HDV>
constexpr size_t tc_fwd_smem_bytes() {
  return ((size_t)(TC_BQ + 2 * TC_BK) * (HD + 8) +
          (size_t)2 * TC_BK * (HDV + 8)) * sizeof(bf16);
}

// one block per (b*H + h, q tile); q tiles in reverse, heaviest first
template <int HD, int HDV>
__global__ void __launch_bounds__(TC_NT, 2)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int H, int G, int Sq, int Sk,
                    int hd, int hd_v, int q_offset, int causal, int window,
                    float scale) {
  constexpr int LD = HD + 8, LDV = HDV + 8, KS = HD / 16, NK = TC_BK / 8,
                ND = HDV / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // TC_BQ x LD
  bf16* sK = sQ + TC_BQ * LD;                      // 2 stages of TC_BK x LD
  bf16* sV = sK + 2 * TC_BK * LD;                  // 2 stages of TC_BK x LDV

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, w0 = warp * 16;
  const int bh = blockIdx.x;                          // b * H + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;
  const int bkv = (bh / H) * (H / G) + (bh % H) / G;  // b * KH + h / G
  const bf16* kp = k + (size_t)bkv * Sk * hd;
  const bf16* vp = v + (size_t)bkv * Sk * hd_v;
  const int q_rows = min(TC_BQ, Sq - q0);
  const int row0 = q_offset + q0;   // global position of tile row 0
  int kv_begin = 0, kv_end = Sk;
  if (causal) kv_end = min(Sk, row0 + TC_BQ);
  if (window > 0) kv_begin = max(0, row0 - window + 1);
  const int kt0 = (kv_begin / TC_BK) * TC_BK;
  const int n_it = kv_end > kt0 ? (kv_end - kt0 + TC_BK - 1) / TC_BK : 0;

  cp_tile<HD, TC_BQ, LD, TC_NT>(sQ, q + ((size_t)bh * Sq + q0) * hd, q_rows,
                                hd);
  if (n_it > 0) {
    cp_tile<HD, TC_BK, LD, TC_NT>(sK, kp + (size_t)kt0 * hd, Sk - kt0, hd);
    cp_tile<HDV, TC_BK, LDV, TC_NT>(sV, vp + (size_t)kt0 * hd_v, Sk - kt0,
                                    hd_v);
  }
  cp_async_commit();

  // this thread's rows of the warp's 16: w0 + g and w0 + g + 8
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, k0 = kt0 + it * TC_BK;
    if (it + 1 < n_it) {   // prefetch the next kv tile into the other stage
      const int nk0 = k0 + TC_BK;
      cp_tile<HD, TC_BK, LD, TC_NT>(sK + (st ^ 1) * TC_BK * LD,
                                    kp + (size_t)nk0 * hd, Sk - nk0, hd);
      cp_tile<HDV, TC_BK, LDV, TC_NT>(sV + (st ^ 1) * TC_BK * LDV,
                                      vp + (size_t)nk0 * hd_v, Sk - nk0,
                                      hd_v);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = sK + st * TC_BK * LD;
    const bf16* Vs = sV + st * TC_BK * LDV;

    // S = Q K^T, fp32 sums
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, a_addr(sQ, LD, w0, ks * 16, lane));
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, b_addr(Ks, LD, np * 16, ks * 16, lane));
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }
    // scale in fp32; mask only where the causal edge, the window edge or
    // Sk cuts the tile
    const bool full = k0 + TC_BK <= Sk &&
                      (!causal || k0 + TC_BK - 1 <= row0) &&
                      (window <= 0 || row0 + TC_BQ - 1 - k0 < window);
    if (full) {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale;
    } else {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + w0 + g + 8 * (e >> 1);
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          s[n][e] = is_live(row, col, Sk, causal, window) ? s[n][e] * scale
                                                          : NEG_INF;
        }
    }

    // online softmax on the fragments: a row lives in the 4 lanes of a quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = __expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - m[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P from registers as a bf16 hi + lo pair, V^T by
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_frag(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, bt_addr(Vs, LDV, kk * 16, np * 16, lane));
        mma_pair(acc[2 * np], acc[2 * np + 1], hi, lo, b);
      }
    }
    __syncthreads();   // this stage is read; the next prefetch may land
  }

  // each lane holds a quarter of its rows' sums
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w0 + g + 8 * i;
    if (r >= q_rows) continue;
    const float den = fmaxf(l[i], 1e-37f);
    if (lse != nullptr && t == 0)
      lse[(size_t)bh * Sq + q0 + r] = m[i] + logf(den);
    bf16* out = o + ((size_t)bh * Sq + q0 + r) * hd_v;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < hd_v)
        *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
            acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
    }
  }
}

struct FwdArgs {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, H, KH, Sq, Sk, hd, hd_v, ldv, q_offset, causal, window;
  float scale;
  int* occupancy;   // non-null: report blocks per SM instead of launching
};

// Set the kernel's shared-memory limit, then either report its blocks
// per SM (a.occupancy) or launch it.
template <typename T, typename Kern>
cudaError_t run(Kern kern, const FwdArgs& a, dim3 grid, int threads,
                size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (a.occupancy != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.occupancy, kern,
                                                         threads, smem);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.H,
      a.H / a.KH, a.Sq, a.Sk, a.hd, a.hd_v, a.q_offset, a.causal, a.window,
      a.scale);
  return cudaGetLastError();
}

template <int HD, int HDV, bool SAME>
cudaError_t launch_f32(const FwdArgs& a, cudaStream_t st) {
  return run<float>(flash_fwd_kernel<float, HD, HDV, SAME>, a,
                    dim3((a.Sq + BQ - 1) / BQ, a.B * a.H), NT,
                    fwd_smem_bytes<HD, HDV>(), st);
}

template <int HD, int HDV>
cudaError_t launch_tc(const FwdArgs& a, cudaStream_t st) {
  return run<bf16>(flash_fwd_tc_kernel<HD, HDV>, a,
                   dim3(a.B * a.H, (a.Sq + TC_BQ - 1) / TC_BQ), TC_NT,
                   tc_fwd_smem_bytes<HD, HDV>(), st);
}

cudaError_t dispatch(const FwdArgs& a, int dtype, cudaStream_t st) {
  const int pair = attn_pair(a.hd, a.hd_v);
  if (pair < 0) return cudaErrorInvalidValue;
  if (a.occupancy == nullptr) {
    if (a.B <= 0 || a.H <= 0 || a.Sq <= 0) return cudaSuccess;
    if (a.KH <= 0 || a.H % a.KH) return cudaErrorInvalidValue;
    // v's rows are hd_v apart, or (the (576, 512) pair) k's prefix
    if (a.ldv != a.hd_v && !(pair == 3 && a.v == a.k && a.ldv == a.hd))
      return cudaErrorInvalidValue;
    // grid limits: fp32 (q tiles, B*H), bf16 (B*H, q tiles)
    const int nq = (a.Sq + BQ - 1) / BQ;
    if ((dtype == 0 && a.B * a.H > 65535) || (dtype == 1 && nq > 65535))
      return cudaErrorInvalidValue;
  }
  if (pair == 3)
    return wide_fwd(a.q, a.k, a.v, a.o, a.lse, a.B, a.H, a.KH, a.Sq, a.Sk,
                    a.hd, a.hd_v, a.ldv, a.q_offset, a.causal, a.window,
                    a.scale, dtype, a.occupancy, st);
  const bool same = a.hd == a.hd_v;
  if (dtype == 0)
    return pair == 2 ? launch_f32<192, 128, false>(a, st)
           : same    ? (pair == 0 ? launch_f32<64, 64, true>(a, st)
                                  : launch_f32<128, 128, true>(a, st))
                     : (pair == 0 ? launch_f32<64, 64, false>(a, st)
                                  : launch_f32<128, 128, false>(a, st));
  if (dtype != 1) return cudaErrorInvalidValue;
  if (pair == 2) return launch_tc<192, 128>(a, st);
  return hopper_fwd(a.q, a.k, a.v, a.o, a.lse, a.B, a.H, a.KH, a.Sq, a.Sk,
                    a.hd, a.hd_v, a.q_offset, a.causal, a.window, a.scale,
                    a.occupancy, st);
}

}  // namespace
}  // namespace repro

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  q
// (B,H,Sq,hd), k (B,KH,Sk,hd), v (B,KH,Sk,hd_v), out (B,H,Sq,hd_v), all
// contiguous but v, whose rows are ldv elements apart: hd_v, or at the
// (576, 512) pair hd where v is k's first hd_v columns (v == k); (hd,
// hd_v) multiples of 8 that a compiled pair holds (attn_pair); lse
// (B,H,Sq) fp32, or null for the forward without it; scale 1/sqrt(hd).
// Returns the launch's cudaError_t.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int H, int KH,
                               int Sq, int Sk, int hd, int hd_v, int ldv,
                               int q_offset, int causal, int window,
                               int dtype, float scale, void* stream) {
  const repro::FwdArgs a{q,  k,    v,   o,        static_cast<float*>(lse),
                         B,  H,    KH,  Sq,       Sk,
                         hd, hd_v, ldv, q_offset, causal,
                         window, scale, nullptr};
  return repro::dispatch(a, dtype, static_cast<cudaStream_t>(stream));
}

// *blocks = the blocks of K1 that one SM holds at once for these head
// widths and dtype, as the CUDA runtime's occupancy calculator gives it
// for the compiled kernel.
extern "C" int repro_flash_fwd_occupancy(int hd, int hd_v, int dtype,
                                         int* blocks) {
  const repro::FwdArgs a{nullptr, nullptr, nullptr, nullptr, nullptr,
                         1, 1, 1, 1, 1, hd, hd_v, hd_v, 0, 0, 0, 1.f, blocks};
  return repro::dispatch(a, dtype, nullptr);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
