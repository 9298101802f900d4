// K4f and K4b: whole-sequence ("mega") causal / sliding-window GQA
// attention, forward and backward, for sm_90a.
//
// Replace the Pallas TPU kernels of repro/kernels/flash_attention.py:
//   K4f  _fwd_mega_kernel (:243, pallas_call :295 in _fwd_mega_call),
//   K4b  _bwd_mega_kernel (:312, pallas_call :350 in _bwd_mega_call),
// and their batch-tiled variants (_bt, :272).  The TPU kernels take the
// whole (B, KH) problem in one grid step: one batched product per
// matmul, a softmax over whole score rows (no online rescale) under the
// additive -1e30 mask of _mega_amask, and a backward whose contraction
// over the g*sq rows is the GQA group sum.  On Hopper the same function
// becomes one thread block per (batch, kv head) that holds the kv head's
// whole K and V in shared memory and walks the G*Sq query rows of its G
// query heads in strips of R rows (R = 8 * RPT, sized by the planner,
// repro_torch/kernels/autotune.py plan_attention, from the 232,448 B a
// block may opt into; the caller passes autotune.mega_smem_bytes, and
// each block traps if that is less than its layout below needs):
//   K4f  per strip: q (scale folded in) into shared memory, the whole
//        live score row s = q.k, row max m, p = exp(s - m),
//        l = max(sum p, 1e-37), o = p.V / l and, with an lse pointer,
//        lse = m + log l (the convention K2/K3 read).
//   K4b  per strip: P = exp(s - lse), dP = dO.V^T,
//        dS = P * (dP - delta); the strip's whole dq rows
//        dq = scale * dS.K are written once; then dV += P^T.dO and
//        dK += dS^T.(q*scale) into fp32 dK/dV held in shared memory for
//        the whole kv head.  dk and dv are written once at the end in
//        the input dtype.  Every element of dK/dV is summed over the
//        strips in strip order and over a strip's rows in row order by
//        one thread at a time: no atomics, the same bits on every run
//        (K3 sums dq with atomics; K4b needs none, because one block owns
//        every query row of its kv head).
// Strip rows are global positions q_offset + i.  The causal mask and the
// window become the strip's live column range [c_lo, c_hi): columns
// wholly past the strip's last row or before its window are neither
// computed nor masked; inside the range each entry is masked by index and
// a masked entry's probability is selected to zero (never a mask
// multiplied into an exp that may overflow).  Ragged Sq and Sk need no
// padding.  Inputs are bf16 or fp32; K and V stay in the input dtype in
// shared memory; all arithmetic is fp32 FMAs from shared memory (no
// tensor cores yet, as in K1-K3).
//
// Bound on the H100 at the short-sequence training shape (B=64, H=15,
// KH=5, S=256, hd=64, bf16, causal; 32,896 live pairs per head): K4f's
// 4*hd FLOP per live pair and head are 8.08 GFLOP (8 us of bf16 tensor
// cores) against 83.9 MB of q, k, v and o (25 us at 3.35 TB/s), so the
// function is bound by bytes; K4b's 10*hd are 20.2 GFLOP (20 us) against
// ~138 MB (41 us), bytes again.  These kernels issue their products as
// fp32 FMAs with shared-memory operands and are bound by that issue rate,
// far above either bound; tensor-core tiles come with the redesign.
//
// Threads: 256 a block, 8 warps.  In the row phases warp w owns strip
// rows w*RPT .. w*RPT + RPT - 1 and lane l the score columns
// c_lo + l + 32j of a 128-column pass (4 columns a lane), or the head
// columns l + 32j; a warp reads and writes only its own rows of the
// score strip, so those phases meet at __syncwarp.  In K4b's dK/dV phase
// warp w owns 4 kv columns per pass and lane l the head columns l + 32j.
// K and V rows are padded by one 32-bit word (hd+2 bf16, hd+1 fp32
// values) so the 32 lanes reading one column each hit 32 banks.

#include "common.cuh"

namespace repro {
namespace {

constexpr int NT = 256, NW = NT / 32;
constexpr int JN = 4;    // score columns a lane takes in one pass
constexpr int CPT = 4;   // kv columns a warp takes in one dK/dV pass

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// K/V row stride in elements: one 32-bit word of padding
__host__ __device__ constexpr int kv_ld(int hd, int itemsize) {
  return hd + (itemsize == 2 ? 2 : 1);
}

constexpr size_t SMEM_OPTIN = 232448;   // H100 per-block opt-in maximum

// Trap unless the launch gave the block `need` bytes of dynamic shared
// memory: the size is the caller's sum, the layout is the kernel's.
__device__ __forceinline__ void require_smem(size_t need) {
  unsigned have;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(have));
  if (need > have) __trap();
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return make_float2(p[0], p[1]);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Copy `rows` rows of HD elements into shared memory unconverted, with
// row stride LDK.
template <typename T, int HD, int LDK>
__device__ __forceinline__ void load_kv(T* dst, const T* src, int rows) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = HD / V;
  for (int idx = threadIdx.x; idx < rows * PER_ROW; idx += NT) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * V;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(src + (size_t)r * HD + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) dst[r * LDK + c + i] = e[i];
  }
}

// The reference's mask for one (query position, key column).
__device__ __forceinline__ bool is_live(int pos, int col, int causal,
                                        int window) {
  return (!causal || col <= pos) && (window <= 0 || pos - col < window);
}

struct Strip {
  int rows;    // valid rows of the strip (the last one may be ragged)
  int p_lo;    // global position of strip row 0
  int c_lo;    // live columns [c_lo, c_hi)
  int c_hi;
};

__device__ __forceinline__ Strip make_strip(int i0, int R, int Sq, int Sk,
                                            int q_offset, int causal,
                                            int window) {
  Strip st;
  st.rows = min(R, Sq - i0);
  st.p_lo = q_offset + i0;
  const int p_hi = st.p_lo + st.rows - 1;
  st.c_lo = window > 0 ? max(0, st.p_lo - window + 1) : 0;
  st.c_hi = causal ? min(Sk, p_hi + 1) : Sk;
  return st;
}

// Two score-like products of the warp's RPT rows against one 128-column
// pass starting at cb: s[i][j] = A[row i] . X[col], and with TWO also
// t[i][j] = B[row i] . Y[col].  A, B: fp32 rows of HD; X, Y: T rows of
// LDK.  Columns past Sk read row Sk - 1 (their results are not used).
template <typename T, int HD, int LDK, int RPT, bool TWO>
__device__ __forceinline__ void strip_products(
    const float* A, const float* Bm, const T* X, const T* Y, int row0,
    int cb, int Sk, float (&s)[RPT][JN], float (&t)[RPT][JN]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) s[i][j] = t[i][j] = 0.f;
  int col[JN];
#pragma unroll
  for (int j = 0; j < JN; ++j) col[j] = min(cb + lane + 32 * j, Sk - 1);
#pragma unroll 4
  for (int d = 0; d < HD; d += 2) {
    float2 a[RPT], b[RPT], x[JN], y[JN];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      a[i] = *reinterpret_cast<const float2*>(A + (row0 + i) * HD + d);
      if constexpr (TWO)
        b[i] = *reinterpret_cast<const float2*>(Bm + (row0 + i) * HD + d);
    }
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      x[j] = ld2(X + col[j] * LDK + d);
      if constexpr (TWO) y[j] = ld2(Y + col[j] * LDK + d);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        s[i][j] = fmaf(a[i].x, x[j].x, fmaf(a[i].y, x[j].y, s[i][j]));
        if constexpr (TWO)
          t[i][j] = fmaf(b[i].x, y[j].x, fmaf(b[i].y, y[j].y, t[i][j]));
      }
  }
}

// ------------------------------------------------------------------ K4f

template <typename T, int HD, int RPT>
__global__ void __launch_bounds__(NT)
mega_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                float* __restrict__ lse, int G, int Sq, int Sk,
                int q_offset, int causal, int window, float scale) {
  constexpr int R = RPT * NW, LDK = kv_ld(HD, sizeof(T)), ND = HD / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t kv_bytes = align16((size_t)Sk * LDK * sizeof(T));
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = reinterpret_cast<T*>(smem + kv_bytes);
  float* sQ = reinterpret_cast<float*>(smem + 2 * kv_bytes);   // R x HD
  float* sS = sQ + R * HD;                                      // R x Sk
  require_smem(2 * kv_bytes + align16((size_t)R * HD * 4) +
               (size_t)R * Sk * 4);

  const int bkv = blockIdx.x;            // b * KH + kh
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * RPT;
  load_kv<T, HD, LDK>(sK, k + (size_t)bkv * Sk * HD, Sk);
  load_kv<T, HD, LDK>(sV, v + (size_t)bkv * Sk * HD, Sk);

  for (int g = 0; g < G; ++g) {
    for (int i0 = 0; i0 < Sq; i0 += R) {
      const Strip st = make_strip(i0, R, Sq, Sk, q_offset, causal, window);
      // index of strip row 0 among the (B, H, Sq) rows: H = KH * G
      const size_t base = ((size_t)bkv * G + g) * Sq + i0;
      __syncthreads();   // K/V loaded; the previous strip's sQ reads done
      load_rows<T, HD, R, HD, NT>(sQ, q + base * HD, st.rows, scale);
      __syncthreads();

      for (int cb = st.c_lo; cb < st.c_hi; cb += 32 * JN) {
        float s[RPT][JN], unused[RPT][JN];
        strip_products<T, HD, LDK, RPT, false>(sQ, nullptr, sK, nullptr,
                                               row0, cb, Sk, s, unused);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < JN; ++j) {
            const int c = cb + lane + 32 * j;
            const int r = row0 + i;
            if (c < st.c_hi) {
              const bool live = r < st.rows &&
                                is_live(st.p_lo + r, c, causal, window);
              sS[r * Sk + c] = live ? s[i][j] : NEG_INF;
            }
          }
      }
      __syncwarp();

      // whole-row softmax of the warp's rows
      float m[RPT], l[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float* srow = sS + (row0 + i) * Sk;
        float mx = NEG_INF;
        for (int c = st.c_lo + lane; c < st.c_hi; c += 32)
          mx = fmaxf(mx, srow[c]);
#pragma unroll
        for (int off = 16; off; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float sum = 0.f;
        for (int c = st.c_lo + lane; c < st.c_hi; c += 32) {
          const float sv = srow[c];
          const float p = sv == NEG_INF ? 0.f : expf(sv - mx);
          srow[c] = p;
          sum += p;
        }
#pragma unroll
        for (int off = 16; off; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        m[i] = mx;
        l[i] = fmaxf(sum, 1e-37f);
      }
      __syncwarp();

      // o = p . V over the live columns
      float acc[RPT][ND];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int c = st.c_lo; c < st.c_hi; ++c) {
        float p[RPT], vv[ND];
#pragma unroll
        for (int i = 0; i < RPT; ++i) p[i] = sS[(row0 + i) * Sk + c];
#pragma unroll
        for (int j = 0; j < ND; ++j)
          vv[j] = to_float(sV[c * LDK + lane + 32 * j]);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = row0 + i;
        if (r >= st.rows) continue;
        if (lse != nullptr && lane == 0) lse[base + r] = m[i] + logf(l[i]);
        T* orow = o + (base + r) * HD;
#pragma unroll
        for (int j = 0; j < ND; ++j)
          orow[lane + 32 * j] = from_float<T>(acc[i][j] / l[i]);
      }
    }
  }
}

// ------------------------------------------------------------------ K4b

template <typename T, int HD, int RPT>
__global__ void __launch_bounds__(NT)
mega_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq,
                T* __restrict__ dk, T* __restrict__ dv, int G, int Sq,
                int Sk, int q_offset, int causal, int window, float scale) {
  constexpr int R = RPT * NW, LDK = kv_ld(HD, sizeof(T)), ND = HD / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t kv_bytes = align16((size_t)Sk * LDK * sizeof(T));
  const size_t acc_bytes = align16((size_t)Sk * HD * 4);
  const size_t row_bytes = align16((size_t)R * HD * 4);
  const size_t score_bytes = align16((size_t)R * Sk * 4);
  unsigned char* p = smem;
  T* sK = reinterpret_cast<T*>(p);                p += kv_bytes;
  T* sV = reinterpret_cast<T*>(p);                p += kv_bytes;
  float* sdK = reinterpret_cast<float*>(p);       p += acc_bytes;
  float* sdV = reinterpret_cast<float*>(p);       p += acc_bytes;
  float* sQ = reinterpret_cast<float*>(p);        p += row_bytes;    // scaled
  float* sO = reinterpret_cast<float*>(p);        p += row_bytes;    // dO
  float* sP = reinterpret_cast<float*>(p);        p += score_bytes;  // P
  float* sD = reinterpret_cast<float*>(p);        p += score_bytes;  // dS
  float* sL = reinterpret_cast<float*>(p);        p += align16(R * 4);
  float* sDl = reinterpret_cast<float*>(p);
  require_smem((size_t)(p - smem) + R * 4);

  const int bkv = blockIdx.x;            // b * KH + kh
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * RPT;
  load_kv<T, HD, LDK>(sK, k + (size_t)bkv * Sk * HD, Sk);
  load_kv<T, HD, LDK>(sV, v + (size_t)bkv * Sk * HD, Sk);
  for (int i = threadIdx.x; i < Sk * HD; i += NT) sdK[i] = sdV[i] = 0.f;

  for (int g = 0; g < G; ++g) {
    for (int i0 = 0; i0 < Sq; i0 += R) {
      const Strip st = make_strip(i0, R, Sq, Sk, q_offset, causal, window);
      const size_t base = ((size_t)bkv * G + g) * Sq + i0;
      __syncthreads();   // the previous strip's dK/dV pass is done
      load_rows<T, HD, R, HD, NT>(sQ, q + base * HD, st.rows, scale);
      load_rows<T, HD, R, HD, NT>(sO, dout + base * HD, st.rows, 1.f);
      for (int r = threadIdx.x; r < R; r += NT) {
        sL[r] = r < st.rows ? lse[base + r] : 0.f;
        sDl[r] = r < st.rows ? delta[base + r] : 0.f;
      }
      __syncthreads();

      // P and dS of the warp's rows over the live columns
      for (int cb = st.c_lo; cb < st.c_hi; cb += 32 * JN) {
        float s[RPT][JN], dp[RPT][JN];
        strip_products<T, HD, LDK, RPT, true>(sQ, sO, sK, sV, row0, cb, Sk,
                                              s, dp);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < JN; ++j) {
            const int c = cb + lane + 32 * j;
            const int r = row0 + i;
            if (c < st.c_hi) {
              const bool live = r < st.rows &&
                                is_live(st.p_lo + r, c, causal, window);
              const float pr = live ? expf(s[i][j] - sL[r]) : 0.f;
              sP[r * Sk + c] = pr;
              sD[r * Sk + c] = pr * (dp[i][j] - sDl[r]);
            }
          }
      }
      __syncwarp();

      // the warp's whole dq rows: scale * dS . K, written once
      {
        float acc[RPT][ND];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
#pragma unroll 4
        for (int c = st.c_lo; c < st.c_hi; ++c) {
          float w[RPT], kv[ND];
#pragma unroll
          for (int i = 0; i < RPT; ++i) w[i] = sD[(row0 + i) * Sk + c];
#pragma unroll
          for (int j = 0; j < ND; ++j)
            kv[j] = to_float(sK[c * LDK + lane + 32 * j]);
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < ND; ++j)
              acc[i][j] = fmaf(w[i], kv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = row0 + i;
          if (r >= st.rows) continue;
          T* drow = dq + (base + r) * HD;
#pragma unroll
          for (int j = 0; j < ND; ++j)
            drow[lane + 32 * j] = from_float<T>(acc[i][j] * scale);
        }
      }
      __syncthreads();   // every row's P and dS written

      // dV += P^T dO, dK += dS^T (q * scale): warp w takes CPT columns a
      // pass, lane the head columns lane + 32j; rows summed in order
      for (int cb = st.c_lo + warp * CPT; cb < st.c_hi; cb += NW * CPT) {
        float adk[CPT][ND], adv[CPT][ND];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc)
#pragma unroll
          for (int j = 0; j < ND; ++j) adk[cc][j] = adv[cc][j] = 0.f;
        const int ncol = min(CPT, st.c_hi - cb);
        for (int r = 0; r < st.rows; ++r) {
          float pv[CPT], dsv[CPT], ov[ND], qv[ND];
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc) {
            pv[cc] = cc < ncol ? sP[r * Sk + cb + cc] : 0.f;
            dsv[cc] = cc < ncol ? sD[r * Sk + cb + cc] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            ov[j] = sO[r * HD + lane + 32 * j];
            qv[j] = sQ[r * HD + lane + 32 * j];
          }
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc)
#pragma unroll
            for (int j = 0; j < ND; ++j) {
              adv[cc][j] = fmaf(pv[cc], ov[j], adv[cc][j]);
              adk[cc][j] = fmaf(dsv[cc], qv[j], adk[cc][j]);
            }
        }
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          if (cc >= ncol) break;
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            const int e = (cb + cc) * HD + lane + 32 * j;
            sdK[e] += adk[cc][j];
            sdV[e] += adv[cc][j];
          }
        }
      }
    }
  }
  __syncthreads();
  T* dkp = dk + (size_t)bkv * Sk * HD;
  T* dvp = dv + (size_t)bkv * Sk * HD;
  for (int i = threadIdx.x; i < Sk * HD; i += NT) {
    dkp[i] = from_float<T>(sdK[i]);
    dvp[i] = from_float<T>(sdV[i]);
  }
}

struct MegaArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, H, KH, Sq, Sk, q_offset, causal, window, rows, smem;
  int* occupancy;   // non-null: report blocks per SM instead of launching
};

template <typename T, int HD, int RPT>
cudaError_t launch_fwd(const MegaArgs& a, void* o, float* lse,
                       cudaStream_t stream) {
  if (a.smem <= 0 || (size_t)a.smem > SMEM_OPTIN)
    return cudaErrorInvalidValue;
  auto kern = mega_fwd_kernel<T, HD, RPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  if (a.occupancy != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.occupancy, kern,
                                                         NT, a.smem);
  kern<<<a.B * a.KH, NT, a.smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(o), lse, a.H / a.KH, a.Sq,
      a.Sk, a.q_offset, a.causal, a.window, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T, int HD, int RPT>
cudaError_t launch_bwd(const MegaArgs& a, void* dq, void* dk, void* dv,
                       cudaStream_t stream) {
  if (a.smem <= 0 || (size_t)a.smem > SMEM_OPTIN)
    return cudaErrorInvalidValue;
  auto kern = mega_bwd_kernel<T, HD, RPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  if (a.occupancy != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.occupancy, kern,
                                                         NT, a.smem);
  kern<<<a.B * a.KH, NT, a.smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      a.H / a.KH, a.Sq, a.Sk, a.q_offset, a.causal, a.window,
      1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_rows(int bwd, const MegaArgs& a, void* o, float* lse,
                          void* dq, void* dk, void* dv, cudaStream_t st) {
  switch (a.rows) {
    case 8:
      return bwd ? launch_bwd<T, HD, 1>(a, dq, dk, dv, st)
                 : launch_fwd<T, HD, 1>(a, o, lse, st);
    case 16:
      return bwd ? launch_bwd<T, HD, 2>(a, dq, dk, dv, st)
                 : launch_fwd<T, HD, 2>(a, o, lse, st);
    case 32:
      return bwd ? launch_bwd<T, HD, 4>(a, dq, dk, dv, st)
                 : launch_fwd<T, HD, 4>(a, o, lse, st);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int bwd, const MegaArgs& a, void* o, float* lse,
                     void* dq, void* dk, void* dv, int hd, int dtype,
                     cudaStream_t st) {
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0) return cudaSuccess;
  if (a.KH <= 0 || a.H % a.KH || a.Sk <= 0) return cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64)
    return dispatch_rows<float, 64>(bwd, a, o, lse, dq, dk, dv, st);
  if (dtype == 0 && hd == 128)
    return dispatch_rows<float, 128>(bwd, a, o, lse, dq, dk, dv, st);
  if (dtype == 1 && hd == 64)
    return dispatch_rows<__nv_bfloat16, 64>(bwd, a, o, lse, dq, dk, dv, st);
  if (dtype == 1 && hd == 128)
    return dispatch_rows<__nv_bfloat16, 128>(bwd, a, o, lse, dq, dk, dv, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16.  q, o (B,H,Sq,hd), k/v (B,KH,Sk,hd),
// all contiguous; lse (B,H,Sq) fp32, or null for the forward without it;
// rows the strip (8, 16 or 32) and smem the block's dynamic shared
// memory, autotune.mega_smem_bytes (at most the opt-in maximum).
// Returns the launch's cudaError_t.
extern "C" int repro_flash_mega_fwd(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int B,
                                    int H, int KH, int Sq, int Sk, int hd,
                                    int q_offset, int causal, int window,
                                    int dtype, int rows, int smem,
                                    void* stream) {
  const repro::MegaArgs a{q, k, v, nullptr, nullptr, nullptr, B, H, KH, Sq,
                          Sk, q_offset, causal, window, rows, smem, nullptr};
  return repro::dispatch(0, a, o, static_cast<float*>(lse), nullptr, nullptr,
                         nullptr, hd, dtype,
                         static_cast<cudaStream_t>(stream));
}

// As above plus dout (like q) and lse, delta (B,H,Sq) fp32; dq (like q),
// dk, dv (like k) are written once each.
extern "C" int repro_flash_mega_bwd(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, void* dk, void* dv, int B,
                                    int H, int KH, int Sq, int Sk, int hd,
                                    int q_offset, int causal, int window,
                                    int dtype, int rows, int smem,
                                    void* stream) {
  const repro::MegaArgs a{q, k, v, dout, static_cast<const float*>(lse),
                          static_cast<const float*>(delta), B, H, KH, Sq,
                          Sk, q_offset, causal, window, rows, smem, nullptr};
  return repro::dispatch(1, a, nullptr, nullptr, dq, dk, dv, hd, dtype,
                         static_cast<cudaStream_t>(stream));
}

// *blocks = the K4f (bwd = 0) or K4b blocks one SM holds at once with
// this strip and shared memory, as the CUDA runtime's occupancy
// calculator gives it for the compiled kernel.
extern "C" int repro_flash_mega_occupancy(int bwd, int hd, int dtype,
                                          int rows, int smem, int* blocks) {
  const repro::MegaArgs a{nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, 1, 1, 1, 1, 1, 0, 0, 0, rows, smem,
                          blocks};
  return repro::dispatch(bwd, a, nullptr, nullptr, nullptr, nullptr, nullptr,
                         hd, dtype, nullptr);
}
