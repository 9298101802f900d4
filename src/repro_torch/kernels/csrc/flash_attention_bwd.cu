// K2 and K3: flash-attention backward, causal / sliding-window GQA, for
// sm_90a.
//
// Replaces the Pallas TPU kernels of repro/kernels/flash_attention.py:
//   K2  _bwd_dq_kernel (:451, pallas_call :713) and _bwd_dkv_kernel (:494,
//       pallas_call :760), the split backward of _bwd_call (:621);
//   K3  _bwd_fused_kernel (:541, pallas_call :669), the fused backward.
// Both recompute the probabilities from the forward's logsumexp:
// s = (q * scale) . k, masked scores -1e30, P = exp(s - lse),
// dP = dO . v, dS = P * (dP - delta) * scale, delta = rowsum(dO * O)
// computed by the caller in fp32 (the reference computes it outside the
// kernel too).  Inputs are fp32 or bf16; all arithmetic is fp32 (CUDA-core
// FMAs from shared memory, no tensor cores yet).
//
// The TPU kernels carry dq, dk and dv in VMEM scratch across sequential
// grid axes; CUDA blocks run in no order, so the carries become loops
// inside one block:
//   dq   one block per (64-row q tile, b*H + h); it loops over the live kv
//        tiles and keeps its dq tile in registers, so each element of dq
//        is written by one block.
//   dkv  one block per (64-row kv tile, b*KH + kh); it loops over the G
//        query heads of kv head kh and their live q tiles, and keeps dk
//        and dv in fp32 registers.  The GQA group sum stays inside the
//        block: no atomics, a fixed summation order, so K2 is
//        bit-reproducible from run to run.
//   K3   the dkv block (FUSED = true), which also adds each tile's dS . k
//        into an fp32 dq buffer (B, H, Sq, hd) with atomicAdd: the Hopper
//        form of the reference's "dq in scratch, dk/dv in revisited
//        blocks", which has no ordered revisit on a GPU.  K3's dk and dv
//        come from the same code as K2's dkv block and equal them bit for
//        bit; its dq equals K2's up to the order of the fp32 sums.
// The causal and window masks become loop bounds (the reference's pl.when
// tile skips), shifted by q_offset, the global position of q row 0.
// Ragged Sq and Sk are masked by index; nothing is padded on the host.
//
// Bound on the H100 at the training shape (B=4, H=15, KH=5, S=4096,
// hd=64, bf16, causal; 8.39M live (query, key) pairs per head): the
// reference's arithmetic is 2 products per live pair and head dimension
// for S and dP, plus 2 each for dV, dK and dQ.  K3 recomputes S and dP
// once: 10 * hd FLOP per live pair and head = 322 GFLOP, 0.33 ms at
// 989 TFLOP/s; K2 recomputes them in both passes: 14 * hd = 451 GFLOP,
// 0.46 ms.  Bytes (q, k, v, dO, lse, delta read once, dq, dk, dv written
// once) are ~138 MB, 0.041 ms at 3.35 TB/s, so both are compute-bound.
// These kernels run their products on the fp32 CUDA cores (67 TFLOP/s
// peak) with shared-memory operands, far above that bound; mma/wgmma
// tiles are later work.
//
// Tiles: BQ = BK = 64, 256 threads as a 16 x 16 grid (ty, tx).
//   dq   thread owns q rows 4ty..4ty+3, score columns tx+16j (j < 4) and
//        dq columns tx+16j (j < hd/16).  Shared memory: q (pre-scaled),
//        dO, k, v with rows padded to hd+1 floats (the 16 column-owners of
//        a warp hit 16 banks) and the dS tile (64 x 65): (4*64(hd+1) +
//        64*65)*4 B = 83,200 B at hd 64, 148,736 B at hd 128.
//   dkv  thread owns kv rows 4ty..4ty+3 and, of the transposed score
//        tile, q columns tx+16j (j < 4); dk/dv columns tx+16j.  Shared
//        memory: k, v, q (pre-scaled), dO padded to hd+1, P^T and dS^T
//        tiles (64 x 65 each), lse and delta of the q tile: 100,352 B at
//        hd 64, 165,888 B at hd 128.
// All inside the 232,448 B (227 KB) a block may use.  Registers: dkv
// keeps 2 * 4 * hd/16 accumulators (64 at hd 128) plus 32 scores and
// products, under the 255 a thread may hold at 256 threads a block.

#include "common.cuh"

namespace repro {
namespace {

constexpr int BQ = 64, BK = 64, NT = 256;

// The reference's _tile_mask for one (query row, key column), both global
// positions; col < Sk masks the ragged kv edge.
__device__ __forceinline__ bool is_live(int row, int col, int Sk, int causal,
                                        int window) {
  return col < Sk && (!causal || col <= row) &&
         (window <= 0 || row - col < window);
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return (size_t)(4 * 64 * (HD + 1) + BQ * (BK + 1)) * sizeof(float);
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(4 * 64 * (HD + 1) + 2 * BK * (BQ + 1) + 2 * BQ) *
         sizeof(float);
}

// ------------------------------------------------------------------ K2: dq

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int G, int Sq, int Sk, int q_offset, int causal,
                    int window, float scale) {
  constexpr int LD = HD + 1, LDS = BK + 1, NJ = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                 // BQ x LD, pre-scaled
  float* sO = sQ + BQ * LD;         // BQ x LD, dO
  float* sK = sO + BQ * LD;         // BK x LD
  float* sV = sK + BK * LD;         // BK x LD
  float* sS = sV + BK * LD;         // BQ x LDS, dS

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;                          // b * H + h
  const int bkv = (bh / H) * (H / G) + (bh % H) / G;  // b * KH + h / G
  const T* kp = k + (size_t)bkv * Sk * HD;
  const T* vp = v + (size_t)bkv * Sk * HD;
  const int q_rows = min(BQ, Sq - q0);

  load_rows<T, HD, BQ, LD, NT>(sQ, q + ((size_t)bh * Sq + q0) * HD, q_rows,
                               scale);
  load_rows<T, HD, BQ, LD, NT>(sO, dout + ((size_t)bh * Sq + q0) * HD,
                               q_rows, 1.f);
  float rl[4], rd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    rl[i] = r < Sq ? lse[(size_t)bh * Sq + r] : 0.f;
    rd[i] = r < Sq ? delta[(size_t)bh * Sq + r] : 0.f;
  }

  const int row0 = q_offset + q0;   // global position of tile row 0
  int kv_begin = 0, kv_end = Sk;
  if (causal) kv_end = min(Sk, row0 + BQ);
  if (window > 0) kv_begin = max(0, row0 - window + 1);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = (kv_begin / BK) * BK; k0 < kv_end; k0 += BK) {
    __syncthreads();   // sQ/sO written; previous tile's sK/sV/sS reads done
    const int kv_rows = min(BK, Sk - k0);
    load_rows<T, HD, BK, LD, NT>(sK, kp + (size_t)k0 * HD, kv_rows, 1.f);
    load_rows<T, HD, BK, LD, NT>(sV, vp + (size_t)k0 * HD, kv_rows, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], o[4], b[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sQ[(ty * 4 + i) * LD + d];
        o[i] = sO[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = sK[(tx + 16 * j) * LD + d];
        c[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(o[i], c[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float sv =
            is_live(row, col, Sk, causal, window) ? s[i][j] : NEG_INF;
        const float p = expf(sv - rl[i]);
        sS[(ty * 4 + i) * LDS + tx + 16 * j] = p * (dp[i][j] - rd[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float w[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = sS[(ty * 4 + i) * LDS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = sK[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(w[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    T* out = dq + ((size_t)bh * Sq + r) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[tx + 16 * j] = from_float<T>(acc[i][j]);
  }
}

// ------------------------------------------------- K2: dk/dv; K3: fused

template <typename T, int HD, bool FUSED>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ dq_acc, int H,
                     int G, int Sq, int Sk, int q_offset, int causal,
                     int window, float scale) {
  constexpr int LD = HD + 1, LDT = BQ + 1, NJ = HD / 16;
  extern __shared__ float smem[];
  float* sK = smem;                 // BK x LD
  float* sV = sK + BK * LD;         // BK x LD
  float* sQ = sV + BK * LD;         // BQ x LD, pre-scaled
  float* sO = sQ + BQ * LD;         // BQ x LD, dO
  float* sP = sO + BQ * LD;         // BK x LDT, P^T
  float* sD = sP + BK * LDT;        // BK x LDT, P^T * (dP^T - delta)
  float* sL = sD + BK * LDT;        // BQ, lse of the q tile
  float* sDl = sL + BQ;             // BQ, delta of the q tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK;
  const int bkv = blockIdx.y;                         // b * KH + kh
  const int KH = H / G;
  const int bh0 = (bkv / KH) * H + (bkv % KH) * G;    // b * H + kh * G
  const int kv_rows = min(BK, Sk - k0);
  load_rows<T, HD, BK, LD, NT>(sK, k + ((size_t)bkv * Sk + k0) * HD,
                               kv_rows, 1.f);
  load_rows<T, HD, BK, LD, NT>(sV, v + ((size_t)bkv * Sk + k0) * HD,
                               kv_rows, 1.f);

  // q rows whose masks keep some column of this kv tile
  const int k_last = k0 + kv_rows - 1;
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(0, k0 - q_offset);
  if (window > 0) q_hi = min(Sq, k_last + window - q_offset);

  float adk[4][NJ], adv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int bh = bh0 + g;
    for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();   // previous tile's reads of sQ/sO/sP/sD/sL done
      const int q_rows = min(BQ, Sq - q0);
      load_rows<T, HD, BQ, LD, NT>(sQ, q + ((size_t)bh * Sq + q0) * HD,
                                   q_rows, scale);
      load_rows<T, HD, BQ, LD, NT>(sO, dout + ((size_t)bh * Sq + q0) * HD,
                                   q_rows, 1.f);
      for (int r = tid; r < BQ; r += NT) {
        sL[r] = r < q_rows ? lse[(size_t)bh * Sq + q0 + r] : 0.f;
        sDl[r] = r < q_rows ? delta[(size_t)bh * Sq + q0 + r] : 0.f;
      }
      __syncthreads();

      // transposed tiles: s[i][j] = S[q col tx+16j][kv row 4ty+i]
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float a[4], c[4], b[4], o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = sK[(ty * 4 + i) * LD + d];
          c[i] = sV[(ty * 4 + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j] = sQ[(tx + 16 * j) * LD + d];
          o[j] = sO[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(b[j], a[i], s[i][j]);
            dp[i][j] = fmaf(o[j], c[i], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tx + 16 * j;
          const bool live =
              qr < q_rows &&
              is_live(q_offset + q0 + qr, col, Sk, causal, window);
          const float p = expf((live ? s[i][j] : NEG_INF) - sL[qr]);
          sP[(ty * 4 + i) * LDT + qr] = p;
          sD[(ty * 4 + i) * LDT + qr] = p * (dp[i][j] - sDl[qr]);
        }
      }
      __syncthreads();

      // dv += P^T dO, dk += dS^T q: with q pre-scaled, dS without the
      // scale gives the reference's (dS * scale) . q
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[4], dsv[4], ov[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sP[(ty * 4 + i) * LDT + qq];
          dsv[i] = sD[(ty * 4 + i) * LDT + qq];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          ov[j] = sO[qq * LD + tx + 16 * j];
          qv[j] = sQ[qq * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            adv[i][j] = fmaf(pv[i], ov[j], adv[i][j]);
            adk[i][j] = fmaf(dsv[i], qv[j], adk[i][j]);
          }
      }

      if (FUSED) {
        // dq[q0 + 4ty + i][tx + 16j] += sum over this tile's kv rows of
        // dS * k, the same dS * scale products as the dq kernel
        float part[4][NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) part[i][j] = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
          float w[4], kv[NJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = sD[kk * LDT + ty * 4 + i] * scale;
#pragma unroll
          for (int j = 0; j < NJ; ++j) kv[j] = sK[kk * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              part[i][j] = fmaf(w[i], kv[j], part[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i;
          if (r >= q_rows) continue;
          float* out = dq_acc + ((size_t)bh * Sq + q0 + r) * HD;
#pragma unroll
          for (int j = 0; j < NJ; ++j) atomicAdd(out + tx + 16 * j, part[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= kv_rows) continue;
    const size_t off = ((size_t)bkv * Sk + k0 + r) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[off + tx + 16 * j] = from_float<T>(adk[i][j]);
      dv[off + tx + 16 * j] = from_float<T>(adv[i][j]);
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, H, KH, Sq, Sk, q_offset, causal, window;
};

template <typename T, int HD>
cudaError_t launch_dq(const BwdArgs& a, void* dq, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<HD>();
  auto kern = flash_bwd_dq_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dq), a.H, a.H / a.KH, a.Sq, a.Sk, a.q_offset,
      a.causal, a.window, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T, int HD, bool FUSED>
cudaError_t launch_dkv(const BwdArgs& a, void* dk, void* dv, float* dq_acc,
                       cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<HD>();
  auto kern = flash_bwd_dkv_kernel<T, HD, FUSED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sk + BK - 1) / BK, a.B * a.KH);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dk), static_cast<T*>(dv), dq_acc, a.H,
      a.H / a.KH, a.Sq, a.Sk, a.q_offset, a.causal, a.window,
      1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

// 0: dq (K2), 1: dk/dv (K2), 2: fused (K3)
cudaError_t dispatch(int which, const BwdArgs& a, void* dq, void* dk,
                     void* dv, int hd, int dtype, cudaStream_t st) {
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Sk <= 0) return cudaSuccess;
  if (a.KH <= 0 || a.H % a.KH || a.B * a.H > 65535)
    return cudaErrorInvalidValue;
  float* acc = static_cast<float*>(dq);
#define REPRO_BWD(T, HD)                                           \
  (which == 0   ? launch_dq<T, HD>(a, dq, st)                      \
   : which == 1 ? launch_dkv<T, HD, false>(a, dk, dv, nullptr, st) \
                : launch_dkv<T, HD, true>(a, dk, dv, acc, st))
  if (dtype == 0 && hd == 64) return REPRO_BWD(float, 64);
  if (dtype == 0 && hd == 128) return REPRO_BWD(float, 128);
  if (dtype == 1 && hd == 64) return REPRO_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) return REPRO_BWD(__nv_bfloat16, 128);
#undef REPRO_BWD
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16.  q, dout (B,H,Sq,hd) and k, v
// (B,KH,Sk,hd) in that dtype; lse, delta (B,H,Sq) fp32; all contiguous.
// dq (B,H,Sq,hd) in q's dtype.  Returns the launch's cudaError_t.
extern "C" int repro_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, int B, int H,
                                  int KH, int Sq, int Sk, int hd,
                                  int q_offset, int causal, int window,
                                  int dtype, void* stream) {
  const repro::BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                         static_cast<const float*>(delta), B, H, KH, Sq, Sk,
                         q_offset, causal, window};
  return repro::dispatch(0, a, dq, nullptr, nullptr, hd, dtype,
                         static_cast<cudaStream_t>(stream));
}

// As above; dk, dv (B,KH,Sk,hd) in k's dtype.
extern "C" int repro_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int H, int KH,
                                   int Sq, int Sk, int hd, int q_offset,
                                   int causal, int window, int dtype,
                                   void* stream) {
  const repro::BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                         static_cast<const float*>(delta), B, H, KH, Sq, Sk,
                         q_offset, causal, window};
  return repro::dispatch(1, a, nullptr, dk, dv, hd, dtype,
                         static_cast<cudaStream_t>(stream));
}

// As above; dq_acc (B,H,Sq,hd) fp32, zeroed by the caller, receives dq by
// atomicAdd.
extern "C" int repro_flash_bwd_fused(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq_acc, void* dk, void* dv, int B,
                                     int H, int KH, int Sq, int Sk, int hd,
                                     int q_offset, int causal, int window,
                                     int dtype, void* stream) {
  const repro::BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                         static_cast<const float*>(delta), B, H, KH, Sq, Sk,
                         q_offset, causal, window};
  return repro::dispatch(2, a, dq_acc, dk, dv, hd, dtype,
                         static_cast<cudaStream_t>(stream));
}
