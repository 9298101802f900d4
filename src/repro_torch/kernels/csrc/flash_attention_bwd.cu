// K2 and K3: flash-attention backward, causal / sliding-window GQA, for
// sm_90a.
//
// Replaces the Pallas TPU kernels of repro/kernels/flash_attention.py:
//   K2  _bwd_dq_kernel (:451, pallas_call :713) and _bwd_dkv_kernel (:494,
//       pallas_call :760), the split backward of _bwd_call (:621);
//   K3  _bwd_fused_kernel (:541, pallas_call :669), the fused backward.
// Both recompute the probabilities from the forward's logsumexp:
// s = (q . k) * scale, masked scores -1e30, P = exp(s - lse),
// dP = dO . v, dS = P * (dP - delta) * scale, delta = rowsum(dO * O)
// computed by the caller in fp32 (the reference computes it outside the
// kernel too); dV = sum P^T dO, dK = sum dS^T q, dQ = sum dS k.
//
// The TPU kernels carry dq, dk and dv in VMEM scratch across sequential
// grid axes; CUDA blocks run in no order, so the carries become loops
// inside one block:
//   dq   one block per (q tile, b*H + h); it loops over the live kv tiles
//        and keeps its dq tile in registers, so each element of dq is
//        written by one block.
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
// Head widths: q, k, dq and dk have width hd; v, dO and dv hd_v.
// Compiled for the pairs (HD, HD_V) = (64, 64), (128, 128) and (192, 128)
// (attn_pair in common.cuh), the kernels run any multiples of 8 at the
// first pair that holds both (hd 32 at 64, h2o-danube3-4b's 120 at 128,
// DeepSeek-V2's MLA heads (192, 128) as they are, its reduced (48, 32) at
// 64).  The fourth pair, (576, 512) (MLA's absorbed route), has kernels
// of their own in flash_attention_wide.cu, which dispatch() calls; their
// dk/dv pass sums head slices through an fp32 workspace that the entry
// points below take (ws, splits; unused at the other pairs).  S and dK
// run over HD columns, dP and dV over HD_V.  Loads
// zero-fill the columns past the true widths in shared memory, which add
// nothing to any product, and stores write the true columns.  The
// wrapper passes hd, hd_v and scale = 1/sqrt(hd).  The equal-width
// pairs' dq and fp32 kernels are built twice: SAME (hd_v == hd, every
// model's heads but MLA's) tells the compiler that v is as wide as q and
// k, which keeps K2's dq pass at its speed before hd_v existed (4-9 %
// slower with the widths apart, scripts/torch_attention_ab.py on the
// H100); the other build runs a v narrower than q and k (MLA's reduced
// (48, 32)).
//
// Bound on the H100 at the training shape (B=4, H=15, KH=5, S=4096,
// hd=64, bf16, causal; 8.39M live (query, key) pairs per head): the
// reference's arithmetic is 2 products per live pair and head dimension
// for S and dP, plus 2 each for dV, dK and dQ.  K3 recomputes S and dP
// once: 10 * hd FLOP per live pair and head = 322 GFLOP, 0.33 ms at
// 989 TFLOP/s; K2 recomputes them in both passes: 14 * hd = 451 GFLOP,
// 0.46 ms.  Bytes (q, k, v, dO, lse, delta read once, dq, dk, dv written
// once) are ~138 MB, 0.041 ms at 3.35 TB/s, so both are compute-bound.
//
// bf16 inputs: tensor cores.  K2's dk/dv and K3 at the pairs (64, 64)
// and (128, 128) are the wgmma kernels of flash_attention_hopper.cu,
// which dispatch() calls; K2's dq at those pairs and every bf16 kernel at
// (192, 128) are the mma.sync kernels below (tc_bwd_*): all five products
// of a tile bf16 mma.sync.m16n8k16 with fp32 sums, operands from
// ldmatrix; 128 threads, four warps.
//   dkv  ((192, 128)) BK = 64 kv rows a block, 16 a warp; q tiles of BQ =
//        32 rows.  Each warp keeps its 16 rows of dK and dV in fp32
//        registers across the G heads and the q tiles.  S^T = K Q^T and
//        dP^T = V dO^T come out as accumulator fragments; P^T and dS^T
//        are computed in place and re-packed as the A operands of dV +=
//        P^T dO and dK += dS^T Q without a trip through shared memory.
//        K3 also writes dS^T (bf16) to shared memory, and the four warps
//        then compute the tile's dQ = dS K and add it into dq_acc.
//   dq   BQ = 64 q rows a block, 16 a warp; kv tiles of BK = 64 rows at
//        hd 64 and 32 wider.  S = Q K^T and dP = dO V^T as fragments, dS
//        in place, then dQ += dS K from registers.
// Rounding: the mma operands are bf16.  q, k, v and dO are bf16 already;
// P and dS are not.  Rounding them once to bf16 (2^-8 relative) moves dV,
// dK and dQ by about 2^-8 / sqrt(3) of the typical entry, which puts
// entries near zero outside the one-bf16-rounding limits that K2 is held
// to against K4b (2^-7 |x| + 1e-4 max|x|).  So P and dS enter each of
// their products as a bf16 pair hi + lo (hi = bf16(x), lo = bf16(x - hi),
// about 2^-16 relative): dV, dK and dQ take two mma each, eight products
// a tile in K3 instead of five (the wgmma kernels do the same).
// Asynchronous copies: the dkv block double-buffers the q, dO, lse and
// delta tiles, the dq block the k and v tiles, with 16-byte (4-byte for
// lse and delta) cp.async, so the next tile loads while this one
// computes.  Shared-memory rows are padded by 16 B (stride HD + 8 bf16),
// so the eight rows an ldmatrix phase reads fall in distinct banks.
// Shared memory: dkv 86,528 B ((192, 128); +10,240 for K3's dS^T); dq
// 55,296 B (hd 64), 69,632 B (hd 128) and 86,016 B ((192, 128)), all
// under the 232,448 B (227 KB) a block may use.  Registers (ptxas,
// sm_90a) and blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// through repro_flash_bwd_occupancy) on an H100:
//   dq   hd 64: 168 registers, 3 blocks an SM; hd 128: 191, 2;
//        (192, 128): 233, 2
//   dkv  (192, 128): 215 (K3 230), 2; no spills
// so the SM's 65,536 registers, not shared memory, bound the residency.
// At (192, 128) a warp's dK (HD/2 fp32 a thread) and dV (HD_V/2) would
// take 160 registers before S, dP and the fragments, past the 255 a
// thread may hold, so the dkv block makes two passes over its q tiles
// (TcTiles::DK_SPLIT): dV with dK's columns [0, 64) (96 accumulator
// registers), then dK's columns [64, 192) (64), each pass recomputing S^T
// and dP^T; K3's dQ runs in the second pass.  That costs the S and dP
// products once more (HD + HD_V = 320 of the 1,280 bf16 mma columns a
// live pair takes in K3, counting hi + lo) and a second read of the q and
// dO tiles.
//
// fp32 inputs keep the CUDA-core kernels (flash_bwd_* below): the
// card's fp32 comparisons hold the backward to 1e-4 / 1e-5 of the plain
// version, and TF32 tensor cores (10-bit mantissa) would not meet them.
// Tiles: BQ = BK = 64, 256 threads as a 16 x 16 grid (ty, tx).
//   dq   thread owns q rows 4ty..4ty+3, score columns tx+16j (j < 4) and
//        dq columns tx+16j (j < HD/16).  Shared memory: q (pre-scaled),
//        dO, k, v with rows padded to HD+1 (HD_V+1) floats and the dS
//        tile (64 x 65): 83,200 B at HD 64, 148,736 B at HD 128, 181,504
//        B at (192, 128).
//   dkv  thread owns kv rows 4ty..4ty+3 and, of the transposed score
//        tile, q columns tx+16j (j < 4); dk/dv columns tx+16j.  Shared
//        memory: k, v, q (pre-scaled), dO padded to HD+1, P^T and dS^T
//        tiles (64 x 65 each), lse and delta of the q tile: 100,352 B at
//        HD 64, 165,888 B at HD 128, 198,656 B at (192, 128).

#include "common.cuh"

namespace repro {
namespace {

// ---------------------------------------------------- fp32: CUDA cores

constexpr int BQ = 64, BK = 64, NT = 256;

template <int HD, int HDV>
constexpr size_t dq_smem_bytes() {
  return (size_t)(2 * 64 * (HD + 1) + 2 * 64 * (HDV + 1) + BQ * (BK + 1)) *
         sizeof(float);
}

template <int HD, int HDV>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * 64 * (HD + 1) + 2 * 64 * (HDV + 1) +
                  2 * BK * (BQ + 1) + 2 * BQ) *
         sizeof(float);
}

// s[i][j] += A(4ty+i, d) B(tx+16j, d) over d < HD and dp[i][j] += C(4ty+i,
// d) D(tx+16j, d) over d < HDV, from shared tiles with row strides LD
// (A, B) and LDV (C, D): one loop over the shared columns, then the
// wider operand's rest (none where HD == HDV)
template <int HD, int HDV>
__device__ __forceinline__ void dual_dot(float (&s)[4][4], float (&dp)[4][4],
                                         const float* A, const float* B,
                                         const float* C, const float* D,
                                         int ty, int tx) {
  constexpr int LD = HD + 1, LDV = HDV + 1;
  constexpr int DM = HD < HDV ? HD : HDV;
#pragma unroll 4
  for (int d = 0; d < DM; ++d) {
    float a[4], o[4], b[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(ty * 4 + i) * LD + d];
      o[i] = C[(ty * 4 + i) * LDV + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = B[(tx + 16 * j) * LD + d];
      c[j] = D[(tx + 16 * j) * LDV + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(o[i], c[j], dp[i][j]);
      }
  }
#pragma unroll 4
  for (int d = DM; d < HD; ++d) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = fmaf(A[(ty * 4 + i) * LD + d], B[(tx + 16 * j) * LD + d],
                       s[i][j]);
  }
#pragma unroll 4
  for (int d = DM; d < HDV; ++d) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dp[i][j] = fmaf(C[(ty * 4 + i) * LDV + d],
                        D[(tx + 16 * j) * LDV + d], dp[i][j]);
  }
}

template <typename T, int HD, int HDV, bool SAME>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int G, int Sq, int Sk, int hd, int hd_v,
                    int q_offset, int causal, int window, float scale) {
  if (SAME) hd_v = hd;   // v as wide as q, k: one width for the compiler
  constexpr int LD = HD + 1, LDV = HDV + 1, LDS = BK + 1, NJ = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                 // BQ x LD, pre-scaled
  float* sO = sQ + BQ * LD;         // BQ x LDV, dO
  float* sK = sO + BQ * LDV;        // BK x LD
  float* sV = sK + BK * LD;         // BK x LDV
  float* sS = sV + BK * LDV;        // BQ x LDS, dS

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;                          // b * H + h
  const int bkv = (bh / H) * (H / G) + (bh % H) / G;  // b * KH + h / G
  const T* kp = k + (size_t)bkv * Sk * hd;
  const T* vp = v + (size_t)bkv * Sk * hd_v;
  const int q_rows = min(BQ, Sq - q0);

  load_rows<T, HD, BQ, LD, NT>(sQ, q + ((size_t)bh * Sq + q0) * hd, q_rows,
                               scale, hd);
  load_rows<T, HDV, BQ, LDV, NT>(sO, dout + ((size_t)bh * Sq + q0) * hd_v,
                                 q_rows, 1.f, hd_v);
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
    load_rows<T, HD, BK, LD, NT>(sK, kp + (size_t)k0 * hd, kv_rows, 1.f, hd);
    load_rows<T, HDV, BK, LDV, NT>(sV, vp + (size_t)k0 * hd_v, kv_rows, 1.f,
                                   hd_v);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    dual_dot<HD, HDV>(s, dp, sQ, sK, sO, sV, ty, tx);
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
    T* out = dq + ((size_t)bh * Sq + r) * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (tx + 16 * j < hd) out[tx + 16 * j] = from_float<T>(acc[i][j]);
  }
}

// ------------------------------------------------- K2: dk/dv; K3: fused

template <typename T, int HD, int HDV, bool FUSED, bool SAME>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ dq_acc, int H,
                     int G, int Sq, int Sk, int hd, int hd_v, int q_offset,
                     int causal, int window, float scale) {
  if (SAME) hd_v = hd;   // v as wide as q, k: one width for the compiler
  constexpr int LD = HD + 1, LDV = HDV + 1, LDT = BQ + 1, NJ = HD / 16,
                NJV = HDV / 16;
  extern __shared__ float smem[];
  float* sK = smem;                 // BK x LD
  float* sV = sK + BK * LD;         // BK x LDV
  float* sQ = sV + BK * LDV;        // BQ x LD, pre-scaled
  float* sO = sQ + BQ * LD;         // BQ x LDV, dO
  float* sP = sO + BQ * LDV;        // BK x LDT, P^T
  float* sD = sP + BK * LDT;        // BK x LDT, P^T * (dP^T - delta)
  float* sL = sD + BK * LDT;        // BQ, lse of the q tile
  float* sDl = sL + BQ;             // BQ, delta of the q tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK;
  const int bkv = blockIdx.y;                         // b * KH + kh
  const int KH = H / G;
  const int bh0 = (bkv / KH) * H + (bkv % KH) * G;    // b * H + kh * G
  const int kv_rows = min(BK, Sk - k0);
  load_rows<T, HD, BK, LD, NT>(sK, k + ((size_t)bkv * Sk + k0) * hd,
                               kv_rows, 1.f, hd);
  load_rows<T, HDV, BK, LDV, NT>(sV, v + ((size_t)bkv * Sk + k0) * hd_v,
                                 kv_rows, 1.f, hd_v);

  // q rows whose masks keep some column of this kv tile
  const int k_last = k0 + kv_rows - 1;
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(0, k0 - q_offset);
  if (window > 0) q_hi = min(Sq, k_last + window - q_offset);

  float adk[4][NJ], adv[4][NJV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) adk[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < NJV; ++j) adv[i][j] = 0.f;
  }

  for (int g = 0; g < G; ++g) {
    const int bh = bh0 + g;
    for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();   // previous tile's reads of sQ/sO/sP/sD/sL done
      const int q_rows = min(BQ, Sq - q0);
      load_rows<T, HD, BQ, LD, NT>(sQ, q + ((size_t)bh * Sq + q0) * hd,
                                   q_rows, scale, hd);
      load_rows<T, HDV, BQ, LDV, NT>(sO,
                                     dout + ((size_t)bh * Sq + q0) * hd_v,
                                     q_rows, 1.f, hd_v);
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
      dual_dot<HD, HDV>(s, dp, sK, sQ, sV, sO, ty, tx);
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
        float pv[4], dsv[4], ov[NJV], qv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sP[(ty * 4 + i) * LDT + qq];
          dsv[i] = sD[(ty * 4 + i) * LDT + qq];
        }
#pragma unroll
        for (int j = 0; j < NJV; ++j) ov[j] = sO[qq * LDV + tx + 16 * j];
#pragma unroll
        for (int j = 0; j < NJ; ++j) qv[j] = sQ[qq * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < NJV; ++j)
            adv[i][j] = fmaf(pv[i], ov[j], adv[i][j]);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
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
          float* out = dq_acc + ((size_t)bh * Sq + q0 + r) * hd;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            if (tx + 16 * j < hd) atomicAdd(out + tx + 16 * j, part[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= kv_rows) continue;
    const size_t row = (size_t)bkv * Sk + k0 + r;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (tx + 16 * j < hd)
        dk[row * hd + tx + 16 * j] = from_float<T>(adk[i][j]);
#pragma unroll
    for (int j = 0; j < NJV; ++j)
      if (tx + 16 * j < hd_v)
        dv[row * hd_v + tx + 16 * j] = from_float<T>(adv[i][j]);
  }
}

// -------------------------------------------------- bf16: tensor cores

constexpr int TC_NT = 128;   // four warps

template <int HD, int HDV>
struct TcTiles {
  static constexpr int LD = HD + 8;               // q/k smem row stride
  static constexpr int LDV = HDV + 8;             // v/dO smem row stride
  // the dkv block (the (192, 128) pair's; the others run the wgmma
  // kernels of flash_attention_hopper.cu)
  static constexpr int DKV_BK = 64;               // kv rows of a dkv block
  static constexpr int DKV_BQ = 32;               // q rows of its tiles
  static constexpr int DQ_BQ = 64;                // q rows of a dq block
  static constexpr int DQ_BK = HD == 64 ? 64 : 32;
  static constexpr int LDS = DKV_BQ + 8;          // K3's dS^T row stride
  // dK columns of the dkv block's first pass: it makes two passes over
  // its q tiles, dV with dK columns [0, 64), then dK columns [64, 192)
  // (see the header)
  static constexpr int DK_SPLIT = 64;
  static constexpr size_t dkv_bytes(bool fused) {
    return (size_t)(DKV_BK * (LD + LDV) + 2 * DKV_BQ * (LD + LDV)) * 2 +
           4 * DKV_BQ * sizeof(float) +
           (fused ? (size_t)2 * DKV_BK * LDS * 2 : 0);
  }
  static constexpr size_t dq_bytes() {
    return (size_t)(DQ_BQ * (LD + LDV) + 2 * DQ_BK * (LD + LDV)) * 2;
  }
};

// K2 dq on tensor cores: one block per (DQ_BQ-row q tile, b*H + h)
template <int HD, int HDV, bool SAME>
__global__ void __launch_bounds__(TC_NT)
tc_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int H, int G, int Sq, int Sk, int hd, int hd_v, int q_offset,
                 int causal, int window, float scale) {
  if (SAME) hd_v = hd;   // v as wide as q, k: one width for the compiler
  using C = TcTiles<HD, HDV>;
  constexpr int TQ = C::DQ_BQ, TK = C::DQ_BK, LD = C::LD, LDV = C::LDV;
  constexpr int KS = HD / 16, KSV = HDV / 16, KSM = KS > KSV ? KS : KSV;
  constexpr int NK = TK / 8, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // TQ x LD
  bf16* sO = sQ + TQ * LD;                         // TQ x LDV, dO
  bf16* sK = sO + TQ * LDV;                        // 2 stages of TK x LD
  bf16* sV = sK + 2 * TK * LD;                     // 2 stages of TK x LDV

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, w0 = warp * 16;
  const int q0 = blockIdx.x * TQ;
  const int bh = blockIdx.y;                          // b * H + h
  const int bkv = (bh / H) * (H / G) + (bh % H) / G;  // b * KH + h / G
  const bf16* kp = k + (size_t)bkv * Sk * hd;
  const bf16* vp = v + (size_t)bkv * Sk * hd_v;
  const int q_rows = min(TQ, Sq - q0);
  const int row0 = q_offset + q0;   // global position of tile row 0
  int kv_begin = 0, kv_end = Sk;
  if (causal) kv_end = min(Sk, row0 + TQ);
  if (window > 0) kv_begin = max(0, row0 - window + 1);
  const int kt0 = (kv_begin / TK) * TK;
  const int n_it = kv_end > kt0 ? (kv_end - kt0 + TK - 1) / TK : 0;

  cp_tile<HD, TQ, LD, TC_NT>(sQ, q + ((size_t)bh * Sq + q0) * hd, q_rows, hd);
  cp_tile<HDV, TQ, LDV, TC_NT>(sO, dout + ((size_t)bh * Sq + q0) * hd_v,
                               q_rows, hd_v);
  if (n_it > 0) {
    cp_tile<HD, TK, LD, TC_NT>(sK, kp + (size_t)kt0 * hd, Sk - kt0, hd);
    cp_tile<HDV, TK, LDV, TC_NT>(sV, vp + (size_t)kt0 * hd_v, Sk - kt0, hd_v);
  }
  cp_async_commit();

  // this thread's rows of the warp's 16: w0 + g and w0 + g + 8
  float rl[2], rd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w0 + g + 8 * i;
    rl[i] = r < q_rows ? lse[(size_t)bh * Sq + q0 + r] : 0.f;
    rd[i] = r < q_rows ? delta[(size_t)bh * Sq + q0 + r] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, kk0 = kt0 + it * TK;
    if (it + 1 < n_it) {   // prefetch the next kv tile into the other stage
      const int nk0 = kk0 + TK;
      cp_tile<HD, TK, LD, TC_NT>(sK + (st ^ 1) * TK * LD,
                                 kp + (size_t)nk0 * hd, Sk - nk0, hd);
      cp_tile<HDV, TK, LDV, TC_NT>(sV + (st ^ 1) * TK * LDV,
                                   vp + (size_t)nk0 * hd_v, Sk - nk0, hd_v);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = sK + st * TK * LD;
    const bf16* Vs = sV + st * TK * LDV;

    // S = Q K^T over HD columns, dP = dO V^T over HDV: one loop over the
    // k16 steps, each product for the steps its width has
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSM; ++ks) {
      uint32_t aq[4], ao[4];
      if (ks < KS) ldsm_x4(aq, a_addr(sQ, LD, w0, ks * 16, lane));
      if (ks < KSV) ldsm_x4(ao, a_addr(sO, LDV, w0, ks * 16, lane));
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t b[4];
        if (ks < KS) {
          ldsm_x4(b, b_addr(Ks, LD, np * 16, ks * 16, lane));
          mma_bf16(s[2 * np], aq, b[0], b[1]);
          mma_bf16(s[2 * np + 1], aq, b[2], b[3]);
        }
        if (ks < KSV) {
          ldsm_x4(b, b_addr(Vs, LDV, np * 16, ks * 16, lane));
          mma_bf16(dp[2 * np], ao, b[0], b[1]);
          mma_bf16(dp[2 * np + 1], ao, b[2], b[3]);
        }
      }
    }
    // P = exp(s - lse), dS = P (dP - delta), the scale applied at the end
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int row = row0 + w0 + g + 8 * i;
        const int col = kk0 + n * 8 + 2 * t + (e & 1);
        const float sv =
            is_live(row, col, Sk, causal, window) ? s[n][e] * scale : NEG_INF;
        dp[n][e] = expf(sv - rl[i]) * (dp[n][e] - rd[i]);
      }
    // dQ += dS K: dS from registers (hi + lo), K^T by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_frag(dp[2 * kk], dp[2 * kk + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, bt_addr(Ks, LD, kk * 16, np * 16, lane));
        mma_pair(acc[2 * np], acc[2 * np + 1], hi, lo, b);
      }
    }
    __syncthreads();   // this stage is read; the next prefetch may land
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w0 + g + 8 * i;
    if (r >= q_rows) continue;
    bf16* out = dq + ((size_t)bh * Sq + q0 + r) * hd;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < hd)
        *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
            acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
    }
  }
}

// One dkv block's tensors, shared-memory tiles and q-tile range, as
// tc_bwd_dkv_kernel sets them up for its passes.
struct DkvBlock {
  const bf16 *q, *dout;
  const float *lse, *delta;
  bf16 *dk, *dv;
  float* dq_acc;
  bf16 *sK, *sV, *sQ, *sO, *sSh, *sSl;
  float *sL, *sD;
  int bkv, bh0, k0, kv_rows, qt0, n_qt, n_it;
  int Sq, Sk, hd, hd_v, q_offset, causal, window;
  float scale;
};

// One pass of the dkv block over its G heads' live q tiles: dK columns
// [DK0, DK0 + DKW), with DV also dV, and with DQ (K3) the tile's dQ into
// dq_acc; the accumulators are written out at the end of the pass.
template <int HD, int HDV, bool DQ, int DK0, int DKW, bool DV>
__device__ __forceinline__ void tc_dkv_pass(const DkvBlock& b) {
  using C = TcTiles<HD, HDV>;
  constexpr int TQ = C::DKV_BQ, TK = C::DKV_BK, LD = C::LD, LDV = C::LDV,
                LDS = C::LDS;
  constexpr int KS = HD / 16, KSV = HDV / 16, KSM = KS > KSV ? KS : KSV;
  constexpr int NQ = TQ / 8, NDK = DKW / 8, NDV = DV ? HDV / 8 : 2;
  constexpr int NPM = (DV && NDV > NDK ? NDV : NDK) / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, w0 = warp * 16;
  const int Sq = b.Sq;

  // iteration it: head bh0 + it / n_qt, q tile qt0 + (it % n_qt) * TQ
  auto prefetch = [&](int it, int stage) {
    const int bh = b.bh0 + it / b.n_qt, q0 = b.qt0 + (it % b.n_qt) * TQ;
    const size_t row = (size_t)bh * Sq + q0;
    cp_tile<HD, TQ, LD, TC_NT>(b.sQ + stage * TQ * LD, b.q + row * b.hd,
                               Sq - q0, b.hd);
    cp_tile<HDV, TQ, LDV, TC_NT>(b.sO + stage * TQ * LDV,
                                 b.dout + row * b.hd_v, Sq - q0, b.hd_v);
    cp_vals<TQ, TC_NT>(b.sL + stage * TQ, b.lse + row, Sq - q0);
    cp_vals<TQ, TC_NT>(b.sD + stage * TQ, b.delta + row, Sq - q0);
  };
  if (b.n_it > 0) prefetch(0, 0);
  cp_async_commit();

  float adk[NDK][4], adv[NDV][4];
#pragma unroll
  for (int n = 0; n < NDK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < NDV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adv[n][e] = 0.f;

  for (int it = 0; it < b.n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < b.n_it) {
      prefetch(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int bh = b.bh0 + it / b.n_qt, q0 = b.qt0 + (it % b.n_qt) * TQ;
    const int q_rows = min(TQ, Sq - q0);
    const bf16* Qs = b.sQ + st * TQ * LD;
    const bf16* Os = b.sO + st * TQ * LDV;
    const float* Ls = b.sL + st * TQ;
    const float* Ds = b.sD + st * TQ;

    // transposed tiles: s[n][e] = S[q col n*8 + 2t + (e&1)][kv row w0 + g
    // + 8(e>>1)]; S^T = K Q^T over HD columns, dP^T = V dO^T over HDV
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSM; ++ks) {
      uint32_t ak[4], av[4];
      if (ks < KS) ldsm_x4(ak, a_addr(b.sK, LD, w0, ks * 16, lane));
      if (ks < KSV) ldsm_x4(av, a_addr(b.sV, LDV, w0, ks * 16, lane));
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t bb[4];
        if (ks < KS) {
          ldsm_x4(bb, b_addr(Qs, LD, np * 16, ks * 16, lane));
          mma_bf16(s[2 * np], ak, bb[0], bb[1]);
          mma_bf16(s[2 * np + 1], ak, bb[2], bb[3]);
        }
        if (ks < KSV) {
          ldsm_x4(bb, b_addr(Os, LDV, np * 16, ks * 16, lane));
          mma_bf16(dp[2 * np], av, bb[0], bb[1]);
          mma_bf16(dp[2 * np + 1], av, bb[2], bb[3]);
        }
      }
    }
    // P^T and dS^T = P^T (dP^T - delta), unscaled, in place
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = n * 8 + 2 * t + (e & 1);
        const int col = b.k0 + w0 + g + 8 * (e >> 1);
        const bool live =
            qr < q_rows && is_live(b.q_offset + q0 + qr, col, b.Sk, b.causal,
                                   b.window);
        const float p = expf((live ? s[n][e] * b.scale : NEG_INF) - Ls[qr]);
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - Ds[qr]);
      }
    // dV += P^T dO, dK += dS^T Q: A from registers (hi + lo), B by
    // ldmatrix.trans from the [q][d] tiles
#pragma unroll
    for (int kq = 0; kq < TQ / 16; ++kq) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      if (DV) split_frag(s[2 * kq], s[2 * kq + 1], ph, pl);
      split_frag(dp[2 * kq], dp[2 * kq + 1], dh, dl);
      if (DQ) {   // dS^T to shared memory for the tile's dQ
        uint32_t* rh = reinterpret_cast<uint32_t*>(b.sSh + (w0 + g) * LDS +
                                                   kq * 16 + 2 * t);
        uint32_t* rlo = reinterpret_cast<uint32_t*>(b.sSl + (w0 + g) * LDS +
                                                    kq * 16 + 2 * t);
        rh[0] = dh[0];
        rh[8 * LDS / 2] = dh[1];
        rh[4] = dh[2];
        rh[8 * LDS / 2 + 4] = dh[3];
        rlo[0] = dl[0];
        rlo[8 * LDS / 2] = dl[1];
        rlo[4] = dl[2];
        rlo[8 * LDS / 2 + 4] = dl[3];
      }
#pragma unroll
      for (int np = 0; np < NPM; ++np) {
        uint32_t bb[4];
        if (DV && np < NDV / 2) {
          ldsm_x4_t(bb, bt_addr(Os, LDV, kq * 16, np * 16, lane));
          mma_pair(adv[2 * np], adv[2 * np + 1], ph, pl, bb);
        }
        if (np < NDK / 2) {
          ldsm_x4_t(bb, bt_addr(Qs, LD, kq * 16, DK0 + np * 16, lane));
          mma_pair(adk[2 * np], adk[2 * np + 1], dh, dl, bb);
        }
      }
    }

    if (DQ) {
      // dQ tile = dS K over this block's kv rows: warp (rg, cg) takes q
      // rows rg*16.. and CW head columns from cg*CW; A = dS from the
      // [kv][q] dS^T tile by ldmatrix.trans, B = K from [kv][d]
      constexpr int RG = TQ / 16, CG = 4 / RG, CW = HD / CG;
      const int rg = warp % RG, cg = warp / RG;
      __syncthreads();   // every warp's dS^T is in shared memory
#pragma unroll
      for (int nc = 0; nc < CW / 32; ++nc) {
        const int c0 = cg * CW + nc * 32;
        float part[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
          uint32_t hi[4], lo[4], bb[4];
          ldsm_x4_t(hi, at_addr(b.sSh, LDS, kk * 16, rg * 16, lane));
          ldsm_x4_t(lo, at_addr(b.sSl, LDS, kk * 16, rg * 16, lane));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            ldsm_x4_t(bb, bt_addr(b.sK, LD, kk * 16, c0 + np * 16, lane));
            mma_pair(part[2 * np], part[2 * np + 1], hi, lo, bb);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = rg * 16 + g + 8 * i;
          if (r >= q_rows) continue;
          float* out = b.dq_acc + ((size_t)bh * Sq + q0 + r) * b.hd;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int c = c0 + n * 8 + 2 * t;
            if (c >= b.hd) continue;
            atomicAdd(out + c, part[n][2 * i] * b.scale);
            atomicAdd(out + c + 1, part[n][2 * i + 1] * b.scale);
          }
        }
      }
    }
    __syncthreads();   // this stage is read; the next prefetch may land
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w0 + g + 8 * i;
    if (r >= b.kv_rows) continue;
    const size_t row = (size_t)b.bkv * b.Sk + b.k0 + r;
#pragma unroll
    for (int n = 0; n < NDK; ++n) {
      const int c = DK0 + n * 8 + 2 * t;
      if (c < b.hd)
        *reinterpret_cast<__nv_bfloat162*>(b.dk + row * b.hd + c) =
            __floats2bfloat162_rn(adk[n][2 * i] * b.scale,
                                  adk[n][2 * i + 1] * b.scale);
    }
    if (DV) {
#pragma unroll
      for (int n = 0; n < NDV; ++n) {
        const int c = n * 8 + 2 * t;
        if (c < b.hd_v)
          *reinterpret_cast<__nv_bfloat162*>(b.dv + row * b.hd_v + c) =
              __floats2bfloat162_rn(adv[n][2 * i], adv[n][2 * i + 1]);
      }
    }
  }
}

// K2 dk/dv (FUSED = false) and K3 (FUSED = true) on tensor cores at the
// (192, 128) pair: one block per (64-row kv tile, b*KH + kh)
template <int HD, int HDV, bool FUSED>
__global__ void __launch_bounds__(TC_NT)
tc_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, float* __restrict__ dq_acc, int H,
                  int G, int Sq, int Sk, int hd, int hd_v, int q_offset,
                  int causal, int window, float scale) {
  using C = TcTiles<HD, HDV>;
  constexpr int TK = C::DKV_BK, TQ = C::DKV_BQ, LD = C::LD, LDV = C::LDV,
                LDS = C::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // TK x LD
  bf16* sV = sK + TK * LD;                         // TK x LDV
  bf16* sQ = sV + TK * LDV;                        // 2 stages of TQ x LD
  bf16* sO = sQ + 2 * TQ * LD;                     // 2 stages of TQ x LDV
  float* sL = reinterpret_cast<float*>(sO + 2 * TQ * LDV);   // 2 x TQ lse
  float* sD = sL + 2 * TQ;                                    // 2 x TQ delta
  bf16* sSh = reinterpret_cast<bf16*>(sD + 2 * TQ);  // TK x LDS dS^T hi
  bf16* sSl = sSh + TK * LDS;                        // TK x LDS dS^T lo

  const int k0 = blockIdx.x * TK;
  const int bkv = blockIdx.y;                         // b * KH + kh
  const int KH = H / G;
  const int bh0 = (bkv / KH) * H + (bkv % KH) * G;    // b * H + kh * G
  const int kv_rows = min(TK, Sk - k0);

  // q rows whose masks keep some column of this kv tile
  const int k_last = k0 + kv_rows - 1;
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(0, k0 - q_offset);
  if (window > 0) q_hi = min(Sq, k_last + window - q_offset);
  const int qt0 = (q_lo / TQ) * TQ;
  const int n_qt = q_hi > qt0 ? (q_hi - qt0 + TQ - 1) / TQ : 0;

  cp_tile<HD, TK, LD, TC_NT>(sK, k + ((size_t)bkv * Sk + k0) * hd, kv_rows,
                             hd);
  cp_tile<HDV, TK, LDV, TC_NT>(sV, v + ((size_t)bkv * Sk + k0) * hd_v,
                               kv_rows, hd_v);
  const DkvBlock blk{q,   dout, lse, delta, dk,      dv,  dq_acc,
                     sK,  sV,   sQ,  sO,    sSh,     sSl, sL,
                     sD,  bkv,  bh0, k0,    kv_rows, qt0, n_qt,
                     G * n_qt,  Sq,  Sk,    hd,      hd_v, q_offset,
                     causal,    window, scale};
  tc_dkv_pass<HD, HDV, false, 0, C::DK_SPLIT, true>(blk);
  tc_dkv_pass<HD, HDV, FUSED, C::DK_SPLIT, HD - C::DK_SPLIT, false>(blk);
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, H, KH, Sq, Sk, hd, hd_v, ldv, q_offset, causal, window;
  float scale;
  int* occupancy;   // non-null: report blocks per SM instead of launching
  float* ws;        // the (576, 512) dk/dv workspace and its head slices
  int splits;
  void* ds;             // the (576, 512) bf16 K3's dS workspace
  const int* passes;    // and its passes (host triples)
  int n_pass;
};

// Set the kernel's shared-memory limit, then either report its blocks
// per SM (a.occupancy) or launch it on `grid`.
template <typename Kern, typename... Args>
cudaError_t run(Kern kern, const BwdArgs& a, dim3 grid, int threads,
                size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (a.occupancy != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.occupancy, kern,
                                                         threads, smem);
  kern<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int HD, int HDV, bool SAME>
cudaError_t launch_f32(int which, const BwdArgs& a, void* dq, void* dk,
                       void* dv, cudaStream_t st) {
  const float *q = static_cast<const float*>(a.q),
              *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v),
              *dout = static_cast<const float*>(a.dout);
  const int G = a.H / a.KH;
  if (which == 0)
    return run(flash_bwd_dq_kernel<float, HD, HDV, SAME>, a,
               dim3((a.Sq + BQ - 1) / BQ, a.B * a.H), NT,
               dq_smem_bytes<HD, HDV>(), st, q, k, v, dout, a.lse, a.delta,
               static_cast<float*>(dq), a.H, G, a.Sq, a.Sk, a.hd, a.hd_v,
               a.q_offset, a.causal, a.window, a.scale);
  const dim3 grid((a.Sk + BK - 1) / BK, a.B * a.KH);
  auto kern = which == 1 ? flash_bwd_dkv_kernel<float, HD, HDV, false, SAME>
                         : flash_bwd_dkv_kernel<float, HD, HDV, true, SAME>;
  return run(kern, a, grid, NT, dkv_smem_bytes<HD, HDV>(), st, q, k, v,
             dout, a.lse, a.delta, static_cast<float*>(dk),
             static_cast<float*>(dv),
             which == 2 ? static_cast<float*>(dq) : nullptr, a.H, G, a.Sq,
             a.Sk, a.hd, a.hd_v, a.q_offset, a.causal, a.window, a.scale);
}

// K2 dq at any pair but (576, 512); K2 dk/dv and K3 at (192, 128)
template <int HD, int HDV, bool SAME>
cudaError_t launch_tc(int which, const BwdArgs& a, void* dq, void* dk,
                      void* dv, cudaStream_t st) {
  using C = TcTiles<HD, HDV>;
  const bf16 *q = static_cast<const bf16*>(a.q),
             *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v),
             *dout = static_cast<const bf16*>(a.dout);
  const int G = a.H / a.KH;
  if (which == 0)
    return run(tc_bwd_dq_kernel<HD, HDV, SAME>, a,
               dim3((a.Sq + C::DQ_BQ - 1) / C::DQ_BQ, a.B * a.H), TC_NT,
               C::dq_bytes(), st, q, k, v, dout, a.lse, a.delta,
               static_cast<bf16*>(dq), a.H, G, a.Sq, a.Sk, a.hd, a.hd_v,
               a.q_offset, a.causal, a.window, a.scale);
  if constexpr (HD != 192) {
    return hopper_bwd(which == 2, a.q, a.k, a.v, a.dout, a.lse, a.delta, dk,
                      dv, static_cast<float*>(dq), a.B, a.H, a.KH, a.Sq,
                      a.Sk, a.hd, a.hd_v, a.q_offset, a.causal, a.window,
                      a.scale, a.occupancy, st);
  } else {
    const dim3 grid((a.Sk + C::DKV_BK - 1) / C::DKV_BK, a.B * a.KH);
    auto kern = which == 1 ? tc_bwd_dkv_kernel<HD, HDV, false>
                           : tc_bwd_dkv_kernel<HD, HDV, true>;
    return run(kern, a, grid, TC_NT, C::dkv_bytes(which == 2), st, q, k, v,
               dout, a.lse, a.delta, static_cast<bf16*>(dk),
               static_cast<bf16*>(dv),
               which == 2 ? static_cast<float*>(dq) : nullptr, a.H, G, a.Sq,
               a.Sk, a.hd, a.hd_v, a.q_offset, a.causal, a.window, a.scale);
  }
}

template <int HD, int HDV, bool SAME>
cudaError_t launch(int which, const BwdArgs& a, void* dq, void* dk, void* dv,
                   int dtype, cudaStream_t st) {
  if (dtype == 0) return launch_f32<HD, HDV, SAME>(which, a, dq, dk, dv, st);
  if (dtype == 1) return launch_tc<HD, HDV, SAME>(which, a, dq, dk, dv, st);
  return cudaErrorInvalidValue;
}

// 0: dq (K2), 1: dk/dv (K2), 2: fused (K3)
cudaError_t dispatch(int which, const BwdArgs& a, void* dq, void* dk,
                     void* dv, int dtype, cudaStream_t st) {
  const int pair = attn_pair(a.hd, a.hd_v);
  if (pair < 0 || which < 0 || which > 2) return cudaErrorInvalidValue;
  if (a.occupancy == nullptr) {
    if (a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Sk <= 0) return cudaSuccess;
    if (a.KH <= 0 || a.H % a.KH || a.B * a.H > 65535)
      return cudaErrorInvalidValue;
    // v's rows are hd_v apart, or (the (576, 512) pair) k's prefix
    if (a.ldv != a.hd_v && !(pair == 3 && a.v == a.k && a.ldv == a.hd))
      return cudaErrorInvalidValue;
  }
  if (pair == 3)
    return wide_bwd(which, a.q, a.k, a.v, a.dout, a.lse, a.delta, dq, dk, dv,
                    a.ws, a.splits, a.ds, a.passes, a.n_pass, a.B, a.H, a.KH,
                    a.Sq, a.Sk, a.hd, a.hd_v, a.ldv, a.q_offset, a.causal,
                    a.window, a.scale, dtype, a.occupancy, st);
  const bool same = a.hd == a.hd_v;
  if (pair == 2)
    return launch<192, 128, false>(which, a, dq, dk, dv, dtype, st);
  if (pair == 1)
    return same ? launch<128, 128, true>(which, a, dq, dk, dv, dtype, st)
                : launch<128, 128, false>(which, a, dq, dk, dv, dtype, st);
  return same ? launch<64, 64, true>(which, a, dq, dk, dv, dtype, st)
              : launch<64, 64, false>(which, a, dq, dk, dv, dtype, st);
}

BwdArgs args(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, int B, int H, int KH,
             int Sq, int Sk, int hd, int hd_v, int ldv, int q_offset,
             int causal, int window, float scale, void* ws = nullptr,
             int splits = 0, void* ds = nullptr,
             const int* passes = nullptr, int n_pass = 0) {
  return BwdArgs{q, k, v, dout, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), B, H, KH, Sq, Sk, hd,
                 hd_v, ldv, q_offset, causal, window, scale, nullptr,
                 static_cast<float*>(ws), splits, ds, passes, n_pass};
}

}  // namespace
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16.  q (B,H,Sq,hd), k (B,KH,Sk,hd), v
// (B,KH,Sk,hd_v) and dout (B,H,Sq,hd_v) in that dtype, (hd, hd_v)
// multiples of 8 that a compiled pair holds (attn_pair); lse, delta
// (B,H,Sq) fp32; all contiguous but v, whose rows are ldv elements apart:
// hd_v, or at the (576, 512) pair hd where v is k's first hd_v columns
// (v == k); scale 1/sqrt(hd).  dq (B,H,Sq,hd) in q's dtype.  Returns the
// launch's cudaError_t.
extern "C" int repro_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, int B, int H,
                                  int KH, int Sq, int Sk, int hd, int hd_v,
                                  int ldv, int q_offset, int causal,
                                  int window, int dtype, float scale,
                                  void* stream) {
  return repro::dispatch(0,
                         repro::args(q, k, v, dout, lse, delta, B, H, KH, Sq,
                                     Sk, hd, hd_v, ldv, q_offset, causal,
                                     window, scale),
                         dq, nullptr, nullptr, dtype,
                         static_cast<cudaStream_t>(stream));
}

// As above; dk (B,KH,Sk,hd) and dv (B,KH,Sk,hd_v) in k's dtype.  At the
// (576, 512) pair, ws is an fp32 workspace of splits * B*KH*Sk*(hd + hd_v)
// elements for `splits` head slices (autotune.wide_dkv_splits); the other
// pairs take null and 0.
extern "C" int repro_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, void* ws, int splits,
                                   int B, int H, int KH,
                                   int Sq, int Sk, int hd, int hd_v, int ldv,
                                   int q_offset,
                                   int causal, int window, int dtype,
                                   float scale, void* stream) {
  return repro::dispatch(1,
                         repro::args(q, k, v, dout, lse, delta, B, H, KH, Sq,
                                     Sk, hd, hd_v, ldv, q_offset, causal,
                                     window, scale, ws, splits),
                         nullptr, dk, dv, dtype,
                         static_cast<cudaStream_t>(stream));
}

// As above; dq_acc (B,H,Sq,hd) fp32, zeroed by the caller, receives dq by
// atomicAdd, except at the (576, 512) pair in bf16: there dq_acc is dq in
// q's dtype, summed in order from the bf16 dS workspace ds over n_pass
// passes, `passes` a host array of (first q row, end q row, tile pairs)
// triples from the last rows down (autotune.wide_ds_passes).
extern "C" int repro_flash_bwd_fused(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq_acc, void* dk, void* dv,
                                     void* ws, int splits, void* ds,
                                     const int* passes, int n_pass, int B,
                                     int H, int KH, int Sq, int Sk, int hd,
                                     int hd_v, int ldv, int q_offset,
                                     int causal, int window,
                                     int dtype, float scale, void* stream) {
  return repro::dispatch(2,
                         repro::args(q, k, v, dout, lse, delta, B, H, KH, Sq,
                                     Sk, hd, hd_v, ldv, q_offset, causal,
                                     window, scale, ws, splits, ds, passes,
                                     n_pass),
                         dq_acc, dk, dv, dtype,
                         static_cast<cudaStream_t>(stream));
}

// *blocks = the blocks of the dq (which 0), dk/dv (1) or fused (2) kernel
// that one SM holds at once for these head widths and dtype, as the CUDA
// runtime's occupancy calculator gives it for the compiled kernel.
extern "C" int repro_flash_bwd_occupancy(int which, int hd, int hd_v,
                                         int dtype, int* blocks) {
  repro::BwdArgs a = repro::args(nullptr, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, 1, 1, 1, 1, 1, hd, hd_v, hd_v, 0,
                                 0, 0, 1.f);
  a.occupancy = blocks;
  return repro::dispatch(which, a, nullptr, nullptr, nullptr, dtype,
                         nullptr);
}
