// K1: flash-attention forward, causal / sliding-window GQA, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// _fwd_kernel (launched by _fwd_call, pallas_call at :437).  That kernel
// walks kv tiles on the innermost sequential grid axis and carries the
// online softmax (m, l, acc) in VMEM scratch from one grid step to the
// next.  CUDA blocks run in no order, so here one block owns a BQ-row q
// tile of one (batch, head) and walks the kv tiles in a loop, with the
// carry in registers.  Query head h reads kv head h / G.  The loop bounds
// skip every kv tile that the causal mask or the window masks whole (the
// TPU kernel's pl.when skips); the ragged Sk edge is masked by index, the
// host pads nothing.
//
// Head widths: the kernel is compiled for HD = 64 and 128 and runs any
// hd that is a multiple of 8 up to 128 at the next compiled width (hd 32
// at 64; hd 120, h2o-danube3-4b's, at 128).  The tiles load hd columns
// and zero-fill the rest in shared memory, so the padded columns add
// zeros to every score and yield zeros that the store skips; the tensors
// stay unpadded.  The wrapper passes hd and the scale 1/sqrt(hd).
//
// Numerics follow the reference: scale 1/sqrt(hd) folded into q, masked
// scores -1e30, exp(s - m) and the rescale exp(m_old - m_new) in fp32,
// the denominator floored at 1e-37.  Inputs are fp32 or bf16; all
// arithmetic is fp32 (CUDA-core FMAs, no tensor cores yet).  With an lse
// pointer (the reference's with_lse, taken on the differentiated path) the
// kernel also writes lse = m + log(max(l, 1e-37)) in fp32, one store per
// row at the end as the reference's _finalize does; the backward kernels
// (flash_attention_bwd.cu) recompute P from it.
//
// Bound on the H100: at the serve shape (B=1, H=15, KH=5, hd=64,
// Sq=Sk=3008, bf16, causal) the live work is 2*Sq^2*hd*H ~ 17.4 GFLOP
// against ~15.4 MB moved, so the function is compute-bound: ~18 us at
// 989 TFLOP/s of bf16 tensor cores.  This kernel does its products on
// the fp32 CUDA cores (67 TFLOP/s peak), and each FMA of the two inner
// loops needs half a shared-memory load, so it is bound by FMA issue and
// shared-memory bandwidth, well above that bound.  mma/wgmma tiles and
// TMA loads are later work.
//
// Tiles: BQ = BK = 64, 256 threads; thread (ty, tx) of a 16x16 grid owns
// q rows 4*ty..4*ty+3, score columns tx+16j (j < 4) and output columns
// tx+16j (j < hd/16).  Shared memory holds q, k (rows padded to hd+1
// floats so the 16 column-owners of a warp hit 16 banks), v and the
// probability tile, all fp32: (64(hd+1)*2 + 64hd + 64*65)*4 B = 66,304 B
// at hd=64 and 115,456 B at hd=128, inside the 232,448 B (227 KB) a block
// may use; the SM's 228 KB then holds three resp. two blocks.  Registers:
// 16 scores + 4hd/16 accumulators + row state, under the 255 per thread
// that 256 threads per block allow.

#include "common.cuh"

namespace repro {
namespace {

constexpr int BQ = 64, BK = 64, NT = 256;

template <int HD>
constexpr size_t fwd_smem_bytes() {
  return (size_t)(BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1)) *
         sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int G,
                 int Sq, int Sk, int hd, int q_offset, int causal,
                 int window, float scale) {
  constexpr int LDQ = HD + 1, LDP = BK + 1, NJ = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                 // BQ x LDQ, pre-scaled
  float* sK = sQ + BQ * LDQ;        // BK x LDQ
  float* sV = sK + BK * LDQ;        // BK x HD
  float* sP = sV + BK * HD;         // BQ x LDP probabilities

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;                       // b * H + h
  const int bkv = (bh / H) * (H / G) + (bh % H) / G;  // b * KH + h / G
  const T* kp = k + (size_t)bkv * Sk * hd;
  const T* vp = v + (size_t)bkv * Sk * hd;

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
    load_rows<T, HD, BK, HD, NT>(sV, vp + (size_t)k0 * hd, kv_rows, 1.f, hd);
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
      for (int j = 0; j < NJ; ++j) vv[j] = sV[kk * HD + tx + 16 * j];
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
    T* op = o + ((size_t)bh * Sq + r) * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (tx + 16 * j < hd) op[tx + 16 * j] = from_float<T>(acc[i][j] / den);
  }
}

template <typename T, int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int KH, int Sq, int Sk,
                       int hd, int q_offset, int causal, int window,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<HD>();
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, H / KH, Sq, Sk,
      hd, q_offset, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16.  q (B,H,Sq,hd), k/v (B,KH,Sk,hd),
// out (B,H,Sq,hd), all contiguous, hd a multiple of 8 up to 128; lse
// (B,H,Sq) fp32, or null for the forward without it; scale 1/sqrt(hd).
// Returns the launch's cudaError_t.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int H, int KH,
                               int Sq, int Sk, int hd, int q_offset,
                               int causal, int window, int dtype,
                               float scale, void* stream) {
  using namespace repro;
  if (B <= 0 || H <= 0 || Sq <= 0) return cudaSuccess;
  if (KH <= 0 || H % KH || B * H > 65535 || hd % 8 || hd < 8 || hd > 128)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FWD(T, HD) \
  launch_fwd<T, HD>(q, k, v, o, static_cast<float*>(lse), B, H, KH, Sq, Sk, \
                    hd, q_offset, causal, window, scale, st)
  if (dtype == 0 && hd <= 64) return REPRO_FWD(float, 64);
  if (dtype == 0) return REPRO_FWD(float, 128);
  if (dtype == 1 && hd <= 64) return REPRO_FWD(__nv_bfloat16, 64);
  if (dtype == 1) return REPRO_FWD(__nv_bfloat16, 128);
#undef REPRO_FWD
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
