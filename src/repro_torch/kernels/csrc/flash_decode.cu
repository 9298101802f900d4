// K5: one-token GQA flash-decode against a head-major cache, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py
// _decode_kernel (launched by flash_decode, pallas_call at :107).  That
// kernel walks cache blocks on the innermost sequential grid axis with
// the online softmax (m, l, acc) in VMEM scratch.  Here one block owns
// one (batch, kv head): it holds the G query rows of that kv head and
// loops over the cache in BS-row blocks, with (m, l) in shared memory
// and the accumulators in registers.  cur_len is read from device
// memory, so the host never waits on it; blocks at or past min(cur_len, S)
// and, with a window, blocks wholly before cur_len - window are skipped (the
// TPU kernel's pl.when stripe skip), and the ragged edge inside the last
// block is masked by index.
//
// Head widths: compiled for HD = 64 and 128, the kernel runs any hd that
// is a multiple of 8 up to 128 at the next compiled width; the loads
// zero-fill columns hd..HD in shared memory and the store writes hd
// columns, so the caches stay unpadded.  The wrapper passes hd and the
// scale 1/sqrt(hd).
//
// Numerics follow the reference: s = (q . k) * 1/sqrt(hd) in fp32,
// masked scores -1e30, denominator floored at 1e-37.
//
// Bound on the H100: decode reads the live part of both caches once.  At
// B=4, KH=5, hd=64, cur ~ 2600, bf16 that is ~13.3 MB, ~4 us at
// 3.35 TB/s; the arithmetic (4 FLOP per cache element and query head) is
// far below the compute roof, so the function is memory-bound.  This
// design runs only B*KH = 20 blocks on 132 SMs and loads each block
// before computing on it, so it reaches a fraction of the memory rate;
// splitting the sequence across blocks with a log-sum-exp combine is the
// later performance work.
//
// Tiles: BS = 128 cache rows, 128 threads.  Shared memory (fp32) holds
// q (G x hd), a k block with rows padded to hd+1 floats (the 32 rows a
// warp scores sit in 32 banks), a v block, the G x BS scores and the
// per-row (m, l, rescale): 72,288 B at hd=64 and 139,872 B at hd=128
// (sized for G <= 8), inside the 232,448 B (227 KB) a block may use.
// Each thread keeps at most 8*hd/128 <= 8 output accumulators in
// registers.

#include "common.cuh"

namespace repro {
namespace {

constexpr int NT = 128, BS = 128, MAX_G = 8;

template <int HD>
constexpr size_t decode_smem_bytes() {
  return (size_t)(MAX_G * HD + BS * (HD + 1) + BS * HD + MAX_G * BS +
                  3 * MAX_G) *
         sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ cur_len,
                    T* __restrict__ o, int G, int S, int hd, int window,
                    float scale) {
  constexpr int LDK = HD + 1, MAXP = MAX_G * HD / NT, NW = NT / 32;
  extern __shared__ float smem[];
  float* sQ = smem;                 // G x HD
  float* sK = sQ + MAX_G * HD;      // BS x LDK
  float* sV = sK + BS * LDK;        // BS x HD
  float* sS = sV + BS * HD;         // G x BS scores, then probabilities
  float* sM = sS + MAX_G * BS;      // running max per query row
  float* sL = sM + MAX_G;           // running denominator
  float* sA = sL + MAX_G;           // this block's rescale factor

  const int bkv = blockIdx.x;       // b * KH + kv head
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* kp = kc + (size_t)bkv * S * hd;
  const T* vp = vc + (size_t)bkv * S * hd;
  // the window counts back from cur_len itself, which may exceed S after
  // a decode past the cache end (as in the reference's mask); only the
  // loop stops at S
  const int cur = *cur_len;
  const int end = min(cur, S);

  load_rows<T, HD, MAX_G, HD, NT>(sQ, q + (size_t)bkv * G * hd, G, 1.f, hd);
  if (tid < G) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }
  float acc[MAXP];
#pragma unroll
  for (int p = 0; p < MAXP; ++p) acc[p] = 0.f;

  const int start = window > 0 ? max(0, cur - window) : 0;
  for (int base = (start / BS) * BS; base < end; base += BS) {
    __syncthreads();   // sQ/sM/sL written; previous block's reads done
    const int rows = min(BS, S - base);
    load_rows<T, HD, BS, LDK, NT>(sK, kp + (size_t)base * hd, rows, 1.f, hd);
    load_rows<T, HD, BS, HD, NT>(sV, vp + (size_t)base * hd, rows, 1.f, hd);
    __syncthreads();

    for (int idx = tid; idx < G * BS; idx += NT) {
      const int g = idx / BS, t = idx % BS;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot = fmaf(sQ[g * HD + d], sK[t * LDK + d], dot);
      const int pos = base + t;
      const bool live = pos < end && (window <= 0 || pos >= cur - window);
      sS[g * BS + t] = live ? dot * scale : NEG_INF;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NW) {
      float tmax = NEG_INF;
      for (int t = lane; t < BS; t += 32) tmax = fmaxf(tmax, sS[g * BS + t]);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, tmax);
      float sum = 0.f;
      for (int t = lane; t < BS; t += 32) {
        const float p = expf(sS[g * BS + t] - m_new);
        sS[g * BS + t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sA[g] = alpha;
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int p = 0; p < MAXP; ++p) {
      const int idx = tid + p * NT;
      if (idx < G * HD) {
        const int g = idx / HD, d = idx % HD;
        float a = acc[p] * sA[g];
#pragma unroll 8
        for (int t = 0; t < BS; ++t) a = fmaf(sS[g * BS + t], sV[t * HD + d], a);
        acc[p] = a;
      }
    }
  }
  __syncthreads();

  T* op = o + (size_t)bkv * G * hd;
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    const int idx = tid + p * NT;
    const int g = idx / HD, d = idx % HD;
    if (idx < G * HD && d < hd)
      op[g * hd + d] = from_float<T>(acc[p] / fmaxf(sL[g], 1e-37f));
  }
}

template <typename T, int HD>
cudaError_t launch_decode(const void* q, const void* kc, const void* vc,
                          const void* cur, void* o, int B, int KH, int G,
                          int S, int hd, int window, float scale,
                          cudaStream_t stream) {
  constexpr size_t smem = decode_smem_bytes<HD>();
  auto kern = flash_decode_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B * KH, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(cur),
      static_cast<T*>(o), G, S, hd, window, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16.  q (B,KH,G,hd), caches (B,KH,S,hd),
// cur_len one int32 on the device, out (B,KH,G,hd), all contiguous, hd a
// multiple of 8 up to 128; scale 1/sqrt(hd).  Returns the launch's
// cudaError_t.
extern "C" int repro_flash_decode(const void* q, const void* kc,
                                  const void* vc, const void* cur, void* o,
                                  int B, int KH, int G, int S, int hd,
                                  int window, int dtype, float scale,
                                  void* stream) {
  using namespace repro;
  if (B <= 0 || KH <= 0) return cudaSuccess;
  if (G < 1 || G > MAX_G || S <= 0 || hd % 8 || hd < 8 || hd > 128)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_DEC(T, HD) \
  launch_decode<T, HD>(q, kc, vc, cur, o, B, KH, G, S, hd, window, scale, st)
  if (dtype == 0 && hd <= 64) return REPRO_DEC(float, 64);
  if (dtype == 0) return REPRO_DEC(float, 128);
  if (dtype == 1 && hd <= 64) return REPRO_DEC(__nv_bfloat16, 64);
  if (dtype == 1) return REPRO_DEC(__nv_bfloat16, 128);
#undef REPRO_DEC
  return cudaErrorInvalidValue;
}
