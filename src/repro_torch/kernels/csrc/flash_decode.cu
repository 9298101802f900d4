// K5: one-token GQA flash-decode against a head-major cache, for sm_90a,
// as a split-sequence kernel (Flash-Decoding, Dao et al. 2023).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py
// _decode_kernel (launched by flash_decode, pallas_call at :107).  That
// kernel walks cache blocks on the innermost sequential grid axis with
// the online softmax (m, l, acc) in VMEM scratch.  A GPU has no ordered
// grid axis, and one block per (batch, kv head) leaves most of the 132
// SMs idle at decode's batch sizes (8 blocks for h2o-danube3-4b at B=1),
// so here the live span is split across blocks and the partial softmaxes
// are combined in a second, small kernel:
//   split    grid (B*KH, nsplit).  Each block reads cur_len from device
//            memory (the host never waits on it), computes the live span
//            [max(0, cur - window), min(cur, S)) itself (the window
//            counts back from cur_len, which may exceed S after a decode
//            past the cache end), takes its share of it, chunk =
//            ceil(span / nsplit) rounded up to the BS-row tile, and runs
//            the online softmax over its tiles for the G <= 8 query rows
//            of its kv head.  It writes (m, l, acc) per query row in fp32
//            to scratch the wrapper allocates.  A split with no live row
//            writes (-1e30, 0, 0).
//   combine  grid (B*KH, G): m = max m_i, l = sum l_i e^(m_i - m), o =
//            sum acc_i e^(m_i - m) / max(l, 1e-37), each sum in split
//            order.  An empty split's weight e^(-1e30 - m) is exactly 0,
//            so it adds nothing.
// No atomics touch the data and every sum has a fixed order, so K5 gives
// the same bits on every run.  nsplit is the host's
// (autotune.decode_splits), a function of the shapes alone.
//
// Head widths: compiled for HD = 64 and 128, the kernel runs any hd that
// is a multiple of 8 up to 128 at the next compiled width; the loads
// zero-fill columns hd..HD in shared memory and the stores write hd
// columns, so the caches stay unpadded.  The wrapper passes hd and the
// scale 1/sqrt(hd).
//
// Numerics follow the reference: s = (q . k) * 1/sqrt(hd) in fp32,
// masked scores -1e30, probabilities and sums in fp32, the denominator
// floored at 1e-37.
//
// Bound on the H100: decode reads the live part of both caches once.
// For h2o-danube3-4b (B=1, KH=8, G=4, hd 120, window 4096, bf16) that is
// 15.7 MB, 4.7 us at 3.35 TB/s; the arithmetic is 4 FLOP per cache
// element and query head, ~1 FLOP a byte at G = 4, far under the ~295
// the tensor cores need to be the limit, so the function is memory-bound
// and tensor cores would not help: q.k and p.v run as fp32 FMAs on the
// CUDA cores.  What the design does for the memory rate: enough blocks
// (two waves of 132 SMs where the span allows: 32 splits x 8 (b, kh) for
// danube, 14 x 20 for smollm-360m at B=4), and each block keeps its next
// tiles in flight: K and V tiles of BS = 64 rows stay in the input dtype
// in shared memory (a ring of STAGES = 2) and arrive by 16-byte cp.async
// while the block computes on the previous tile.  At HD 128, bf16, a
// block takes 75,872 B of shared memory, so three share an SM.
//
// Threads (128): scores  thread (t, h) = (tid % 64, tid / 64) scores
// cache row t for query rows h, h+2, h+4, h+6 (16-byte loads of its K
// row; rows padded by 16 B so the eight rows a load phase reads fall in
// distinct banks; q in fp32 shared memory, read as a broadcast);
// softmax  one warp per query row; p.v  thread owns the column pair
// tid % (HD/2) for every query row and every (256/HD)-th row of the tile
// (bf16x2 loads of V), the row groups summed in a fixed order at the end.

#include "common.cuh"

namespace repro {
namespace {

constexpr int NT = 128, BS = 64, STAGES = 2, MAX_G = 8, MAX_SPLITS = 128;

template <typename T, int HD>
struct DecodeTiles {
  static constexpr int VEC = 16 / sizeof(T);     // elements a 16-byte copy
  static constexpr int LD = HD + VEC;            // smem row stride, +16 B
  static constexpr int NPAIR = HD / 2;           // column pairs of p.v
  static constexpr int NGRP = NT / NPAIR;        // row groups of p.v
  static constexpr size_t kv_bytes = (size_t)2 * STAGES * BS * LD * sizeof(T);
  static constexpr size_t bytes =
      kv_bytes + (MAX_G * HD + MAX_G * BS + 3 * MAX_G) * sizeof(float);
  // the row groups' accumulators, summed at the end, reuse the K ring
  static_assert(NGRP * MAX_G * HD * sizeof(float) <= kv_bytes / 2,
                "reduction buffer must fit the K ring");
};

// Rows [0, BS) of a (rows, hd) tile into shared memory with row stride
// LD by 16-byte cp.async; rows at or past valid_rows and columns hd..HD
// are zero-filled (nothing is read for them).
template <typename T, int HD, int LD>
__device__ __forceinline__ void cp_rows(T* dst, const T* src, int valid_rows,
                                        int hd) {
  constexpr int VEC = 16 / sizeof(T), CH = HD / VEC;
  for (int idx = threadIdx.x; idx < BS * CH; idx += NT) {
    const int r = idx / CH, c = (idx % CH) * VEC;
    const bool ok = r < valid_rows && c < hd;
    cp_async16(dst + r * LD + c, ok ? src + (size_t)r * hd + c : src, ok);
  }
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ cur_len,
                    float* __restrict__ part_acc, float* __restrict__ part_m,
                    float* __restrict__ part_l, int G, int S, int hd,
                    int window, int nsplit, float scale) {
  using C = DecodeTiles<T, HD>;
  constexpr int LD = C::LD, VEC = C::VEC, NW = NT / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);            // STAGES x BS x LD
  T* sV = sK + STAGES * BS * LD;                     // STAGES x BS x LD
  float* sQ = reinterpret_cast<float*>(sV + STAGES * BS * LD);  // G x HD
  float* sS = sQ + MAX_G * HD;      // G x BS scores, then probabilities
  float* sM = sS + MAX_G * BS;      // running max per query row
  float* sL = sM + MAX_G;           // running denominator
  float* sA = sL + MAX_G;           // this tile's rescale factor

  const int bkv = blockIdx.x, split = blockIdx.y;   // b * KH + kv head
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* kp = kc + (size_t)bkv * S * hd;
  const T* vp = vc + (size_t)bkv * S * hd;

  // this split's rows [lo, hi) of the live span
  const int cur = *cur_len;
  const int end = min(cur, S);
  const int start = window > 0 ? max(0, cur - window) : 0;
  const int span = max(0, end - start);
  const int chunk = ((span + nsplit - 1) / nsplit + BS - 1) / BS * BS;
  const int lo = start + split * chunk;
  const int hi = min(end, lo + chunk);
  const int ntiles = hi > lo ? (hi - lo + BS - 1) / BS : 0;

#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < ntiles) {
      const int base = lo + s * BS;
      cp_rows<T, HD, LD>(sK + s * BS * LD, kp + (size_t)base * hd, hi - base,
                         hd);
      cp_rows<T, HD, LD>(sV + s * BS * LD, vp + (size_t)base * hd, hi - base,
                         hd);
    }
    cp_async_commit();   // an empty group keeps the wait counts uniform
  }
  for (int idx = tid; idx < MAX_G * HD; idx += NT) {
    const int g = idx / HD, d = idx % HD;
    sQ[idx] = g < G && d < hd ? to_float(q[((size_t)bkv * G + g) * hd + d])
                              : 0.f;
  }
  if (tid < MAX_G) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  const int row = tid % BS, half = tid / BS;          // scores
  const int pair = tid % C::NPAIR, grp = tid / C::NPAIR;   // p.v
  float acc[MAX_G][2];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % STAGES, base = lo + it * BS;
    const int rows = min(BS, hi - base);
    cp_async_wait<STAGES - 1>();
    __syncthreads();   // this tile landed; sQ, sM, sL written
    const T* Ks = sK + st * BS * LD;
    const T* Vs = sV + st * BS * LD;

    // s = (q . k) * scale for cache row `row`, query rows half + 2j
    float dot[MAX_G / 2];
#pragma unroll
    for (int j = 0; j < MAX_G / 2; ++j) dot[j] = 0.f;
    const T* kr = Ks + row * LD;
#pragma unroll 2
    for (int c = 0; c < HD; c += VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
      const T* e = reinterpret_cast<const T*>(&raw);
      float kf[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) kf[i] = to_float(e[i]);
#pragma unroll
      for (int j = 0; j < MAX_G / 2; ++j) {
        const int g = half + 2 * j;
        if (g < G) {
          const float* qr = sQ + g * HD + c;
#pragma unroll
          for (int i = 0; i < VEC; ++i) dot[j] = fmaf(qr[i], kf[i], dot[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MAX_G / 2; ++j) {
      const int g = half + 2 * j;
      if (g < G) sS[g * BS + row] = row < rows ? dot[j] * scale : NEG_INF;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int g = warp; g < G; g += NW) {
      const float s0 = sS[g * BS + lane], s1 = sS[g * BS + lane + 32];
      float tmax = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, tmax);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      sS[g * BS + lane] = p0;
      sS[g * BS + lane + 32] = p1;
      float sum = p0 + p1;
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

    // acc = acc * alpha + p . v for this thread's column pair
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        const float a = sA[g];
        acc[g][0] *= a;
        acc[g][1] *= a;
      }
    }
    for (int t = grp; t < rows; t += C::NGRP) {
      const float2 vv = load_pair(Vs + t * LD + 2 * pair);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          const float p = sS[g * BS + t];
          acc[g][0] = fmaf(p, vv.x, acc[g][0]);
          acc[g][1] = fmaf(p, vv.y, acc[g][1]);
        }
      }
    }
    __syncthreads();   // every read of this stage is done: refill it
    if (it + STAGES < ntiles) {
      const int nb = lo + (it + STAGES) * BS;
      cp_rows<T, HD, LD>(sK + st * BS * LD, kp + (size_t)nb * hd, hi - nb,
                         hd);
      cp_rows<T, HD, LD>(sV + st * BS * LD, vp + (size_t)nb * hd, hi - nb,
                         hd);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  // sum the row groups in a fixed order, then write this split's partial
  float* red = reinterpret_cast<float*>(smem_raw);   // NGRP x MAX_G x HD
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    red[(grp * MAX_G + g) * HD + 2 * pair] = acc[g][0];
    red[(grp * MAX_G + g) * HD + 2 * pair + 1] = acc[g][1];
  }
  __syncthreads();
  const size_t pb = (size_t)bkv * nsplit + split;
  for (int idx = tid; idx < G * hd; idx += NT) {
    const int g = idx / hd, d = idx % hd;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < C::NGRP; ++r) a += red[(r * MAX_G + g) * HD + d];
    part_acc[(pb * G + g) * hd + d] = a;
  }
  if (tid < G) {
    part_m[pb * G + tid] = sM[tid];
    part_l[pb * G + tid] = sL[tid];
  }
}

// The splits' partials of one (b*KH + kv head, query row) -> its output
// row: the split weights e^(m_i - m) and l once in shared memory, then
// each thread one column, its sum over splits in split order.
template <typename T>
__global__ void __launch_bounds__(NT)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l, T* __restrict__ o,
                      int G, int hd, int nsplit) {
  __shared__ float sw[MAX_SPLITS];   // e^(m_i - m) per split
  __shared__ float s_den;
  const int bkv = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const size_t pb = (size_t)bkv * nsplit;
  if (tid < 32) {
    float m = NEG_INF;
    for (int s = tid; s < nsplit; s += 32)
      m = fmaxf(m, part_m[(pb + s) * G + g]);
#pragma unroll
    for (int off = 16; off; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    for (int s = tid; s < nsplit; s += 32)
      sw[s] = expf(part_m[(pb + s) * G + g] - m);
  }
  __syncthreads();
  if (tid == 0) {
    float l = 0.f;
    for (int s = 0; s < nsplit; ++s) l += part_l[(pb + s) * G + g] * sw[s];
    s_den = fmaxf(l, 1e-37f);
  }
  __syncthreads();
  for (int d = tid; d < hd; d += NT) {
    const float* pa = part_acc + (pb * G + g) * hd + d;
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s) a += pa[(size_t)s * G * hd] * sw[s];
    o[((size_t)bkv * G + g) * hd + d] = from_float<T>(a / s_den);
  }
}

template <typename T, int HD>
cudaError_t launch_decode(const void* q, const void* kc, const void* vc,
                          const void* cur, void* o, float* part, int B,
                          int KH, int G, int S, int hd, int window,
                          int nsplit, float scale, cudaStream_t stream) {
  constexpr size_t smem = DecodeTiles<T, HD>::bytes;
  auto kern = decode_split_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const size_t rows = (size_t)B * KH * nsplit * G;
  float* part_acc = part;
  float* part_m = part + rows * hd;
  float* part_l = part_m + rows;
  kern<<<dim3(B * KH, nsplit), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(cur), part_acc,
      part_m, part_l, G, S, hd, window, nsplit, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(B * KH, G), NT, 0, stream>>>(
      part_acc, part_m, part_l, static_cast<T*>(o), G, hd, nsplit);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16.  q (B,KH,G,hd), caches (B,KH,S,hd),
// cur_len one int32 on the device, out (B,KH,G,hd), all contiguous, hd a
// multiple of 8 up to 128; part: B*KH*nsplit*G*(hd + 2) fp32 of scratch
// (acc, then m, then l); 1 <= nsplit <= 128 splits of the live span; tile:
// the rows the host planned the splits with (autotune.DECODE_TILE), which
// must be this kernel's BS, since a split's chunk is its share rounded up
// to BS; scale 1/sqrt(hd).  Launches the split and the combine kernel;
// returns the first failing launch's cudaError_t.
extern "C" int repro_flash_decode(const void* q, const void* kc,
                                  const void* vc, const void* cur, void* o,
                                  void* part, int B, int KH, int G, int S,
                                  int hd, int window, int nsplit, int tile,
                                  int dtype, float scale, void* stream) {
  using namespace repro;
  if (B <= 0 || KH <= 0) return cudaSuccess;
  if (G < 1 || G > MAX_G || S <= 0 || hd % 8 || hd < 8 || hd > 128 ||
      nsplit < 1 || nsplit > MAX_SPLITS || tile != BS)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
#define REPRO_DEC(T, HD)                                                    \
  launch_decode<T, HD>(q, kc, vc, cur, o, p, B, KH, G, S, hd, window,       \
                       nsplit, scale, st)
  if (dtype == 0 && hd <= 64) return REPRO_DEC(float, 64);
  if (dtype == 0) return REPRO_DEC(float, 128);
  if (dtype == 1 && hd <= 64) return REPRO_DEC(__nv_bfloat16, 64);
  if (dtype == 1) return REPRO_DEC(__nv_bfloat16, 128);
#undef REPRO_DEC
  return cudaErrorInvalidValue;
}
