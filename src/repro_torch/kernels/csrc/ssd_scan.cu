// K9: the Mamba2 SSD chunked scan, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py _ssd_kernel
// (launched by ssd_scan, pallas_call at :93).  That kernel runs a grid
// (B, H, nc) whose chunk axis is sequential ("arbitrary") and carries the
// (P, N) state in VMEM scratch from one chunk step to the next.  CUDA
// blocks run in no order, so here the carry is a loop: one block owns one
// (batch, head) and walks its nc chunks in order, the fp32 state staying
// in shared memory the whole time.  Per chunk of Q positions, in fp32:
//
//   cum   = cumsum(dt * A)                      (warp scans)
//   att   = (C B^T) * exp(cum_q - cum_t) * dt_t  for t <= q, else 0
//   y     = att x + exp(cum_q) * C state^T
//   state = exp(total) * state + (x * exp(total - cum) * dt)^T B
//
// The masked entries (t > q) are *selected* to zero: exp(cum_q - cum_t)
// there is exp of a positive sum of |dt A| that overflows fp32 at full
// width, and a multiply by a 0/1 mask would give inf * 0 = NaN.
//
// Ragged S: positions past S (and the rows between Q and the padded
// chunk QP, see qpad) load as dt = 0, x = B = C = 0 -- decay 1, no input
// -- the reference's dt = 0 padding; their y rows are not stored, and the
// state is exact.  Q is the caller's chunk (min(chunk, S)), any value
// 1..128.
//
// Layout: every operand is read through its strides (the last dimension
// unit-stride), so the model's (B, S, H, P) x and y need no transpose.
//
// Bound on the H100: at B=4, S=4096, H=64, P=64, N=128, Q=128 the scan
// does 2Q^2N + 2Q^2P + 4QNP = 10.5 MFLOP per (b, h, chunk), 85.9 GFLOP in
// all, and moves ~290 MB (x in, y out, B, C, dt, state once): 0.087 ms of
// tensor-core time or of HBM time, alike.  This design does its products
// as fp32 FMAs from shared memory (4x4, 2x4 and 4x8 register tiles, the
// causal half of C B^T skipped), so it is bound by shared-memory loads
// and the fp32 rate, far above that bound; B*H blocks (64 at batch 1)
// also leave SMs idle.  Sharing C B^T across heads, splitting the
// sequence across blocks and tensor cores are later work.
//
// Shared memory (fp32; odd row strides keep the strided reads of a warp
// in 32 distinct banks): x QP x P, B and C QP x (N+1), state P x (N+1),
// an att strip of R = min(32, QP) rows x (QP+1), and cum, dt, w, the
// scan's warp sums.  At QP=128, P=64, N=128 that is 215,968 B of the
// 232,448 B (227 KB) a block may use; one block per SM.

#include "common.cuh"

namespace repro {
namespace {

constexpr int NT = 256;        // threads per block
constexpr int MAX_Q = 128, MAX_P = 64, MAX_N = 128;
constexpr int STRIP = 32;      // att rows per strip

// The chunk as the block holds it: 16 rows, or a whole number of att
// strips, so that no strip reaches past the chunk.
__host__ __device__ constexpr int qpad(int q) {
  return q <= 16 ? 16 : (q + STRIP - 1) / STRIP * STRIP;
}

__host__ __device__ inline size_t ssd_smem_floats(int qp, int p, int n) {
  const int r = qp < STRIP ? qp : STRIP;
  return (size_t)qp * p + 2 * (size_t)qp * (n + 1) + (size_t)p * (n + 1) +
         (size_t)r * (qp + 1) + 3 * (size_t)qp + 8;
}

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

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  float* state;
  int H, S, P, N, Q;
  long long xs_b, xs_h, xs_s;   // x strides (elements)
  long long ys_b, ys_h, ys_s;   // y strides
  long long ds_b, ds_h, ds_s;   // dt strides
  long long bs_b, bs_s;         // B strides
  long long cs_b, cs_s;         // C strides
};

template <typename T>
__global__ void __launch_bounds__(NT, 1) ssd_scan_kernel(SsdArgs a) {
  extern __shared__ float smem[];
  const int P = a.P, N = a.N, Q = a.Q, S = a.S;
  const int QP = qpad(Q);
  const int R = QP < STRIP ? QP : STRIP;
  const int LDN = N + 1, LDA = QP + 1;
  float* sX = smem;                       // QP x P
  float* sB = sX + QP * P;                // QP x LDN
  float* sC = sB + QP * LDN;              // QP x LDN
  float* sSt = sC + QP * LDN;             // P x LDN, the carried state
  float* sAtt = sSt + P * LDN;            // R x LDA
  float* sCum = sAtt + R * LDA;           // QP
  float* sDt = sCum + QP;                 // QP
  float* sW = sDt + QP;                   // QP
  float* sWarp = sW + QP;                 // 4 warp sums (+ total)

  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const T* xp = static_cast<const T*>(a.x) + b * a.xs_b + h * a.xs_h;
  T* yp = static_cast<T*>(a.y) + b * a.ys_b + h * a.ys_h;
  const float* dtp = a.dt + b * a.ds_b + h * a.ds_h;
  const T* bp = static_cast<const T*>(a.Bm) + b * a.bs_b;
  const T* cp = static_cast<const T*>(a.Cm) + b * a.cs_b;
  const float A_h = a.A[h];

  for (int i = tid; i < P * LDN; i += NT) sSt[i] = 0.f;

  const int nc = (S + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int base = c * Q;
    const int valid = min(Q, S - base);
    __syncthreads();   // the previous chunk's reads of sX, sB, sC are done

    // ---- load the chunk; rows >= valid are the dt = 0 padding
    for (int i = tid; i < QP * P; i += NT) {
      const int t = i / P, p = i % P;
      sX[i] = t < valid ? to_float(xp[(base + t) * a.xs_s + p]) : 0.f;
    }
    for (int i = tid; i < QP * N; i += NT) {
      const int t = i / N, n = i % N;
      const bool live = t < valid;
      sB[t * LDN + n] = live ? to_float(bp[(base + t) * a.bs_s + n]) : 0.f;
      sC[t * LDN + n] = live ? to_float(cp[(base + t) * a.cs_s + n]) : 0.f;
    }
    // ---- cum = cumsum(dt * A): four warps scan 32 positions each
    if (tid < MAX_Q) {
      const int lane = tid & 31, warp = tid >> 5;
      const float dt = tid < valid ? dtp[(base + tid) * a.ds_s] : 0.f;
      float v = dt * A_h;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      if (lane == 31) sWarp[warp] = v;
      if (tid < QP) {
        sDt[tid] = dt;
        sCum[tid] = v;
      }
    }
    __syncthreads();
    if (tid < QP) {
      float off = 0.f;
      for (int w = 0; w < (tid >> 5); ++w) off += sWarp[w];
      sCum[tid] += off;
    }
    __syncthreads();
    const float total = sCum[QP - 1];
    if (tid < QP) sW[tid] = expf(total - sCum[tid]) * sDt[tid];

    // ---- strips of R query rows: att, then y
    for (int r0 = 0; r0 < QP; r0 += R) {
      const int ncols = r0 + R;   // <= QP; t > r0 + R - 1 is masked
      {
        constexpr int TM = 4, TN = 4;
        const int mt = R / TM, nt = ncols / TN;
        for (int item = tid; item < mt * nt; item += NT) {
          const int mi = item / nt, ni = item % nt;
          float acc[TM][TN];
          zero(acc);
          mac<TM, TN, true, true>(acc, sC + r0 * LDN, LDN, sB, LDN, mi, mt,
                                  ni, nt, N);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int q = r0 + mi + i * mt;
            const float cq = sCum[q];
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              const int t = ni + j * nt;
              sAtt[(q - r0) * LDA + t] =
                  t <= q ? acc[i][j] * expf(cq - sCum[t]) * sDt[t] : 0.f;
            }
          }
        }
      }
      __syncthreads();
      {
        constexpr int TM = 2, TN = 4;
        const int mt = R / TM, nt = P / TN;
        for (int item = tid; item < mt * nt; item += NT) {
          const int mi = item / nt, ni = item % nt;
          float yd[TM][TN], yo[TM][TN];
          zero(yd);
          zero(yo);
          mac<TM, TN, true, false>(yd, sAtt, LDA, sX, P, mi, mt, ni, nt,
                                   ncols);
          mac<TM, TN, true, true>(yo, sC + r0 * LDN, LDN, sSt, LDN, mi, mt,
                                  ni, nt, N);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int q = r0 + mi + i * mt;
            if (q >= valid) continue;
            const float eq = expf(sCum[q]);
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              const int p = ni + j * nt;
              yp[(base + q) * a.ys_s + p] =
                  from_float<T>(yd[i][j] + eq * yo[i][j]);
            }
          }
        }
      }
      __syncthreads();   // sAtt is rewritten by the next strip
    }

    // ---- state = exp(total) * state + (x * w)^T B
    for (int i = tid; i < QP * P; i += NT) sX[i] *= sW[i / P];
    __syncthreads();
    {
      constexpr int TM = 4, TN = 8;
      const int mt = P / TM, nt = N / TN;
      const float decay = expf(total);
      for (int item = tid; item < mt * nt; item += NT) {
        const int mi = item / nt, ni = item % nt;
        float acc[TM][TN];
        zero(acc);
        mac<TM, TN, false, false>(acc, sX, P, sB, LDN, mi, mt, ni, nt, QP);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            float* s = &sSt[(mi + i * mt) * LDN + ni + j * nt];
            *s = decay * *s + acc[i][j];
          }
      }
    }
  }
  __syncthreads();
  float* stp = a.state + (size_t)blockIdx.x * P * N;
  for (int i = tid; i < P * N; i += NT) stp[i] = sSt[(i / N) * LDN + i % N];
}

template <typename T>
cudaError_t launch_ssd(const SsdArgs& a, int B, cudaStream_t stream) {
  const size_t smem = ssd_smem_floats(qpad(a.Q), a.P, a.N) * sizeof(float);
  auto kern = ssd_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B * a.H, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt, A and the state
// are fp32.  x, y (B, H, S, P) and dt (B, H, S) through their strides
// (b, h, s); B, C (B, S, N) through (b, s); state (B, H, P, N)
// contiguous.  P and N multiples of 8 up to 64 and 128, chunk 1..128.
// Returns the launch's cudaError_t.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y,
                              void* state, int B, int H, int S, int P, int N,
                              int chunk, long long xs_b, long long xs_h,
                              long long xs_s, long long ys_b, long long ys_h,
                              long long ys_s, long long ds_b, long long ds_h,
                              long long ds_s, long long bs_b, long long bs_s,
                              long long cs_b, long long cs_s, int dtype,
                              void* stream) {
  using namespace repro;
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (S <= 0 || chunk < 1 || chunk > MAX_Q || P < 8 || P > MAX_P ||
      P % 8 || N < 8 || N > MAX_N || N % 8)
    return cudaErrorInvalidValue;
  SsdArgs a{x,    static_cast<const float*>(dt), static_cast<const float*>(A),
            Bm,   Cm,   y,    static_cast<float*>(state),
            H,    S,    P,    N,    chunk < S ? chunk : S,
            xs_b, xs_h, xs_s, ys_b, ys_h, ys_s, ds_b, ds_h, ds_s,
            bs_b, bs_s, cs_b, cs_s};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_ssd<float>(a, B, st);
  if (dtype == 1) return launch_ssd<__nv_bfloat16>(a, B, st);
  return cudaErrorInvalidValue;
}
