// K9: the Mamba2 SSD chunked scan, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py _ssd_kernel
// (launched by ssd_scan, pallas_call at :93).  That kernel runs a grid
// (B, H, nc) whose chunk axis is sequential ("arbitrary") and carries the
// (P, N) state in VMEM scratch from one chunk step to the next.  Per chunk
// of Q positions, in fp32:
//
//   cum   = cumsum(dt * A)
//   att   = (C B^T) * exp(cum_q - cum_t) * dt_t  for t <= q, else 0
//   y     = att x + exp(cum_q) * C state^T
//   state = exp(total) * state + (x * exp(total - cum) * dt)^T B
//
// The masked entries (t > q) are *selected* to zero: exp(cum_q - cum_t)
// there is exp of a positive sum of |dt A| that overflows fp32 at full
// width, and a multiply by a 0/1 mask would give inf * 0 = NaN.
//
// Two routes, chosen by the wrapper from dtype and shape alone
// (kernels/ssd_scan.py route()):
//
// "tc" (bf16, P and N multiples of 16 up to 64 and 128): chunk-parallel
// on the tensor cores, two launches.  Only the (P, N) carry is
// sequential; each chunk's y and its own contribution to the state are
// independent of the other chunks (Dao & Gu, arXiv:2405.21060, sec. 6).
//   K9s ssd_states_tc_kernel, grid (B*H, P/32), two blocks an SM: a
//       block owns 32 state rows of one (b, h) and walks the chunks in
//       order, the rows in mma accumulators.  Per chunk it writes the
//       state *entering* the chunk, staged in shared memory as a bf16
//       hi + lo pair (x = hi + lo to ~2^-17), to a scratch (B, H, nc, 2,
//       P, N) by two bulk copies, then adds (x * w)^T B on mma.sync,
//       x * w split into its hi + lo pair in registers (B is bf16 and
//       exact).  One block barrier a chunk: the next chunk's x, B and
//       dt load by cp.async and its w is scanned one chunk ahead.
//   K9y ssd_scan_tc_kernel, grid (B * nc * H/G), one block an SM: a
//       block owns one chunk of one batch row for G heads.  C B^T has no
//       head axis (B and C are (B, S, N), one group for every head), so
//       the block computes it once, into registers (each warp one
//       16-row query tile, up to the diagonal; the two warps of an SM
//       sub-partition take tiles w and 7 - w, which balances the causal
//       work); per head it then forms att in registers (below the
//       diagonal tile the decay as a row factor times a column factor,
//       on the diagonal tile the select above; the hi + lo split) and
//       runs att x and C state_{c-1}^T (the scratch's pair, straight
//       into shared memory by cp.async) on mma.sync, the next head's x
//       and state loading meanwhile.  y is stored in x's dtype through
//       its strides.
//   The scratch costs B*H*nc*P*N*4 bytes: 268 MB at B=4 x 4096 (and at
//   1 x 16384) for mamba2's H 64, P 64, N 128, written once by K9s and
//   read once by K9y.
//
// "fp32" (fp32, and bf16 shapes outside the tc range): the CUDA-core
// kernel ssd_scan_kernel, one block per (batch, head) walking its chunks
// in order with the fp32 state in shared memory.
//
// Ragged S: positions past S (and the rows between Q and the padded
// chunk, see qpad / qpad16) load as dt = 0, x = B = C = 0 -- decay 1, no
// input -- the reference's dt = 0 padding; their y rows are not stored,
// and the state is exact.  Q is the caller's chunk (min(chunk, S)), any
// value 1..128.
//
// Layout: every operand is read through its strides (the last dimension
// unit-stride), so the model's (B, S, H, P) x and y need no transpose.
//
// Bound on the H100: at B=4, S=4096, H=64, P=64, N=128, Q=128 the scan's
// function needs 2Q^2N + 2Q^2P + 4QNP = 10.5 MFLOP per (b, h, chunk),
// 85.9 GFLOP in all (the causal half: 60 GFLOP), and moves ~290 MB (x in,
// y out, B, C, dt, state once): 0.087 ms of HBM time.  The tc route adds
// the scratch's round trip (2 x 268 MB) and reads x twice, so its own
// byte floor is ~0.94 GB, 0.28 ms; its mma work, with the hi + lo pairs,
// is ~90 GFLOP.
//
// fp32 route, shared memory (fp32; odd row strides keep the strided reads
// of a warp in 32 distinct banks): x QP x P, B and C QP x (N+1), state
// P x (N+1), an att strip of R = min(32, QP) rows x (QP+1), and cum, dt,
// w, the scan's warp sums.  At QP=128, P=64, N=128 that is 215,968 B of
// the 232,448 B (227 KB) a block may use; one block per SM.

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

// ------------------------------------------------------------ the tc route

constexpr int TC_NT = 256;     // 8 warps
constexpr int TC_PS = 32;      // K9s: state rows per block
constexpr int TC_RING = 2;     // K9s: chunks of x and B in shared memory
constexpr int TC_LDX = TC_PS + 8;
constexpr int TC_MAX_G = 8;    // K9y: heads per block
constexpr float LOG2E = 1.4426950408889634f;


struct TcArgs {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* Bm;
  const bf16* Cm;
  bf16* y;
  float* state;
  bf16* scr;                    // (B, H, nc, 2, P, N): entering states
  int H, S, P, N, Q, nc, G;
  long long xs_b, xs_h, xs_s;
  long long ys_b, ys_h, ys_s;
  long long ds_b, ds_h, ds_s;
  long long bs_b, bs_s;
  long long cs_b, cs_s;
  const float* init;            // K9s reversed: (B, H, P, N) or null
};

// K9s.  Block (b*H + h, p-slice): state rows p0..p0+PS-1 of (b, h).
// REV (K9b's reverse state pass, K9bs): the same walk from the last chunk
// to the first, on x = dy, B = C with w = e^cum, from a.init (the final
// state's gradient): G_c = e^total G_{c+1} + (dy e^cum)^T C, storing the
// gradient of the state *leaving* each chunk, G_{c+1}; no final state.
// Warp w: rows 16*(w/4) of the slice, column pairs (16 wide) w%4, w%4+4.
// One block barrier a chunk.  After it, for chunk c: thread 0 writes the
// staged entering state out by two bulk copies; the chunk TC_RING - 1
// ahead starts loading (its x and B, the dt of the chunk after it); the
// last warp (thread 0's issues are in warp 0) scans chunk c + 1's dt * A
// into w = exp(total - cum) * dt; every warp takes chunk c's x^T by
// ldmatrix.trans, scales it by w and splits it into the hi + lo pair in
// registers, adds (x w)^T B to its rows, and stages the state entering
// chunk c + 1 once the copies have read the stage (an mbarrier that
// thread 0 arrives on).
template <bool REV>
__global__ void __launch_bounds__(TC_NT, 2) ssd_states_tc_kernel(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t stage_free;
  const int P = a.P, N = a.N, Q = a.Q, S = a.S, nc = a.nc;
  const int QP = qpad16(Q), LDN = N + 8;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int p0 = blockIdx.y * TC_PS, PS = min(TC_PS, P - p0);
  bf16* sB = reinterpret_cast<bf16*>(smem_raw);     // TC_RING x QP x LDN
  bf16* sX = sB + TC_RING * QP * LDN;               // TC_RING x QP x TC_LDX
  bf16* sSt = sX + TC_RING * QP * TC_LDX;           // (hi, lo) x PS x N
  float* sDt = reinterpret_cast<float*>(sSt + 2 * TC_PS * N);
  float* sW = sDt + (TC_RING + 1) * QP;             // 2 x QP
  float* sTot = sW + 2 * QP;                        // 2

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int gq = lane >> 2, tq = lane & 3;
  const bool active = 16 * wm < PS;
  const bf16* xp = a.x + b * a.xs_b + h * a.xs_h + p0;
  const float* dtp = a.dt + b * a.ds_b + h * a.ds_h;
  const bf16* bp = a.Bm + b * a.bs_b;
  const float A_h = a.A[h];
  bf16* scr = a.scr + ((size_t)(b * a.H + h) * nc) * 2 * P * N;
  // the chunk walked c-th
  auto pos = [&](int c) { return REV ? nc - 1 - c : c; };

  // dt of chunk c into its slot (TC_RING + 1 slots)
  auto load_dt = [&](int c) {
    const int base = pos(c) * Q, valid = min(Q, S - base);
    float* d = sDt + (c % (TC_RING + 1)) * QP;
    for (int t = tid; t < QP; t += TC_NT) {
      const bool ok = t < valid;
      cp_async4(d + t, ok ? dtp + (base + t) * a.ds_s : dtp, ok);
    }
  };
  // one cp.async group per chunk c: its x and B, and the dt of c + 1
  auto load = [&](int c) {
    if (c < nc) {
      const int base = pos(c) * Q, valid = min(Q, S - base);
      const int buf = c % TC_RING;
      cp_rows(sX + buf * QP * TC_LDX, TC_LDX, xp + base * a.xs_s, a.xs_s,
              QP, valid, PS);
      cp_rows(sB + buf * QP * LDN, LDN, bp + base * a.bs_s, a.bs_s, QP,
              valid, N);
    }
    if (c + 1 < nc) load_dt(c + 1);
    cp_async_commit();
  };
  // (the last warp) w = exp(total - cum) * dt and the total of chunk c,
  // cum = cumsum(dt * A); lane l holds positions 4l..4l+3 (QP <= 128)
  auto scan = [&](int c) {
    const float* dts = sDt + (c % (TC_RING + 1)) * QP;
    float v[4], run = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * lane + i;
      run += t < QP ? dts[t] * A_h : 0.f;
      v[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    const float total = __shfl_sync(0xffffffffu, incl, 31);
    const float excl = incl - run;
    float* w = sW + (c & 1) * QP;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * lane + i;
      if (t < QP)
        w[t] = REV ? expf(v[i] + excl) : expf(total - (v[i] + excl)) * dts[t];
    }
    if (lane == 0) sTot[c & 1] = total;
  };

  float st[2][2][4];   // the carried state: pairs wn, wn + 4; n8 tiles
  const float* init =
      a.init ? a.init + (size_t)(b * a.H + h) * P * N : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = p0 + 16 * wm + gq + 8 * (e >> 1);
        const int col = 16 * (wn + 4 * i) + 8 * j + 2 * tq + (e & 1);
        st[i][j][e] = init && active && 16 * (wn + 4 * i) < N
                          ? init[row * N + col] : 0.f;
      }
  // the carried state as a hi + lo pair into the stage, for the copies
  auto stage = [&]() {
    if (!active) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int jp = wn + 4 * i;
      if (16 * jp >= N) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * wm + gq + 8 * r;
          const int col = 16 * jp + 8 * j + 2 * tq;
          uint32_t hi, lo;
          split_bf16(st[i][j][2 * r], st[i][j][2 * r + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(sSt + row * N + col) = hi;
          *reinterpret_cast<uint32_t*>(sSt + (PS + row) * N + col) = lo;
        }
    }
    // the generic writes before the async proxy's reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_u32(&stage_free)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_dt(0);
  for (int k = 0; k < TC_RING - 1; ++k) load(k);
  stage();   // zeros: the state entering chunk 0
  cp_async_wait<TC_RING - 2>();
  __syncthreads();
  if (warp == TC_NT / 32 - 1) scan(0);

  for (int c = 0; c < nc; ++c) {
    const int buf = c % TC_RING;
    cp_async_wait<TC_RING - 2>();
    __syncthreads();   // chunk c's x, B and dt(c + 1) have landed; w(c)
                       // and the stage are complete; chunk c - 1 is done
    if (tid == 0) {
      bf16* hp = scr + (size_t)pos(c) * 2 * P * N + (size_t)p0 * N;
      bulk_store(hp, sSt, PS * N * 2);
      bulk_store(hp + (size_t)P * N, sSt + PS * N, PS * N * 2);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    load(c + TC_RING - 1);
    if (warp == TC_NT / 32 - 1 && c + 1 < nc) scan(c + 1);

    // state = exp(total) * state + (x w)^T B; the hi and lo products in
    // separate accumulators, two chains of QP/16 instead of one of QP/8
    if (active) {
      float ch[2][2][4], cl[2][2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ch[i][j][e] = cl[i][j][e] = 0.f;
      const bf16* sb = sB + buf * QP * LDN;
      const bf16* sx = sX + buf * QP * TC_LDX;
      const float* w = sW + (c & 1) * QP;
      for (int kk = 0; kk < QP / 16; ++kk) {
        uint32_t xa[4], bb[2][4];
        ldsm_x4_t(xa, at_addr(sx, TC_LDX, 16 * kk, 16 * wm, lane));
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (16 * (wn + 4 * i) < N)
            ldsm_x4_t(bb[i], bt_addr(sb, LDN, 16 * kk, 16 * (wn + 4 * i),
                                     lane));
        // x^T's fragment: a0, a1 at k = 2tq, 2tq + 1; a2, a3 at + 8
        const float2 w0 =
            *reinterpret_cast<const float2*>(w + 16 * kk + 2 * tq);
        const float2 w1 =
            *reinterpret_cast<const float2*>(w + 16 * kk + 2 * tq + 8);
        uint32_t ah[4], al[4];
        scale_split(xa[0], w0, ah[0], al[0]);
        scale_split(xa[1], w0, ah[1], al[1]);
        scale_split(xa[2], w1, ah[2], al[2]);
        scale_split(xa[3], w1, ah[3], al[3]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (16 * (wn + 4 * i) >= N) continue;
          mma_bf16(ch[i][0], ah, bb[i][0], bb[i][1]);
          mma_bf16(ch[i][1], ah, bb[i][2], bb[i][3]);
          mma_bf16(cl[i][0], al, bb[i][0], bb[i][1]);
          mma_bf16(cl[i][1], al, bb[i][2], bb[i][3]);
        }
      }
      const float decay = expf(sTot[c & 1]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[i][j][e] = decay * st[i][j][e] + (ch[i][j][e] + cl[i][j][e]);
    }
    if (tid == 0) {
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                   :: "r"(smem_u32(&stage_free)) : "memory");
    }
    if (c + 1 < nc) {
      mbar_wait(&stage_free, c & 1);   // the copies have read the stage
      stage();
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

  // the final state, fp32
  if (active && a.state) {
    float* out = a.state + (size_t)(b * a.H + h) * P * N;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int jp = wn + 4 * i;
      if (16 * jp >= N) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = p0 + 16 * wm + gq + 8 * r;
          const int col = 16 * jp + 8 * j + 2 * tq;
          *reinterpret_cast<float2*>(out + row * N + col) =
              make_float2(st[i][j][2 * r], st[i][j][2 * r + 1]);
        }
    }
  }
}

__host__ __device__ inline size_t states_tc_smem(int qp, int n) {
  return (size_t)TC_RING * qp * (n + 8) * 2 +
         (size_t)TC_RING * qp * TC_LDX * 2 + (size_t)2 * TC_PS * n * 2 +
         (size_t)(TC_RING + 3) * qp * 4 + 8;
}

// K9y.  Block: chunk c of batch row b for heads h0..h0+G-1.  Each warp
// owns one 16-row query tile of the chunk (idle past QP).  cum is kept
// in base-2 units (times log2 e), so each decay is one exp2.
__global__ void __launch_bounds__(TC_NT, 1) ssd_scan_tc_kernel(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = a.P, N = a.N, Q = a.Q, S = a.S;
  const int QP = qpad16(Q), LDN = N + 8, LDP = P + 8;
  const int ngroups = (a.H + a.G - 1) / a.G;
  const int grp = blockIdx.x % ngroups;
  const int c = (blockIdx.x / ngroups) % a.nc;
  const int b = blockIdx.x / (ngroups * a.nc);
  const int h0 = grp * a.G, G = min(a.G, a.H - h0);
  const int base = c * Q, valid = min(Q, S - base);
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);     // QP x LDN
  bf16* sB = sC + QP * LDN;                         // QP x LDN
  bf16* sX = sB + QP * LDN;                         // 2 x QP x LDP
  bf16* sS = sX + 2 * QP * LDP;                     // 2 x (hi, lo) x P x LDN
  float* sDt = reinterpret_cast<float*>(sS + 4 * P * LDN);    // G x QP
  float* sCum = sDt + a.G * QP;                     // G x QP
  float* sE = sCum + a.G * QP;                      // G x QP

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  // query row tile: tile t has t + 1 causal column tiles, so the two
  // warps of each SM sub-partition (w, w + 4) take tiles w and 7 - w
  const int mt = warp < 4 ? warp : 11 - warp;
  const bool active = 16 * mt < QP;

  // C, B and every head's dt: one group; head 0's x and state: the next
  cp_rows(sC, LDN, a.Cm + b * a.cs_b + base * a.cs_s, a.cs_s, QP, valid, N);
  cp_rows(sB, LDN, a.Bm + b * a.bs_b + base * a.bs_s, a.bs_s, QP, valid, N);
  for (int i = tid; i < G * QP; i += TC_NT) {
    const int g = i / QP, t = i % QP;
    const bool ok = t < valid;
    const float* src =
        a.dt + b * a.ds_b + (h0 + g) * a.ds_h + (base + t) * a.ds_s;
    cp_async4(sDt + i, ok ? src : a.dt, ok);
  }
  cp_async_commit();
  auto load_head = [&](int g, int buf) {
    const int h = h0 + g;
    cp_rows(sX + buf * QP * LDP, LDP,
            a.x + b * a.xs_b + h * a.xs_h + base * a.xs_s, a.xs_s, QP, valid,
            P);
    const bf16* src =
        a.scr + ((size_t)(b * a.H + h) * a.nc + c) * 2 * P * N;
    cp_rows(sS + buf * 2 * P * LDN, LDN, src, N, 2 * P, 2 * P, N);
    cp_async_commit();
  };
  load_head(0, 0);
  cp_async_wait<1>();
  __syncthreads();

  // cum of each head: warp w scans heads w, w + 8, ...; lane l holds
  // positions 4l..4l+3
  for (int g = warp; g < G; g += 8) {
    const float A_h = a.A[h0 + g];
    float v[4], run = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * lane + i;
      run += t < QP ? sDt[g * QP + t] * A_h : 0.f;
      v[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    const float excl = incl - run;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * lane + i;
      if (t < QP) sCum[g * QP + t] = (v[i] + excl) * LOG2E;
    }
    __syncwarp();
    // e(t) = exp(cum_e - cum_t) dt_t, e = the last position of t's
    // 16-wide tile: the column factor of the decay below the diagonal
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * lane + i;
      if (t < QP)
        sE[g * QP + t] = exp2f(sCum[g * QP + (t | 15)] - sCum[g * QP + t]) *
                         sDt[g * QP + t];
    }
  }

  // C B^T for this warp's rows, up to the diagonal, once for all heads
  float cb[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[j][e] = 0.f;
  if (active) {
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, a_addr(sC, LDN, 16 * mt, 16 * kk, lane));
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        if (jp > mt) break;
        uint32_t bb[4];
        ldsm_x4(bb, b_addr(sB, LDN, 16 * jp, 16 * kk, lane));
        mma_bf16(cb[2 * jp], af, bb[0], bb[1]);
        mma_bf16(cb[2 * jp + 1], af, bb[2], bb[3]);
      }
    }
  }

  const int r0 = 16 * mt + gq, r1 = r0 + 8;
  for (int g = 0; g < G; ++g) {
    const int buf = g & 1, h = h0 + g;
    cp_async_wait<0>();
    __syncthreads();   // head g has landed; head g-1 is done everywhere
    if (g + 1 < G) load_head(g + 1, buf ^ 1);
    if (!active) continue;
    const bf16* xs = sX + buf * QP * LDP;
    const bf16* sh = sS + buf * 2 * P * LDN;
    const bf16* sl = sh + P * LDN;
    const float* cum = sCum + g * QP;
    const float* dts = sDt + g * QP;
    const float* ev = sE + g * QP;

    float y[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[j][e] = 0.f;
    // C state^T, the state as its hi + lo pair: a k-step's fragments
    // first, then the hi products of every tile, then the lo ones
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t af[4], bh[4][4], bl[4][4];
      ldsm_x4(af, a_addr(sC, LDN, 16 * mt, 16 * kk, lane));
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        if (16 * pp >= P) break;
        ldsm_x4(bh[pp], b_addr(sh, LDN, 16 * pp, 16 * kk, lane));
        ldsm_x4(bl[pp], b_addr(sl, LDN, 16 * pp, 16 * kk, lane));
      }
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        if (16 * pp >= P) break;
        mma_bf16(y[2 * pp], af, bh[pp][0], bh[pp][1]);
        mma_bf16(y[2 * pp + 1], af, bh[pp][2], bh[pp][3]);
      }
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        if (16 * pp >= P) break;
        mma_bf16(y[2 * pp], af, bl[pp][0], bl[pp][1]);
        mma_bf16(y[2 * pp + 1], af, bl[pp][2], bl[pp][3]);
      }
    }
    const float c0 = cum[r0], c1 = cum[r1];
    const float e0 = exp2f(c0), e1 = exp2f(c1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      y[j][0] *= e0;
      y[j][1] *= e0;
      y[j][2] *= e1;
      y[j][3] *= e1;
    }
    // att x, att = C B^T * exp(cum_q - cum_t) * dt_t selected to t <= q;
    // x's fragments load first, then att, its hi products, its lo ones.
    // Below the diagonal tile the decay factors through e, the tile's
    // last column: exp(cum_q - cum_e) exp(cum_e - cum_t), both <= 1, so
    // two exps a row instead of one an entry; the diagonal tile takes
    // one an entry, and the select.
#pragma unroll
    for (int jp = 0; jp < 8; ++jp) {
      if (jp > mt) break;
      uint32_t bx[4][4];
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        if (16 * pp >= P) break;
        ldsm_x4_t(bx[pp], bt_addr(xs, LDP, 16 * jp, 16 * pp, lane));
      }
      float at[2][4];
      if (jp < mt) {
        const float ce = cum[16 * jp + 15];
        const float f0 = exp2f(c0 - ce), f1 = exp2f(c1 - ce);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 e = *reinterpret_cast<const float2*>(
              ev + 16 * jp + 8 * j + 2 * tq);
          at[j][0] = cb[2 * jp + j][0] * f0 * e.x;
          at[j][1] = cb[2 * jp + j][1] * f0 * e.y;
          at[j][2] = cb[2 * jp + j][2] * f1 * e.x;
          at[j][3] = cb[2 * jp + j][3] * f1 * e.y;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int t0 = 16 * jp + 8 * j + 2 * tq;
          const float2 ct = *reinterpret_cast<const float2*>(cum + t0);
          const float2 dv = *reinterpret_cast<const float2*>(dts + t0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = t0 + (e & 1);
            const int r = e < 2 ? r0 : r1;
            const float cr = e < 2 ? c0 : c1;
            const float cmt = (e & 1) ? ct.y : ct.x;
            const float dtt = (e & 1) ? dv.y : dv.x;
            at[j][e] = t <= r ? cb[2 * jp + j][e] * exp2f(cr - cmt) * dtt
                              : 0.f;
          }
        }
      }
      uint32_t hi[4], lo[4];
      split_frag(at[0], at[1], hi, lo);
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        if (16 * pp >= P) break;
        mma_bf16(y[2 * pp], hi, bx[pp][0], bx[pp][1]);
        mma_bf16(y[2 * pp + 1], hi, bx[pp][2], bx[pp][3]);
      }
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        if (16 * pp >= P) break;
        mma_bf16(y[2 * pp], lo, bx[pp][0], bx[pp][1]);
        mma_bf16(y[2 * pp + 1], lo, bx[pp][2], bx[pp][3]);
      }
    }
    bf16* yp = a.y + b * a.ys_b + h * a.ys_h + base * a.ys_s;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (8 * j >= P) break;
      const int col = 8 * j + 2 * tq;
      if (r0 < valid)
        *reinterpret_cast<__nv_bfloat162*>(yp + r0 * a.ys_s + col) =
            __floats2bfloat162_rn(y[j][0], y[j][1]);
      if (r1 < valid)
        *reinterpret_cast<__nv_bfloat162*>(yp + r1 * a.ys_s + col) =
            __floats2bfloat162_rn(y[j][2], y[j][3]);
    }
  }
}

__host__ __device__ inline size_t scan_tc_smem(int qp, int p, int n, int g) {
  return (size_t)2 * qp * (n + 8) * 2 + (size_t)2 * qp * (p + 8) * 2 +
         (size_t)4 * p * (n + 8) * 2 + (size_t)3 * g * qp * 4;
}

cudaError_t launch_tc(const TcArgs& a, int B, int stages,
                      cudaStream_t stream) {
  const int qp = qpad16(a.Q);
  if (stages & 1) {
    const size_t smem = states_tc_smem(qp, a.N);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_states_tc_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ssd_states_tc_kernel<false>
        <<<dim3(B * a.H, (a.P + TC_PS - 1) / TC_PS), TC_NT, smem, stream>>>(
            a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (stages & 2) {
    const size_t smem = scan_tc_smem(qp, a.P, a.N, a.G);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const int ngroups = (a.H + a.G - 1) / a.G;
    ssd_scan_tc_kernel<<<B * a.nc * ngroups, TC_NT, smem, stream>>>(a);
    return cudaGetLastError();
  }
  return cudaSuccess;
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

// The tc route (bf16).  scratch: (B, H, nc, 2, P, N) bf16, nc = ceil(S /
// Q) with Q = min(chunk, S); G heads per K9y block.  stages: 1 = K9s
// (scratch and state), 2 = K9y (y from the scratch), 3 = both.  Strides
// as repro_ssd_scan's; every row of x, B and C starts on 16 bytes (the
// wrapper checks).  P and N multiples of 16 up to 64 and 128.
extern "C" int repro_ssd_scan_tc(const void* x, const void* dt, const void* A,
                                 const void* Bm, const void* Cm, void* y,
                                 void* state, void* scratch, int B, int H,
                                 int S, int P, int N, int chunk, int G,
                                 long long xs_b, long long xs_h,
                                 long long xs_s, long long ys_b,
                                 long long ys_h, long long ys_s,
                                 long long ds_b, long long ds_h,
                                 long long ds_s, long long bs_b,
                                 long long bs_s, long long cs_b,
                                 long long cs_s, int stages, void* stream) {
  using namespace repro;
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (S <= 0 || chunk < 1 || chunk > MAX_Q || P < 16 || P > MAX_P ||
      P % 16 || N < 16 || N > MAX_N || N % 16 || G < 1 || G > TC_MAX_G ||
      stages < 1 || stages > 3)
    return cudaErrorInvalidValue;
  const int Q = chunk < S ? chunk : S;
  TcArgs a{static_cast<const bf16*>(x),  static_cast<const float*>(dt),
           static_cast<const float*>(A), static_cast<const bf16*>(Bm),
           static_cast<const bf16*>(Cm), static_cast<bf16*>(y),
           static_cast<float*>(state),   static_cast<bf16*>(scratch),
           H, S, P, N, Q, (S + Q - 1) / Q, G,
           xs_b, xs_h, xs_s, ys_b, ys_h, ys_s, ds_b, ds_h, ds_s,
           bs_b, bs_s, cs_b, cs_s, nullptr};
  return launch_tc(a, B, stages, static_cast<cudaStream_t>(stream));
}

// K9b's reverse state pass on the tc route (K9s reversed): dy (B, H, S, P)
// through its strides (b, h, s), dt, A, C (B, S, N) as the forward's,
// dstate (B, H, P, N) fp32 contiguous or null; writes the gradient of the
// state leaving each chunk to scratch (B, H, nc, 2, P, N) bf16 as a hi +
// lo pair.  Rows of dy and C start on 16 bytes (the wrapper checks).
extern "C" int repro_ssd_dstates_tc(const void* dy, const void* dt,
                                    const void* A, const void* Cm,
                                    const void* dstate, void* scratch, int B,
                                    int H, int S, int P, int N, int chunk,
                                    long long ys_b, long long ys_h,
                                    long long ys_s, long long ds_b,
                                    long long ds_h, long long ds_s,
                                    long long cs_b, long long cs_s,
                                    void* stream) {
  using namespace repro;
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (S <= 0 || chunk < 1 || chunk > MAX_Q || P < 16 || P > MAX_P ||
      P % 16 || N < 16 || N > MAX_N || N % 16)
    return cudaErrorInvalidValue;
  const int Q = chunk < S ? chunk : S;
  TcArgs a{static_cast<const bf16*>(dy), static_cast<const float*>(dt),
           static_cast<const float*>(A), static_cast<const bf16*>(Cm),
           nullptr, nullptr, nullptr, static_cast<bf16*>(scratch),
           H, S, P, N, Q, (S + Q - 1) / Q, 1,
           ys_b, ys_h, ys_s, 0, 0, 0, ds_b, ds_h, ds_s,
           cs_b, cs_s, 0, 0, static_cast<const float*>(dstate)};
  const size_t smem = states_tc_smem(qpad16(Q), N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_states_tc_kernel<true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_states_tc_kernel<true>
      <<<dim3(B * H, (P + TC_PS - 1) / TC_PS), TC_NT, smem,
         static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
