"""Time the (576, 512) bf16 kernels of the ``repro_torch`` beside this
script against builds of the same sources with one design choice
changed, all in one process; with ``--profile`` also one K3 and one K2
dk/dv call of the tree's own kernels, kernel by kernel.

    PYTHONPATH=src python scripts/torch_wide_variants.py OUT [--variants]
        [--profile]

Shapes: the absorbed MLA route's (chip_smoke's ``K1_TIMED`` and
``K1_LSE_TIMED`` "mla_absorbed", bf16, causal): K1 at B=4, H=128, KH=1,
S=4096, and K1-lse, K2 dk/dv and K3 at B=1, each with v as k's first
512 columns (the route's form) and with v apart; chip_smoke's events
timer, [median, min, max] ms of 10 cold-L2 calls.  Each variant patches
``csrc/flash_attention_wide.cu`` and ``csrc/hopper.cuh`` (a patch that no
longer matches the source raises), builds them with
``flash_attention.cu`` and ``flash_attention_bwd.cu`` into
``build/wide_variants/``, runs through the wrappers, and is held against
the plain versions before it is timed:

* ``k1_three_stages``: K1 on a three-stage ring of 32-row kv tiles (16
  where v comes apart), each consumer starting the next tile's S before
  its softmax, so that the trade and the softmax run beside it;
* ``dkv_cluster``: the dV and dK blocks of a kv tile as one cluster of
  two blocks, each q / dO tile loaded once by TMA multicast into both.

Appends one JSON line to OUT and prints it.  Needs a CUDA card and nvcc.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

WIDE = _build.CSRC / "flash_attention_wide.cu"
HOPPER = _build.CSRC / "hopper.cuh"

K1_THREE_STAGES = r'''constexpr int F_BQ = 64;   // q rows of a K1 block: wgmma's M
// K1's ring: three stages, so that a tile's S can start while the one
// before it is still read by P V; kv rows of a stage: 32 where v is k's
// prefix (one tile for both), 16 where v comes apart (K and V tiles)
constexpr int K1_STAGES = 3;
template <bool SV> constexpr int f_bk() { return SV ? 32 : 16; }

template <bool SV>
constexpr size_t k1_bytes() {
  return SMEM_ALIGN + (size_t)F_BQ * HD_BOXES * BOX * 2 +
         (size_t)K1_STAGES * f_bk<SV>() *
             (HD_BOXES + (SV ? 0 : HDV_BOXES)) * BOX * 2 +
         (size_t)2 * F_BQ * f_bk<SV>() * 4 + 8 * (1 + 2 * K1_STAGES);
}
static_assert(k1_bytes<true>() <= 232448, "K1 tiles, v k's prefix");
static_assert(k1_bytes<false>() <= 232448, "K1 tiles, v apart");

template <int BK, bool SV>
__global__ void __launch_bounds__(3 * WG, 1)
flash_fwd_wide_tc_kernel(const __grid_constant__ CUtensorMap tmq,
                         const __grid_constant__ CUtensorMap tmk,
                         const __grid_constant__ CUtensorMap tmv,
                         bf16* __restrict__ o, float* __restrict__ lse,
                         int H, int G, int Sq, int Sk, int hd, int hd_v,
                         int q_offset, int causal, int window, float scale) {
  constexpr int NS = BK / 2;
  constexpr int KSTAGE = HD_BOXES * BK * BOX, VSTAGE = HDV_BOXES * BK * BOX;
  bf16* sQ = smem_tiles();
  bf16* sK = sQ + HD_BOXES * F_BQ * BOX;
  bf16* sV = sK + K1_STAGES * KSTAGE;
  float4* sX = reinterpret_cast<float4*>(sV + (SV ? 0 : K1_STAGES * VSTAGE));
  uint64_t* bars = reinterpret_cast<uint64_t*>(sX + 2 * (NS / 4) * WG);
  uint64_t *qbar = bars, *full = bars + 1, *empty = bars + 1 + K1_STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F_BQ;
  const int bkv = (bh / H) * (H / G) + (bh % H) / G;
  const int row0 = q_offset + q0;
  int kv_begin = 0, kv_end = Sk;
  if (causal) kv_end = min(Sk, row0 + F_BQ);
  if (window > 0) kv_begin = max(0, row0 - window + 1);
  const int kt0 = (kv_begin / BK) * BK;
  const int n_it = kv_end > kt0 ? (kv_end - kt0 + BK - 1) / BK : 0;

  init_ring(bars, 1, 2 * WG, K1_STAGES);
  const int wg = warpgroup();

  if (wg == 2) {
    reg_dealloc<24>();
    if (threadIdx.x == 2 * WG) {
      mbar_expect(qbar, HD_BOXES * F_BQ * BOX * 2);
      for (int b = 0; b < HD_BOXES; ++b)
        tma_load(sQ + b * F_BQ * BOX, tmq, qbar, b * BOX, q0, bh);
      for (int it = 0; it < n_it; ++it) {
        const int st = it % K1_STAGES, k0 = kt0 + it * BK;
        mbar_wait(&empty[st], ((it / K1_STAGES) & 1) ^ 1);
        mbar_expect(&full[st], (KSTAGE + (SV ? 0 : VSTAGE)) * 2);
        for (int b = 0; b < HD_BOXES; ++b)
          tma_load(sK + st * KSTAGE + b * BK * BOX, tmk, &full[st], b * BOX,
                   k0, bkv);
        if (!SV)
          for (int b = 0; b < HDV_BOXES; ++b)
            tma_load(sV + st * VSTAGE + b * BK * BOX, tmv, &full[st],
                     b * BOX, k0, bkv);
      }
    }
  } else {
    reg_alloc<240>();
    const int t = threadIdx.x % WG, lane = t & 31;
    const int g = lane >> 2, tq = lane & 3, r_lo = (t >> 5) * 16 + g;
    const int nks = (hd + 15) / 16, ks_lo = wg * ((nks + 1) / 2);
    const int ks_hi = min(nks, ks_lo + (nks + 1) / 2);
    float acc[128];
    zero_acc(acc);
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    uint32_t hi[BK / 16][4], lo[BK / 16][4];
    mbar_wait(qbar, 0);
    auto start_s = [&](float (&s)[NS], int it) {
      const int st = it % K1_STAGES;
      mbar_wait(&full[st], (it / K1_STAGES) & 1);
      zero_acc(s);
      fence_regs(s);
      wgmma_fence();
      for (int ks = ks_lo; ks < ks_hi; ++ks)
        wgmma_ss<0, 0>(s, kmaj(sQ, F_BQ, ks),
                       kmaj(sK + st * KSTAGE, BK, ks));
      wgmma_commit();
    };
    auto tile = [&](float (&s)[NS], float (&sn)[NS], int it) {
      const int st = it % K1_STAGES, k0 = kt0 + it * BK;
      wgmma_wait();
      fence_regs(s);
      fence_regs(acc);
      fence_regs(hi);
      fence_regs(lo);
      if (it > 0) mbar_arrive(&empty[(it - 1) % K1_STAGES]);
      if (it + 1 < n_it) start_s(sn, it + 1);
      wg_pair_sync(1);
      put_acc(sX, wg, t, s);
      wg_pair_sync(2);
      {
        float y[NS];
        get_acc(y, sX, wg ^ 1, t);
#pragma unroll
        for (int i = 0; i < NS; ++i) s[i] += y[i];
      }
      const bool full_tile = k0 + BK <= Sk &&
                             (!causal || k0 + BK - 1 <= row0) &&
                             (window <= 0 || row0 + F_BQ - 1 - k0 < window);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int row = row0 + r_lo + 8 * ((i >> 1) & 1);
        const int col = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
        s[i] = full_tile || is_live(row, col, Sk, causal, window)
                   ? s[i] * scale : NEG_INF;
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < NS; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = __expf(m[i] - mx[i]);
        m[i] = mx[i];
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = __expf(s[i] - m[(i >> 1) & 1]);
        rs[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) frag_pair(s, kk, hi[kk], lo[kk]);
      const bf16* Vs = SV ? sK + st * KSTAGE : sV + st * VSTAGE;
      fence_regs(hi);
      fence_regs(lo);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t vd = mnmaj(Vs, BK, 4 * wg, kk);
        wgmma_rs<1>(acc, hi[kk], vd);
        wgmma_rs<1>(acc, lo[kk], vd);
      }
      wgmma_commit();
    };
    float sa[NS], sb[NS];
    if (n_it > 0) start_s(sa, 0);
    for (int it = 0; it < n_it; it += 2) {
      tile(sa, sb, it);
      if (it + 1 < n_it) tile(sb, sa, it + 1);
    }
    wgmma_wait();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    if (n_it > 0) mbar_arrive(&empty[(n_it - 1) % K1_STAGES]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    const int q_rows = min(F_BQ, Sq - q0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_lo + 8 * i;
      if (r >= q_rows) continue;
      const float den = fmaxf(l[i], 1e-37f);
      if (lse != nullptr && wg == 0 && tq == 0)
        lse[(size_t)bh * Sq + q0 + r] = m[i] + logf(den);
      bf16* out = o + ((size_t)bh * Sq + q0 + r) * hd_v;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = 256 * wg + 8 * j + 2 * tq;
        if (c < hd_v)
          *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
              acc[4 * j + 2 * i] / den, acc[4 * j + 2 * i + 1] / den);
      }
    }
  }
}

'''

DKV_CLUSTER_KERNEL = r'''// K2's dk/dv and K3's dk, dv, dS: one cluster of two blocks per (head
// slice, 64-row kv tile, b*KH + kh), each walking the same q tiles (of
// the pass's rows [pa, pb)); every q / dO tile is loaded once, each block's
// producer fetching half of its boxes by TMA multicast into both blocks.
// Block 0 sums dV: both consumers split S^T = K Q^T's depth as K1 does
// and add P^T dO (256 columns each).  Block 1 sums dK: consumer 1 sums
// S^T (into its own scratch) and dP^T = V dO^T, forms dS^T = P^T (dP^T -
// delta) as a bf16 hi + lo pair and hands it to consumer 0 through shared
// memory; both add dS^T Q, consumer 0 into dK's columns 0..255 and
// 512..575 (160 fp32, with no score work beside them), consumer 1 into
// 256..511.  With DS, block 1's consumer 0 writes dS^T into the pass's dS
// workspace for tc_bwd_dq_ds_wide_kernel.  Each block writes its slice's
// fp32 partial into ws; `carry` resumes the partial an earlier pass left.
template <int TQ, bool SV, bool DS>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(3 * WG, 1)
tc_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv,
                       const __grid_constant__ CUtensorMap tmq,
                       const __grid_constant__ CUtensorMap tmo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ ws, bf16* __restrict__ ds,
                       int H, int G, int Sq, int Sk, int hd, int hd_v,
                       int q_offset, int causal, int window, float scale,
                       int splits, int pa, int pb, int pass_pairs,
                       int carry) {
  constexpr int NS = TQ / 2, NK = TQ / 16;
  constexpr int KTILE = HD_BOXES * KV_T * BOX;
  constexpr int QSTAGE = HD_BOXES * TQ * BOX, OSTAGE = HDV_BOXES * TQ * BOX;
  bf16* sK = smem_tiles();
  bf16* sV = sK + KTILE;                         // not SV: V's own tile
  bf16* sQ = sV + (SV ? 0 : HDV_BOXES * KV_T * BOX);   // 2 stages
  bf16* sO = sQ + 2 * QSTAGE;                    // 2 stages of dO
  // dV: the two consumers' S^T halves; dK: consumer 1's S^T and the dS^T
  // it hands over
  float4* sX = reinterpret_cast<float4*>(sO + 2 * OSTAGE);
  float4* sS = sX;
  uint32_t* sP = reinterpret_cast<uint32_t*>(sX + (NS / 4) * WG);
  float* sL = reinterpret_cast<float*>(sX + 2 * (NS / 4) * WG);  // 2 x TQ
  float* sD = sL + 2 * TQ;                                 // lse, delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(sD + 2 * TQ);
  uint64_t *kbar = bars, *full = bars + 1, *empty = bars + 3;

  const uint32_t role = cluster_rank();          // 0 dV, 1 dK
  const int split = blockIdx.x >> 1, k0 = blockIdx.y * KV_T;
  const int bkv = blockIdx.z, kt = blockIdx.y;
  int bh0, qt0;
  const int nh = slice_heads(bkv, H, G, split, splits, &bh0);
  const int kv_rows = min(KV_T, Sk - k0);
  const int n_qt = dkv_q_tiles<TQ>(k0, kv_rows, Sq, q_offset, causal,
                                   window, pa, pb, &qt0);
  const int n_it = nh * n_qt;
  const size_t n_rows = (size_t)gridDim.z * Sk;   // B * KH * Sk
  float* wk = ws + (size_t)split * n_rows * hd;
  float* wv = ws + (size_t)splits * n_rows * hd + (size_t)split * n_rows * hd_v;
  // both blocks of the cluster leave together: an earlier pass holds the
  // partials
  if (n_it == 0 && carry) return;
  // iteration it: q tile qt0 + (n_qt - 1 - it / nh) * TQ (the last
  // first), head bh0 + it % nh
  auto q_of = [&](int it) { return qt0 + (n_qt - 1 - it / nh) * TQ; };
  auto bh_of = [&](int it) { return bh0 + it % nh; };

  // a stage is free once every consumer warp of both blocks has read it
  init_ring(bars, 1, 2 * 2 * WG / 32);
  cluster_sync();   // the peer's barriers are set up before any load
  const int wg = warpgroup();
  const int lane = threadIdx.x & 31;
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) {
      mbar_arrive_at(&empty[st], 0);
      mbar_arrive_at(&empty[st], 1);
    }
  };

  if (wg == 2) {
    reg_dealloc<24>();
    if (threadIdx.x == 2 * WG) {
      mbar_expect(kbar, (KTILE + (role == 1 && !SV ? HDV_BOXES * KV_T * BOX
                                                   : 0)) * 2);
      for (int b = 0; b < HD_BOXES; ++b)
        tma_load(sK + b * KV_T * BOX, tmk, kbar, b * BOX, k0, bkv);
      if (role == 1 && !SV)
        for (int b = 0; b < HDV_BOXES; ++b)
          tma_load(sV + b * KV_T * BOX, tmv, kbar, b * BOX, k0, bkv);
      for (int it = 0; it < n_it; ++it) {
        const int st = it & 1, q0 = q_of(it), bh = bh_of(it);
        mbar_wait(&empty[st], ((it >> 1) & 1) ^ 1);
        mbar_expect(&full[st], (QSTAGE + OSTAGE) * 2);
        if (role == 0)   // q's boxes to both blocks
          for (int b = 0; b < HD_BOXES; ++b)
            tma_load_mc(sQ + st * QSTAGE + b * TQ * BOX, tmq, &full[st],
                        b * BOX, q0, bh, 0x3);
        else             // dO's
          for (int b = 0; b < HDV_BOXES; ++b)
            tma_load_mc(sO + st * OSTAGE + b * TQ * BOX, tmo, &full[st],
                        b * BOX, q0, bh, 0x3);
      }
      // the last stages' releases, the peer's arrivals among them, land
      // before this block leaves
      for (int it = max(n_it, 2); it < n_it + 2; ++it)
        mbar_wait(&empty[it & 1], ((it >> 1) & 1) ^ 1);
    }
    return;
  }
  reg_alloc<240>();
  const int t = threadIdx.x % WG;
  const int g = lane >> 2, tq = lane & 3, r_lo = (t >> 5) * 16 + g;

  if (role == 0) {   // dV
    const int nks = (hd + 15) / 16, ks_lo = wg * ((nks + 1) / 2);
    const int ks_hi = min(nks, ks_lo + (nks + 1) / 2);
    float adv[128];
    zero_acc(adv);
    if (carry)
      dk_part<false>(wv, bkv, Sk, k0, kv_rows, hd_v, 256 * wg, r_lo, tq, adv);
    mbar_wait(kbar, 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it & 1, q0 = q_of(it), bh = bh_of(it);
      float ls[NS / 2];   // lse of this thread's q columns
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) {
        const int qc = q0 + 8 * (i >> 1) + 2 * tq + (i & 1);
        ls[i] = qc < Sq ? lse[(size_t)bh * Sq + qc] : 0.f;
      }
      const bf16* Qs = sQ + st * QSTAGE;
      mbar_wait(&full[st], (it >> 1) & 1);

      float s[NS];   // S^T: kv rows, q columns
      zero_acc(s);
      fence_regs(s);
      wgmma_fence();
      for (int ks = ks_lo; ks < ks_hi; ++ks)
        wgmma_ss<0, 0>(s, kmaj(sK, KV_T, ks), kmaj(Qs, TQ, ks));
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      wg_pair_sync(1);
      put_acc(sX, wg, t, s);
      wg_pair_sync(2);
      {
        float y[NS];
        get_acc(y, sX, wg ^ 1, t);
#pragma unroll
        for (int i = 0; i < NS; ++i) s[i] += y[i];
      }
      // P^T, masked
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int qr = 8 * (i >> 2) + 2 * tq + (i & 1);
        const int col = k0 + r_lo + 8 * ((i >> 1) & 1);
        const bool live = q0 + qr < Sq &&
                          is_live(q_offset + q0 + qr, col, Sk, causal, window);
        s[i] = expf((live ? s[i] * scale : NEG_INF) -
                    ls[((i >> 2) << 1) | (i & 1)]);
      }
      // dV[:, 256 wg ..] += P^T dO
      uint32_t hi[NK][4], lo[NK][4];
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) frag_pair(s, kk, hi[kk], lo[kk]);
      const bf16* Os = sO + st * OSTAGE;
      fence_regs(hi);
      fence_regs(lo);
      fence_regs(adv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint64_t od = mnmaj(Os, TQ, 4 * wg, kk);
        wgmma_rs<1>(adv, hi[kk], od);
        wgmma_rs<1>(adv, lo[kk], od);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(adv);
      release(st);
    }
    // this slice's partial dV (the splits' dK partials come first in ws)
    dk_part<true>(wv, bkv, Sk, k0, kv_rows, hd_v, 256 * wg, r_lo, tq, adv);
    return;
  }

  // dK: consumer 0 puts the q rows' lse and delta in shared memory one
  // tile ahead of consumer 1, which forms dS^T with them
  auto stage_ld = [&](int it) {
    if (t < TQ) {
      const int q = q_of(it) + t, b = it & 1;
      const size_t row = (size_t)bh_of(it) * Sq + q;
      sL[b * TQ + t] = q < Sq ? lse[row] : 0.f;
      sD[b * TQ + t] = q < Sq ? delta[row] : 0.f;
    }
  };
  if (wg == 0 && n_it > 0) stage_ld(0);
  wg_pair_sync(3);
  mbar_wait(kbar, 0);
  if (wg == 0) {
    float adk[128], adk8[32];
    zero_acc(adk);
    zero_acc(adk8);
    if (carry) {
      dk_part<false>(wk, bkv, Sk, k0, kv_rows, hd, 0, r_lo, tq, adk);
      dk_part<false>(wk, bkv, Sk, k0, kv_rows, hd, 512, r_lo, tq, adk8);
    }
    int slot_qt = -1, slot0 = 0;   // K3: the dS tile pair's slot
    for (int it = 0; it < n_it; ++it) {
      const int st = it & 1, q0 = q_of(it), bh = bh_of(it);
      if (it + 1 < n_it) stage_ld(it + 1);
      wg_pair_sync(1);   // consumer 1's dS^T of this tile is in sP
      uint32_t hi[NK][4], lo[NK][4];
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[kk][e] = sP[(kk * 8 + e) * WG + t];
          lo[kk][e] = sP[(kk * 8 + 4 + e) * WG + t];
        }
      if (it + 1 < n_it) wg_pair_arrive(2);   // sP may be written again
      if (DS) {
        // dS^T into the pass's workspace: tile pair (bh, q tile, kv
        // tile) of 64 kv rows by 64 q columns, hi then lo
        const int qt = q0 / 64;
        if (qt != slot_qt) {
          int lo_t, hi_t;
          ds_kv_tiles(qt * 64, q_offset, Sk, causal, window, lo_t, hi_t);
          slot_qt = qt;
          slot0 = ds_pairs(pa / 64, qt, q_offset, Sk, causal, window) + kt -
                  lo_t;
        }
        bf16* tile = ds + ((size_t)bh * pass_pairs + slot0) * 2 * 64 * 64;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // fragment register e: kv row r_lo (+8 for e odd), q columns
            // 16 kk + 2 tq (+8 for e >= 2)
            const int r = r_lo + 8 * (e & 1);
            const int c = q0 % 64 + 16 * kk + 2 * tq + 8 * (e >> 1);
            *reinterpret_cast<uint32_t*>(tile + r * 64 + c) = hi[kk][e];
            *reinterpret_cast<uint32_t*>(tile + 64 * 64 + r * 64 + c) =
                lo[kk][e];
          }
      }
      const bf16* Qs = sQ + st * QSTAGE;
      mbar_wait(&full[st], (it >> 1) & 1);
      fence_regs(hi);
      fence_regs(lo);
      fence_regs(adk);
      fence_regs(adk8);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint64_t qa = mnmaj(Qs, TQ, 0, kk), qb = mnmaj(Qs, TQ, 8, kk);
        wgmma_rs<1>(adk, hi[kk], qa);
        wgmma_rs<1>(adk, lo[kk], qa);
        wgmma_rs<1>(adk8, hi[kk], qb);
        wgmma_rs<1>(adk8, lo[kk], qb);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(adk);
      fence_regs(adk8);
      release(st);
    }
    // this slice's partial dK (unscaled), to be resumed or summed
    dk_part<true>(wk, bkv, Sk, k0, kv_rows, hd, 0, r_lo, tq, adk);
    dk_part<true>(wk, bkv, Sk, k0, kv_rows, hd, 512, r_lo, tq, adk8);
  } else {
    float adk[128];
    zero_acc(adk);
    if (carry) dk_part<false>(wk, bkv, Sk, k0, kv_rows, hd, 256, r_lo, tq, adk);
    const int nks = (hd + 15) / 16, nvs = (hd_v + 15) / 16;
    const bf16* Vt = SV ? sK : sV;
    for (int it = 0; it < n_it; ++it) {
      const int st = it & 1, q0 = q_of(it);
      const bf16* Qs = sQ + st * QSTAGE;
      const bf16* Os = sO + st * OSTAGE;
      mbar_wait(&full[st], (it >> 1) & 1);
      // S^T over hd into this warpgroup's scratch, then dP^T over hd_v
      float x[NS];
      zero_acc(x);
      fence_regs(x);
      wgmma_fence();
      for (int ks = 0; ks < nks; ++ks)
        wgmma_ss<0, 0>(x, kmaj(sK, KV_T, ks), kmaj(Qs, TQ, ks));
      wgmma_commit();
      wgmma_wait();
      fence_regs(x);
      put_acc(sS, 0, t, x);
      zero_acc(x);
      fence_regs(x);
      wgmma_fence();
      for (int ks = 0; ks < nvs; ++ks)
        wgmma_ss<0, 0>(x, kmaj(Vt, KV_T, ks), kmaj(Os, TQ, ks));
      wgmma_commit();
      wgmma_wait();
      fence_regs(x);
      // dS^T = P^T (dP^T - delta), unscaled, into x
      const float* Ls = sL + st * TQ;
      const float* Ds = sD + st * TQ;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j) {
        const float4 s4 = sS[j * WG + t];
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, qr = 8 * j + 2 * tq + (e & 1);
          const int col = k0 + r_lo + 8 * (e >> 1);
          const bool live = q0 + qr < Sq && is_live(q_offset + q0 + qr, col,
                                                    Sk, causal, window);
          const float p = expf((live ? sv[e] * scale : NEG_INF) - Ls[qr]);
          x[i] = p * (x[i] - Ds[qr]);
        }
      }
      uint32_t hi[NK][4], lo[NK][4];
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) frag_pair(x, kk, hi[kk], lo[kk]);
      if (it > 0) wg_pair_sync(2);   // consumer 0 has read the last dS^T
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sP[(kk * 8 + e) * WG + t] = hi[kk][e];
          sP[(kk * 8 + 4 + e) * WG + t] = lo[kk][e];
        }
      wg_pair_sync(1);
      fence_regs(hi);
      fence_regs(lo);
      fence_regs(adk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint64_t qa = mnmaj(Qs, TQ, 4, kk);
        wgmma_rs<1>(adk, hi[kk], qa);
        wgmma_rs<1>(adk, lo[kk], qa);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(adk);
      release(st);
    }
    dk_part<true>(wk, bkv, Sk, k0, kv_rows, hd, 256, r_lo, tq, adk);
  }
}

'''

DKV_CLUSTER_LAUNCH = r'''template <bool SV>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dq, void* dk, void* dv,
                          float* ws, int splits, void* ds, const int* passes,
                          int n_pass, int B, int H, int KH, int Sq, int Sk,
                          int hd, int hd_v, int ldv, int q_offset,
                          int causal, int window, float scale,
                          int* occupancy, cudaStream_t st) {
  constexpr int TQ = dk_tq<SV>();
  const int G = H / KH, n_kt = (Sk + KV_T - 1) / KV_T;
  const int rows_all = (Sq + 63) / 64 * 64;
  const dim3 grid(2 * splits, n_kt, B * KH);   // clusters of dV, dK blocks
  if (occupancy != nullptr)
    return run(tc_bwd_dkv_wide_kernel<TQ, SV, true>, occupancy, grid, 3 * WG,
               dk_bytes<SV>(), st, CUtensorMap{}, CUtensorMap{},
               CUtensorMap{}, CUtensorMap{}, lse, delta, ws,
               static_cast<bf16*>(ds), H, G, Sq, Sk, hd, hd_v, q_offset,
               causal, window, scale, splits, 0, 0, 0, 0);
  CUtensorMap mk{}, mv{}, mq{}, mo{}, mds{};
  if (!tile_map(&mk, k, hd, Sk, B * KH, hd, (long long)Sk * hd, KV_T) ||
      (!SV && !tile_map(&mv, v, hd_v, Sk, B * KH, ldv, (long long)Sk * ldv,
                        KV_T)) ||
      !tile_map(&mq, q, hd, Sq, B * H, hd, (long long)Sq * hd, TQ) ||
      !tile_map(&mo, dout, hd_v, Sq, B * H, hd_v, (long long)Sq * hd_v, TQ))
    return cudaErrorInvalidValue;
  if (ds == nullptr)
    return run(tc_bwd_dkv_wide_kernel<TQ, SV, false>, nullptr, grid, 3 * WG,
               dk_bytes<SV>(), st, mk, SV ? mk : mv, mq, mo, lse, delta, ws,
               static_cast<bf16*>(nullptr), H, G, Sq, Sk, hd, hd_v, q_offset,
               causal, window, scale, splits, 0, rows_all, 0, 0);
  // the workspace as rows of 64 dS values: the largest pass's pairs
  int most = 0;
  for (int p = 0; p < n_pass; ++p) most = max(most, passes[3 * p + 2]);
  if (most > 0 && !tile_map(&mds, ds, 64, (long long)B * H * most * 2 * 64,
                            1, 64, (long long)B * H * most * 2 * 64 * 64, 64))
    return cudaErrorInvalidValue;
  for (int p = 0; p < n_pass; ++p) {
    const int pa = passes[3 * p], pb = passes[3 * p + 1];
    const int pairs = passes[3 * p + 2];
    cudaError_t err = run(
        tc_bwd_dkv_wide_kernel<TQ, SV, true>, nullptr, grid, 3 * WG,
        dk_bytes<SV>(), st, mk, SV ? mk : mv, mq, mo, lse, delta, ws,
        static_cast<bf16*>(ds), H, G, Sq, Sk, hd, hd_v, q_offset, causal,
        window, scale, splits, pa, pb, pairs, int(p > 0));
    if (err != cudaSuccess) return err;
    err = run(tc_bwd_dq_ds_wide_kernel, nullptr,
              dim3((pb - pa) / 64, B * H), 4 * WG, dq_bytes(), st, mds, mk,
              static_cast<bf16*>(dq), H, G, Sq, Sk, hd, q_offset, causal,
              window, scale, pa, pairs);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

'''

CLUSTER_HELPERS = r'''// One box as tma_load, written at the same offset into the shared memory
// of every block of the cluster in `mask`, completing on each one's
// mbarrier at `bar`'s offset.
__device__ __forceinline__ void tma_load_mc(void* dst, const CUtensorMap& map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(&map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// one arrival on the mbarrier at `bar`'s offset in cluster block `rank`
__device__ __forceinline__ void mbar_arrive_at(uint64_t* bar, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(a) : "memory");
}

'''

INIT_RING = r'''__device__ __forceinline__ void init_ring(uint64_t* bars, int lead,
                                          uint32_t consumers) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < lead + 2; ++i) mbar_init(&bars[i], 1);
    for (int s = 0; s < 2; ++s) mbar_init(&bars[lead + 2 + s], consumers);'''

INIT_RING_STAGES = r'''__device__ __forceinline__ void init_ring(uint64_t* bars, int lead,
                                          uint32_t consumers,
                                          int stages = 2) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < lead + stages; ++i) mbar_init(&bars[i], 1);
    for (int s = 0; s < stages; ++s)
      mbar_init(&bars[lead + stages + s], consumers);'''

CONSUMER_SYNC = "// the two consumer warpgroups (256 threads) meet at named barrier `id`"

# name: {source: [(start, end, new)]}: the text from start up to end (or
# start itself where end is None) becomes new
VARIANTS = {
    "k1_three_stages": {
        "wide": [("constexpr int F_BQ = 64;   // q rows of a K1 block: "
                  "wgmma's M",
                  "// --------------------------------------------- K2 "
                  "dk/dv and K3 (wgmma)", K1_THREE_STAGES)],
        "hopper": [(INIT_RING, None, INIT_RING_STAGES)]},
    "dkv_cluster": {
        "wide": [("// dK (K2's dk half, and K3's with DS): one block per "
                  "(head slice, 64-row",
                  "// K3's dq = scale * sum over kv tiles of dS K",
                  DKV_CLUSTER_KERNEL),
                 ("template <bool SV>\ncudaError_t launch_bwd_tc(",
                  "}  // namespace\n\ncudaError_t wide_fwd(",
                  DKV_CLUSTER_LAUNCH)],
        "hopper": [(CONSUMER_SYNC, None, CLUSTER_HELPERS + CONSUMER_SYNC)]},
}


def _patched(text, edits, name):
    for start, end, new in edits:
        i = text.find(start)
        j = i + len(start) if end is None else text.find(end, i + 1)
        if i < 0 or j < 0:
            raise RuntimeError(f"variant {name}: its patch no longer "
                               "matches the source")
        text = text[:i] + new + text[j:]
    return text


def _build_variants(names):
    """{name: ctypes library}: each variant's patched sources built with
    the entry points' files into one library."""
    procs = {}
    for name in names:
        d = _build.BUILD_DIR / "wide_variants" / name
        d.mkdir(parents=True, exist_ok=True)
        edits = VARIANTS[name]
        (d / "flash_attention_wide.cu").write_text(
            _patched(WIDE.read_text(), edits["wide"], name))
        (d / "hopper.cuh").write_text(
            _patched(HOPPER.read_text(), edits["hopper"], name))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(d),
             "-I", str(_build.CSRC), "-o", str(d / "lib.so"),
             str(d / "flash_attention_wide.cu"),
             str(_build.CSRC / "flash_attention.cu"),
             str(_build.CSRC / "flash_attention_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(_build.BUILD_DIR / "wide_variants" / name /
                              "lib.so"))
        for fn, argtypes in _build._ENTRIES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def _inputs(b, s, k_prefix, seed):
    bf = torch.bfloat16
    q = cs._randn((b, 128, s, 576), bf, seed)
    k = cs._randn((b, 1, s, 576), bf, seed + 1)
    v = k[..., :512] if k_prefix else cs._randn((b, 1, s, 512), bf, seed + 2)
    return q, k, v


def _check(tag):
    """The wrappers against the plain versions at a small ragged shape,
    both forms of v: raise where an output leaves chip_smoke's limits."""
    bf = torch.bfloat16
    for k_prefix in (True, False):
        q, k, v = _inputs(1, 600, k_prefix, 7)
        q = q[:, :16].contiguous()
        do = cs._randn((1, 16, 600, 512), bf, 9)
        kw = dict(causal=True, window=100)
        out, lse = fa.flash_attention_fwd(q, k, v, 30, **kw)
        cs._check(f"{tag} K1-lse", out, fa.flash_attention_plain(
            q, k, v, 30, **kw), bf)
        delta = (do.float() * out.float()).sum(-1)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, 30, **kw)
        for name, got in (("K3", fa.flash_attention_bwd_fused(
                q, k, v, do, lse, delta, 30, **kw)),
                          ("K2 dk/dv", (None, *fa.flash_attention_bwd_dkv(
                              q, k, v, do, lse, delta, 30, **kw)))):
            for g, w in zip(got, want):
                if g is not None:
                    cs._check_rel(f"{tag} {name}", g, w, bf)


def _times(flush):
    """K1, K1-lse, K2 dk/dv and K3 at the absorbed shapes, both forms."""
    res = {}
    for k_prefix in (True, False):
        form = "k_prefix" if k_prefix else "apart"
        q, k, v = _inputs(4, 4096, k_prefix, 1)
        res[f"k1_{form}"] = cs._time_stats(
            lambda: fa.flash_attention(q, k, v), 10, flush)
        del q, k, v
        q, k, v = _inputs(1, 4096, k_prefix, 1)
        do = cs._randn((1, 128, 4096, 512), torch.bfloat16, 4)
        out, lse = fa.flash_attention_fwd(q, k, v)
        a = (q, k, v, do, lse, (do.float() * out.float()).sum(-1))
        res[f"k1_lse_{form}"] = cs._time_stats(
            lambda: fa.flash_attention_fwd(q, k, v), 10, flush)
        res[f"k2_dkv_{form}"] = cs._time_stats(
            lambda: fa.flash_attention_bwd_dkv(*a), 10, flush)
        res[f"k3_{form}"] = cs._time_stats(
            lambda: fa.flash_attention_bwd_fused(*a), 10, flush)
        del q, k, v, do, out, lse, a
        torch.cuda.empty_cache()
    return res


def _profile():
    """Device ms a call of each kernel in one K3 and one K2 dk/dv call
    at 1 x 4096, v k's prefix (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v = _inputs(1, 4096, True, 1)
    do = cs._randn((1, 128, 4096, 512), torch.bfloat16, 4)
    out, lse = fa.flash_attention_fwd(q, k, v)
    a = (q, k, v, do, lse, (do.float() * out.float()).sum(-1))
    res = {}
    for name, fn in (("k3", fa.flash_attention_bwd_fused),
                     ("k2_dkv", fa.flash_attention_bwd_dkv)):
        fn(*a)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            fn(*a)
            torch.cuda.synchronize()
        per = {}
        for e in prof.events():
            t = getattr(e, "device_time_total", 0) or 0
            if t and "kernel" in e.name:
                per[e.name[:90]] = per.get(e.name[:90], 0.0) + t / 1e3
        res[name] = per
    return res


def main() -> int:
    out = sys.argv[1]
    if not torch.cuda.is_available():
        print("torch_wide_variants: no CUDA device", file=sys.stderr)
        return 1
    lib = _build.load()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    names = list(VARIANTS) if "--variants" in sys.argv[2:] else []
    libs = {"tree": lib, **_build_variants(names)}
    res = {"src": fa.__file__}
    for name, variant in libs.items():
        with mock.patch.object(_build, "load", lambda v=variant: v):
            _check(name)
            res[name] = _times(flush)
        print(name, {k: round(t["median"], 4) for k, t in res[name].items()},
              flush=True)
    if "--profile" in sys.argv[2:]:
        res["profile"] = _profile()
    print(json.dumps(res))
    with open(out, "a") as f:
        f.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
