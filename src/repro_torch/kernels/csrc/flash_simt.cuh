// The CUDA-core tile body of GQA self-attention: the "simt" route of
// flash_attention.cu and dual_tenant_attention.cu, for f32 and f16 at head
// dims 64, 128 and 256 (bf16 takes the tensor-core body of flash_wgmma.cuh,
// which computes the same function). f32 stays on CUDA cores because TF32
// would break its 2e-5 tolerance.
//
// Replaces, with flash_wgmma.cuh, the Pallas online-softmax bodies of
//   src/repro/kernels/flash_attention.py       (_kernel, flash_attention)
//   src/repro/kernels/dual_tenant_attention.py
//     (_kernel, dual_tenant_attention)
//
// What it computes. One call handles one query tile: BQ = 64 consecutive
// query positions q0.. of head h of batch row b, against KV head
// h / (H / Hkv). q, k, v and out are contiguous [B, S, H or Hkv, D]. Query s
// sees key t when t <= s (causal) and t > s - window (window > 0); the
// scores are q.k * D^-0.5 in f32, capped as c * tanh(s / c) when softcap c
// > 0, then masked to the finite NEG_INF = -1e30 (never -inf: a wholly
// masked tile must not turn into NaN). Softmax state (m, l, acc) is f32 and
// the result is acc / max(l, 1e-30), rounded once to the output type. The
// softmax runs in base 2 (exp2f): q is scaled once by D^-0.5 * log2(e);
// with a softcap by D^-0.5 alone, and log2(e) multiplies the capped score.
//
// What bounds it on the card: operations. 4 * D flops per visible (query,
// key) pair, all f32 FMAs (67 TFLOP/s on an H100), against 4 * D bytes of K
// and V per key shared by the tile's 64 rows. Feeding each FMA from shared
// memory caps it far below that (shared memory serves 128 bytes a cycle to
// an SM's 128 FMA lanes), so the design feeds the FMAs from register tiles
// whose shared operand every lane of a warp reads at once (a broadcast: one
// pass of shared memory for the warp):
//   Block: 256 threads; warp w owns the tile's rows 8w .. 8w + 7, all its
//   lanes the same 8 rows. Scores: lane j sums q.k over all of D, in order,
//   for the 8 rows and the keys j + 32c (c < BK / 32) of the key tile: per
//   16 bytes of D, one 16-byte read of K a key and one broadcast of q a row.
//   P.V: lane j owns head dims (j + 32c) * NV .. + NV of the 8 rows and sums
//   the tile's keys in order: one read of V a key, one broadcast of P per 4
//   keys and row. At f32 D 128 a warp's 128 FMAs take 24 shared-memory
//   passes in both products (0.75 of what shared memory serves at the FMA
//   peak; the 16 x 8 thread grid this replaces took 64 for the scores), and
//   neither product moves values between lanes.
//   Softmax: the scores go to P in shared memory, and lane (g, r) = (lane /
//   8, lane % 8) takes row 8w + r, its 4-key chunks g + 4x: one row a lane,
//   whose max and sum need two xor shuffles (the row in registers across
//   the warp needed ten, on chains that stalled both warps of a scheduler).
//   The row's 4 lanes hold its (m, l); the warp's 8 rows' alpha reach every
//   lane by one shuffle each. The logit softcap and the mask are uniform
//   branches around whole loops: a key tile that every row sees whole
//   (inside each row's window and diagonal, below S) skips the mask, and
//   without a softcap no tanh is issued.
//   Key tiles: BK = 128 keys (64 at D 256, what shared memory holds) at
//   absolute key positions 0, BK, ...; a query tile visits those from the
//   one holding its first row's window start to the one holding its last
//   row's last key.
//   Loads: one K and one V buffer, each filled by bulk copies (the copy
//   engine's cp.async.bulk) that complete on an mbarrier, one copy per key
//   row (a KV head's rows are Hkv * D elements apart): thread r < BK copies
//   K row r of a tile, thread BK + r V row r, so no thread issues more than
//   one copy a tile. K and V of the first tile are fetched together; V of
//   tile t > 0 once P.V of tile t - 1 is done, landing during the score
//   product; K of tile t + 1 once the scores of tile t are done, landing
//   during P.V. K rows and P rows are 16 bytes longer than D and BK, so the
//   8 lanes of a load phase, on 8 rows, read 8 different bank groups. V
//   rows past the tile's keys are zeroed (P is 0 there, and 0 times a stale
//   NaN would not be). An mbarrier wait that never completes traps
//   (hopper::mbar_wait) instead of hanging the card.
// Shared memory: q (f32) + K + V + P: 195 KB at f32 D 128, 210 KB at f32 D
// 256, 115 KB at f32 D 64, 131 KB at f16 D 128; one block of 8 warps an SM
// (ptxas: 168 registers at f32 D 128, 253 at D 256, no spills).
//
// Bits. dual_tenant_attention must equal flash_attention bit for bit, so
// both kernels run this one function, and every floating-point operation in
// it is an explicit round-to-nearest intrinsic that the compiler may neither
// contract nor reorder. What a row computes does not depend on its slot in
// the query tile: a score sums its D products in order; the lane that takes
// a key in the softmax, and so the order of a row's max and sum, is fixed
// by the key's place in its absolute tile, and the row's 4 lanes combine
// their parts by the same butterfly in every warp; P.V sums a tile's keys
// in order into fresh registers, then acc = acc * alpha + pv. A masked key
// gets p = 0 explicitly, and a tile that holds no key of a row leaves its
// (m, l, acc) bit for bit as they were (alpha = exp2(0) = 1, pv = 0), while
// before a row's first key (m = NEG_INF, l = acc = 0) the first key it sees
// wipes them with alpha = exp2(-1e30 - m) = 0. So a row's bits depend only
// on its own q and keys: not on the query tile, on which tiles the unit
// visits, on the batch or on the other tenant.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "dtypes.cuh"
#include "hopper.cuh"

namespace sgdrc {
namespace flash {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;
constexpr int RW = 8;                    // query rows a warp
constexpr int BQ = RW * (kThreads / 32);  // query rows a tile: 64

template <typename T, int D>
struct Geo {
  static constexpr int BK = D == 256 ? 64 : 128;  // keys a tile
  static constexpr int VK = 16 / (int)sizeof(T);  // elements in 16 bytes
  static constexpr int CN = BK / 32;              // keys a lane
  static constexpr int KS = D + VK;               // K's row stride
  static constexpr int DN = D / 32;               // output dims a lane
  static constexpr int NV = DN < VK ? DN : VK;    // adjacent dims a read
  static constexpr int VCH = DN / NV;             // reads a V row
  static constexpr int PS = BK + 4;               // P's row stride
  static constexpr int KX = BK / 16;  // 4-key chunks a lane in the softmax
  static constexpr int ROW_BYTES = D * (int)sizeof(T);
  static constexpr int Q_BYTES = BQ * D * 4;
  static constexpr int K_BYTES = BK * KS * (int)sizeof(T);
  static constexpr int V_BYTES = BK * D * (int)sizeof(T);
  static constexpr int P_BYTES = BQ * PS * 4;
  static constexpr int BAR_OFF = Q_BYTES + K_BYTES + V_BYTES + P_BYTES;
  static constexpr int SMEM = BAR_OFF + 16;  // + two mbarriers
  static_assert(2 * BK <= kThreads, "one K or V row a thread");
  static_assert(CN * 32 == BK && NV * VCH == DN, "lane tiles");
};

struct Heads {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int S, H, Hkv;
};

// What a persistent block carries from one query tile to the next: the key
// tiles loaded so far, which fix the mbarriers' phases.
struct Pipe {
  uint32_t tiles = 0;
};

// Initialise the two mbarriers once per block; every thread calls it.
template <typename T, int D>
__device__ __forceinline__ void init(uint8_t* smem) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Geo<T, D>::BAR_OFF);
  if (threadIdx.x == 0) {
    hopper::mbar_init(&bars[0], 1);
    hopper::mbar_init(&bars[1], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
}

// One query tile [q0, q0 + BQ) of head h of batch row b. `smem` (16-byte
// aligned, Geo<T, D>::SMEM bytes) is initialised by init<T, D>. The caller
// guarantees that the block's previous tile is done with shared memory (a
// __syncthreads after its last use).
template <typename T, int D>
__device__ __forceinline__ void tile(const Heads& a, int b, int h, int q0,
                                     bool causal, int window, float softcap,
                                     float scale, uint8_t* smem, Pipe& pipe) {
  using G = Geo<T, D>;
  constexpr int BK = G::BK, VK = G::VK, CN = G::CN, KS = G::KS;
  constexpr int NV = G::NV, VCH = G::VCH, PS = G::PS, KX = G::KX;
  constexpr int CPR = D / VK;
  float* q_s = reinterpret_cast<float*>(smem);
  T* k_s = reinterpret_cast<T*>(smem + G::Q_BYTES);
  T* v_s = reinterpret_cast<T*>(smem + G::Q_BYTES + G::K_BYTES);
  float* p_s = reinterpret_cast<float*>(smem + G::Q_BYTES + G::K_BYTES +
                                        G::V_BYTES);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + G::BAR_OFF);
  uint64_t* v_full = k_full + 1;

  const int S = a.S;
  const int tid = threadIdx.x, lane = tid % 32, wrow = RW * (tid / 32);
  const int hk = h / (a.H / a.Hkv);
  const int64_t q_row = (int64_t)a.H * D, kv_row = (int64_t)a.Hkv * D;
  // key tiles from the one holding the first row's window start to the one
  // holding the last row's last key
  const int t_first = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int n_tiles = (kv_end + BK - 1) / BK - t_first;

  // Loads: thread r < BK copies K row r of a tile, thread BK + r V row r;
  // the first of each sets its barrier's byte count.
  const bool loads_k = tid < BK;
  const int kk_own = loads_k ? tid : tid - BK;  // >= BK: copies nothing
  const T* src = static_cast<const T*>(loads_k ? a.k : a.v) +
                 ((int64_t)b * S * a.Hkv + hk) * D;
  T* dst = loads_k ? k_s + kk_own * KS : v_s + kk_own * D;
  uint64_t* bar = loads_k ? k_full : v_full;
  auto fetch = [&](int t) {
    const int k0 = (t_first + t) * BK, n = min(BK, kv_end - k0);
    if (kk_own == 0) hopper::mbar_expect_tx(bar, n * G::ROW_BYTES);
    if (kk_own < n)
      hopper::bulk_load(dst, src + (k0 + kk_own) * kv_row, G::ROW_BYTES, bar);
  };
  fetch(0);

  // q as f32, scaled once (rows past S: zeros), while K and V of tile 0 are
  // in flight
  const T* qg = static_cast<const T*>(a.q) + ((int64_t)b * S * a.H + h) * D;
  const float qscale = softcap > 0.f ? scale : __fmul_rn(scale, kLog2e);
  for (int i = tid; i < BQ * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR, s = q0 + r;
    float x[VK];
    if (s < S) {
      load_f32<T, VK>(qg + s * q_row + c * VK, x);
#pragma unroll
      for (int e = 0; e < VK; ++e) x[e] = __fmul_rn(x[e], qscale);
    } else {
#pragma unroll
      for (int e = 0; e < VK; ++e) x[e] = 0.f;
    }
    store_from_f32<float, VK>(q_s + r * D + c * VK, x);
  }

  // the softmax state of row wrow + lane % 8 (the same in its 4 lanes) and
  // the output dims of the warp's 8 rows
  float m = kNegInf, l = 0.f, acc[RW][VCH][NV];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int c = 0; c < VCH; ++c)
#pragma unroll
      for (int n = 0; n < NV; ++n) acc[i][c][n] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = (t_first + t) * BK;
    const uint32_t parity = (pipe.tiles + t) & 1;
    __syncthreads();  // q written; every thread is done with V and P of t - 1
    if (!loads_k && t > 0) fetch(t);
    if (t == n_tiles - 1) {
      // V rows past the keys: zeros, ordered before the bulk copies of a
      // later query tile that overwrite them
      const float zero[VK] = {};
      for (int i = (kv_end - k0) * CPR + tid; i < BK * CPR; i += kThreads)
        store_from_f32<T, VK>(v_s + i * VK, zero);
      hopper::fence_proxy_async();
    }

    // S = q K^T for the warp's 8 rows and this lane's keys, over D in order
    hopper::mbar_wait(k_full, parity);
    float s[RW][CN];
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += VK) {
      float kf[CN][VK];
#pragma unroll
      for (int j = 0; j < CN; ++j)
        load_f32<T, VK>(k_s + (lane + 32 * j) * KS + d, kf[j]);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        float qf[VK];
        load_f32<float, VK>(q_s + (wrow + i) * D + d, qf);
#pragma unroll
        for (int j = 0; j < CN; ++j)
#pragma unroll
          for (int e = 0; e < VK; ++e)
            s[i][j] = __fmaf_rn(qf[e], kf[j][e], s[i][j]);
      }
    }

    // base-2 logits to P: with a softcap, c * tanh(s / c) * log2(e)
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j)
          s[i][j] = __fmul_rn(
              __fmul_rn(softcap, tanhf(__fdiv_rn(s[i][j], softcap))), kLog2e);
    }
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        p_s[(wrow + i) * PS + lane + 32 * j] = s[i][j];
    __syncwarp();

    // online softmax: lane (g, r) = (lane / 8, lane % 8) takes row wrow + r,
    // its 4-key chunks g + 4x (x < KX), and the row's 4 lanes combine by xor
    // 8 and 16; a tile that every row sees whole (inside each row's window
    // and diagonal, below S) skips the mask
    float* prow = p_s + (wrow + lane % 8) * PS + 4 * (lane / 8);
    float x[KX][4];
#pragma unroll
    for (int c = 0; c < KX; ++c) load_f32<float, 4>(prow + 16 * c, x[c]);
    const int qp = q0 + wrow + lane % 8;
    const int lo = window > 0 ? qp - window + 1 : 0;
    const int hi = causal ? min(qp, S - 1) : S - 1;
    const int kp0 = k0 + 4 * (lane / 8);
    auto seen = [&](int c, int e) {
      const int kp = kp0 + 16 * c + e;
      return kp >= lo && kp <= hi;
    };
    float m_new, sum = 0.f;
    auto reduce = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < KX; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx = fmaxf(mx, !kMasked || seen(c, e) ? x[c][e] : kNegInf);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      m_new = fmaxf(m, mx);
#pragma unroll
      for (int c = 0; c < KX; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[c][e] = !kMasked || seen(c, e)
                        ? exp2f(__fsub_rn(x[c][e], m_new))
                        : 0.f;
          sum = __fadd_rn(sum, x[c][e]);
        }
        store_from_f32<float, 4>(prow + 16 * c, x[c]);
      }
    };
    if (k0 + BK > S || (causal && k0 + BK - 1 > q0) ||
        (window > 0 && k0 <= q0 + BQ - 1 - window))
      reduce(std::true_type{});
    else
      reduce(std::false_type{});
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 8));
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 16));
    const float a_own = exp2f(__fsub_rn(m, m_new));
    l = __fmaf_rn(l, a_own, sum);
    m = m_new;
    float alpha[RW];  // of the warp's rows, from lane i of row i
#pragma unroll
    for (int i = 0; i < RW; ++i)
      alpha[i] = __shfl_sync(0xffffffffu, a_own, i);
    __syncthreads();  // P written; every thread is done with K of tile t
    if (loads_k && t + 1 < n_tiles) fetch(t + 1);

    // pv = P V for the warp's 8 rows and this lane's head dims, over the
    // tile's keys in order; then acc = acc * alpha + pv
    hopper::mbar_wait(v_full, parity);
    float pv[RW][VCH][NV];
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int c = 0; c < VCH; ++c)
#pragma unroll
        for (int n = 0; n < NV; ++n) pv[i][c][n] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      float pf[RW][4];
#pragma unroll
      for (int i = 0; i < RW; ++i)
        load_f32<float, 4>(p_s + (wrow + i) * PS + kk, pf[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vf[VCH][NV];
#pragma unroll
        for (int c = 0; c < VCH; ++c)
          load_f32<T, NV>(v_s + (kk + e) * D + (lane + 32 * c) * NV, vf[c]);
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
          for (int c = 0; c < VCH; ++c)
#pragma unroll
            for (int n = 0; n < NV; ++n)
              pv[i][c][n] = __fmaf_rn(pf[i][e], vf[c][n], pv[i][c][n]);
      }
    }
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int c = 0; c < VCH; ++c)
#pragma unroll
        for (int n = 0; n < NV; ++n)
          acc[i][c][n] = __fmaf_rn(acc[i][c][n], alpha[i], pv[i][c][n]);
  }
  pipe.tiles += n_tiles;

  // out = acc / max(l, 1e-30), rounded once to T
  T* ob = static_cast<T*>(a.out) + ((int64_t)b * S * a.H + h) * D;
  const float den_own = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int qp = q0 + wrow + i;
    const float den = __shfl_sync(0xffffffffu, den_own, i);
    if (qp >= S) continue;
#pragma unroll
    for (int c = 0; c < VCH; ++c) {
      float y[NV];
#pragma unroll
      for (int n = 0; n < NV; ++n) y[n] = __fdiv_rn(acc[i][c][n], den);
      store_from_f32<T, NV>(ob + qp * q_row + (lane + 32 * c) * NV, y);
    }
  }
}

// Calls f(Dim<D>{}) for a supported head dim; f returns cudaError_t.
template <int D>
struct Dim {
  static constexpr int value = D;
};

template <typename F>
cudaError_t with_head_dim(int D, F&& f) {
  switch (D) {
    case 64:
      return f(Dim<64>{});
    case 128:
      return f(Dim<128>{});
    case 256:
      return f(Dim<256>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory above 48 KB must be allowed once per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace flash
}  // namespace sgdrc
