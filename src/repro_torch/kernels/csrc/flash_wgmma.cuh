// The bf16 tile body of GQA self-attention on Hopper tensor cores, shared by
// flash_attention.cu and dual_tenant_attention.cu (the "wgmma" route; f32
// and f16 take flash_simt.cuh's CUDA-core body, the "simt" route).
//
// What it computes is flash_simt.cuh's tile, for a query tile of BQ = 128
// rows: GQA, causal or not, local window, logit softcap, the scale D^-0.5
// on the f32 scores, the finite NEG_INF = -1e30, acc / max(l, 1e-30), the
// same key-tile range (first row's window start to last row's diagonal).
//
// Design. 256 threads = two consumer warpgroups, each owning 64 query rows
// of the tile; both share every K/V tile, so a key is read from shared
// memory once for 128 query rows.
//   Loads: TMA (cp.async.bulk.tensor.4d) over 4-D tensor maps of [B, S,
//   H or Hkv, D] with 128-byte swizzle, so a box past S reads zeros, never
//   the next batch row's keys. Boxes are 64 wide, so a row of D takes D/64
//   boxes. Q is loaded once per tile; K and V go through a ring of STAGES
//   stages with a full and an empty mbarrier each. Thread 0 is the
//   producer: it refills a stage as soon as all eight warps released it.
//   S = Q K^T: wgmma m64nBKk16, Q and K K-major from shared memory, f32
//   accumulators in registers.
//   Softmax: online, in registers on the accumulator fragment; a row's
//   values sit in the 4 lanes of a quad (two xor shuffles). Everything
//   outside the wgmma (scale, softcap, mask, max, exp, sum, rescale, final
//   divide) is an explicit round-to-nearest intrinsic, so two kernels that
//   inline this function produce the same bits.
//   O += P V: P rounded once to bf16 (__float2bfloat16_rn) into the register
//   A operand of wgmma m64nDk16 (two n128 halves at D 256); V is the
//   MN-major B operand straight from the TMA tile (trans-b), never copied.
//   Tiles that no mask touches skip the mask: masking them changes no bit.
// Tile traits (shared memory = Q + STAGES * (K + V), all bf16):
//   D 64:  BK 128, 2 stages,  80 KB; S 64 + O 32 accumulator registers
//   D 128: BK 128, 2 stages, 160 KB; S 64 + O 64
//   D 256: BK  64, 2 stages, 192 KB; S 32 + O 128 (BK 64 keeps S and P in
//          registers beside the 128-register O; 192 KB leaves no room for
//          a third stage)
// One block per SM; 256 threads may each hold up to 255 registers.
#pragma once

#include <stdint.h>

#include "flash_simt.cuh"
#include "hopper.cuh"

namespace sgdrc {
namespace flash {
namespace wg {

using namespace sgdrc::hopper;

constexpr int kThreads = 256;
constexpr int BQ = 128;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int BK = D == 256 ? 64 : 128;
  static constexpr int STAGES = 2;
  static constexpr int CH = D / 64;                  // 64-wide chunks a row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;        // one of K or V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  // + barriers (q_full, full[STAGES], empty[STAGES]) + 1024 for alignment
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

// TMA descriptors of one tenant's q, k, v ([B, S, H or Hkv, D], boxes
// {64, 1, rows, 1}) and its output.
struct Maps {
  const CUtensorMap* q;
  const CUtensorMap* k;
  const CUtensorMap* v;
  void* out;
  int S, H, Hkv;
};

// Per-block counters that carry the barriers' phases from one tile to the
// next (a persistent block runs many tiles).
struct Pipe {
  uint32_t kv = 0;     // K/V tiles loaded so far
  uint32_t units = 0;  // query tiles run so far
};

// Initialise the barriers once per block; every thread calls it.
template <int D>
__device__ __forceinline__ void init(uint8_t* smem) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Tile<D>::BAR_OFF);
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    for (int s = 0; s < Tile<D>::STAGES; ++s) {
      mbar_init(&bars[1 + s], 1);
      mbar_init(&bars[1 + Tile<D>::STAGES + s], kThreads / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// One query tile [q0, q0 + BQ) of head h of batch row b. `smem` is
// 1024-byte aligned and initialised by init<D>. The caller guarantees that
// the block's previous tile is done with shared memory (a __syncthreads
// after its last use).
template <int D>
__device__ __forceinline__ void tile(const Maps& a, int b, int h, int q0,
                                     bool causal, int window, float softcap,
                                     float scale, uint8_t* smem, Pipe& pipe) {
  using T = Tile<D>;
  constexpr int BK = T::BK, STAGES = T::STAGES, CH = T::CH;
  constexpr int NS = BK / 2;               // score registers a thread
  constexpr int NO = D / 2;                // output registers a thread
  uint8_t* q_s = smem;
  uint8_t* kv_s = smem + T::Q_BYTES;       // stage s: K at s*STAGE, V after
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* q_full = &bars[0];
  uint64_t* full = &bars[1];
  uint64_t* empty = &bars[1 + STAGES];

  const int S = a.S;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4;
  const int hk = h / (a.H / a.Hkv);
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_first = kv_begin / BK * BK;
  const int n_tiles = (kv_end - k_first + BK - 1) / BK;

  auto produce = [&](int t) {  // thread 0 only: K/V tile t into its stage
    const uint32_t g = pipe.kv + t;
    const int st = g % STAGES;
    if (g >= STAGES) mbar_wait(&empty[st], ((g / STAGES) & 1) ^ 1);
    mbar_expect_tx(&full[st], T::STAGE_BYTES);
    uint8_t* k_dst = kv_s + st * T::STAGE_BYTES;
    const int k0 = k_first + t * BK;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      tma_load_4d(k_dst + c * BK * 128, a.k, &full[st], c * 64, hk, k0, b);
      tma_load_4d(k_dst + T::KV_BYTES + c * BK * 128, a.v, &full[st], c * 64,
                  hk, k0, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
    for (int c = 0; c < CH; ++c)
      tma_load_4d(q_s + c * BQ * 128, a.q, q_full, c * 64, h, q0, b);
    for (int t = 0; t < min(STAGES, n_tiles); ++t) produce(t);
  }
  __syncwarp();

  // rows of this thread: r0 and r0 + 8 of the block's query tile
  const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4;
  const int qp0 = q0 + r0, qp1 = qp0 + 8;
  const int cq = 2 * (lane % 4);  // first of the thread's two columns
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  const uint32_t q_addr = smem_u32(q_s) + wg * 64 * 128;
  mbar_wait(q_full, pipe.units & 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_first + t * BK;
    const uint32_t g = pipe.kv + t;
    const int st = g % STAGES;
    const uint32_t k_addr = smem_u32(kv_s + st * T::STAGE_BYTES);
    const uint32_t v_addr = k_addr + T::KV_BYTES;
    mbar_wait(&full[st], (g / STAGES) & 1);

    // S = Q K^T over D in k16 steps (the first overwrites s: scale-d 0)
    float s[NS];
    fence_regs<NS>(s);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const uint32_t off = (kd % 4) * 32;  // k16 step in a 64-wide chunk
      const uint64_t da =
          desc_sw128(q_addr + (kd / 4) * BQ * 128 + off, 16, 1024);
      const uint64_t db =
          desc_sw128(k_addr + (kd / 4) * BK * 128 + off, 16, 1024);
      if constexpr (BK == 128)
        wgmma_ss_n128<0>(s, da, db, kd > 0);
      else
        wgmma_ss_n64<0>(s, da, db, kd > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NS>(s);

    // scale, softcap, mask; s[4j + e] is row r0 (e < 2) or r0 + 8, key
    // k0 + 8j + cq + e % 2
    const bool need_mask = k0 + BK > S || (causal && k0 + BK - 1 > q0) ||
                           (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float x = __fmul_rn(s[i], scale);
      if (softcap > 0.f) x = __fmul_rn(softcap, tanhf(__fdiv_rn(x, softcap)));
      if (need_mask) {
        const int qp = (i % 4) < 2 ? qp0 : qp1;
        const int kp = k0 + 8 * (i / 4) + cq + (i % 2);
        const bool ok = kp < S && (!causal || kp <= qp) &&
                        (window <= 0 || kp > qp - window);
        x = ok ? x : kNegInf;
      }
      s[i] = x;
    }
    // online softmax, per row
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          const float p = exp2f(__fmul_rn(__fsub_rn(s[i], m_new), kLog2e));
          s[i] = p;
          sum = __fadd_rn(sum, p);
        }
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
      alpha[r] = exp2f(__fmul_rn(__fsub_rn(m[r], m_new), kLog2e));
      l[r] = __fmaf_rn(l[r], alpha[r], sum);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = __fmul_rn(o[i], alpha[(i % 4) / 2]);
    // P as the A operand: k16 step kk covers keys 16kk.. = n8 blocks 2kk,
    // 2kk + 1 of the score fragment
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const float* lo = s + 8 * kk;
      pf[kk][0] = pack_bf16(lo[0], lo[1]);
      pf[kk][1] = pack_bf16(lo[2], lo[3]);
      pf[kk][2] = pack_bf16(lo[4], lo[5]);
      pf[kk][3] = pack_bf16(lo[6], lo[7]);
    }

    // O += P V over the tile's keys in k16 steps
    fence_regs<NO>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t vk = v_addr + kk * 16 * 128;
      if constexpr (D == 64) {
        wgmma_rs_n64<1>(o, pf[kk], desc_sw128(vk, BK * 128, 1024));
      } else {
#pragma unroll
        for (int nh = 0; nh < D / 128; ++nh)
          wgmma_rs_n128<1>(o + 64 * nh, pf[kk],
                           desc_sw128(vk + nh * 2 * BK * 128, BK * 128, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NO>(o);

    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (tid == 0 && t + STAGES < n_tiles) produce(t + STAGES);
    __syncwarp();
  }
  pipe.kv += n_tiles;
  pipe.units += 1;

  // out = acc / max(l, 1e-30), rounded once to bf16
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out) +
                      ((int64_t)b * S * a.H + h) * D;
  const int64_t row = (int64_t)a.H * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r == 0 ? qp0 : qp1;
    if (qp >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(ob + qp * row + 8 * j + cq) =
          __floats2bfloat162_rn(__fdiv_rn(o[i], den),
                                __fdiv_rn(o[i + 1], den));
    }
  }
}

// The tensor map of one of q, k, v: [B, S, Hx, D] bf16, boxes {64, 1, rows,
// 1}.
inline cudaError_t make_heads_map(CUtensorMap* map, const void* base, int B,
                                  int S, int Hx, int D, int rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)Hx, (uint64_t)S,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)Hx * D * 2,
                               (uint64_t)S * Hx * D * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return hopper::make_map(map, base, 4, dims, strides, box);
}

}  // namespace wg

// Launch parameters of a route's tile body for element type T and head dim
// D, which both flash_attention.cu and dual_tenant_attention.cu read:
// threads a block, query rows a tile (the same for every T of a route),
// dynamic shared memory bytes.
struct Launch {
  int threads, rows, smem;
};

template <typename T, int D>
constexpr Launch launch(bool wgmma) {
  return wgmma ? Launch{wg::kThreads, wg::BQ, wg::Tile<D>::SMEM}
               : Launch{kThreads, BQ, Geo<T, D>::SMEM};
}
}  // namespace flash
}  // namespace sgdrc
