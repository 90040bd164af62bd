// The bf16 tile body of chunked-prefill attention on Hopper tensor cores: the
// "wgmma" route of prefill_attention.cu, for bf16 at head dims 64 and 128
// (f32, f16, and bf16 at D 32 take prefill_simt.cuh's CUDA-core body, the
// "simt" route).
//
// Replaces, with prefill_simt.cuh, the Pallas online-softmax body of
//   src/repro/kernels/prefill_attention.py (_kernel, prefill_attention[_paged])
// and computes the contract stated in prefill_args.cuh.
//
// What bounds it on the card: operations. A chunk of Sq tokens does 4 * D
// flops per visible (query row, key) pair against 4 * D bytes of K and V per
// key, shared by all Sq * G rows: at phase 3's shapes ~100-500 flops a byte,
// above the H100's ~295 ridge for the long rows that dominate.
//
// Design.
//   Unit = (b, KV head h, query tile of BQ = 128 flattened rows). With q
//   contiguous the G heads of one position are adjacent, so a tile is 128 / G
//   positions times G heads in row order. Two consumer warpgroups of 64
//   rows each, as flash_wgmma.cuh has them, share every K/V tile, and a
//   third, producer warpgroup loads the tiles. The grid is (B * Hkv, query
//   tiles), and a block takes query tile n - 1 - blockIdx.y, so the last
//   tiles of each (b, h), the longest rows, start first; the order comes
//   from blockIdx alone (the host never reads pos).
//   Key tiles of BK = 128 keys sit at absolute key positions 0, 128, ...,
//   never placed relative to pos. A unit visits the tiles up to its last
//   row's last key (min(pos + min(last row / G, cap - 1), window - 1)); a
//   warpgroup stops at its own last key, and one whose rows all lie past cap
//   or past Sq * G runs no wgmma (it still joins every barrier). A masked
//   key gets the score NEG_INF, so p = 0 and alpha = exp2(0) = 1: a tile
//   that holds no key of a row leaves the row's (m, l, acc) bit for bit as
//   they were. Tile 0 holds key 0, which every live row sees. So a row's bits
//   depend only on its own q and keys: not on where its chunk starts, on the
//   abort cap of the rows after it, or on the batch.
//   Loads: the producer warpgroup starts 16-byte cp.async copies (no TMA:
//   a paged gather would need a box per page, and encoding tensor maps
//   costs host time on every call) into the 128-byte-swizzled layout the
//   wgmma descriptors of hopper.cuh read, K-major for Q and K, MN-major
//   (the same bytes, read transposed) for V. A thread that starts cp.async
//   copies stalls until the memory system takes them, so no consumer
//   starts any, and it takes four warps, not one, to keep enough copies in
//   flight. K/V go through a ring of stages with a full and an empty
//   mbarrier each: each producer thread's copies arrive on the full barrier
//   when they land (cp.async.mbarrier.arrive), every consumer warp arrives
//   on the empty one when it is done with the tile. For a page pool the
//   producer reads each key's page-table entry two tiles ahead and
//   publishes the tile's entries in shared memory, so no copy waits on the
//   table. Keys past the unit's range are zero-filled (src-size 0) and
//   never addressed, nor is a page-table column past the last one a row
//   needs.
//   Compute, as flash_wgmma.cuh's tile: S = Q K^T with wgmma m64n128k16, f32
//   accumulators, the scale D^-0.5 on the f32 scores; the mask per flattened
//   row, skipped on tiles no mask touches (masking them changes no bit);
//   online softmax in registers with explicit round-to-nearest intrinsics;
//   P rounded once to bf16 into the register A operand of wgmma m64nDk16,
//   V MN-major from shared memory; out = acc / max(l, 1e-30) stored through
//   out's strides.
// Shared memory: Q + STAGES * (K + V) + 1 KB of page-table entries: 3
// stages, 225 KB at D 128; 4 stages, 145 KB at D 64. One block an SM: 384
// threads start at 168 registers each; the producer gives some back
// (setmaxnreg) so that the consumers hold their score and output tiles.
#pragma once

#include <stdint.h>

#include "hopper.cuh"
#include "prefill_args.cuh"

namespace sgdrc {
namespace prefill {

using namespace sgdrc::hopper;

constexpr int kConsumers = 256;  // two warpgroups of 64 query rows each
constexpr int kProducers = 128;  // one warpgroup that loads
constexpr int kThreads = kConsumers + kProducers;
constexpr int kConsumerWarps = kConsumers / 32;
// registers a thread: 384 threads start at 168 (65536 / 384); the producer
// gives back what the consumers' score and output tiles need
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
static_assert(kProducers * kProducerRegs + kConsumers * kConsumerRegs <= 65536,
              "registers over the SM's file");
constexpr int BQ = 128;  // flattened query rows a unit
constexpr int BK = 128;  // keys a tile, at absolute positions
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int STAGES = D == 128 ? 3 : 4;
  static constexpr int CPR = D / 8;                  // 16-byte chunks a row
  static constexpr int RPP = kProducers / CPR;       // rows a load pass
  static constexpr int KPT = BK / RPP;               // keys a thread loads
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;        // one of K or V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // the page-table entries of two tiles' keys, one int a key
  static constexpr int PAGE_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = PAGE_OFF + 2 * BK * 4;
  // + barriers (q_full, full[STAGES], empty[STAGES]) + 1024 for alignment
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

// The producer warpgroup's own barrier (0 is __syncthreads).
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers) : "memory");
}

// The producer warpgroup: Q once, then each K/V tile into its ring stage
// once both consumer warpgroups have released the stage. Thread p copies
// 16-byte chunk p % CPR of the rows p / CPR + i * RPP; its copies arrive on
// the stage's full barrier when they land. For a page pool, thread p reads
// the page-table entry of key p of a tile two tiles ahead and publishes it
// in shared memory for the tile's copies, so no copy waits on the table.
template <int D>
__device__ __forceinline__ void produce(const AttnArgs& a, int b, int h,
                                       int row0, int G, int n_keys,
                                       int n_tiles, uint8_t* smem,
                                       uint64_t* bars) {
  using T = Tile<D>;
  constexpr int STAGES = T::STAGES, CPR = T::CPR, RPP = T::RPP;
  constexpr int KPT = T::KPT;
  static_assert(kProducers == BK, "one page-table entry a producer thread");
  const int p = threadIdx.x - kConsumers;
  const int jc = p % CPR, r_first = p / CPR;
  const int n_rows = a.Sq * G;
  uint64_t* q_full = &bars[0];
  uint64_t* full = &bars[1];
  uint64_t* empty = &bars[1 + STAGES];
  int* pages = reinterpret_cast<int*>(smem + T::PAGE_OFF);  // [2][BK]

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q);
  for (int r = r_first; r < BQ; r += RPP) {
    const int row = row0 + r;
    const bool ok = row < n_rows;  // rows past the chunk: zeros
    int64_t off = 0;
    if (ok)
      off = b * a.q_sb + (row / G) * a.q_ss +
            (int64_t)(h * G + row % G) * a.q_sh;
    cp_async16(smem + sw128_offset(BQ, r, jc), qg + off + jc * 8, ok);
  }
  cp_async_mbar_arrive(q_full);

  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v);
  const bool paged = a.page_table != nullptr;
  const int* pt_row = paged ? a.page_table + (int64_t)b * a.pt_stride : nullptr;
  const int ps = a.page_size;
  const int ps_shift = (paged && (ps & (ps - 1)) == 0) ? __ffs(ps) - 1 : -1;
  // the entry of key p of `tile` (0 past the unit's keys: never read)
  auto entry_of = [&](int tile) {
    const int t = tile * BK + p;
    if (t >= n_keys) return 0;
    return pt_row[ps_shift >= 0 ? t >> ps_shift : t / ps];
  };
  int cur = 0, nxt = 0;  // entries of tiles t and t + 1
  if (paged) {
    cur = entry_of(0);
    if (n_tiles > 1) nxt = entry_of(1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const int* pg_t = pages + (t & 1) * BK;
    if (paged) {
      pages[(t & 1) * BK + p] = cur;
      producer_sync();
      cur = nxt;
      if (t + 2 < n_tiles) nxt = entry_of(t + 2);
    }
    if (t >= STAGES) mbar_wait(&empty[st], ((t / STAGES) & 1) ^ 1);
    uint8_t* ks = smem + T::Q_BYTES + st * T::STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kk = r_first + i * RPP, tk = t * BK + kk;
      const bool ok = tk < n_keys;  // past it: zeros, never addressed
      int64_t ko = 0, vo = 0;
      if (ok) {
        if (paged) {
          const int pg = min(max(pg_t[kk], 0), a.n_pages - 1);
          const int off =
              ps_shift >= 0 ? tk & (ps - 1) : tk - (tk / ps) * ps;
          ko = pg * a.k_s0 + h * a.k_sh + off * a.k_ss;
          vo = pg * a.v_s0 + h * a.v_sh + off * a.v_ss;
        } else {
          ko = b * a.k_s0 + h * a.k_sh + tk * a.k_ss;
          vo = b * a.v_s0 + h * a.v_sh + tk * a.v_ss;
        }
      }
      const uint32_t o = sw128_offset(BK, kk, jc);
      cp_async16(ks + o, kg + ko + jc * 8, ok);
      cp_async16(ks + T::KV_BYTES + o, vg + vo + jc * 8, ok);
    }
    cp_async_mbar_arrive(&full[st]);
  }
  cp_async_commit();
  cp_async_wait<0>();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    prefill_wgmma_kernel(const AttnArgs a) {
  using T = Tile<D>;
  constexpr int STAGES = T::STAGES;
  constexpr int NS = BK / 2;  // score registers a thread
  constexpr int NO = D / 2;   // output registers a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* kv_s = q_s + T::Q_BYTES;  // stage s: K at s * STAGE, V after
  uint64_t* bars = reinterpret_cast<uint64_t*>(q_s + T::BAR_OFF);
  uint64_t* q_full = &bars[0];
  uint64_t* full = &bars[1];
  uint64_t* empty = &bars[1 + STAGES];

  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / a.Hkv, h = blockIdx.x % a.Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4;
  const int G = a.H / a.Hkv;
  const int n_rows = a.Sq * G;
  const int row0 = qt * BQ;
  const int pos = a.pos[b];
  const int cap = min(max(a.abort ? a.abort[b] : a.Sq, 0), a.Sq);
  const int n_keys = keys_seen(a, pos, cap, G, row0, row0 + BQ);
  const int n_tiles = (n_keys + BK - 1) / BK;

  if (tid == 0) {
    if (a.progress != nullptr && qt == 0 && h == 0) a.progress[b] = cap;
    mbar_init(q_full, kProducers);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], kProducers);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();  // the last block-wide barrier: the roles part here
  if (wg == 2) {
    regs_dec<kProducerRegs>();
    if (n_tiles > 0) produce<D>(a, b, h, row0, G, n_keys, n_tiles, q_s, bars);
    return;
  }
  regs_inc<kConsumerRegs>();

  const int wg_row0 = row0 + 64 * wg;
  const int wg_keys = keys_seen(a, pos, cap, G, wg_row0, wg_row0 + 64);
  // every row of the warpgroup live: a tile whose keys all lie at or before
  // its first row's position (and inside the window) needs no mask
  const bool wg_live = wg_row0 + 64 <= n_rows && (wg_row0 + 63) / G < cap;
  const int wg_first = pos + wg_row0 / G;

  // rows of this thread: r0 and r0 + 8 of the unit's tile (the layout of an
  // m64 accumulator fragment); a row that may see no key gets kNoPos
  const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4;
  int qp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r0 + 8 * r;
    qp[r] = (row < n_rows && row / G < cap) ? pos + row / G : kNoPos;
  }
  const int cq = 2 * (lane % 4);  // first of the thread's two columns
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  const uint32_t q_addr = smem_u32(q_s) + wg * 64 * 128;
  if (n_tiles > 0) mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES, k0 = t * BK;
    mbar_wait(&full[st], (t / STAGES) & 1);
    fence_proxy_async();  // the copies (generic proxy) before wgmma reads
    if (k0 < wg_keys) {   // uniform over the warpgroup
      const uint32_t k_addr = smem_u32(kv_s + st * T::STAGE_BYTES);
      const uint32_t v_addr = k_addr + T::KV_BYTES;

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
        wgmma_ss_n128<0>(s, da, db, kd > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NS>(s);

      // scale and mask; s[4j + e] is row r0 (e < 2) or r0 + 8, key
      // k0 + 8j + cq + e % 2
      const bool need_mask =
          !wg_live || k0 + BK - 1 > wg_first || k0 + BK > a.window;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float x = __fmul_rn(s[i], a.scale);
        if (need_mask) {
          const int kp = k0 + 8 * (i / 4) + cq + (i % 2);
          x = (kp <= qp[(i % 4) / 2] && kp < a.window) ? x : kNegInf;
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
        const uint64_t dv =
            desc_sw128(v_addr + kk * 16 * 128, BK * 128, 1024);
        if constexpr (D == 64)
          wgmma_rs_n64<1>(o, pf[kk], dv);
        else
          wgmma_rs_n128<1>(o, pf[kk], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NO>(o);
    }
    // every consumer warp waits for and releases every tile, so the
    // ring's phases stay in step where a warpgroup has nothing to compute
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // out = acc / max(l, 1e-30), rounded once to bf16; a row that saw no key
  // (no tile, or a skipped warpgroup) writes zeros
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r0 + 8 * r;
    if (row >= n_rows) continue;
    __nv_bfloat16* orow = ob + b * a.o_sb + (row / G) * a.o_ss +
                          (int64_t)(h * G + row % G) * a.o_sh;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) =
          __floats2bfloat162_rn(__fdiv_rn(o[i], den),
                                __fdiv_rn(o[i + 1], den));
    }
  }
}

// Launch the wgmma body for head dim D on `stream`.
template <int D>
cudaError_t launch(const AttnArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      prefill_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<D>::SMEM);
  if (err != cudaSuccess) return err;
  const int G = a.H / a.Hkv;
  const dim3 grid(a.B * a.Hkv, (a.Sq * G + BQ - 1) / BQ);
  prefill_wgmma_kernel<D><<<grid, kThreads, Tile<D>::SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace prefill
}  // namespace sgdrc
