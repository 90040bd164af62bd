// The CUDA-core tile body of chunked-prefill attention: the "simt" route of
// prefill_attention.cu, for f32 and f16 at head dims 32, 64 and 128 and bf16
// at 32 (bf16 at 64 and 128 takes the tensor-core body of prefill_wgmma.cuh,
// which computes the same contract). f32 stays on CUDA cores because TF32
// would break its 2e-5 tolerance.
//
// Replaces, with prefill_wgmma.cuh, the Pallas online-softmax body of
//   src/repro/kernels/prefill_attention.py (_kernel, prefill_attention[_paged])
// and computes the contract stated in prefill_args.cuh.
//
// What bounds it on the card: operations. 4 * D flops per visible (query
// row, key) pair, all f32 FMAs (67 TFLOP/s on an H100), against 4 * D bytes
// of K and V per key shared by the chunk's Sq * G rows. Feeding every FMA
// from shared memory caps it far below that (shared memory delivers 128
// bytes a cycle to an SM's 128 FMA lanes), so the design feeds the FMAs
// from register tiles:
//   Unit = (b, KV head h, query tile of BQ = 64 flattened rows), 256
//   threads, one block a unit. Blocks start in index order, and block u
//   takes the units of the batch row of rank u / (query tiles * Hkv) when
//   the rows are ordered by their length (row_of_rank: read from pos and
//   abort on the card, never on the host), last query tile first. So the
//   longest units start first and the short ones fill in behind them (with
//   the query tiles outermost, a short row's units share the first wave
//   with the long ones, and the long ones end late). Key tiles of BK = 128
//   keys sit at absolute key positions 0, 128, ...; a unit visits the
//   tiles up to its last row's last key.
//   Threads: warp w holds the unit's rows 8w .. 8w + 7, and lane = 16 *
//   half + kg. For the scores, lane (half, kg) sums the products of the
//   warp's 8 rows and the keys kg + 16 j (j < 8) over its half of D; lanes
//   l and l ^ 16 then add their halves, each keeping 4 of the 8 rows (8w +
//   4 half + i). For P.V, lane (half, kg) sums the 8 rows times head-dim
//   group kg (D / 16 dims) over its half of the tile's keys, and the halves
//   are added the same way. So a thread holds 4 rows' softmax state and
//   their D / 16 head dims of the output in registers for the unit's life,
//   and a row's max and sum are four xor shuffles over the 16 lanes of its
//   half. Both products read 16-byte vectors and do 1 byte of
//   shared-memory loads an FMA in f32 (a 4 x 4 tile a thread does 2, and
//   the 16-row block with one (row, key) a thread did 8). q is held in
//   shared memory as f32, scaled by D^-0.5 * log2(e) once (the softmax is
//   in base 2, exp2f, as decode_attention.cu's); K and V stay in the input
//   type and widen at use. The score loop of key group kg walks its half of
//   D in chunks of 4 elements from chunk kg on, so the lanes of a load
//   phase read different bank groups of K's unpadded rows. P goes through
//   shared memory (row stride BK + 4 floats: the two halves of a warp
//   write rows 4 apart, on other banks).
//   Loads: one K and one V buffer, each filled by bulk copies (the copy
//   engine's cp.async.bulk: no tensor map, so any strides and a page table)
//   that complete on an mbarrier: one copy per run of key rows adjacent in
//   memory (a page, at most 32 rows), one per row where rows are not
//   adjacent. Thread r < BK looks after K row r of a tile and thread BK + r
//   after V row r, so no thread issues more than one copy a tile (a thread
//   that issues many 16-byte cp.async copies stalls until they are taken).
//   V of tile t is fetched once P.V of tile t - 1 is done and lands during
//   the score product; K of tile t + 1 once the scores of tile t are done,
//   and lands during P.V. For a page pool each thread reads its row's
//   entry a tile ahead. V rows past the unit's keys are zeroed (P is 0
//   there, and 0 times a stale NaN would not be).
// Shared memory: q + K + V + P: 193 KB at f32 D 128 (one block an SM), 113
// KB at f32 D 64, 129 KB at f16 D 128. Registers: ptxas gives every
// instance 238-254 (no spills), so one block an SM in any case.
//
// Bits. Every floating-point operation is an explicit round-to-nearest
// intrinsic, and what a row computes does not depend on its slot in the
// unit: a score sums each half of its D products in an order set by the
// key's key group, then adds the halves (IEEE addition commutes, so both
// lanes of a pair get the same bits); a row's max and sum run over the key
// groups, whose keys are fixed by the key's place in its absolute tile, by
// the same butterfly in every half-warp; P.V sums each half of the tile's
// keys in key order into fresh registers, adds the halves, then acc = acc
// * alpha + pv. A masked key gets p = 0 explicitly, and a tile that holds
// no key of a row leaves its (m, l, acc) bit for bit as they were (alpha =
// exp2(0) = 1, pv = 0). Tile 0 holds key 0, which every live row sees. So a
// row's bits depend only on its own q and keys: not on where its chunk
// starts, on the abort cap of the rows after it, or on the batch.
#pragma once

#include <stdint.h>

#include "hopper.cuh"
#include "prefill_args.cuh"

namespace sgdrc {
namespace simt {

using hopper::bulk_load;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_init_fence;
using hopper::mbar_wait;

constexpr int kThreads = 256;
constexpr int BQ = 64;    // flattened query rows a unit
constexpr int BK = 128;   // keys a tile, at absolute positions
constexpr int kWarpRows = BQ / (kThreads / 32);  // rows a warp: 8
constexpr int kGroups = 16;        // key groups, and head-dim groups
constexpr int RM = kWarpRows / 2;  // rows a thread owns
constexpr int CN = BK / kGroups;   // keys a thread
constexpr int PS = BK + 4;         // P's row stride, floats
constexpr int kRun = 32;           // rows a bulk copy at most
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Geo {
  static constexpr int VK = 16 / sizeof(T);       // elements in 16 bytes
  static constexpr int CPR = D / VK;              // 16-byte chunks a row
  static constexpr int HC = D / 8;                // 4-element chunks in D / 2
  static constexpr int ROW_BYTES = D * (int)sizeof(T);
  // output columns: chunks of NV adjacent head dims, chunk kg + 16 c
  static constexpr int NV = D / kGroups < VK ? D / kGroups : VK;
  static constexpr int VCH = D / kGroups / NV;
  static constexpr int Q_BYTES = BQ * D * 4;
  static constexpr int K_BYTES = BK * D * (int)sizeof(T);
  static constexpr int V_BYTES = BK * D * (int)sizeof(T);
  static constexpr int P_BYTES = BQ * PS * 4;
  static constexpr int BAR_OFF = Q_BYTES + K_BYTES + V_BYTES + P_BYTES;
  static constexpr int SMEM = BAR_OFF + 16;  // + two mbarriers
  static_assert(VCH >= 1 && NV * VCH * kGroups == D, "output columns");
  static_assert((HC & (HC - 1)) == 0, "a power-of-two count of chunks");
};

// The batch row of rank r when the rows are ordered by the keys their last
// live position sees, most first (ties by row index). Every block computes
// the same order from pos and abort, so the units of the longest rows start
// first, whatever the batch's order.
__device__ __forceinline__ int row_of_rank(const AttnArgs& a, int G, int r) {
  __shared__ int row;
  auto weight = [&](int j) {
    const int cap = min(max(a.abort ? a.abort[j] : a.Sq, 0), a.Sq);
    return keys_seen(a, a.pos[j], cap, G, 0, a.Sq * G);
  };
  for (int j = threadIdx.x; j < a.B; j += blockDim.x) {
    const int wj = weight(j);
    int rank = 0;
    for (int i = 0; i < a.B; ++i) {
      const int wi = weight(i);
      rank += wi > wj || (wi == wj && i < j);
    }
    if (rank == r) row = j;
  }
  __syncthreads();
  return row;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    prefill_simt_kernel(const AttnArgs a) {
  using Gm = Geo<T, D>;
  constexpr int VK = Gm::VK, CPR = Gm::CPR, HC = Gm::HC;
  constexpr int NV = Gm::NV, VCH = Gm::VCH, ROW_BYTES = Gm::ROW_BYTES;
  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  T* k_s = reinterpret_cast<T*>(smem + Gm::Q_BYTES);
  T* v_s = reinterpret_cast<T*>(smem + Gm::Q_BYTES + Gm::K_BYTES);
  float* p_s =
      reinterpret_cast<float*>(smem + Gm::Q_BYTES + Gm::K_BYTES + Gm::V_BYTES);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + Gm::BAR_OFF);
  uint64_t* v_full = k_full + 1;

  // block -> unit: the batch rows by rank, then query tiles last first,
  // then KV heads
  const int G = a.H / a.Hkv;
  const int n_rows = a.Sq * G;
  const int n_qt = (n_rows + BQ - 1) / BQ;
  const int per_row = n_qt * a.Hkv;
  const int b = row_of_rank(a, G, blockIdx.x / per_row);
  const int qt = n_qt - 1 - blockIdx.x % per_row / a.Hkv;
  const int h = blockIdx.x % a.Hkv;
  const int tid = threadIdx.x, lane = tid % 32;
  // lane = 16 * part + kg; the warp's rows are wrow.. wrow + 7, of which
  // this thread owns wrow + RM * part + i (i < RM)
  const int kg = lane % kGroups, part = lane / kGroups;
  const int wrow = kWarpRows * (tid / 32), own = wrow + RM * part;
  const int row0 = qt * BQ;
  const int pos = a.pos[b];
  const int cap = min(max(a.abort ? a.abort[b] : a.Sq, 0), a.Sq);
  if (a.progress != nullptr && qt == 0 && h == 0 && tid == 0)
    a.progress[b] = cap;
  const int n_keys = keys_seen(a, pos, cap, G, row0, row0 + BQ);
  const int n_tiles = (n_keys + BK - 1) / BK;
  if (tid == 0) {
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // Loads: bulk copies of runs of key rows that are adjacent in memory (a
  // page, or up to kRun rows of a dense cache; single rows where the cache's
  // rows are not adjacent). Thread r < BK looks after K row r of a tile,
  // thread BK + r after V row r, and copies the run that starts there, if
  // one does; for a page pool each reads its row's page-table entry a tile
  // ahead.
  static_assert(2 * BK == kThreads, "one K or V row a thread");
  const bool loads_k = tid < BK;
  const int kk_own = loads_k ? tid : tid - BK;  // the row this thread copies
  const T* src = static_cast<const T*>(loads_k ? a.k : a.v);
  const int64_t s0 = loads_k ? a.k_s0 : a.v_s0;
  const int64_t sh = loads_k ? a.k_sh : a.v_sh;
  const int64_t ss = loads_k ? a.k_ss : a.v_ss;
  const bool adjacent = ss == D;
  T* dst = (loads_k ? k_s : v_s) + kk_own * D;
  uint64_t* bar = loads_k ? k_full : v_full;
  const bool paged = a.page_table != nullptr;
  const int* pt_row = paged ? a.page_table + (int64_t)b * a.pt_stride
                            : nullptr;
  const int ps = a.page_size;
  const int ps_shift = (paged && (ps & (ps - 1)) == 0) ? __ffs(ps) - 1 : -1;
  auto page_of = [&](int t) { return ps_shift >= 0 ? t >> ps_shift : t / ps; };
  // the page-table entry of this thread's key of tile t (0 past the unit's
  // keys: never read)
  auto lookup = [&](int t) {
    const int key = t * BK + kk_own;
    return paged && key < n_keys ? pt_row[page_of(key)] : 0;
  };
  // this thread's row of tile t, with the tile's byte count on the barrier
  auto fetch = [&](int t, int entry) {
    const int n = min(BK, n_keys - t * BK);
    if (kk_own == 0) mbar_expect_tx(bar, n * ROW_BYTES);
    if (kk_own >= n) return;
    const int key = t * BK + kk_own;
    const int in_page = paged ? key - page_of(key) * ps : 0;
    int rows = 1;  // the run that starts at this row, or 0
    if (adjacent) {
      rows = kk_own % kRun == 0 || (paged && in_page == 0)
                 ? min(n - kk_own, kRun - kk_own % kRun)
                 : 0;
      if (paged) rows = min(rows, ps - in_page);
    }
    if (rows == 0) return;
    int64_t off;
    if (paged) {
      const int64_t pg = min(max(entry, 0), a.n_pages - 1);
      off = pg * s0 + h * sh + in_page * ss;
    } else {
      off = b * s0 + h * sh + key * ss;
    }
    bulk_load(dst, src + off, rows * ROW_BYTES, bar);
  };

  int entry = 0;  // this thread's page-table entry of the next tile it loads
  if (n_tiles > 0) {
    entry = lookup(0);
    if (loads_k) {
      fetch(0, entry);
      entry = n_tiles > 1 ? lookup(1) : 0;
    }
  }

  // q, scaled into base 2, as f32 (rows past the chunk: zeros), while tile
  // 0 is in flight
  const T* qg = static_cast<const T*>(a.q);
  const float qscale = a.scale * kLog2e;
  for (int i = tid; i < BQ * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR, row = row0 + r;
    float x[VK];
    if (row < n_rows) {
      load_f32<T, VK>(qg + b * a.q_sb + (row / G) * a.q_ss +
                          (int64_t)(h * G + row % G) * a.q_sh + c * VK,
                      x);
#pragma unroll
      for (int e = 0; e < VK; ++e) x[e] = __fmul_rn(x[e], qscale);
    } else {
#pragma unroll
      for (int e = 0; e < VK; ++e) x[e] = 0.f;
    }
    store_from_f32<float, VK>(q_s + r * D + c * VK, x);
  }

  // the last key each of this thread's rows sees, or -1 (no key: past the
  // chunk or the cap)
  int lim[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = row0 + own + i, s = row / G;
    lim[i] = (row < n_rows && s < cap) ? min(pos + s, a.window - 1) : -1;
  }
  float m[RM], l[RM], acc[RM][VCH][NV];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < VCH; ++c)
#pragma unroll
      for (int n = 0; n < NV; ++n) acc[i][c][n] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const uint32_t parity = t & 1;
    __syncthreads();  // every thread is done with V and P of tile t - 1
    if (!loads_k) {
      fetch(t, entry);
      if (t + 1 < n_tiles) entry = lookup(t + 1);
    }
    if (t == n_tiles - 1) {
      // V rows past the unit's keys: zeros
      const float zero[VK] = {};
      for (int i = (n_keys - k0) * CPR + tid; i < BK * CPR; i += kThreads)
        store_from_f32<T, VK>(v_s + i * VK, zero);
    }

    // S = q K^T for the warp's 8 rows and this lane's 8 keys over its half
    // of D, in chunks of 4 elements from chunk kg on (the 8 or 16 lanes of
    // a load phase read different bank groups of K's unpadded rows)
    mbar_wait(k_full, parity);
    float s8[kWarpRows][CN];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s8[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < HC; ++c) {
      const int d = (part * HC + ((c + kg) & (HC - 1))) * 4;
      float kf[CN][4];
#pragma unroll
      for (int j = 0; j < CN; ++j)
        load_f32<T, 4>(k_s + (kg + kGroups * j) * D + d, kf[j]);
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) {
        float qf[4];
        load_f32<float, 4>(q_s + (wrow + i) * D + d, qf);
#pragma unroll
        for (int j = 0; j < CN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s8[i][j] = __fmaf_rn(qf[e], kf[j][e], s8[i][j]);
      }
    }
    // a score is the sum of its two halves of D: each lane keeps its own
    // rows and adds the other half's, from lane ^ 16
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float keep = part ? s8[RM + i][j] : s8[i][j];
        const float give = part ? s8[i][j] : s8[RM + i][j];
        s[i][j] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, give, kGroups));
      }

    // online softmax, per row, over the 16 lanes of a half
    float alpha[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        if (k0 + kg + kGroups * j > lim[i]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = kGroups / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = k0 + kg + kGroups * j <= lim[i]
                            ? exp2f(__fsub_rn(s[i][j], m_new))
                            : 0.f;
        p_s[(own + i) * PS + kg + kGroups * j] = p;
        sum = __fadd_rn(sum, p);
      }
#pragma unroll
      for (int o = kGroups / 2; o > 0; o >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
      alpha[i] = exp2f(__fsub_rn(m[i], m_new));
      l[i] = __fmaf_rn(l[i], alpha[i], sum);
      m[i] = m_new;
    }
    __syncthreads();  // P complete; every thread is done with K of tile t
    if (loads_k && t + 1 < n_tiles) {
      fetch(t + 1, entry);
      if (t + 2 < n_tiles) entry = lookup(t + 2);
    }

    // pv = P V for the warp's 8 rows and this lane's head dims over its
    // half of the tile's keys, in key order; the halves are added as the
    // scores' are, then acc = acc * alpha + pv: a row's keys are summed a
    // half tile at a time (summed key by key into one register, a row of
    // 2048 keys that repeat loses ~1e-5)
    mbar_wait(v_full, parity);
    float pv8[kWarpRows][VCH][NV];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i)
#pragma unroll
      for (int c = 0; c < VCH; ++c)
#pragma unroll
        for (int n = 0; n < NV; ++n) pv8[i][c][n] = 0.f;
    const int k_lo = part * (BK / 2);
#pragma unroll 4
    for (int kk = k_lo; kk < k_lo + BK / 2; kk += 4) {
      float pf[kWarpRows][4];
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i)
        load_f32<float, 4>(p_s + (wrow + i) * PS + kk, pf[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vf[VCH][NV];
#pragma unroll
        for (int c = 0; c < VCH; ++c)
          load_f32<T, NV>(v_s + (kk + e) * D + (kg + kGroups * c) * NV,
                          vf[c]);
#pragma unroll
        for (int i = 0; i < kWarpRows; ++i)
#pragma unroll
          for (int c = 0; c < VCH; ++c)
#pragma unroll
            for (int n = 0; n < NV; ++n)
              pv8[i][c][n] = __fmaf_rn(pf[i][e], vf[c][n], pv8[i][c][n]);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < VCH; ++c)
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const float keep = part ? pv8[RM + i][c][n] : pv8[i][c][n];
          const float give = part ? pv8[i][c][n] : pv8[RM + i][c][n];
          const float pv = __fadd_rn(
              keep, __shfl_xor_sync(0xffffffffu, give, kGroups));
          acc[i][c][n] = __fmaf_rn(acc[i][c][n], alpha[i], pv);
        }
  }

  // out = acc / max(l, 1e-30), rounded once to T; a row that saw no key
  // writes zeros
  T* ob = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = row0 + own + i;
    if (row >= n_rows) continue;
    T* orow = ob + b * a.o_sb + (row / G) * a.o_ss +
              (int64_t)(h * G + row % G) * a.o_sh;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < VCH; ++c) {
      float y[NV];
#pragma unroll
      for (int n = 0; n < NV; ++n) y[n] = __fdiv_rn(acc[i][c][n], den);
      store_from_f32<T, NV>(orow + (kg + kGroups * c) * NV, y);
    }
  }
}

// Launch the CUDA-core body for element type T and head dim D on `stream`.
template <typename T, int D>
cudaError_t launch(const AttnArgs& a, cudaStream_t stream) {
  constexpr int smem = Geo<T, D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      prefill_simt_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int G = a.H / a.Hkv;
  const int64_t units = (int64_t)a.B * a.Hkv * ((a.Sq * G + BQ - 1) / BQ);
  if (units > 0x7fffffff) return cudaErrorInvalidValue;
  prefill_simt_kernel<T, D>
      <<<static_cast<unsigned>(units), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace simt
}  // namespace sgdrc
