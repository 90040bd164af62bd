// (a_ls @ b_ls, a_be @ b_be) in one launch, tile rows in the BE quota's
// order. Replaces src/repro/kernels/dual_tenant_matmul.py::dual_tenant_matmul.
//
// What it computes: a_* [M_*, K] @ b_* [K, N] (row-major, shared K and N),
// each product accumulated in f32 (never TF32) and rounded once to the
// output type. Work units are (tile row, n-block) pairs: the wrapper
// uploads dual_tenant_matmul._schedule's order of (owner, tile row) pairs
// over tile rows of BM = 128 rows (both routes), and unit u is n-block
// u % n_nb of order entry u / n_nb (n-blocks of 96 columns on the simt
// route, 256 on the wgmma route), so a tile row's n-blocks start
// together, as the TPU grid's (order, n, k) axes run them. The grid is
// persistent (as many blocks as fit on the card at once), each block
// taking the next unit from a global atomic ticket: units start in
// schedule order, and the sm_be quota governs start order only. Each
// output element is one sum over k in order (no split-K, no atomics), so
// a tenant's bits depend neither on sm_be nor on the other tenant's rows.
//
// What bounds it on the card: operations (2 * M * K * N per product; at the
// widths chip_smoke.py runs, some hundreds of flops per byte moved, above
// the H100's 295 bf16 flops a byte). Two routes, picked by the wrapper
// (dual_tenant_matmul.py::route) before the launch:
//   wgmma (bf16, K and N multiples of 8, so every TMA row stride is a
//   multiple of 16 bytes): tensor cores, warp-specialised. 384 threads:
//   warpgroup 0 is the producer (setmaxnreg down to 40 registers), whose
//   thread 0 takes the units' tickets and streams A tiles [128, 64] and B
//   tiles [64, 4 x 64] by TMA, 128-byte swizzle, zero-filled past M, N and
//   K, into a ring of 4 stages (48 KB each) with full and empty mbarriers.
//   Warpgroups 1 and 2 (setmaxnreg up to 232) each own 64 rows of a
//   128 x 256 output tile and issue wgmma m64n128k16 twice per k16 step
//   with f32 accumulators (128 registers a thread); A is the K-major
//   operand, B [K, N] the MN-major one (trans-b), so neither is copied.
//   One wgmma group stays in flight while the next is issued, and a stage
//   is released as soon as its group is done. The producer hands each
//   unit to the consumers through a two-slot mbarrier ring and takes the
//   next ticket as soon as it has issued the current unit's loads, so the
//   ring never drains between units: a unit's loads start in ticket order,
//   at most one unit ahead of its products. 193 KB of shared memory: one
//   block per SM, a persistent grid of min(units, SMs) blocks. The
//   epilogue rounds each output once to bf16 and stores it with bounds
//   checks at the ragged M and N edges.
//   simt (f32, f16, and bf16 with K or N not a multiple of 8): f32 FMAs on
//   CUDA cores (f32 keeps the reference's 1e-5 tolerance, which TF32 would
//   break; 67 TFLOP/s on an H100). Each SM scheduler issues one
//   instruction a cycle and does one warp's FMA a cycle, so every other
//   instruction costs an FMA's slot; and the SM's shared memory delivers
//   128 bytes a cycle to its 128 FMA lanes, so a register tile that reads
//   one byte an FMA (8 x 8) can at best tie it. The design:
//   - Units of 128 x 96 outputs (Tile below), 128 threads, each thread an
//     8 x 12 register tile: 0.83 bytes of shared-memory reads an FMA, all
//     of them 8- or 16-byte loads. Warps are 4 (m) x 8 (n) threads; thread
//     (tm, tn) owns rows tm + 16 i and columns 4 tn + c + 32 q, so a warp's
//     A reads hit 4 rows of A's tile (16 bytes past a multiple of 128
//     bytes apart: no bank conflict) and its B reads 8 adjacent quads.
//   - k tiles of 64 bytes a row in a ring of 4 stages in dynamic shared
//     memory, in the input type (f16 and bf16 widen to f32 when read into
//     registers), filled by cp.async and zero-filled past M, N and K. One
//     barrier a k tile: the tile 3 ahead is issued once every thread is
//     done with the slot it refills. The ring runs across units: a block
//     takes its next ticket when it starts loading a unit, so the next
//     unit's first tiles load during the current unit's last ones.
//   - Copies 16 bytes wide where the host (COPY, the wrapper's
//     copy_width) finds K * itemsize, N * itemsize and every base a
//     multiple of 16; else 4-byte cp.async, or plain 2-byte loads for f16
//     and bf16 with an odd K or N. The same body, chosen before the launch.
//   - 96-wide units at three blocks an SM keep the last wave nearly full at
//     both of the model's projection shapes (see Tile).
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "dtypes.cuh"
#include "hopper.cuh"

namespace sgdrc {
namespace gemm {

constexpr int BM = 128;

struct Operands {
  const void* a;
  const void* b;
  void* out;
  int M;
};

struct DualArgs {
  Operands ls, be;
  const int* order;  // [2 * n_order] (owner, tile row); owner 0 = LS, 1 = BE
  int* ticket;
  int n_order, K, N;
};

namespace simt {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::smem_u32;

// The unit's tile for element type T. BN = 96 output columns of the BM =
// 128 rows; each thread an 8 x 12 register tile (8 rows, NQ = 3 quads of
// 4 columns), so 128 threads. k tiles of 64 bytes a row (BK = 16 f32, 32
// f16 or bf16) in a ring of 4 stages, 64 KB for every T; A is read 8
// bytes (KA k) at a time. Three blocks an SM: the launch bounds hold ptxas
// to 168 registers a thread. Waves, by the tile: phase 7's gate projection
// has 18 tile rows x 64 n-blocks = 1152 units on 396 blocks (2.91 waves),
// its down projection 18 x 22 = 396 units, one wave (128 x 128 units at
// two blocks an SM would be 3.27 and 1.09 waves).
template <typename T>
struct Tile {
  static constexpr int BN = 96, NQ = 3, TN = 4 * NQ;
  static constexpr int BK = 64 / sizeof(T), KA = 8 / sizeof(T);
  static constexpr int STAGES = 4, MIN_BLOCKS = 3;
  static constexpr int kThreads = 16 * BN / TN;  // (BM / 8) x (BN / TN)
  // A's row stride in elements: 16 bytes past the row, so the 4 rows a
  // warp reads at one k sit in different banks
  static constexpr int SA = BK + 16 / sizeof(T);
  static constexpr int A_ELEMS = BM * SA, STAGE = A_ELEMS + BK * BN;
  static constexpr int kTickets = 8;  // > STAGES: a slot per unit in flight
  static constexpr int SMEM =
      STAGES * STAGE * (int)sizeof(T) + kTickets * (int)sizeof(int);
};

// 4 bytes global -> shared through L1; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// One copy of COPY bytes; COPY == sizeof(T) == 2 is a plain load.
template <typename T, int COPY>
__device__ __forceinline__ void copy(T* dst, const T* src, bool valid) {
  if constexpr (COPY == 16) {
    cp_async16(dst, src, valid);
  } else if constexpr (COPY == 4) {
    cp_async4(dst, src, valid);
  } else {
    static_assert(COPY == sizeof(T), "copy width");
    *dst = valid ? *src : from_f32<T>(0.f);
  }
}

// N adjacent elements of T in shared memory (N * sizeof(T) bytes, aligned
// to that), read with one load and widened to f32 at use.
template <typename T, int N>
struct Vec {
  static constexpr int W = N * sizeof(T) / 4;  // 32-bit words
  static_assert(W == 2 || W == 4, "vector width");
  uint32_t w[W];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (W == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x, w[1] = v.y;
    }
  }
  __device__ __forceinline__ float operator[](int i) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[i]);
    } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      const uint32_t x = w[i / 2];  // bf16 is f32's upper half
      return __uint_as_float(i % 2 ? x & 0xffff0000u : x << 16);
    } else {
      const uint32_t x = w[i / 2];
      return __half2float(
          __ushort_as_half(static_cast<unsigned short>(i % 2 ? x >> 16 : x)));
    }
  }
};

// Register row i (< 8) of thread row tm (< 16) is row tm + 16 i of the
// unit; quad q (< NQ) of thread column tn starts at column col_of(tn, q).
template <typename T>
__device__ __forceinline__ int col_of(int tn, int q) {
  return Tile<T>::BN / Tile<T>::NQ * q + 4 * tn;
}

struct Unit {
  const void* a;
  const void* b;
  void* out;
  int M, m0, n0;
};

__device__ __forceinline__ Unit unit_of(const DualArgs& g, int u, int n_nb,
                                        int BN) {
  const int oi = u / n_nb;
  const bool be = g.order[2 * oi] != 0;
  return {be ? g.be.a : g.ls.a, be ? g.be.b : g.ls.b,
          be ? g.be.out : g.ls.out, be ? g.be.M : g.ls.M,
          g.order[2 * oi + 1] * BM, (u % n_nb) * BN};
}

// Issue the copies of k tile [k0, k0 + BK) of unit `un` into one stage:
// A's tile row-major (rows SA apart), B's [BK, BN]. The narrow copies'
// loops stay rolled: unrolled, their addresses would spill.
template <typename T, int COPY>
__device__ __forceinline__ void load_tile(T* stage, const Unit& un, int k0,
                                          int K, int N, int tid) {
  using L = Tile<T>;
  constexpr int CE = COPY / sizeof(T), NT = L::kThreads;
  const T* A = static_cast<const T*>(un.a);
  const T* B = static_cast<const T*>(un.b);
  constexpr int CPR_A = L::BK / CE, NA = BM * CPR_A;
  constexpr int UA = COPY == 16 ? (NA + NT - 1) / NT : 1;
  constexpr int CPR_B = L::BN / CE, NB = L::BK * CPR_B;
  constexpr int UB = COPY == 16 ? (NB + NT - 1) / NT : 1;
#pragma unroll (UA)
  for (int e = 0; e < (NA + NT - 1) / NT; ++e) {
    const int c = tid + e * NT;
    if (NA % NT == 0 || c < NA) {
      const int r = c / CPR_A, kc = (c % CPR_A) * CE;
      const int gm = un.m0 + r, gk = k0 + kc;
      const bool ok = gm < un.M && gk < K;
      copy<T, COPY>(stage + r * L::SA + kc,
                    A + (ok ? (int64_t)gm * K + gk : 0), ok);
    }
  }
  T* Bs = stage + L::A_ELEMS;
#pragma unroll (UB)
  for (int e = 0; e < (NB + NT - 1) / NT; ++e) {
    const int c = tid + e * NT;
    if (NB % NT == 0 || c < NB) {
      const int kr = c / CPR_B, nc = (c % CPR_B) * CE;
      const int gk = k0 + kr, gn = un.n0 + nc;
      const bool ok = gk < K && gn < N;
      copy<T, COPY>(Bs + kr * L::BN + nc,
                    B + (ok ? (int64_t)gk * N + gn : 0), ok);
    }
  }
}

// acc[i][4 q + c] += sum over the stage's BK k of A[tm + 16 i][k] *
// B[k][col_of(tn, q) + c], k in order. The loop over KA-deep steps is kept
// rolled: unrolled, ptxas hoists the next steps' loads and spills.
template <typename T>
__device__ __forceinline__ void mma_tile(const T* stage, int tm, int tn,
                                         float (&acc)[8][Tile<T>::TN]) {
  using L = Tile<T>;
  constexpr int KA = L::KA, NQ = L::NQ;
  const T* Bs = stage + L::A_ELEMS;
#pragma unroll 1
  for (int kq = 0; kq < L::BK; kq += KA) {
    float a[KA][8];  // a[kk][i] = A[tm + 16 i][kq + kk]
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      Vec<T, KA> v;
      v.load(stage + (tm + 16 * i) * L::SA + kq);
#pragma unroll
      for (int kk = 0; kk < KA; ++kk) a[kk][i] = v[kk];
    }
#pragma unroll
    for (int kk = 0; kk < KA; ++kk) {
      Vec<T, 4> b[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        b[q].load(Bs + (kq + kk) * L::BN + col_of<T>(tn, q));
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][4 * q + c] = fmaf(a[kk][i], b[q][c], acc[i][4 * q + c]);
    }
  }
}

// Two outputs rounded to a 2-byte T, packed low then high.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const T h[2] = {from_f32<T>(lo), from_f32<T>(hi)};
  uint32_t w;
  memcpy(&w, h, sizeof(w));
  return w;
}

// Round the unit's outputs once to T and store them, within M and N.
template <typename T, int COPY>
__device__ __forceinline__ void store_tile(
    const Unit& un, int N, int tm, int tn,
    const float (&acc)[8][Tile<T>::TN]) {
  T* C = static_cast<T*>(un.out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = un.m0 + tm + 16 * i;
    if (gm >= un.M) continue;
#pragma unroll
    for (int q = 0; q < Tile<T>::NQ; ++q) {
      const int gn = un.n0 + col_of<T>(tn, q);
      T* p = C + (int64_t)gm * N + gn;
      const float v0 = acc[i][4 * q], v1 = acc[i][4 * q + 1],
                  v2 = acc[i][4 * q + 2], v3 = acc[i][4 * q + 3];
      if constexpr (COPY == 16) {  // N a multiple of 16 bytes: whole quads
        if (gn >= N) continue;
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float4*>(p) = make_float4(v0, v1, v2, v3);
        } else {
          *reinterpret_cast<uint2*>(p) =
              make_uint2(pack2<T>(v0, v1), pack2<T>(v2, v3));
        }
      } else {
        const float v[4] = {v0, v1, v2, v3};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (gn + c < N) p[c] = from_f32<T>(v[c]);
      }
    }
  }
}

template <typename T, int COPY>
__global__ void __launch_bounds__(Tile<T>::kThreads, Tile<T>::MIN_BLOCKS)
    dual_gemm_simt(DualArgs g) {
  using L = Tile<T>;
  constexpr int STAGES = L::STAGES, R = L::kTickets;
  extern __shared__ __align__(16) uint8_t smem[];
  T* ring = reinterpret_cast<T*>(smem);
  int* tickets = reinterpret_cast<int*>(ring + STAGES * L::STAGE);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // warps of 4 (m) x 8 (n) threads: a warp's B reads are 8 adjacent quads
  const int tm = warp % 4 * 4 + lane / 8, tn = warp / 4 * 8 + lane % 8;
  const int K = g.K, N = g.N;
  const int n_nb = (N + L::BN - 1) / L::BN, n_units = g.n_order * n_nb;
  const int k_tiles = max(1, (K + L::BK - 1) / L::BK);

  if (tid == 0) tickets[0] = atomicAdd(g.ticket, 1);
  __syncthreads();
  // loader: unit l_unit (the l_seq-th this block took), k tile l_t;
  // products: unit c_unit, k tile c_t, STAGES - 1 tiles behind
  int l_unit = tickets[0], l_seq = 0, l_t = 0;
  int c_unit = l_unit, c_seq = 0, c_t = 0;
  if (c_unit >= n_units) return;

  // Issue the next k tile into `slot` (nothing once the tickets run out);
  // one cp.async group a call either way, so the waits count tiles.
  auto load_next = [&](int slot) {
    if (l_unit < n_units) {
      if (l_t == 0 && tid == 0)
        tickets[(l_seq + 1) % R] = atomicAdd(g.ticket, 1);
      load_tile<T, COPY>(ring + slot * L::STAGE,
                         unit_of(g, l_unit, n_nb, L::BN), l_t * L::BK, K, N,
                         tid);
      if (++l_t == k_tiles) {
        l_t = 0;
        __syncthreads();  // every thread sees thread 0's next ticket
        l_unit = tickets[++l_seq % R];
      }
    }
    cp_async_commit();
  };

  float acc[8][L::TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < L::TN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_next(s);
  for (int slot = 0;; slot = (slot + 1) % STAGES) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of the tile landed
    __syncthreads();  // everyone's, and the slot refilled below is free
    load_next((slot + STAGES - 1) % STAGES);
    mma_tile<T>(ring + slot * L::STAGE, tm, tn, acc);
    if (++c_t < k_tiles) continue;
    store_tile<T, COPY>(unit_of(g, c_unit, n_nb, L::BN), N, tm, tn, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < L::TN; ++j) acc[i][j] = 0.f;
    c_t = 0;
    c_unit = tickets[++c_seq % R];  // the loader's crossing barrier wrote it
    if (c_unit >= n_units) break;
  }
}

// The body's launch: a persistent grid of as many blocks as fit.
template <typename T, int COPY>
cudaError_t launch(const DualArgs& g, cudaStream_t st) {
  using L = Tile<T>;
  auto kernel = dual_gemm_simt<T, COPY>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = hopper::resident_blocks(kernel, L::kThreads, L::SMEM,
                                g.n_order * ((g.N + L::BN - 1) / L::BN),
                                &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, L::kThreads, L::SMEM, st>>>(g);
  return cudaGetLastError();
}

// `copy` (16, 4, or 2 for 2-byte types) picks the instance.
template <typename T>
cudaError_t launch_copy(const DualArgs& g, int copy, cudaStream_t st) {
  if (copy == 16) return launch<T, 16>(g, st);
  if (copy == 4) return launch<T, 4>(g, st);
  if constexpr (sizeof(T) == 2) {
    if (copy == 2) return launch<T, 2>(g, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace simt

namespace wg {

using namespace sgdrc::hopper;

constexpr int BK = 64;
static_assert(BM == 128, "two m64 consumer warpgroups");

// Warpgroup 0 is the producer (one thread takes the tickets and issues
// every TMA load), warpgroups 1 and 2 the consumers, each owning 64 rows of
// a 128 x 256 output tile.
constexpr int kThreads = 384, TBN = 256, STAGES = 4;
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BK * TBN * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
// barriers: full and empty per stage, unit full and unit empty per unit
// slot (2 slots), then the 2 slots; + 1024 for alignment
constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + 4) + 8 + 1024;

__global__ void __launch_bounds__(kThreads, 1) dual_gemm_wgmma(
    const __grid_constant__ CUtensorMap a_ls,
    const __grid_constant__ CUtensorMap b_ls,
    const __grid_constant__ CUtensorMap a_be,
    const __grid_constant__ CUtensorMap b_be, void* out_ls, void* out_be,
    int M_ls, int M_be, const int* order, int* ticket, int n_order, int K,
    int N) {
  constexpr int BN = TBN, NA = 128;  // NA: accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* ufull = empty + STAGES;  // [2]
  uint64_t* uempty = ufull + 2;      // [2]
  int* unit_slot = reinterpret_cast<int*>(uempty + 2);  // [2]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // the consumers' eight warps
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&ufull[s], 1);
      mbar_init(&uempty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int n_nb = (N + BN - 1) / BN;
  const int n_units = n_order * n_nb;
  const int k_tiles = (K + BK - 1) / BK;

  if (warp < 4) {
    // producer: takes units in ticket order and streams their k tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 0) return;
    uint32_t g = 0;
    for (uint32_t ui = 0;; ++ui) {
      const int u = atomicAdd(ticket, 1);
      const int slot = ui % 2;
      if (ui >= 2) mbar_wait(&uempty[slot], ((ui / 2) & 1) ^ 1);
      unit_slot[slot] = u;
      mbar_arrive(&ufull[slot]);  // release: the consumers see unit_slot
      if (u >= n_units) return;
      const int oi = u / n_nb, nb = u % n_nb;
      const bool be = order[2 * oi] != 0;
      const CUtensorMap* ma = be ? &a_be : &a_ls;
      const CUtensorMap* mb = be ? &b_be : &b_ls;
      const int m0 = order[2 * oi + 1] * BM, n0 = nb * BN;
      for (int t = 0; t < k_tiles; ++t, ++g) {
        const int st = g % STAGES;
        if (g >= STAGES) mbar_wait(&empty[st], ((g / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], STAGE_BYTES);
        uint8_t* dst = smem + st * STAGE_BYTES;
        tma_load_2d(dst, ma, &full[st], t * BK, m0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(dst + A_BYTES + c * BK * 128, mb, &full[st], n0 + 64 * c,
                      t * BK);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wgi = warp / 4 - 1;  // consumer warpgroup: rows 64 wgi..
    uint32_t g = 0;
    for (uint32_t ui = 0;; ++ui) {
      const int slot = ui % 2;
      mbar_wait(&ufull[slot], (ui / 2) & 1);
      const int u = unit_slot[slot];
      __syncwarp();
      if (lane == 0) mbar_arrive(&uempty[slot]);
      if (u >= n_units) return;
      const int oi = u / n_nb, nb = u % n_nb;
      const bool be = order[2 * oi] != 0;
      const int M = be ? M_be : M_ls;
      const int m0 = order[2 * oi + 1] * BM, n0 = nb * BN;

      float acc[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = 0.f;
      for (int t = 0; t < k_tiles; ++t) {
        const int st = (g + t) % STAGES;
        mbar_wait(&full[st], ((g + t) / STAGES) & 1);
        const uint32_t a_addr = smem_u32(smem + st * STAGE_BYTES);
        const uint32_t b_addr = a_addr + A_BYTES;
        fence_regs<NA>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int nh = 0; nh < 2; ++nh)
            wgmma_ss_n128<1>(
                acc + 64 * nh,
                desc_sw128(a_addr + wgi * 64 * 128 + kk * 32, 16, 1024),
                desc_sw128(b_addr + nh * 2 * BK * 128 + kk * 16 * 128,
                           BK * 128, 1024),
                1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous tile's group is done
        fence_regs<NA>(acc);
        if (t > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(g + t - 1) % STAGES]);
        }
      }
      wgmma_wait<0>();
      fence_regs<NA>(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(g + k_tiles - 1) % STAGES]);
      g += k_tiles;

      __nv_bfloat16* C = static_cast<__nv_bfloat16*>(be ? out_be : out_ls);
      const int r0 = m0 + 64 * wgi + 16 * (warp % 4) + lane / 4;
      const int cq = n0 + 2 * (lane % 4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int gm = r0 + 8 * r;
        if (gm >= M) continue;
#pragma unroll
        for (int j = 0; j < NA / 4; ++j) {
          const int gn = cq + 8 * j;
          if (gn < N)
            *reinterpret_cast<__nv_bfloat162*>(C + (int64_t)gm * N + gn) =
                __floats2bfloat162_rn(acc[4 * j + 2 * r],
                                      acc[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// The tensor map of a row-major [rows, cols] bf16 matrix, box {64, box_rows}.
inline cudaError_t make_matrix_map(CUtensorMap* map, const void* base,
                                   int rows, int cols, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {64, (uint32_t)box_rows};
  return make_map(map, base, 2, dims, strides, box);
}

}  // namespace wg
}  // namespace gemm
}  // namespace sgdrc

// Rows of one tile row (a work unit's height) on either route: the wrapper
// builds the schedule over ceil(M / this) tile rows per tenant.
extern "C" int sgdrc_matmul_tile(void) { return sgdrc::gemm::BM; }

// `wgmma` 1 takes the tensor-core route (bf16 only, K and N multiples of
// 8, 16-byte aligned operands), 0 the CUDA-core route, whose copies are
// `copy` bytes wide (16, 4, or 2 for f16 and bf16): K and N times the
// element size and every base must be multiples of it.
extern "C" int sgdrc_dual_tenant_matmul(const void* a_ls, const void* b_ls,
                                        void* out_ls, const void* a_be,
                                        const void* b_be, void* out_be,
                                        const void* order, void* ticket,
                                        int dtype, int M_ls, int M_be, int K,
                                        int N, int n_order, int wgmma,
                                        int copy, void* stream) {
  using namespace sgdrc::gemm;
  if (n_order == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  int blocks = 0;
  if (wgmma) {
    if (dtype != 1 || K <= 0 || K % 8 != 0 || N % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    // a tenant with no rows never runs a unit: it borrows the other's maps
    const bool has_ls = M_ls > 0, has_be = M_be > 0;
    CUtensorMap maps[4];
    const void* as[2] = {has_ls ? a_ls : a_be, has_be ? a_be : a_ls};
    const void* bs[2] = {has_ls ? b_ls : b_be, has_be ? b_be : b_ls};
    const int ms[2] = {has_ls ? M_ls : M_be, has_be ? M_be : M_ls};
    for (int i = 0; i < 2; ++i) {
      if ((err = wg::make_matrix_map(&maps[2 * i], as[i], ms[i], K, BM)) !=
              cudaSuccess ||
          (err = wg::make_matrix_map(&maps[2 * i + 1], bs[i], K, N,
                                     wg::BK)) != cudaSuccess)
        return static_cast<int>(err);
    }
    auto kernel = wg::dual_gemm_wgmma;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               wg::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    // one block per SM: the shared memory holds one ring
    err = sgdrc::hopper::resident_blocks(
        kernel, wg::kThreads, wg::SMEM,
        n_order * ((N + wg::TBN - 1) / wg::TBN), &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, wg::kThreads, wg::SMEM, st>>>(
        maps[0], maps[1], maps[2], maps[3], out_ls, out_be, M_ls, M_be,
        static_cast<const int*>(order), static_cast<int*>(ticket), n_order,
        K, N);
    return static_cast<int>(cudaGetLastError());
  }
  const int item = dtype == 0 ? 4 : 2;
  const void* ptrs[6] = {a_ls, b_ls, out_ls, a_be, b_be, out_be};
  bool ok = (copy == 16 || copy == 4 || copy == 2) && copy >= item &&
            (int64_t)K * item % copy == 0 && (int64_t)N * item % copy == 0;
  for (const void* p : ptrs)
    ok = ok && reinterpret_cast<uintptr_t>(p) % copy == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const DualArgs g{{a_ls, b_ls, out_ls, M_ls},
                   {a_be, b_be, out_be, M_be},
                   static_cast<const int*>(order),
                   static_cast<int*>(ticket),
                   n_order,
                   K,
                   N};
  return static_cast<int>(sgdrc::with_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return simt::launch_copy<T>(g, copy, st);
  }));
}
