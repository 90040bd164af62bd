// (a_ls @ b_ls, a_be @ b_be) in one launch, tile rows in the BE quota's
// order. Replaces src/repro/kernels/dual_tenant_matmul.py::dual_tenant_matmul.
//
// What it computes: a_* [M_*, K] @ b_* [K, N] (row-major, shared K and N),
// each product accumulated in f32 (never TF32) and rounded once to the
// output type. Work units are (tile row, n-block) pairs: the wrapper
// uploads dual_tenant_matmul._schedule's order of (owner, tile row) pairs
// over tile rows of BM = 128 rows (both routes), and unit u is n-block
// u % n_nb of order entry u / n_nb (n-blocks of 128 columns on the simt
// route, 256 on the wgmma route), so a tile row's n-blocks start
// together, as the TPU grid's (order, n, k) axes run them. The grid is
// persistent (as many blocks as fit on the card at once), each block
// taking the next unit from a global atomic ticket: units start in
// schedule order, and the sm_be quota governs start order only.
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
//   simt (f32, f16, and bf16 with K or N not a multiple of 8): CUDA cores.
//   128 x 128 output tiles, 8-deep K slices staged through shared memory as
//   f32, an 8 x 8 register tile a thread of f32 FMAs (f32 keeps the
//   reference's 1e-5 tolerance, which TF32 would break).
#include <stdint.h>

#include "dtypes.cuh"
#include "hopper.cuh"

namespace sgdrc {
namespace gemm {

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int kThreads = 256;  // a 16 x 16 grid (ty, tx)
constexpr int TM = BM / 16, TN = BN / 16;

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

template <typename T>
__global__ void __launch_bounds__(kThreads) dual_gemm(DualArgs g) {
  __shared__ float a_s[BK][BM + 4];  // A tile, transposed; +4: no conflicts
  __shared__ float b_s[BK][BN];
  __shared__ int unit_s;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int K = g.K, N = g.N;
  const int n_nb = (N + BN - 1) / BN;
  const int n_units = g.n_order * n_nb;
  while (true) {
    if (tid == 0) unit_s = atomicAdd(g.ticket, 1);
    __syncthreads();
    const int u = unit_s;
    __syncthreads();  // every thread has read unit_s before it is reused
    if (u >= n_units) break;
    const int oi = u / n_nb, nb = u % n_nb;
    const bool be = g.order[2 * oi] != 0;
    const Operands op{be ? g.be.a : g.ls.a, be ? g.be.b : g.ls.b,
                      be ? g.be.out : g.ls.out, be ? g.be.M : g.ls.M};
    const int m0 = g.order[2 * oi + 1] * BM, n0 = nb * BN;
    const T* A = static_cast<const T*>(op.a);
    const T* B = static_cast<const T*>(op.b);

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
      for (int e = 0; e < BM * BK / kThreads; ++e) {
        const int i = tid + e * kThreads, r = i / BK, kk = i % BK;
        const int gm = m0 + r, gk = k0 + kk;
        a_s[kk][r] = (gm < op.M && gk < K)
                         ? to_f32(A[(int64_t)gm * K + gk])
                         : 0.f;
      }
#pragma unroll
      for (int e = 0; e < BK * BN / kThreads; ++e) {
        const int i = tid + e * kThreads, kk = i / BN, c = i % BN;
        const int gk = k0 + kk, gn = n0 + c;
        b_s[kk][c] = (gk < K && gn < N) ? to_f32(B[(int64_t)gk * N + gn])
                                        : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float ar[TM], br[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) ar[i] = a_s[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) br[j] = b_s[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }

    T* C = static_cast<T*>(op.out);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty + 16 * i;
      if (gm >= op.M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = n0 + tx + 16 * j;
        if (gn < N) C[(int64_t)gm * N + gn] = from_f32<T>(acc[i][j]);
      }
    }
  }
}


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
// 8, 16-byte aligned operands), 0 the CUDA-core route.
extern "C" int sgdrc_dual_tenant_matmul(const void* a_ls, const void* b_ls,
                                        void* out_ls, const void* a_be,
                                        const void* b_be, void* out_be,
                                        const void* order, void* ticket,
                                        int dtype, int M_ls, int M_be, int K,
                                        int N, int n_order, int wgmma,
                                        void* stream) {
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
  const DualArgs g{{a_ls, b_ls, out_ls, M_ls},
                   {a_be, b_be, out_be, M_be},
                   static_cast<const int*>(order),
                   static_cast<int*>(ticket),
                   n_order,
                   K,
                   N};
  return static_cast<int>(sgdrc::with_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    auto kernel = dual_gemm<T>;
    cudaError_t e = sgdrc::hopper::resident_blocks(
        kernel, kThreads, 0, n_order * ((N + BN - 1) / BN), &blocks);
    if (e != cudaSuccess) return e;
    kernel<<<blocks, kThreads, 0, st>>>(g);
    return cudaGetLastError();
  }));
}
