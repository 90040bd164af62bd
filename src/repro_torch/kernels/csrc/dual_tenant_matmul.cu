// (a_ls @ b_ls, a_be @ b_be) in one launch, tile rows in the BE quota's
// order. Replaces src/repro/kernels/dual_tenant_matmul.py::dual_tenant_matmul.
//
// What it computes: a_* [M_*, K] @ b_* [K, N] (row-major, shared K and N),
// each product accumulated in f32 (plain FMAs, never TF32) and rounded once
// to the output type. Work units are (tile row, n-block) pairs: the wrapper
// uploads dual_tenant_matmul._schedule's order of (owner, tile row) pairs
// over tile rows of BM rows, and unit u is n-block u % n_nb of order entry
// u / n_nb, so a tile row's n-blocks start together, as the TPU grid's
// (order, n, k) axes run them. The grid is persistent (occupancy times SM
// count), each block taking the next unit from a global atomic ticket:
// units start in schedule order, and the sm_be quota governs start order
// only.
//
// What bounds it on the card: operations (2 * M * K * N per product; at the
// widths chip_smoke.py runs, some hundreds of flops per byte moved). This is
// the simple form of a GEMM: 128 x 128 output tiles, 8-deep K slices staged
// through shared memory as f32, and an 8 x 8 register tile a thread on CUDA
// cores; no tensor cores, no cp.async or TMA pipelining (later work).
#include <stdint.h>

#include <algorithm>

#include "dtypes.cuh"

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

}  // namespace gemm
}  // namespace sgdrc

// Rows of one tile row (a work unit's height): the wrapper builds the
// schedule over ceil(M / this) tile rows per tenant.
extern "C" int sgdrc_matmul_tile(void) { return sgdrc::gemm::BM; }

extern "C" int sgdrc_dual_tenant_matmul(const void* a_ls, const void* b_ls,
                                        void* out_ls, const void* a_be,
                                        const void* b_be, void* out_be,
                                        const void* order, void* ticket,
                                        int dtype, int M_ls, int M_be, int K,
                                        int N, int n_order, void* stream) {
  using namespace sgdrc::gemm;
  if (n_order == 0 || N == 0) return 0;
  const DualArgs g{{a_ls, b_ls, out_ls, M_ls},
                   {a_be, b_be, out_be, M_be},
                   static_cast<const int*>(order),
                   static_cast<int*>(ticket),
                   n_order,
                   K,
                   N};
  const int n_units = n_order * ((N + BN - 1) / BN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(sgdrc::with_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    auto kernel = dual_gemm<T>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    const int blocks = std::min(n_units, std::max(1, sms * per_sm));
    kernel<<<blocks, kThreads, 0, st>>>(g);
    return cudaGetLastError();
  }));
}
