// Two causal GQA self-attentions, the LS and the BE tenant's, in one launch.
// Replaces src/repro/kernels/dual_tenant_attention.py::dual_tenant_attention.
//
// The TPU kernel's leading grid axis walks work units in the order of
// dual_tenant_matmul._schedule: per round of round_tiles units BE holds at
// most its sm_be share (fractional quotas carry credit), so a BE unit waits
// at most one query tile for an LS one. Hopper blocks run in no order, so
// here the grid is persistent: as many blocks as fit on the card at once
// (the occupancy of the kernel times the SM count), each taking the next
// unit from a global atomic ticket. Units therefore *start* in schedule
// order; the quota is about start order only (no SM masking, as the JAX
// package has none). A unit is one (tenant, b, h, query tile), decoded from
// its row r as (r / (H * nq), (r / nq) % H, r % nq) with nq = ceil(S / BQ),
// and runs flash_core.cuh's tile with causal = true, no window, no softcap:
// the very code of flash_attention.cu, so each tenant's output equals
// flash_attention's bit for bit and does not depend on sm_be.
//
// What bounds it on the card: operations, as flash_attention (4 * D flops
// per visible causal (query, key) pair, both tenants together).
//
// order: int32 [2 * n_units] of (owner, row) pairs, owner 0 = LS, 1 = BE;
// ticket: one int32, zero at launch.
#include <algorithm>

#include "flash_core.cuh"

namespace sgdrc {
namespace flash {

struct DualArgs {
  Heads ls, be;
  const int* order;
  int* ticket;
  int n_units;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dual_kernel(DualArgs a) {
  extern __shared__ float smem[];
  __shared__ int unit_s;
  const int S = a.ls.S, H = a.ls.H;
  const int nq = (S + Tile<D>::BQ - 1) / Tile<D>::BQ;
  while (true) {
    if (threadIdx.x == 0) unit_s = atomicAdd(a.ticket, 1);
    __syncthreads();
    const int t = unit_s;
    __syncthreads();  // every thread has read unit_s before it is reused
    if (t >= a.n_units) break;
    const bool be = a.order[2 * t] != 0;
    const int r = a.order[2 * t + 1];
    const int b = r / (H * nq), h = (r / nq) % H, qi = r % nq;
    // select field by field: a whole-struct select goes through local memory
    const Heads x{be ? a.be.q : a.ls.q, be ? a.be.k : a.ls.k,
                  be ? a.be.v : a.ls.v, be ? a.be.out : a.ls.out, S, H,
                  a.ls.Hkv};
    tile<T, D>(x, b, h, qi * Tile<D>::BQ, true, 0, 0.f, a.scale, smem);
  }
}

}  // namespace flash
}  // namespace sgdrc

// Query rows per work unit for head dim D (0 if D is not supported): the
// wrapper builds the schedule over tiles of this height.
extern "C" int sgdrc_flash_tile_rows(int D) {
  using namespace sgdrc::flash;
  switch (D) {
    case 64:
      return Tile<64>::BQ;
    case 128:
      return Tile<128>::BQ;
    case 256:
      return Tile<256>::BQ;
    default:
      return 0;
  }
}

extern "C" int sgdrc_dual_tenant_attention(
    const void* q_ls, const void* k_ls, const void* v_ls, void* out_ls,
    const void* q_be, const void* k_be, const void* v_be, void* out_be,
    const void* order, void* ticket, int dtype, int S, int H, int Hkv, int D,
    int n_units, float scale, void* stream) {
  using namespace sgdrc::flash;
  if (n_units == 0 || S == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  DualArgs a{{q_ls, k_ls, v_ls, out_ls, S, H, Hkv},
             {q_be, k_be, v_be, out_be, S, H, Hkv},
             static_cast<const int*>(order),
             static_cast<int*>(ticket),
             n_units,
             scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(sgdrc::with_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return with_head_dim(D, [&](auto dim) {
      constexpr int kD = decltype(dim)::value;
      constexpr int bytes = smem_floats<kD>() * sizeof(float);
      auto kernel = dual_kernel<T, kD>;
      cudaError_t err = allow_smem(kernel, bytes);
      if (err != cudaSuccess) return err;
      int dev = 0, sms = 0, per_sm = 0;
      if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return err;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, bytes);
      if (err != cudaSuccess) return err;
      const int blocks = std::min(n_units, std::max(1, sms * per_sm));
      kernel<<<blocks, kThreads, bytes, st>>>(a);
      return cudaGetLastError();
    });
  }));
}
