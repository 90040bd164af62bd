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
// and runs the tile body of flash_attention.cu's route with causal = true,
// no window, no softcap: the very code of flash_attention.cu, so each
// tenant's output equals flash_attention's bit for bit and does not depend
// on sm_be. The route (`wgmma`: bf16 and f16 on flash_wgmma.cuh's
// tensor-core body; else f32 on flash_simt.cuh's CUDA-core body) fixes BQ,
// the block size and the shared memory (flash::launch), and the wrapper
// schedules over the route's BQ (sgdrc_flash_tile_rows). On the CUDA-core
// body query tile r % nq counts from the last, so the units of a (b, h)
// start heaviest first, as flash_attention.cu's blocks do, and the light
// ones fill the tail.
//
// What bounds it on the card: operations, as flash_attention (4 * D flops
// per visible causal (query, key) pair, both tenants together).
//
// order: int32 [2 * n_units] of (owner, row) pairs, owner 0 = LS, 1 = BE;
// ticket: one int32, zero at launch.
#include "flash_wgmma.cuh"

namespace sgdrc {
namespace flash {

struct DualArgs {
  Heads ls, be;
  const int* order;
  int* ticket;
  int n_units;
  float scale;
};

// The next unit's index, the same for every thread of the block; the
// second barrier also ends the block's use of shared memory for the last
// unit.
__device__ __forceinline__ int next_unit(int* ticket, int* unit_s) {
  if (threadIdx.x == 0) *unit_s = atomicAdd(ticket, 1);
  __syncthreads();
  const int t = *unit_s;
  __syncthreads();  // every thread has read unit_s before it is reused
  return t;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) dual_kernel(DualArgs a) {
  extern __shared__ __align__(16) uint8_t simt_smem[];
  __shared__ int unit_s;
  init<T, D>(simt_smem);
  const int S = a.ls.S, H = a.ls.H;
  const int nq = (S + BQ - 1) / BQ;
  Pipe pipe;
  while (true) {
    const int t = next_unit(a.ticket, &unit_s);
    if (t >= a.n_units) break;
    const bool be = a.order[2 * t] != 0;
    const int r = a.order[2 * t + 1];
    const int b = r / (H * nq), h = (r / nq) % H, qi = nq - 1 - r % nq;
    // select field by field: a whole-struct select goes through local memory
    const Heads x{be ? a.be.q : a.ls.q, be ? a.be.k : a.ls.k,
                  be ? a.be.v : a.ls.v, be ? a.be.out : a.ls.out, S, H,
                  a.ls.Hkv};
    tile<T, D>(x, b, h, qi * BQ, true, 0, 0.f, a.scale, simt_smem, pipe);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(wg::kThreads, 1) dual_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_ls,
    const __grid_constant__ CUtensorMap k_ls,
    const __grid_constant__ CUtensorMap v_ls,
    const __grid_constant__ CUtensorMap q_be,
    const __grid_constant__ CUtensorMap k_be,
    const __grid_constant__ CUtensorMap v_be, void* out_ls, void* out_be,
    const int* order, int* ticket, int n_units, int S, int H, int Hkv,
    float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int unit_s;
  uint8_t* smem = sgdrc::hopper::align1024(smem_raw);
  wg::init<D>(smem);
  const int nq = (S + wg::BQ - 1) / wg::BQ;
  wg::Pipe pipe;
  while (true) {
    const int t = next_unit(ticket, &unit_s);
    if (t >= n_units) break;
    const bool be = order[2 * t] != 0;
    const int r = order[2 * t + 1];
    const int b = r / (H * nq), h = (r / nq) % H, qi = r % nq;
    const wg::Maps x{be ? &q_be : &q_ls, be ? &k_be : &k_ls,
                     be ? &v_be : &v_ls, be ? out_be : out_ls, S, H, Hkv};
    wg::tile<T, D>(x, b, h, qi * wg::BQ, true, 0, 0.f, scale, smem, pipe);
  }
}

}  // namespace flash
}  // namespace sgdrc

// Query rows per work unit for head dim D on the route (`wgmma` 1: the
// bf16 and f16 tensor-core body; 0: the CUDA-core body), 0 if D is not
// supported: the wrapper builds the schedule over tiles of this height.
extern "C" int sgdrc_flash_tile_rows(int D, int wgmma) {
  using namespace sgdrc::flash;
  int rows = 0;
  with_head_dim(D, [&](auto dim) {
    rows = launch<float, decltype(dim)::value>(wgmma != 0).rows;
    return cudaSuccess;
  });
  return rows;
}

extern "C" int sgdrc_dual_tenant_attention(
    const void* q_ls, const void* k_ls, const void* v_ls, void* out_ls,
    const void* q_be, const void* k_be, const void* v_be, void* out_be,
    const void* order, void* ticket, int dtype, int B_ls, int B_be, int S,
    int H, int Hkv, int D, int n_units, int wgmma, float scale,
    void* stream) {
  using namespace sgdrc::flash;
  if (n_units == 0 || S == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ord = static_cast<const int*>(order);
  int* tk = static_cast<int*>(ticket);
  if (wgmma) {
    return static_cast<int>(sgdrc::with_bf16_or_f16(dtype, [&](auto tag) {
      using T = typename decltype(tag)::type;
      return with_head_dim(D, [&](auto dim) {
        constexpr int kD = decltype(dim)::value;
        constexpr Launch L = launch<T, kD>(true);
        // a tenant with no rows never runs a unit: it borrows the other's
        // maps
        const bool has_ls = B_ls > 0, has_be = B_be > 0;
        const void* bases[6] = {has_ls ? q_ls : q_be, has_ls ? k_ls : k_be,
                                has_ls ? v_ls : v_be, has_be ? q_be : q_ls,
                                has_be ? k_be : k_ls, has_be ? v_be : v_ls};
        const int batch[2] = {has_ls ? B_ls : B_be, has_be ? B_be : B_ls};
        CUtensorMap maps[6];
        for (int i = 0; i < 6; ++i) {
          const bool is_q = i % 3 == 0;
          cudaError_t err = wg::make_heads_map(
              &maps[i], sgdrc::hopper::map_type<T>(), bases[i], batch[i / 3],
              S, is_q ? H : Hkv, kD, is_q ? wg::BQ : wg::Tile<kD>::BK);
          if (err != cudaSuccess) return err;
        }
        auto kernel = dual_wgmma_kernel<T, kD>;
        cudaError_t err = allow_smem(kernel, L.smem);
        if (err != cudaSuccess) return err;
        int blocks = 0;
        err = sgdrc::hopper::resident_blocks(kernel, L.threads, L.smem,
                                             n_units, &blocks);
        if (err != cudaSuccess) return err;
        kernel<<<blocks, L.threads, L.smem, st>>>(
            maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], out_ls,
            out_be, ord, tk, n_units, S, H, Hkv, scale);
        return cudaGetLastError();
      });
    }));
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  DualArgs a{{q_ls, k_ls, v_ls, out_ls, S, H, Hkv},
             {q_be, k_be, v_be, out_be, S, H, Hkv},
             ord,
             tk,
             n_units,
             scale};
  return static_cast<int>(with_head_dim(D, [&](auto dim) {
    constexpr int kD = decltype(dim)::value;
    constexpr Launch L = launch<float, kD>(false);
    auto kernel = dual_kernel<float, kD>;
    cudaError_t err = allow_smem(kernel, L.smem);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = sgdrc::hopper::resident_blocks(kernel, L.threads, L.smem, n_units,
                                         &blocks);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, L.threads, L.smem, st>>>(a);
    return cudaGetLastError();
  }));
}
