// Tiled GQA self-attention: causal or not, local window, logit softcap.
// Replaces src/repro/kernels/flash_attention.py::flash_attention.
//
// Two routes, picked by the wrapper (flash_attention.py::route) before the
// launch and passed as `wgmma`: bf16 and f16 run flash_wgmma.cuh's
// tensor-core body (TMA, wgmma, 128-row query tiles); f32 runs
// flash_simt.cuh's CUDA-core body (64-row query tiles, register-tiled f32
// FMAs fed by bulk copies), which refuses bf16 and f16. Each
// header says what its tile computes, what bounds it and why
// dual_tenant_attention.cu gives the same bits. Both copy q, k and v 16
// bytes at a time, so the tensors start on 16-byte boundaries (the
// wrapper's aligned16).
//
// Grid: (H * B, ceil(S / BQ)), one query tile per block; the TPU kernel's
// sequential kv grid axis is the key loop inside the tile. Blocks start in
// index order, x fastest, so tile qi = nq - 1 - blockIdx.y: under causal
// masking the heaviest tiles (the last rows see the most keys) start first
// and the light ones fill the tail. The order changes no bit.
#include "flash_wgmma.cuh"

namespace sgdrc {
namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_kernel(Heads a, int causal, int window, float scale, float softcap) {
  extern __shared__ __align__(16) uint8_t simt_smem[];
  init<T, D>(simt_smem);
  Pipe pipe;
  const int qi = gridDim.y - 1 - blockIdx.y;
  tile<T, D>(a, blockIdx.x / a.H, blockIdx.x % a.H, qi * BQ, causal != 0,
             window, softcap, scale, simt_smem, pipe);
}

template <typename T, int D>
__global__ void __launch_bounds__(wg::kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, void* out,
                       int S, int H, int Hkv, int causal, int window,
                       float scale, float softcap) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sgdrc::hopper::align1024(smem_raw);
  wg::init<D>(smem);
  const wg::Maps a{&q_map, &k_map, &v_map, out, S, H, Hkv};
  wg::Pipe pipe;
  const int qi = gridDim.y - 1 - blockIdx.y;
  wg::tile<T, D>(a, blockIdx.x / H, blockIdx.x % H, qi * wg::BQ, causal != 0,
              window, softcap, scale, smem, pipe);
}

}  // namespace flash
}  // namespace sgdrc

extern "C" int sgdrc_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int dtype,
                                     int B, int S, int H, int Hkv, int D,
                                     int causal, int window, int wgmma,
                                     float scale, float softcap,
                                     void* stream) {
  using namespace sgdrc::flash;
  if (B == 0 || S == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wgmma) {
    return static_cast<int>(sgdrc::with_bf16_or_f16(dtype, [&](auto tag) {
      using T = typename decltype(tag)::type;
      return with_head_dim(D, [&](auto dim) {
        constexpr int kD = decltype(dim)::value;
        constexpr Launch L = launch<T, kD>(true);
        CUtensorMap maps[3];
        const void* bases[3] = {q, k, v};
        const int heads[3] = {H, Hkv, Hkv};
        for (int i = 0; i < 3; ++i) {
          cudaError_t err = wg::make_heads_map(
              &maps[i], sgdrc::hopper::map_type<T>(), bases[i], B, S,
              heads[i], kD, i == 0 ? wg::BQ : wg::Tile<kD>::BK);
          if (err != cudaSuccess) return err;
        }
        cudaError_t err = allow_smem(flash_wgmma_kernel<T, kD>, L.smem);
        if (err != cudaSuccess) return err;
        const dim3 grid(H * B, (S + L.rows - 1) / L.rows);
        flash_wgmma_kernel<T, kD><<<grid, L.threads, L.smem, st>>>(
            maps[0], maps[1], maps[2], out, S, H, Hkv, causal, window, scale,
            softcap);
        return cudaGetLastError();
      });
    }));
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Heads a{q, k, v, out, S, H, Hkv};
  return static_cast<int>(with_head_dim(D, [&](auto dim) {
    constexpr int kD = decltype(dim)::value;
    constexpr Launch L = launch<float, kD>(false);
    cudaError_t err = allow_smem(flash_kernel<float, kD>, L.smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(H * B, (S + L.rows - 1) / L.rows);
    flash_kernel<float, kD><<<grid, L.threads, L.smem, st>>>(
        a, causal, window, scale, softcap);
    return cudaGetLastError();
  }));
}
