// Tiled GQA self-attention: causal or not, local window, logit softcap.
// Replaces src/repro/kernels/flash_attention.py::flash_attention (see
// flash_core.cuh for what a tile computes, what bounds it and why
// dual_tenant_attention.cu gives the same bits).
//
// Grid: (ceil(S / BQ), H, B), one query tile per block; the TPU kernel's
// sequential kv grid axis is the key loop inside the tile.
#include "flash_core.cuh"

namespace sgdrc {
namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(Heads a, int causal, int window, float scale, float softcap) {
  extern __shared__ float smem[];
  tile<T, D>(a, blockIdx.z, blockIdx.y, blockIdx.x * Tile<D>::BQ, causal != 0,
             window, softcap, scale, smem);
}

}  // namespace flash
}  // namespace sgdrc

extern "C" int sgdrc_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int dtype,
                                     int B, int S, int H, int Hkv, int D,
                                     int causal, int window, float scale,
                                     float softcap, void* stream) {
  using namespace sgdrc::flash;
  if (B == 0 || S == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Heads a{q, k, v, out, S, H, Hkv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(sgdrc::with_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return with_head_dim(D, [&](auto dim) {
      constexpr int kD = decltype(dim)::value;
      constexpr int bytes = smem_floats<kD>() * sizeof(float);
      cudaError_t err = allow_smem(flash_kernel<T, kD>, bytes);
      if (err != cudaSuccess) return err;
      const dim3 grid((S + Tile<kD>::BQ - 1) / Tile<kD>::BQ, H, B);
      flash_kernel<T, kD><<<grid, kThreads, bytes, st>>>(a, causal, window,
                                                         scale, softcap);
      return cudaGetLastError();
    });
  }));
}
