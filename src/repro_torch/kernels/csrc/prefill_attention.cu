// Chunked-prefill GQA flash attention over a dense KV-major cache or a page
// pool, with the abort/progress protocol. Replaces
// src/repro/kernels/prefill_attention.py::prefill_attention and
// ::prefill_attention_paged. Two tile bodies, picked by the caller's route
// before the launch (kernels/prefill_attention.py::route):
//   wgmma: bf16 and f16 at head dims 64 and 128, on the tensor cores
//          (prefill_wgmma.cuh: units of 128 flattened query rows, key tiles
//          of 128 at absolute positions, 16-byte cp.async into swizzled
//          tiles);
//   simt:  f32 at head dims 32, 64 and 128, and bf16 and f16 at 32, on CUDA
//          cores (prefill_simt.cuh: units of 64 flattened query rows, key
//          tiles of 128 at absolute positions, register-tiled f32 FMAs,
//          bulk copies into shared memory).
// Both stop a unit at the last key its own rows may see (causal), and rows
// at or past the abort cap see no key.
#include <type_traits>

#include "prefill_args.cuh"
#include "prefill_simt.cuh"
#include "prefill_wgmma.cuh"

namespace sgdrc {
namespace {

// The simt route: bf16 and f16 only at D 32 (their D 64 and 128 take the
// wgmma route, so they are not instantiated here).
template <typename T>
cudaError_t launch_simt(const AttnArgs& a, int D, cudaStream_t stream) {
  if (D == 32) return simt::launch<T, 32>(a, stream);
  if constexpr (std::is_same_v<T, float>) {
    if (D == 64) return simt::launch<T, 64>(a, stream);
    if (D == 128) return simt::launch<T, 128>(a, stream);
  }
  return cudaErrorInvalidValue;
}

// The wgmma route: bf16 and f16 at D 64 and 128.
cudaError_t launch_wgmma(const AttnArgs& a, int dtype, int D,
                         cudaStream_t stream) {
  return with_bf16_or_f16(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if (D == 64) return prefill::launch<T, 64>(a, stream);
    if (D == 128) return prefill::launch<T, 128>(a, stream);
    return cudaErrorInvalidValue;
  });
}

}  // namespace
}  // namespace sgdrc

extern "C" int sgdrc_prefill_attention(
    const void* q, void* out, const void* k, const void* v, const void* pos,
    const void* abort_cap, void* progress, const void* page_table, int dtype,
    int B, int Sq, int H, int Hkv, int D, int use_wgmma, int window,
    int page_size, int pt_stride, int n_pages, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t k_s0,
    int64_t k_sh, int64_t k_ss, int64_t v_s0, int64_t v_sh, int64_t v_ss,
    float scale, void* stream) {
  sgdrc::AttnArgs a;
  a.q = q;
  a.out = out;
  a.k = k;
  a.v = v;
  a.pos = static_cast<const int*>(pos);
  a.abort = static_cast<const int*>(abort_cap);
  a.progress = static_cast<int*>(progress);
  a.page_table = static_cast<const int*>(page_table);
  a.B = B;
  a.Sq = Sq;
  a.H = H;
  a.Hkv = Hkv;
  a.window = window;
  a.page_size = page_size;
  a.pt_stride = pt_stride;
  a.n_pages = n_pages;
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.o_sb = o_sb;
  a.o_ss = o_ss;
  a.o_sh = o_sh;
  a.k_s0 = k_s0;
  a.k_sh = k_sh;
  a.k_ss = k_ss;
  a.v_s0 = v_s0;
  a.v_sh = v_sh;
  a.v_ss = v_ss;
  a.scale = scale;
  if (B == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_wgmma) return static_cast<int>(sgdrc::launch_wgmma(a, dtype, D, st));
  return static_cast<int>(sgdrc::with_dtype(dtype, [&](auto tag) {
    return sgdrc::launch_simt<typename decltype(tag)::type>(a, D, st);
  }));
}
