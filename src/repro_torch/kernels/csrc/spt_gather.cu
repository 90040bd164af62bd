// Page gather and scatter through a shadow page table (SPT).
// Replaces src/repro/kernels/spt_gather.py::spt_gather (out[i] =
// arena[spt[i]]) and ::spt_scatter (arena[spt[i]] = x[i], into an arena the
// wrapper zeroes with torch.zeros; this kernel allocates nothing).
//
// What bounds it on the card: bytes. Each page is read once and written
// once, and the SPT costs 4 bytes a page. One warp copies one page at a
// time with 16-byte vectors (when the page size and both base addresses
// allow; else 8, 4 or 1 bytes), four vectors in flight a lane, and the warps
// walk the pages grid-stride. Offsets are int64: an arena may exceed 2 GiB.
// The copy is bit-exact.
//
// Entries outside the arena are clamped into it by gather and dropped by
// scatter, so a bad SPT cannot fault the card; both are outside the
// contract (entries in range, and unique for scatter), which the wrapper
// does not check on the card, since that costs a host sync.
#include <stdint.h>

#include <algorithm>

#include <cuda_runtime.h>

namespace sgdrc {
namespace spt {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename V>
__global__ void __launch_bounds__(kThreads)
    copy_pages(const char* __restrict__ src, char* __restrict__ dst,
               const int* __restrict__ spt, int64_t n, int64_t row_bytes,
               int64_t src_rows, int64_t dst_rows, bool scatter) {
  const int64_t nv = row_bytes / (int64_t)sizeof(V);
  const int lane = threadIdx.x % 32;
  const int64_t n_warps = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t w = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / 32; w < n;
       w += n_warps) {
    const int64_t p = spt[w];
    int64_t s_row = w, d_row = w;
    if (scatter) {
      if (p < 0 || p >= dst_rows) continue;
      d_row = p;
    } else {
      s_row = p < 0 ? 0 : (p >= src_rows ? src_rows - 1 : p);
    }
    const V* s = reinterpret_cast<const V*>(src + s_row * row_bytes);
    V* d = reinterpret_cast<V*>(dst + d_row * row_bytes);
    for (int64_t i0 = lane; i0 < nv; i0 += 32 * kUnroll) {
      V tmp[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i0 + 32 * u < nv) tmp[u] = s[i0 + 32 * u];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i0 + 32 * u < nv) d[i0 + 32 * u] = tmp[u];
    }
  }
}

template <typename V>
cudaError_t launch(const void* src, void* dst, const int* spt, int64_t n,
                   int64_t row_bytes, int64_t src_rows, int64_t dst_rows,
                   bool scatter, cudaStream_t st) {
  const int64_t warps_per_block = kThreads / 32;
  const int64_t blocks =
      std::min<int64_t>((n + warps_per_block - 1) / warps_per_block, 65535);
  copy_pages<V><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const char*>(src), static_cast<char*>(dst), spt, n,
      row_bytes, src_rows, dst_rows, scatter);
  return cudaGetLastError();
}

int copy(const void* src, void* dst, const void* spt, int64_t n,
         int64_t row_bytes, int64_t src_rows, int64_t dst_rows, bool scatter,
         void* stream) {
  if (n == 0 || row_bytes == 0) return 0;
  if (src_rows <= 0 && !scatter)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* s = static_cast<const int*>(spt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) |
                          reinterpret_cast<uintptr_t>(dst) |
                          static_cast<uintptr_t>(row_bytes);
  cudaError_t err;
  if (align % 16 == 0)
    err = launch<uint4>(src, dst, s, n, row_bytes, src_rows, dst_rows,
                        scatter, st);
  else if (align % 8 == 0)
    err = launch<uint2>(src, dst, s, n, row_bytes, src_rows, dst_rows,
                        scatter, st);
  else if (align % 4 == 0)
    err = launch<unsigned>(src, dst, s, n, row_bytes, src_rows, dst_rows,
                           scatter, st);
  else
    err = launch<unsigned char>(src, dst, s, n, row_bytes, src_rows,
                                dst_rows, scatter, st);
  return static_cast<int>(err);
}

}  // namespace spt
}  // namespace sgdrc

// arena [src_rows, row_bytes] -> out [n, row_bytes]: out[i] = arena[spt[i]]
extern "C" int sgdrc_spt_gather(const void* arena, void* out, const void* spt,
                                int64_t n, int64_t row_bytes,
                                int64_t src_rows, int64_t dst_rows,
                                void* stream) {
  return sgdrc::spt::copy(arena, out, spt, n, row_bytes, src_rows, dst_rows,
                          false, stream);
}

// x [n, row_bytes] -> arena [dst_rows, row_bytes]: arena[spt[i]] = x[i]
extern "C" int sgdrc_spt_scatter(const void* x, void* arena, const void* spt,
                                 int64_t n, int64_t row_bytes,
                                 int64_t src_rows, int64_t dst_rows,
                                 void* stream) {
  return sgdrc::spt::copy(x, arena, spt, n, row_bytes, src_rows, dst_rows,
                          true, stream);
}
