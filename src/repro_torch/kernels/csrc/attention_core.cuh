// Cached-context GQA attention for Hopper: one templated kernel body behind
// the four entry points of decode_attention.cu and prefill_attention.cu.
//
// Replaces the Pallas online-softmax bodies of
//   src/repro/kernels/decode_attention.py  (_kernel, decode_attention[_paged])
//   src/repro/kernels/prefill_attention.py (_kernel, prefill_attention[_paged])
//
// What it computes. For batch row b and KV head h the query rows are the
// Sq chunk positions times the G = H / Hkv query heads of that KV head,
// flattened as row = s * G + g. Row `row` sits at position pos[b] + row / G
// and attends to the keys t <= that position (and row / G < abort[b]).
// Keys live in a dense cache (key t at b*s0 + h*sh + t*ss) or in a page pool
// (key t at page_table[b, t / page_size] clamped to [0, n_pages-1], offset
// t % page_size). Softmax state (m, l, acc) is f32 with the reference's
// finite NEG_INF = -1e30, and the result is acc / max(l, 1e-30): a row that
// sees no key comes out finite, never NaN.
//
// What bounds it on the card: the bytes of K and V read (decode and short
// chunks do ~2 flops per byte, far below the H100's ~295 flops/byte ridge).
// The design reads only the keys a block needs: a row block stops at the
// last position its rows may see (pos + min(last row, abort - 1)), never past
// the row's window, so per-row traffic scales with the row's length and not
// with Smax or the page-table width; a key tile is loaded once into shared
// memory and used by every query row of the block (all G heads of one KV
// head, and ROWS chunk rows at once in prefill). This is the simple, correct
// form: no tensor cores, no TMA, no split over keys (later work).
//
// Grid: (ceil(Sq*G / ROWS), Hkv, B); 128 threads. The TPU kernel's
// sequential kv grid axis becomes the loop over key tiles inside the block.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sgdrc {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kTileK = 32;  // keys per tile: one key per lane of a warp
constexpr int kNoPos = -2147483647 - 1;  // a row that may see no key

struct AttnArgs {
  const void* q;
  void* out;
  const void* k;
  const void* v;
  const int* pos;         // [B] chunk start (decode: the token's position)
  const int* abort;       // [B] position cap, or null (= Sq)
  int* progress;          // [B] min(abort, Sq), or null
  const int* page_table;  // [B, pt_stride], or null for a dense cache
  int B, Sq, H, Hkv;
  int window;     // keys a row can address: Smax, or P * page_size
  int page_size;  // 0 for a dense cache
  int pt_stride;
  int n_pages;
  int64_t q_sb, q_ss, q_sh;  // q [B, Sq, H, D], element strides
  int64_t o_sb, o_ss, o_sh;  // out, same shape
  int64_t k_s0, k_sh, k_ss;  // dense: (b, h, t); paged: (page, h, offset)
  int64_t v_s0, v_sh, v_ss;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(kThreads) attention_kernel(AttnArgs a) {
  static_assert((ROWS * D) % kThreads == 0, "ROWS * D must fill the block");
  constexpr int kPerThread = ROWS * D / kThreads;
  constexpr int kWarps = kThreads / 32;

  __shared__ float q_s[ROWS][D];
  __shared__ float k_s[kTileK][D + 1];  // +1: conflict-free column reads
  __shared__ float v_s[kTileK][D];
  __shared__ float p_s[ROWS][kTileK];
  __shared__ float m_s[ROWS], l_s[ROWS], alpha_s[ROWS];
  __shared__ int qpos_s[ROWS];
  __shared__ int64_t koff_s[kTileK], voff_s[kTileK];

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.H / a.Hkv;
  const int n_rows = a.Sq * G;
  const int row0 = tile * ROWS;
  const int pos = a.pos[b];
  int cap = a.abort ? a.abort[b] : a.Sq;
  cap = min(max(cap, 0), a.Sq);
  if (a.progress != nullptr && tile == 0 && h == 0 && tid == 0)
    a.progress[b] = cap;

  // keys this block visits: up to the last position any of its rows may
  // see, and never past the row's window (the sentinel row pos == window
  // must not address key `window`, nor page-table column P)
  const int s_hi = min((min(row0 + ROWS, n_rows) - 1) / G, cap - 1);
  int n_keys = 0;
  if (s_hi >= 0) n_keys = max(min(pos + s_hi, a.window - 1) + 1, 0);

  const T* q = static_cast<const T*>(a.q);
  for (int i = tid; i < ROWS * D; i += kThreads) {
    const int r = i / D, d = i % D, row = row0 + r;
    float x = 0.f;
    if (row < n_rows) {
      const int s = row / G, g = row % G;
      x = to_f32(q[b * a.q_sb + s * a.q_ss + (int64_t)(h * G + g) * a.q_sh +
                   d]) *
          a.scale;
    }
    q_s[r][d] = x;
  }
  if (tid < ROWS) {
    const int row = row0 + tid, s = row / G;
    qpos_s[tid] = (row < n_rows && s < cap) ? pos + s : kNoPos;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) acc[e] = 0.f;

  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  for (int k0 = 0; k0 < n_keys; k0 += kTileK) {
    __syncthreads();
    if (tid < kTileK) {
      const int t = k0 + tid;
      int64_t ko = -1, vo = -1;
      if (t < n_keys) {
        if (a.page_table != nullptr) {
          const int j = t / a.page_size, off = t - j * a.page_size;
          int pg = a.page_table[(int64_t)b * a.pt_stride + j];
          pg = min(max(pg, 0), a.n_pages - 1);
          ko = pg * a.k_s0 + h * a.k_sh + off * a.k_ss;
          vo = pg * a.v_s0 + h * a.v_sh + off * a.v_ss;
        } else {
          ko = b * a.k_s0 + h * a.k_sh + t * a.k_ss;
          vo = b * a.v_s0 + h * a.v_sh + t * a.v_ss;
        }
      }
      koff_s[tid] = ko;
      voff_s[tid] = vo;
    }
    __syncthreads();
    for (int i = tid; i < kTileK * D; i += kThreads) {
      const int kk = i / D, d = i % D;
      const int64_t ko = koff_s[kk], vo = voff_s[kk];
      k_s[kk][d] = ko >= 0 ? to_f32(kp[ko + d]) : 0.f;
      v_s[kk][d] = vo >= 0 ? to_f32(vp[vo + d]) : 0.f;
    }
    __syncthreads();

    // scores: one (row, key) dot product per thread and step
    for (int i = tid; i < ROWS * kTileK; i += kThreads) {
      const int r = i / kTileK, kk = i % kTileK, t = k0 + kk;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(q_s[r][d], k_s[kk][d], s);
      p_s[r][kk] = (t < n_keys && t <= qpos_s[r]) ? s : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per row, one key per lane
    for (int r = warp; r < ROWS; r += kWarps) {
      const float s = p_s[r][lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[r][lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v, one (row, d) element per slot
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int idx = tid + e * kThreads, r = idx / D, d = idx % D;
      float pv = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < kTileK; ++kk) pv = fmaf(p_s[r][kk], v_s[kk][d], pv);
      acc[e] = acc[e] * alpha_s[r] + pv;
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int idx = tid + e * kThreads, r = idx / D, d = idx % D;
    const int row = row0 + r;
    if (row < n_rows) {
      const int s = row / G, g = row % G;
      out[b * a.o_sb + s * a.o_ss + (int64_t)(h * G + g) * a.o_sh + d] =
          from_f32<T>(acc[e] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename T, int ROWS>
cudaError_t launch_typed(const AttnArgs& a, int D, cudaStream_t stream) {
  const int G = a.H / a.Hkv;
  const dim3 grid((a.Sq * G + ROWS - 1) / ROWS, a.Hkv, a.B);
  switch (D) {
    case 32:
      attention_kernel<T, 32, ROWS><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 64:
      attention_kernel<T, 64, ROWS><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 128:
      attention_kernel<T, 128, ROWS><<<grid, kThreads, 0, stream>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16, 2 float16
template <int ROWS>
int launch(const AttnArgs& a, int dtype, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_typed<float, ROWS>(a, D, s);
      break;
    case 1:
      err = launch_typed<__nv_bfloat16, ROWS>(a, D, s);
      break;
    case 2:
      err = launch_typed<__half, ROWS>(a, D, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// One C signature for all four entry points (ctypes binds it once).
#define SGDRC_ATTENTION_ENTRY(NAME, ROWS)                                     \
  extern "C" int NAME(                                                        \
      const void* q, void* out, const void* k, const void* v,                 \
      const void* pos, const void* abort_cap, void* progress,                 \
      const void* page_table, int dtype, int B, int Sq, int H, int Hkv,       \
      int D, int window, int page_size, int pt_stride, int n_pages,           \
      int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t o_sb, int64_t o_ss,   \
      int64_t o_sh, int64_t k_s0, int64_t k_sh, int64_t k_ss, int64_t v_s0,   \
      int64_t v_sh, int64_t v_ss, float scale, void* stream) {                \
    sgdrc::AttnArgs a;                                                        \
    a.q = q;                                                                  \
    a.out = out;                                                              \
    a.k = k;                                                                  \
    a.v = v;                                                                  \
    a.pos = static_cast<const int*>(pos);                                     \
    a.abort = static_cast<const int*>(abort_cap);                             \
    a.progress = static_cast<int*>(progress);                                 \
    a.page_table = static_cast<const int*>(page_table);                       \
    a.B = B;                                                                  \
    a.Sq = Sq;                                                                \
    a.H = H;                                                                  \
    a.Hkv = Hkv;                                                              \
    a.window = window;                                                        \
    a.page_size = page_size;                                                  \
    a.pt_stride = pt_stride;                                                  \
    a.n_pages = n_pages;                                                      \
    a.q_sb = q_sb;                                                            \
    a.q_ss = q_ss;                                                            \
    a.q_sh = q_sh;                                                            \
    a.o_sb = o_sb;                                                            \
    a.o_ss = o_ss;                                                            \
    a.o_sh = o_sh;                                                            \
    a.k_s0 = k_s0;                                                            \
    a.k_sh = k_sh;                                                            \
    a.k_ss = k_ss;                                                            \
    a.v_s0 = v_s0;                                                            \
    a.v_sh = v_sh;                                                            \
    a.v_ss = v_ss;                                                            \
    a.scale = scale;                                                          \
    if (B == 0 || Sq == 0) return 0;                                          \
    return sgdrc::launch<ROWS>(a, dtype, D, stream);                          \
  }

}  // namespace sgdrc
