// Cached-context GQA attention on CUDA cores: the kernel body of the "simt"
// route of prefill_attention.cu (f32, f16, and bf16 at D 32; bf16 at D 64
// and 128 takes the tensor-core body of prefill_wgmma.cuh, which computes
// the same contract). Decode has its own split-K body, decode_attention.cu.
//
// Replaces the Pallas online-softmax body of
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
// What bounds it on the card: the bytes of K and V read at short chunks,
// the f32 FMAs at long ones (no tensor cores here).
// The design reads only the keys a block needs: a row block stops at the
// last position its rows may see (pos + min(last row, abort - 1)), never past
// the row's window, so per-row traffic scales with the row's length and not
// with Smax or the page-table width; a key tile is loaded once into shared
// memory and used by every query row of the block (all G heads of one KV
// head, and ROWS chunk rows at once). Key tiles sit at absolute positions
// 0, 32, ..., so a row's bits do not depend on the rows beside it.
//
// Grid: (ceil(Sq*G / ROWS), Hkv, B); 128 threads. The TPU kernel's
// sequential kv grid axis becomes the loop over key tiles inside the block.
#pragma once

#include <stdint.h>

#include "dtypes.cuh"

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

}  // namespace sgdrc
