// What both tile bodies of chunked-prefill attention share (prefill_simt.cuh
// on CUDA cores, prefill_wgmma.cuh on tensor cores): the launch arguments,
// the reference's finite NEG_INF, and which keys a run of query rows sees.
//
// The contract. For batch row b and KV head h the query rows are the Sq
// chunk positions times the G = H / Hkv query heads of that KV head,
// flattened as row = s * G + g. Row `row` sits at position pos[b] + row / G
// and sees the keys t <= that position, t < window, and only if row / G <
// cap = clamp(abort[b], 0, Sq). Keys live in a dense cache (key t at b*s0 +
// h*sh + t*ss) or in a page pool (key t at page_table[b, t / page_size]
// clamped to [0, n_pages-1], offset t % page_size). Softmax state (m, l, acc)
// is f32 with the finite NEG_INF = -1e30, the result is acc / max(l, 1e-30)
// (a row that sees no key comes out finite, never NaN), and progress[b] =
// cap.
#pragma once

#include <stdint.h>

#include "dtypes.cuh"

namespace sgdrc {

constexpr float kNegInf = -1e30f;
constexpr int kNoPos = -2147483647 - 1;  // a row that may see no key

struct AttnArgs {
  const void* q;
  void* out;
  const void* k;
  const void* v;
  const int* pos;         // [B] chunk start
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

// Keys a run of flattened rows [r_lo, r_hi) may see: up to the position of
// its last live row (below cap), never past the window (the sentinel row
// pos == window must not address key `window`, nor page-table column P); 0
// when no row of it is live.
__device__ __forceinline__ int keys_seen(const AttnArgs& a, int pos, int cap,
                                         int G, int r_lo, int r_hi) {
  const int n_rows = a.Sq * G;
  if (r_lo >= n_rows || r_lo / G >= cap) return 0;
  const int s_hi = min((min(r_hi, n_rows) - 1) / G, cap - 1);
  return max(min(pos + s_hi, a.window - 1) + 1, 0);
}

}  // namespace sgdrc
