// Chunked linear-recurrence scan (SSD / Mamba2) on Hopper:
//   S_t = diag(exp w_t) S_{t-1} + k_t v_t^T,   y_t = q_t . S_t   (inclusive)
// q, k, log_w [B,T,H,K]; v [B,T,H,P] -> y [B,T,H,P] in q's dtype; the
// [K,P] state is f32 and carried across chunks of L tokens.
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan, with the exact
// intra-chunk decay: key i reaches query j (i <= j) through
// exp(s_j - s_i), s the inclusive cumsum of log_w, taken as one exponent
// per pair and channel. On those pairs, and in the cross-chunk factor
// exp(s_j) and the state tail exp(s_L - s_i), every exponent is <= 0, so
// no clamp is needed and nothing overflows. (The Pallas kernel splits the
// decay into exp(s_j) * exp(-s_i) with s clamped to +-20, which loses real
// terms once a chunk's cumulative decay passes -20; below that the two
// agree up to rounding.)
//
// What bounds it on the card: operations, the way it is written. The
// least work is bytes (each input read once, y written once: about 0.1 ms
// at zamba2's mamba2 widths in bf16), but the exact decay costs one
// exponential per (query, key, channel) of each chunk, L(L+1)/2 * K of
// them, on the special-function units, and the products run as f32 FMAs
// on CUDA cores. Design: one block per (batch row, head, 64-column tile of
// P) walks the chunks in order, carrying the state in shared memory; per
// chunk it stages q, k, the cumsum and v in shared memory as f32
// (channel-major, so a warp reads consecutive rows as float4), computes
// the masked decayed scores, then y (intra-chunk + cross-chunk), then the
// state update, each as 4 x 4 register tiles. Inputs are read through
// their strides ([B,T,H,*] views, last axis contiguous, broadcast axes
// allowed); nothing is transposed or copied. Tensor cores and TMA are
// later work.
#include <stdint.h>

#include <algorithm>

#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace sgdrc {
namespace ssd {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;
constexpr int kMaxK = 128;
constexpr int kTileP = 64;
constexpr int kR = 4;  // register tile edge

struct Strides {
  int64_t b, t, h;  // elements; the last axis is contiguous
};

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

// Shared-memory floats of one block: q, k, s as [K][LP]; the scores
// transposed, [L(key)][LP(query)]; v as [L][PT4]; the state as [K][PT4].
// Rows are padded to multiples of 4 floats for float4 reads; the padding
// is never written to an output.
__host__ __device__ inline int64_t smem_floats(int L, int K, int PT) {
  const int LP = round4(L) + 4, PT4 = round4(PT);
  return 3LL * K * LP + (int64_t)L * LP + (int64_t)L * PT4 +
         (int64_t)K * PT4;
}

template <typename E, typename EW>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v, const EW* __restrict__ w,
                    E* __restrict__ y, Strides sq, Strides sk, Strides sv,
                    Strides sw, Strides sy, int T, int K, int P, int L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int p0 = blockIdx.x * kTileP;
  const int h = blockIdx.y, b = blockIdx.z;
  const int PT = min(kTileP, P - p0);
  const int LP = round4(L) + 4, PT4 = round4(PT);
  float* qs = smem;             // [K][LP]: q, then q * exp(s)
  float* ks = qs + K * LP;      // [K][LP]: k, then k * exp(s_L - s)
  float* ss = ks + K * LP;      // [K][LP]: log_w, then its inclusive cumsum
  float* sc = ss + K * LP;      // [L][LP]: sc[i][j] = score of key i, query j
  float* vs = sc + L * LP;      // [L][PT4]
  float* st = vs + L * PT4;     // [K][PT4]: the carried state
  const int tid = threadIdx.x;
  const E* qb = q + b * sq.b + h * sq.h;
  const E* kb = k + b * sk.b + h * sk.h;
  const E* vb = v + b * sv.b + h * sv.h + p0;
  const EW* wb = w + b * sw.b + h * sw.h;
  E* yb = y + b * sy.b + h * sy.h + p0;
  for (int i = tid; i < K * PT4; i += kThreads) st[i] = 0.f;

  const int nl = (L + kR - 1) / kR, nk = (K + kR - 1) / kR,
            np = (PT + kR - 1) / kR;
  for (int c0 = 0; c0 < T; c0 += L) {
    // -- 1: stage the chunk as f32 (rows read coalesced) ----------------
    for (int i = tid; i < L * K; i += kThreads) {
      const int r = i / K, c = i - r * K;
      const int64_t t = c0 + r;
      qs[c * LP + r] = to_f32(qb[t * sq.t + c]);
      ks[c * LP + r] = to_f32(kb[t * sk.t + c]);
      ss[c * LP + r] = to_f32(wb[t * sw.t + c]);
    }
    for (int i = tid; i < L * PT; i += kThreads) {
      const int r = i / PT, c = i - r * PT;
      vs[r * PT4 + c] = to_f32(vb[(int64_t)(c0 + r) * sv.t + c]);
    }
    __syncthreads();
    // -- 2: inclusive cumsum of the log-decay along the chunk ------------
    for (int c = tid; c < K; c += kThreads) {
      float acc = 0.f;
      for (int r = 0; r < L; ++r) {
        acc += ss[c * LP + r];
        ss[c * LP + r] = acc;
      }
    }
    __syncthreads();
    // -- 3: scores[j][i] = sum_c q_jc k_ic exp(s_jc - s_ic), i <= j ------
    // Only the tiles on or below the diagonal (i0 <= j0): step 5 reads no
    // other, so the tiles above it are neither computed nor written.
    for (int tile = tid; tile < nl * (nl + 1) / 2; tile += kThreads) {
      int row = (int)((sqrtf(8.f * tile + 1.f) - 1.f) * 0.5f);
      while ((row + 1) * (row + 2) / 2 <= tile) ++row;
      while (row * (row + 1) / 2 > tile) --row;
      const int j0 = row * kR, i0 = (tile - row * (row + 1) / 2) * kR;
      float acc[kR][kR];
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int e = 0; e < kR; ++e) acc[a][e] = 0.f;
      for (int c = 0; c < K; ++c) {
        const float4 qj = *reinterpret_cast<const float4*>(qs + c * LP + j0);
        const float4 sj = *reinterpret_cast<const float4*>(ss + c * LP + j0);
        const float4 ki = *reinterpret_cast<const float4*>(ks + c * LP + i0);
        const float4 si = *reinterpret_cast<const float4*>(ss + c * LP + i0);
        const float qa[kR] = {qj.x, qj.y, qj.z, qj.w};
        const float sa[kR] = {sj.x, sj.y, sj.z, sj.w};
        const float ke[kR] = {ki.x, ki.y, ki.z, ki.w};
        const float se[kR] = {si.x, si.y, si.z, si.w};
#pragma unroll
        for (int a = 0; a < kR; ++a)
#pragma unroll
          for (int e = 0; e < kR; ++e) {
            // a masked pair takes 0, never the exponential (its exponent
            // may be positive and overflow)
            const float d = (i0 + e <= j0 + a) ? __expf(sa[a] - se[e]) : 0.f;
            acc[a][e] = fmaf(qa[a] * ke[e], d, acc[a][e]);
          }
      }
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int e = 0; e < kR; ++e)
          if (j0 + a < L && i0 + e < L) sc[(i0 + e) * LP + j0 + a] = acc[a][e];
    }
    __syncthreads();
    // -- 4: q_j exp(s_j) and k_i exp(s_L - s_i), in place ----------------
    for (int i = tid; i < K * L; i += kThreads) {
      const int c = i / L, r = i - c * L;
      const float s = ss[c * LP + r];
      qs[c * LP + r] *= __expf(s);
      ks[c * LP + r] *= __expf(ss[c * LP + L - 1] - s);
    }
    __syncthreads();
    // -- 5: y_j = sum_{i<=j} scores_ji v_i + (q_j exp(s_j)) . S ----------
    // (rows i < j0 + 4 of a 4-row tile: scores past the diagonal are 0)
    for (int tile = tid; tile < nl * np; tile += kThreads) {
      const int j0 = (tile / np) * kR, pp = (tile % np) * kR;
      float acc[kR][kR];
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int e = 0; e < kR; ++e) acc[a][e] = 0.f;
      const int i_end = min(j0 + kR, L);
      for (int i = 0; i < i_end; ++i) {
        const float4 s4 = *reinterpret_cast<const float4*>(sc + i * LP + j0);
        const float4 v4 = *reinterpret_cast<const float4*>(vs + i * PT4 + pp);
        const float sa[kR] = {s4.x, s4.y, s4.z, s4.w};
        const float ve[kR] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int a = 0; a < kR; ++a)
#pragma unroll
          for (int e = 0; e < kR; ++e) acc[a][e] = fmaf(sa[a], ve[e], acc[a][e]);
      }
      for (int c = 0; c < K; ++c) {
        const float4 q4 = *reinterpret_cast<const float4*>(qs + c * LP + j0);
        const float4 s4 = *reinterpret_cast<const float4*>(st + c * PT4 + pp);
        const float qa[kR] = {q4.x, q4.y, q4.z, q4.w};
        const float se[kR] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int a = 0; a < kR; ++a)
#pragma unroll
          for (int e = 0; e < kR; ++e) acc[a][e] = fmaf(qa[a], se[e], acc[a][e]);
      }
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        if (j0 + a >= L) break;
        E* row = yb + (int64_t)(c0 + j0 + a) * sy.t;
#pragma unroll
        for (int e = 0; e < kR; ++e)
          if (pp + e < PT) row[pp + e] = from_f32<E>(acc[a][e]);
      }
    }
    __syncthreads();
    // -- 6: S = exp(s_L) S + sum_i (k_i exp(s_L - s_i)) v_i^T ------------
    for (int tile = tid; tile < nk * np; tile += kThreads) {
      const int cc = (tile / np) * kR, pp = (tile % np) * kR;
      float acc[kR][kR];
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        const int c = min(cc + a, K - 1);
        const float decay = __expf(ss[c * LP + L - 1]);
        const float4 s4 = *reinterpret_cast<const float4*>(st + c * PT4 + pp);
        acc[a][0] = decay * s4.x;
        acc[a][1] = decay * s4.y;
        acc[a][2] = decay * s4.z;
        acc[a][3] = decay * s4.w;
      }
      for (int i = 0; i < L; ++i) {
        const float4 v4 = *reinterpret_cast<const float4*>(vs + i * PT4 + pp);
        const float ve[kR] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int a = 0; a < kR; ++a) {
          const float kt = ks[min(cc + a, K - 1) * LP + i];
#pragma unroll
          for (int e = 0; e < kR; ++e) acc[a][e] = fmaf(kt, ve[e], acc[a][e]);
        }
      }
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        if (cc + a >= K) break;
        *reinterpret_cast<float4*>(st + (cc + a) * PT4 + pp) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      }
    }
    __syncthreads();
  }
}

template <typename E, typename EW>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* w, void* y, const Strides* s, int B, int T,
                   int H, int K, int P, int L, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<E, EW>;
  const size_t bytes = smem_floats(L, K, kTileP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kTileP - 1) / kTileP, H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const EW*>(w),
      static_cast<E*>(y), s[0], s[1], s[2], s[3], s[4], T, K, P, L);
  return cudaGetLastError();
}

}  // namespace ssd
}  // namespace sgdrc

// q, k, v, log_w, y: [B,T,H,*] views, last axis contiguous; strides holds
// (b, t, h) element strides of q, k, v, log_w and y, in that order.
// dtype: q/k/v/y; wdtype: log_w (codes of kernels/_build.py DTYPE_CODES).
extern "C" int sgdrc_ssd_scan(const void* q, const void* k, const void* v,
                              const void* log_w, void* y, int dtype,
                              int wdtype, int B, int T, int H, int K, int P,
                              int L, const int64_t* strides, void* stream) {
  using namespace sgdrc;
  if (B <= 0 || T <= 0 || H <= 0 || P <= 0) return 0;
  if (L <= 0 || L > ssd::kMaxChunk || T % L != 0 || K <= 0 ||
      K > ssd::kMaxK || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  ssd::Strides s[5];
  for (int i = 0; i < 5; ++i)
    s[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    return with_dtype(wdtype, [&](auto wtag) {
      using EW = typename decltype(wtag)::type;
      return ssd::launch<E, EW>(q, k, v, log_w, y, s, B, T, H, K, P, L, st);
    });
  }));
}
