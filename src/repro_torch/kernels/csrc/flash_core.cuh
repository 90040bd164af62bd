// The CUDA-core tile body of GQA self-attention (the "simt" route: f32 and
// f16), shared by flash_attention.cu and dual_tenant_attention.cu; bf16
// takes the tensor-core body of flash_wgmma.cuh (the "wgmma" route), which
// computes the same function.
//
// Replaces the Pallas online-softmax bodies of
//   src/repro/kernels/flash_attention.py       (_kernel, flash_attention)
//   src/repro/kernels/dual_tenant_attention.py
//     (_kernel, dual_tenant_attention)
//
// What it computes. One call handles one query tile: BQ consecutive query
// positions q0.. of head h of batch row b, against kv head h / (H / Hkv).
// q, k, v and out are contiguous [B, S, H or Hkv, D]. Query s sees key t
// when t <= s (causal) and t > s - window (window > 0); the scores are
// q.k * D^-0.5 in f32, capped as c * tanh(s / c) when softcap c > 0, then
// masked to the finite NEG_INF = -1e30 (never -inf: a wholly masked first
// tile must not turn into NaN). Softmax state (m, l, acc) is f32 and the
// result is acc / max(l, 1e-30), rounded once to the output type.
//
// Bit identity. dual_tenant_attention must equal flash_attention bit for
// bit, so both kernels run this one function on the same data, and every
// floating-point operation in it is an explicit round-to-nearest intrinsic
// (__fmaf_rn, __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn) that the compiler
// may neither contract nor reorder; the same tile sizes for a given D and
// the same key-tile order fix the rest. The key loop starts at the tile
// holding the first row's window start and stops at the tile holding the
// last row's causal diagonal. Tiles outside that range would change no bit:
// past the diagonal every entry is masked, so p = 0 and alpha = 1; before a
// row's window, p = exp(0) = 1 fills (l, acc) with finite values that the
// first visible key wipes exactly with alpha = exp(-1e30 - m) = 0.
//
// What bounds it on the card: operations. A tile does 4 * D flops for each
// (query, key) pair it visits, from BQ + BK rows loaded once into shared
// memory; at the H100's 295 bf16 flops a byte, that is the tensor cores'
// 989 TFLOP/s, not HBM. Per route:
//   simt (this body): f32 FMAs on CUDA cores, bound by their 67 TFLOP/s
//   and by shared-memory loads (2-3 FMAs a load), with a register tile of
//   RM query rows by CN keys (scores) and RM rows by DN head dims
//   (accumulator) per thread. It stays for f32, whose 2e-5 tolerance TF32
//   tensor cores would break, and for f16.
//   wgmma (flash_wgmma.cuh): both products on the tensor cores in bf16 with
//   f32 accumulators, fed by TMA through a two-stage ring, 128 query rows
//   sharing each K/V tile.
//
// Block: 128 threads as a 16 x 8 grid (ty, tx). Thread (ty, tx) owns query
// rows ty + 16 i, keys tx + 8 j of the score tile and head dims tx + 8 jj of
// the accumulator; the 8 threads of a row are 8 consecutive lanes of one
// warp, so a row's max and sum are three xor shuffles.
#pragma once

#include <stdint.h>

#include "dtypes.cuh"

namespace sgdrc {
namespace flash {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kTX = 8;   // threads across a row's keys and head dims
constexpr int kTY = 16;  // thread rows

// Tile sizes by head dim: the f32 accumulator is RM * DN = 32-64 registers a
// thread, and shared memory (66-103 KB) lets two or three blocks share an SM.
template <int D>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int BQ = 64, BK = 64;
};
template <>
struct Tile<128> {
  static constexpr int BQ = 64, BK = 32;
};
template <>
struct Tile<256> {
  static constexpr int BQ = 32, BK = 32;
};

template <int D>
constexpr int smem_floats() {
  return Tile<D>::BQ * (D + 1) + Tile<D>::BK * (D + 1) + Tile<D>::BK * D +
         Tile<D>::BQ * (Tile<D>::BK + 1);
}

struct Heads {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int S, H, Hkv;
};

template <typename T, int D>
__device__ __forceinline__ void tile(const Heads& a, int b, int h, int q0,
                                     bool causal, int window, float softcap,
                                     float scale, float* smem) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK;
  constexpr int RM = BQ / kTY, CN = BK / kTX, DN = D / kTX;
  constexpr int QS = D + 1, KS = D + 1, PS = BK + 1;  // +1: no bank conflicts
  static_assert(BQ % kTY == 0 && BK % kTX == 0 && D % kTX == 0, "tile");
  float* q_s = smem;           // [BQ][QS], pre-scaled
  float* k_s = q_s + BQ * QS;  // [BK][KS]
  float* v_s = k_s + BK * KS;  // [BK][D]
  float* p_s = v_s + BK * D;   // [BQ][PS]

  const int S = a.S;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int hk = h / (a.H / a.Hkv);
  const int64_t q_row = (int64_t)a.H * D, kv_row = (int64_t)a.Hkv * D;
  const T* qb = static_cast<const T*>(a.q) + ((int64_t)b * S * a.H + h) * D;
  const T* kb = static_cast<const T*>(a.k) + ((int64_t)b * S * a.Hkv + hk) * D;
  const T* vb = static_cast<const T*>(a.v) + ((int64_t)b * S * a.Hkv + hk) * D;

  __syncthreads();  // a persistent block's previous tile is done with smem
  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    q_s[r * QS + d] =
        s < S ? __fmul_rn(to_f32(qb[s * q_row + d]), scale) : 0.f;
  }

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DN; ++jj) acc[i][jj] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = kv_begin / BK * BK; k0 < kv_end; k0 += BK) {
    __syncthreads();  // q_s written; last tile's k_s, v_s, p_s all read
    for (int i = tid; i < BK * D; i += kThreads) {
      const int kk = i / D, d = i % D, t = k0 + kk;
      float kx = 0.f, vx = 0.f;
      if (t < S) {
        kx = to_f32(kb[t * kv_row + d]);
        vx = to_f32(vb[t * kv_row + d]);
      }
      k_s[kk * KS + d] = kx;
      v_s[kk * D + d] = vx;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[RM], kc[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qa[i] = q_s[(ty + kTY * i) * QS + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kc[j] = k_s[(tx + kTX * j) * KS + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j)
          s[i][j] = __fmaf_rn(qa[i], kc[j], s[i][j]);
    }

    // online softmax, per row: the 8 threads of a row hold its BK scores
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qp = q0 + ty + kTY * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kp = k0 + tx + kTX * j;
        float x = s[i][j];
        if (softcap > 0.f)
          x = __fmul_rn(softcap, tanhf(__fdiv_rn(x, softcap)));
        const bool ok = kp < S && (!causal || kp <= qp) &&
                        (window <= 0 || kp > qp - window);
        x = ok ? x : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = kTX / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(__fsub_rn(s[i][j], m_new));
        s[i][j] = p;
        sum = __fadd_rn(sum, p);
      }
#pragma unroll
      for (int o = kTX / 2; o > 0; o >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
      const float alpha = expf(__fsub_rn(m[i], m_new));
      l[i] = __fmaf_rn(l[i], alpha, sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DN; ++jj)
        acc[i][jj] = __fmul_rn(acc[i][jj], alpha);
#pragma unroll
      for (int j = 0; j < CN; ++j)
        p_s[(ty + kTY * i) * PS + tx + kTX * j] = s[i][j];
    }
    __syncthreads();

    // acc += p @ v over the tile's keys, in key order
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pr[RM], vr[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) pr[i] = p_s[(ty + kTY * i) * PS + kk];
#pragma unroll
      for (int jj = 0; jj < DN; ++jj) vr[jj] = v_s[kk * D + tx + kTX * jj];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int jj = 0; jj < DN; ++jj)
          acc[i][jj] = __fmaf_rn(pr[i], vr[jj], acc[i][jj]);
    }
  }

  T* ob = static_cast<T*>(a.out) + ((int64_t)b * S * a.H + h) * D;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int s = q0 + ty + kTY * i;
    if (s >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DN; ++jj)
      ob[s * q_row + tx + kTX * jj] = from_f32<T>(__fdiv_rn(acc[i][jj], den));
  }
}

// Calls f(Dim<D>{}) for a supported head dim; f returns cudaError_t.
template <int D>
struct Dim {
  static constexpr int value = D;
};

template <typename F>
cudaError_t with_head_dim(int D, F&& f) {
  switch (D) {
    case 64:
      return f(Dim<64>{});
    case 128:
      return f(Dim<128>{});
    case 256:
      return f(Dim<256>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory above 48 KB must be allowed once per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace flash
}  // namespace sgdrc
