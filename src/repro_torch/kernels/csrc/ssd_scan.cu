// Linear-recurrence scan (SSD / Mamba2) on Hopper:
//   S_t = diag(exp w_t) S_{t-1} + k_t v_t^T,   y_t = q_t . S_t   (inclusive)
// q, k, log_w [B,T,H,K]; v [B,T,H,P] -> y [B,T,H,P] in q's dtype; the
// [K,P] state is f32.
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan (the Pallas kernel), with
// the exact decay: key i reaches query j (i <= j) through exp(s_j - s_i),
// s the inclusive cumsum of log_w, and every exponential this kernel
// evaluates has an exponent <= 0, so nothing overflows and no clamp is
// needed; a pair past the diagonal evaluates none. (The Pallas kernel
// splits the decay into exp(s_j) * exp(-s_i) with s clamped to +-20 inside
// its chunks, which loses real terms once a chunk's cumulative decay passes
// -20; below that the two agree up to rounding.) Because the result is the
// exact recurrence, the caller's `chunk` is not a tiling here: the kernel
// walks T in sub-chunks of kLS = 16 tokens whatever the chunk, so every
// chunk gives the same bits, and a ragged last sub-chunk is zero-filled.
//
// What bounds it on the card. The least work is bytes (each input read
// once, y written once: 0.12 ms at zamba2-1.2b's mamba2 widths, B 4, T 2048,
// H 64, K = P = 64, bf16). The work it does is f32 FMAs on CUDA cores (TF32
// would keep ~3 digits): per (token, head) K*P for q~ . S and K*P for the
// state update, whatever the sub-chunk, plus the sub-chunk's own pairs
// (kLS + 1) / 2 * K a token. What holds this body is shared memory: every
// operand of those FMAs is read from it, and an SM reads 128 bytes a cycle
// however many lanes share an address, so the design counts bytes read a
// FMA (1.5 for the products' 8 x 4 register tiles) and bytes a score term.
//
// Design: one block of 256 threads per (batch row, head, 64-column tile of
// P) walks the sub-chunks in order, two blocks an SM. The state lives on
// chip for the whole walk: warps 0-3 hold it in registers, 8 channels x 4
// columns a thread, and write a shared-memory copy after each update for
// the next sub-chunk's q~ . S. A ring of kStages sub-chunks is fed by
// cp.async (16-byte copies where every row's address allows, else 8, 4, or
// plain 2-byte loads). Per sub-chunk n, two barriers apart:
//  X. warps 4-7: y's inter-chunk part q~ . S_{n-1} (q~_j = q_j exp(s_j)) as
//     8 rows x 4 columns a thread, K split over 4 lanes; warps 0-3: the
//     state S = exp(s_L) S + sum_i k~_i v_i^T (k~_i = k_i exp(s_L - s_i));
//     warps 0-4: the scores sum_c q_jc k_ic exp(s_jc - s_ic) as 4 x 4
//     tiles of 4-token blocks, 16 lanes a tile (channels ks, ks + 16, ...)
//     summed by a shuffle reduce-scatter: the 4 diagonal blocks pair by
//     pair, the 6 others through exp(s_j - s_m) exp(s_m - s_i), m the key
//     block's last token, both exponents <= 0 (8 exponentials a channel
//     for 16 pairs);
//  Y. warps 4-7: y's intra-chunk part sum_{i<=j} score_ji v_i into the same
//     tiles, a reduce-scatter over the 4 lanes, y stored; warps 0-3: the
//     state's copy, then step 1 of sub-chunk n + 1: per channel the cumsum
//     of log_w over the 16 tokens as a warp-shuffle scan (in log2 units, for
//     ex2), q~, k~, exp(s_L), and channel-major copies of q, k, s for the
//     scores (v double-buffered, as Y reads sub-chunk n's).
// Inputs are read through their strides ([B,T,H,*] views, last axis
// contiguous, broadcast axes allowed); nothing is transposed or copied in
// device memory. Tensor cores are not used: the products are f32.
#include <stdint.h>

#include <cuda_runtime.h>

#include "dtypes.cuh"
#include "hopper.cuh"

namespace sgdrc {
namespace ssd {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::smem_u32;

constexpr int kThreads = 256;
constexpr int kLS = 16;      // tokens a sub-chunk
constexpr int kTileP = 64;   // columns of P a block
constexpr int kMaxK = 128;
constexpr int kStages = 3;   // sub-chunks in the load ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  int64_t b, t, h;  // elements; the last axis is contiguous
};

// Copy widths in bytes (16, 8, 4, or the element size for plain loads) of
// q, k, v, log_w, chosen on the host from their addresses and strides.
struct Widths {
  int q, k, v, w;
};

// Shared-memory layout, in floats after the ring. Row strides (floats), so
// that the float4 reads and writes of a warp meet no bank conflict beyond
// their bytes: RS = K + 4 for token-major [kLS][K] arrays (consecutive rows
// 4 banks apart), PS = 72 for [*][64] arrays (8 apart), LSP = 24 and LSC =
// 20 for the [*][16] ones.
template <int KT>
struct Layout {
  static constexpr int RS = KT + 4, PS = kTileP + 8, LSP = kLS + 8;
  static constexpr int LSC = kLS + 4;
  static constexpr int QT = 0;                    // [KT][LSP]  q~, channel-major
  static constexpr int KTL = QT + KT * LSP;       // [kLS][RS]  k~
  static constexpr int QC = KTL + kLS * RS;       // [KT][LSC]  q, channel-major
  static constexpr int KC = QC + KT * LSC;        // [KT][LSC]  k
  static constexpr int SCL = KC + KT * LSC;       // [KT][LSC]  s (log2 units)
  static constexpr int VF = SCL + KT * LSC;       // [2][kLS][PS] v, by parity
  static constexpr int SC = VF + 2 * kLS * PS;    // [kLS][LSP] scores, key-major
  static constexpr int DK = SC + kLS * LSP;       // [KT]       exp(s_L)
  static constexpr int MS = DK + KT;              // [KT][PS]   the state
  static constexpr int FLOATS = MS + KT * PS;
};

// One stage of the ring: q, k, v, log_w rows as loaded, each row padded by
// 16 bytes so lanes reading consecutive rows meet different banks.
template <typename E, typename EW, int KT>
struct Ring {
  static constexpr int RE = KT + 16 / (int)sizeof(E);
  static constexpr int RV = kTileP + 16 / (int)sizeof(E);
  static constexpr int RW = KT + 16 / (int)sizeof(EW);
  static constexpr int Q = 0, K = Q + kLS * RE * (int)sizeof(E),
                       V = K + kLS * RE * (int)sizeof(E),
                       W = V + kLS * RV * (int)sizeof(E),
                       BYTES = W + kLS * RW * (int)sizeof(EW);
};

template <typename E, typename EW, int KT>
constexpr size_t smem_bytes() {
  return (size_t)kStages * Ring<E, EW, KT>::BYTES +
         (size_t)Layout<KT>::FLOATS * sizeof(float);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// W bytes global -> shared through L1; zero-filled when !valid.
template <int W>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(W), "r"(valid ? W : 0)
               : "memory");
}

// Rows t0 .. t0 + kLS - 1 (row_elems elements each, `st` elements apart in
// device memory) into `dst` (rows dst_stride elements apart); rows at or
// past T are zero-filled. Thread tid copies pieces tid % 16, tid % 16 + 16,
// ... of row tid / 16, `width` bytes each (uniform across the block).
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int dst_stride,
                                          const T* src, int64_t st, int t0,
                                          int T_len, int row_elems,
                                          int width, int tid) {
  const int r = tid >> 4, per = width / (int)sizeof(T);
  const bool ok = t0 + r < T_len;
  const T* s = src + (ok ? (int64_t)(t0 + r) * st : 0);
  T* d = dst + r * dst_stride;
  const int c0 = (tid & 15) * per, dc = 16 * per;
  if (width == 16) {
    for (int c = c0; c < row_elems; c += dc) cp_async16(d + c, s + c, ok);
  } else if (width == 8) {
    for (int c = c0; c < row_elems; c += dc) cp_async_ca<8>(d + c, s + c, ok);
  } else if (width == 4) {
    for (int c = c0; c < row_elems; c += dc) cp_async_ca<4>(d + c, s + c, ok);
  } else {
    for (int c = c0; c < row_elems; c += dc)
      d[c] = ok ? s[c] : from_f32<T>(0.f);
  }
}

template <typename E, typename EW, int KT>
__global__ void __launch_bounds__(kThreads, KT == 64 ? 2 : 1)
    ssd_scan_kernel(const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v, const EW* __restrict__ w,
                    E* __restrict__ y, Strides sq, Strides sk, Strides sv,
                    Strides sw, Strides sy, Widths wd, int T, int K, int P) {
  using Lay = Layout<KT>;
  using Rg = Ring<E, EW, KT>;
  constexpr int RS = Lay::RS, PS = Lay::PS, LSP = Lay::LSP, LSC = Lay::LSC;
  constexpr int CPT = KT / 8;  // state channels a thread of warps 0-3 holds
  extern __shared__ float4 smem4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4);
  float* fs = reinterpret_cast<float*>(ring + kStages * Rg::BYTES);
  float* qT = fs + Lay::QT;
  float* kt = fs + Lay::KTL;
  float* qc = fs + Lay::QC;
  float* kc = fs + Lay::KC;
  float* scl = fs + Lay::SCL;
  float* vf = fs + Lay::VF;
  float* sc = fs + Lay::SC;
  float* dk = fs + Lay::DK;
  float* ms = fs + Lay::MS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * kTileP;
  const int h = blockIdx.y, b = blockIdx.z;
  const int PT = min(kTileP, P - p0);
  const E* qb = q + b * sq.b + h * sq.h;
  const E* kb = k + b * sk.b + h * sk.h;
  const E* vb = v + b * sv.b + h * sv.h + p0;
  const EW* wb = w + b * sw.b + h * sw.h;
  E* yb = y + b * sy.b + h * sy.h + p0;

  // Zero the ring (its padding columns stay zero: copies write [0, K) and
  // [0, PT) only), the scores (the entries above the diagonal stay zero) and
  // the state's copy.
  {
    float4* r4 = reinterpret_cast<float4*>(ring);
    for (int i = tid; i < kStages * Rg::BYTES / 16; i += kThreads)
      r4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < Lay::FLOATS; i += kThreads) fs[i] = 0.f;
  }
  __syncthreads();

  const int nsub = (T + kLS - 1) / kLS;
  auto load_stage = [&](int n) {
    uint8_t* st = ring + (n % kStages) * Rg::BYTES;
    const int t0 = n * kLS;
    load_rows(reinterpret_cast<E*>(st + Rg::Q), Rg::RE, qb, sq.t, t0, T, K,
              wd.q, tid);
    load_rows(reinterpret_cast<E*>(st + Rg::K), Rg::RE, kb, sk.t, t0, T, K,
              wd.k, tid);
    load_rows(reinterpret_cast<E*>(st + Rg::V), Rg::RV, vb, sv.t, t0, T, PT,
              wd.v, tid);
    load_rows(reinterpret_cast<EW*>(st + Rg::W), Rg::RW, wb, sw.t, t0, T, K,
              wd.w, tid);
  };

  // step 1 of sub-chunk n (stage n % kStages), on warps 0-3: token t1 of a
  // 16-lane half-warp, channel quads hw, hw + 8, ...
  const int t1 = tid & 15, hw = (tid >> 4) & 7;
  auto prep = [&](int n) {
    const uint8_t* st = ring + (n % kStages) * Rg::BYTES;
    const E* qr = reinterpret_cast<const E*>(st + Rg::Q);
    const E* kr = reinterpret_cast<const E*>(st + Rg::K);
    const E* vr = reinterpret_cast<const E*>(st + Rg::V);
    const EW* wr = reinterpret_cast<const EW*>(st + Rg::W);
#pragma unroll
    for (int gi = 0; gi < KT / 32; ++gi) {
      const int c0 = 4 * (hw + 8 * gi);
      float s[4], qv[4], kv[4], sL[4];
      load_f32<EW, 4>(wr + t1 * Rg::RW + c0, s);
      load_f32<E, 4>(qr + t1 * Rg::RE + c0, qv);
      load_f32<E, 4>(kr + t1 * Rg::RE + c0, kv);
#pragma unroll
      for (int x = 0; x < 4; ++x) s[x] *= kLog2e;
#pragma unroll
      for (int o = 1; o < kLS; o <<= 1)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float u = __shfl_up_sync(kFull, s[x], o, kLS);
          if (t1 >= o) s[x] += u;
        }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        sL[x] = __shfl_sync(kFull, s[x], kLS - 1, kLS);
        qT[(c0 + x) * LSP + t1] = qv[x] * ex2(s[x]);
        qc[(c0 + x) * LSC + t1] = qv[x];
        kc[(c0 + x) * LSC + t1] = kv[x];
        scl[(c0 + x) * LSC + t1] = s[x];
      }
      *reinterpret_cast<float4*>(kt + t1 * RS + c0) = make_float4(
          kv[0] * ex2(sL[0] - s[0]), kv[1] * ex2(sL[1] - s[1]),
          kv[2] * ex2(sL[2] - s[2]), kv[3] * ex2(sL[3] - s[3]));
      if (t1 == 0)
        *reinterpret_cast<float4*>(dk + c0) =
            make_float4(ex2(sL[0]), ex2(sL[1]), ex2(sL[2]), ex2(sL[3]));
    }
#pragma unroll
    for (int gi = 0; gi < kTileP / 32; ++gi) {
      const int p4 = 4 * (hw + 8 * gi);
      float vv[4];
      load_f32<E, 4>(vr + t1 * Rg::RV + p4, vv);
      *reinterpret_cast<float4*>(vf + (n & 1) * kLS * PS + t1 * PS + p4) =
          make_float4(vv[0], vv[1], vv[2], vv[3]);
    }
  };

  // scores, as 4 x 4 tiles of (query j, key i) over blocks of 4 tokens:
  // warps 0-4, 16 lanes a tile, each lane the channels ks, ks + 16, ...;
  // tiles 0-3 the diagonal blocks (J = I, exact, i <= j), tiles 4-9 the
  // blocks J > I, where exp(s_j - s_i) = exp(s_j - s_m) exp(s_m - s_i) with
  // m = 4I + 3, the key block's last token: both exponents <= 0, so the
  // tile costs 8 exponentials a channel, not 16
  const int tile = 2 * warp + (lane >> 4), ks = lane & 15;
  int tJ = tile, tI = tile;
  if (tile >= 4) {
    const int o = tile - 4;  // (1,0) (2,0) (2,1) (3,0) (3,1) (3,2)
    tJ = o < 1 ? 1 : o < 3 ? 2 : 3;
    tI = o - (tJ * (tJ - 1)) / 2;
  }
  // Warps 4-7 make y: rows j0 .. j0 + 7, columns pa .. pa + 3, over the
  // channels (and keys) cq, cq + 4, ...: 8 x 4 register tiles, 1.5 bytes
  // of shared memory read an FMA. Warps 0-3 hold the state: channels cs ..
  // cs + CPT - 1, columns pb .. pb + 3.
  const bool ywarp = warp >= 4;
  const int cq = lane & 3;
  const int j0 = 8 * (warp & 1);
  const int pa = 4 * (8 * ((warp >> 1) & 1) + (lane >> 2));
  const int pb = 4 * (8 * (warp & 1) + (lane & 7));
  const int cs = CPT * (4 * ((warp >> 1) & 1) + (lane >> 3));
  // y rows start on 4-element boundaries and the tile has whole quads
  const bool vec_y =
      pa + 4 <= PT &&
      ((reinterpret_cast<uintptr_t>(yb + pa) | (uint64_t)(sy.t * sizeof(E))) &
       (4 * sizeof(E) - 1)) == 0;
  float S[CPT][4];
#pragma unroll
  for (int x = 0; x < CPT; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[x][e] = 0.f;

#pragma unroll
  for (int n = 0; n < kStages; ++n) {
    if (n < nsub) load_stage(n);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();
  if (!ywarp) prep(0);
  __syncthreads();

  for (int n = 0; n < nsub; ++n) {
    // -- X: the scores, y's inter-chunk part q~ . S, the state update ------
    float sa[4][4];  // this lane's channels' share of tile (tJ, tI)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[a][e] = 0.f;
    if (warp < 2) {
#pragma unroll
      for (int x = 0; x < KT / 16; ++x) {
        const int c = ks + 16 * x;
        const float4 q4 = *reinterpret_cast<const float4*>(qc + c * LSC + 4 * tJ);
        const float4 k4 = *reinterpret_cast<const float4*>(kc + c * LSC + 4 * tJ);
        const float4 s4 = *reinterpret_cast<const float4*>(scl + c * LSC + 4 * tJ);
        const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          sa[a][a] = fmaf(qv[a], kv[a], sa[a][a]);
#pragma unroll
          for (int e = 0; e < a; ++e)
            sa[a][e] = fmaf(qv[a] * kv[e], ex2(sv[a] - sv[e]), sa[a][e]);
        }
      }
    } else if (warp < 5) {
#pragma unroll
      for (int x = 0; x < KT / 16; ++x) {
        const int c = ks + 16 * x;
        const float4 q4 = *reinterpret_cast<const float4*>(qc + c * LSC + 4 * tJ);
        const float4 j4 = *reinterpret_cast<const float4*>(scl + c * LSC + 4 * tJ);
        const float4 k4 = *reinterpret_cast<const float4*>(kc + c * LSC + 4 * tI);
        const float4 i4 = *reinterpret_cast<const float4*>(scl + c * LSC + 4 * tI);
        const float m = i4.w;
        const float qa[4] = {q4.x * ex2(j4.x - m), q4.y * ex2(j4.y - m),
                             q4.z * ex2(j4.z - m), q4.w * ex2(j4.w - m)};
        const float kb[4] = {k4.x * ex2(m - i4.x), k4.y * ex2(m - i4.y),
                             k4.z * ex2(m - i4.z), k4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) sa[a][e] = fmaf(qa[a], kb[e], sa[a][e]);
      }
    }
    float acc[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
    const float* vc = vf + (n & 1) * kLS * PS;
    if (ywarp) {
#pragma unroll
      for (int g = 0; g < KT / 4; ++g) {
        const int c = 4 * g + cq;
        const float4 q0 = *reinterpret_cast<const float4*>(qT + c * LSP + j0);
        const float4 q1 =
            *reinterpret_cast<const float4*>(qT + c * LSP + j0 + 4);
        const float4 sa4 = *reinterpret_cast<const float4*>(ms + c * PS + pa);
        const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
        const float sv4[4] = {sa4.x, sa4.y, sa4.z, sa4.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[a][e] = fmaf(qv[a], sv4[e], acc[a][e]);
      }
    } else {
#pragma unroll
      for (int x = 0; x < CPT; ++x) {
        const float d = dk[cs + x];
#pragma unroll
        for (int e = 0; e < 4; ++e) S[x][e] *= d;
      }
#pragma unroll
      for (int i = 0; i < kLS; ++i) {
        const float4 va = *reinterpret_cast<const float4*>(vc + i * PS + pb);
        const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
        for (int x4 = 0; x4 < CPT; x4 += 4) {
          const float4 ka =
              *reinterpret_cast<const float4*>(kt + i * RS + cs + x4);
          const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              S[x4 + x][e] = fmaf(kv[x], vv[e], S[x4 + x][e]);
        }
      }
    }
    if (warp < 5) {
      // reduce-scatter over the tile's 16 lanes: lane ks ends with element
      // (ks / 4, ks % 4) of the tile
      float r8[8], r4[4], r2[2];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const bool hi = ks & 8;
        const float lo = sa[u >> 2][u & 3], up = sa[(u + 8) >> 2][u & 3];
        r8[u] = (hi ? up : lo) + __shfl_xor_sync(kFull, hi ? lo : up, 8);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool hi = ks & 4;
        r4[u] = (hi ? r8[u + 4] : r8[u]) +
                __shfl_xor_sync(kFull, hi ? r8[u] : r8[u + 4], 4);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const bool hi = ks & 2;
        r2[u] = (hi ? r4[u + 2] : r4[u]) +
                __shfl_xor_sync(kFull, hi ? r4[u] : r4[u + 2], 2);
      }
      const bool hi = ks & 1;
      const float v1 = (hi ? r2[1] : r2[0]) +
                       __shfl_xor_sync(kFull, hi ? r2[0] : r2[1], 1);
      const int a = ks >> 2, e = ks & 3;
      if (tile >= 4 || e <= a) sc[(4 * tI + e) * LSP + 4 * tJ + a] = v1;
    }
    cp_async_wait<kStages - 2>();  // sub-chunk n + 1 has landed
    __syncthreads();

    // -- Y: y's intra-chunk part, reduce, store; the state's copy; step 1
    // of sub-chunk n + 1; loads of sub-chunk n + kStages -----------------
    if (ywarp) {
#pragma unroll
      for (int m = 0; m < kLS / 4; ++m) {
        if (4 * m > j0 + 7) break;  // scores past the diagonal are 0
        const int i = 4 * m + cq;
        const float4 c0 = *reinterpret_cast<const float4*>(sc + i * LSP + j0);
        const float4 c1 =
            *reinterpret_cast<const float4*>(sc + i * LSP + j0 + 4);
        const float4 va = *reinterpret_cast<const float4*>(vc + i * PS + pa);
        const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[a][e] = fmaf(cv[a], vv[e], acc[a][e]);
      }
      // reduce-scatter over the 4 lanes of a tile: lane cq ends with rows
      // j0 + r0, j0 + r0 + 1, r0 = 4 * (cq & 1) + 2 * (cq >> 1)
      const bool b0 = cq & 1, b1 = (cq >> 1) & 1;
      float h4[4][4], out[2][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float send = b0 ? acc[r][e] : acc[4 + r][e];
          const float keep = b0 ? acc[4 + r][e] : acc[r][e];
          h4[r][e] = keep + __shfl_xor_sync(kFull, send, 1);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float send = b1 ? h4[r][e] : h4[2 + r][e];
          const float keep = b1 ? h4[2 + r][e] : h4[r][e];
          out[r][e] = keep + __shfl_xor_sync(kFull, send, 2);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = n * kLS + j0 + 4 * (int)b0 + 2 * (int)b1 + r;
        if (t < T) {
          E* row = yb + (int64_t)t * sy.t + pa;
          if (vec_y) {
            store_from_f32<E, 4>(row, out[r]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (pa + e < PT) row[e] = from_f32<E>(out[r][e]);
          }
        }
      }
    } else {
#pragma unroll
      for (int x = 0; x < CPT; ++x)
        *reinterpret_cast<float4*>(ms + (cs + x) * PS + pb) =
            make_float4(S[x][0], S[x][1], S[x][2], S[x][3]);
    }
    if (!ywarp && n + 1 < nsub) prep(n + 1);
    if (n + kStages < nsub) load_stage(n + kStages);
    cp_async_commit();
    __syncthreads();
  }
  cp_async_wait<0>();
}

// The widest copy (16, 8, 4 bytes, else the element size) that every row
// start (base, strides) and every row's length (in bytes) allows.
inline int copy_width(const void* p, const Strides& s, int esz,
                      int64_t row_bytes, int64_t extra) {
  uint64_t x = reinterpret_cast<uintptr_t>(p) |
               (uint64_t)(s.b * esz) | (uint64_t)(s.t * esz) |
               (uint64_t)(s.h * esz) | (uint64_t)row_bytes | (uint64_t)extra;
  int wdt = 16;
  while (wdt > esz && (x & (uint64_t)(wdt - 1))) wdt >>= 1;
  return wdt;
}

// Lets the kernel take its shared memory, all of the SM's carve-out.
template <typename E, typename EW, int KT>
cudaError_t prepare() {
  auto kern = ssd_scan_kernel<E, EW, KT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<E, EW, KT>());
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename E, typename EW, int KT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* w, void* y, const Strides* s, int B, int T,
                   int H, int K, int P, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<E, EW, KT>;
  const size_t bytes = smem_bytes<E, EW, KT>();
  cudaError_t err = prepare<E, EW, KT>();
  if (err != cudaSuccess) return err;
  const int es = (int)sizeof(E), ew = (int)sizeof(EW);
  // v's columns start at multiples of kTileP; the last tile may be short
  const Widths wd{copy_width(q, s[0], es, (int64_t)K * es, 0),
                  copy_width(k, s[1], es, (int64_t)K * es, 0),
                  copy_width(v, s[2], es, (int64_t)P * es,
                             (int64_t)kTileP * es),
                  copy_width(w, s[3], ew, (int64_t)K * ew, 0)};
  const dim3 grid((P + kTileP - 1) / kTileP, H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const EW*>(w),
      static_cast<E*>(y), s[0], s[1], s[2], s[3], s[4], wd, T, K, P);
  return cudaGetLastError();
}

}  // namespace ssd
}  // namespace sgdrc

// q, k, v, log_w, y: [B,T,H,*] views, last axis contiguous; strides holds
// (b, t, h) element strides of q, k, v, log_w and y, in that order.
// dtype: q/k/v/y; wdtype: log_w (codes of kernels/_build.py DTYPE_CODES).
// L, the caller's chunk, must divide T (the reference's contract); it does
// not change the result or the tiling.
extern "C" int sgdrc_ssd_scan(const void* q, const void* k, const void* v,
                              const void* log_w, void* y, int dtype,
                              int wdtype, int B, int T, int H, int K, int P,
                              int L, const int64_t* strides, void* stream) {
  using namespace sgdrc;
  if (B <= 0 || T <= 0 || H <= 0 || P <= 0) return 0;
  if (L <= 0 || T % L != 0 || K <= 0 || K > ssd::kMaxK || H > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  ssd::Strides s[5];
  for (int i = 0; i < 5; ++i)
    s[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    return with_dtype(wdtype, [&](auto wtag) {
      using EW = typename decltype(wtag)::type;
      return K <= 64 ? ssd::launch<E, EW, 64>(q, k, v, log_w, y, s, B, T, H,
                                              K, P, st)
                     : ssd::launch<E, EW, 128>(q, k, v, log_w, y, s, B, T,
                                               H, K, P, st);
    });
  }));
}

// Blocks of the kernel for (dtype, wdtype, K) resident on one SM, or -1.
extern "C" int sgdrc_ssd_scan_blocks_per_sm(int dtype, int wdtype, int K) {
  using namespace sgdrc;
  int n = -1;
  const cudaError_t err = with_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    return with_dtype(wdtype, [&](auto wtag) {
      using EW = typename decltype(wtag)::type;
      auto occupancy = [&](auto kern, size_t bytes, cudaError_t e) {
        return e != cudaSuccess
                   ? e
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &n, kern, ssd::kThreads, bytes);
      };
      return K <= 64 ? occupancy(ssd::ssd_scan_kernel<E, EW, 64>,
                                 ssd::smem_bytes<E, EW, 64>(),
                                 ssd::prepare<E, EW, 64>())
                     : occupancy(ssd::ssd_scan_kernel<E, EW, 128>,
                                 ssd::smem_bytes<E, EW, 128>(),
                                 ssd::prepare<E, EW, 128>());
    });
  });
  return err == cudaSuccess ? n : -1;
}
