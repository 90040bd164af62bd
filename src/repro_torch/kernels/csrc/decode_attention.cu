// Split-K flash-decode for Hopper: one new token's GQA attention against a
// dense KV cache or a page pool, in one launch.
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention (dense
// cache, bshd or bhsd through strides) and ::decode_attention_paged (page
// pool through a per-row page table).
//
// What it computes. For batch row b and KV head h, the G = H / Hkv query
// heads of h attend to keys 0..n-1, n = min(pos[b], window - 1) + 1 (no key
// when pos[b] < 0). Key t lives in a dense cache at b*s0 + h*sh + t*ss, or
// in a pool at page page_table[b, t / page_size] clamped to [0, n_pages-1],
// offset t % page_size; keys >= n are never addressed, so pages past
// pos[b] / page_size and page-table column P are never read. Softmax state
// is f32 with the reference's finite NEG_INF = -1e30, and the result is
// acc / max(l, 1e-30): a row that sees no key comes out 0, never NaN.
//
// What bounds it on the card: the bytes of K and V (a decode does ~2 flops
// per cached byte, far below the H100's ~295 flops/byte ridge), so the
// design keeps bytes in flight on every SM:
//  - Split over keys. A (row, KV head)'s keys are cut into splits of
//    `split` keys (kernels/decode_attention.py::split_plan: whole pages, at
//    most 128 keys, a function of the window and page size only, never of
//    B or of the other rows). A cluster of C <= 8 blocks serves one (row,
//    KV head); block c takes splits c, c + C, c + 2C, ..., so a row shorter
//    than the window still spreads over up to 8 blocks. A block whose
//    splits all start at or past the row's last key loads nothing.
//  - Stream K/V with 16-byte cp.async loads (neighbouring threads on
//    neighbouring 16 bytes of a key row, which is contiguous in every
//    layout) into a ring of 3 stages of 16 KB (a K and a V tile of TK keys)
//    in shared memory, 4 blocks an SM: while the block computes on one
//    stage the next is in flight, and the page-table reads of the tile
//    after it overlap the compute. No TMA: a tensor map costs host time to
//    encode on every call.
//  - Compute on CUDA cores in f32. A key is read by a lane group of
//    D * sizeof(T) / 16 lanes, each lane owning one 16-byte slice of D and
//    holding q's slice of all the block's query heads in registers; the
//    score is reduced across the group by shuffles. Each lane group keeps
//    its own online softmax over its keys (4 of every stage); lane groups,
//    then warps, then the cluster's blocks merge their (m, l, acc).
//  - Merge in the same launch: after a cluster barrier, block 0 reads the
//    other blocks' partials through distributed shared memory and merges
//    them in block (split) order. Every merge has a fixed order and there
//    are no atomics, so the same inputs give the same bits, and a row's
//    bits do not depend on which rows share its batch.
//
// Grid: (C, Hkv * ceil(G / GM), B), cluster (C, 1, 1), 128 threads; a block
// serves GM = 1, 2, 4 or 8 query heads of one KV head.
#include <cooperative_groups.h>
#include <stdint.h>

#include "dtypes.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace sgdrc {
namespace decode {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
constexpr int kStageBytes = 16384;  // one stage: a K tile and a V tile
constexpr int kKeysPerGroup = 4;    // keys a lane group takes from a stage
constexpr int kMaxCluster = 8;      // the portable cluster size

struct Args {
  const void* q;
  void* out;
  const void* k;
  const void* v;
  const int* pos;         // [B]
  const int* page_table;  // [B, pt_stride], or null for a dense cache
  int H, Hkv;
  int n_gc;       // blocks of GM query heads per KV head
  int window;     // keys a row can address: Smax, or P * page_size
  int page_size;  // 0 for a dense cache
  int page_shift; // log2(page_size) when that is a power of two, else -1
  int pt_stride, n_pages;
  int split;      // keys a split holds
  int64_t q_sb, q_sh, o_sb, o_sh;  // q, out [B, H, D], element strides
  int64_t k_s0, k_sh, k_ss;        // dense: (b, h, t); paged: (page, h, off)
  int64_t v_s0, v_sh, v_ss;
  float scale;
};

// The tile geometry for element type T and head dim D: a lane loads 16
// bytes (kVec elements), kLanes lanes cover one key row, and a 16 KB stage
// holds TK keys of K and of V, 4 for each lane group.
template <typename T, int D>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kLanes = D / kVec;
  static constexpr int kGroupsPerWarp = 32 / kLanes;
  static constexpr int kGroups = kWarps * kGroupsPerWarp;
  static constexpr int kKeys = kGroups * kKeysPerGroup;
  static constexpr int kChunks = kKeys * kLanes;  // 16-byte chunks a tile
  static_assert(kLanes >= 1 && kLanes <= 32 && 32 % kLanes == 0,
                "a key row must be 16 to 512 bytes");
  static_assert(2 * kChunks * 16 == kStageBytes, "a stage is 16 KB");
  static_assert(kChunks % kThreads == 0, "chunks must fill the block");
};

// 16 bytes of T widened to f32.
template <typename T>
struct Widen;
template <>
struct Widen<float> {
  static __device__ __forceinline__ void run(const uint4& u, float* x) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  }
};
template <>
struct Widen<__nv_bfloat16> {
  static __device__ __forceinline__ void run(const uint4& u, float* x) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Widen<__half> {
  static __device__ __forceinline__ void run(const uint4& u, float* x) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

// 16-byte cp.async, shared with the tensor-core kernels (hopper.cuh)
using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

// Scores are kept in base 2 (q is scaled by log2 e), where the softmax's
// exponential is one SFU instruction (exp2f). Every merge of softmax
// partials (m_i, l_i, acc_i) below, of lane groups, warps and blocks, is
// M = max m_i, l = sum l_i 2^(m_i - M), acc likewise, taken in a fixed
// order.
template <typename T, int D, int GM>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Args a) {
  using Geo = Tile<T, D>;
  constexpr int V = Geo::kVec, L = Geo::kLanes, TK = Geo::kKeys;
  constexpr int NG = Geo::kGroups;
  extern __shared__ __align__(16) uint8_t smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int C = gridDim.x;
  const int h = blockIdx.y / a.n_gc, g0 = (blockIdx.y % a.n_gc) * GM;
  const int b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane % L;  // this lane's 16-byte slice of a key row
  const int group = warp * Geo::kGroupsPerWarp + lane / L;

  const int pos = a.pos[b];
  const int n_keys = pos < 0 ? 0 : min(pos, a.window - 1) + 1;
  const int n_active = (n_keys + a.split - 1) / a.split;  // splits with keys
  const int tps = (a.split + TK - 1) / TK;                // tiles a split
  int n_tiles = 0;
  if (c < n_active) {
    const int mine = (n_active - 1 - c) / C + 1;
    const int last = c + (mine - 1) * C;
    n_tiles = (mine - 1) * tps +
              (min(a.split, n_keys - last * a.split) + TK - 1) / TK;
  }

  // partials, in the ring's memory once the ring is drained: per warp
  // (acc [GM][D], m [GM], l [GM]), then the block's
  float* wpart = reinterpret_cast<float*>(smem);
  constexpr int kPart = GM * D + 2 * GM;
  float* bpart = wpart + kWarps * kPart;

  if (n_tiles > 0) {
    const T* kp = static_cast<const T*>(a.k);
    const T* vp = static_cast<const T*>(a.v);
    // first key and end of tile j's keys (within its split, below n_keys)
    auto tile_keys = [&](int j, int& t0, int& t_end) {
      const int s = c + (j / tps) * C;
      t0 = s * a.split + (j % tps) * TK;
      t_end = min((s + 1) * a.split, n_keys);
    };
    // Tile j's loads: this thread's kR 16-byte chunks of the K tile and of
    // the V tile, chunk i = tid + r * 128, which is slice tid % L of key
    // tid / L + r * 128 / L (128 is a multiple of L). On a pool, lookup()
    // reads the chunks' pages from the page table a tile before fetch()
    // needs them, so that read overlaps the compute.
    constexpr int kR = Geo::kChunks / kThreads;
    const int key0 = tid / L;
    const bool paged = a.page_table != nullptr;
    const int64_t kb = (paged ? 0 : b * a.k_s0) + h * a.k_sh + sub * V;
    const int64_t vb = (paged ? 0 : b * a.v_s0) + h * a.v_sh + sub * V;
    const int* pt_row = paged ? a.page_table + (int64_t)b * a.pt_stride
                              : nullptr;
    auto page_of = [&](int t) {
      return a.page_shift >= 0 ? t >> a.page_shift : t / a.page_size;
    };
    auto lookup = [&](int j, int (&pg)[kR]) {
      if (!paged) return;
      int t0, t_end;
      tile_keys(j, t0, t_end);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int t = t0 + key0 + r * (kThreads / L);
        pg[r] = t < t_end ? pt_row[page_of(t)] : 0;
      }
    };
    auto fetch = [&](int j, const int (&pg)[kR]) {
      int t0, t_end;
      tile_keys(j, t0, t_end);
      uint8_t* ks = smem + (j % kStages) * kStageBytes;
      uint8_t* vs = ks + kStageBytes / 2;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = tid + r * kThreads;
        const int t = t0 + key0 + r * (kThreads / L);
        const bool ok = t < t_end;
        int64_t ko = kb, vo = vb;
        if (ok) {
          if (paged) {
            const int64_t p = min(max(pg[r], 0), a.n_pages - 1);
            const int off = t - page_of(t) * a.page_size;
            ko += p * a.k_s0 + off * a.k_ss;
            vo += p * a.v_s0 + off * a.v_ss;
          } else {
            ko += t * a.k_ss;
            vo += t * a.v_ss;
          }
        }
        cp_async16(ks + i * 16, kp + (ok ? ko : 0), ok);
        cp_async16(vs + i * 16, vp + (ok ? vo : 0), ok);
      }
    };

    int pg[kR];
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
      if (j < n_tiles) {
        lookup(j, pg);
        fetch(j, pg);
      }
      cp_async_commit();
    }
    if (kStages - 1 < n_tiles) lookup(kStages - 1, pg);

    // q (read while the first tiles are in flight): this lane's slice of D
    // for the block's GM heads, scaled; heads past G are zero and never
    // written
    float q[GM][V];
    const T* qp = static_cast<const T*>(a.q);
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const bool has = g0 + g < G;
      const int64_t base =
          b * a.q_sb + (int64_t)(h * G + g0 + g) * a.q_sh + sub * V;
#pragma unroll
      for (int e = 0; e < V; ++e)
        q[g][e] = has ? to_f32(qp[base + e]) * (a.scale * kLog2e) : 0.f;
    }
    float m[GM], l[GM], acc[GM][V];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][e] = 0.f;
    }
    for (int j = 0; j < n_tiles; ++j) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // tile j landed; every thread is done with j - 1

      const uint8_t* ks = smem + (j % kStages) * kStageBytes;
      const uint8_t* vs = ks + kStageBytes / 2;
      int t0, t_end;
      tile_keys(j, t0, t_end);
      float s[kKeysPerGroup][GM];
#pragma unroll
      for (int kk = 0; kk < kKeysPerGroup; ++kk) {
        const int key = kk * NG + group;
        float x[V];
        Widen<T>::run(*reinterpret_cast<const uint4*>(ks + (key * L + sub) * 16),
                      x);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < V; ++e) d = fmaf(q[g][e], x[e], d);
          s[kk][g] = d;
        }
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int kk = 0; kk < kKeysPerGroup; ++kk)
#pragma unroll
          for (int g = 0; g < GM; ++g)
            s[kk][g] += __shfl_xor_sync(0xffffffffu, s[kk][g], o);
      }
      bool ok[kKeysPerGroup];
#pragma unroll
      for (int kk = 0; kk < kKeysPerGroup; ++kk)
        ok[kk] = t0 + kk * NG + group < t_end;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float mx = m[g];
#pragma unroll
        for (int kk = 0; kk < kKeysPerGroup; ++kk)
          if (ok[kk]) mx = fmaxf(mx, s[kk][g]);
        const float alpha = exp2f(m[g] - mx);
        m[g] = mx;
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int kk = 0; kk < kKeysPerGroup; ++kk) {
        const int key = kk * NG + group;
        float x[V];
        Widen<T>::run(*reinterpret_cast<const uint4*>(vs + (key * L + sub) * 16),
                      x);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float p = ok[kk] ? exp2f(s[kk][g] - m[g]) : 0.f;
          l[g] += p;
#pragma unroll
          for (int e = 0; e < V; ++e) acc[g][e] = fmaf(p, x[e], acc[g][e]);
        }
      }
      // tile j + kStages - 1 into the slot tile j - 1 left, then the pages
      // of the tile after it
      const int nx = j + kStages - 1;
      if (nx < n_tiles) fetch(nx, pg);
      cp_async_commit();
      if (nx + 1 < n_tiles) lookup(nx + 1, pg);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is drained: its memory holds the partials

    // lane groups of a warp, by xor steps over the group index
#pragma unroll
    for (int o = L; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float mx = fmaxf(m[g], mo);
        const float wa = exp2f(m[g] - mx), wb = exp2f(mo - mx);
        l[g] = l[g] * wa + lo * wb;
        m[g] = mx;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
          acc[g][e] = acc[g][e] * wa + ao * wb;
        }
      }
    }
    float* wp = wpart + warp * kPart;
    if (lane < L) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
#pragma unroll
        for (int e = 0; e < V; ++e) wp[g * D + sub * V + e] = acc[g][e];
        if (lane == 0) {
          wp[GM * D + g] = m[g];
          wp[GM * D + GM + g] = l[g];
        }
      }
    }
    __syncthreads();
    // the block's partial: its warps in order
    for (int i = tid; i < GM * D; i += kThreads) {
      const int g = i / D;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        mx = fmaxf(mx, wpart[w * kPart + GM * D + g]);
      float x = 0.f, ls = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* p = wpart + w * kPart;
        const float wt = exp2f(p[GM * D + g] - mx);
        x += p[i] * wt;
        ls += p[GM * D + GM + g] * wt;
      }
      bpart[i] = x;
      if (i % D == 0) {
        bpart[GM * D + g] = mx;
        bpart[GM * D + GM + g] = ls;
      }
    }
  }

  // block 0 merges the cluster's partials in block order; blocks without
  // keys (rank >= n_active) hold none and are skipped. Each block's
  // weight 2^(m_r - M) per head is taken once, then every output element
  // reads its acc from all blocks at once.
  cluster.sync();
  if (c == 0) {
    const int n_read = min(C, n_active);
    float* wts = bpart + kPart;               // [kMaxCluster][GM]
    float* lsum = wts + kMaxCluster * GM;     // [GM]
    if (tid < GM) {
      float mr[kMaxCluster], mx = kNegInf;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        mr[r] = r < n_read ? cluster.map_shared_rank(bpart, r)[GM * D + tid]
                           : kNegInf;
        mx = fmaxf(mx, mr[r]);
      }
      float ls = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        const float wt = r < n_read ? exp2f(mr[r] - mx) : 0.f;
        wts[r * GM + tid] = wt;
        if (r < n_read)
          ls += cluster.map_shared_rank(bpart, r)[GM * D + GM + tid] * wt;
      }
      lsum[tid] = ls;
    }
    __syncthreads();
    T* out = static_cast<T*>(a.out);
    for (int i = tid; i < GM * D; i += kThreads) {
      const int g = i / D, d = i % D;
      if (g0 + g >= G) continue;
      float x = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < n_read)
          x += cluster.map_shared_rank(bpart, r)[i] * wts[r * GM + g];
      out[b * a.o_sb + (int64_t)(h * G + g0 + g) * a.o_sh + d] =
          from_f32<T>(x / fmaxf(lsum[g], 1e-30f));
    }
  }
  cluster.sync();  // no block leaves while block 0 reads its shared memory
}

template <typename T, int D, int GM>
cudaError_t launch_typed(const Args& a, int B, int C, cudaStream_t stream) {
  auto kernel = decode_kernel<T, D, GM>;
  constexpr int kSmem = kStages * kStageBytes;
  static_assert(((kWarps + 1) * (GM * D + 2 * GM) + (kMaxCluster + 1) * GM) *
                        4 <= kSmem,
                "partials must fit in the ring");
  static int ready_device = -1;  // the device the attribute was set on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != ready_device) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    ready_device = dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, a.Hkv * a.n_gc, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_heads(const Args& a, int GM, int B, int C, cudaStream_t s) {
  switch (GM) {
    case 1:
      return launch_typed<T, D, 1>(a, B, C, s);
    case 2:
      return launch_typed<T, D, 2>(a, B, C, s);
    case 4:
      return launch_typed<T, D, 4>(a, B, C, s);
    case 8:
      return launch_typed<T, D, 8>(a, B, C, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_dim(const Args& a, int D, int GM, int B, int C,
                   cudaStream_t s) {
  switch (D) {
    case 32:
      return by_heads<T, 32>(a, GM, B, C, s);
    case 64:
      return by_heads<T, 64>(a, GM, B, C, s);
    case 128:
      return by_heads<T, 128>(a, GM, B, C, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace decode
}  // namespace sgdrc

// heads_per_block (GM) and split / cluster come from
// kernels/decode_attention.py (split_plan, heads_per_block).
extern "C" int sgdrc_decode_attention(
    const void* q, void* out, const void* k, const void* v, const void* pos,
    const void* page_table, int dtype, int B, int H, int Hkv, int D,
    int heads_per_block, int window, int page_size, int pt_stride,
    int n_pages, int split, int cluster, int64_t q_sb, int64_t q_sh,
    int64_t o_sb, int64_t o_sh, int64_t k_s0, int64_t k_sh, int64_t k_ss,
    int64_t v_s0, int64_t v_sh, int64_t v_ss, float scale, void* stream) {
  using namespace sgdrc::decode;
  if (B == 0) return 0;
  if (Hkv <= 0 || H % Hkv || split <= 0 || cluster < 1 ||
      cluster > kMaxCluster || (page_table != nullptr && page_size <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hkv;
  Args a;
  a.q = q;
  a.out = out;
  a.k = k;
  a.v = v;
  a.pos = static_cast<const int*>(pos);
  a.page_table = static_cast<const int*>(page_table);
  a.H = H;
  a.Hkv = Hkv;
  a.n_gc = (G + heads_per_block - 1) / heads_per_block;
  a.window = window;
  a.page_size = page_size;
  a.page_shift = -1;
  if (page_size > 0 && (page_size & (page_size - 1)) == 0)
    a.page_shift = __builtin_ctz(page_size);
  a.pt_stride = pt_stride;
  a.n_pages = n_pages;
  a.split = split;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.o_sb = o_sb;
  a.o_sh = o_sh;
  a.k_s0 = k_s0;
  a.k_sh = k_sh;
  a.k_ss = k_ss;
  a.v_s0 = v_s0;
  a.v_sh = v_sh;
  a.v_ss = v_ss;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(sgdrc::with_dtype(dtype, [&](auto tag) {
    return by_dim<typename decltype(tag)::type>(a, D, heads_per_block, B,
                                                cluster, s);
  }));
}
