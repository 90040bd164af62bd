// Hopper building blocks shared by the tensor-core kernels (flash_wgmma.cuh,
// prefill_wgmma.cuh, dual_tenant_matmul.cu; decode_attention.cu takes its
// cp.async from here), written as inline PTX for sm_90a: mbarriers, TMA
// tile loads, 16-byte cp.async into swizzled tiles, moving registers
// between warpgroups, wgmma shared-memory descriptors and the wgmma shapes
// the kernels use, for bf16 or f16 operands (the element type T, a template
// argument that defaults to bf16), and the host-side encoding of TMA tensor
// maps.
//
// Shared-memory operands are 128-byte swizzled tiles as TMA writes them
// with CU_TENSOR_MAP_SWIZZLE_128B: rows of 64 16-bit elements (128 bytes),
// 8 rows to a 1024-byte swizzle atom, every tile 1024-byte aligned. bf16
// and f16 share every byte offset, so only the instruction's type and the
// tensor map's element type differ between them.
//   K-major operand (the reduction axis contiguous: A of a GEMM, Q, K):
//     rows of the M/N axis 128 bytes apart, LBO unused, SBO = 1024 (the
//     next 8 rows); a k16 step inside a 64-wide chunk adds 32 bytes.
//   MN-major operand (the M/N axis contiguous: B [K, N] of a GEMM, V):
//     rows of the K axis 128 bytes apart, LBO = the byte distance to the
//     next 64-wide chunk of N, SBO = 1024 (the next 8 rows of K); a k16
//     step adds 16 rows = 2048 bytes; the instruction's trans-b bit is 1.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace sgdrc {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p: swizzled tiles start there.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A wait of more
// than about 2^34 cycles (seconds) can only be a fault of the pipeline: it
// traps, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// -- TMA tile loads (complete on `bar`; boxes past the tensor read zeros) ---

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// global -> shared by the copy engine, completing on `bar`'s transaction
// count. It takes no tensor map, so any row of any layout.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// -- cp.async: 16-byte copies, each tracked by the thread that starts it ----

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (no
// byte of src is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed.
// noinc: the arrival counts against the count the barrier was initialised
// with (one per thread that calls this for a phase).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// Orders this thread's earlier shared-memory writes (cp.async, st.shared:
// the generic proxy) before later accesses by the async proxy (wgmma reads,
// bulk-copy writes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk j of row r in a 128-byte-swizzled tile of
// `rows` rows (the layout TMA's CU_TENSOR_MAP_SWIZZLE_128B writes, see the
// top): 64-wide chunk j / 8 of the row axis starts at (j / 8) * rows * 128,
// and 16-byte chunk c of row r sits at c ^ (r % 8) within its 128-byte row.
__device__ __forceinline__ uint32_t sw128_offset(int rows, int r, int j) {
  return static_cast<uint32_t>((j >> 3) * rows * 128 + r * 128 +
                               (((j & 7) ^ (r & 7)) << 4));
}

// -- registers between warpgroups --------------------------------------------

// Lower (dec) or raise (inc) this warpgroup's registers a thread to N; every
// thread of the warpgroup executes it. A producer warpgroup gives registers
// back so that the consumers' tiles fit.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// -- wgmma -----------------------------------------------------------------

// Descriptor of a 128-byte-swizzled shared-memory operand (see the top).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two f32 values rounded once to T (round to nearest even), lo in the low
// half: a register A operand's word, or two adjacent outputs.
template <typename T>
__device__ __forceinline__ uint32_t pack2_rn(float lo, float hi) {
  static_assert(std::is_same_v<T, __nv_bfloat16> || std::is_same_v<T, __half>,
                "wgmma operands are bf16 or f16");
  if constexpr (std::is_same_v<T, __half>)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

// The wgmma shapes, T x T -> f32 for T bf16 or f16; TransB 1 reads B
// MN-major. Each is one asm statement written once (the macros below) and
// instantiated with the type's PTX name, so bf16 emits the instruction it
// always has.
#define SGDRC_ACC32 \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SGDRC_ACC64 \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define SGDRC_WGMMA_SS_N64(AB)                                              \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"     \
      : SGDRC_ACC32                                                         \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TransB))
#define SGDRC_WGMMA_RS_N64(AB)                                              \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
      : SGDRC_ACC32                                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),         \
        "n"(TransB))
#define SGDRC_WGMMA_SS_N128(AB)                                             \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"     \
      : SGDRC_ACC64                                                         \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TransB))
#define SGDRC_WGMMA_RS_N128(AB)                                             \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
      : SGDRC_ACC64                                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),         \
        "n"(TransB))

// d[0:32] (+)= A[64 x 16] . B[16 x 64], A and B in shared memory.
template <int TransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (std::is_same_v<T, __half>)
    SGDRC_WGMMA_SS_N64("f16");
  else
    SGDRC_WGMMA_SS_N64("bf16");
}

// d[0:32] += A[64 x 16] . B[16 x 64], A in registers (a[4] per thread,
// the layout of an m64 accumulator fragment), B in shared memory.
template <int TransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  if constexpr (std::is_same_v<T, __half>)
    SGDRC_WGMMA_RS_N64("f16");
  else
    SGDRC_WGMMA_RS_N64("bf16");
}

// d[0:64] (+)= A[64 x 16] . B[16 x 128], A and B in shared memory.
template <int TransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  if constexpr (std::is_same_v<T, __half>)
    SGDRC_WGMMA_SS_N128("f16");
  else
    SGDRC_WGMMA_SS_N128("bf16");
}

// d[0:64] += A[64 x 16] . B[16 x 128], A in registers (a[4] per thread,
// the layout of an m64 accumulator fragment), B in shared memory.
template <int TransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  if constexpr (std::is_same_v<T, __half>)
    SGDRC_WGMMA_RS_N128("f16");
  else
    SGDRC_WGMMA_RS_N128("bf16");
}

#undef SGDRC_WGMMA_SS_N64
#undef SGDRC_WGMMA_RS_N64
#undef SGDRC_WGMMA_SS_N128
#undef SGDRC_WGMMA_RS_N128
#undef SGDRC_ACC32
#undef SGDRC_ACC64

// -- host: TMA tensor maps -------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through cudaGetDriverEntryPoint
// (no -lcuda needed).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor-map element type of a wgmma operand type.
template <typename T>
constexpr CUtensorMapDataType map_type() {
  static_assert(std::is_same_v<T, __nv_bfloat16> || std::is_same_v<T, __half>,
                "tensor maps of bf16 or f16");
  return std::is_same_v<T, __half> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A tensor map of 16-bit elements of type `type` (map_type<T>(): BFLOAT16
// or FLOAT16) with 128-byte swizzle over `rank` dims (innermost first;
// strides in bytes of dims 1.., each a multiple of 16), box `box`.
// Zero-fills what a box reads past the tensor.
inline cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type,
                            const void* base, int rank, const uint64_t* dims,
                            const uint64_t* strides, const uint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(base) & 15) != 0)
    return cudaErrorMisalignedAddress;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUresult r = fn(map, type, rank,
                        const_cast<void*>(base), d, s, b, e,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// -- host: the persistent grid ---------------------------------------------

// As many blocks of `kernel` (threads a block, dynamic shared memory bytes)
// as fit on the card at once, and no more than n_units.
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, int smem, int n_units,
                            int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  *blocks = std::min(n_units, std::max(1, sms * per_sm));
  return cudaSuccess;
}

}  // namespace hopper
}  // namespace sgdrc
