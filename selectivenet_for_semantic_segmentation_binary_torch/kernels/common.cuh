// Device code shared by the port's kernels: the BatchNorm-apply prologue of
// the fused-CBR kernels (8 channels of an NHWC pixel, or 8 samples of one
// channel in the transposed layout), the fixed-order sum of per-CTA
// partials that makes their statistics, and bn_stats', the same run to run,
// and Hopper's building blocks: wgmma and its shared-memory descriptors,
// mbarriers, TMA tile loads and the host's tensor maps.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsReduceThreads = 256;

// relu(x * a + b) of 8 bf16 channels, rounded back to bf16, with the 8
// channels' a and b in registers. __fmul_rn and __fadd_rn keep the compiler
// from contracting to an fma, so xn equals the plain PyTorch version's bit
// for bit.
__device__ __forceinline__ uint4 prologue8_ab(uint4 v, const float (&av)[8], const float (&bv)[8]) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(p[j]);
    const float lo = fmaxf(__fadd_rn(__fmul_rn(f.x, av[2 * j]), bv[2 * j]), 0.0f);
    const float hi = fmaxf(__fadd_rn(__fmul_rn(f.y, av[2 * j + 1]), bv[2 * j + 1]), 0.0f);
    p[j] = __floats2bfloat162_rn(lo, hi);
  }
  return v;
}

// prologue8_ab with a and b read from global memory (8 floats each).
__device__ __forceinline__ uint4 prologue8(uint4 v, const float* a, const float* b) {
  const float4 a0 = __ldg(reinterpret_cast<const float4*>(a));
  const float4 a1 = __ldg(reinterpret_cast<const float4*>(a) + 1);
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(b));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(b) + 1);
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  return prologue8_ab(v, av, bv);
}

// relu(x * a + b) of one bf16 value, with prologue8's arithmetic.
__device__ __forceinline__ __nv_bfloat16 prologue1(__nv_bfloat16 v, float a, float b) {
  return __float2bfloat16_rn(fmaxf(__fadd_rn(__fmul_rn(__bfloat162float(v), a), b), 0.0f));
}

// prologue8 for 8 bf16 values of ONE channel: in the transposed
// (H, C, W, N) layout 8 contiguous elements are 8 samples of a channel, so
// they share one (a, b).
__device__ __forceinline__ uint4 prologue8_1ch(uint4 v, float a, float b) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(p[j]);
    p[j] = __floats2bfloat162_rn(fmaxf(__fadd_rn(__fmul_rn(f.x, a), b), 0.0f),
                                 fmaxf(__fadd_rn(__fmul_rn(f.y, a), b), 0.0f));
  }
  return v;
}

// The sum of the n values at p by a block of kRowsReduceThreads threads,
// each thread over a fixed strided subset, then a fixed tree: deterministic.
// Thread 0 returns it.
__device__ __forceinline__ float block_row_sum(const float* __restrict__ p, int64_t n) {
  __shared__ float sh[kRowsReduceThreads];
  float acc = 0.0f;
  for (int64_t t = threadIdx.x; t < n; t += kRowsReduceThreads) acc += p[t];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kRowsReduceThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  return sh[0];
}

// out[r] = sum of row r of partials (one row of n values per block, launched
// with kRowsReduceThreads threads), in block_row_sum's fixed order.
__global__ void __launch_bounds__(kRowsReduceThreads)
rows_reduce_kernel(const float* __restrict__ partials, int64_t n, float* __restrict__ out) {
  const float sum = block_row_sum(partials + static_cast<int64_t>(blockIdx.x) * n, n);
  if (threadIdx.x == 0) out[blockIdx.x] = sum;
}

// --- wgmma ---------------------------------------------------------------------------

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), 128-byte swizzle. The swizzled tiles are rows of
// 128 bytes whose 16-byte pieces sit in the order piece ^ (row % 8), each
// 8-row group 1024 bytes and 1024-byte aligned (the pattern repeats there),
// as TMA's CU_TENSOR_MAP_SWIZZLE_128B writes them. K-major operand: SBO 1024
// between 8-row groups, LBO unused; the next 16 of K start 32 bytes on. MN-
// major operand (rows along K, 64 elements of M or N a row): SBO 1024
// between 8-row groups of K, LBO between 64-column blocks; the next 16 of K
// start 2048 bytes on.
__device__ __forceinline__ uint64_t wg_desc(const void* p, int lbo, int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The writes this thread made to shared memory through the generic proxy
// (cp.async, stores) become visible to wgmma's and TMA's async proxy.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64x128, float32) (+)= A (64x16) . B (16x128, N-major), bf16 operands in shared
// memory; A is K-major (kTransA 0) or M-major (kTransA 1).
template <int kTransA>
__device__ __forceinline__ void wgmma_64x128x16(float (&d)[64], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA));
}

// d (64x64, float32) (+)= A (64x16) . B (16x64, N-major), bf16 operands in shared
// memory; A is K-major (kTransA 0) or M-major (kTransA 1).
template <int kTransA>
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA));
}

// d (64xkN) (+)= A . B over one k16 step, kN 64 or 128.
template <int kN, int kTransA>
__device__ __forceinline__ void wgmma_step(float (&d)[kN / 2], uint64_t da, uint64_t db) {
  if constexpr (kN == 128)
    wgmma_64x128x16<kTransA>(d, da, db, 1);
  else
    wgmma_64x64x16<kTransA>(d, da, db, 1);
}

// --- mbarriers and TMA ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Arrives and adds bytes to the transfer count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Spins until the phase of the given parity has completed (a fresh barrier
// counts its phase before 0, parity 1, as completed). A wait past ~20 G
// cycles (over 10 s) traps: the launch then fails with an error instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > 20000000000LL)
      __trap();
  }
}

// A TMA tile load into shared memory, its bytes counted on bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// bar.sync on named barrier kId for kThreads threads (whole warps), so that
// one group of warps syncs while the others run on.
template <int kId, int kThreads>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kId), "n"(kThreads) : "memory");
}

// Launch return codes above this are a failed tensor-map encode: the
// CUresult is the code less kTensorMapError.
constexpr int kTensorMapError = 100000;

// A bf16 tensor map for TMA tile loads with the 128-byte swizzle and zero
// fill out of bounds: dims innermost first, strides (bytes) of dims 1.., the
// box. The driver's encoder is reached through the runtime, so the library
// needs no -lcuda. Returns 0 or an error code.
inline int encode_bf16_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                           const uint64_t* strides, const uint32_t* box) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
                            const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

// The error string of a launch's return code (a CUDA error or a failed
// tensor-map encode).
inline const char* launch_error_string(int code) {
  if (code >= kTensorMapError) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The card's multiprocessor count.
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 132;
  return n;
}

}  // namespace
