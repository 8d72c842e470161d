// int8 implicit-GEMM 3x3 conv (W8A8) for Hopper (sm_90a): K10.
//
// No Pallas original. Replaces the XLA int8 convolution of the JAX package's
// int8 paths, selectivenet_for_semantic_segmentation_binary_tpu/models/unet.py:
//   the W8A8 serving CBR (:315-327, static activation scale) and
//   _qat_fwd_math (:221-240, the QAT forward's dynamic scales),
// both lax.conv_general_dilated(int8, int8, preferred_element_type=int32).
//
// For x (N, H, W, Cin) NHWC in bf16 or float32, w (Cout, 3, 3, Cin) int8,
// the activation scale a (one float32 on the device), the per-output-channel
// weight scales ks (Cout,) and, for the static variant, bias (Cout,):
//   prologue  q = clamp(rint(float(x) * (1 / a)), -127, 127)   (int8; rint
//             rounds half to even as jnp.round; 1 / a in float32)
//   product   acc = sum over (dy, dx, c) of q[n, h+dy-1, w+dx-1, c] *
//             w[co, dy, dx, c]  (int32, exact; SAME zero padding is exact
//             since the quantization has no zero point)
//   static    y = relu(fadd_rn(fmul_rn(float(acc), fmul_rn(a, ks[co])), bias[co]))
//             in the output dtype (bf16 or float32): the serving CBR;
//   dynamic   y = fmul_rn(float(acc), fmul_rn(a, ks[co])) in float32: the QAT
//             forward, whose CBR adds its bias afterwards.
// The __fmul_rn / __fadd_rn intrinsics keep nvcc from contracting the
// epilogue into an FMA, so the kernel equals its plain version
// (ops/int8_conv.py::int8_conv_reference) bit for bit.
//
// Bound: at the main path's shapes the int8 operations over the card's
// 1,979 TOPS take about as long as the bf16 activations over 3.35 TB/s
// (the 14 trunk layers of a batch-128 forward: 9.00e12 operations, ~15.96
// GB moved, ~5.96 ms summed layer by layer).
//
// Design, a first simple kernel (mma.sync, no TMA, no wgmma):
// - A CTA of 8 warps computes a tile of BM output pixels (consecutive in
//   N*H*W) by BN output channels: 128 x 128, or 256 x 64 where Cout is not
//   a multiple of 128. Each warp holds a 64 x 32 tile of int32 sums in
//   registers: 4 x 4 mma.sync.m16n8k32.s8.s8.s32 a step of 32 reductions.
// - The reduction runs over (channel chunk of 32, tap) with the taps inner,
//   so the nine shifted reads of one chunk find the rows in L1/L2. A step
//   stages the A tile (BM pixels x 32 channels of one tap, quantized by the
//   prologue on the way into shared memory; zeros outside the image) and
//   the B tile (BN channels x 32 int8 weights) into one of two shared
//   buffers, while the warps multiply the other: the next step's global
//   loads are issued before this step's products and stored after them.
// - Rows of 48 bytes in shared memory make the 4-byte fragment loads of a
//   warp hit 32 distinct banks.
// - Cin % 32 != 0 (the first layer: RGB 3, GH 2) runs the element path of
//   the same kernel: the reduction index k = tap * Cin + c is flattened and
//   cut into steps of 32, the tail of the last step (27 -> 32 at Cin = 3)
//   zero-filled in A and in B.
// - The epilogue converts each pair of neighbouring channels and stores it
//   as one bf16x2 or float2 word.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;          // int8 reductions a step: one mma k-step
constexpr int kLds = kBK + 16;   // shared row stride in bytes

struct Params {
  const void* x;
  const int8_t* w;
  const float* a;
  const float* ks;
  const float* bias;
  void* y;
  long long M;  // N * H * W
  int H, W, Cin, Cout;
};

__device__ __forceinline__ uint32_t q8(float v, float inv_a) {
  // __float2int_rn rounds half to even and saturates; the clamp follows
  int q = __float2int_rn(__fmul_rn(v, inv_a));
  q = min(max(q, -127), 127);
  return static_cast<uint32_t>(q) & 0xffu;
}

__device__ __forceinline__ uint32_t pack4(const float* v, float inv_a) {
  return q8(v[0], inv_a) | (q8(v[1], inv_a) << 8) | (q8(v[2], inv_a) << 16) |
         (q8(v[3], inv_a) << 24);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// 16-byte words of raw input -> floats
__device__ __forceinline__ void unpack(const uint4& u, __nv_bfloat16, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename Tin, typename Tout, int BM, int BN, bool kDynamic, bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const Params p) {
  constexpr int kWarpsN = BN / 32;
  constexpr int kWarpsM = 8 / kWarpsN;
  constexpr int kWarpM = BM / kWarpsM;  // 64
  constexpr int MT = kWarpM / 16;       // m16 tiles a warp
  constexpr int NT = 4;                 // n8 tiles a warp (32 channels)
  constexpr int kTpr = kThreads / BM;   // threads staging one A row
  constexpr int kE = kBK / kTpr;        // A elements a thread stages
  constexpr int kRaw = kVec ? kE * static_cast<int>(sizeof(Tin)) / 16 : 1;
  constexpr int kElemsPerVec = 16 / static_cast<int>(sizeof(Tin));
  constexpr int kBElems = BN * kBK / kThreads;  // B bytes a thread (element path)
  static_assert(kWarpM == 64, "warp tile");
  static_assert(BN * 2 <= kThreads, "one 16-byte B word a thread at most");

  __shared__ __align__(16) uint8_t sA[2][BM * kLds];
  __shared__ __align__(16) uint8_t sB[2][BN * kLds];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int K = 9 * Cin;
  const float a = *p.a;
  const float inv_a = __fdiv_rn(1.0f, a);
  const Tin* __restrict__ x = static_cast<const Tin*>(p.x);

  // the A row this thread stages: one output pixel
  const int ar = tid / kTpr, apart = tid % kTpr;
  const long long am = m0 + ar;
  const bool arow = am < p.M;
  int an = 0, ah = 0, aw = 0;
  if (arow) {
    const long long hw = static_cast<long long>(H) * W;
    an = static_cast<int>(am / hw);
    const int rem = static_cast<int>(am - static_cast<long long>(an) * hw);
    ah = rem / W;
    aw = rem - ah * W;
  }
  // the B row (output channel) and half this thread stages (vector path)
  const int br = tid >> 1, bhalf = tid & 1;
  const bool bthread = tid < BN * 2;
  const bool brow = bthread && n0 + br < Cout;

  const int nsteps = kVec ? (Cin / kBK) * 9 : (K + kBK - 1) / kBK;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  uint4 raw[kRaw];
  uint4 braw = make_uint4(0, 0, 0, 0);
  float ev[kVec ? 1 : kE];
  uint8_t eb[kVec ? 1 : kBElems];

  auto load = [&](int s) {
    if constexpr (kVec) {
      const int chunk = s / 9, tap = s - chunk * 9;
      const int ih = ah + tap / 3 - 1, iw = aw + tap % 3 - 1;
      const bool ok = arow && ih >= 0 && ih < H && iw >= 0 && iw < W;
      if (ok) {
        const uint4* src = reinterpret_cast<const uint4*>(
            x + ((static_cast<long long>(an) * H + ih) * W + iw) * Cin + chunk * kBK +
            apart * kE);
#pragma unroll
        for (int i = 0; i < kRaw; ++i) raw[i] = __ldg(src + i);
      } else {
#pragma unroll
        for (int i = 0; i < kRaw; ++i) raw[i] = make_uint4(0, 0, 0, 0);
      }
      if (brow) {
        braw = __ldg(reinterpret_cast<const uint4*>(
            p.w + static_cast<long long>(n0 + br) * K + tap * Cin + chunk * kBK + bhalf * 16));
      }
    } else {
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        const int k = s * kBK + apart * kE + j;
        float v = 0.0f;
        if (arow && k < K) {
          const int tap = k / Cin, c = k - tap * Cin;
          const int ih = ah + tap / 3 - 1, iw = aw + tap % 3 - 1;
          if (ih >= 0 && ih < H && iw >= 0 && iw < W)
            v = to_float(x[((static_cast<long long>(an) * H + ih) * W + iw) * Cin + c]);
        }
        ev[j] = v;
      }
#pragma unroll
      for (int j = 0; j < kBElems; ++j) {
        const int idx = tid * kBElems + j;
        const int row = idx / kBK, k = s * kBK + idx % kBK;
        eb[j] = (n0 + row < Cout && k < K)
                    ? static_cast<uint8_t>(p.w[static_cast<long long>(n0 + row) * K + k])
                    : 0;
      }
    }
  };

  auto store = [&](int buf) {
    uint32_t packed[kE / 4];
    if constexpr (kVec) {
#pragma unroll
      for (int i = 0; i < kRaw; ++i) {
        float f[kElemsPerVec];
        unpack(raw[i], Tin(), f);
#pragma unroll
        for (int j = 0; j < kElemsPerVec / 4; ++j)
          packed[i * (kElemsPerVec / 4) + j] = pack4(f + 4 * j, inv_a);
      }
      if (bthread) {
        *reinterpret_cast<uint4*>(&sB[buf][br * kLds + bhalf * 16]) =
            brow ? braw : make_uint4(0, 0, 0, 0);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kE / 4; ++j) packed[j] = pack4(ev + 4 * j, inv_a);
#pragma unroll
      for (int j = 0; j < kBElems; ++j) {
        const int idx = tid * kBElems + j;
        sB[buf][(idx / kBK) * kLds + idx % kBK] = eb[j];
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(&sA[buf][ar * kLds + apart * kE]);
#pragma unroll
    for (int i = 0; i < kE / 16; ++i)
      dst[i] = make_uint4(packed[4 * i], packed[4 * i + 1], packed[4 * i + 2], packed[4 * i + 3]);
  };

  auto compute = [&](int buf) {
    const uint8_t* A = sA[buf];
    const uint8_t* B = sB[buf];
    uint32_t af[MT][4], bf[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = wm * kWarpM + i * 16 + g;
      af[i][0] = *reinterpret_cast<const uint32_t*>(&A[r * kLds + t * 4]);
      af[i][1] = *reinterpret_cast<const uint32_t*>(&A[(r + 8) * kLds + t * 4]);
      af[i][2] = *reinterpret_cast<const uint32_t*>(&A[r * kLds + 16 + t * 4]);
      af[i][3] = *reinterpret_cast<const uint32_t*>(&A[(r + 8) * kLds + 16 + t * 4]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = wn * 32 + j * 8 + g;
      bf[j][0] = *reinterpret_cast<const uint32_t*>(&B[c * kLds + t * 4]);
      bf[j][1] = *reinterpret_cast<const uint32_t*>(&B[c * kLds + 16 + t * 4]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  };

  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < nsteps; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < nsteps;
    if (more) load(s + 1);
    compute(buf);
    if (more) store(buf ^ 1);
    __syncthreads();
  }

  Tout* __restrict__ y = static_cast<Tout*>(p.y);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + wn * 32 + j * 8 + t * 2;
    if (col >= Cout) continue;
    const float s0 = __fmul_rn(a, p.ks[col]), s1 = __fmul_rn(a, p.ks[col + 1]);
    float b0 = 0.0f, b1 = 0.0f;
    if (!kDynamic) {
      b0 = p.bias[col];
      b1 = p.bias[col + 1];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + wm * kWarpM + i * 16 + g + h * 8;
        if (row >= p.M) continue;
        float v0 = __fmul_rn(static_cast<float>(acc[i][j][2 * h]), s0);
        float v1 = __fmul_rn(static_cast<float>(acc[i][j][2 * h + 1]), s1);
        if (!kDynamic) {
          v0 = fmaxf(__fadd_rn(v0, b0), 0.0f);
          v1 = fmaxf(__fadd_rn(v1, b1), 0.0f);
        }
        store_pair(y + row * Cout + col, v0, v1);
      }
    }
  }
}

template <typename Tin, typename Tout, bool kDynamic>
int launch_typed(const Params& p, cudaStream_t stream) {
  const bool vec = p.Cin % kBK == 0;
  const unsigned mt128 = static_cast<unsigned>((p.M + 127) / 128);
  const unsigned mt256 = static_cast<unsigned>((p.M + 255) / 256);
  if (p.Cout % 128 == 0) {
    const dim3 grid(mt128, p.Cout / 128);
    if (vec)
      int8_conv_kernel<Tin, Tout, 128, 128, kDynamic, true><<<grid, kThreads, 0, stream>>>(p);
    else
      int8_conv_kernel<Tin, Tout, 128, 128, kDynamic, false><<<grid, kThreads, 0, stream>>>(p);
  } else {
    const dim3 grid(mt256, (p.Cout + 63) / 64);
    if (vec)
      int8_conv_kernel<Tin, Tout, 256, 64, kDynamic, true><<<grid, kThreads, 0, stream>>>(p);
    else
      int8_conv_kernel<Tin, Tout, 256, 64, kDynamic, false><<<grid, kThreads, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The reduction depth of a step: the kernel's vector path takes Cin % 32 == 0.
int int8_conv_chunk() { return kBK; }

// x: (N, H, W, Cin) bf16 (x_bf16 = 1) or float32, contiguous, 16-byte
// aligned. w: (Cout, 3, 3, Cin) int8, contiguous, 16-byte aligned. a: one
// float32; ks, bias: float32 (Cout,) (bias unused when dynamic). y: (N, H,
// W, Cout), bf16 (y_bf16 = 1) or float32; dynamic = 1 takes float32 only.
// Cout % 8 == 0. Returns the cudaError_t of the launch.
int int8_conv_launch(const void* x, int x_bf16, const void* w, const void* a, const void* ks,
                     const void* bias, void* y, int y_bf16, int n, int h, int wd, int cin,
                     int cout, int dynamic, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || cin < 1 || cout < 8 || cout % 8 != 0 ||
      (dynamic && y_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.a = static_cast<const float*>(a);
  p.ks = static_cast<const float*>(ks);
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.M = static_cast<long long>(n) * h * wd;
  p.H = h;
  p.W = wd;
  p.Cin = cin;
  p.Cout = cout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dynamic)
    return x_bf16 ? launch_typed<__nv_bfloat16, float, true>(p, s)
                  : launch_typed<float, float, true>(p, s);
  if (x_bf16)
    return y_bf16 ? launch_typed<__nv_bfloat16, __nv_bfloat16, false>(p, s)
                  : launch_typed<__nv_bfloat16, float, false>(p, s);
  return y_bf16 ? launch_typed<float, __nv_bfloat16, false>(p, s)
                : launch_typed<float, float, false>(p, s);
}

const char* int8_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
