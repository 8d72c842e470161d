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
//             since the quantization has no zero point: q(0) = 0)
//   static    y = relu(fadd_rn(fmul_rn(float(acc), fmul_rn(a, ks[co])), bias[co]))
//             in the output dtype (bf16 or float32): the serving CBR;
//   dynamic   y = fmul_rn(float(acc), fmul_rn(a, ks[co])) in float32: the QAT
//             forward, whose CBR adds its bias afterwards.
// The __fmul_rn / __fadd_rn intrinsics keep nvcc from contracting the
// epilogue into an FMA, and |acc| <= 127 * 127 * 9 * Cin < 2^31 up to Cin
// 14,793, so the sums are exact in any order and the kernel equals its plain
// version (ops/int8_conv.py::int8_conv_reference) bit for bit.
//
// Bound: at the main path's shapes the int8 operations over the card's
// 1,979 TOPS take about as long as the bf16 activations over 3.35 TB/s
// (the 14 trunk layers of a batch-128 forward: 9.00e12 operations, ~15.96
// GB moved, ~5.98 ms summed layer by layer).
//
// Three kernels, chosen by shape alone (int8_conv_path; the wrapper's
// ops/int8_conv.py::kernel_path is the same rule in Python):
//
// int8_conv_wgmma_kernel (Cin % 32 == 0 and the window below fits the
// shared memory: W <= 745 where Cout % 128 != 0, W <= 585 where it is 0;
// N H W < 2^31 - 256 and (H + 4)(W + 2) + 2048 < 2^31). The 13 trunk layers.
//   The GEMM: M = output channels, N = output positions, K = (tap, channel).
//   Cout is M because the 8-bit wgmma takes both operands K-major: the
//   weights (Cout, 3, 3, Cin) are already channel-contiguous rows of A, and
//   positions as N give the widest instruction, m64n256k32, at every layer
//   (positions as M would make N = Cout, 64 at the Cout-64 layers: twice the
//   shared-memory bytes a product). A consumer warpgroup holds 64 channels
//   x 256 positions of int32 sums (128 registers a thread).
//   Positions are flattened with the padded width Wp = W + 2: output (h, w)
//   is position j = h Wp + w, and the staged input pixel (h', w') of the
//   image padded by one (zeros) is position h' Wp + w'. Tap (dy, dx) of
//   output j reads staged position j + dy Wp + dx, so the nine taps of a
//   tile of positions are nine views of ONE staged window, each a fixed
//   number of positions further on. The window is int8, K-major, without
//   swizzle: for channels 0-15 and 16-31 of a 32-channel chunk, a plane of
//   16-byte rows, one a position. A view shifted by one position is one row,
//   16 bytes on, so every tap is a legal descriptor start (wg_desc_noswizzle;
//   the 128-byte swizzle of the bf16 kernels would need whole 1024-byte
//   atoms). Positions w = W, W + 1 of each row are computed and dropped:
//   2 / Wp of the products (6% at W 32, 0.8% at W 256).
//   A CTA of two consumer warpgroups and one producer warpgroup takes a
//   tile of P positions of one image by 64 cw output channels: cw = 2
//   (P = 256, the warpgroups on channels co0 and co0 + 64) where
//   Cout % 128 == 0, else cw = 1 (P = 512, the warpgroups on positions
//   0-255 and 256-511). It walks its tiles (one of every gridDim.x, same
//   channel tile) with the producers ahead of it:
//   - two producer threads issue every TMA load, apart so that a wait for a
//     weight slot never holds back the input: the tile's window of raw
//     input, chunk by chunk, as boxes of 256 (bf16) or 128 (float32) pixels
//     x 32 channels of x seen as (N H W, Cin) through a ring of three 16 KB
//     slots (the window's in-image pixels are one contiguous run of that
//     2D view, so no box reads a pixel twice and the map's zero fill covers
//     the end of the tensor); and the weights of (chunk, 9 taps, 64 cw
//     channels), a box of w seen as (16 channels, Cout, Cin / 16, 9): two
//     slots, loaded once and kept where Cin <= 64 (64 -> 64: 36 KB), else
//     one chunk a stage through the two slots. The producer warpgroup hands
//     its registers to the consumers (setmaxnreg: 40 and 2 x 232 a thread;
//     with 168 for all, the 128 sums and the conversion spilled);
//   - the consumers' 256 threads convert each raw element ONCE into the
//     int8 window and write zeros at the padding, then fence.proxy.async
//     and a named barrier; while the nine wgmma of stage s run, they
//     convert stage s + 1 into the other window buffer. A thread takes one
//     16-byte piece of 4 pixels of a box, loaded before any is converted,
//     and releases the slot once they are in registers. The arithmetic is
//     q8's: __fdiv_rn(1, a), x * (1 / a) rounded to nearest even and
//     clamped to +-127, the clamp taken first in float and the rounding by
//     adding 1.5 * 2^23 (pack4_fast: the same levels for every input that is
//     not NaN, without the conversion unit);
//   - a tile's last chunk ends in store_tile (the epilogue): the unchanged
//     arithmetic, then bf16 through stmatrix.trans into 2 KB of shared
//     memory a warp and out as 16-byte NHWC stores (8 channels of one
//     position), or float32 as one 4-byte store a value, 8 lanes on 32
//     contiguous bytes.
//   Staging arithmetic. A stage is one 32-channel chunk of a tile. Its
//   window is L = P + 2 Wp + 2 positions (P outputs and the two halo rows),
//   quantized once in the CTA and read by all nine taps and both
//   warpgroups. So the CTA quantizes L / P staged elements per output
//   position and chunk (the mma.sync kernel: 9, once per tap, and again
//   per column CTA), and x crosses from L2 as L / P raw reads per element of x
//   for each channel tile of 64 cw: at the trunk's shapes
//     64 -> 64 at 256 (cw 1): L / P = 1030 / 512 = 2.01, one channel tile;
//     128 -> 128 at 128 (cw 2): 518 / 256 = 2.02, one tile;
//     256 -> 256 at 64 (cw 2): 390 / 256 = 1.52, two tiles;
//     512 -> 512 at 32 (cw 2): 326 / 256 = 1.27, four tiles.
//   The weights cross once a CTA where resident, else 9 Cin bytes per
//   position of a tile for each channel (18 B per output at Cin 512).
//   Shared memory: window 2 buffers x 2 planes x (16 L + 64) B (66 KB at
//   64 -> 64 at 256), weights 2 x 9 x 32 x 64 cw B (36 or 72 KB), raw ring
//   48 KB, epilogue 16 KB: 170 KB at 64 -> 64 at 256, 174 KB at 128 at 128.
//   The 16 L + 64 B plane stride puts the two planes' 64-byte halves of a
//   phase of stores on distinct banks.
//
// int8_conv_im2col_kernel (Cin <= 3: the first layer, RGB's 3 and GH's 2).
//   K = 9 Cin <= 27 is one k32 step: the CTA (two warpgroups, P = 512, 64
//   output channels) quantizes its tile's window once, a 4-byte word a
//   position, builds each position's 32-byte im2col row from the nine
//   taps' words (zeros from byte 9 Cin on, in the weights' rows too), and
//   each warpgroup runs one m64n256k32; store_tile writes the outputs. x is
//   read with plain loads: a pixel of 6 or 12 bytes makes no TMA box.
//
// int8_conv_kernel (every other shape: 3 < Cin, Cin % 32 != 0, or a window
// too wide): the first design, kept as it was.
//   A CTA of 8 warps computes BM output pixels (consecutive in N*H*W) by BN
//   output channels: 128 x 128, or 256 x 64 where Cout % 128 != 0, with
//   mma.sync.m16n8k32.s8.s8.s32 (4 x 4 a warp, 64 x 32 of int32 sums). The
//   reduction runs over (channel chunk of 32, tap), taps inner; each step
//   stages the A tile (quantized on the way into shared memory, zeros
//   outside the image) and the B tile into one of two buffers while the
//   warps multiply the other. Cin % 32 != 0 flattens k = tap * Cin + c and
//   cuts it into steps of 32 element by element, the tail zero-filled in A
//   and B. Rows of 48 bytes keep the 4-byte fragment loads on distinct
//   banks. The epilogue stores bf16x2 / float2 words.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// --- the mma.sync kernel: the shapes the wgmma kernels do not take ---------------------

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
int launch_mma_sync(const Params& p, cudaStream_t stream) {
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


// --- the wgmma kernel ------------------------------------------------------------------

constexpr int kQC = 32;             // input channels of a stage: one k32 step a tap
constexpr int kPos = 256;           // positions of a warpgroup's tile (m64n256k32)
constexpr int kConsumers = 256;     // two warpgroups
constexpr int kWgThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kRawSlots = 3;
constexpr int kRawBytes = 16384;    // 256 bf16 or 128 float32 pixels x 32 channels
constexpr int kWarpEpi = 2048;      // a warp's 4 x 16 positions x 16 channels of bf16
constexpr int kBarBytes = 128;      // 10 mbarriers
constexpr int kSmemCap = 232448;    // a CTA's dynamic shared memory on an H100

struct WGeo {
  int n, h, w, cin, cout;
  int cw;          // 64-channel warpgroup tiles of a CTA's channel tile: 1 or 2
  int P;           // positions of a CTA's tile: 256 (cw 2) or 512 (cw 1)
  int Wp;          // W + 2
  int L;           // positions of a window: P + 2 Wp + 2
  int plane;       // bytes of a window plane: 16 L rounded up to 128, + 64
  int chunks;      // Cin / 32
  int tiles;       // position tiles of an image: ceil(H Wp / P)
  int n_co;        // channel tiles: ceil(Cout / (64 cw))
  int raw_pix;     // pixels of a raw box
  int wstage;      // bytes of one weight slot: 9 x 32 x 64 cw
  int grid_x;      // CTAs of a channel tile
  int smem;        // dynamic shared memory, with 1 KB for the alignment
};

WGeo wgeo(int n, int h, int wd, int cin, int cout, int x_bf16) {
  WGeo g;
  g.n = n;
  g.h = h;
  g.w = wd;
  g.cin = cin;
  g.cout = cout;
  g.cw = cout % 128 == 0 ? 2 : 1;
  g.P = kPos * (3 - g.cw);
  g.Wp = wd + 2;
  g.L = g.P + 2 * g.Wp + 2;
  g.plane = (16 * g.L + 127) / 128 * 128 + 64;
  g.chunks = cin / kQC;
  g.tiles = static_cast<int>((static_cast<long long>(h) * g.Wp + g.P - 1) / g.P);
  g.n_co = (cout + 64 * g.cw - 1) / (64 * g.cw);
  g.raw_pix = x_bf16 ? 256 : 128;
  g.wstage = 9 * kQC * 64 * g.cw;
  const long long items = static_cast<long long>(n) * g.tiles;
  long long gx = sm_count() / g.n_co;
  if (gx < 1) gx = 1;
  g.grid_x = static_cast<int>(items < gx ? items : gx);
  g.smem = 2 * g.wstage + kRawSlots * kRawBytes + 4 * g.plane +
           (kConsumers / 32) * kWarpEpi + kBarBytes + 1024;
  return g;
}

// In-image pixels of an image among its padded positions [0, q) (row-major,
// width Wp, rows 0 and H + 1 the padding).
__device__ __forceinline__ int valid_before(const WGeo& g, int q) {
  const int pr = q / g.Wp, pc = q - pr * g.Wp;
  if (pr < 1) return 0;
  if (pr > g.h) return g.h * g.w;
  return (pr - 1) * g.w + min(max(pc - 1, 0), g.w);
}

// (row, col) of an index v = row * d + col, and stepping it by a fixed
// stride (srow, scol) = (stride / d, stride % d), so a thread divides once
// and then adds
struct RowCol {
  int row, col;
  __device__ __forceinline__ RowCol(int v, int d) : row(v / d), col(v - (v / d) * d) {}
  __device__ __forceinline__ void step(int srow, int scol, int d) {
    row += srow;
    col += scol;
    if (col >= d) {
      col -= d;
      ++row;
    }
  }
};

// Eight rows of an 8 x 8 b16 matrix fragment of each of four matrices,
// stored transposed: row i of matrix m at the address lane 8 m + i passes
// holds column i of the fragment.
__device__ __forceinline__ void stmatrix_x4_trans(const void* row, uint32_t r0, uint32_t r1,
                                                  uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_u32(row)),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// q8 of four values, packed: the clamp to +-127 first, in float, then
// rint by adding 1.5 * 2^23 (round to nearest even, as __float2int_rn; the
// sum's low byte is the level in two's complement). clamp(rint(t)) equals
// rint(clamp(t)) for every t that is not NaN, the bounds being integers.
// Float adds in place of the conversion unit: on an H100 the 13 wgmma
// layers took 4% less time than with __float2int_rn and an integer clamp.
__device__ __forceinline__ uint32_t pack4_fast(const float* v, float inv_a) {
  uint32_t b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    b[i] = __float_as_uint(
        __fadd_rn(fminf(fmaxf(__fmul_rn(v[i], inv_a), -127.0f), 127.0f), 12582912.0f));
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

// 16 bytes of raw input (8 bf16 or 4 float32 channels) -> their int8 levels,
// packed in order into the low bytes
__device__ __forceinline__ uint2 quantize16(const uint4& u, __nv_bfloat16, float inv_a) {
  float f[8];
  unpack(u, __nv_bfloat16(), f);
  return make_uint2(pack4_fast(f, inv_a), pack4_fast(f + 4, inv_a));
}
__device__ __forceinline__ uint2 quantize16(const uint4& u, float, float inv_a) {
  float f[4];
  unpack(u, float(), f);
  return make_uint2(pack4_fast(f, inv_a), 0u);
}

// A consumer warpgroup's tile out of its accumulators: position pos0 + 8 b
// + 2 (lane % 4) + e of image n is accumulator b * 4 + 2 h + e of channel
// wco + r0 + 8 h (r0 = 16 (warp % 4) + lane / 4; sc, bi that channel's
// a * ks and bias). The static epilogue relu(acc * sc + bias) or the dynamic
// acc * sc, one rounding an operation; positions past the image's rows and
// columns and channels past Cout are dropped. bf16 goes through the warp's
// 2 KB buf by stmatrix.trans, four groups of 16 positions at a time, and
// out as 16-byte NHWC stores (8 channels of a position); float32 as 4-byte
// stores, 8 lanes on 32 contiguous bytes.
template <bool kOutBf16, bool kDynamic>
__device__ __forceinline__ void store_tile(const int (&acc)[128], const float (&sc)[2],
                                           const float (&bi)[2], void* y_ptr, const WGeo& g,
                                           int n, int pos0, int wco, unsigned char* buf) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const long long img = static_cast<long long>(n) * g.h;
  auto value = [&](int v, int h) {
    const float f = __fmul_rn(static_cast<float>(v), sc[h]);
    return kDynamic ? f : fmaxf(__fadd_rn(f, bi[h]), 0.0f);
  };
  if constexpr (kOutBf16) {
    __nv_bfloat16* y = static_cast<__nv_bfloat16*>(y_ptr);
    const int mm = lane >> 3, ii = lane & 7;
    const int co = wco + warp * 16 + (lane & 1) * 8;
    RowCol rc(pos0 + (lane >> 1), g.Wp);  // the position this lane stores
    const int erow = 16 / g.Wp, ecol = 16 % g.Wp;
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) {
#pragma unroll
      for (int jq = 0; jq < 4; ++jq) {
        const int jj = jb * 4 + jq;
        uint32_t r[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int b = 2 * jj + (m >> 1), h = m & 1;
          const __nv_bfloat162 v = __floats2bfloat162_rn(value(acc[b * 4 + 2 * h], h),
                                                         value(acc[b * 4 + 2 * h + 1], h));
          r[m] = *reinterpret_cast<const uint32_t*>(&v);
        }
        // matrix m = (b = 2 jj + m / 2, h = m % 2); its row i = position
        // 8 (m / 2) + i, channels 8 h .. 8 h + 7: 16 positions x 32 bytes
        stmatrix_x4_trans(buf + jq * 512 + ((mm >> 1) * 8 + ii) * 32 + (mm & 1) * 16, r[0], r[1],
                          r[2], r[3]);
      }
      __syncwarp();
#pragma unroll
      for (int jq = 0; jq < 4; ++jq) {
        const uint4 v = *reinterpret_cast<const uint4*>(buf + jq * 512 + lane * 16);
        if (rc.row < g.h && rc.col < g.w && co < g.cout)
          *reinterpret_cast<uint4*>(y + ((img + rc.row) * g.w + rc.col) * g.cout + co) = v;
        rc.step(erow, ecol, g.Wp);
      }
      __syncwarp();
    }
  } else {
    float* y = static_cast<float*>(y_ptr);
    RowCol rc[2] = {RowCol(pos0 + 2 * (lane & 3), g.Wp), RowCol(pos0 + 2 * (lane & 3) + 1, g.Wp)};
    const int erow = 8 / g.Wp, ecol = 8 % g.Wp;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (rc[e].row < g.h && rc[e].col < g.w) {
          float* yp = y + ((img + rc[e].row) * g.w + rc[e].col) * g.cout + wco + r0;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (wco + r0 + 8 * h < g.cout) yp[8 * h] = value(acc[b * 4 + 2 * h + e], h);
        }
        rc[e].step(erow, ecol, g.Wp);
      }
    }
  }
}

template <typename Tin, bool kOutBf16, bool kDynamic>
__global__ void __launch_bounds__(kWgThreads, 1)
int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap, const float* __restrict__ a_ptr,
                       const float* __restrict__ ks, const float* __restrict__ bias,
                       void* __restrict__ y_ptr, const WGeo g) {
  constexpr int kPieces = 32 * static_cast<int>(sizeof(Tin)) / 16;  // 16 B pieces a pixel
  constexpr int kPieceCh = 16 / static_cast<int>(sizeof(Tin));      // channels a piece
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  unsigned char* ws = smem_raw + (((base + 1023) & ~1023u) - base);
  unsigned char* raw = ws + 2 * g.wstage;
  unsigned char* qb = raw + kRawSlots * kRawBytes;
  unsigned char* epi = qb + 4 * g.plane;
  uint64_t* rawfull = reinterpret_cast<uint64_t*>(epi + (kConsumers / 32) * kWarpEpi);
  uint64_t* rawempty = rawfull + kRawSlots;
  uint64_t* wfull = rawempty + kRawSlots;
  uint64_t* wempty = wfull + 2;

  const int co0 = blockIdx.y * 64 * g.cw;
  const int n_items = g.n * g.tiles;  // < N H W < 2^31
  const int my_items =
      n_items > static_cast<int>(blockIdx.x) ? (n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_stages = my_items * g.chunks;
  const bool resident = g.chunks <= 2;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kRawSlots; ++i) {
      mbar_init(&rawfull[i], 1);
      mbar_init(&rawempty[i], kConsumers / 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&wfull[i], 1);
      mbar_init(&wempty[i], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the image, first position and in-image pixel run of a stage's window
  struct Window {
    int n, j0, v0, count;
  };
  auto window = [&](int s) {
    const int item = blockIdx.x + (s / g.chunks) * gridDim.x;
    Window win;
    win.n = item / g.tiles;
    win.j0 = (item - win.n * g.tiles) * g.P;
    win.v0 = valid_before(g, win.j0);
    win.count = valid_before(g, win.j0 + g.L) - win.v0;
    return win;
  };

  if (threadIdx.x >= kConsumers) {
    // producers: one thread issues the weights' copies, one the raw input's
    // (apart, so that a wait for a weight slot never holds back the input);
    // their warpgroup gives up its registers to the consumers (40 + 2 x 232
    // a thread of 128 x 512)
    warpgroup_reg_dealloc<40>();
    if (threadIdx.x != kConsumers && threadIdx.x != kConsumers + 32) return;
    auto load_w = [&](int slot, int c) {
      mbar_expect_tx(&wfull[slot], g.wstage);
      tma_load_4d(ws + slot * g.wstage, &wmap, &wfull[slot], 0, co0, 2 * c, 0);
    };
    if (threadIdx.x == kConsumers + 32) {
      if (resident)
        for (int c = 0; c < g.chunks; ++c) load_w(c, c);
      else
        for (int s = 0; s < n_stages; ++s) {
          mbar_wait(&wempty[s & 1], ((s >> 1) & 1) ^ 1);
          load_w(s & 1, s % g.chunks);
        }
      return;
    }
    long long piece = 0;
    for (int s = 0; s < n_stages; ++s) {
      const int c = s % g.chunks;
      const Window win = window(s);
      const long long u0 = static_cast<long long>(win.n) * g.h * g.w + win.v0;
      for (int k = 0; k * g.raw_pix < win.count; ++k, ++piece) {
        const int slot = static_cast<int>(piece % kRawSlots);
        mbar_wait(&rawempty[slot], static_cast<uint32_t>((piece / kRawSlots) & 1) ^ 1);
        mbar_expect_tx(&rawfull[slot], kRawBytes);
        tma_load_2d(raw + slot * kRawBytes, &xmap, &rawfull[slot], c * kQC,
                    static_cast<int>(u0 + static_cast<long long>(k) * g.raw_pix));
      }
    }
    return;
  }

  // consumers: warpgroup wg, warp `warp` (0-7), its rows r0 and r0 + 8 of the
  // warpgroup's 64 channels
  warpgroup_reg_alloc<232>();
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const float a = __ldg(a_ptr);
  const float inv_a = __fdiv_rn(1.0f, a);
  constexpr int kStride = kConsumers / kPieces;  // pixels between a thread's items of a box
  constexpr int kItems = kRawBytes / (kPieces * 16) / kStride;  // its items of a box: 4
  const int srow = kStride / g.w, scol = kStride % g.w;  // the steps of RowCol
  const int hrow = kConsumers / g.Wp, hcol = kConsumers % g.Wp;
  const int wco = co0 + (g.cw == 2 ? wg * 64 : 0);  // the warpgroup's first channel
  const int woff = g.cw == 1 ? wg * kPos : 0;       // its first position in the tile
  const int r0 = (warp & 3) * 16 + (lane >> 2);
  float sc[2], bi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int co = wco + r0 + 8 * h;
    sc[h] = co < g.cout ? __fmul_rn(a, __ldg(ks + co)) : 0.0f;
    bi[h] = !kDynamic && co < g.cout ? __ldg(bias + co) : 0.0f;
  }
  int acc[128];
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0;
  long long piece = 0;

  // stage s's window into q: every in-image pixel's 32 channels from the raw
  // ring, converted once (a thread takes one 16-byte piece of a pixel, so a
  // phase of lanes reads contiguous bytes, and 4 pixels of a box, loaded
  // before any is converted), then zeros at the padding. Pixel v of the
  // image lies at window position v + 2 (v / W) + Wp + 1 - j0.
  auto quantize = [&](int s, unsigned char* q) {
    const Window win = window(s);
    const int part = tid % kPieces;
    unsigned char* dst = q + (part / (kPieces / 2)) * g.plane + (part % (kPieces / 2)) * kPieceCh;
    const int i0 = tid / kPieces;
    for (int k = 0; k * g.raw_pix < win.count; ++k, ++piece) {
      const int slot = static_cast<int>(piece % kRawSlots);
      mbar_wait(&rawfull[slot], static_cast<uint32_t>((piece / kRawSlots) & 1));
      const unsigned char* src = raw + slot * kRawBytes + part * 16;
      const int m = min(g.raw_pix, win.count - k * g.raw_pix);
      uint4 u[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        if (i0 + j * kStride < m)
          u[j] = *reinterpret_cast<const uint4*>(src + (i0 + j * kStride) * (kPieces * 16));
      __syncwarp();
      if (lane == 0) mbar_arrive(&rawempty[slot]);  // the slot is in registers
      const int v0 = win.v0 + k * g.raw_pix + i0;
      RowCol rc(v0, g.w);
      const int base = v0 + g.Wp + 1 - win.j0;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (i0 + j * kStride < m) {
          const int p = base + j * kStride + 2 * rc.row;
          const uint2 v = quantize16(u[j], Tin(), inv_a);
          if constexpr (kPieceCh == 8)
            *reinterpret_cast<uint2*>(dst + p * 16) = v;
          else
            *reinterpret_cast<uint32_t*>(dst + p * 16) = v.x;
        }
        rc.step(srow, scol, g.w);
      }
    }
    RowCol hc(win.j0 + tid, g.Wp);
    for (int p = tid; p < g.L; p += kConsumers) {
      if (hc.row < 1 || hc.row > g.h || hc.col < 1 || hc.col > g.w) {
        *reinterpret_cast<uint4*>(q + p * 16) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(q + g.plane + p * 16) = make_uint4(0, 0, 0, 0);
      }
      hc.step(hrow, hcol, g.Wp);
    }
  };

  // the nine products of stage s: tap (dy, dx) reads the window dy Wp + dx
  // positions on
  auto products = [&](int s, const unsigned char* q) {
    const int c = s % g.chunks;
    const int tap_bytes = 2 * 64 * g.cw * 16;  // two 16-channel planes of the tile's rows
    const unsigned char* wsl =
        ws + (resident ? c : (s & 1)) * g.wstage + (g.cw == 2 ? wg * 64 * 16 : 0);
    wg_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      wgmma_64x256x32_s8(acc, wg_desc_noswizzle(wsl + tap * tap_bytes, 64 * g.cw * 16, 128),
                         wg_desc_noswizzle(q + (woff + dy * g.Wp + dx) * 16, g.plane, 128),
                         c > 0 || tap > 0);
    }
    wg_commit();
  };

  auto epilogue = [&](int s) {
    const Window win = window(s);
    store_tile<kOutBf16, kDynamic>(acc, sc, bi, y_ptr, g, win.n, win.j0 + woff, wco,
                                   epi + warp * kWarpEpi);
  };

  if (n_stages > 0) {
    quantize(0, qb);
    fence_async_shared();
    named_sync<1, kConsumers>();
  }
  for (int s = 0; s < n_stages; ++s) {
    const int c = s % g.chunks;
    const int wslot = resident ? c : (s & 1);
    mbar_wait(&wfull[wslot], resident ? 0u : static_cast<uint32_t>((s >> 1) & 1));
    products(s, qb + (s & 1) * 2 * g.plane);
    // stage s + 1 into the other buffer while the products run (its last
    // readers, stage s - 1's products, ended before the barrier below)
    if (s + 1 < n_stages) quantize(s + 1, qb + ((s + 1) & 1) * 2 * g.plane);
    wg_wait<0>();
    if (!resident && (tid & 127) == 0) mbar_arrive(&wempty[wslot]);
    fence_async_shared();  // the converted window, for the next products
    named_sync<1, kConsumers>();
    if (c == g.chunks - 1) epilogue(s);
  }
}


// --- the first layer (Cin <= 3): one im2col k32 step ------------------------------------

// The im2col kernel's geometry: 64-channel tiles (cw 1), P = 512 positions,
// plane the bytes of one of the two 16-byte planes of the im2col rows.
WGeo wgeo_im2col(int n, int h, int wd, int cin, int cout) {
  WGeo g;
  g.n = n;
  g.h = h;
  g.w = wd;
  g.cin = cin;
  g.cout = cout;
  g.cw = 1;
  g.P = 2 * kPos;
  g.Wp = wd + 2;
  g.L = g.P + 2 * g.Wp + 2;
  g.plane = 16 * g.P + 64;
  g.chunks = 1;
  g.tiles = static_cast<int>((static_cast<long long>(h) * g.Wp + g.P - 1) / g.P);
  g.n_co = (cout + 63) / 64;
  g.raw_pix = 0;
  g.wstage = 64 * kQC;
  const long long items = static_cast<long long>(n) * g.tiles;
  long long gx = sm_count() / g.n_co;
  if (gx < 1) gx = 1;
  g.grid_x = static_cast<int>(items < gx ? items : gx);
  g.smem = g.wstage + (4 * g.L + 127) / 128 * 128 + 2 * g.plane + (kConsumers / 32) * kWarpEpi +
           1024;
  return g;
}

// The 32-byte im2col row of a position from the nine taps' words of
// levels (t9[t]: the kCin levels of tap t, one a byte): byte k = t kCin + c
// is level c of tap t; bytes from 9 kCin on are zero.
template <int kCin>
__device__ __forceinline__ void im2col_row(const uint32_t (&t9)[9], uint32_t (&o)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = 0;
#pragma unroll
  for (int k = 0; k < 9 * kCin; ++k)
    o[k >> 2] |= ((t9[k / kCin] >> (8 * (k % kCin))) & 0xFFu) << (8 * (k & 3));
}

// K = 9 Cin <= 27 is one k32 step: the CTA quantizes its tile's window once
// (a word a position, the Cin levels in its low bytes, zeros at the
// padding), builds each position's im2col row from the nine taps' words,
// and each warpgroup runs ONE m64n256k32 over its 256 positions against the
// CTA's 64 output channels (the weights' rows of 9 Cin bytes, zero-filled
// to 32). x is read with plain loads (a pixel is 6 or 12 bytes: no TMA box
// of 16-byte rows); the epilogue is store_tile's.
template <typename Tin, bool kOutBf16, bool kDynamic>
__global__ void __launch_bounds__(kConsumers, 1)
int8_conv_im2col_kernel(const Tin* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ a_ptr, const float* __restrict__ ks,
                        const float* __restrict__ bias, void* __restrict__ y_ptr, const WGeo g) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  unsigned char* ws = smem_raw + (((base + 1023) & ~1023u) - base);  // 2 planes of 64 x 16 B
  uint32_t* words = reinterpret_cast<uint32_t*>(ws + g.wstage);     // L words
  unsigned char* col = ws + g.wstage + (4 * g.L + 127) / 128 * 128;  // 2 planes of P x 16 B
  unsigned char* epi = col + 2 * g.plane;

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int co0 = blockIdx.y * 64;
  const int K = 9 * g.cin;
  for (int i = tid; i < 64 * kQC; i += kConsumers) {
    const int co = i / kQC, k = i % kQC;
    ws[(k >> 4) * 1024 + co * 16 + (k & 15)] =
        co0 + co < g.cout && k < K ? w[static_cast<long long>(co0 + co) * K + k] : 0;
  }
  const float a = __ldg(a_ptr);
  const float inv_a = __fdiv_rn(1.0f, a);
  const int r0 = (warp & 3) * 16 + (lane >> 2);
  float sc[2], bi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int co = co0 + r0 + 8 * h;
    sc[h] = co < g.cout ? __fmul_rn(a, __ldg(ks + co)) : 0.0f;
    bi[h] = !kDynamic && co < g.cout ? __ldg(bias + co) : 0.0f;
  }
  const int hrow = kConsumers / g.Wp, hcol = kConsumers % g.Wp;
  int acc[128];
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0;
  const int n_items = g.n * g.tiles;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int n = item / g.tiles, j0 = (item - n * g.tiles) * g.P;
    __syncthreads();  // the last tile's rows are read
    RowCol rc(j0 + tid, g.Wp);
    for (int p = tid; p < g.L; p += kConsumers) {
      uint32_t word = 0;
      if (rc.row >= 1 && rc.row <= g.h && rc.col >= 1 && rc.col <= g.w) {
        const Tin* px =
            x + ((static_cast<long long>(n) * g.h + rc.row - 1) * g.w + rc.col - 1) * g.cin;
        for (int c = 0; c < g.cin; ++c) word |= q8(to_float(px[c]), inv_a) << (8 * c);
      }
      words[p] = word;
      rc.step(hrow, hcol, g.Wp);
    }
    __syncthreads();
    for (int j = tid; j < g.P; j += kConsumers) {
      uint32_t t9[9], o[8];
#pragma unroll
      for (int t = 0; t < 9; ++t) t9[t] = words[j + (t / 3) * g.Wp + t % 3];
      if (g.cin == 3)
        im2col_row<3>(t9, o);
      else if (g.cin == 2)
        im2col_row<2>(t9, o);
      else
        im2col_row<1>(t9, o);
      *reinterpret_cast<uint4*>(col + j * 16) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(col + g.plane + j * 16) = make_uint4(o[4], o[5], o[6], o[7]);
    }
    fence_async_shared();  // the rows and the weights, for wgmma
    __syncthreads();
    wg_fence();
    wgmma_64x256x32_s8(acc, wg_desc_noswizzle(ws, 64 * 16, 128),
                       wg_desc_noswizzle(col + wg * kPos * 16, g.plane, 128), 0);
    wg_commit();
    wg_wait<0>();
    store_tile<kOutBf16, kDynamic>(acc, sc, bi, y_ptr, g, n, j0 + wg * kPos, co0,
                                   epi + warp * kWarpEpi);
  }
}

template <typename Tin, bool kOutBf16, bool kDynamic>
int launch_im2col(const Params& p, cudaStream_t stream) {
  const WGeo g = wgeo_im2col(static_cast<int>(p.M / (static_cast<long long>(p.H) * p.W)), p.H,
                             p.W, p.Cin, p.Cout);
  auto kernel = int8_conv_im2col_kernel<Tin, kOutBf16, kDynamic>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(g.grid_x, g.n_co), kConsumers, g.smem, stream>>>(
      static_cast<const Tin*>(p.x), p.w, p.a, p.ks, p.bias, p.y, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, bool kOutBf16, bool kDynamic>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  const bool bf16 = sizeof(Tin) == 2;
  const WGeo g = wgeo(p.M / (static_cast<long long>(p.H) * p.W), p.H, p.W, p.Cin, p.Cout, bf16);
  // x as (Cin, N H W): a box is raw_pix consecutive pixels x 32 channels
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {static_cast<uint64_t>(p.Cin), static_cast<uint64_t>(p.M)};
  const uint64_t xstrides[1] = {static_cast<uint64_t>(p.Cin) * sizeof(Tin)};
  const uint32_t xbox[2] = {kQC, static_cast<uint32_t>(g.raw_pix)};
  int rc = encode_map(&xmap,
                      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                      p.x, 2, xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  // w as (16 channels, Cout, Cin / 16, 9 taps): a box is one chunk's two
  // 16-channel slices of the 9 taps for 64 cw output channels, laid out
  // [tap][slice][channel][16 bytes] (rows past Cout zero-filled)
  const uint64_t wdims[4] = {16, static_cast<uint64_t>(p.Cout), static_cast<uint64_t>(p.Cin / 16),
                             9};
  const uint64_t wstrides[3] = {9ull * p.Cin, 16, static_cast<uint64_t>(p.Cin)};
  const uint32_t wbox[4] = {16, static_cast<uint32_t>(64 * g.cw), 2, 9};
  rc = encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.w, 4, wdims, wstrides, wbox,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  auto kernel = int8_conv_wgmma_kernel<Tin, kOutBf16, kDynamic>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(g.grid_x, g.n_co), kWgThreads, g.smem, stream>>>(xmap, wmap, p.a, p.ks, p.bias,
                                                                  p.y, g);
  return static_cast<int>(cudaGetLastError());
}

// The kernel a shape takes: 2 the im2col kernel (Cin <= 3), 1 the wgmma
// kernel (Cin % 32 == 0), 0 the mma.sync kernel (the rest, and shapes
// whose window does not fit the shared memory).
int kernel_path(int n, int h, int wd, int cin, int cout, int x_bf16) {
  // pixel coordinates of the 2D map, items and positions in int32
  if (static_cast<long long>(n) * h * wd > 2147483647LL - 256) return 0;
  if (static_cast<long long>(h + 4) * (wd + 2) + 2048 > 2147483647LL) return 0;
  if (cin <= 3) return wgeo_im2col(n, h, wd, cin, cout).smem <= kSmemCap ? 2 : 0;
  if (cin % kQC != 0) return 0;
  return wgeo(n, h, wd, cin, cout, x_bf16).smem <= kSmemCap ? 1 : 0;
}

template <typename Tin, typename Tout, bool kDynamic>
int launch_typed(const Params& p, cudaStream_t stream) {
  const long long n = p.M / (static_cast<long long>(p.H) * p.W);
  switch (kernel_path(static_cast<int>(n), p.H, p.W, p.Cin, p.Cout, sizeof(Tin) == 2)) {
    case 2:
      return launch_im2col<Tin, sizeof(Tout) == 2, kDynamic>(p, stream);
    case 1:
      return launch_wgmma<Tin, sizeof(Tout) == 2, kDynamic>(p, stream);
    default:
      return launch_mma_sync<Tin, Tout, kDynamic>(p, stream);
  }
}

}  // namespace

extern "C" {

// Which kernel a launch at this shape runs: 2 the im2col kernel, 1 the
// wgmma kernel, 0 the mma.sync kernel.
int int8_conv_path(int n, int h, int wd, int cin, int cout, int x_bf16) {
  return kernel_path(n, h, wd, cin, cout, x_bf16);
}

// x: (N, H, W, Cin) bf16 (x_bf16 = 1) or float32, contiguous, 16-byte
// aligned. w: (Cout, 3, 3, Cin) int8, contiguous, 16-byte aligned. a: one
// float32; ks, bias: float32 (Cout,) (bias unused when dynamic). y: (N, H,
// W, Cout), bf16 (y_bf16 = 1) or float32; dynamic = 1 takes float32 only.
// Cout % 8 == 0. Returns the cudaError_t of the launch, or a tensor-map
// code (int8_conv_error_string).
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

const char* int8_conv_error_string(int code) { return launch_error_string(code); }

}  // extern "C"
