// The Mosaic-bisection kernels of the transposed (H, C, W, N) CBR, for
// Hopper (sm_90a): crops, shifted sums and stacked dots over the N-minor
// rows, one launcher per script.
//
// Replaces the Pallas TPU kernels
//   scripts/bisect_transposed.py  v1 :29 (pallas_call :36), v2 :50 (:56),
//     v3 :69 (:79), v4 :95 (:105), v5 :117 (:125)        -> bisect_k7_launch
//   scripts/bisect_transposed2.py::make :15 (:22), bodies a-e :45-72
//                                                        -> bisect_k8_launch
//   scripts/bisect_transposed3.py::build :82 (:87), body _kernel :18-79
//                                                        -> bisect_k9_launch
//
// xp is the scripts' padded input as (Hs, C, Ws, N) bf16 (Hs = H + 2; Ws =
// W + 2, or W + 8 for K7 v5); every output is (H, Cout, W, N) bf16:
//   crop        out[h,c,w,n] = xp[h+1, c, w+1, n]                 K7 v1 v2 v5
//   shifted sum out[h,c,w,n] = sum over the (dy, dx) of the variant of
//               xp[h+dy, c, w+dx, n], in float32 (K7 v4: dy 1, dx 0..2;
//               K8 a: dy 0..2, dx 1), or rounded to bf16 after each add
//               (K8 b, whose body adds bf16 values)
//   dot         out[h,co,w,n] = sum over dx of (sum over dy, ci of
//               Wm[co, (dy - dy0) * C + ci] * src[h+dy, ci, w+dx, n]), float32
//               (K7 v3, K8 c e: dy 0..2, dx 1; K8 d: dy 1, dx 1; K9: dy 0..2
//               with merge_dot, else dy 1; dx 0..2 with shift, else dx 0)
// where src is xp, or for K9 with its scratch: bf16(relu(xp * 1.1 + 0.1))
// with the prologue, and row 0 and column 0 of the padded input zeroed with
// zero_ring (the TPU kernel zeroes the block's top row only in the first
// row block and its left column only in the first column block). K9's
// stats are the float32 sum of the rounded y per channel over (h, w, n):
// per-CTA partials, then k9_stats_kernel in a fixed order.
//
// Bound: every one of them moves bytes, not operations. At the scripts'
// size (H 16, W 32, C 64, N 128) a crop moves 16.8 MB (5.01 us at 3.35
// TB/s), a three-tap sum 17.3-17.8 MB (5.2-5.3 us), the stacked dot 17.85
// MB (5.33 us) for 1.61 GFLOP (1.63 us at 989 TFLOP/s); K9's widest case
// (merge_dot and shift: nine taps) does 4.83 GFLOP (4.89 us) for 17.8 MB.
//
// K7 and K8, one design each:
// - rows_kernel (crops, sums): an output row y[h, c, :, :] is W*N contiguous
//   elements and each tap of it the equally contiguous span
//   xp[h+dy, c, dx*N : dx*N + W*N], so a block takes a chunk of one row and
//   its threads copy or add 16-byte vectors, neighbouring threads on
//   neighbouring vectors, with 32-bit indices inside the row: no division
//   per element. A sum loads every tap's vector first, then adds in the
//   plain version's order (dy outer, dx inner; K8 b rounds after each add)
//   and rounds once, so its y equals the plain version's bit for bit; a
//   crop copies the bits. N % 8 != 0 or a misaligned pointer takes the
//   element path of the same kernel.
// - the dots: per output row h, Y_h (C x W*N) = Wm[:, :K] (C x K) . X_h
//   (K x W*N), K = ndy * C, with X_h[k, p] = xp[h + dy0 + k / C, k % C,
//   dx*N + p]: the stacked index k has the one stride Ws*N, so neighbouring
//   rows h share ndy - 1 of their input rows. A tile is 64 output channels
//   x 128 columns p, its products on the tensor cores with float32 sums,
//   its epilogue rounded to bf16 in shared memory and stored as 16-byte
//   vectors along p. The copies are 16-byte cp.async (zero-filled past C,
//   K and W*N); N % 8 != 0 or a misaligned pointer copies element by
//   element in the same kernel.
//   window_dot_kernel (C <= 128 at ndy = 3): one warpgroup takes one tile
//   of two output rows h, h + 1 and runs wgmma m64n128k16 with both
//   operands in shared memory (Wm K-major, the rows N-major, B transposed),
//   each input row copied once for both outputs and the products of a row
//   issued as soon as it lands. wgmma, not mma.sync: on an H100, mma.sync
//   from eight warps (ldmatrix .trans) ran these products slower than one
//   torch.bmm of the same function, window or not (PERF.md).
//   tile_dot_kernel (wider C, whose window would not fit shared memory):
//   one tile of one row h, K in chunks of 64 through three cp.async
//   stages, eight warps of 32x32 running mma.sync m16n8k16 on ldmatrix
//   fragments.
// K9 (k9_dot_kernel) is the window's dot with its four extras, on wgmma at
// every C: a tile is 64 output channels by two output columns of 64 samples
// over two output rows, one consumer warpgroup a row, and the samples are
// the fastest 64 of a staged column block, so consecutive blocks are
// consecutive columns and a view of several is one wgmma operand. The dx
// shift is the same dot read one block further on: T = Wm . X runs once
// over the two columns and their halo (m64n256k16) and the three shifted
// slices are added in float32 in the epilogue, in the plain version's
// order, inside each thread's registers. The input rows come in channel
// chunks of 64 through a ring of up to four cp.async stages, so the
// 768-term dots of C = 256 run as the 192-term ones do; the prologue and the zero
// ring are applied to each stage once, in shared memory, beside the
// products of the stage before; the epilogue rounds once, stores 16-byte
// vectors and sums each channel's rounded values from the registers (a
// butterfly over a row's four lanes), one row of per-CTA sums that
// k9_stats_kernel adds in a fixed order into the stats output (without
// stats the dot kernel zeroes it). N % 8 != 0 or a misaligned pointer takes
// the element path of the same kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Geo {
  int hs, c, ws, n;  // input (Hs, C, Ws, N)
  int h, w;          // output rows and columns
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether a kernel takes its 16-byte path: N % 8 == 0 makes every row and
// tap span (and every 8 samples of K9's column blocks) a whole number of
// vectors; the pointers (w unless null) must be 16-byte aligned. Else the
// element path of the same kernel.
bool vector_path(const void* x, const void* w, int n, const void* y) {
  return n % 8 == 0 && aligned16(x) && (w == nullptr || aligned16(w)) && aligned16(y);
}

// --- K7/K8 crops and shifted sums ----------------------------------------------------

constexpr int kRowVecs = 2;                         // 16-byte vectors a thread
constexpr int kRowChunk = kThreads * kRowVecs * 8;  // elements of a row a block

struct RowTaps {
  int64_t off[3];  // each tap's span, from xp[h, c, 0, 0], in the plain version's order
};

// The taps of 8 elements summed in float32 in order (or rounded to bf16 after
// each add), rounded once; one tap is copied as it is.
template <int kTaps, bool kBf16Adds>
__device__ __forceinline__ uint4 tap_sum8(const uint4 (&v)[kTaps]) {
  if constexpr (kTaps == 1) {
    return v[0];
  } else {
    float acc[8];
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[t]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        if (t == 0) {
          acc[2 * j] = f.x;
          acc[2 * j + 1] = f.y;
        } else {
          acc[2 * j] = acc[2 * j] + f.x;
          acc[2 * j + 1] = acc[2 * j + 1] + f.y;
          if (kBf16Adds) {
            acc[2 * j] = __bfloat162float(__float2bfloat16_rn(acc[2 * j]));
            acc[2 * j + 1] = __bfloat162float(__float2bfloat16_rn(acc[2 * j + 1]));
          }
        }
      }
    }
    uint4 out;
    __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
    return out;
  }
}

// tap_sum8 for one element at i of each tap's span.
template <int kTaps, bool kBf16Adds>
__device__ __forceinline__ __nv_bfloat16 tap_sum1(const __nv_bfloat16* const (&s)[kTaps], int i) {
  if constexpr (kTaps == 1) {
    return s[0][i];
  } else {
    float acc = __bfloat162float(s[0][i]);
#pragma unroll
    for (int t = 1; t < kTaps; ++t) {
      acc = acc + __bfloat162float(s[t][i]);
      if (kBf16Adds) acc = __bfloat162float(__float2bfloat16_rn(acc));
    }
    return __float2bfloat16_rn(acc);
  }
}

// One block: kRowChunk elements of the output row blockIdx.x / chunks, which
// is row (h, c) of y; xp's row (h, c) has the same index. in_row = Ws * N,
// row_len = W * N.
template <int kTaps, bool kBf16Adds>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const __nv_bfloat16* __restrict__ x, int64_t in_row, RowTaps taps, int row_len,
            int chunks, int vec, __nv_bfloat16* __restrict__ y) {
  const int row = blockIdx.x / chunks;
  const int begin = (blockIdx.x - row * chunks) * kRowChunk;
  const int len = min(kRowChunk, row_len - begin);
  const __nv_bfloat16* base = x + row * in_row + begin;
  const __nv_bfloat16* src[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) src[t] = base + taps.off[t];
  __nv_bfloat16* dst = y + static_cast<int64_t>(row) * row_len + begin;
  if (vec) {
    const int nv = len >> 3;
    uint4 v[kRowVecs][kTaps];
#pragma unroll
    for (int j = 0; j < kRowVecs; ++j) {
      const int i = j * kThreads + threadIdx.x;
      if (i < nv) {
#pragma unroll
        for (int t = 0; t < kTaps; ++t) v[j][t] = __ldg(reinterpret_cast<const uint4*>(src[t]) + i);
      }
    }
#pragma unroll
    for (int j = 0; j < kRowVecs; ++j) {
      const int i = j * kThreads + threadIdx.x;
      if (i < nv) reinterpret_cast<uint4*>(dst)[i] = tap_sum8<kTaps, kBf16Adds>(v[j]);
    }
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads) dst[i] = tap_sum1<kTaps, kBf16Adds>(src, i);
  }
}

int64_t row_chunks(const Geo& g) {
  return (static_cast<int64_t>(g.w) * g.n + kRowChunk - 1) / kRowChunk;
}

// The taps (dy0..dy0+ndy-1) x (dx0..dx0+ndx-1), 1 or 3 of them, dy outer.
int launch_rows(bool bf16_adds, const void* x, const Geo& g, int dy0, int ndy, int dx0, int ndx,
                void* y, cudaStream_t s) {
  const int64_t in_row = static_cast<int64_t>(g.ws) * g.n;
  RowTaps taps{};
  int n_taps = 0;
  for (int dy = dy0; dy < dy0 + ndy; ++dy)
    for (int dx = dx0; dx < dx0 + ndx; ++dx)
      taps.off[n_taps++] = dy * g.c * in_row + static_cast<int64_t>(dx) * g.n;
  const int chunks = static_cast<int>(row_chunks(g));
  const unsigned blocks = static_cast<unsigned>(static_cast<int64_t>(g.h) * g.c * chunks);
  const int vec = vector_path(x, nullptr, g.n, y);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  const int len = g.w * g.n;
  if (n_taps == 1)
    rows_kernel<1, false><<<blocks, kThreads, 0, s>>>(xp, in_row, taps, len, chunks, vec, yp);
  else if (n_taps == 3 && bf16_adds)
    rows_kernel<3, true><<<blocks, kThreads, 0, s>>>(xp, in_row, taps, len, chunks, vec, yp);
  else if (n_taps == 3)
    rows_kernel<3, false><<<blocks, kThreads, 0, s>>>(xp, in_row, taps, len, chunks, vec, yp);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// --- K7/K8 stacked dots: mma.sync on the tensor cores ---------------------------------

constexpr int kBM = 64;   // output channels a tile
constexpr int kBN = 128;  // columns p a tile
constexpr int kBK = 64;   // stacked index k (or channels) a chunk
constexpr int kALd = kBK + 8;  // padded rows: ldmatrix's 8 row addresses hit 8 bank groups
constexpr int kBLd = kBN + 8;
constexpr int kAStage = kBM * kALd;  // elements of a 64x64 chunk of Wm
constexpr int kBStage = kBK * kBLd;  // elements of a 64x128 chunk of X_h
constexpr int kMaxSmem = 232448;     // a block's shared memory on the card
static_assert(kBM * kBLd <= kBStage, "the epilogue tile fits a chunk of X_h");
static_assert(kThreads == 256, "eight warps of 32x32");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(fill ? 16 : 0)
               : "memory");  // 0 bytes read: the 16 are zero-filled
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp_async_wait for a count known at run time (at most 4 pending is exact,
// more waits for all).
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// d += a (16x16, row-major) . b (16x8), bf16 products, float32 sums.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void zero_acc(float (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

// acc (this warp's 32x32 of the 64x128 tile) += as (64x64 of Wm, row stride
// kALd) . bs (64x128 of X_h, row stride kBLd), k in 4 steps of 16.
__device__ __forceinline__ void mma_chunk(float (&acc)[2][4][4], const __nv_bfloat16* as,
                                          const __nv_bfloat16* bs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp & 1) * 32, wn0 = (warp >> 1) * 32;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldmatrix_x4(a[i], as + (wm0 + i * 16 + (lane & 15)) * kALd + kk + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, bs + (kk + (lane & 15)) * kBLd + wn0 + j * 16 + (lane >> 4) * 8);
      b[2 * j][0] = r[0];
      b[2 * j][1] = r[1];
      b[2 * j + 1][0] = r[2];
      b[2 * j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_16816(acc[i][j], a[i], b[j][0], b[j][1]);
  }
}

// The shapes of a dot: Y_h (c x p) = Wm[:, :K] . X_h, K = ndy * c, X_h's
// row k at xp + h * x_h + x_off + k * x_k (x_off = dy0 * x_h + dx * N).
struct DotGeo {
  int64_t x_k;   // Ws * N
  int64_t x_h;   // C * Ws * N
  int64_t x_off;
  int c, p, wld, ndy, h;
  int ncb;     // channel chunks of kBK: ceil(C / 64)
  int ptiles;  // column tiles of a row h
  int mtiles;  // channel tiles
  int vec;     // 16-byte copies (N % 8 == 0, aligned pointers)
};

// rows x cols of bf16 from src (row stride ld, rows < n_rows and cols <
// n_cols read, the rest zero) to dst (row stride dst_ld). cols and the
// column bound are whole 16-byte vectors on the vector path.
template <int kRows, int kCols>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, int dst_ld, const __nv_bfloat16* src,
                                      int64_t ld, int n_rows, int n_cols, int vec) {
  constexpr int kVecs = kCols / 8;
  const int tid = threadIdx.x;
  if (vec) {
    const int q = (tid % kVecs) * 8;
    const bool col_in = q < n_cols;
#pragma unroll
    for (int j = 0; j < kRows * kVecs / kThreads; ++j) {
      const int r = tid / kVecs + j * (kThreads / kVecs);
      const bool in = col_in && r < n_rows;
      cp_async16(dst + r * dst_ld + q, in ? src + r * ld + q : src, in);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    for (int i = tid; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, q = i % kCols;
      dst[r * dst_ld + q] = r < n_rows && q < n_cols ? src[r * ld + q] : zero;
    }
  }
}

// The rounded tile (h, p0, m0) through shared memory cs, then whole rows of
// 16-byte vectors out to y.
__device__ __forceinline__ void store_tile(const float (&acc)[2][4][4], const DotGeo& g, int h,
                                           int p0, int m0, __nv_bfloat16* cs,
                                           __nv_bfloat16* __restrict__ y) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp & 1) * 32, wn0 = (warp >> 1) * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm0 + i * 16 + (lane >> 2), q = wn0 + j * 8 + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(cs + r * kBLd + q) =
          __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<__nv_bfloat162*>(cs + (r + 8) * kBLd + q) =
          __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  __nv_bfloat16* yb = y + (static_cast<int64_t>(h) * g.c + m0) * g.p + p0;
  const int n_rows = min(kBM, g.c - m0), n_cols = min(kBN, g.p - p0);
  if (g.vec) {
    const int q = (tid % (kBN / 8)) * 8;
    if (q < n_cols) {
#pragma unroll
      for (int j = 0; j < kBM * kBN / 8 / kThreads; ++j) {
        const int r = tid / (kBN / 8) + j * (kThreads / (kBN / 8));
        if (r < n_rows)
          *reinterpret_cast<uint4*>(yb + static_cast<int64_t>(r) * g.p + q) =
              *reinterpret_cast<const uint4*>(cs + r * kBLd + q);
      }
    }
  } else {
    for (int i = tid; i < kBM * kBN; i += kThreads) {
      const int r = i / kBN, q = i % kBN;
      if (r < n_rows && q < n_cols) yb[static_cast<int64_t>(r) * g.p + q] = cs[r * kBLd + q];
    }
  }
}

// The window design, on wgmma: a CTA (one warpgroup) takes the tile (m0, p0)
// of the output rows h0 and h0 + 1 (kWinRows). It copies Wm[m0:m0+64, :K]
// as ndy * ncb chunks (dy, channel chunk) of 64x64, K-major, and the ndy + 1
// input rows h0+dy0 .. h0+dy0+ndy that its two outputs read, once each, as
// ncb chunks of 64 channels x 128 columns, N-major: one cp.async group a
// row, Wm's dy chunks with row dy. Input row r is output 0's tap r and
// output 1's tap r - 1, so each row's products for both outputs are issued
// as soon as it has landed, into two sets of accumulators, and output 0 is
// rounded and stored (through row 0's first chunk, which output 1 does not
// read) while output 1's last products run. Both layouts are wgmma's
// 128-byte swizzle: a 128-byte row of a chunk holds its 16-byte pieces in
// the order piece ^ (row % 8).
constexpr int kWgThreads = 128;
constexpr int kWinRows = 2;     // output rows a CTA: two sets of accumulators
constexpr int kWgA = kBM * kBK;  // elements of a chunk of Wm (8 KB)
constexpr int kWgB = kBK * kBN;  // elements of a chunk of a row (16 KB)
static_assert(kBM * kBN <= kWgB, "the epilogue tile fits a chunk of a row");
// wgmma's shared-memory descriptors, 128-byte swizzle, in bytes: Wm's chunk
// (K-major) has its 8-row groups 1024 apart (the leading offset is unused);
// a row's chunk (N-major) its 8-channel groups 1024 apart and its two
// 64-column blocks kBK * 128 apart.
constexpr int kALbo = 16, kASbo = 1024, kBLbo = kBK * 128, kBSbo = 1024;

int window_smem(int ndy, int ncb) {
  return (ndy * ncb * kWgA + (kWinRows + ndy - 1) * ncb * kWgB) * 2 + 1024;  // + alignment
}

// A chunk of Wm: rows (output channels) < n_rows and k < n_cols of src (row
// stride ld), K-major, 128-byte swizzle; the rest zero. tid: the thread's
// index in the warpgroup that copies it.
__device__ __forceinline__ void stage_wg_a(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int64_t ld, int n_rows, int n_cols, int vec,
                                           int tid) {
  if (vec) {
#pragma unroll
    for (int j = 0; j < kBM * kBK / 8 / kWgThreads; ++j) {
      const int i = tid + j * kWgThreads, r = i >> 3, c = i & 7;
      const bool in = r < n_rows && c * 8 < n_cols;
      cp_async16(dst + r * kBK + ((c ^ (r & 7)) << 3), in ? src + r * ld + c * 8 : src, in);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    for (int i = tid; i < kBM * kBK; i += kWgThreads) {
      const int r = i / kBK, k = i % kBK;
      dst[r * kBK + (((k >> 3) ^ (r & 7)) << 3) + (k & 7)] =
          r < n_rows && k < n_cols ? src[r * ld + k] : zero;
    }
  }
}

// A chunk of an input row: channels < n_rows and columns < n_cols of src
// (channel stride ld), N-major in two 64-column blocks, 128-byte swizzle.
__device__ __forceinline__ void stage_wg_b(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int64_t ld, int n_rows, int n_cols, int vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int j = 0; j < kBK * kBN / 8 / kWgThreads; ++j) {
      const int i = tid + j * kWgThreads, r = i >> 4, c = i & 15;
      const bool in = r < n_rows && c * 8 < n_cols;
      cp_async16(dst + (c >> 3) * (kBK * 64) + r * 64 + (((c & 7) ^ (r & 7)) << 3),
                 in ? src + r * ld + c * 8 : src, in);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    for (int i = tid; i < kBK * kBN; i += kWgThreads) {
      const int r = i / kBN, n = i % kBN;
      dst[(n >> 6) * (kBK * 64) + r * 64 + ((((n >> 3) & 7) ^ (r & 7)) << 3) + (n & 7)] =
          r < n_rows && n < n_cols ? src[r * ld + n] : zero;
    }
  }
}

// A 64x128 float32 tile of wgmma's accumulators (this thread's 64) rounded
// to bf16 into cs (16-byte pieces swizzled by row), then whole rows of
// 16-byte vectors out to y's row h.
__device__ __forceinline__ void store_wg_tile(const float (&acc)[64], const DotGeo& g, int h,
                                              int p0, int m0, __nv_bfloat16* cs,
                                              __nv_bfloat16* __restrict__ y) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + (lane >> 2) + half * 8;
      const int piece = (j & 8) | ((j ^ r) & 7);
      *reinterpret_cast<__nv_bfloat162*>(cs + r * kBN + piece * 8 + (lane & 3) * 2) =
          __floats2bfloat162_rn(acc[j * 4 + half * 2], acc[j * 4 + half * 2 + 1]);
    }
  __syncthreads();
  __nv_bfloat16* yb = y + (static_cast<int64_t>(h) * g.c + m0) * g.p + p0;
  const int n_rows = min(kBM, g.c - m0), n_cols = min(kBN, g.p - p0);
  if (g.vec) {
#pragma unroll
    for (int j = 0; j < kBM * kBN / 8 / kWgThreads; ++j) {
      const int e = tid + j * kWgThreads, r = e >> 4, c = e & 15;
      if (r < n_rows && c * 8 < n_cols)
        *reinterpret_cast<uint4*>(yb + static_cast<int64_t>(r) * g.p + c * 8) =
            *reinterpret_cast<const uint4*>(cs + r * kBN + (((c & 8) | ((c ^ r) & 7)) << 3));
    }
  } else {
    for (int e = tid; e < kBM * kBN; e += kWgThreads) {
      const int r = e / kBN, n = e % kBN, c = n >> 3;
      if (r < n_rows && n < n_cols)
        yb[static_cast<int64_t>(r) * g.p + n] =
            cs[r * kBN + (((c & 8) | ((c ^ r) & 7)) << 3) + (n & 7)];
    }
  }
}

__global__ void __launch_bounds__(kWgThreads)
window_dot_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wm,
                  DotGeo g, __nv_bfloat16* __restrict__ y) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the chunks to it
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  __nv_bfloat16* as =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + (((base + 1023) & ~1023u) - base));
  __nv_bfloat16* rs = as + g.ndy * g.ncb * kWgA;  // the input rows' chunks
  const int t = blockIdx.x / g.mtiles;
  const int m0 = (blockIdx.x - t * g.mtiles) * kBM;
  const int run = t / g.ptiles;
  const int p0 = (t - run * g.ptiles) * kBN;
  const int h0 = run * kWinRows;
  const int hr = min(kWinRows, g.h - h0);
  const int rows = hr + g.ndy - 1;
  const __nv_bfloat16* xb = x + h0 * g.x_h + g.x_off + p0;  // input row 0 at column p0

  for (int ir = 0; ir < rows; ++ir) {
    for (int cb = 0; cb < g.ncb; ++cb) {
      if (ir < g.ndy)
        stage_wg_a(as + (ir * g.ncb + cb) * kWgA,
                   wm + static_cast<int64_t>(m0) * g.wld + ir * g.c + cb * kBK, g.wld, g.c - m0,
                   g.c - cb * kBK, g.vec, threadIdx.x);
      stage_wg_b(rs + (ir * g.ncb + cb) * kWgB, xb + ir * g.x_h + cb * kBK * g.x_k, g.x_k,
                 g.c - cb * kBK, g.p - p0, g.vec);
    }
    cp_async_commit();  // group ir
  }

  // input row r is output 0's tap r and output 1's tap r - 1: each row's
  // products for both outputs go in as soon as it has landed, one wgmma
  // group a row, and output 0 goes out while output 1's last row runs
  float acc0[64], acc1[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc0[e] = acc1[e] = 0.0f;
  const bool two = hr == kWinRows;
  wg_fence();
  for (int r = 0; r < rows; ++r) {
    cp_async_wait_pending(rows - 1 - r);  // row r has landed
    fence_async_shared();
    __syncthreads();
    for (int cb = 0; cb < g.ncb; ++cb) {
      const __nv_bfloat16* b = rs + (r * g.ncb + cb) * kWgB;
      if (r < g.ndy) {
        const __nv_bfloat16* a = as + (r * g.ncb + cb) * kWgA;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16)
          wgmma_64x128x16<0>(acc0, wg_desc(a + kk, kALbo, kASbo),
                          wg_desc(b + kk * 64, kBLbo, kBSbo), r + cb + kk > 0);
      }
      if (two && r >= 1) {
        const __nv_bfloat16* a = as + ((r - 1) * g.ncb + cb) * kWgA;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16)
          wgmma_64x128x16<0>(acc1, wg_desc(a + kk, kALbo, kASbo),
                          wg_desc(b + kk * 64, kBLbo, kBSbo), r - 1 + cb + kk > 0);
      }
    }
    wg_commit();
  }
  // output 0's products are in every group but the last (output 1's last row)
  if (two)
    wg_wait<1>();
  else
    wg_wait<0>();
  __syncthreads();
  store_wg_tile(acc0, g, h0, p0, m0, rs, y);  // through row 0, which output 1 does not read
  if (two) {
    wg_wait<0>();
    __syncthreads();
    store_wg_tile(acc1, g, h0 + 1, p0, m0, rs + g.ncb * kWgB, y);
  }
}

// The tile design, for C too wide for the window's shared memory: a CTA
// takes one tile (h, p0, m0) and its K in chunks of 64, kStages in flight,
// each a 64x64 chunk of Wm and a 64x128 chunk of X_h.
constexpr int kStages = 3;
constexpr int kTileStage = kAStage + kBStage;
constexpr int kTileSmem = kStages * kTileStage * 2;  // 79,872 bytes

__global__ void __launch_bounds__(kThreads, 2)
tile_dot_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wm,
                DotGeo g, __nv_bfloat16* __restrict__ y) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int h = blockIdx.x / g.ptiles;
  const int p0 = (blockIdx.x - h * g.ptiles) * kBN;
  const int m0 = blockIdx.y * kBM;
  const __nv_bfloat16* xb = x + h * g.x_h + g.x_off + p0;
  const int k = g.ndy * g.c;
  const int nk = (k + kBK - 1) / kBK;
  auto load = [&](int kc) {
    __nv_bfloat16* st = sm + kc % kStages * kTileStage;
    stage<kBM, kBK>(st, kALd, wm + static_cast<int64_t>(m0) * g.wld + kc * kBK, g.wld,
                    g.c - m0, k - kc * kBK, g.vec);
    stage<kBK, kBN>(st + kAStage, kBLd, xb + kc * kBK * g.x_k, g.x_k, k - kc * kBK, g.p - p0,
                    g.vec);
    cp_async_commit();
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load(s);
    else
      cp_async_commit();
  }
  float acc[2][4][4];
  zero_acc(acc);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();  // chunk kc has landed
    __syncthreads();               // and every thread is done with chunk kc - 1's stage
    if (kc + kStages - 1 < nk)
      load(kc + kStages - 1);
    else
      cp_async_commit();
    const __nv_bfloat16* st = sm + kc % kStages * kTileStage;
    mma_chunk(acc, st, st + kAStage);
  }
  cp_async_wait<0>();
  __syncthreads();
  store_tile(acc, g, h, p0, m0, sm, y);
}

int64_t dot_ptiles(const Geo& g) { return (static_cast<int64_t>(g.w) * g.n + kBN - 1) / kBN; }

// Y_h = Wm[:, :ndy*C] . the rows xp[h+dy0 .. h+dy0+ndy-1] stacked, at column
// dx: the window design where its shared memory fits, else the tile design.
int launch_mma_dot(const void* x, const void* w, const Geo& g, int dy0, int ndy, int dx, void* y,
                   cudaStream_t s) {
  DotGeo d;
  d.x_k = static_cast<int64_t>(g.ws) * g.n;
  d.x_h = g.c * d.x_k;
  d.x_off = dy0 * d.x_h + static_cast<int64_t>(dx) * g.n;
  d.c = g.c;
  d.p = g.w * g.n;
  d.wld = 3 * g.c;
  d.ndy = ndy;
  d.h = g.h;
  d.ncb = (g.c + kBK - 1) / kBK;
  d.ptiles = static_cast<int>(dot_ptiles(g));
  d.mtiles = (g.c + kBM - 1) / kBM;
  d.vec = vector_path(x, w, g.n, y);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  const int smem = window_smem(ndy, d.ncb);
  if (smem <= kMaxSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(window_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int runs = (g.h + kWinRows - 1) / kWinRows;
    window_dot_kernel<<<d.mtiles * d.ptiles * runs, kWgThreads, smem, s>>>(xp, wp, d, yp);
  } else {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tile_dot_kernel<<<dim3(g.h * d.ptiles, d.mtiles), kThreads, kTileSmem, s>>>(xp, wp, d, yp);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7/K8's limits: 32-bit indices inside a row and in the grids.
bool bad_k78_geo(int hs, int c, int ws, int n, int margin) {
  if (hs < 3 || ws <= margin || n < 1 || c < 8 || c % 8 != 0 || (c + kBM - 1) / kBM > 65535)
    return true;
  const Geo g{hs, c, ws, n, hs - 2, ws - margin};
  const int64_t kMax = 2147483647LL;
  return static_cast<int64_t>(g.w) * g.n > kMax - kRowChunk - kBN ||
         static_cast<int64_t>(g.h) * g.c * row_chunks(g) > kMax ||
         static_cast<int64_t>(g.h) * dot_ptiles(g) * ((c + kBM - 1) / kBM) > kMax;
}

// d (64x256, float32) (+)= A (64x16) . B (16x256, N-major), bf16 operands in shared
// memory, A K-major: K9's span of four column blocks.
__device__ __forceinline__ void wgmma_64x256x16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// --- K9: the dot with prologue, zero ring, dx shift and stats, on wgmma --------------

// A CTA takes 64 output channels (m0) by two output columns w0, w0 + 1 of 64
// samples nb*64.. (128 columns p of y) over the output rows h0 and h0 + 1,
// one consumer warpgroup a row. The samples are the fastest 64 of a staged
// column: a block holds one input column's 64 samples of 64 channels,
// [ci][n] N-major with the 128-byte swizzle (8 KB), and consecutive blocks
// are consecutive columns, so a view of kSpan blocks is one wgmma B
// operand. A stage is one input row's channel chunk: its kSpan column
// blocks (w0 .. w0 + kSpan - 1) and the two chunks of Wm its outputs read
// there (K-major, as the window kernel's): input row i is output 0's tap i
// and output 1's tap i - 1. Where C <= 64 the CTA's taps of Wm (one chunk
// each) are copied once instead, beside the ring, and a stage is its
// column blocks alone. Without the shift kSpan is 2 and the products
// are m64n128k16. With it, T = Wm . X runs once over the four blocks the
// two output columns and their dx halo span (m64n256k16), and each output
// column block b is (T[b] + T[b + 1]) + T[b + 2] in float32, the plain
// version's order over dx: column c + 64 of T sits in the same thread 32
// registers on, so the shifted add needs no data movement, and it does
// two thirds of the three-pass products. Stages come by 16-byte cp.async
// (zero-filled past C, N, Ws) through a ring of up to four stages, so that
// the four input rows of a three-tap tile are in flight at once where they
// fit; the prologue and the zero ring are applied to each stage once, in
// shared memory, while the previous stage's products run.
constexpr int kK9Threads = 2 * kWgThreads;  // a consumer warpgroup per output row
constexpr int kBlkN = 64;                   // samples of a column block
constexpr int kBlkElems = kBK * kBlkN;      // a block: 64 channels x 64 samples (8 KB)

struct K9Geo {
  int hs, c, ws, n;  // input (Hs, C, Ws, N)
  int h, w;          // output rows and columns
  int dy0, ndy;
  int span;          // column blocks of a stage: 2, or 4 with the shift
  int ncb;           // channel chunks of 64
  int mtiles, nbs, ptiles, runs;  // tiles: channels, sample blocks, (column pairs x nbs), row pairs
  int a_res;         // C <= 64: Wm's ndy chunks resident, not in the stages
  int stage_elems;   // span blocks, + 2 of Wm unless a_res
  int ring;          // stages in flight: 3 or 4
  int stats_numel;   // elements of the stats output
  int prologue, zero_ring, stats, vec;
};

__device__ __forceinline__ void k9_mma(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_64x128x16<0>(d, da, db, 1);
}
__device__ __forceinline__ void k9_mma(float (&d)[128], uint64_t da, uint64_t db) {
  wgmma_64x256x16(d, da, db);
}

// Stage gi = (input row i, channel chunk cb) of the CTA's tile into st: the
// column blocks by every thread, warpgroup o's chunk of Wm (unless they are
// resident) by warpgroup o.
__device__ __forceinline__ void k9_stage(const K9Geo& g, const __nv_bfloat16* __restrict__ x,
                                         const __nv_bfloat16* __restrict__ wm, int h0, int w0,
                                         int nb, int m0, bool two, int gi,
                                         __nv_bfloat16* st) {
  const int tid = threadIdx.x;
  const int i = gi / g.ncb, cb = gi - i * g.ncb;
  const int r = h0 + g.dy0 + i, c0 = cb * kBK, n0 = nb * kBlkN;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  if (g.vec) {
    for (int e = tid; e < g.span * (kBlkElems / 8); e += kK9Threads) {
      const int blk = e >> 9, ci = (e >> 3) & 63, pc = e & 7;
      const int col = w0 + blk, n = n0 + pc * 8;
      const bool in = r < g.hs && col < g.ws && c0 + ci < g.c && n < g.n;
      const __nv_bfloat16* src =
          x + ((static_cast<int64_t>(r) * g.c + c0 + ci) * g.ws + col) * g.n + n;
      cp_async16(st + blk * kBlkElems + ci * 64 + ((pc ^ (ci & 7)) << 3), in ? src : x, in);
    }
  } else {
    for (int e = tid; e < g.span * kBlkElems; e += kK9Threads) {
      const int blk = e >> 12, ci = (e >> 6) & 63, q = e & 63;
      const int col = w0 + blk, n = n0 + q;
      const bool in = r < g.hs && col < g.ws && c0 + ci < g.c && n < g.n;
      st[blk * kBlkElems + ci * 64 + (((q >> 3) ^ (ci & 7)) << 3) + (q & 7)] =
          in ? x[((static_cast<int64_t>(r) * g.c + c0 + ci) * g.ws + col) * g.n + n] : zero;
    }
  }
  const int o = tid / kWgThreads, t = i - o;
  if (g.a_res || (o == 1 && !two) || t < 0 || t >= g.ndy) return;
  stage_wg_a(st + (g.span + o) * kBlkElems,
             wm + static_cast<int64_t>(m0) * (3 * g.c) + t * g.c + c0, 3 * g.c, g.c - m0,
             g.c - c0, g.vec, tid % kWgThreads);
}

// This thread's accumulators of one output tile, its first 64 (two column
// blocks), rounded to bf16 into cs (64 x 128, 16-byte pieces swizzled by
// row, as store_wg_tile).
template <int kAcc>
__device__ __forceinline__ void k9_round(const float (&acc)[kAcc], __nv_bfloat16* cs) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + (lane >> 2) + half * 8;
      const int piece = (j & 8) | ((j ^ r) & 7);
      *reinterpret_cast<__nv_bfloat162*>(cs + r * kBN + piece * 8 + (lane & 3) * 2) =
          __floats2bfloat162_rn(acc[j * 4 + half * 2], acc[j * 4 + half * 2 + 1]);
    }
}

// This thread's share of the sums of its two rows (output channels) of the
// rounded tile over its valid columns, in order, then over the row's four
// lanes by a butterfly (the same bits in each): into red[r].
template <int kAcc>
__device__ __forceinline__ void k9_row_sums(const float (&acc)[kAcc], const K9Geo& g, int w0,
                                            int nb, float* red) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = j * 8 + (lane & 3) * 2 + e;
        const bool in = w0 + (q >> 6) < g.w && nb * kBlkN + (q & 63) < g.n;
        const float v = __bfloat162float(__float2bfloat16_rn(acc[j * 4 + half * 2 + e]));
        sum += in ? v : 0.0f;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if ((lane & 3) == 0) red[warp * 16 + (lane >> 2) + half * 8] = sum;
  }
}

// The rounded tile cs of output row h out to y (16-byte stores on the
// vector path) by the thread t of its warpgroup.
__device__ __forceinline__ void k9_store(const K9Geo& g, const __nv_bfloat16* cs, int h, int w0,
                                         int nb, int m0, int t, __nv_bfloat16* __restrict__ y) {
  const int n0 = nb * kBlkN;
  if (g.vec) {
#pragma unroll
    for (int j = 0; j < kBM * kBN / 8 / kWgThreads; ++j) {
      const int e = t + j * kWgThreads, r = e >> 4, c = e & 15;
      const int col = w0 + (c >> 3), n = n0 + (c & 7) * 8;
      if (m0 + r < g.c && col < g.w && n < g.n)
        *reinterpret_cast<uint4*>(
            y + ((static_cast<int64_t>(h) * g.c + m0 + r) * g.w + col) * g.n + n) =
            *reinterpret_cast<const uint4*>(cs + r * kBN + (((c & 8) | ((c ^ r) & 7)) << 3));
    }
  } else {
    for (int e = t; e < kBM * kBN; e += kWgThreads) {
      const int r = e >> 7, q = e & 127, c = q >> 3;
      const int col = w0 + (q >> 6), n = n0 + (q & 63);
      if (m0 + r < g.c && col < g.w && n < g.n)
        y[((static_cast<int64_t>(h) * g.c + m0 + r) * g.w + col) * g.n + n] =
            cs[r * kBN + (((c & 8) | ((c ^ r) & 7)) << 3) + (q & 7)];
    }
  }
}

// kSpan 2: no shift, T is the output (64 accumulators a thread), two CTAs
// an SM (at most 97 KB of shared memory and 128 registers each); 4: the
// shift, T over four column blocks (128 accumulators), one CTA an SM.
template <int kSpan>
__global__ void __launch_bounds__(kK9Threads, kSpan == 2 ? 2 : 1)
k9_dot_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wm,
              K9Geo g, __nv_bfloat16* __restrict__ y, float* __restrict__ partials,
              float* __restrict__ stats_out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float red[2][kBM];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + (((base + 1023) & ~1023u) - base));
  const int tid = threadIdx.x, wg = tid / kWgThreads;
  const int mt = blockIdx.x % g.mtiles;
  const int part = blockIdx.x / g.mtiles;  // this CTA's column of the stats' partials
  const int pt = part % g.ptiles, run = part / g.ptiles;
  // the sample blocks of a column pair are neighbouring CTAs
  const int m0 = mt * kBM, nb = pt % g.nbs, w0 = (pt / g.nbs) * 2, h0 = run * kWinRows;
  const bool two = h0 + 1 < g.h;
  const bool active = wg == 0 || two;  // this warpgroup has an output row
  const int n_stages = (two ? g.ndy + 1 : g.ndy) * g.ncb;
  if (!g.stats && blockIdx.x == 0)  // the stats output of a case without stats: zeros
    for (int e = tid; e < g.stats_numel; e += kK9Threads) stats_out[e] = 0.0f;

  // resident Wm: tap t by warpgroup t % 2, in the first copy group
  const __nv_bfloat16* a_res = ring + g.ring * g.stage_elems;
  if (g.a_res)
    for (int t = wg; t < g.ndy; t += 2)
      stage_wg_a(ring + g.ring * g.stage_elems + t * kBlkElems,
                 wm + static_cast<int64_t>(m0) * (3 * g.c) + t * g.c, 3 * g.c, g.c - m0, g.c,
                 g.vec, tid % kWgThreads);
  // the whole ring before the first product: stage s in copy group s; a
  // later stage s >= ring goes into the slot of stage s - ring once its
  // products are done, at iteration s - ring + 1, in copy group s + 1
  const int pre = min(g.ring, n_stages);
  for (int s = 0; s < pre; ++s) {
    k9_stage(g, x, wm, h0, w0, nb, m0, two, s, ring + s * g.stage_elems);
    cp_async_commit();
  }
  float acc[kSpan * 32];
#pragma unroll
  for (int e = 0; e < kSpan * 32; ++e) acc[e] = 0.0f;
  for (int gi = 0; gi < n_stages; ++gi) {
    __nv_bfloat16* st = ring + (gi % g.ring) * g.stage_elems;
    const int i = gi / g.ncb;
    cp_async_wait_pending(gi < pre ? pre - 1 : pre - 2);  // stage gi has landed
    __syncthreads();
    if (g.prologue || g.zero_ring) {
      // once a staged element: src = bf16(relu(xp * 1.1 + 0.1)), then row 0
      // and column 0 of the padded input zero
      const bool row0 = g.zero_ring && h0 + g.dy0 + i == 0;
      uint4* v = reinterpret_cast<uint4*>(st);
      for (int e = tid; e < kSpan * (kBlkElems / 8); e += kK9Threads) {
        if (row0 || (g.zero_ring && w0 + (e >> 9) == 0))
          v[e] = make_uint4(0u, 0u, 0u, 0u);
        else if (g.prologue)
          v[e] = prologue8_1ch(v[e], 1.1f, 0.1f);
      }
    }
    fence_async_shared();
    __syncthreads();
    const int tap = i - wg;
    if (active && tap >= 0 && tap < g.ndy) {
      const __nv_bfloat16* a = g.a_res ? a_res + tap * kBlkElems : st + (kSpan + wg) * kBlkElems;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16)
        k9_mma(acc, wg_desc(a + kk, kALbo, kASbo), wg_desc(st + kk * 64, kBlkElems * 2, kBSbo));
    }
    wg_commit();
    wg_wait<1>();  // stage gi - 1's products are done: its slot takes stage gi - 1 + ring
    __syncthreads();
    const int next = gi - 1 + g.ring;
    if (gi > 0 && next < n_stages)
      k9_stage(g, x, wm, h0, w0, nb, m0, two, next, ring + (next % g.ring) * g.stage_elems);
    cp_async_commit();
  }
  wg_wait<0>();
  cp_async_wait<0>();
  __syncthreads();
  // each warpgroup's tile through stage buffer wg (each holds 64 x 128)
  static_assert(2 * kBlkElems == kBM * kBN, "a stage holds an epilogue tile");
  __nv_bfloat16* cs = ring + wg * g.stage_elems;
  if (active) {
    if constexpr (kSpan == 4) {
      // output column block b = (T[b] + T[b + 1]) + T[b + 2], in place
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = (acc[e] + acc[e + 32]) + acc[e + 64];
    }
    k9_round(acc, cs);
    if (g.stats) k9_row_sums(acc, g, w0, nb, red[wg]);
  }
  __syncthreads();
  if (active) k9_store(g, cs, h0 + wg, w0, nb, m0, tid % kWgThreads, y);
  if (g.stats && tid < kBM && m0 + tid < g.c)
    partials[static_cast<int64_t>(m0 + tid) * (g.ptiles * g.runs) + part] =
        two ? red[0][tid] + red[1][tid] : red[0][tid];
}

// The stats output of a case with stats: out[r] = the sum of row r of
// partials (n values) for r < c, in rows_reduce_kernel's fixed order, and
// zero from c to numel.
__global__ void __launch_bounds__(kRowsReduceThreads)
k9_stats_kernel(const float* __restrict__ partials, int64_t n, int c, int numel,
                float* __restrict__ out) {
  for (int e = c + blockIdx.x * kRowsReduceThreads + threadIdx.x; e < numel;
       e += gridDim.x * kRowsReduceThreads)
    out[e] = 0.0f;
  const float sum = block_row_sum(partials + static_cast<int64_t>(blockIdx.x) * n, n);
  if (threadIdx.x == 0) out[blockIdx.x] = sum;
}

K9Geo k9_geo(int hs, int c, int ws, int n, bool merge_dot, bool shift) {
  K9Geo g;
  g.hs = hs;
  g.c = c;
  g.ws = ws;
  g.n = n;
  g.h = hs - 2;
  g.w = ws - 2;
  g.dy0 = merge_dot ? 0 : 1;
  g.ndy = merge_dot ? 3 : 1;
  g.span = shift ? 4 : 2;
  g.ncb = (c + kBK - 1) / kBK;
  g.mtiles = (c + kBM - 1) / kBM;
  g.nbs = (n + kBlkN - 1) / kBlkN;
  g.ptiles = (g.w + 1) / 2 * g.nbs;
  g.runs = (g.h + kWinRows - 1) / kWinRows;
  g.a_res = g.ncb == 1;
  g.stage_elems = (g.a_res ? g.span : g.span + 2) * kBlkElems;
  // span 2 keeps two CTAs an SM: three stages of four blocks where Wm is
  // not resident
  g.ring = g.span == 2 && !g.a_res ? 3 : 4;
  g.stats_numel = 0;
  g.prologue = g.zero_ring = g.stats = g.vec = 0;
  return g;
}

bool bad_k9_geo(int hs, int c, int ws, int n) {
  if (hs < 3 || ws <= 2 || n < 1 || c < 8 || c % 8 != 0) return true;
  const K9Geo g = k9_geo(hs, c, ws, n, true, true);
  return static_cast<int64_t>(g.mtiles) * g.ptiles * g.runs > 2147483647LL;
}

template <int kSpan>
int launch_k9(const void* x, const void* w, const K9Geo& g, void* y, void* partials,
              void* stats_out, cudaStream_t s) {
  const int smem = (g.ring * g.stage_elems + (g.a_res ? g.ndy * kBlkElems : 0)) * 2 +
                   1024;  // + alignment
  const cudaError_t err = cudaFuncSetAttribute(
      k9_dot_kernel<kSpan>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k9_dot_kernel<kSpan><<<g.mtiles * g.ptiles * g.runs, kK9Threads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), g,
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(partials),
      static_cast<float*>(stats_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K7. variant 1..5 (v1..v5); x (hs, c, ws, n) bf16 with ws = w + 2 (v5: w +
// 8); w (c, 3c) bf16, read by v3 only; y (hs - 2, c, w, n) bf16.
int bisect_k7_launch(int variant, const void* x, const void* w, int hs, int c, int ws, int n,
                     void* y, void* stream) {
  const int margin = variant == 5 ? 8 : 2;
  if (variant < 1 || variant > 5 || bad_k78_geo(hs, c, ws, n, margin))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g{hs, c, ws, n, hs - 2, ws - margin};
  switch (variant) {
    case 3:
      return launch_mma_dot(x, w, g, 0, 3, 1, y, s);
    case 4:
      return launch_rows(false, x, g, 1, 1, 0, 3, y, s);
    default:  // v1, v2, v5: the crop
      return launch_rows(false, x, g, 1, 1, 1, 1, y, s);
  }
}

// K8. body 0..4 (a..e); x (hs, c, ws, n) bf16 with ws = w + 2; w (c, 3c)
// bf16, read by c, d and e; y (hs - 2, c, w, n) bf16.
int bisect_k8_launch(int body, const void* x, const void* w, int hs, int c, int ws, int n,
                     void* y, void* stream) {
  if (body < 0 || body > 4 || bad_k78_geo(hs, c, ws, n, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g{hs, c, ws, n, hs - 2, ws - 2};
  switch (body) {
    case 0:
      return launch_rows(false, x, g, 0, 3, 1, 1, y, s);
    case 1:
      return launch_rows(true, x, g, 0, 3, 1, 1, y, s);
    case 3:
      return launch_mma_dot(x, w, g, 1, 1, 1, y, s);
    default:  // c, e: the stacked dot
      return launch_mma_dot(x, w, g, 0, 3, 1, y, s);
  }
}

// Whether a K7/K8/K9 launch on x (N samples) and w (null for a crop or a
// sum) takes the 16-byte path (1) or the element path (0) of its kernel,
// its output being a fresh, aligned tensor as the wrappers allocate it.
int bisect_vector_path(const void* x, const void* w, int n) {
  return vector_path(x, w, n, nullptr);
}

// The number of K9 partial sums per channel (the CTAs along the rows and
// columns of one channel tile).
int64_t bisect_k9_partials(int hs, int c, int ws, int n) {
  const K9Geo g = k9_geo(hs, c, ws, n, true, true);
  return static_cast<int64_t>(g.ptiles) * g.runs;
}

// K9. x (hs, c, ws, n) bf16 with ws = w + 2; w (3, c, 3c) bf16, of which
// w[0] is read; y (hs - 2, c, w, n) bf16. stats: the float32 stats output
// of stats_numel >= c values, written whole: with stats the sum of y per
// channel in its first c values (partials: float32 scratch of c *
// bisect_k9_partials(...) values), zeros in the rest and without stats. The
// flags are bisect_transposed3.py's (prologue and zero_ring act only with
// scratch, as there). Returns the cudaError_t of the launches.
int bisect_k9_launch(int prologue, int zero_ring, int merge_dot, int shift, int stats,
                     int scratch, const void* x, const void* w, int hs, int c, int ws, int n,
                     void* y, void* partials, void* stats_out, int stats_numel, void* stream) {
  if (bad_k9_geo(hs, c, ws, n) || stats_numel < c) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  K9Geo g = k9_geo(hs, c, ws, n, merge_dot != 0, shift != 0);
  g.prologue = scratch && prologue;
  g.zero_ring = scratch && zero_ring;
  g.stats = stats != 0;
  g.vec = vector_path(x, w, n, y);
  g.stats_numel = stats_numel;
  const int rc = shift ? launch_k9<4>(x, w, g, y, partials, stats_out, s)
                       : launch_k9<2>(x, w, g, y, partials, stats_out, s);
  if (rc != 0 || !stats) return rc;
  k9_stats_kernel<<<c, kRowsReduceThreads, 0, s>>>(static_cast<const float*>(partials),
                                                   bisect_k9_partials(hs, c, ws, n), c,
                                                   stats_numel, static_cast<float*>(stats_out));
  return static_cast<int>(cudaGetLastError());
}

const char* bisect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
