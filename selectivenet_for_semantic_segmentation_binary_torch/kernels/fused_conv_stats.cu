// Fused conv3x3 with a BatchNorm-apply prologue and a BatchNorm-statistics
// epilogue, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of one function:
//   selectivenet_for_semantic_segmentation_binary_tpu/ops/fused_cbr.py
//   ::fused_conv_stats (_pallas_fwd :148-194, pallas_call :170, body
//   _fwd_kernel :98-145), the trunk's kernel (K2, ops/fused_cbr.py), and
//   scripts/proto_fused_cbr.py::fused_cbr (:107, pallas_call :137, body
//   _fused_cbr_kernel :42), the prototype that stages a normalised row band
//   (K3, ops/fused_cbr_rows.py): its idea, the band staged once and the
//   prologue once an element, is this kernel's design.
//
// For x (N, H, W, Cin) bf16 NHWC, w (3, 3, Cin, Cout) bf16 HWIO, a, b (Cin,)
// and bias (Cout,) float32:
//   xn    = bf16(relu(x * a + b))      (the prologue; xn = x when it is off)
//   y     = bf16(conv3x3_same(xn, w) + bias), float32 accumulation
//   stats = [sum(y), sum(y * y)] per output channel over N, H, W, taken on
//           the rounded y, in float32
// Positions outside the image are zero AFTER the affine: SAME padding pads
// the normalised input, so relu(b) must not leak into the halo (the Pallas
// kernel zeroes its pad ring for the same reason, fused_cbr.py:113-128).
//
// Bound: an implicit GEMM of M = N*H*W pixels by Cout with depth 9*Cin does
// 2*9*Cin*Cout flops per (2*Cin + 2*Cout) bytes of x and y, 288 at Cin =
// Cout = 64 and more at every wider layer: at or above the H100's ~295
// flop/byte bf16 ridge, so the tensor cores bound it (9.099 ms for the 13
// layers of a forward at batch 128).
//
// Design. An output tile is 128 pixels, 8 samples x 8 columns x 2 rows
// (n fastest), by kBN = 128 output channels (64 where Cout is 64). Per chunk
// of 64 input channels, the tile's halo band, 8 samples x 10 columns x 4
// rows = 320 pixel rows of 128 bytes, comes in one TMA box over the 4D
// tensor map (C, N, W, H) of x: coordinates outside the tensor (the halo,
// the ragged tail of N, W, H, and the channels past Cin in a last chunk of
// 32, where Cin % 64 == 32) are zero-filled. The weights' 3D map (Cout,
// Cin, 9) zero-fills their rows past Cin in the same way, and the prologue
// leaves those channels zero, so they add nothing whatever a and b are.
// Because the samples are the fastest 8 of a band row index, a tap's shift
// (dy, dx) moves the view by a multiple of 8 rows: each output row's 64 pixels (one consumer
// warpgroup) are 64 contiguous band rows starting on a 1024-byte swizzle
// boundary, so the nine taps read the one band through plain wgmma
// descriptors (A K-major, 128-byte swizzle). The weights w[tap][chunk]
// (64 x kBN, N-major) come by TMA into a ring of 64 KB. Warp roles:
// - one producer warp issues every copy, each band as soon as its buffer
//   frees (three bands at kBN = 128, two at 64);
// - two consumer warpgroups run wgmma m64nkBNk16 with float32 accumulators
//   in registers, and at a tile's end add the bias, round once to bf16 and
//   leave the tile in an epilogue buffer;
// - helper warpgroups (two at kBN = 64, else one) apply the prologue to
//   each band in shared memory, once a staged element rather than once a
//   tap, to its in-image rows only (the halo stays zero after the affine
//   for any a and b), and store each finished tile's y with 16-byte stores
//   and its per-tile channel sums of the rounded values in a fixed order.
// So the prologue and the epilogue run beside the products, not between
// them. The kernel is persistent: one CTA an SM walks the tiles.
// rows_reduce_kernel sums the per-tile rows in a fixed order. No float
// atomics: y and stats are identical from run to run.
//
// Only the forward is a kernel. The backward stays where the JAX package
// has it, outside any kernel: the port's torch.autograd.Function runs
// cuDNN's conv backward plus elementwise PyTorch (ops/fused_cbr.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTn = 8, kTw = 8;  // a tile's samples and columns
constexpr int kBK = 64;          // input channels a chunk
constexpr int kCinStep = 32;     // Cin % 32 == 0: a last chunk may be half full
constexpr int kBandW = kTw + 2;
constexpr int kConsumers = 256;  // two warpgroups: the products
constexpr int kHelperBar = 2;    // named barrier of the helpers

// A tile's rows: 2, one a consumer warpgroup, at kBN = 128; 4, two a
// warpgroup, at kBN = 64, so that a weight stage serves 256 pixels there
// too (the weights are re-read from L2 for every tile).
template <int kBN>
__host__ __device__ constexpr int tile_h() { return kBN == 64 ? 4 : 2; }
template <int kBN>
__host__ __device__ constexpr int tile_m() { return kTn * kTw * tile_h<kBN>(); }
// A band: the tile's pixels and their halo, 8 x 10 x (rows + 2) pixel rows
// of 64 channels (128 bytes): 40 KB or 60 KB.
template <int kBN>
__host__ __device__ constexpr int band_rows() { return kTn * kBandW * (tile_h<kBN>() + 2); }
template <int kBN>
__host__ __device__ constexpr int band_bytes() { return band_rows<kBN>() * 128; }

// The helpers (prologue, y, stats): two warpgroups at kBN = 64, whose band
// (480 rows) and tile (256 pixels) are larger, else one (a second one at
// kBN = 128 caps the registers at 96 and ran slower); then one producer
// warp.
template <int kBN>
__host__ __device__ constexpr int helpers() { return kBN == 64 ? 256 : 128; }
template <int kBN>
__host__ __device__ constexpr int threads() { return kConsumers + helpers<kBN>() + 32; }
// Bands in flight: three of 40 KB at kBN = 128 (two loading, and their
// prologue running, while one is read), two of 60 KB at kBN = 64; one
// epilogue buffer. That is what shared memory holds beside the weight ring.
template <int kBN>
__host__ __device__ constexpr int band_count() { return kBN == 64 ? 2 : 3; }

// The weight ring: 64 KB of stages, 4 of 16 KB at kBN = 128, 8 of 8 KB at 64.
template <int kBN>
__host__ __device__ constexpr int b_stage_bytes() { return kBK * kBN * 2; }
template <int kBN>
__host__ __device__ constexpr int b_stages() { return 65536 / b_stage_bytes<kBN>(); }
template <int kBN>
__host__ __device__ constexpr int epi_ld() { return kBN + 8; }  // bf16 pitch of an epilogue tile
template <int kBN>
__host__ __device__ constexpr int epi_bytes() { return tile_m<kBN>() * epi_ld<kBN>() * 2; }
template <int kBN>
__host__ __device__ constexpr int smem_bytes() {
  return band_count<kBN>() * band_bytes<kBN>() + 65536 + epi_bytes<kBN>() + 2 * 4 * 128 * 4 +
         (3 * band_count<kBN>() + 2 + 2 * b_stages<kBN>()) * 8 + 1024;
}

struct Geo {
  int n, h, w, cin, cout;
  int th;          // a tile's rows
  int cn, cw, ch;  // tiles along N, W, H
  int tiles_m, tiles_n, chunks;
};

struct Tile {
  int tile_m, co0, n0, w0, h0;
};

__device__ __forceinline__ Tile tile_of(const Geo& g, int t, int kBN) {
  Tile r;
  r.tile_m = t / g.tiles_n;
  r.co0 = (t - r.tile_m * g.tiles_n) * kBN;
  const int wt = r.tile_m % g.cw;
  const int rest = r.tile_m / g.cw;
  r.w0 = wt * kTw;
  r.h0 = (rest % g.ch) * g.th;
  r.n0 = (rest / g.ch) * kTn;
  return r;
}

// The tile of this CTA's chunk gi (tiles blockIdx.x, + gridDim.x, ...).
__device__ __forceinline__ Tile chunk_tile(const Geo& g, int gi, int kBN) {
  return tile_of(g, static_cast<int>(blockIdx.x + (gi / g.chunks) * gridDim.x), kBN);
}

template <int kBN, bool kPrologue>
__global__ void __launch_bounds__(threads<kBN>(), 1)
fused_conv_stats_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap, const float* __restrict__ a,
                        const float* __restrict__ b, const float* __restrict__ bias, Geo g,
                        __nv_bfloat16* __restrict__ y, float* __restrict__ partials) {
  constexpr int kBStage = b_stage_bytes<kBN>();
  constexpr int kStages = b_stages<kBN>();
  constexpr int kLd = epi_ld<kBN>();
  constexpr int kHelpers = helpers<kBN>();
  constexpr int kBands = band_count<kBN>();
  constexpr int kTh = tile_h<kBN>();
  constexpr int kBM = tile_m<kBN>();
  constexpr int kBandRows = band_rows<kBN>();
  constexpr int kBandBytes = band_bytes<kBN>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  unsigned char* bands = smem_raw + (((base + 1023) & ~1023u) - base);
  unsigned char* bstages = bands + kBands * kBandBytes;
  __nv_bfloat16* epi = reinterpret_cast<__nv_bfloat16*>(bstages + 65536);
  float* red = reinterpret_cast<float*>(bstages + 65536 + epi_bytes<kBN>());  // [2][4][128]
  uint64_t* band_full = reinterpret_cast<uint64_t*>(red + 2 * 4 * 128);
  uint64_t* band_ready = band_full + kBands;  // the prologue done (kPrologue)
  uint64_t* band_empty = band_ready + kBands;
  uint64_t* epi_full = band_empty + kBands;
  uint64_t* epi_empty = epi_full + 1;
  uint64_t* b_full = epi_empty + 1;
  uint64_t* b_empty = b_full + kStages;

  const int total_tiles = g.tiles_m * g.tiles_n;
  const int my_tiles = blockIdx.x < total_tiles
                           ? (total_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1
                           : 0;
  const int G = my_tiles * g.chunks;  // this CTA's chunks, tile by tile

  if (threadIdx.x == 0) {
    for (int i = 0; i < kBands; ++i) {
      mbar_init(&band_full[i], 1);
      mbar_init(&band_ready[i], 1);
      mbar_init(&band_empty[i], 2);
    }
    mbar_init(epi_full, kConsumers);
    mbar_init(epi_empty, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&b_full[i], 1);
      mbar_init(&b_empty[i], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers + kHelpers) {
    // producer: one thread issues every copy
    if (threadIdx.x != kConsumers + kHelpers) return;
    auto issue_band = [&](int gi) {
      const Tile tl = chunk_tile(g, gi, kBN);
      const int bb = gi % kBands;
      mbar_wait(&band_empty[bb], ((gi / kBands) & 1) ^ 1);
      mbar_expect_tx(&band_full[bb], kBandBytes);
      tma_load_4d(bands + bb * kBandBytes, &xmap, &band_full[bb], (gi % g.chunks) * kBK, tl.n0,
                  tl.w0 - 1, tl.h0 - 1);
    };
    for (int gi = 0; gi < kBands - 1 && gi < G; ++gi) issue_band(gi);
    int s = 0;
    uint32_t ph = 0;
    for (int gi = 0; gi < G; ++gi) {
      const Tile tl = chunk_tile(g, gi, kBN);
      const int c = gi % g.chunks;
      for (int tap = 0; tap < 9; ++tap) {
        mbar_wait(&b_empty[s], ph ^ 1);
        mbar_expect_tx(&b_full[s], kBStage);
#pragma unroll
        for (int j = 0; j < kBN / 64; ++j)
          tma_load_3d(bstages + s * kBStage + j * (kBK * 128), &wmap, &b_full[s], tl.co0 + 64 * j,
                      c * kBK, tap);
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
        // the band kBands - 1 ahead once this chunk's first weights are on
        // their way: its buffer frees when the consumers finish the
        // previous chunk
        if (tap == 1 && gi + kBands - 1 < G) issue_band(gi + kBands - 1);
      }
    }
    return;
  }

  if (threadIdx.x >= kConsumers) {
    // helpers: the prologue of each band, and each tile's y and sums from
    // the rounded tile the consumers leave in an epilogue buffer
    const int t = threadIdx.x - kConsumers;
    // a helper's 16-byte pieces of a band row all have one piece index and
    // one swizzle phase (row % 8 = the sample), so one 8-channel group
    const int piece = t & 7, n_row = (t >> 3) & 7;
    const int group = (piece ^ n_row) << 3;
    for (int gi = 0; gi <= G; ++gi) {
      if (kPrologue && gi < G) {
        const Tile tl = chunk_tile(g, gi, kBN);
        const int bb = gi % kBands;
        const int ch = (gi % g.chunks) * kBK + group;
        // a last chunk of 32 channels: the 8-channel groups past Cin hold
        // the copy's zeros, left as they are (a and b end at Cin)
        const bool c_in = ch < g.cin;
        const int cl = c_in ? ch : 0;
        const float4 a0 = __ldg(reinterpret_cast<const float4*>(a + cl));
        const float4 a1 = __ldg(reinterpret_cast<const float4*>(a + cl) + 1);
        const float4 b0 = __ldg(reinterpret_cast<const float4*>(b + cl));
        const float4 b1 = __ldg(reinterpret_cast<const float4*>(b + cl) + 1);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        const bool n_in = c_in && tl.n0 + n_row < g.n;
        unsigned char* band = bands + bb * kBandBytes;
        mbar_wait(&band_full[bb], (gi / kBands) & 1);
#pragma unroll 4
        for (int r = t >> 3; r < kBandRows; r += kHelpers / 8) {
          const int bw = (r >> 3) % kBandW, bh = r / (kTn * kBandW);
          const int ww = tl.w0 - 1 + bw, hh = tl.h0 - 1 + bh;
          if (n_in && ww >= 0 && ww < g.w && hh >= 0 && hh < g.h) {
            uint4* p = reinterpret_cast<uint4*>(band + r * 128 + piece * 16);
            *p = prologue8_ab(*p, av, bv);
          }
        }
        fence_async_shared();  // the band, for the consumers' wgmma
        named_sync<kHelperBar, kHelpers>();
        if (t == 0) mbar_arrive(&band_ready[bb]);
      }
      // the tile that ended with chunk gi - 1
      if (gi == 0 || (gi - 1) % g.chunks != g.chunks - 1) continue;
      const int it = (gi - 1) / g.chunks;
      const Tile tl = chunk_tile(g, gi - 1, kBN);
      mbar_wait(epi_full, it & 1);
      auto pixel_in = [&](int r) {
        return tl.n0 + (r & 7) < g.n && tl.w0 + ((r >> 3) & 7) < g.w && tl.h0 + (r >> 6) < g.h;
      };
      for (int i = t; i < kBM * kBN / 8; i += kHelpers) {
        const int r = i / (kBN / 8), p = i % (kBN / 8);
        if (pixel_in(r)) {
          const int64_t pix =
              (static_cast<int64_t>(tl.n0 + (r & 7)) * g.h + tl.h0 + (r >> 6)) * g.w + tl.w0 +
              ((r >> 3) & 7);
          *reinterpret_cast<uint4*>(y + pix * g.cout + tl.co0 + p * 8) =
              *reinterpret_cast<const uint4*>(epi + r * kLd + p * 8);
        }
      }
      // per-channel sums of the rounded tile in a fixed order: kParts
      // helpers a channel, kBM / kParts rows each, then the parts in order
      constexpr int kParts = kHelpers / kBN > 0 ? kHelpers / kBN : 1;
      constexpr int kRows = kBM / kParts;
      const int col = t % kBN, part = t / kBN;
      // four interleaved partial sums (rows r % 4), then added in order
      float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int r0 = part * kRows; r0 < (part + 1) * kRows; r0 += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float v = pixel_in(r0 + u) ? __bfloat162float(epi[(r0 + u) * kLd + col]) : 0.0f;
          sum[u] += v;
          sq[u] += v * v;
        }
      }
      red[(0 * 4 + part) * 128 + col] = (sum[0] + sum[1]) + (sum[2] + sum[3]);
      red[(1 * 4 + part) * 128 + col] = (sq[0] + sq[1]) + (sq[2] + sq[3]);
      named_sync<kHelperBar, kHelpers>();
      if (t == 0) mbar_arrive(epi_empty);  // every helper is done reading it
      for (int i = t; i < 2 * kBN; i += kHelpers) {
        const int which = i / kBN, cc = i % kBN;
        float total = red[(which * 4) * 128 + cc];
#pragma unroll
        for (int p = 1; p < kParts; ++p) total += red[(which * 4 + p) * 128 + cc];
        partials[(static_cast<int64_t>(which) * g.cout + tl.co0 + cc) * g.tiles_m + tl.tile_m] =
            total;
      }
      named_sync<kHelperBar, kHelpers>();
    }
    return;
  }

  // consumers: warpgroup wg takes output rows h0 + wg * kRows .. + kRows
  constexpr int kRows = kTh / 2;
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x;
  float acc[kRows][kBN / 2];
  int s = 0;
  uint32_t ph = 0;
  int pend_stage = -1, pend_band = -1;  // copies whose products were in flight
  auto release = [&]() {
    if ((t & 127) == 0) {
      if (pend_stage >= 0) mbar_arrive(&b_empty[pend_stage]);
      if (pend_band >= 0) mbar_arrive(&band_empty[pend_band]);
    }
    pend_stage = pend_band = -1;
  };
  for (int gi = 0; gi < G; ++gi) {
    const int c = gi % g.chunks;
    const int bb = gi % kBands;
    mbar_wait(kPrologue ? &band_ready[bb] : &band_full[bb], (gi / kBands) & 1);
    if (c == 0) {
#pragma unroll
      for (int k = 0; k < kRows; ++k)
#pragma unroll
        for (int e = 0; e < kBN / 2; ++e) acc[k][e] = 0.0f;
    }
    const unsigned char* band = bands + bb * kBandBytes;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const unsigned char* bv = bstages + s * kBStage;
      mbar_wait(&b_full[s], ph);
      wg_fence();
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        // output row wg * kRows + k, its 64 pixels (n + 8 * w) at the tap:
        // contiguous band rows
        const unsigned char* av =
            band + (kTn * (1 + dx) + kTn * kBandW * (1 + wg * kRows + k + dy)) * 128;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_step<kBN, 0>(acc[k], wg_desc(av + kk * 32, 16, 1024),
                             wg_desc(bv + kk * 2048, kBK * 128, 1024));
      }
      wg_commit();
      wg_wait<1>();  // the previous tap's products are done: release its copies
      release();
      pend_stage = s;
      pend_band = tap == 8 ? bb : -1;
      if (++s == kStages) {
        s = 0;
        ph ^= 1;
      }
    }
    if (c != g.chunks - 1) continue;

    // the tile's end: bias, one rounding to bf16, into an epilogue buffer
    // for the helpers
    wg_wait<0>();
    release();
    const int it = gi / g.chunks;
    const Tile tl = chunk_tile(g, gi, kBN);
    mbar_wait(epi_empty, (it & 1) ^ 1);
    const int warp = (t >> 5) & 3, lane = t & 31;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = j * 8 + (lane & 3) * 2;
      const float b0 = __ldg(bias + tl.co0 + col), b1 = __ldg(bias + tl.co0 + col + 1);
#pragma unroll
      for (int k = 0; k < kRows; ++k)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = (wg * kRows + k) * 64 + warp * 16 + (lane >> 2) + half * 8;
          *reinterpret_cast<__nv_bfloat162*>(epi + r * kLd + col) = __floats2bfloat162_rn(
              acc[k][j * 4 + half * 2] + b0, acc[k][j * 4 + half * 2 + 1] + b1);
        }
    }
    mbar_arrive(epi_full);
  }
}

Geo geo_of(int n, int h, int w, int cin, int cout) {
  Geo g;
  g.n = n;
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.cout = cout;
  const bool wide = cout % 128 == 0;
  g.th = wide ? tile_h<128>() : tile_h<64>();
  g.cn = (n + kTn - 1) / kTn;
  g.cw = (w + kTw - 1) / kTw;
  g.ch = (h + g.th - 1) / g.th;
  g.tiles_m = g.cn * g.cw * g.ch;
  g.tiles_n = wide ? cout / 128 : cout / 64;
  g.chunks = (cin + kBK - 1) / kBK;
  return g;
}

template <int kBN, bool kPrologue>
int launch(const CUtensorMap& xmap, const CUtensorMap& wmap, const float* a, const float* b,
           const float* bias, const Geo& g, __nv_bfloat16* y, float* partials, cudaStream_t s) {
  constexpr int smem = smem_bytes<kBN>();
  const cudaError_t err = cudaFuncSetAttribute(
      fused_conv_stats_kernel<kBN, kPrologue>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = static_cast<int64_t>(g.tiles_m) * g.tiles_n;
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  fused_conv_stats_kernel<kBN, kPrologue><<<grid, threads<kBN>(), smem, s>>>(xmap, wmap, a, b, bias, g,
                                                                     y, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fused_conv_stats_tile_n() { return 64; }
int fused_conv_stats_tile_k() { return kBK; }
// The input channels the kernel takes a multiple of: a last chunk may hold
// 32 of its 64.
int fused_conv_stats_cin_step() { return kCinStep; }

// The number of per-tile partial sums per channel (output tiles of 8
// samples x 8 columns x 2 rows, or x 4 rows where cout is not a multiple
// of 128).
int64_t fused_conv_stats_tiles_m(int n, int h, int w, int cout) {
  return geo_of(n, h, w, kBK, cout).tiles_m;
}

// x (n, h, wd, cin) and w (3, 3, cin, cout) bf16, a, b (cin,) and bias
// (cout,) float32, all contiguous and 16-byte aligned; cin % 32 == 0 and
// cout % 64 == 0. partials: float32 scratch of 2 * cout *
// fused_conv_stats_tiles_m(n, h, wd, cout) values. stats: float32 (2, cout).
// Returns the cudaError_t of the launches (or a tensor-map code,
// fused_conv_stats_error_string).
int fused_conv_stats_launch(const void* x, const void* a, const void* b,
                            const void* w, const void* bias, int apply_prologue,
                            int n, int h, int wd, int cin, int cout, void* y,
                            void* partials, void* stats, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || cin < kCinStep || cin % kCinStep != 0 || cout < 64 ||
      cout % 64 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geo g = geo_of(n, h, wd, cin, cout);
  if (static_cast<int64_t>(g.tiles_m) * g.tiles_n > 2147483647LL || 9LL * cin > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  // x as (C, N, W, H) with the samples' stride outermost in memory: a band's
  // rows come n fastest; the box is 64 channels x 8 x 10 x (tile rows + 2),
  // zero-filled past Cin in a last chunk of 32
  CUtensorMap xmap, wmap;
  const uint64_t xdims[4] = {static_cast<uint64_t>(cin), static_cast<uint64_t>(n),
                             static_cast<uint64_t>(wd), static_cast<uint64_t>(h)};
  const uint64_t xstrides[3] = {static_cast<uint64_t>(h) * wd * cin * 2,
                                static_cast<uint64_t>(cin) * 2,
                                static_cast<uint64_t>(wd) * cin * 2};
  const uint32_t xbox[4] = {kBK, kTn, kBandW, static_cast<uint32_t>(g.th + 2)};
  int rc = encode_bf16_map(&xmap, x, 4, xdims, xstrides, xbox);
  if (rc != 0) return rc;
  // w as (Cout, Cin, 9): a stage is 64 input channels of one tap by 64
  // output channels a box, its rows past Cin zero-filled as x's channels are
  const uint64_t wdims[3] = {static_cast<uint64_t>(cout), static_cast<uint64_t>(cin), 9};
  const uint64_t wstrides[2] = {static_cast<uint64_t>(cout) * 2,
                                static_cast<uint64_t>(cin) * cout * 2};
  const uint32_t wbox[3] = {64, kBK, 1};
  rc = encode_bf16_map(&wmap, w, 3, wdims, wstrides, wbox);
  if (rc != 0) return rc;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  const auto* biasp = static_cast<const float*>(bias);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* pp = static_cast<float*>(partials);
  const bool wide = cout % 128 == 0;
  if (wide && apply_prologue)
    rc = launch<128, true>(xmap, wmap, ap, bp, biasp, g, yp, pp, s);
  else if (wide)
    rc = launch<128, false>(xmap, wmap, ap, bp, biasp, g, yp, pp, s);
  else if (apply_prologue)
    rc = launch<64, true>(xmap, wmap, ap, bp, biasp, g, yp, pp, s);
  else
    rc = launch<64, false>(xmap, wmap, ap, bp, biasp, g, yp, pp, s);
  if (rc != 0) return rc;
  rows_reduce_kernel<<<2 * cout, kRowsReduceThreads, 0, s>>>(pp, g.tiles_m,
                                                            static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

const char* fused_conv_stats_error_string(int code) { return launch_error_string(code); }

}  // extern "C"
