// Fused CBR in the transposed (H, C, W, N) layout, for Hopper (sm_90a):
// conv3x3 with a BatchNorm-apply prologue and a BatchNorm-statistics
// epilogue, forward only.
//
// Replaces the Pallas TPU kernels
//   scripts/proto_transposed_cbr.py::transposed_fused_cbr (:123-171,
//     pallas_call :140, body _kernel :49-118)             -> stacked_m = 0
//   scripts/proto_transposed_cbr.py::transposed_fused_cbr_v2 (:219-285,
//     pallas_call :254, body _kernel2 :181-214)           -> stacked_m = 1
// The two TPU designs differ only in where the TPU does the dx shift (on
// the input side, or on the output side with the stacked-M dot). Here the
// shift is free on either side (below), so both launch one design and give
// the same y, bit for bit.
//
// For x (H, Cin, W, N) bf16, w (3, 3, Cin, Cout) bf16 HWIO, a, b (Cin,) and
// bias (Cout,) float32:
//   xn    = bf16(relu(x * a + b))      (the prologue; xn = x when it is off)
//   y     = bf16(conv3x3_same(xn, w) + bias) as (H, Cout, W, N), float32
//           accumulation
//   stats = [sum(y), sum(y * y)] per output channel over H, W, N, taken on
//           the rounded y, in float32
// K2's function (kernels/fused_conv_stats.cu), with the sample index N the
// minor dimension. Positions outside the image are zero AFTER the affine,
// for every a: the copies zero-fill the halo and the prologue runs only on
// in-image elements. (The TPU v2 pre-fills the halo with (-1 - b) / a so that
// the prologue maps it to 0; where |a| <= 1e-12 it fills 0, and relu(b)
// leaks into the border. The port does not reproduce that.)
//
// Bound: 2 * 9 * Cin * Cout FLOP per output element against 2 (Cin + Cout)
// bytes of x and y: at the level-1 shape (N 128, 256 x 256, 64 -> 64) 618.5
// GFLOP and 2.15 GB, 0.625 ms of tensor cores and 0.641 ms of HBM; wider
// layers are bound by the tensor cores.
//
// Design (N % 8 == 0, tcbr_tma_kernel). The GEMM of an output row h: M =
// Cout, K = (dy, dx, ci), columns = (w, n). A staged column block is one
// input column's 64 samples of 64 channels, [ci][n] with the 128-byte
// swizzle (8 KB), and the blocks of an input row sit in column order, so
// the dx shift is a whole-block view: output columns w0, w0 + 1 at tap dx
// read staged blocks dx, dx + 1 through a plain wgmma descriptor, for any N
// (samples past N are TMA's zeros, which no output keeps). The weights are
// the M-major A operand, [ci][co] as they lie in w; B is the staged row,
// N-major. A tile is 64 output channels x kCols = 2 output columns x 64
// samples (m64n128k16, 64 accumulators a thread) of one output row.
//
// Staging arithmetic (shared memory 227 KB): a tile of R output rows x C
// output columns that stages its own halo reads (R + 2)(C + 2) / (RC) of x
// per output element from L2, 4x at 2 x 2 and 3x at 2 x 4; a CTA that walks
// down H with a ring of input rows reads (C + 2) / C. An input row's staged
// chunk of 64 channels is (C + 2) blocks: 48 KB at C = 4, 32 KB at C = 2.
// The 64 -> 64 weights are 72 KB. C = 4 leaves room for 3 rows beside them
// (216 KB), which lets a row load start only as the tile before it ends;
// C = 2 holds a ring of 4 rows (128 KB + 72 KB = 200 KB, and 16 KB of
// epilogue buffers), about one output row of loads in flight, at 2x
// staging. So C = 2 (1.37 ms at the level-1 shape on an H100, 3.2x the
// earlier design below; a TMA prefetch into the L2 of the stages three
// ahead of their loads moved nothing there: the loads are not what waits):
// - Cin <= 64 (one chunk): the weights stay resident, and a CTA walks its
//   band of output rows with the ring: each input row is staged once (plus
//   two halo rows a band), 2x x from L2; at the level-1 shape that is 2.1
//   GB of L2 reads for 1.07 GB of x.
// - Cin > 64: a CTA takes output rows in pairs and, for each chunk of 64
//   channels, stages the pair's four input rows and the chunk's weights
//   (one dy's 24 KB at a time, three slots): 4x x from L2 and the weights
//   once a pair. A last chunk of 32 channels is zero-filled past Cin by TMA
//   in x and in the weights' map (Cout, Cin, 9).
// Roles, as in K2: one producer warp issues every TMA load (x over the 4D
// map (N, C, W, H), whose out-of-bounds zeros are the halo, the ragged N, W
// and H and the channels past Cin; the weights over the 3D map (Cout, Cin,
// 9)); two consumer warpgroups, one output row each (rows h and h + 1, then
// h + 2 and h + 3, ...), run the wgmma products and each its own epilogue
// while the other's products run; one helper warpgroup (prologue on)
// applies the prologue to each staged row once, in shared memory, to its
// in-image elements only, before the consumers read it. mbarriers link the
// roles. The epilogue adds the bias, rounds once to bf16, sums each
// channel's rounded values in registers (in a fixed order) and stores y as
// 16-byte vectors of 8 samples, through a 2 KB shared buffer a warp filled
// by stmatrix. (On an H100, a first epilogue that transposed by shuffles
// inside each quad of lanes took 0.49 of 1.41 ms at the level-1 shape with
// the prologue off, measured by dropping it; this one takes about 0.2.)
// The helpers' 16-byte places are spread over the banks: with the four
// channels of a shared-memory phase on one place the prologue cost 0.4 ms
// there, 0.2 without the conflict.
// Each CTA writes one row of per-channel sums; rows_reduce_kernel adds them
// in a fixed order. No float atomics: y and stats are the same run to run.
//
// N % 8 != 0: a row of x is not 16-byte aligned and TMA cannot map it. That
// case runs tcbr_elem_kernel, the earlier design kept for it: wmma from 8
// warps on a tile of 4 rows x 8 columns x 16 samples x 64 output channels,
// Cin in chunks of 32 copied element by element with the prologue applied
// on the way (transposed_cbr_path names the path).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kCinStep = 32;  // Cin % 32 == 0: a last chunk may be half full
constexpr int kCoTile = 64;   // output channels of a tile

// --- the TMA + wgmma kernel (N % 8 == 0) ------------------------------------------------

constexpr int kBK = 64;                         // input channels of a chunk
constexpr int kBlkN = 64;                       // samples of a column block
constexpr int kCols = 2;                        // output columns of a tile
constexpr int kSpan = kCols + 2;                // staged column blocks of an input row
constexpr int kBlkBytes = kBK * kBlkN * 2;      // 8 KB
constexpr int kStageBytes = kSpan * kBlkBytes;  // 32 KB: one input row's chunk
constexpr int kRing = 4;                        // input rows in flight
constexpr int kTapBytes = kBK * kCoTile * 2;    // 8 KB of weights: 64 ci x 64 co
constexpr int kDyBytes = 3 * kTapBytes;         // a dy's three dx taps
constexpr int kConsumers = 256;                 // two warpgroups, one output row each
constexpr int kHelpers = 128;                   // the prologue
constexpr int kTmaThreads = kConsumers + kHelpers + 32;
constexpr int kHelperBar = 1, kConsumerBar = 2;  // named barriers
constexpr int kWarpEpiBytes = 8 * 2 * kBlkN * 2;  // a consumer warp's 8 channels x 2 columns
constexpr int kBarriers = 3 * kRing + 2 * 3;
constexpr int kTmaSmem = kRing * kStageBytes + 3 * kDyBytes + (kConsumers / 32) * kWarpEpiBytes +
                         2 * 2 * kCoTile * 4 + kBarriers * 8 + 1024;  // + alignment
static_assert(kTmaSmem <= 227 * 1024, "fits a CTA's shared memory");

struct TGeo {
  int h, cin, w, n, cout;
  int chunks;               // of 64 input channels
  int n_ct, n_nb, n_co;     // column tiles, sample blocks, channel tiles
  int bands, band_h;        // output row bands a (column tile, sample block)
  int items_m;              // CTAs of one channel tile: partial sums a channel
};

TGeo tgeo(int h, int cin, int wd, int n, int cout) {
  TGeo g;
  g.h = h;
  g.cin = cin;
  g.w = wd;
  g.n = n;
  g.cout = cout;
  g.chunks = (cin + kBK - 1) / kBK;
  g.n_ct = (wd + kCols - 1) / kCols;
  g.n_nb = (n + kBlkN - 1) / kBlkN;
  g.n_co = cout / kCoTile;
  // split H into bands where the columns and sample blocks alone leave SMs
  // idle (a band stages two halo rows more)
  const int64_t units = static_cast<int64_t>(g.n_ct) * g.n_nb;
  int64_t want = units >= sm_count() ? 1 : sm_count() / units;
  if (want > h) want = h;
  g.band_h = static_cast<int>((h + want - 1) / want);
  g.bands = (h + g.band_h - 1) / g.band_h;
  g.items_m = static_cast<int>(units * g.bands);
  return g;
}

// The input row and chunk of a CTA's x stage s: rows b0 - 1 .. b1 in order
// with one chunk; else (pair p, chunk c, row i of the pair's four) in order.
__device__ __forceinline__ void stage_of(const TGeo& g, int b0, int s, int* row, int* chunk) {
  if (g.chunks == 1) {
    *row = b0 - 1 + s;
    *chunk = 0;
  } else {
    const int wu = s >> 2, p = wu / g.chunks;
    *chunk = wu - p * g.chunks;
    *row = b0 + 2 * p - 1 + (s & 3);
  }
}

// Four 8 x 8 bf16 matrices from the registers of a warp (thread t holds row
// t / 4, columns 2 (t % 4) and + 1 of each: a wgmma accumulator fragment) to
// shared memory, row r of matrix i at the address lane 8 i + r passes.
__device__ __forceinline__ void stmatrix_x4(const void* row, uint32_t r0, uint32_t r1,
                                            uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_u32(row)),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

template <bool kPrologue>
__global__ void __launch_bounds__(kTmaThreads, 1)
tcbr_tma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ bias, TGeo g, __nv_bfloat16* __restrict__ y,
                float* __restrict__ partials) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  unsigned char* xs = smem_raw + (((base + 1023) & ~1023u) - base);
  unsigned char* ws = xs + kRing * kStageBytes;
  unsigned char* epi = ws + 3 * kDyBytes;  // a buffer of kWarpEpiBytes a consumer warp
  float* red = reinterpret_cast<float*>(epi + (kConsumers / 32) * kWarpEpiBytes);  // [wg][2][64]
  uint64_t* xfull = reinterpret_cast<uint64_t*>(red + 2 * 2 * kCoTile);
  uint64_t* xready = xfull + kRing;  // the prologue done (kPrologue)
  uint64_t* xempty = xready + kRing;
  uint64_t* wfull = xempty + kRing;
  uint64_t* wempty = wfull + 3;
  uint64_t* avail = kPrologue ? xready : xfull;

  // this CTA: column tile ct (fastest, so neighbouring CTAs share halo
  // columns in the L2), sample block nb, channel tile co_t, row band band
  int rest = blockIdx.x;
  const int ct = rest % g.n_ct;
  rest /= g.n_ct;
  const int nb = rest % g.n_nb;
  rest /= g.n_nb;
  const int co_t = rest % g.n_co;
  const int band = rest / g.n_co;
  const int m = (band * g.n_nb + nb) * g.n_ct + ct;  // this CTA's column of the partials
  const int w0 = ct * kCols, n0 = nb * kBlkN, co0 = co_t * kCoTile;
  const int b0 = band * g.band_h;
  const int b1 = min(g.h, b0 + g.band_h);
  const int pairs = (b1 - b0 + 1) / 2;
  const bool single = g.chunks == 1;
  const int n_stages = single ? b1 - b0 + 2 : pairs * g.chunks * 4;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(&xfull[i], 1);
      mbar_init(&xready[i], 1);
      mbar_init(&xempty[i], 2);
    }
    for (int i = 0; i < 3; ++i) {
      mbar_init(&wfull[i], 1);
      mbar_init(&wempty[i], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers + kHelpers) {
    // producer: one thread issues every copy
    if (threadIdx.x != kConsumers + kHelpers) return;
    auto load_w = [&](int c, int dy, int round) {
      mbar_wait(&wempty[dy], (round & 1) ^ 1);
      mbar_expect_tx(&wfull[dy], kDyBytes);
      for (int dx = 0; dx < 3; ++dx)
        tma_load_3d(ws + dy * kDyBytes + dx * kTapBytes, &wmap, &wfull[dy], co0, c * kBK,
                    dy * 3 + dx);
    };
    auto load_x = [&](int s) {
      const int slot = s % kRing;
      int row, c;
      stage_of(g, b0, s, &row, &c);
      mbar_wait(&xempty[slot], ((s / kRing) & 1) ^ 1);
      mbar_expect_tx(&xfull[slot], kStageBytes);
      tma_load_4d(xs + slot * kStageBytes, &xmap, &xfull[slot], n0, c * kBK, w0 - 1, row);
    };
    if (single) {
      for (int dy = 0; dy < 3; ++dy) load_w(0, dy, 0);
      for (int s = 0; s < n_stages; ++s) load_x(s);
    } else {
      for (int wu = 0; wu < pairs * g.chunks; ++wu) {
        for (int i = 0; i < 4; ++i) {
          if (i < 3) load_w(wu % g.chunks, i, wu);
          load_x(wu * 4 + i);
        }
      }
    }
    return;
  }

  if (threadIdx.x >= kConsumers) {
    // helpers: the prologue of each stage, once a staged element. Thread t
    // takes channel t / 2 and four of its row's eight 16-byte places in each
    // of the four blocks, places (t % 2) * 4 + ci + k mod 8: the eight
    // threads of a shared-memory phase (four channels) on eight distinct
    // places, so on distinct banks
    if (!kPrologue) return;
    const int t = threadIdx.x - kConsumers;
    const int ci = t >> 1, q0 = (t & 1) * 4 + ci;
    for (int s = 0; s < n_stages; ++s) {
      const int slot = s % kRing;
      int row, c;
      stage_of(g, b0, s, &row, &c);
      const int ch = c * kBK + ci;
      mbar_wait(&xfull[slot], (s / kRing) & 1);
      // channels past Cin (a last chunk of 32) hold the copy's zeros, left
      // as they are (a and b end at Cin)
      if (row >= 0 && row < g.h && ch < g.cin) {
        const float av = __ldg(a + ch), bv = __ldg(b + ch);
        unsigned char* st = xs + slot * kStageBytes + ci * 128;
#pragma unroll
        for (int blk = 0; blk < kSpan; ++blk) {
          const int col = w0 - 1 + blk;
          if (col < 0 || col >= g.w) continue;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int q = (q0 + k) & 7;  // the place; it holds samples 8 (q ^ ci % 8) ..
            if (n0 + 8 * (q ^ (ci & 7)) < g.n) {
              uint4* p = reinterpret_cast<uint4*>(st + blk * kBlkBytes + q * 16);
              *p = prologue8_1ch(*p, av, bv);
            }
          }
        }
      }
      fence_async_shared();  // the stage, for the consumers' wgmma
      named_sync<kHelperBar, kHelpers>();
      if (t == 0) mbar_arrive(&xready[slot]);
    }
    return;
  }

  // consumers: warpgroup wg takes output rows b0 + wg, b0 + wg + 2, ...
  const int wg = threadIdx.x >> 7, lt = threadIdx.x & 127;
  const int warp = lt >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's channels r0 and r0 + 8
  const float bias_r[2] = {__ldg(bias + co0 + r0), __ldg(bias + co0 + r0 + 8)};
  // bit 2 j + e: this thread's column j * 8 + (lane % 4) * 2 + e of a tile
  // row lies inside the output (for the sums)
  uint32_t valid = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (w0 + (j >> 3) < g.w && n0 + (j & 7) * 8 + (lane & 3) * 2 + e < g.n)
        valid |= 1u << (2 * j + e);
  unsigned char* wepi = epi + (threadIdx.x >> 5) * kWarpEpiBytes;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  float ssum[2] = {0.0f, 0.0f}, ssq[2] = {0.0f, 0.0f};

  // the 12 products of tap row dy on the stage in slot: three dx views of
  // the staged row (blocks dx, dx + 1), four k16 steps each
  auto products = [&](int slot, int dy) {
    const unsigned char* xb = xs + slot * kStageBytes;
    const unsigned char* wb = ws + dy * kDyBytes;
    wg_fence();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_64x128x16<1>(acc, wg_desc(wb + dx * kTapBytes + kk * 2048, 8192, 1024),
                           wg_desc(xb + dx * kBlkBytes + kk * 2048, 8192, 1024), 1);
    wg_commit();
  };
  // stage s is no longer read by this warpgroup (its availability first, so
  // that the arrivals on a slot's barrier come in its phases' order)
  auto release_x = [&](int s) {
    mbar_wait(&avail[s % kRing], (s / kRing) & 1);
    if (lt == 0) mbar_arrive(&xempty[s % kRing]);
  };
  // output row h: bias, one rounding, the sums of the rounded values; y as
  // 16-byte vectors of 8 samples, each warp's 8 channels of a half through
  // its own 2 KB of shared memory ([channel][column][8 pieces of 16 bytes],
  // the pieces of channel r in the order piece ^ r: no bank conflicts)
  auto epilogue = [&](int h) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4) {  // column groups j = 4 s4 .. 4 s4 + 3
        uint32_t r[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * s4 + jj;
          const __nv_bfloat162 v = __floats2bfloat162_rn(acc[j * 4 + half * 2] + bias_r[half],
                                                         acc[j * 4 + half * 2 + 1] + bias_r[half]);
          r[jj] = *reinterpret_cast<const uint32_t*>(&v);
          const float2 f = __bfloat1622float2(v);
          const float f0 = (valid >> (2 * j)) & 1u ? f.x : 0.0f;
          const float f1 = (valid >> (2 * j + 1)) & 1u ? f.y : 0.0f;
          ssum[half] += f0 + f1;
          ssq[half] += f0 * f0 + f1 * f1;
        }
        const int j = 4 * s4 + (lane >> 3), rr = lane & 7;
        stmatrix_x4(wepi + rr * 256 + (j >> 3) * 128 + (((j & 7) ^ rr) << 4), r[0], r[1], r[2],
                    r[3]);
      }
      __syncwarp();
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int idx = it * 32 + lane, rr = idx >> 4, w = (idx >> 3) & 1, c = idx & 7;
        const uint4 v = *reinterpret_cast<const uint4*>(wepi + rr * 256 + w * 128 +
                                                        ((c ^ rr) << 4));
        const int ww = w0 + w, nn = n0 + c * 8;
        if (ww < g.w && nn < g.n)
          *reinterpret_cast<uint4*>(
              y + ((static_cast<int64_t>(h) * g.cout + co0 + warp * 16 + half * 8 + rr) * g.w +
                   ww) * g.n + nn) = v;
      }
      __syncwarp();
    }
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  };

  if (single) {
    // the ring walks the band's input rows; a stage is released once this
    // warpgroup's later rows no longer read it (rows <= h after row h's
    // products of that row)
    int rel = 0, pend = 0;  // released: stages < rel; releasable once done: < pend
    for (int h = b0 + wg; h < b1; h += 2) {
      for (int dy = 0; dy < 3; ++dy) {
        const int s = h + dy - b0;  // input row h + dy - 1
        mbar_wait(&avail[s % kRing], (s / kRing) & 1);
        mbar_wait(&wfull[dy], 0);
        products(s % kRing, dy);
        wg_wait<1>();  // the previous group's products are done
        for (; rel < pend; ++rel) release_x(rel);
        pend = (dy < 2 ? h + dy - 1 : h) - b0 + 2;
      }
      wg_wait<0>();
      for (; rel < pend; ++rel) release_x(rel);
      epilogue(h);
    }
    for (; rel < n_stages; ++rel) release_x(rel);
  } else {
    // pairs of output rows; a round is (pair, chunk): four x stages and the
    // chunk's three dy weight slots. Stage i of a round is warpgroup 0's tap
    // row i and warpgroup 1's tap row i - 1; each warpgroup releases the one
    // it does not read
    int pend_s = -1, pend_dy = 0;
    auto release_pending = [&]() {
      if (pend_s >= 0 && lt == 0) {
        mbar_arrive(&xempty[pend_s % kRing]);
        mbar_arrive(&wempty[pend_dy]);
      }
      pend_s = -1;
    };
    for (int p = 0; p < pairs; ++p) {
      const int h = b0 + 2 * p + wg;
      const bool active = h < b1;
      for (int c = 0; c < g.chunks; ++c) {
        const int wu = p * g.chunks + c;
        if (wg == 1) release_x(wu * 4);
        for (int dy = 0; dy < 3; ++dy) {
          const int s = wu * 4 + wg + dy;
          mbar_wait(&avail[s % kRing], (s / kRing) & 1);
          mbar_wait(&wfull[dy], wu & 1);
          if (active)
            products(s % kRing, dy);
          else
            wg_commit();
          wg_wait<1>();
          release_pending();
          pend_s = s;
          pend_dy = dy;
        }
        if (wg == 0) release_x(wu * 4 + 3);
      }
      if (active) {
        wg_wait<0>();
        release_pending();
        epilogue(h);
      }
    }
    wg_wait<0>();
    release_pending();
  }

  // this CTA's sums of each channel, in a fixed order: the thread's values
  // row by row, its quad, then warpgroup 0 + warpgroup 1
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float s = ssum[half], q = ssq[half];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    q += __shfl_xor_sync(0xffffffffu, q, 2);
    if ((lane & 3) == 0) {
      red[(wg * 2 + 0) * kCoTile + r0 + half * 8] = s;
      red[(wg * 2 + 1) * kCoTile + r0 + half * 8] = q;
    }
  }
  named_sync<kConsumerBar, kConsumers>();
  if (threadIdx.x < 2 * kCoTile) {
    const int which = threadIdx.x / kCoTile, co = threadIdx.x % kCoTile;
    partials[(static_cast<int64_t>(which) * g.cout + co0 + co) * g.items_m + m] =
        red[which * kCoTile + co] + red[(2 + which) * kCoTile + co];
  }
}

// --- the element path (N % 8 != 0): wmma on cp.async-free staging -----------------------

using namespace nvcuda;

constexpr int kTR = 4;         // output rows per CTA (one per warp row)
constexpr int kTW = 8;         // output columns per CTA
constexpr int kNB = 16;        // samples per CTA: one wmma column block
constexpr int kEBK = 32;       // input channels per chunk
constexpr int kEThreads = 256;  // 8 warps: 2 along Cout (32 each) x 4 output rows
constexpr int kSR = kTR + 2;   // staged rows
constexpr int kSW = kTW + 2;   // staged columns
constexpr int kSP = kSR * kSW;                 // staged positions
constexpr int kXStage = kSP * kEBK * kNB;      // bf16 elements: [position][channel][sample]
constexpr int kWP = kCoTile + 8;               // staged weight row pitch (bf16)
constexpr int kWStage = 9 * kEBK * kWP;        // [tap][channel][output channel]
constexpr int kEStage = kXStage + kWStage;     // bf16 elements of one buffer
constexpr int kPix = kTR * kTW * kNB;          // output elements per channel per CTA
constexpr int kCLd = kPix + 4;                 // float32 epilogue pitch: [channel][pixel]
constexpr int kPipeBytes = 2 * kEStage * 2;
constexpr int kEpiBytes = kCoTile * kCLd * 4;
constexpr int kESmem = kPipeBytes > kEpiBytes ? kPipeBytes : kEpiBytes;
constexpr int kXElems = kSP * kEBK * kNB;      // elements of a chunk's x
constexpr int kWCopies = 9 * kEBK * (kCoTile / 8);  // 16-byte copies of a chunk's weights
static_assert(kXElems % kEThreads == 0 && kWCopies % kEThreads == 0,
              "copies split evenly over the threads");
static_assert(kESmem <= 227 * 1024, "fits a CTA's shared memory");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

struct ETiles {
  int n_tc, n_nb;
  int64_t m;
};

ETiles etiles(int h, int wd, int n) {
  ETiles t;
  t.n_tc = (wd + kTW - 1) / kTW;
  t.n_nb = (n + kNB - 1) / kNB;
  t.m = static_cast<int64_t>((h + kTR - 1) / kTR) * t.n_tc * t.n_nb;
  return t;
}

template <bool kPrologue>
__global__ void __launch_bounds__(kEThreads, 1)
tcbr_elem_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ b, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias, int H, int Cin, int W, int N, int Cout,
                 int n_tc, int n_nb, int64_t n_tiles_m, int n_tiles_n,
                 __nv_bfloat16* __restrict__ y, float* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[2][4][kCoTile];

  const int tid = threadIdx.x;
  const int64_t tile_m = blockIdx.x / n_tiles_n;
  const int tile_n = static_cast<int>(blockIdx.x % n_tiles_n);
  const int nb_i = static_cast<int>(tile_m % n_nb);
  const int tc_i = static_cast<int>((tile_m / n_nb) % n_tc);
  const int tr_i = static_cast<int>(tile_m / (static_cast<int64_t>(n_nb) * n_tc));
  const int h0 = tr_i * kTR;
  const int w0 = tc_i * kTW;
  const int s0 = nb_i * kNB;  // first sample
  const int co0 = tile_n * kCoTile;
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);

  // chunk `chunk` (input channels chunk * 32 ..) into buffer st: x element
  // by element with the prologue applied on the way (zeros in the halo,
  // past N and past Cin), the weights by 16-byte cp.async (zeros past Cin)
  auto copy_chunk = [&](int chunk, int st) {
    const int c0 = chunk * kEBK;
    __nv_bfloat16* xs = stages + st * kEStage;
    __nv_bfloat16* ws = xs + kXStage;
#pragma unroll 1  // unrolled, the copies' addresses spill the accumulators
    for (int i = 0; i < kXElems / kEThreads; ++i) {
      const int idx = tid + i * kEThreads;
      const int n = idx % kNB;
      const int sc = (idx / kNB) % kSW;
      const int k = (idx / (kNB * kSW)) % kEBK;
      const int sr = idx / (kNB * kSW * kEBK);
      const int hh = h0 + sr - 1, ww = w0 + sc - 1;
      __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && s0 + n < N && c0 + k < Cin) {
        v = x[((static_cast<int64_t>(hh) * Cin + c0 + k) * W + ww) * N + s0 + n];
        if (kPrologue) v = prologue1(v, __ldg(a + c0 + k), __ldg(b + c0 + k));
      }
      xs[((sr * kSW + sc) * kEBK + k) * kNB + n] = v;
    }
#pragma unroll
    for (int i = 0; i < kWCopies / kEThreads; ++i) {
      const int idx = tid + i * kEThreads;
      const int row = idx >> 3;  // tap * 32 + input channel of the chunk
      const int cv = idx & 7;
      const int tap = row / kEBK;
      const int k = row - tap * kEBK;
      cp_async16(ws + row * kWP + cv * 8,
                 w + (static_cast<int64_t>(tap) * Cin + c0 + k) * Cout + co0 + cv * 8);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int warp = tid >> 5;
  const int wn = warp & 1;   // output channels wn * 32 .. + 32
  const int wr = warp >> 1;  // output row h0 + wr
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kTW][2];
#pragma unroll
  for (int c = 0; c < kTW; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::fill_fragment(acc[c][i], 0.0f);

  const int n_chunks = Cin / kEBK;
  copy_chunk(0, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = ch & 1;
    // buffer st ^ 1 was last read in chunk ch - 1, which every warp has left
    // (the barrier that ends each chunk)
    if (ch + 1 < n_chunks) {
      copy_chunk(ch + 1, st ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const __nv_bfloat16* xs = stages + st * kEStage;
    const __nv_bfloat16* ws = xs + kXStage;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const __nv_bfloat16* xrow = xs + (wr + dy) * kSW * kEBK * kNB;
#pragma unroll
      for (int kk = 0; kk < kEBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[3][2];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(fa[dx][i],
                                   ws + ((dy * 3 + dx) * kEBK + kk) * kWP + wn * 32 + i * 16, kWP);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
#pragma unroll
        for (int c = 0; c < kTW; ++c)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            wmma::load_matrix_sync(fb, xrow + ((c + dx) * kEBK + kk) * kNB, kNB);
#pragma unroll
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[c][i], fa[dx][i], fb, acc[c][i]);
          }
      }
    }
    __syncthreads();
  }

  // epilogue: the accumulators go to shared memory as [channel][pixel],
  // pixel = (row, column, sample) (reusing the buffers: all copies have
  // landed and every warp has left the last chunk)
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int c = 0; c < kTW; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::store_matrix_sync(Cs + (wn * 32 + i * 16) * kCLd + (wr * kTW + c) * kNB, acc[c][i],
                              kCLd, wmma::mem_row_major);
  __syncthreads();

  // bias, one rounding to bf16, the store of y; the rounded values stay in
  // shared memory for the sums (elements outside the output count as zero)
  const int64_t row_stride = static_cast<int64_t>(W) * N;  // y[h][co] rows
  for (int v = tid; v < kCoTile * kPix; v += kEThreads) {
    const int co = v / kPix;
    const int p = v % kPix;
    const int hh = h0 + p / (kTW * kNB);
    const int ww = w0 + (p / kNB) % kTW;
    const int n = s0 + p % kNB;
    float* cs = Cs + co * kCLd + p;
    if (hh < H && ww < W && n < N) {
      const __nv_bfloat16 o = __float2bfloat16_rn(*cs + __ldg(bias + co0 + co));
      y[(static_cast<int64_t>(hh) * Cout + co0 + co) * row_stride + static_cast<int64_t>(ww) * N +
        n] = o;
      *cs = __bfloat162float(o);
    } else {
      *cs = 0.0f;
    }
  }
  __syncthreads();

  // per-channel sums of this tile in a fixed order: 4 threads a channel,
  // kPix / 4 pixels each, then the 4 parts in order
  {
    const int col = tid & (kCoTile - 1);
    const int part = tid / kCoTile;
    float s = 0.0f, q = 0.0f;
    const float* cs = Cs + col * kCLd;
    for (int p = part * (kPix / 4); p < (part + 1) * (kPix / 4); ++p) {
      const float v = cs[p];
      s += v;
      q += v * v;
    }
    red[0][part][col] = s;
    red[1][part][col] = q;
  }
  __syncthreads();
  if (tid < 2 * kCoTile) {
    const int s = tid / kCoTile;
    const int col = tid & (kCoTile - 1);
    const float t = ((red[s][0][col] + red[s][1][col]) + red[s][2][col]) + red[s][3][col];
    partials[(static_cast<int64_t>(s) * Cout + co0 + col) * n_tiles_m + tile_m] = t;
  }
}

bool tma_path(int n) { return n % 8 == 0; }

template <bool kPrologue>
int launch_tma(const CUtensorMap& xmap, const CUtensorMap& wmap, const float* a, const float* b,
               const float* bias, const TGeo& g, __nv_bfloat16* y, float* partials,
               cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      tcbr_tma_kernel<kPrologue>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTmaSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = static_cast<int64_t>(g.items_m) * g.n_co;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  tcbr_tma_kernel<kPrologue><<<static_cast<unsigned>(blocks), kTmaThreads, kTmaSmem, s>>>(
      xmap, wmap, a, b, bias, g, y, partials);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPrologue>
int launch_elem(const __nv_bfloat16* x, const float* a, const float* b, const __nv_bfloat16* w,
                const float* bias, int h, int cin, int wd, int n, int cout, __nv_bfloat16* y,
                float* partials, cudaStream_t s) {
  auto kernel = tcbr_elem_kernel<kPrologue>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kESmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ETiles t = etiles(h, wd, n);
  const int n_tiles_n = cout / kCoTile;
  const int64_t blocks = t.m * n_tiles_n;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kEThreads, kESmem, s>>>(
      x, a, b, w, bias, h, cin, wd, n, cout, t.n_tc, t.n_nb, t.m, n_tiles_n, y, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int transposed_cbr_tile_n() { return kCoTile; }
int transposed_cbr_tile_k() { return kCinStep; }

// Whether a launch on N samples takes the TMA + wgmma kernel (1) or the
// element path (0).
int transposed_cbr_path(int n) { return tma_path(n) ? 1 : 0; }

// The number of per-CTA partial sums per channel (columns of the partials
// scratch) for this shape.
int64_t transposed_cbr_tiles_m(int h, int wd, int n) {
  return tma_path(n) ? tgeo(h, kBK, wd, n, kCoTile).items_m : etiles(h, wd, n).m;
}

// x (h, cin, wd, n) bf16; w (3, 3, cin, cout) bf16; a, b (cin,), bias (cout,)
// float32; y (h, cout, wd, n) bf16. stacked_m: 0 for v1, 1 for v2 (one
// design: the same y and stats). partials: float32 scratch of 2 * cout *
// transposed_cbr_tiles_m(h, wd, n) values; stats: float32 (2, cout). All
// contiguous and 16-byte aligned; cin % 32 == 0, cout % 64 == 0. Returns the
// cudaError_t of the launches (or a tensor-map code, see
// transposed_cbr_error_string).
int transposed_cbr_launch(const void* x, const void* a, const void* b, const void* w,
                          const void* bias, int stacked_m, int apply_prologue, int h, int cin,
                          int wd, int n, int cout, void* y, void* partials, void* stats,
                          void* stream) {
  (void)stacked_m;
  if (h < 1 || wd < 1 || n < 1 || cin < kCinStep || cin % kCinStep != 0 || cout < kCoTile ||
      cout % kCoTile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  const auto* biasp = static_cast<const float*>(bias);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* pp = static_cast<float*>(partials);
  int rc;
  if (tma_path(n)) {
    const TGeo g = tgeo(h, cin, wd, n, cout);
    // x as (N, C, W, H): a box is 64 samples x 64 channels x kSpan columns
    // of one row, its blocks in column order; zero-filled outside the tensor
    CUtensorMap xmap, wmap;
    const uint64_t xdims[4] = {static_cast<uint64_t>(n), static_cast<uint64_t>(cin),
                               static_cast<uint64_t>(wd), static_cast<uint64_t>(h)};
    const uint64_t xstrides[3] = {static_cast<uint64_t>(wd) * n * 2,
                                  static_cast<uint64_t>(n) * 2,
                                  static_cast<uint64_t>(cin) * wd * n * 2};
    const uint32_t xbox[4] = {kBlkN, kBK, kSpan, 1};
    rc = encode_bf16_map(&xmap, x, 4, xdims, xstrides, xbox);
    if (rc != 0) return rc;
    // w as (Cout, Cin, 9): a box is 64 input channels of one tap by 64
    // output channels, [ci][co], its rows past Cin zero-filled
    const uint64_t wdims[3] = {static_cast<uint64_t>(cout), static_cast<uint64_t>(cin), 9};
    const uint64_t wstrides[2] = {static_cast<uint64_t>(cout) * 2,
                                  static_cast<uint64_t>(cin) * cout * 2};
    const uint32_t wbox[3] = {kCoTile, kBK, 1};
    rc = encode_bf16_map(&wmap, w, 3, wdims, wstrides, wbox);
    if (rc != 0) return rc;
    rc = apply_prologue ? launch_tma<true>(xmap, wmap, ap, bp, biasp, g, yp, pp, s)
                        : launch_tma<false>(xmap, wmap, ap, bp, biasp, g, yp, pp, s);
  } else {
    const auto* xp = static_cast<const __nv_bfloat16*>(x);
    const auto* wp = static_cast<const __nv_bfloat16*>(w);
    rc = apply_prologue ? launch_elem<true>(xp, ap, bp, wp, biasp, h, cin, wd, n, cout, yp, pp, s)
                        : launch_elem<false>(xp, ap, bp, wp, biasp, h, cin, wd, n, cout, yp, pp, s);
  }
  if (rc != 0) return rc;
  rows_reduce_kernel<<<2 * cout, kRowsReduceThreads, 0, s>>>(pp, transposed_cbr_tiles_m(h, wd, n),
                                                            static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

const char* transposed_cbr_error_string(int code) { return launch_error_string(code); }

}  // extern "C"
