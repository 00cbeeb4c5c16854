// stream_block: Conv1d(k, 'SAME') + bias + ReLU or exact GELU +
// AdaptiveAvgPool1d(t_out), fused, for NVIDIA Hopper (sm_90a), forward and
// backward.
//
// Replaces the TPU kernel _stream_block_kernel in
// gaitpd/ops/pallas_blocks.py and the backward of its custom_vjp
// (make_stream_block). The forward computes exactly the reference's
// _stream_block_jnp / SharedBackbone:
//   x (B, T, Cin), w (K, Cin, Cout), b (Cout,)  ->  out (B, t_out, Cout), f32.
//
// FORWARD
//
// What bounds it. On the serving path B = 3N windows (the three streams
// share the backbone and go through one launch), T = 64, Cin = 12, Cout = 16,
// K = 3, t_out = 8. The kernel must read 3N*64*12*4 B and write 3N*8*16*4 B,
// and does 2*3N*64*12*16*3 FLOP of f32 work on the CUDA cores. At N = 1024
// that is 9.4 MB + 1.6 MB over 3.35 TB/s = 3.3 us against 226 MFLOP over
// 67 TFLOP/s = 3.4 us: both bounds are close, and neither is reached while
// the conv's intermediate (B, T, Cout) goes through device memory.
//
// What the design does about it. One pass, nothing between the input and the
// pooled output goes through device memory. Four variants, chosen by the
// sizes alone (gaitpd_torch/ops/stream_block.py::_variant):
//
// "warp_tile", the main path's sizes compiled in: T = 64, Cout = 16, K = 3,
// t_out = 8, Cin in {12, 16, 36} (the flagship's, late fusion's and the
// cheap cross-attention's backbone; the shared latent; early fusion), ReLU or
// exact GELU. One warp a window, four windows a block. Lane = (bin 0..7,
// group of 4 c_out 0..3) keeps the conv outputs of its bin's 8 frames and 4
// c_out, 32 accumulators, in registers. For each input channel it loads the
// bin's 8 frames and a halo frame on each side once (two float4 and a
// float2) and, for each tap, one float4 of w: 6 shared loads for 96 FMAs, so
// the FMA pipe and not shared memory sets the pace (the generic variant
// reads x and w for every FMA: two shared loads an FMA, about 27 us of
// shared-load issue at the main shape). x is staged channel-major per
// window, each bin's 10 frames in a row of 12 floats (the halo frames
// duplicated), so that the 8 bins of a warp read 8 x 16 bytes on 32
// distinct banks; a channel's rows are 100 floats apart, so that the
// staging stores of neighbouring channels spread over the banks. The lane
// then applies bias and activation, averages its 8 frames in registers and
// writes one float4: a warp writes its window's 512 bytes at once.
//
// "wide", warp_tile's T, Cout, K and t_out at any Cin (_variant takes it
// from ops/stream_block.py::WIDE_MIN_CIN channels; FOCAL's backbone: 128
// shared + 3 x 64 private channels, GELU). At 1024 windows of Cin 320 it
// reads 84 MB and does 2.0 GFLOP, 25 us and 30 us at the card's rates:
// both bound it. Cin is streamed through shared memory 32 channels at
// a time with cp.async into two buffers, so the next chunk's copies run
// under this chunk's FMAs, and the chunk of w is staged once a block for all
// its windows. A block of 8 warps takes 1, 2, 4 or 8 windows (the most that
// still gives every SM a block: 4 at 1024 windows, 1 at 64) and splits each
// window's channel quads over the rest of its warps; lane = (bin, 4 c_out)
// as in warp_tile, 32 accumulators, 10 float4 of x and 12 of w per 384 FMAs;
// the splits' sums meet in shared memory in a fixed order. Rows of x are
// skewed 16 bytes every 8 frames and rows of w every 4 channels, so a warp's
// loads fall on distinct banks. Any Cin: a chunk beyond Cin is zero-filled
// by the copies. On the H100 (PERF.md) the copies alone take half the
// kernel's time and the FMAs alone three quarters: they overlap only in
// part.
//
// "per_frame", _stream_block_kernel's forward (gaitpd/ops/pallas_blocks.py:
// 72-94) at every other size whose window fits a block's shared memory
// (T = 101 with overlapping bins, K = 1 or 5, Cin = 13, C_out 4, ...). The
// FBG/FoG models' backbones: 2 x 256 windows of T 101 at Cin 3, 6, 12, 16 or
// 32. At FOCAL's 2-modality shape, (512, 101, 32) -> C_out 4, t_out 4, the
// kernel must read 6.6 MB and does 40 MFLOP: 2.0 us of bytes against 0.6 us
// of operations, so bytes bound it, and at FoG's (512, 101, 6) -> (8, 16) the
// 1.5 MB bound it at 0.45 us. The window is small, so what sets the time is
// how many SMs load at once and how long the chain of FMAs after the load
// is. The design: one window a block, so 512 blocks of at most 18 KB spread
// over every SM and all load at once (cp.async, 16 bytes a copy where Cin is
// a multiple of 4); each conv output z[t, c_out] is computed once, by a
// thread a (frame, 4 c_out) item (101 to 404 items a window, in blocks of
// 64 to 256 threads), which reads per 4 channels one float4 of x and four
// of w (broadcast) for 16 FMAs, in the generic variant's order (tap-major,
// channel-minor); bias and activation go into y (T, C_out) in shared
// memory; then a thread a (bin, c_out) sums the bin's frames in ascending
// order and divides by the bin's length. The bin is [floor(i*T/t_out), ceil((i+1)*T/t_out)), as
// torch's AdaptiveAvgPool1d: bins overlap when t_out does not divide T, and a
// frame on a shared edge is read by both bins but computed once.
//
// "generic", the first design, kept for the sizes whose window, w
// and y do not fit per_frame's 227 KB but whose window and w do (a long T at
// few channels: per_frame pads C_in and C_out to 4 and keeps y). A block
// stages a tile of whole windows (with a zeroed halo of K/2 frames on each
// side, so no host-side padding) and the weights in shared memory; each
// thread owns one (window, bin, c_out) output, computes the conv outputs of
// the frames in its bin, applies bias and activation, and averages them: a
// frame on a shared bin edge is computed by both bins.
//
// No tensor cores: parity is strict f32 (no TF32). A 3xTF32 tensor-core
// version of the wide variant's conv is untried.
//
// BACKWARD
//
// The VJP of the forward for a cotangent g (B, t_out, Cout). With
// z = conv(x, w) + b and y = act(z):
//   g_y[t]  = sum over the bins o that hold t of g[o] / |bin o|;
//   g_z     = g_y * act'(z)   (ReLU'(0) = 0; GELU' = Phi(z) + z phi(z));
//   gx[t,ci]   = sum_i sum_co g_z[t - i + pad, co] w[i, ci, co]  (halo masked);
//   gw[i,ci,co] = sum_{b,t} xp[b, t + i, ci] g_z[b, t, co];
//   gb[co]      = sum_{b,t} g_z[b, t, co].
//
// What bounds it. In a CAGrad training step the backbone's backward runs
// once per task (K = 3) over the concatenated batch of the three streams:
// at 3*1024 windows, T = 64, Cin = 12, Cout = 16, k = 3 it must read x and g
// and write gx, about 20.4 MB (6.1 us at 3.35 TB/s), and do the recompute of
// z, gx and gw, each as many FLOP as the forward's 226 MFLOP, about
// 680 MFLOP of f32 (10.1 us at 67 TFLOP/s): operations bound it.
//
// What the design does about it. Nothing of the forward is saved but x, w
// and b. A block takes a tile of 8 whole windows (at the main shape 65 KB of
// shared memory, three blocks an SM: the 384 blocks of 3*1024 windows fit in
// one wave), stages x with a zeroed halo, g, w and b in shared memory, and
// keeps g_z of its windows there too, with a zeroed halo of its own. Cin and
// Cout are padded to multiples of 4 with zeros there, so every inner loop
// reads 16 bytes at a time. The phases:
//  - Liveness. A window is live if its cotangent row g[b] has a nonzero
//    value or its x a non-finite one; every window is live if w or b has a
//    non-finite value. A window that is not live has g_z = 0 exactly (z is
//    finite), so its gx is 0 and it adds exactly 0 to gw and gb: it is
//    skipped. (Not caught: finite x and w whose z overflows to inf.) In a
//    CAGrad task pass two thirds of the windows carry zero cotangents, in
//    whole blocks, and such a block writes zeros and returns.
//  - g_z of the live windows: a thread takes (window, frame, 4 c_out),
//    recomputes z with one x and one float4 of w per 4 FMAs, and adds the
//    frame's bins, whose range is computed once per block.
//  - gx: a thread takes (window, 2 frames, 4 c_in); per 32 FMAs it reads
//    two float4 of g_z and four of w. The halo of g_z needs no masks.
//  - gw and gb: a thread keeps a 4 x 4 tile of outputs (4 taps j of K*Cin,
//    4 c_out; gb is one more row of tiles, against a constant 1) in
//    registers and reads one float4 of x and one of g_z per 16 FMAs. The
//    40 tiles of the main shape take 40 threads; the block's 6 groups of 40
//    split the live (window, frame) steps, and their sums are added in a
//    fixed order through shared memory (aliasing x and g_z, no longer read).
// Each window belongs to one block, so the block writes gx directly. Each
// block writes its partial gw, gb to its own row of a scratch buffer
// (allocated by the caller); a second launch sums the rows in 8 slices of
// fixed order over 152 blocks, a third the slices in order. No float
// atomics: the result is the same bits from run to run. No tensor cores:
// parity is strict f32. On the H100 (PERF.md) the blocks run in one wave,
// so the kernel lasts as long as a live block: in a CAGrad task pass the
// skip frees two thirds of the SMs' work but shortens the launch little.
//
// That is the "generic" backward. At the wide forward's sizes (FOCAL's Cin
// 320) it would stage a whole window and w per block (one window a block at Cin
// 320, w reloaded by each of 1024 blocks) and write 63 MB of partial rows;
// above Cin of about 510 one window no longer fits. The "wide" backward
// (gaitpd_torch/ops/stream_block.py::_backward_variant) takes those sizes,
// any Cin, in two kernels and the two reductions:
//  - g_z: the wide forward's conv, with g_y * act'(z) (B, 64, 16) written to
//    a scratch buffer in place of the pooled output (4 MB at 1024 windows).
//  - gx and gw: block (window range, chunk of 32 channels), two blocks an
//    SM and as many ranges as fill the card once (26 x 10 chunks at Cin 320).
//    A block stages the chunk of w once, then its windows 4 at a time with
//    their g_z, double-buffered. Each window has a gx warp (lane = 8 frames
//    x 4 channels, 32 accumulators, per c_out quad 10 float4 of g_z and 12
//    of w for 384 FMAs; it writes gx) and a gw warp (lane = 4 channels x 4
//    c_out x 3 taps, 48 accumulators over all the block's windows, one
//    float4 of x and one of g_z per frame for 48 FMAs; gb beside it in the
//    chunk-0 blocks): the two are as many FMAs. At the end the gw warps'
//    tiles are added in a fixed order into the range's row of the scratch
//    buffer: 26 rows, 1.6 MB, where the generic backward writes 63 MB. The
//    gx and gw warps of a window are warps w and w + 4, so that each of the
//    SM's schedulers runs both kinds. The two kinds run loops of their own
//    that meet at the same barriers: barrier.sync without .aligned, which
//    PTX allows to be reached from different code (__syncthreads is not).
//    On the H100 (PERF.md) it reads x again and writes gx, 168 MB, and its
//    copies, its gx stores and its FMAs overlap only in part: it takes about
//    twice the 2 x 1.0 GFMA's time.
// It skips no window (a NaN anywhere reaches gw as in the plain version),
// uses no float atomics, and gives the same bits from run to run.
//
// FOLDS
//
// Cross-validation trains F folds' models in one step (gaitpd_torch/train/
// vmap_cv.py), each on its own B windows with its own weights. Every entry
// point takes a fold count F: x (F*B, T, Cin) fold-major, w (F, K, Cin, Cout),
// b (F, Cout), out (F*B, t_out, Cout); the backward gives gx (F*B, T, Cin),
// gw (F, K, Cin, Cout) and gb (F, Cout). The fold is the grid's z index:
// every kernel offsets its pointers to fold blockIdx.z's windows, weights
// and partial rows and then runs as a launch of one fold does, with the
// windows a block, the split of a window and the reduction order chosen from
// B alone. So no block's windows span two folds, each fold's result has the
// bits of a launch of that fold alone, and F = 1 launches what a launch
// without folds does.
//
// Plain C interface, bound with ctypes (gaitpd_torch/ops/stream_block.py).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kGenericWindows = 4;
constexpr int kBwdTileWindows = 8;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

constexpr int kActRelu = 0;
constexpr int kActGelu = 1;

// The backward's reduction of its partial rows (reduce_partials_kernel).
constexpr int kReduceX = 32;      // outputs per block, one per lane
constexpr int kReduceY = 8;       // rows of a slice summed at once
constexpr int kReduceSlices = 8;  // slices of the partial rows

// The fold of a block (see FOLDS in the header).
__device__ __forceinline__ size_t fold_index() { return blockIdx.z; }

constexpr float kInvSqrt2 = 0.70710678118654752440f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kActRelu) return v < 0.0f ? 0.0f : v;  // keeps NaN, as torch
  return 0.5f * v * (1.0f + erff(v * kInvSqrt2));
}

// d act / dz. ReLU'(0) = 0 (and 0 for NaN), as torch and JAX.
__device__ __forceinline__ float activate_grad(float v, int act) {
  if (act == kActRelu) return v > 0.0f ? 1.0f : 0.0f;
  return 0.5f * (1.0f + erff(v * kInvSqrt2)) + v * kInvSqrt2Pi * expf(-0.5f * v * v);
}

// Zeroes the halo rows and copies the tile's windows into shared memory:
// window wi occupies xs[wi * row_elems ...], frame t at row t + pad.
__device__ __forceinline__ void stage_windows(const float* __restrict__ x, float* xs,
                                              int b0, int nwin, int t_in, int cin,
                                              int pad) {
  const int row_elems = (t_in + 2 * pad) * cin;
  const int win_elems = t_in * cin;
  const int halo = pad * cin;
  for (int e = threadIdx.x; e < nwin * 2 * halo; e += blockDim.x) {
    const int wi = e / (2 * halo);
    const int r = e - wi * 2 * halo;
    xs[wi * row_elems + (r < halo ? r : halo + win_elems + (r - halo))] = 0.0f;
  }
  // The tile's windows are contiguous in device memory: coalesced reads.
  const float* xg = x + static_cast<size_t>(b0) * win_elems;
  for (int e = threadIdx.x; e < nwin * win_elems; e += blockDim.x) {
    const int wi = e / win_elems;
    xs[wi * row_elems + halo + (e - wi * win_elems)] = xg[e];
  }
}

// The warp_tile variant's sizes.
constexpr int kTileT = 64;
constexpr int kTileCout = 16;
constexpr int kTileK = 3;
constexpr int kTileTout = 8;
constexpr int kTileBin = kTileT / kTileTout;     // frames a bin
constexpr int kTileRow = 12;                     // a bin's row: halo, 8 frames, halo, 2 unused
constexpr int kTilePitch = kTileTout * kTileRow + 4;  // one channel of a window, in floats
constexpr int kTileWarps = 4;                    // windows (one a warp) a block
constexpr int kTileThreads = kTileWarps * 32;

enum Variant { kWarpTile = 0, kGeneric = 1, kWide = 2, kPerFrame = 3 };
enum BackwardVariant { kBwdGeneric = 0, kBwdWide = 1 };

bool tile_sizes(int t_in, int cin, int cout, int k, int t_out) {
  return t_in == kTileT && cout == kTileCout && k == kTileK && t_out == kTileTout &&
         (cin == 12 || cin == 16 || cin == 36);
}

// One window a warp. Shared memory: w as (K, CIN, 16), then each warp's
// window channel-major, xs[ci * kTilePitch + bin * kTileRow + f] = x[8 bin - 1
// + f, ci] for f = 0..9 (zero outside the window).
template <int CIN, int ACT>
__global__ void __launch_bounds__(kTileThreads)
stream_block_tile_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ b, float* __restrict__ out, int batch) {
  extern __shared__ float4 smem_tile[];
  float* ws = reinterpret_cast<float*>(smem_tile);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int win = blockIdx.x * kTileWarps + warp;
  float* xw = ws + kTileK * CIN * kTileCout + warp * CIN * kTilePitch;
  x += fold_index() * batch * kTileT * CIN;
  w += fold_index() * kTileK * CIN * kTileCout;
  b += fold_index() * kTileCout;
  out += fold_index() * batch * kTileTout * kTileCout;

  for (int e = threadIdx.x; e < kTileK * CIN * kTileCout; e += kTileThreads) ws[e] = w[e];
  if (win < batch) {
    for (int ci = lane; ci < CIN; ci += 32) {
      xw[ci * kTilePitch] = 0.0f;  // frame -1
      xw[ci * kTilePitch + (kTileTout - 1) * kTileRow + kTileBin + 1] = 0.0f;  // frame T
    }
    // The window is contiguous in device memory: each load of the warp reads
    // 128 consecutive bytes.
    const float* xg = x + static_cast<size_t>(win) * kTileT * CIN;
#pragma unroll 8
    for (int q = 0; q < kTileT * CIN / 32; ++q) {
      const int e = q * 32 + lane;
      const float v = xg[e];
      const int t = e / CIN, ci = e - t * CIN;
      const int bin = t / kTileBin, f = t - bin * kTileBin + 1;
      float* row = xw + ci * kTilePitch + bin * kTileRow;
      row[f] = v;
      if (f == kTileBin && bin + 1 < kTileTout) row[kTileRow] = v;  // next bin's halo
      if (f == 1 && bin > 0) row[kTileBin + 1 - kTileRow] = v;      // previous bin's halo
    }
  }
  __syncthreads();
  if (win >= batch) return;

  const int bin = lane >> 2, cg = lane & 3;
  float acc[kTileBin][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float bias = b[cg * 4 + c];
#pragma unroll
    for (int j = 0; j < kTileBin; ++j) acc[j][c] = bias;
  }
  const float* xr = xw + bin * kTileRow;
  const float4* w4 = reinterpret_cast<const float4*>(ws) + cg;  // w[i, ci, 4 cg ..]
#pragma unroll 4
  for (int ci = 0; ci < CIN; ++ci) {
    const float* r = xr + ci * kTilePitch;
    const float4 lo = *reinterpret_cast<const float4*>(r);
    const float4 mid = *reinterpret_cast<const float4*>(r + 4);
    const float2 hi = *reinterpret_cast<const float2*>(r + 8);
    const float xv[kTileBin + 2] = {lo.x, lo.y, lo.z, lo.w, mid.x, mid.y, mid.z, mid.w,
                                    hi.x, hi.y};
#pragma unroll
    for (int i = 0; i < kTileK; ++i) {
      const float4 wv = w4[(i * CIN + ci) * (kTileCout / 4)];
#pragma unroll
      for (int j = 0; j < kTileBin; ++j) {
        // output frame 8 bin + j reads frame 8 bin + j - 1 + i, at f = j + i
        acc[j][0] = fmaf(xv[j + i], wv.x, acc[j][0]);
        acc[j][1] = fmaf(xv[j + i], wv.y, acc[j][1]);
        acc[j][2] = fmaf(xv[j + i], wv.z, acc[j][2]);
        acc[j][3] = fmaf(xv[j + i], wv.w, acc[j][3]);
      }
    }
  }
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < kTileBin; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] += activate(acc[j][c], ACT);
  }
  constexpr float n = static_cast<float>(kTileBin);
  reinterpret_cast<float4*>(out)[(static_cast<size_t>(win) * kTileTout + bin) * 4 + cg] =
      make_float4(s[0] / n, s[1] / n, s[2] / n, s[3] / n);
}

__global__ void __launch_bounds__(kThreads)
stream_block_generic_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ out,
                    int batch, int t_in, int cin, int cout, int k, int t_out,
                    int act, int tile) {
  extern __shared__ float smem[];
  const int pad = k / 2;
  const int row_elems = (t_in + k - 1) * cin;  // one padded window
  const int taps = k * cin;                    // contiguous inputs per output
  float* xs = smem;                            // tile * row_elems
  float* ws = xs + tile * row_elems;           // (K*Cin, Cout)
  float* bs = ws + taps * cout;                // Cout

  const int b0 = blockIdx.x * tile;
  const int nwin = min(tile, batch - b0);
  x += fold_index() * batch * t_in * cin;
  w += fold_index() * taps * cout;
  b += fold_index() * cout;
  out += fold_index() * batch * t_out * cout;

  for (int e = threadIdx.x; e < taps * cout; e += blockDim.x) ws[e] = w[e];
  for (int e = threadIdx.x; e < cout; e += blockDim.x) bs[e] = b[e];
  stage_windows(x, xs, b0, nwin, t_in, cin, pad);
  __syncthreads();

  // Consecutive threads take consecutive c_out: coalesced writes, and the
  // weight reads of a warp fall on distinct banks.
  const int per_win = t_out * cout;
  for (int o = threadIdx.x; o < nwin * per_win; o += blockDim.x) {
    const int wi = o / per_win;
    const int r = o - wi * per_win;
    const int bin = r / cout;
    const int co = r - bin * cout;
    const int start = (bin * t_in) / t_out;
    const int end = ((bin + 1) * t_in + t_out - 1) / t_out;
    const float* xw = xs + wi * row_elems;
    float sum = 0.0f;
    for (int t = start; t < end; ++t) {
      // output frame t reads padded rows t .. t+K-1, i.e. frames t-pad .. t+pad
      const float* xr = xw + t * cin;
      float acc = bs[co];
      for (int j = 0; j < taps; ++j) acc = fmaf(xr[j], ws[j * cout + co], acc);
      sum += activate(acc, act);
    }
    out[static_cast<size_t>(b0 + wi) * per_win + r] = sum / static_cast<float>(end - start);
  }
}

// ---------------------------------------------------------------------------
// The wide variants: warp_tile's T, C_out, K and t_out, any C_in, streamed
// through shared memory kWideChunk channels at a time with cp.async, two
// buffers (the next chunk's copies run under this chunk's FMAs).

constexpr int kWideChunk = 32;                   // input channels staged at a time
constexpr int kWideRows = kTileT + kTileK - 1;   // padded frames of a window
constexpr int kWideWarps = 8;
constexpr int kWideThreads = kWideWarps * 32;
// Padded frame r of a window starts at r * row + 4 * (r / 8): the extra 16
// bytes every 8 frames put the rows that lanes of neighbouring bins read at
// once (8 frames apart) on distinct banks.
constexpr int kWideXWin = kWideRows * kWideChunk + 4 * ((kWideRows - 1) >> 3);  // one window of x
constexpr int kWideZWin = kWideRows * kTileCout + 4 * ((kWideRows - 1) >> 3);   // one window of g_z
// Row R = tap * kWideChunk + channel of a chunk of w starts at R * 16 + 4 * (R / 4),
// so that the 4 channel quads a warp reads at once lie on distinct banks.
constexpr int kWideWRows = kTileK * kWideChunk;
constexpr int kWideWSize = kWideWRows * kTileCout + 4 * (kWideWRows >> 2);
constexpr int kWideOut = kWideWRows * kTileCout + kTileCout;  // a chunk's gw, then gb

__device__ __forceinline__ int wide_xrow(int r) { return r * kWideChunk + 4 * (r >> 3); }
__device__ __forceinline__ int wide_zrow(int r) { return r * kTileCout + 4 * (r >> 3); }
__device__ __forceinline__ int wide_wrow(int r) { return r * kTileCout + 4 * (r >> 2); }

__device__ __forceinline__ float component(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Asynchronous copies global -> shared of 4 or 16 bytes; with `full` false
// the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// VEC floats at a time: 4 where C_in is a multiple of 4 and x and w lie on
// 16 bytes, else 1.
template <int VEC>
__device__ __forceinline__ void cp_async_vec(float* dst, const float* src, bool full) {
  if (VEC == 4) {
    cp_async16(dst, src, full);
  } else {
    cp_async4(dst, src, full);
  }
}

// ---------------------------------------------------------------------------
// The per_frame variant: one window a block; each conv output computed once,
// kept in shared memory, then pooled (see the header).

// At most 8 warps a block: FoG's 404 items a window in 416 threads held 3
// blocks an SM (registers), so 512 windows took 1.3 waves; at 256 threads a
// thread takes one or two items and they fit in one (0.0090 against 0.0073
// ms from a CUDA graph, H100 80GB HBM3 at 700 W).
constexpr int kFrameMaxThreads = 256;

// Shared memory of a per_frame block, in floats from its start: x (T + K - 1
// padded frames of `stride` floats), w (K, cin4, cout4), b (cout4), y (T,
// cout4). C_in and C_out are padded to multiples of 4 with zeros; a frame's
// stride is an odd number of float4, so that the 8 frames a quarter warp
// reads 16 bytes of at once lie on distinct banks.
struct FrameLayout {
  long long cin4, cout4, stride, w, b, y, floats;
  __host__ __device__ FrameLayout(int t_in, int cin, int cout, int k) {
    cin4 = (cin + 3LL) / 4 * 4;
    cout4 = (cout + 3LL) / 4 * 4;
    stride = (cin4 / 4) % 2 == 1 ? cin4 : cin4 + 4;
    w = (t_in + k - 1LL) * stride;
    b = w + k * cin4 * cout4;
    y = b + cout4;
    floats = y + static_cast<long long>(t_in) * cout4;
  }
};

template <int VEC, int ACT>
__global__ void __launch_bounds__(kFrameMaxThreads)
stream_block_frame_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ b, float* __restrict__ out, int t_in,
                          int cin, int cout, int k, int t_out) {
  extern __shared__ float4 smem_frame[];
  const FrameLayout L(t_in, cin, cout, k);
  const int cin4 = static_cast<int>(L.cin4), cout4 = static_cast<int>(L.cout4);
  const int stride = static_cast<int>(L.stride);
  float* xs = reinterpret_cast<float*>(smem_frame);
  float* ws = xs + L.w;
  float* bs = xs + L.b;
  float* ys = xs + L.y;
  const int pad = k / 2;
  const size_t win = fold_index() * gridDim.x + blockIdx.x;  // a block a window of the fold
  w += fold_index() * k * cin * cout;
  b += fold_index() * cout;

  // padded frame r holds frame r - pad: zero outside the window and beyond C_in
  const float* xg = x + win * t_in * cin;
  const int per_row = cin4 / VEC;
  for (int e = threadIdx.x; e < (t_in + k - 1) * per_row; e += blockDim.x) {
    const int r = e / per_row, c = (e - r * per_row) * VEC;
    const int f = r - pad;
    const bool full = f >= 0 && f < t_in && c < cin;
    cp_async_vec<VEC>(xs + r * stride + c, full ? xg + static_cast<size_t>(f) * cin + c : x, full);
  }
  cp_async_commit();
  for (int e = threadIdx.x; e < k * cin4 * cout4; e += blockDim.x) {
    const int co = e % cout4, r = e / cout4;  // r = tap * cin4 + channel
    const int i = r / cin4, ci = r - i * cin4;
    ws[e] = ci < cin && co < cout ? w[(static_cast<size_t>(i) * cin + ci) * cout + co] : 0.0f;
  }
  for (int e = threadIdx.x; e < cout4; e += blockDim.x) bs[e] = e < cout ? b[e] : 0.0f;
  cp_async_wait<0>();
  __syncthreads();

  // z[t, 4q .. 4q + 3], once: per 4 channels one float4 of x and four of w
  // (the same for the threads of a q: a broadcast) for 16 FMAs, taps in the
  // order tap-major, channel-minor
  const int quads = cout4 / 4;
  for (int item = threadIdx.x; item < t_in * quads; item += blockDim.x) {
    const int t = item / quads, q = item - t * quads;
    float4 acc = reinterpret_cast<const float4*>(bs)[q];
    for (int i = 0; i < k; ++i) {
      const float4* xr = reinterpret_cast<const float4*>(xs + (t + i) * stride);
      const float4* wr = reinterpret_cast<const float4*>(ws + i * cin4 * cout4) + q;
#pragma unroll 2
      for (int c = 0; c < cin4 / 4; ++c) {
        const float4 xv = xr[c];
        const float xc[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 wv = wr[(4 * c + j) * quads];
          acc.x = fmaf(xc[j], wv.x, acc.x);
          acc.y = fmaf(xc[j], wv.y, acc.y);
          acc.z = fmaf(xc[j], wv.z, acc.z);
          acc.w = fmaf(xc[j], wv.w, acc.w);
        }
      }
    }
    reinterpret_cast<float4*>(ys)[item] =
        make_float4(activate(acc.x, ACT), activate(acc.y, ACT), activate(acc.z, ACT),
                    activate(acc.w, ACT));
  }
  __syncthreads();

  // each (bin, c_out): its frames in ascending order, over the bin's length;
  // consecutive threads on consecutive c_out, so the writes coalesce
  for (int o = threadIdx.x; o < t_out * cout; o += blockDim.x) {
    const int bin = o / cout, co = o - bin * cout;
    const int start = (bin * t_in) / t_out;
    const int end = ((bin + 1) * t_in + t_out - 1) / t_out;
    float sum = 0.0f;
    for (int t = start; t < end; ++t) sum += ys[t * cout4 + co];
    out[win * t_out * cout + o] = sum / static_cast<float>(end - start);
  }
}

// Channels [c0, c0 + kWideChunk) of windows b0 .. b0 + nwin - 1 into xs
// (window i at i * kWideXWin), zero outside the window and beyond C_in.
template <int VEC>
__device__ __forceinline__ void wide_stage_x(const float* __restrict__ x, float* xs, int b0,
                                             int nwin, int cin, int c0) {
  constexpr int kPerRow = kWideChunk / VEC;
  for (int e = threadIdx.x; e < nwin * kWideRows * kPerRow; e += blockDim.x) {
    const int j = (e % kPerRow) * VEC, rw = e / kPerRow;
    const int wi = rw / kWideRows, r = rw - wi * kWideRows;
    const int f = r - 1, ci = c0 + j;
    const bool full = f >= 0 && f < kTileT && ci < cin;
    const float* src = full ? x + (static_cast<size_t>(b0 + wi) * kTileT + f) * cin + ci : x;
    cp_async_vec<VEC>(xs + wi * kWideXWin + wide_xrow(r) + j, src, full);
  }
}

// Channels [c0, c0 + kWideChunk) of w (K, C_in, 16), zero beyond C_in.
template <int VEC>
__device__ __forceinline__ void wide_stage_w(const float* __restrict__ w, float* ws, int cin,
                                             int c0) {
  constexpr int kPerRow = kTileCout / VEC;
  for (int e = threadIdx.x; e < kWideWRows * kPerRow; e += blockDim.x) {
    const int co = (e % kPerRow) * VEC, r = e / kPerRow;
    const int i = r / kWideChunk, ci = c0 + r - i * kWideChunk;
    const bool full = ci < cin;
    const float* src = full ? w + (static_cast<size_t>(i) * cin + ci) * kTileCout + co : w;
    cp_async_vec<VEC>(ws + wide_wrow(r) + co, src, full);
  }
}

// g_z (B, T, 16) of windows b0 .. b0 + nwin - 1 into zs, with a zero frame
// on each side.
__device__ __forceinline__ void wide_stage_gz(const float* __restrict__ gz, float* zs, int b0,
                                              int nwin) {
  for (int e = threadIdx.x; e < nwin * kWideRows * 4; e += blockDim.x) {
    const int q = e & 3, rw = e >> 2;
    const int wi = rw / kWideRows, r = rw - wi * kWideRows;
    const int f = r - 1;
    const bool full = f >= 0 && f < kTileT;
    const float* src =
        full ? gz + (static_cast<size_t>(b0 + wi) * kTileT + f) * kTileCout + 4 * q : gz;
    cp_async16(zs + wi * kWideZWin + wide_zrow(r) + 4 * q, src, full);
  }
}

enum WideMode { kWideForward = 0, kWideGradZ = 1 };

// The conv kernel's buffers: two (16-channel chunks, and 3 or 4 buffers,
// measured slower on the H100 at FOCAL's shape).
constexpr int kConvStages = 2;

// Shared memory of the wide conv kernel at `windows` windows a block: its
// buffers of x and w, or the splits' sums at the end, whichever is larger.
size_t wide_conv_smem(int windows) {
  const size_t staged = kConvStages * static_cast<size_t>(windows * kWideXWin + kWideWSize);
  const size_t sums = static_cast<size_t>(kWideWarps - windows) * 32 * 32;
  return (staged > sums ? staged : sums) * sizeof(float);
}

// The conv of `windows` windows a block, each on kWideWarps / windows warps
// (its splits), which take the channel quads of every chunk in turn. Lane =
// (bin, group of 4 c_out) as in warp_tile: the 8 frames x 4 c_out of its bin
// in 32 registers; per channel quad it reads 10 float4 of x and, per channel
// and tap, one float4 of w, for 384 FMAs. The splits' sums meet in shared
// memory, in split order. Then, by MODE: the pooled activation (B, 8, 16)
// into out; or, for the cotangent g (B, 8, 16), g_z = g_y * act'(z)
// (B, 64, 16) into out.
template <int ACT, int MODE, int VEC>
__global__ void __launch_bounds__(kWideThreads, 2)
stream_block_wide_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ b, const float* __restrict__ g,
                         float* __restrict__ out, int batch, int cin, int windows) {
  extern __shared__ float4 smem_wide[];
  float* smem = reinterpret_cast<float*>(smem_wide);
  const int splits = kWideWarps / windows;
  const int stage = windows * kWideXWin + kWideWSize;  // one buffer: x, then w
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wi = warp / splits, s = warp - wi * splits;
  const int b0 = blockIdx.x * windows;
  const int nwin = min(windows, batch - b0);
  const int bin = lane >> 2, cg = lane & 3;
  const int nchunks = (cin + kWideChunk - 1) / kWideChunk;
  x += fold_index() * batch * kTileT * cin;
  w += fold_index() * kTileK * cin * kTileCout;
  b += fold_index() * kTileCout;
  if (MODE == kWideGradZ) g += fold_index() * batch * kTileTout * kTileCout;
  out += fold_index() * batch * (MODE == kWideForward ? kTileTout : kTileT) * kTileCout;

  float acc[kTileBin][4];
#pragma unroll
  for (int j = 0; j < kTileBin; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;
  }
  // one commit group a chunk (empty past the last), so that waiting for all
  // but the newest kConvStages - 1 groups waits for chunk c
  auto stage_chunk = [&](int c) {
    if (c < nchunks) {
      float* buf = smem + (c % kConvStages) * stage;
      wide_stage_x<VEC>(x, buf, b0, nwin, cin, c * kWideChunk);
      wide_stage_w<VEC>(w, buf + windows * kWideXWin, cin, c * kWideChunk);
    }
    cp_async_commit();
  };
  for (int c = 0; c < kConvStages - 1; ++c) stage_chunk(c);
  for (int c = 0; c < nchunks; ++c) {
    stage_chunk(c + kConvStages - 1);
    cp_async_wait<kConvStages - 1>();
    __syncthreads();
    if (wi < nwin) {
      const float* xw = smem + (c % kConvStages) * stage + wi * kWideXWin + wide_xrow(kTileBin * bin);
      const float* ws = smem + (c % kConvStages) * stage + windows * kWideXWin;
      const int nq = (min(kWideChunk, cin - c * kWideChunk) + 3) >> 2;
      for (int q = s; q < nq; q += splits) {
        // padded rows 8 bin .. 8 bin + 9; wide_xrow(8 bin + i) - wide_xrow(8 bin)
        // = wide_xrow(i)
        float4 xv[kTileBin + 2];
#pragma unroll
        for (int i = 0; i < kTileBin + 2; ++i) {
          xv[i] = *reinterpret_cast<const float4*>(xw + wide_xrow(i) + 4 * q);
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
          for (int tap = 0; tap < kTileK; ++tap) {
            const float4 wv = *reinterpret_cast<const float4*>(
                ws + wide_wrow(tap * kWideChunk + 4 * q + cc) + 4 * cg);
#pragma unroll
            for (int j = 0; j < kTileBin; ++j) {
              // output frame 8 bin + j reads padded row 8 bin + j + tap
              const float xs = component(xv[j + tap], cc);
              acc[j][0] = fmaf(xs, wv.x, acc[j][0]);
              acc[j][1] = fmaf(xs, wv.y, acc[j][1]);
              acc[j][2] = fmaf(xs, wv.z, acc[j][2]);
              acc[j][3] = fmaf(xs, wv.w, acc[j][3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  if (splits > 1) {  // the staging buffers are no longer read
    if (s > 0 && wi < nwin) {
      float* red = smem + ((wi * (splits - 1) + s - 1) * 32) * 32 + lane;
#pragma unroll
      for (int j = 0; j < kTileBin; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) red[(j * 4 + c) * 32] = acc[j][c];
      }
    }
    __syncthreads();
    if (s == 0 && wi < nwin) {
      for (int o = 1; o < splits; ++o) {
        const float* part = smem + ((wi * (splits - 1) + o - 1) * 32) * 32 + lane;
#pragma unroll
        for (int j = 0; j < kTileBin; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][c] += part[(j * 4 + c) * 32];
        }
      }
    }
  }
  if (s != 0 || wi >= nwin) return;
  const int win = b0 + wi;
  const float bv[4] = {b[4 * cg], b[4 * cg + 1], b[4 * cg + 2], b[4 * cg + 3]};
  if (MODE == kWideForward) {
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kTileBin; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[c] += activate(acc[j][c] + bv[c], ACT);
    }
    constexpr float n = static_cast<float>(kTileBin);
    reinterpret_cast<float4*>(out)[(static_cast<size_t>(win) * kTileTout + bin) * 4 + cg] =
        make_float4(sum[0] / n, sum[1] / n, sum[2] / n, sum[3] / n);
  } else {
    // every frame lies in one bin of 8 frames: g_y = g[bin] / 8
    const float* gv = g + (static_cast<size_t>(win) * kTileTout + bin) * kTileCout + 4 * cg;
    constexpr float inv = 1.0f / static_cast<float>(kTileBin);
    const float gy[4] = {gv[0] * inv, gv[1] * inv, gv[2] * inv, gv[3] * inv};
    float4* gz = reinterpret_cast<float4*>(out) +
                 (static_cast<size_t>(win) * kTileT + kTileBin * bin) * 4 + cg;
#pragma unroll
    for (int j = 0; j < kTileBin; ++j) {
      gz[j * 4] = make_float4(gy[0] * activate_grad(acc[j][0] + bv[0], ACT),
                              gy[1] * activate_grad(acc[j][1] + bv[1], ACT),
                              gy[2] * activate_grad(acc[j][2] + bv[2], ACT),
                              gy[3] * activate_grad(acc[j][3] + bv[3], ACT));
    }
  }
}

// A barrier of the whole block that its threads may reach from different
// code: barrier.sync without .aligned (__syncthreads compiles to the
// .aligned form, which requires every thread of a warp, and the whole
// block, to run the same barrier instruction).
__device__ __forceinline__ void block_barrier() { asm volatile("barrier.sync 0;\n" ::: "memory"); }

constexpr int kWideGradWindows = kWideWarps / 2;  // a round: a gx warp and a gw warp a window
constexpr size_t kWideGradSmem =
    (kWideWSize + 2 * static_cast<size_t>(kWideGradWindows) * (kWideXWin + kWideZWin)) *
    sizeof(float);

// gx and gw of the wide backward, from g_z (B, 64, 16). Block (range,
// chunk) takes channels [32 chunk, 32 chunk + 32) of the windows of its
// range, 4 at a time, staged with their g_z while the previous 4 are
// computed; each window has two warps. Its gx warp computes the window's gx
// for the chunk (lane = (8 frames, channel quad), 32 accumulators; per c_out
// quad 10 float4 of g_z and 12 of w for 384 FMAs) and writes it. Its gw warp
// adds the window's gw into its register tile (lane = (channel quad, c_out
// quad), 3 taps x 4 x 4 = 48 accumulators; per frame one float4 of x and one
// of g_z for 48 FMAs) and gb into 4 more: gx and gw are as many FMAs. At the
// end the gw warps' tiles are added in window-slot order through shared
// memory into the range's row of `partial` (gw's entries of the chunk; gb
// by the chunk-0 block).
template <int VEC>
__global__ void __launch_bounds__(kWideThreads, 2)
stream_block_wide_grad_kernel(const float* __restrict__ x, const float* __restrict__ w,
                              const float* __restrict__ gz, float* __restrict__ gx,
                              float* __restrict__ partial, int batch, int cin, int ranges) {
  extern __shared__ float4 smem_wide[];
  float* ws = reinterpret_cast<float*>(smem_wide);  // kWideWSize: the chunk of w
  float* bufs = ws + kWideWSize;                    // two buffers: x, then g_z, of 4 windows
  constexpr int kStage = kWideGradWindows * (kWideXWin + kWideZWin);
  const int nchunks = (cin + kWideChunk - 1) / kWideChunk;
  const int range = blockIdx.x / nchunks, chunk = blockIdx.x - range * nchunks;
  const int c0 = chunk * kWideChunk;
  x += fold_index() * batch * kTileT * cin;
  w += fold_index() * kTileK * cin * kTileCout;
  gz += fold_index() * batch * kTileT * kTileCout;
  gx += fold_index() * batch * kTileT * cin;
  partial += fold_index() * (ranges + kReduceSlices) * (kTileK * cin * kTileCout + kTileCout);
  const int wb0 = static_cast<int>(static_cast<long long>(range) * batch / ranges);
  const int wb1 = static_cast<int>(static_cast<long long>(range + 1) * batch / ranges);
  const int rounds = (wb1 - wb0 + kWideGradWindows - 1) / kWideGradWindows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // warps w and w + 4 share a window and a scheduler: each of the SM's four
  // schedulers runs gx and gw warps both
  const int slot = warp & (kWideGradWindows - 1);  // the window of the round
  const bool gw_warp = warp >= kWideGradWindows;
  const int hi = lane >> 2, lo = lane & 3;  // gx: (frames 8 hi .., quad lo); gw: (quad hi, c_out quad lo)

  auto stage_round = [&](int rd) {
    float* buf = bufs + (rd & 1) * kStage;
    const int r0 = wb0 + rd * kWideGradWindows, n = min(kWideGradWindows, wb1 - r0);
    wide_stage_x<VEC>(x, buf, r0, n, cin, c0);
    wide_stage_gz(gz, buf + kWideGradWindows * kWideXWin, r0, n);
    cp_async_commit();
  };
  // Round rd's data in buffer rd & 1, the next round's copies under way.
  // Every thread stages; both kinds of warp, each in a loop of its own, pass
  // the same block_barrier()s: two a round.
  auto begin_round = [&](int rd) {
    if (rd + 1 < rounds) {
      stage_round(rd + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    block_barrier();
  };
  wide_stage_w<VEC>(w, ws, cin, c0);  // committed with round 0
  stage_round(0);
  if (rounds == 0) cp_async_wait<0>();

  float* red = bufs;  // the gw warps' tiles at the end (the staging buffers are no longer read)
  if (gw_warp) {
    float gw_acc[kTileK][4][4];
    float gb_acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kTileK; ++i) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int co = 0; co < 4; ++co) gw_acc[i][cc][co] = 0.0f;
      }
    }
    for (int rd = 0; rd < rounds; ++rd) {
      begin_round(rd);
      if (wb0 + rd * kWideGradWindows + slot < wb1) {
        // gw[tap, ci, co] += sum_t xp[t + tap, ci] g_z[t, co], padded x row
        // t + tap, padded g_z row t + 1; gb[co] += sum_t g_z[t, co]
        const float* xw = bufs + (rd & 1) * kStage + slot * kWideXWin;
        const float* zw =
            bufs + (rd & 1) * kStage + kWideGradWindows * kWideXWin + slot * kWideZWin;
        float4 x0 = *reinterpret_cast<const float4*>(xw + wide_xrow(0) + 4 * hi);
        float4 x1 = *reinterpret_cast<const float4*>(xw + wide_xrow(1) + 4 * hi);
#pragma unroll 2
        for (int t = 0; t < kTileT; ++t) {
          const float4 x2 = *reinterpret_cast<const float4*>(xw + wide_xrow(t + 2) + 4 * hi);
          const float4 z = *reinterpret_cast<const float4*>(zw + wide_zrow(t + 1) + 4 * lo);
          const float4 xt[3] = {x0, x1, x2};
          const float zc[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
          for (int tap = 0; tap < kTileK; ++tap) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const float xs = component(xt[tap], cc);
#pragma unroll
              for (int co = 0; co < 4; ++co) {
                gw_acc[tap][cc][co] = fmaf(xs, zc[co], gw_acc[tap][cc][co]);
              }
            }
          }
          if (chunk == 0) {
#pragma unroll
            for (int co = 0; co < 4; ++co) gb_acc[co] += zc[co];
          }
          x0 = x1;
          x1 = x2;
        }
      }
      block_barrier();
    }
#pragma unroll
    for (int tap = 0; tap < kTileK; ++tap) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int co = 0; co < 4; ++co) {
          red[slot * kWideOut + (tap * kWideChunk + 4 * hi + cc) * kTileCout + 4 * lo + co] =
              gw_acc[tap][cc][co];
        }
      }
    }
    if (hi == 0) {
#pragma unroll
      for (int co = 0; co < 4; ++co) {
        red[slot * kWideOut + kWideWRows * kTileCout + 4 * lo + co] = gb_acc[co];
      }
    }
  } else {
    for (int rd = 0; rd < rounds; ++rd) {
      begin_round(rd);
      const int win = wb0 + rd * kWideGradWindows + slot;
      const float* zw =
          bufs + (rd & 1) * kStage + kWideGradWindows * kWideXWin + slot * kWideZWin;
      // gx[f, ci] = sum_tap sum_co g_z[f + 1 - tap, co] w[tap, ci, co]: padded
      // g_z row f + 2 - tap, for frame f = 8 hi + j at index j + 2 - tap
      for (int h = 0; h < 2 && win < wb1 && c0 + 16 * h < cin; ++h) {
        const int q = 4 * h + lo;
        float a[kTileBin][4];
#pragma unroll
        for (int j = 0; j < kTileBin; ++j) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) a[j][cc] = 0.0f;
        }
#pragma unroll 1
        for (int cq = 0; cq < 4; ++cq) {
          float4 zv[kTileBin + 2];
#pragma unroll
          for (int i = 0; i < kTileBin + 2; ++i) {
            zv[i] = *reinterpret_cast<const float4*>(zw + wide_zrow(kTileBin * hi + i) + 4 * cq);
          }
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
            for (int tap = 0; tap < kTileK; ++tap) {
              const float4 wv = *reinterpret_cast<const float4*>(
                  ws + wide_wrow(tap * kWideChunk + 4 * q + cc) + 4 * cq);
#pragma unroll
              for (int j = 0; j < kTileBin; ++j) {
                const float4 z = zv[j + 2 - tap];
                a[j][cc] = fmaf(z.x, wv.x, a[j][cc]);
                a[j][cc] = fmaf(z.y, wv.y, a[j][cc]);
                a[j][cc] = fmaf(z.z, wv.z, a[j][cc]);
                a[j][cc] = fmaf(z.w, wv.w, a[j][cc]);
              }
            }
          }
        }
        float* out = gx + (static_cast<size_t>(win) * kTileT + kTileBin * hi) * cin + c0 + 4 * q;
        if (VEC == 4) {  // C_in a multiple of 4: the quad lies on 16 bytes, in or out of C_in
#pragma unroll
          for (int j = 0; j < kTileBin && c0 + 4 * q < cin; ++j) {
            *reinterpret_cast<float4*>(out + j * cin) = make_float4(a[j][0], a[j][1], a[j][2], a[j][3]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < kTileBin; ++j) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              if (c0 + 4 * q + cc < cin) out[j * cin + cc] = a[j][cc];
            }
          }
        }
      }
      block_barrier();
    }
  }
  __syncthreads();
  const int nw = kTileK * cin * kTileCout;
  float* row = partial + static_cast<size_t>(range) * (nw + kTileCout);
  for (int e = threadIdx.x; e < kWideOut; e += blockDim.x) {
    float sum = red[e];
    for (int p = 1; p < kWideGradWindows; ++p) sum += red[p * kWideOut + e];
    if (e < kWideWRows * kTileCout) {
      const int r = e / kTileCout, co = e - r * kTileCout;
      const int tap = r / kWideChunk, ci = c0 + r - tap * kWideChunk;
      if (ci < cin) row[(static_cast<size_t>(tap) * cin + ci) * kTileCout + co] = sum;
    } else if (chunk == 0) {
      row[nw + e - kWideWRows * kTileCout] = sum;
    }
  }
}

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// Sizes of the backward's shared memory, in floats unless said otherwise.
// Cin and Cout are padded to cip, cop (multiples of 4); taps = K * cip.
struct BwdLayout {
  int cip, cop, taps;
  int rx;      // one window of x: (T + K - 1) padded frames of cip
  int rz;      // one window of g_z: (T + 2 * pad) padded frames of cop
  int ntiles;  // 4 x 4 output tiles of gw and gb: (taps / 4 + 1) * cop / 4
  int groups;  // thread groups that split the (window, frame) steps
  int work;    // x and g_z of the tile (one spare g_z row), or the groups' sums
  size_t bytes;

  __host__ __device__ BwdLayout(int t_in, int cin, int cout, int k, int t_out, int tile) {
    const int pad = k / 2;
    cip = round4(cin);
    cop = round4(cout);
    taps = k * cip;
    rx = (t_in + k - 1) * cip;
    rz = (t_in + 2 * pad) * cop;
    ntiles = (taps / 4 + 1) * (cop / 4);
    groups = kThreads / ntiles > 1 ? kThreads / ntiles : 1;
    const int staged = tile * (rx + rz) + cop;
    const int sums = groups > 1 ? groups * (taps + 1) * cop : 0;
    work = staged > sums ? staged : sums;
    const size_t floats = 4 + static_cast<size_t>(taps) * cop + cop +
                          static_cast<size_t>(tile) * t_out * cop + work + t_out;
    const size_t ints = 2 * static_cast<size_t>(t_in) + 2 * tile + 2;
    bytes = floats * sizeof(float) + ints * sizeof(int);
  }
};

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

// Sums over the live (window, frame) steps [s0, s1) of output tile (jt, ct)
// of gw (or gb, for jt = taps / 4, against the constant 1 at one4): 16
// independent accumulators, one float4 of x and one of g_z a step.
__device__ __forceinline__ void gw_tile(float (&acc)[4][4], const float* one4, const float* xs,
                                        const float* gz, const int* live, int jt, int ct,
                                        int taps, int cip, int cop, int rx, int rz, int pad,
                                        int t_in, int s0, int s1) {
  const bool is_gb = jt == taps / 4;
  const float* xbase = is_gb ? one4 : xs + jt * 4;
  const int xwin = is_gb ? 0 : rx, xfr = is_gb ? 0 : cip;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  }
  int li = s0 / t_in, t = s0 - li * t_in;
  for (int s = s0; s < s1; ++s) {
    const int wi = live[li];
    const float4 xv = *reinterpret_cast<const float4*>(xbase + wi * xwin + t * xfr);
    const float4 zv = reinterpret_cast<const float4*>(gz + wi * rz + (t + pad) * cop)[ct];
    const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc[r][0] = fmaf(xr[r], zv.x, acc[r][0]);
      acc[r][1] = fmaf(xr[r], zv.y, acc[r][1]);
      acc[r][2] = fmaf(xr[r], zv.z, acc[r][2]);
      acc[r][3] = fmaf(xr[r], zv.w, acc[r][3]);
    }
    if (++t == t_in) {
      t = 0;
      ++li;
    }
  }
}

// One tile of windows: gx of its windows, and its partial gw (K*Cin*Cout
// values, then gb's Cout) into row blockIdx.x of `partial`.
__global__ void __launch_bounds__(kThreads)
stream_block_backward_kernel(const float* __restrict__ x, const float* __restrict__ w,
                             const float* __restrict__ b, const float* __restrict__ g,
                             float* __restrict__ gx, float* __restrict__ partial,
                             int batch, int t_in, int cin, int cout, int k, int t_out,
                             int act, int tile) {
  extern __shared__ float4 smem4[];
  const BwdLayout L(t_in, cin, cout, k, t_out, tile);
  const int pad = k / 2;
  const int cip = L.cip, cop = L.cop, taps = L.taps, rx = L.rx, rz = L.rz;
  const int nct = cop / 4;  // float4 columns of c_out
  float* one4 = reinterpret_cast<float*>(smem4);  // (1, 0, 0, 0): gb's "x"
  float* ws = one4 + 4;                           // (taps, cop): w, zero-padded
  float* bs = ws + taps * cop;                    // cop
  float* gs = bs + cop;                           // (tile, t_out, cop): g
  float* xs = gs + tile * t_out * cop;            // (tile, rx): x with its halo
  float* gz = xs + tile * rx;                     // (tile, rz) + one row: g_z
  float* red = xs;                                // the groups' sums, at the end
  float* bin_inv = xs + L.work;                   // t_out: 1 / |bin|
  int* frame_lo = reinterpret_cast<int*>(bin_inv + t_out);  // T: bins of frame t
  int* frame_hi = frame_lo + t_in;                // ... are [frame_lo, frame_hi)
  int* flags = frame_hi + t_in;                   // tile: window is live
  int* live = flags + tile;                       // tile: the live windows, in order
  int* counts = live + tile;                      // number live; every window live

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * tile;
  const int nwin = min(tile, batch - b0);
  const int nw = k * cin * cout;
  x += fold_index() * batch * t_in * cin;
  w += fold_index() * nw;
  b += fold_index() * cout;
  g += fold_index() * batch * t_out * cout;
  gx += fold_index() * batch * t_in * cin;
  float* part = partial + (fold_index() * (gridDim.x + kReduceSlices) + blockIdx.x) * (nw + cout);

  // Set-up: flags, w, b, the bins, and the zero halos.
  if (tid < tile) flags[tid] = 0;
  if (tid == 0) {
    counts[1] = 0;
    one4[0] = 1.0f;
    one4[1] = one4[2] = one4[3] = 0.0f;
  }
  __syncthreads();
  for (int e = tid; e < taps * cop; e += blockDim.x) {
    const int co = e % cop, j = e / cop;
    const int i = j / cip, ci = j - i * cip;
    const float v = (ci < cin && co < cout) ? w[(i * cin + ci) * cout + co] : 0.0f;
    if (!isfinite(v)) counts[1] = 1;
    ws[e] = v;
  }
  for (int e = tid; e < cop; e += blockDim.x) {
    const float v = e < cout ? b[e] : 0.0f;
    if (!isfinite(v)) counts[1] = 1;
    bs[e] = v;
  }
  for (int o = tid; o < t_out; o += blockDim.x) {
    const int lo = (o * t_in) / t_out, hi = ((o + 1) * t_in + t_out - 1) / t_out;
    bin_inv[o] = 1.0f / static_cast<float>(hi - lo);
  }
  for (int t = tid; t < t_in; t += blockDim.x) {
    int lo = t_out, hi = 0;
    for (int o = 0; o < t_out; ++o) {
      if (t >= (o * t_in) / t_out && t < ((o + 1) * t_in + t_out - 1) / t_out) {
        lo = min(lo, o);
        hi = o + 1;
      }
    }
    frame_lo[t] = lo;
    frame_hi[t] = hi;
  }
  for (int e = tid; e < nwin * 2 * pad * cip; e += blockDim.x) {
    const int wi = e / (2 * pad * cip), r = e - wi * 2 * pad * cip;
    xs[wi * rx + (r < pad * cip ? r : (t_in + pad) * cip + r - pad * cip)] = 0.0f;
  }
  const int hz = 2 * pad * cop;  // the halo rows of one window of g_z
  for (int e = tid; e < tile * hz; e += blockDim.x) {
    const int wi = e / hz, r = e - wi * hz;
    gz[wi * rz + (r < pad * cop ? r : (t_in + pad) * cop + r - pad * cop)] = 0.0f;
  }
  for (int e = tid; e < cop; e += blockDim.x) gz[tile * rz + e] = 0.0f;  // the spare row
  // Stage g and x, marking live windows (plain stores of 1: no race on the value).
  const float* gg = g + static_cast<size_t>(b0) * t_out * cout;
  for (int e = tid; e < nwin * t_out * cop; e += blockDim.x) {
    const int co = e % cop, wo = e / cop;  // wo = wi * t_out + o
    const float v = co < cout ? gg[wo * cout + co] : 0.0f;
    if (v != 0.0f) flags[wo / t_out] = 1;  // NaN too
    gs[e] = v;
  }
  const float* xg = x + static_cast<size_t>(b0) * t_in * cin;
  for (int e = tid; e < nwin * t_in * cip; e += blockDim.x) {
    const int ci = e % cip, wt = e / cip;  // wt = wi * T + t
    const int wi = wt / t_in, t = wt - wi * t_in;
    const float v = ci < cin ? xg[wt * cin + ci] : 0.0f;
    if (!isfinite(v)) flags[wi] = 1;
    xs[wi * rx + (t + pad) * cip + ci] = v;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int wi = 0; wi < nwin; ++wi) {
      if (counts[1] || flags[wi]) live[n++] = wi;
    }
    counts[0] = n;
  }
  __syncthreads();
  const int nlive = counts[0];
  const bool all_live = counts[1] != 0;

  // gx of the windows that are not live: exactly 0.
  const int win_elems = t_in * cin;
  float* gxb = gx + static_cast<size_t>(b0) * win_elems;
  if (nlive < nwin) {
    for (int e = tid; e < nwin * win_elems; e += blockDim.x) {
      const int wi = e / win_elems;
      if (!(all_live || flags[wi])) gxb[e] = 0.0f;
    }
  }
  if (nlive == 0) {
    for (int e = tid; e < nw + cout; e += blockDim.x) part[e] = 0.0f;
    return;
  }

  // g_z = act'(z) * g_y of the live windows, z recomputed in the forward's
  // order (bias, then the taps in turn).
  const float4* ws4 = reinterpret_cast<const float4*>(ws);
  const float4* gs4 = reinterpret_cast<const float4*>(gs);
  for (int e = tid; e < nlive * t_in * nct; e += blockDim.x) {
    const int li = e / (t_in * nct), r = e - li * (t_in * nct);
    const int t = r / nct, ct = r - t * nct;
    const int wi = live[li];
    const float* xr = xs + wi * rx + t * cip;
    float4 z = reinterpret_cast<const float4*>(bs)[ct];
    for (int j = 0; j < taps; ++j) fma4(z, xr[j], ws4[j * nct + ct]);
    float4 gy = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int o = frame_lo[t]; o < frame_hi[t]; ++o) {
      const float4 gv = gs4[(wi * t_out + o) * nct + ct];
      const float inv = bin_inv[o];
      gy.x = fmaf(gv.x, inv, gy.x);
      gy.y = fmaf(gv.y, inv, gy.y);
      gy.z = fmaf(gv.z, inv, gy.z);
      gy.w = fmaf(gv.w, inv, gy.w);
    }
    reinterpret_cast<float4*>(gz + wi * rz + (t + pad) * cop)[ct] =
        make_float4(gy.x * activate_grad(z.x, act), gy.y * activate_grad(z.y, act),
                    gy.z * activate_grad(z.z, act), gy.w * activate_grad(z.w, act));
  }
  __syncthreads();

  // gx: frame t of a window reads g_z at frames t - i + pad (padded row
  // t - i + 2 pad), i < K. A thread takes frames t, t + 1 and 4 c_in; for an
  // odd T the last thread's second frame reads the next window's halo (or
  // the spare row) and is not written.
  const int ncq = cip / 4, npair = (t_in + 1) / 2;
  for (int e = tid; e < nlive * npair * ncq; e += blockDim.x) {
    const int li = e / (npair * ncq), r = e - li * (npair * ncq);
    const int tp = r / ncq, cq = r - tp * ncq;
    const int wi = live[li], t = 2 * tp;
    float a0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, a1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < k; ++i) {
      const float4* z0 = reinterpret_cast<const float4*>(gz + wi * rz + (t - i + 2 * pad) * cop);
      const float4* z1 = z0 + nct;
      const float4* wr = ws4 + (i * cip + cq * 4) * nct;  // w[i, cq*4 + q, :] at wr + q*nct
      for (int ct = 0; ct < nct; ++ct) {
        const float4 za = z0[ct], zb = z1[ct];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 wv = wr[q * nct + ct];
          a0[q] = fmaf(za.x, wv.x, a0[q]);
          a0[q] = fmaf(za.y, wv.y, a0[q]);
          a0[q] = fmaf(za.z, wv.z, a0[q]);
          a0[q] = fmaf(za.w, wv.w, a0[q]);
          a1[q] = fmaf(zb.x, wv.x, a1[q]);
          a1[q] = fmaf(zb.y, wv.y, a1[q]);
          a1[q] = fmaf(zb.z, wv.z, a1[q]);
          a1[q] = fmaf(zb.w, wv.w, a1[q]);
        }
      }
    }
    float* out = gxb + static_cast<size_t>(wi) * win_elems + t * cin;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ci = cq * 4 + q;
      if (ci < cin) {
        out[ci] = a0[q];
        if (t + 1 < t_in) out[cin + ci] = a1[q];
      }
    }
  }

  // gw and gb: tile (jt, ct) holds taps j = 4 jt .. 4 jt + 3 (padded row
  // t + i, channel ci of x sits at xs[t * cip + j], j = i * cip + ci) and
  // c_out 4 ct .. 4 ct + 3; jt = taps / 4 is gb, against the constant 1.
  // With one group a thread writes its tiles' sums; with more, each thread
  // has one tile of one group, and the groups' sums meet in shared memory.
  const int groups = L.groups, ntiles = L.ntiles, steps = nlive * t_in;
  const int width = (taps + 1) * cop;
  float acc[4][4];
  if (groups == 1) {
    for (int tile_id = tid; tile_id < ntiles; tile_id += blockDim.x) {
      const int jt = tile_id / nct, ct = tile_id - jt * nct;
      gw_tile(acc, one4, xs, gz, live, jt, ct, taps, cip, cop, rx, rz, pad, t_in, 0, steps);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = jt * 4 + r, co = ct * 4 + c;
          const int i = j / cip, ci = j - i * cip;
          if (co >= cout) continue;
          if (jt == taps / 4) {
            if (r == 0) part[nw + co] = acc[0][c];
          } else if (ci < cin) {
            part[(i * cin + ci) * cout + co] = acc[r][c];
          }
        }
      }
    }
    return;
  }
  const bool has_item = tid < groups * ntiles;
  const int grp = tid / ntiles, tile_id = tid - grp * ntiles;
  const int jt = tile_id / nct, ct = tile_id - jt * nct;
  if (has_item) {
    gw_tile(acc, one4, xs, gz, live, jt, ct, taps, cip, cop, rx, rz, pad, t_in,
            grp * steps / groups, (grp + 1) * steps / groups);
  }
  __syncthreads();  // x and g_z are read for the last time: red may take them
  if (has_item) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (jt < taps / 4 || r == 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) red[grp * width + (jt * 4 + r) * cop + ct * 4 + c] = acc[r][c];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nw + cout; e += blockDim.x) {
    int pj = taps * cop + (e - nw);  // gb
    if (e < nw) {
      const int i = e / (cin * cout), r = e - i * cin * cout;
      const int ci = r / cout, co = r - ci * cout;
      pj = (i * cip + ci) * cop + co;
    }
    float s = red[pj];
    for (int q = 1; q < groups; ++q) s += red[q * width + pj];
    part[e] = s;
  }
}

// Sums the block rows [0, rows) of `partial` (width floats each) in
// kReduceSlices slices: slice s = blockIdx.y takes rows
// [s * rows / S, (s + 1) * rows / S); lane y of it sums rows r0 + y, r0 + y + 8,
// ... in turn, then lanes 0..7 are added in turn, into row rows + s. A fold's
// rows + kReduceSlices rows follow the previous fold's.
__global__ void __launch_bounds__(kReduceX * kReduceY)
reduce_partials_kernel(float* partial, int rows, int width) {
  __shared__ float lanes[kReduceY][kReduceX];
  partial += fold_index() * (rows + kReduceSlices) * width;
  const int e = blockIdx.x * kReduceX + threadIdx.x;
  const int s = blockIdx.y;
  const int r0 = s * rows / kReduceSlices, r1 = (s + 1) * rows / kReduceSlices;
  float acc = 0.0f;
  if (e < width) {
    for (int p = r0 + threadIdx.y; p < r1; p += kReduceY) {
      acc += partial[static_cast<size_t>(p) * width + e];
    }
  }
  lanes[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < width) {
    float sum = lanes[0][threadIdx.x];
    for (int y = 1; y < kReduceY; ++y) sum += lanes[y][threadIdx.x];
    partial[static_cast<size_t>(rows + s) * width + e] = sum;
  }
}

// Adds the kReduceSlices slice rows after the block rows in turn: gw, then gb.
__global__ void __launch_bounds__(kThreads)
reduce_slices_kernel(const float* __restrict__ partial, int rows, int nw, int ncout,
                     float* __restrict__ gw, float* __restrict__ gb) {
  const int width = nw + ncout;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= width) return;
  partial += fold_index() * (rows + kReduceSlices) * width;
  gw += fold_index() * nw;
  gb += fold_index() * ncout;
  const float* slices = partial + static_cast<size_t>(rows) * width + e;
  float sum = slices[0];
  for (int s = 1; s < kReduceSlices; ++s) sum += slices[static_cast<size_t>(s) * width];
  if (e < nw) {
    gw[e] = sum;
  } else {
    gb[e - nw] = sum;
  }
}

bool valid_sizes(int batch, int t_in, int cin, int cout, int k, int t_out, int act) {
  return batch >= 0 && t_in >= 1 && cin >= 1 && cout >= 1 && k >= 1 && k % 2 == 1 &&
         t_out >= 1 && (act == kActRelu || act == kActGelu);
}

// Folds a launch takes: the grid's z extent.
constexpr int kMaxFolds = 65535;

bool valid_folds(int folds) { return folds >= 1 && folds <= kMaxFolds; }

// Windows per block for the backward and its shared memory in bytes, or
// tile 0 if one window does not fit.
void backward_tile(int t_in, int cin, int cout, int k, int t_out, int* tile, size_t* smem) {
  int t = kBwdTileWindows;
  while (t > 1 && BwdLayout(t_in, cin, cout, k, t_out, t).bytes > kMaxSmem) t /= 2;
  *smem = BwdLayout(t_in, cin, cout, k, t_out, t).bytes;
  *tile = *smem > kMaxSmem ? 0 : t;
}

using TileKernel = void (*)(const float*, const float*, const float*, float*, int);
using WideKernel = void (*)(const float*, const float*, const float*, const float*, float*, int,
                            int, int);

template <int CIN>
TileKernel tile_kernel_for(int act) {
  return act == kActRelu ? stream_block_tile_kernel<CIN, kActRelu>
                         : stream_block_tile_kernel<CIN, kActGelu>;
}

TileKernel tile_kernel(int cin, int act) {
  switch (cin) {
    case 12: return tile_kernel_for<12>(act);
    case 16: return tile_kernel_for<16>(act);
    default: return tile_kernel_for<36>(act);
  }
}

template <int VEC>
WideKernel wide_kernel_for(int act, int mode) {
  if (mode == kWideForward) {
    return act == kActRelu ? stream_block_wide_kernel<kActRelu, kWideForward, VEC>
                           : stream_block_wide_kernel<kActGelu, kWideForward, VEC>;
  }
  return act == kActRelu ? stream_block_wide_kernel<kActRelu, kWideGradZ, VEC>
                         : stream_block_wide_kernel<kActGelu, kWideGradZ, VEC>;
}

WideKernel wide_kernel(int act, int mode, bool vec4) {
  return vec4 ? wide_kernel_for<4>(act, mode) : wide_kernel_for<1>(act, mode);
}

using WideGradKernel = void (*)(const float*, const float*, const float*, float*, float*, int,
                                int, int);
using FrameKernel = void (*)(const float*, const float*, const float*, float*, int, int, int, int,
                             int);

template <int VEC>
FrameKernel frame_kernel_for(int act) {
  return act == kActRelu ? stream_block_frame_kernel<VEC, kActRelu>
                         : stream_block_frame_kernel<VEC, kActGelu>;
}

// 16-byte copies of x where C_in is a multiple of 4 and x lies on 16 bytes
// (a launch's pointer; the configuration assumes it does), else 4-byte ones.
FrameKernel frame_kernel(int act, int cin, const float* x = nullptr) {
  return cin % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0 ? frame_kernel_for<4>(act)
                                                                 : frame_kernel_for<1>(act);
}

WideGradKernel wide_grad_kernel(bool vec4) {
  return vec4 ? stream_block_wide_grad_kernel<4> : stream_block_wide_grad_kernel<1>;
}

// The wide kernels stage 16 bytes a copy where C_in is a multiple of 4 and
// x and w lie on 16 bytes (a launch's pointers; the configuration assumes
// they do), else 4.
bool wide_vec4(int cin, const float* x = nullptr, const float* w = nullptr) {
  return cin % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0 &&
         reinterpret_cast<size_t>(w) % 16 == 0;
}

bool wide_sizes(int t_in, int cin, int cout, int k, int t_out) {
  return t_in == kTileT && cout == kTileCout && k == kTileK && t_out == kTileTout;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1) {
    cudaGetLastError();  // a failed query is not the launch's error
    return 1;
  }
  return n;
}

// Windows a block of the wide conv kernel: the most (8, 4, 2 or 1) that
// still gives every SM a block; the rest of the block's 8 warps split each
// window's channels.
int wide_windows(int batch) {
  const int sms = sm_count();
  for (int w = kWideWarps; w > 1; w /= 2) {
    if ((batch + w - 1) / w >= sms) return w;
  }
  return 1;
}

// Window ranges of the wide backward's gx/gw kernel: its blocks (two an SM,
// ranges x chunks of C_in) fill the card once, at most one range a window.
int wide_ranges(int batch, int cin) {
  const int chunks = (cin + kWideChunk - 1) / kWideChunk;
  const int r = 2 * sm_count() / chunks;
  return r < 1 ? 1 : (r > batch ? (batch > 0 ? batch : 1) : r);
}

struct ForwardLaunch {
  const void* fn;    // the kernel, for its attributes
  TileKernel tile;   // the warp_tile kernel, or null
  WideKernel wide;   // the wide kernel, or null
  FrameKernel frame; // the per_frame kernel, or null
  int threads, windows, grid;  // windows a block
  size_t smem;
};

// The forward launch of `variant` for these sizes; false if the variant does
// not take them. mode kWideGradZ: the wide backward's first kernel.
bool forward_launch(int variant, int batch, int t_in, int cin, int cout, int k, int t_out,
                    int act, ForwardLaunch* L, int mode = kWideForward,
                    bool vec4 = true, const float* x = nullptr) {
  if (!valid_sizes(batch, t_in, cin, cout, k, t_out, act)) return false;
  L->tile = nullptr;
  L->wide = nullptr;
  L->frame = nullptr;
  if (variant == kWarpTile) {
    if (!tile_sizes(t_in, cin, cout, k, t_out)) return false;
    L->tile = tile_kernel(cin, act);
    L->fn = reinterpret_cast<const void*>(L->tile);
    L->threads = kTileThreads;
    L->windows = kTileWarps;
    L->smem = (static_cast<size_t>(kTileK) * cin * kTileCout +
               static_cast<size_t>(kTileWarps) * cin * kTilePitch) * sizeof(float);
  } else if (variant == kGeneric) {
    const size_t fixed = static_cast<size_t>(k * cin * cout + cout) * sizeof(float);
    const size_t per_window = static_cast<size_t>(t_in + k - 1) * cin * sizeof(float);
    int tile = kGenericWindows;
    while (tile > 1 && fixed + tile * per_window > kMaxSmem) tile /= 2;
    L->fn = reinterpret_cast<const void*>(stream_block_generic_kernel);
    L->threads = kThreads;
    L->windows = tile;
    L->smem = fixed + tile * per_window;
    if (L->smem > kMaxSmem) return false;
  } else if (variant == kWide) {
    if (!wide_sizes(t_in, cin, cout, k, t_out)) return false;
    L->wide = wide_kernel(act, mode, vec4 && wide_vec4(cin));
    L->fn = reinterpret_cast<const void*>(L->wide);
    L->threads = kWideThreads;
    L->windows = wide_windows(batch);
    L->smem = wide_conv_smem(L->windows);
  } else if (variant == kPerFrame) {
    const long long floats = FrameLayout(t_in, cin, cout, k).floats;
    if (floats > static_cast<long long>(kMaxSmem / sizeof(float))) return false;
    L->frame = frame_kernel(act, cin, x);
    L->fn = reinterpret_cast<const void*>(L->frame);
    // a thread an output item (frame, 4 c_out) where they fit in one block
    const long long items = static_cast<long long>(t_in) * ((cout + 3) / 4);
    const long long warps = (items + 31) / 32;
    L->threads = static_cast<int>(warps < 2                       ? 64
                                  : warps > kFrameMaxThreads / 32 ? kFrameMaxThreads
                                                                  : 32 * warps);
    L->windows = 1;
    L->smem = static_cast<size_t>(floats) * sizeof(float);
  } else {
    return false;
  }
  L->grid = (batch + L->windows - 1) / L->windows;
  return true;
}

cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Launches L over `folds` folds of `batch` windows each: grid (L.grid, 1, folds).
cudaError_t launch_forward(const ForwardLaunch& L, const float* x, const float* w,
                           const float* b, const float* g, float* out, int folds, int batch,
                           int t_in, int cin, int cout, int k, int t_out, int act,
                           cudaStream_t s) {
  cudaError_t err = allow_smem(L.fn, L.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(L.grid, 1, folds);
  if (L.tile != nullptr) {
    L.tile<<<grid, L.threads, L.smem, s>>>(x, w, b, out, batch);
  } else if (L.wide != nullptr) {
    L.wide<<<grid, L.threads, L.smem, s>>>(x, w, b, g, out, batch, cin, L.windows);
  } else if (L.frame != nullptr) {
    L.frame<<<grid, L.threads, L.smem, s>>>(x, w, b, out, t_in, cin, cout, k, t_out);
  } else {
    stream_block_generic_kernel<<<grid, L.threads, L.smem, s>>>(
        x, w, b, out, batch, t_in, cin, cout, k, t_out, act, L.windows);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the forward's `variant` (0 warp_tile, 1 generic, 2 wide, 3
// per_frame) over `folds` folds of `batch` windows on `stream`. Returns a
// cudaError_t: 0 on success, cudaErrorInvalidValue for sizes the variant does
// not take. x (folds*batch, T, Cin), w (folds, K, Cin, Cout), b (folds, Cout),
// out (folds*batch, t_out, Cout) are contiguous f32 device pointers (out
// 16-byte aligned); act is 0 (ReLU) or 1 (exact GELU).
int stream_block_forward(const float* x, const float* w, const float* b, float* out,
                         int folds, int batch, int t_in, int cin, int cout, int k, int t_out,
                         int act, int variant, void* stream) {
  ForwardLaunch L;
  if (!valid_folds(folds) ||
      !forward_launch(variant, batch, t_in, cin, cout, k, t_out, act, &L, kWideForward,
                      wide_vec4(cin, x, w), x)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  return static_cast<int>(launch_forward(L, x, w, b, nullptr, out, folds, batch, t_in, cin,
                                         cout, k, t_out, act,
                                         static_cast<cudaStream_t>(stream)));
}

// The forward's launch of `variant` for these sizes: threads a block, dynamic
// shared memory in bytes, the blocks an SM holds at once (the CUDA occupancy
// calculator, registers included), the blocks of the grid (all folds') and
// the windows a block. Returns a cudaError_t.
int stream_block_forward_config(int variant, int folds, int batch, int t_in, int cin, int cout,
                                int k, int t_out, int act, int* threads, int* smem_bytes,
                                int* blocks_per_sm, int* blocks, int* windows) {
  ForwardLaunch L;
  if (!valid_folds(folds) ||
      !forward_launch(variant, batch, t_in, cin, cout, k, t_out, act, &L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *threads = L.threads;
  *smem_bytes = static_cast<int>(L.smem);
  *blocks = L.grid * folds;
  *windows = L.windows;
  cudaError_t err = allow_smem(L.fn, L.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, L.fn, L.threads, L.smem));
}

// Rows of the scratch buffer `partial` that the backward's `variant` (0
// generic, 1 wide) needs for one fold of these sizes (one per block of the
// generic kernel, or per window range of the wide one, then kReduceSlices for
// the slices' sums; each row K*Cin*Cout + Cout floats), or -1 for sizes it
// does not take. A launch of F folds takes F times as many.
int stream_block_backward_rows(int variant, int batch, int t_in, int cin, int cout, int k,
                               int t_out) {
  if (!valid_sizes(batch, t_in, cin, cout, k, t_out, kActRelu) || batch == 0) return -1;
  if (variant == kBwdWide) {
    return wide_sizes(t_in, cin, cout, k, t_out) ? wide_ranges(batch, cin) + kReduceSlices : -1;
  }
  if (variant != kBwdGeneric) return -1;
  int tile;
  size_t smem;
  backward_tile(t_in, cin, cout, k, t_out, &tile, &smem);
  return tile == 0 ? -1 : (batch + tile - 1) / tile + kReduceSlices;
}

// The backward's launch of `variant` for these sizes, into out[9]: threads a
// block, dynamic shared memory in bytes, the blocks an SM holds at once (the
// CUDA occupancy calculator, registers included), the blocks of the grid (all
// folds') and the windows a block (the generic kernel's tile; the wide gx/gw
// kernel's largest window range); then for the wide variant its first kernel
// (g_z): windows a block, shared memory, blocks an SM and blocks (0 for the
// generic variant). Returns a cudaError_t.
int stream_block_backward_config(int variant, int folds, int batch, int t_in, int cin, int cout,
                                 int k, int t_out, int act, int* out) {
  if (!valid_folds(folds) || !valid_sizes(batch, t_in, cin, cout, k, t_out, act)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < 9; ++i) out[i] = 0;
  cudaError_t err;
  if (variant == kBwdWide) {
    ForwardLaunch L;
    if (!forward_launch(kWide, batch, t_in, cin, cout, k, t_out, act, &L, kWideGradZ)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int ranges = wide_ranges(batch, cin);
    const void* fn = reinterpret_cast<const void*>(wide_grad_kernel(wide_vec4(cin)));
    out[0] = kWideThreads;
    out[1] = static_cast<int>(kWideGradSmem);
    out[3] = ranges * ((cin + kWideChunk - 1) / kWideChunk) * folds;
    out[4] = (batch + ranges - 1) / ranges;
    out[5] = L.windows;
    out[6] = static_cast<int>(L.smem);
    out[8] = L.grid * folds;
    if ((err = allow_smem(fn, kWideGradSmem)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn, kWideThreads,
                                                             kWideGradSmem)) != cudaSuccess ||
        (err = allow_smem(L.fn, L.smem)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[7], L.fn, L.threads, L.smem));
  }
  if (variant != kBwdGeneric) return static_cast<int>(cudaErrorInvalidValue);
  int tile;
  size_t smem;
  backward_tile(t_in, cin, cout, k, t_out, &tile, &smem);
  out[0] = kThreads;
  out[1] = static_cast<int>(smem);
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  out[3] = (batch + tile - 1) / tile * folds;
  out[4] = tile;
  const void* fn = reinterpret_cast<const void*>(stream_block_backward_kernel);
  if ((err = allow_smem(fn, smem)) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn, kThreads, smem));
}

// Launches the backward's `variant` over `folds` folds of `batch` windows on
// `stream` (generic: three kernels; wide: four). Returns a cudaError_t. x, w,
// b as the forward; g (folds*batch, t_out, Cout) the cotangent; gx
// (folds*batch, T, Cin), gw (folds, K, Cin, Cout), gb (folds, Cout) the
// outputs; partial a scratch buffer of folds * stream_block_backward_rows(...)
// * (K*Cin*Cout + Cout) floats; gz a scratch buffer of folds*batch*T*Cout
// floats for the wide variant (unused, may be null, for the generic one). All
// contiguous f32 device pointers; gx and gz 16-byte aligned.
int stream_block_backward(const float* x, const float* w, const float* b, const float* g,
                          float* gx, float* gw, float* gb, float* partial, float* gz,
                          int folds, int batch, int t_in, int cin, int cout, int k, int t_out,
                          int act, int variant, void* stream) {
  const int rows = stream_block_backward_rows(variant, batch, t_in, cin, cout, k, t_out);
  if (rows < 0 || !valid_folds(folds) || !valid_sizes(batch, t_in, cin, cout, k, t_out, act)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = rows - kReduceSlices;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (variant == kBwdWide) {
    if (gz == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec4 = wide_vec4(cin, x, w);
    ForwardLaunch L;
    forward_launch(kWide, batch, t_in, cin, cout, k, t_out, act, &L, kWideGradZ, vec4);
    err = launch_forward(L, x, w, b, g, gz, folds, batch, t_in, cin, cout, k, t_out, act, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const WideGradKernel grad = wide_grad_kernel(vec4);
    err = allow_smem(reinterpret_cast<const void*>(grad), kWideGradSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int chunks = (cin + kWideChunk - 1) / kWideChunk;
    grad<<<dim3(blocks * chunks, 1, folds), kWideThreads, kWideGradSmem, s>>>(
        x, w, gz, gx, partial, batch, cin, blocks);
  } else {
    int tile;
    size_t smem;
    backward_tile(t_in, cin, cout, k, t_out, &tile, &smem);
    err = allow_smem(reinterpret_cast<const void*>(stream_block_backward_kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    stream_block_backward_kernel<<<dim3(blocks, 1, folds), kThreads, smem, s>>>(
        x, w, b, g, gx, partial, batch, t_in, cin, cout, k, t_out, act, tile);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nw = k * cin * cout;
  const int width = nw + cout;
  const dim3 grid((width + kReduceX - 1) / kReduceX, kReduceSlices, folds);
  reduce_partials_kernel<<<grid, dim3(kReduceX, kReduceY), 0, s>>>(partial, blocks, width);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_slices_kernel<<<dim3((width + kThreads - 1) / kThreads, 1, folds), kThreads, 0, s>>>(
      partial, blocks, nw, cout, gw, gb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
