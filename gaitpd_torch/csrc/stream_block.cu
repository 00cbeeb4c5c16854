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
// pooled output goes through device memory. Two variants, chosen by the
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
// "generic", every other size (T = 101 with overlapping bins, K = 1 or 5,
// Cin = 13, ...): a block stages a tile of whole windows (with a zeroed halo
// of K/2 frames on each side, so no host-side padding) and the weights in
// shared memory; each thread owns one (window, bin, c_out) output, computes
// the conv outputs of the frames in its bin, applies bias and activation, and
// averages them. The bin is [floor(i*T/t_out), ceil((i+1)*T/t_out)), as
// torch's AdaptiveAvgPool1d: bins overlap when t_out does not divide T, and a
// frame on a shared edge is then computed by both bins.
//
// No tensor cores: parity is strict f32 (no TF32).
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

enum Variant { kWarpTile = 0, kGeneric = 1 };

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
  float* part = partial + static_cast<size_t>(blockIdx.x) * (nw + cout);

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

constexpr int kReduceX = 32;      // outputs per block, one per lane
constexpr int kReduceY = 8;       // rows of a slice summed at once
constexpr int kReduceSlices = 8;  // slices of the partial rows

// Sums the block rows [0, rows) of `partial` (width floats each) in
// kReduceSlices slices: slice s = blockIdx.y takes rows
// [s * rows / S, (s + 1) * rows / S); lane y of it sums rows r0 + y, r0 + y + 8,
// ... in turn, then lanes 0..7 are added in turn, into row rows + s.
__global__ void __launch_bounds__(kReduceX * kReduceY)
reduce_partials_kernel(float* partial, int rows, int width) {
  __shared__ float lanes[kReduceY][kReduceX];
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

// Windows per block for the backward and its shared memory in bytes, or
// tile 0 if one window does not fit.
void backward_tile(int t_in, int cin, int cout, int k, int t_out, int* tile, size_t* smem) {
  int t = kBwdTileWindows;
  while (t > 1 && BwdLayout(t_in, cin, cout, k, t_out, t).bytes > kMaxSmem) t /= 2;
  *smem = BwdLayout(t_in, cin, cout, k, t_out, t).bytes;
  *tile = *smem > kMaxSmem ? 0 : t;
}

using TileKernel = void (*)(const float*, const float*, const float*, float*, int);

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

struct ForwardLaunch {
  const void* fn;   // the kernel, for its attributes
  TileKernel tile;  // the warp_tile kernel, or null for the generic one
  int threads, windows, grid;  // windows a block
  size_t smem;
};

// The forward launch of `variant` for these sizes; false if the variant does
// not take them.
bool forward_launch(int variant, int batch, int t_in, int cin, int cout, int k, int t_out,
                    int act, ForwardLaunch* L) {
  if (!valid_sizes(batch, t_in, cin, cout, k, t_out, act)) return false;
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
    L->tile = nullptr;
    L->fn = reinterpret_cast<const void*>(stream_block_generic_kernel);
    L->threads = kThreads;
    L->windows = tile;
    L->smem = fixed + tile * per_window;
    if (L->smem > kMaxSmem) return false;
  } else {
    return false;
  }
  L->grid = (batch + L->windows - 1) / L->windows;
  return true;
}

cudaError_t allow_forward_smem(const ForwardLaunch& L) {
  if (L.smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(L.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(L.smem));
}

}  // namespace

extern "C" {

// Launches the forward's `variant` (0 warp_tile, 1 generic) on `stream`.
// Returns a cudaError_t: 0 on success, cudaErrorInvalidValue for sizes the
// variant does not take. x, w, b, out are contiguous f32 device pointers (out
// 16-byte aligned); act is 0 (ReLU) or 1 (exact GELU).
int stream_block_forward(const float* x, const float* w, const float* b, float* out,
                         int batch, int t_in, int cin, int cout, int k, int t_out,
                         int act, int variant, void* stream) {
  ForwardLaunch L;
  if (!forward_launch(variant, batch, t_in, cin, cout, k, t_out, act, &L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  cudaError_t err = allow_forward_smem(L);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L.tile != nullptr) {
    L.tile<<<L.grid, L.threads, L.smem, s>>>(x, w, b, out, batch);
  } else {
    stream_block_generic_kernel<<<L.grid, L.threads, L.smem, s>>>(
        x, w, b, out, batch, t_in, cin, cout, k, t_out, act, L.windows);
  }
  return static_cast<int>(cudaGetLastError());
}

// The forward's launch of `variant` for these sizes: threads a block, dynamic
// shared memory in bytes, the blocks an SM holds at once (the CUDA occupancy
// calculator, registers included) and the blocks of the grid. Returns a
// cudaError_t.
int stream_block_forward_config(int variant, int batch, int t_in, int cin, int cout, int k,
                                int t_out, int act, int* threads, int* smem_bytes,
                                int* blocks_per_sm, int* blocks) {
  ForwardLaunch L;
  if (!forward_launch(variant, batch, t_in, cin, cout, k, t_out, act, &L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *threads = L.threads;
  *smem_bytes = static_cast<int>(L.smem);
  *blocks = L.grid;
  cudaError_t err = allow_forward_smem(L);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, L.fn, L.threads, L.smem));
}

// Rows of the scratch buffer that stream_block_backward needs (one per
// block, then kReduceSlices for the slices' sums; each row K*Cin*Cout + Cout
// floats), or -1 for sizes it does not take.
int stream_block_backward_rows(int batch, int t_in, int cin, int cout, int k, int t_out) {
  if (!valid_sizes(batch, t_in, cin, cout, k, t_out, kActRelu) || batch == 0) return -1;
  int tile;
  size_t smem;
  backward_tile(t_in, cin, cout, k, t_out, &tile, &smem);
  return tile == 0 ? -1 : (batch + tile - 1) / tile + kReduceSlices;
}

static cudaError_t allow_smem(size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(stream_block_backward_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The backward kernel's launch for these sizes: windows per block, dynamic
// shared memory in bytes, and the blocks an SM holds at once (the CUDA
// occupancy calculator, registers included). Returns a cudaError_t.
int stream_block_backward_config(int t_in, int cin, int cout, int k, int t_out, int* tile,
                                 int* smem_bytes, int* blocks_per_sm) {
  if (!valid_sizes(1, t_in, cin, cout, k, t_out, kActRelu)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem;
  backward_tile(t_in, cin, cout, k, t_out, tile, &smem);
  *smem_bytes = static_cast<int>(smem);
  if (*tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, stream_block_backward_kernel, kThreads, smem));
}

// Launches the backward (three kernels) on `stream`. Returns a cudaError_t.
// x, w, b as the forward; g (B, t_out, Cout) the cotangent; gx (B, T, Cin),
// gw (K, Cin, Cout), gb (Cout) the outputs; partial a scratch buffer of
// stream_block_backward_rows(...) * (K*Cin*Cout + Cout) floats. All
// contiguous f32 device pointers.
int stream_block_backward(const float* x, const float* w, const float* b, const float* g,
                          float* gx, float* gw, float* gb, float* partial,
                          int batch, int t_in, int cin, int cout, int k, int t_out,
                          int act, void* stream) {
  if (!valid_sizes(batch, t_in, cin, cout, k, t_out, act) || batch == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int tile;
  size_t smem;
  backward_tile(t_in, cin, cout, k, t_out, &tile, &smem);
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = (batch + tile - 1) / tile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  stream_block_backward_kernel<<<rows, kThreads, smem, s>>>(
      x, w, b, g, gx, partial, batch, t_in, cin, cout, k, t_out, act, tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nw = k * cin * cout;
  const int width = nw + cout;
  const dim3 grid((width + kReduceX - 1) / kReduceX, kReduceSlices);
  reduce_partials_kernel<<<grid, dim3(kReduceX, kReduceY), 0, s>>>(partial, rows, width);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_slices_kernel<<<(width + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, rows, nw, cout, gw, gb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
