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
// What the design does about it. One pass: a block stages a tile of whole
// windows (with a zeroed halo of K/2 frames on each side, so no host-side
// padding) and the weights in shared memory; each thread owns one
// (window, bin, c_out) output, computes the conv outputs of the frames in its
// bin, applies bias and activation, and averages them. The bin is
// [floor(i*T/t_out), ceil((i+1)*T/t_out)), as torch's AdaptiveAvgPool1d:
// bins overlap when t_out does not divide T, and a frame on a shared edge is
// then computed by both bins. Nothing goes through device memory between the
// input and the pooled output. No tensor cores yet: at Cin = 12 the products
// are small, and the first aim is a kernel that is right.
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
// and b. A block takes the same tile of whole windows as the forward, stages
// x with its zeroed halo and w in shared memory, recomputes z, and keeps g_z
// of its windows in shared memory (T*Cout floats a window, 4 KB at the main
// shape). Each window belongs to one block, so the block writes gx directly.
// gw and gb are sums over every window: each block writes its partial sums
// to its own row of a scratch buffer (allocated by the caller), and a second
// launch adds the rows in a fixed order. No float atomics: the result is the
// same bits from run to run. No tensor cores, TMA or wgmma yet.
//
// Plain C interface, bound with ctypes (gaitpd_torch/ops/stream_block.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileWindows = 4;
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

__global__ void __launch_bounds__(kThreads)
stream_block_kernel(const float* __restrict__ x, const float* __restrict__ w,
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

// One tile of windows: gx of its windows, and its partial gw (K*Cin*Cout
// values, then gb's Cout) into row blockIdx.x of `partial`.
__global__ void __launch_bounds__(kThreads)
stream_block_backward_kernel(const float* __restrict__ x, const float* __restrict__ w,
                             const float* __restrict__ b, const float* __restrict__ g,
                             float* __restrict__ gx, float* __restrict__ partial,
                             int batch, int t_in, int cin, int cout, int k, int t_out,
                             int act, int tile) {
  extern __shared__ float smem[];
  const int pad = k / 2;
  const int row_elems = (t_in + k - 1) * cin;
  const int taps = k * cin;
  const int z_elems = t_in * cout;                 // g_z of one window
  float* xs = smem;                                // tile * row_elems
  float* ws = xs + tile * row_elems;               // (K*Cin, Cout)
  float* bs = ws + taps * cout;                    // Cout
  float* gz = bs + cout;                           // tile * T * Cout
  float* bin_inv = gz + tile * z_elems;            // t_out: 1 / |bin|
  int* bin_lo = reinterpret_cast<int*>(bin_inv + t_out);  // t_out
  int* bin_hi = bin_lo + t_out;                    // t_out

  const int b0 = blockIdx.x * tile;
  const int nwin = min(tile, batch - b0);

  for (int e = threadIdx.x; e < taps * cout; e += blockDim.x) ws[e] = w[e];
  for (int e = threadIdx.x; e < cout; e += blockDim.x) bs[e] = b[e];
  for (int o = threadIdx.x; o < t_out; o += blockDim.x) {
    bin_lo[o] = (o * t_in) / t_out;
    bin_hi[o] = ((o + 1) * t_in + t_out - 1) / t_out;
    bin_inv[o] = 1.0f / static_cast<float>(bin_hi[o] - bin_lo[o]);
  }
  stage_windows(x, xs, b0, nwin, t_in, cin, pad);
  __syncthreads();

  // g_z = act'(z) * g_y, z recomputed; consecutive threads take consecutive
  // c_out, as in the forward.
  const float* gg = g + static_cast<size_t>(b0) * t_out * cout;
  for (int e = threadIdx.x; e < nwin * z_elems; e += blockDim.x) {
    const int wi = e / z_elems;
    const int r = e - wi * z_elems;
    const int t = r / cout;
    const int co = r - t * cout;
    const float* xr = xs + wi * row_elems + t * cin;
    float acc = bs[co];
    for (int j = 0; j < taps; ++j) acc = fmaf(xr[j], ws[j * cout + co], acc);
    float gy = 0.0f;
    for (int o = 0; o < t_out; ++o) {
      if (t >= bin_lo[o] && t < bin_hi[o]) {
        gy = fmaf(gg[(wi * t_out + o) * cout + co], bin_inv[o], gy);
      }
    }
    gz[e] = gy * activate_grad(acc, act);
  }
  __syncthreads();

  // gx: frame t of a window reads g_z at frames t - i + pad, i < K.
  const int win_elems = t_in * cin;
  float* gxb = gx + static_cast<size_t>(b0) * win_elems;
  for (int e = threadIdx.x; e < nwin * win_elems; e += blockDim.x) {
    const int wi = e / win_elems;
    const int r = e - wi * win_elems;
    const int t = r / cin;
    const int ci = r - t * cin;
    const float* gzw = gz + wi * z_elems;
    float acc = 0.0f;
    for (int i = 0; i < k; ++i) {
      const int tz = t - i + pad;
      if (tz < 0 || tz >= t_in) continue;
      const float* gzr = gzw + tz * cout;
      const float* wr = ws + (i * cin + ci) * cout;
      for (int co = 0; co < cout; ++co) acc = fmaf(gzr[co], wr[co], acc);
    }
    gxb[e] = acc;
  }

  // Partial gw and gb over the tile's windows. Padded row t + i, channel ci
  // sits at xs[(t + i) * cin + ci] = xs[t * cin + j] with j = i * cin + ci.
  const int nw = taps * cout;
  float* part = partial + static_cast<size_t>(blockIdx.x) * (nw + cout);
  for (int e = threadIdx.x; e < nw + cout; e += blockDim.x) {
    float acc = 0.0f;
    if (e < nw) {
      const int j = e / cout;
      const int co = e - j * cout;
      for (int wi = 0; wi < nwin; ++wi) {
        const float* xw = xs + wi * row_elems + j;
        const float* gzw = gz + wi * z_elems + co;
        for (int t = 0; t < t_in; ++t) acc = fmaf(xw[t * cin], gzw[t * cout], acc);
      }
    } else {
      const float* gzc = gz + (e - nw);
      for (int wi = 0; wi < nwin; ++wi) {
        for (int t = 0; t < t_in; ++t) acc += gzc[wi * z_elems + t * cout];
      }
    }
    part[e] = acc;
  }
}

constexpr int kReduceX = 32;  // outputs per block, one per lane
constexpr int kReduceY = 8;   // slices of the partial rows per output

// Adds the `rows` partial rows of width nw + ncout in a fixed order: slice y
// sums rows y, y + 8, ... in turn, then slices 0..7 are added in turn.
__global__ void __launch_bounds__(kReduceX * kReduceY)
reduce_partials_kernel(const float* __restrict__ partial, int rows, int nw, int ncout,
                       float* __restrict__ gw, float* __restrict__ gb) {
  __shared__ float slices[kReduceY][kReduceX];
  const int width = nw + ncout;
  const int e = blockIdx.x * kReduceX + threadIdx.x;
  float acc = 0.0f;
  if (e < width) {
    for (int p = threadIdx.y; p < rows; p += kReduceY) {
      acc += partial[static_cast<size_t>(p) * width + e];
    }
  }
  slices[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < width) {
    float s = slices[0][threadIdx.x];
    for (int y = 1; y < kReduceY; ++y) s += slices[y][threadIdx.x];
    if (e < nw) {
      gw[e] = s;
    } else {
      gb[e - nw] = s;
    }
  }
}

bool valid_sizes(int batch, int t_in, int cin, int cout, int k, int t_out, int act) {
  return batch >= 0 && t_in >= 1 && cin >= 1 && cout >= 1 && k >= 1 && k % 2 == 1 &&
         t_out >= 1 && (act == kActRelu || act == kActGelu);
}

// Windows per block for the backward and its shared memory, or tile 0 if
// one window does not fit.
void backward_tile(int t_in, int cin, int cout, int k, int t_out, int* tile, size_t* smem) {
  const size_t fixed =
      (static_cast<size_t>(k * cin * cout + cout) + 3 * static_cast<size_t>(t_out)) *
      sizeof(float);
  const size_t per_window =
      (static_cast<size_t>(t_in + k - 1) * cin + static_cast<size_t>(t_in) * cout) *
      sizeof(float);
  int t = kTileWindows;
  while (t > 1 && fixed + t * per_window > kMaxSmem) t /= 2;
  *tile = fixed + t * per_window > kMaxSmem ? 0 : t;
  *smem = fixed + t * per_window;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`. Returns a cudaError_t: 0 on success,
// cudaErrorInvalidValue for sizes the kernel does not take. x, w, b, out are
// contiguous f32 device pointers; act is 0 (ReLU) or 1 (exact GELU).
int stream_block_forward(const float* x, const float* w, const float* b, float* out,
                         int batch, int t_in, int cin, int cout, int k, int t_out,
                         int act, void* stream) {
  if (!valid_sizes(batch, t_in, cin, cout, k, t_out, act)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const size_t fixed = static_cast<size_t>(k * cin * cout + cout) * sizeof(float);
  const size_t per_window = static_cast<size_t>(t_in + k - 1) * cin * sizeof(float);
  int tile = kTileWindows;
  while (tile > 1 && fixed + tile * per_window > kMaxSmem) tile /= 2;
  const size_t smem = fixed + tile * per_window;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        stream_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (batch + tile - 1) / tile;
  stream_block_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, b, out, batch, t_in, cin, cout, k, t_out, act, tile);
  return static_cast<int>(cudaGetLastError());
}

// Rows of the scratch buffer that stream_block_backward needs (one per
// block; each row K*Cin*Cout + Cout floats), or -1 for sizes it does not
// take.
int stream_block_backward_rows(int batch, int t_in, int cin, int cout, int k, int t_out) {
  if (!valid_sizes(batch, t_in, cin, cout, k, t_out, kActRelu) || batch == 0) return -1;
  int tile;
  size_t smem;
  backward_tile(t_in, cin, cout, k, t_out, &tile, &smem);
  return tile == 0 ? -1 : (batch + tile - 1) / tile;
}

// Launches the backward (two kernels) on `stream`. Returns a cudaError_t.
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
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        stream_block_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rows = (batch + tile - 1) / tile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  stream_block_backward_kernel<<<rows, kThreads, smem, s>>>(
      x, w, b, g, gx, partial, batch, t_in, cin, cout, k, t_out, act, tile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nw = k * cin * cout;
  const int grid = (nw + cout + kReduceX - 1) / kReduceX;
  reduce_partials_kernel<<<grid, dim3(kReduceX, kReduceY), 0, s>>>(partial, rows, nw, cout,
                                                                    gw, gb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
