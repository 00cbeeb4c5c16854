// stream_block: Conv1d(k, 'SAME') + bias + ReLU or exact GELU +
// AdaptiveAvgPool1d(t_out), fused, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel _stream_block_kernel in
// gaitpd/ops/pallas_blocks.py (forward only; no gradient in this kernel).
// Computes exactly the reference's _stream_block_jnp / SharedBackbone:
//   x (B, T, Cin), w (K, Cin, Cout), b (Cout,)  ->  out (B, t_out, Cout), f32.
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
// Plain C interface, bound with ctypes (gaitpd_torch/ops/stream_block.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileWindows = 4;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

constexpr int kActRelu = 0;
constexpr int kActGelu = 1;

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kActRelu) return v < 0.0f ? 0.0f : v;  // keeps NaN, as torch
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
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
  const int win_elems = t_in * cin;
  const int halo = pad * cin;

  for (int e = threadIdx.x; e < taps * cout; e += blockDim.x) ws[e] = w[e];
  for (int e = threadIdx.x; e < cout; e += blockDim.x) bs[e] = b[e];
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

}  // namespace

extern "C" {

// Launches the kernel on `stream`. Returns a cudaError_t: 0 on success,
// cudaErrorInvalidValue for sizes the kernel does not take. x, w, b, out are
// contiguous f32 device pointers; act is 0 (ReLU) or 1 (exact GELU).
int stream_block_forward(const float* x, const float* w, const float* b, float* out,
                         int batch, int t_in, int cin, int cout, int k, int t_out,
                         int act, void* stream) {
  if (batch < 0 || t_in < 1 || cin < 1 || cout < 1 || k < 1 || k % 2 == 0 ||
      t_out < 1 || (act != kActRelu && act != kActGelu)) {
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

}  // extern "C"
