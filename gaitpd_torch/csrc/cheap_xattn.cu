// cheap_xattn: zero-parameter cross-attention softmax(A B^T / sqrt(d)) B, for
// NVIDIA Hopper (sm_90a), forward and backward. B is both key and value.
//
// Replaces the TPU kernel _xattn_kernel in gaitpd/ops/pallas_blocks.py
// (called by cheap_xattn_pallas) and the backward of its custom_vjp, which is
// the VJP of gaitpd/ops/attention.py::cheap_cross_attention:
//   A (N, Tq, d), B (N, Tk, d)  ->  O (N, Tq, d), f32, for N independent
//   problems, any Tq, Tk >= 1 and any d >= 1.
//
// FORWARD
//
// What bounds it. On the training path of the cheap-xattn fusion model the
// six directed stream pairs of a batch of 1024 window tuples go through one
// launch: N = 6144 problems of Tq = Tk = 64, d = 12. Per problem it must read
// A and B and write O, 9,216 bytes (56.6 MB in all, 16.9 us at 3.35 TB/s),
// and do the two products, 2 * 2 * 64 * 64 * 12 FLOP (1.21 GFLOP in all,
// 18.0 us at the 67 TFLOP/s of f32 on the CUDA cores): operations bound it,
// barely. The (Tq, Tk) score matrix, 16 KB a problem, never needs to leave
// the chip.
//
// What the design does about it. The problems are tiny, so nothing of the
// Pallas tiling is carried over. A block takes one problem and up to 128
// query rows; each thread owns one query row and keeps it, and its output
// row, in registers. B streams through shared memory in tiles of 64 rows;
// every thread of a warp reads the same B row at once (a broadcast, no bank
// conflicts), with 16-byte loads where d is a multiple of 4. Two passes over
// B: the first finds the row's maximum score, the second sums exp(s - max)
// and exp(s - max) * B_k; the output is that sum divided by the first. So no
// score is stored and no kv position needs masking. The score is the dot
// product divided by sqrt(d), as the reference divides (IEEE division and
// expf: the build has no --use_fast_math). The first pass recomputes the
// dot products of the second: 1.5 times the forward's minimum operations.
// No tensor cores yet: at d = 12 a product is 12 deep.
//
// The register rows hold d <= 64 (arrays of 16, 32 or 64, a template). A
// wider d takes a variant of both kernels whose per-thread rows stay in
// device memory: the query and dO rows are read from A and G where they
// lie, and the running sum is the thread's own output row (of O, dA or dB),
// which no other thread touches. Its arithmetic and order are the register
// version's; it is slow (every update of the sum goes through the cache),
// and no model of the repo's defaults takes it.
//
// BACKWARD
//
// For a cotangent dO, with S = A B^T / sqrt(d), P = softmax(S), O = P B:
//   dP = dO B^T;  D_i = sum_c dO_ic O_ic;  dS = P * (dP - D);
//   dA = dS B / sqrt(d);  dB = dS^T A / sqrt(d) + P^T dO.
//
// What bounds it. Five products of the forward's size at the main shape,
// 3.02 GFLOP (45 us), against 94 MB of traffic (28 us): operations.
//
// What the design does about it. One block owns one problem, so dB needs no
// sum across blocks and no float atomics: the result is the same bits from
// run to run. Nothing of the forward is saved; the backward recomputes it.
// Phase 1, a thread per query row: the row's max and sum (two passes over B
// in shared memory, as the forward), then D_i from the recomputed O_i, then
// a third pass for dA_i. The row's (max, sum, D) go to a scratch buffer.
// Phase 2, a thread per key row k, keeping B_k and dB_k in registers: A, dO
// and the row statistics stream through shared memory in tiles of 64 query
// rows, and the thread recomputes P_ik and dS_ik (the same dot products in
// the same order, so the same bits as phase 1) and accumulates dB_k. About
// twice the backward's minimum operations; no tensor cores yet.
//
// Plain C interface, bound with ctypes (gaitpd_torch/ops/cheap_xattn.py).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxThreads = 128;
constexpr int kTile = 64;  // rows staged in shared memory at a time
constexpr int kMaxD = 64;  // the widest register row; wider d runs the *_wide kernels
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// Copies rows [r0, r0 + rows) of a row-major (T, d) matrix into dst:
// contiguous in device memory, so the reads coalesce.
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, float* dst,
                                           int r0, int rows, int d) {
  const float* s = src + static_cast<size_t>(r0) * d;
  for (int e = threadIdx.x; e < rows * d; e += blockDim.x) dst[e] = s[e];
}

// Loads row i of a (T, d) matrix into registers, zero beyond d.
template <int DP>
__device__ __forceinline__ void load_row(float (&r)[DP], const float* __restrict__ src, int i,
                                         int d, bool active) {
#pragma unroll
  for (int c = 0; c < DP; ++c) r[c] = (active && c < d) ? src[static_cast<size_t>(i) * d + c] : 0.0f;
}

// sum_c q[c] * row[c] over c < d, in ascending c. With V4 (d a multiple of
// 4, row 16-byte aligned) the row is read four floats at a time.
template <int DP, bool V4>
__device__ __forceinline__ float dot_row(const float (&q)[DP], const float* row, int d) {
  float s = 0.0f;
  if (V4) {
#pragma unroll
    for (int c = 0; c < DP; c += 4) {
      if (c < d) {
        const float4 r = *reinterpret_cast<const float4*>(row + c);
        s = fmaf(q[c], r.x, s);
        s = fmaf(q[c + 1], r.y, s);
        s = fmaf(q[c + 2], r.z, s);
        s = fmaf(q[c + 3], r.w, s);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < d) s = fmaf(q[c], row[c], s);
    }
  }
  return s;
}

// acc[c] += e * row[c] over c < d.
template <int DP, bool V4>
__device__ __forceinline__ void axpy_row(float (&acc)[DP], float e, const float* row, int d) {
  if (V4) {
#pragma unroll
    for (int c = 0; c < DP; c += 4) {
      if (c < d) {
        const float4 r = *reinterpret_cast<const float4*>(row + c);
        acc[c] = fmaf(e, r.x, acc[c]);
        acc[c + 1] = fmaf(e, r.y, acc[c + 1]);
        acc[c + 2] = fmaf(e, r.z, acc[c + 2]);
        acc[c + 3] = fmaf(e, r.w, acc[c + 3]);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < d) acc[c] = fmaf(e, row[c], acc[c]);
    }
  }
}

// The query row q's max score over all tk rows of bp, and then
// l = sum_k exp(s_k - max) and acc = sum_k exp(s_k - max) * B_k. Every thread
// of the block calls it (it synchronises); inactive threads compute nothing.
template <int DP, bool V4>
__device__ __forceinline__ void softmax_pass(const float (&q)[DP], const float* __restrict__ bp,
                                             float* bs, int tk, int d, float sqrt_d,
                                             bool active, float* m_out, float* l_out,
                                             float (&acc)[DP]) {
  float m = -INFINITY;
  for (int k0 = 0; k0 < tk; k0 += kTile) {
    const int rows = min(kTile, tk - k0);
    __syncthreads();
    stage_rows(bp, bs, k0, rows, d);
    __syncthreads();
    if (active) {
      for (int k = 0; k < rows; ++k) m = fmaxf(m, dot_row<DP, V4>(q, bs + k * d, d) / sqrt_d);
    }
  }
  float l = 0.0f;
#pragma unroll
  for (int c = 0; c < DP; ++c) acc[c] = 0.0f;
  for (int k0 = 0; k0 < tk; k0 += kTile) {
    const int rows = min(kTile, tk - k0);
    __syncthreads();
    stage_rows(bp, bs, k0, rows, d);
    __syncthreads();
    if (active) {
      for (int k = 0; k < rows; ++k) {
        const float* row = bs + k * d;
        const float e = expf(dot_row<DP, V4>(q, row, d) / sqrt_d - m);
        l += e;
        axpy_row<DP, V4>(acc, e, row, d);
      }
    }
  }
  *m_out = m;
  *l_out = l;
}

// Grid (N, ceil(Tq / blockDim)): block (p, y) takes query rows
// [y * blockDim, (y + 1) * blockDim) of problem p. Shared memory: kTile * d
// floats, one tile of B.
template <int DP, bool V4>
__global__ void __launch_bounds__(kMaxThreads)
cheap_xattn_forward_kernel(const float* __restrict__ a, const float* __restrict__ b,
                           float* __restrict__ out, int tq, int tk, int d, float sqrt_d) {
  extern __shared__ float4 smem4[];
  float* bs = reinterpret_cast<float*>(smem4);
  const size_t p = blockIdx.x;
  const float* bp = b + p * tk * d;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = i < tq;
  float q[DP];
  load_row<DP>(q, a + p * tq * d, i, d, active);
  float m, l, acc[DP];
  softmax_pass<DP, V4>(q, bp, bs, tk, d, sqrt_d, active, &m, &l, acc);
  if (active) {
    float* o = out + (p * tq + i) * d;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < d) o[c] = acc[c] / l;
    }
  }
}

// Grid (N): block p owns problem p. Shared memory: 2 * kTile * d + 3 * kTile
// floats (phase 2's tiles of A and dO and their row statistics; phase 1 uses
// the first kTile * d for its tile of B). stats: N * Tq * 3 floats of scratch.
template <int DP, bool V4>
__global__ void __launch_bounds__(kMaxThreads)
cheap_xattn_backward_kernel(const float* __restrict__ a, const float* __restrict__ b,
                            const float* __restrict__ g, float* __restrict__ da,
                            float* __restrict__ db, float* stats, int tq, int tk, int d,
                            float sqrt_d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const size_t p = blockIdx.x;
  const float* ap = a + p * tq * d;
  const float* bp = b + p * tk * d;
  const float* gp = g + p * tq * d;
  float* st = stats + p * tq * 3;

  // Phase 1: a thread per query row i.
  for (int i0 = 0; i0 < tq; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool active = i < tq;
    float q[DP], go[DP];
    load_row<DP>(q, ap, i, d, active);
    load_row<DP>(go, gp, i, d, active);
    float m, l, acc[DP];
    softmax_pass<DP, V4>(q, bp, smem, tk, d, sqrt_d, active, &m, &l, acc);
    float dsum = 0.0f;  // D_i = dO_i . O_i, O_i as the forward computes it
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < d) dsum = fmaf(go[c], acc[c] / l, dsum);
    }
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[c] = 0.0f;  // now dS_i B
    for (int k0 = 0; k0 < tk; k0 += kTile) {
      const int rows = min(kTile, tk - k0);
      __syncthreads();
      stage_rows(bp, smem, k0, rows, d);
      __syncthreads();
      if (active) {
        for (int k = 0; k < rows; ++k) {
          const float* row = smem + k * d;
          const float pk = expf(dot_row<DP, V4>(q, row, d) / sqrt_d - m) / l;
          const float ds = pk * (dot_row<DP, V4>(go, row, d) - dsum);
          axpy_row<DP, V4>(acc, ds, row, d);
        }
      }
    }
    if (active) {
      float* o = da + (p * tq + i) * d;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        if (c < d) o[c] = acc[c] / sqrt_d;
      }
      st[3 * i] = m;
      st[3 * i + 1] = l;
      st[3 * i + 2] = dsum;
    }
  }

  // Phase 2: a thread per key row k. The __syncthreads() at the top of the
  // tile loop also makes phase 1's row statistics visible to the block.
  float* as = smem;
  float* gs = as + kTile * d;
  float* ss = gs + kTile * d;
  for (int k0 = 0; k0 < tk; k0 += blockDim.x) {
    const int k = k0 + threadIdx.x;
    const bool active = k < tk;
    float kb[DP], acc[DP];
    load_row<DP>(kb, bp, k, d, active);
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[c] = 0.0f;
    for (int j0 = 0; j0 < tq; j0 += kTile) {
      const int rows = min(kTile, tq - j0);
      __syncthreads();
      stage_rows(ap, as, j0, rows, d);
      stage_rows(gp, gs, j0, rows, d);
      for (int e = threadIdx.x; e < 3 * rows; e += blockDim.x) ss[e] = st[3 * j0 + e];
      __syncthreads();
      if (active) {
        for (int j = 0; j < rows; ++j) {
          const float* arow = as + j * d;
          const float* grow = gs + j * d;
          const float pk = expf(dot_row<DP, V4>(kb, arow, d) / sqrt_d - ss[3 * j]) / ss[3 * j + 1];
          const float ds = pk * (dot_row<DP, V4>(kb, grow, d) - ss[3 * j + 2]);
          axpy_row<DP, V4>(acc, pk, grow, d);
          axpy_row<DP, V4>(acc, ds / sqrt_d, arow, d);
        }
      }
    }
    if (active) {
      float* o = db + (p * tk + k) * d;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        if (c < d) o[c] = acc[c];
      }
    }
  }
}

bool valid_sizes(int n, int tq, int tk, int d) {
  return n >= 1 && tq >= 1 && tk >= 1 && d >= 1;
}

int threads_for(int rows) {
  const int t = (rows + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// ---------------------------------------------------------------------------
// d > 64: rows in device memory (see the header). The helpers mirror
// dot_row and axpy_row, in the same order.

template <bool V4>
__device__ __forceinline__ float dot_mem(const float* q, const float* row, int d) {
  float s = 0.0f;
  if (V4) {
    for (int c = 0; c < d; c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(q + c);
      const float4 r = *reinterpret_cast<const float4*>(row + c);
      s = fmaf(a.x, r.x, s);
      s = fmaf(a.y, r.y, s);
      s = fmaf(a.z, r.z, s);
      s = fmaf(a.w, r.w, s);
    }
  } else {
    for (int c = 0; c < d; ++c) s = fmaf(q[c], row[c], s);
  }
  return s;
}

template <bool V4>
__device__ __forceinline__ void axpy_mem(float* acc, float e, const float* row, int d) {
  if (V4) {
    for (int c = 0; c < d; c += 4) {
      float4 a = *reinterpret_cast<float4*>(acc + c);
      const float4 r = *reinterpret_cast<const float4*>(row + c);
      a.x = fmaf(e, r.x, a.x);
      a.y = fmaf(e, r.y, a.y);
      a.z = fmaf(e, r.z, a.z);
      a.w = fmaf(e, r.w, a.w);
      *reinterpret_cast<float4*>(acc + c) = a;
    }
  } else {
    for (int c = 0; c < d; ++c) acc[c] = fmaf(e, row[c], acc[c]);
  }
}

// softmax_pass with q and acc rows in device memory and B in tiles of
// `tile` rows.
template <bool V4>
__device__ __forceinline__ void softmax_pass_wide(const float* q, const float* __restrict__ bp,
                                                  float* bs, int tk, int d, int tile,
                                                  float sqrt_d, bool active, float* m_out,
                                                  float* l_out, float* acc) {
  float m = -INFINITY;
  for (int k0 = 0; k0 < tk; k0 += tile) {
    const int rows = min(tile, tk - k0);
    __syncthreads();
    stage_rows(bp, bs, k0, rows, d);
    __syncthreads();
    if (active) {
      for (int k = 0; k < rows; ++k) m = fmaxf(m, dot_mem<V4>(q, bs + k * d, d) / sqrt_d);
    }
  }
  float l = 0.0f;
  if (active) {
    for (int c = 0; c < d; ++c) acc[c] = 0.0f;
  }
  for (int k0 = 0; k0 < tk; k0 += tile) {
    const int rows = min(tile, tk - k0);
    __syncthreads();
    stage_rows(bp, bs, k0, rows, d);
    __syncthreads();
    if (active) {
      for (int k = 0; k < rows; ++k) {
        const float* row = bs + k * d;
        const float e = expf(dot_mem<V4>(q, row, d) / sqrt_d - m);
        l += e;
        axpy_mem<V4>(acc, e, row, d);
      }
    }
  }
  *m_out = m;
  *l_out = l;
}

// As cheap_xattn_forward_kernel; shared memory: tile * d floats.
template <bool V4>
__global__ void __launch_bounds__(kMaxThreads)
cheap_xattn_forward_wide_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                float* __restrict__ out, int tq, int tk, int d, float sqrt_d,
                                int tile) {
  extern __shared__ float4 smem4[];
  float* bs = reinterpret_cast<float*>(smem4);
  const size_t p = blockIdx.x;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = i < tq;
  const size_t row = (p * tq + (active ? i : 0)) * d;
  float* o = out + row;
  float m, l;
  softmax_pass_wide<V4>(a + row, b + p * tk * d, bs, tk, d, tile, sqrt_d, active, &m, &l, o);
  if (active) {
    for (int c = 0; c < d; ++c) o[c] = o[c] / l;
  }
}

// As cheap_xattn_backward_kernel; shared memory: tile * (2 d + 3) floats.
template <bool V4>
__global__ void __launch_bounds__(kMaxThreads)
cheap_xattn_backward_wide_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                 const float* __restrict__ g, float* __restrict__ da,
                                 float* __restrict__ db, float* stats, int tq, int tk, int d,
                                 float sqrt_d, int tile) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const size_t p = blockIdx.x;
  const float* ap = a + p * tq * d;
  const float* bp = b + p * tk * d;
  const float* gp = g + p * tq * d;
  float* st = stats + p * tq * 3;

  // Phase 1: a thread per query row i; dA_i is its running sum.
  for (int i0 = 0; i0 < tq; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool active = i < tq;
    const size_t row = static_cast<size_t>(active ? i : 0) * d;
    const float* q = ap + row;
    const float* go = gp + row;
    float* acc = da + p * tq * d + row;
    float m, l;
    softmax_pass_wide<V4>(q, bp, smem, tk, d, tile, sqrt_d, active, &m, &l, acc);
    float dsum = 0.0f;
    if (active) {
      for (int c = 0; c < d; ++c) dsum = fmaf(go[c], acc[c] / l, dsum);
      for (int c = 0; c < d; ++c) acc[c] = 0.0f;  // now dS_i B
    }
    for (int k0 = 0; k0 < tk; k0 += tile) {
      const int rows = min(tile, tk - k0);
      __syncthreads();
      stage_rows(bp, smem, k0, rows, d);
      __syncthreads();
      if (active) {
        for (int k = 0; k < rows; ++k) {
          const float* brow = smem + k * d;
          const float pk = expf(dot_mem<V4>(q, brow, d) / sqrt_d - m) / l;
          const float ds = pk * (dot_mem<V4>(go, brow, d) - dsum);
          axpy_mem<V4>(acc, ds, brow, d);
        }
      }
    }
    if (active) {
      for (int c = 0; c < d; ++c) acc[c] = acc[c] / sqrt_d;
      st[3 * i] = m;
      st[3 * i + 1] = l;
      st[3 * i + 2] = dsum;
    }
  }

  // Phase 2: a thread per key row k; dB_k is its running sum.
  float* as = smem;
  float* gs = as + tile * d;
  float* ss = gs + tile * d;
  for (int k0 = 0; k0 < tk; k0 += blockDim.x) {
    const int k = k0 + threadIdx.x;
    const bool active = k < tk;
    const size_t row = static_cast<size_t>(active ? k : 0) * d;
    const float* kb = bp + row;
    float* acc = db + p * tk * d + row;
    if (active) {
      for (int c = 0; c < d; ++c) acc[c] = 0.0f;
    }
    for (int j0 = 0; j0 < tq; j0 += tile) {
      const int rows = min(tile, tq - j0);
      __syncthreads();
      stage_rows(ap, as, j0, rows, d);
      stage_rows(gp, gs, j0, rows, d);
      for (int e = threadIdx.x; e < 3 * rows; e += blockDim.x) ss[e] = st[3 * j0 + e];
      __syncthreads();
      if (active) {
        for (int j = 0; j < rows; ++j) {
          const float* arow = as + j * d;
          const float* grow = gs + j * d;
          const float pk = expf(dot_mem<V4>(kb, arow, d) / sqrt_d - ss[3 * j]) / ss[3 * j + 1];
          const float ds = pk * (dot_mem<V4>(kb, grow, d) - ss[3 * j + 2]);
          axpy_mem<V4>(acc, pk, grow, d);
          axpy_mem<V4>(acc, ds / sqrt_d, arow, d);
        }
      }
    }
  }
}

// Rows of a tile for the wide kernels, `row_floats` floats each: as many as
// the default 48 KB hold, at most kTile and at least one; 0 if one row
// exceeds the block's shared memory.
int wide_tile(size_t row_floats, size_t* smem) {
  const size_t row_bytes = row_floats * sizeof(float);
  size_t t = kDefaultSmem / row_bytes;
  t = t > static_cast<size_t>(kTile) ? kTile : (t < 1 ? 1 : t);
  *smem = t * row_bytes;
  return *smem > kMaxSmem ? 0 : static_cast<int>(t);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool V4>
int forward_wide(const float* a, const float* b, float* out, int n, int tq, int tk, int d,
                 cudaStream_t s) {
  size_t smem;
  const int tile = wide_tile(d, &smem);
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(cheap_xattn_forward_wide_kernel<V4>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = threads_for(tq);
  const dim3 grid(n, (tq + threads - 1) / threads);
  cheap_xattn_forward_wide_kernel<V4><<<grid, threads, smem, s>>>(
      a, b, out, tq, tk, d, sqrtf(static_cast<float>(d)), tile);
  return static_cast<int>(cudaGetLastError());
}

template <bool V4>
int backward_wide(const float* a, const float* b, const float* g, float* da, float* db,
                  float* stats, int n, int tq, int tk, int d, cudaStream_t s) {
  size_t smem;
  const int tile = wide_tile(2 * static_cast<size_t>(d) + 3, &smem);
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(cheap_xattn_backward_wide_kernel<V4>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = threads_for(tq > tk ? tq : tk);
  cheap_xattn_backward_wide_kernel<V4><<<n, threads, smem, s>>>(
      a, b, g, da, db, stats, tq, tk, d, sqrtf(static_cast<float>(d)), tile);
  return static_cast<int>(cudaGetLastError());
}

// Launches kernel<DP, V4> for the smallest DP in {16, 32, 64} that holds d.
template <template <int, bool> class Launch, typename... Args>
int dispatch(int d, Args... args) {
  const bool v4 = d % 4 == 0;
  if (d <= 16) return v4 ? Launch<16, true>::run(args...) : Launch<16, false>::run(args...);
  if (d <= 32) return v4 ? Launch<32, true>::run(args...) : Launch<32, false>::run(args...);
  return v4 ? Launch<64, true>::run(args...) : Launch<64, false>::run(args...);
}

template <int DP, bool V4>
struct ForwardLaunch {
  static int run(const float* a, const float* b, float* out, int n, int tq, int tk, int d,
                 cudaStream_t s) {
    const int threads = threads_for(tq);
    const dim3 grid(n, (tq + threads - 1) / threads);
    const size_t smem = static_cast<size_t>(kTile) * d * sizeof(float);
    cheap_xattn_forward_kernel<DP, V4><<<grid, threads, smem, s>>>(
        a, b, out, tq, tk, d, sqrtf(static_cast<float>(d)));
    return static_cast<int>(cudaGetLastError());
  }
};

template <int DP, bool V4>
struct BackwardLaunch {
  static int run(const float* a, const float* b, const float* g, float* da, float* db,
                 float* stats, int n, int tq, int tk, int d, cudaStream_t s) {
    const int threads = threads_for(tq > tk ? tq : tk);
    const size_t smem = (2 * static_cast<size_t>(kTile) * d + 3 * kTile) * sizeof(float);
    cheap_xattn_backward_kernel<DP, V4><<<n, threads, smem, s>>>(
        a, b, g, da, db, stats, tq, tk, d, sqrtf(static_cast<float>(d)));
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

extern "C" {

// Launches the forward on `stream`. Returns a cudaError_t: 0 on success,
// cudaErrorInvalidValue for sizes the kernel does not take (N, Tq, Tk or d
// < 1, or a row of B wider than shared memory). a (N, Tq, d), b (N, Tk, d),
// out (N, Tq, d): contiguous f32 device pointers.
int cheap_xattn_forward(const float* a, const float* b, float* out, int n, int tq, int tk,
                        int d, void* stream) {
  if (!valid_sizes(n, tq, tk, d)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > kMaxD) {
    return d % 4 == 0 ? forward_wide<true>(a, b, out, n, tq, tk, d, s)
                      : forward_wide<false>(a, b, out, n, tq, tk, d, s);
  }
  return dispatch<ForwardLaunch>(d, a, b, out, n, tq, tk, d, static_cast<cudaStream_t>(stream));
}

// Launches the backward on `stream`. Returns a cudaError_t. a, b as the
// forward; g (N, Tq, d) the cotangent; da (N, Tq, d) and db (N, Tk, d) the
// outputs; stats a scratch buffer of N * Tq * 3 floats. All contiguous f32
// device pointers.
int cheap_xattn_backward(const float* a, const float* b, const float* g, float* da, float* db,
                         float* stats, int n, int tq, int tk, int d, void* stream) {
  if (!valid_sizes(n, tq, tk, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (d > kMaxD) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return d % 4 == 0 ? backward_wide<true>(a, b, g, da, db, stats, n, tq, tk, d, s)
                      : backward_wide<false>(a, b, g, da, db, stats, n, tq, tk, d, s);
  }
  return dispatch<BackwardLaunch>(d, a, b, g, da, db, stats, n, tq, tk, d,
                                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
