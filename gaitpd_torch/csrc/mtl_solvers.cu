// mtl_solvers: the simplex and fixed-point solvers of MGDA, FairGrad and
// NashMTL, for NVIDIA Hopper (sm_90a), everything in registers: MGDA's
// Frank-Wolfe one thread a Gram matrix (one warp at K = 7 and 8), ended at
// its bitwise fixed point, FairGrad's and NashMTL's damped Newton
// iterations one warp a Gram matrix.
//
// Not TPU kernels. The JAX package solves these inside its compiled step as
// XLA loops (gaitpd/learning/minnorm.py: min_norm_element :35-55,
// fairgrad_weights :125-141, nashmtl_weights :144-158, called from
// gaitpd/learning/mtl.py's MGDA, FairGrad and NashMTL combines). Eager
// PyTorch would issue 12 to 40 launches on K-vectors for every iteration,
// thousands a training step; these kernels run a whole solve in one launch
// and read and write device memory only.
//
// What each computes, for each (K, K) Gram matrix G, with the reference's
// fixed iteration counts:
//   min_norm_solver:  w on the simplex minimising w . G w, Frank-Wolfe from
//       w = 1/K, 250 steps: t = argmin(G w) (the first index on ties),
//       e = e_t, d = w - e, gamma = clamp(d . G w / (d . G d + EPS), 0, 1),
//       w = (1 - gamma) w + gamma e;
//   fairgrad_solver:  G w = w^(-1/alpha), damped Newton from w = 1/K, 100
//       steps: F = G w - w^(-1/alpha), J = G + diag(w^(-1/alpha - 1)/alpha),
//       w = max(w - 0.5 (J + EPS I)^-1 F, 1e-6);
//   nashmtl_solver:  G a = 1/a, damped Newton from a = 1, 50 steps:
//       F = G a - 1/a, J = G + diag(1/(a a)), a = max(a - 0.8 (J + EPS
//       I)^-1 F, 1e-6). The caller normalises G (gaitpd/learning/mtl.py:379).
// The K x K systems are solved by Gaussian elimination without pivoting,
// then back substitution: J + EPS I is symmetric positive definite for a PSD
// Gram matrix. Every step is one IEEE round-to-nearest operation (__fadd_rn,
// __fmul_rn, __fdiv_rn: no contraction into FMA), w^p is the device's powf,
// the clamps are torch.clamp's (NaN passes through, then fmaxf and fminf),
// and every sum is added left to right, exactly as the plain versions
// (gaitpd_torch/learning/minnorm.py) write them, so the two agree bit for
// bit. Frank-Wolfe's argmin near the optimum, where the entries of G w are
// nearly equal, is decided by rounding; any other order of operations would
// take other vertices there.
//
// What bounds them. Neither bytes (K*K + K floats) nor operations (about
// 14,750 f32 operations for MGDA at K = 3, 7,000 for FairGrad, 3,500 for
// NashMTL: a fraction of a microsecond at 67 TFLOP/s) but the latency of
// each solve's chain of dependent scalar operations. clock64() readings on
// an NVIDIA H100 80GB HBM3 at 700 W, SM clock 1,975-1,986 MHz (python -m
// gaitpd_torch.tools.mtl_solver_clock; cycles a link of a dependent chain):
// an add 4.9; __fdiv_rn 58.2; powf 254.5 at each of FairGrad's exponents
// for alpha 0.5, 1 and 2; __frcp_rn 76.9; __shfl_sync 26.3. Independent
// calls in one thread do not overlap at all: two divisions take 115.9
// cycles, three 173.2, two powf 504.4 (each branches to a slow path for
// special operands, and nothing is scheduled across that branch).
//
// The Newton designs. One thread a matrix (the first, `thread` design,
// retired once the warp design's times were recorded; its device functions
// live on in gaitpd_torch/tools/mtl_solver_clock.cu, whose probes measure
// it) runs a step as one chain: at K = 3 the right-hand side's 2K = 6 powf
// calls (NashMTL: 6 divisions) one after another, then the elimination's 3
// multipliers and the 3 back-substitution divisions; 1,550 cycles a
// FairGrad step and 614 a NashMTL step. The `warp` design (the default) gives each of those calls
// that is independent of the others a lane of its own:
//   - right-hand side: lane i < K forms w_i^(-1/alpha) (NashMTL 1/w_i), lane
//     K + i forms w_i^(-1/alpha - 1) (1/(w_i w_i)): the 2K calls take one
//     latency, and 2K shuffles, issued back to back, bring them to every
//     lane, which holds G and w and forms G w, F and J + EPS I itself;
//   - elimination on every lane alike, in the serial loop's order; where two
//     or more rows lie below a pivot, lane r forms row r's multiplier and
//     shuffles bring them to every lane, one division latency and a shuffle
//     in place of K - p - 1 divisions (at K = 3, pivot 0's two);
//   - back substitution and the clamp on every lane alike, so w stays
//     replicated with no shuffle inside that chain.
// A lane performs exactly the IEEE operations the serial loop performs, on
// the same operands, in the same order for every entry; shuffles move bits
// unchanged. So w is the plain version's bit for bit, the degenerate
// matrices' NaNs included. Steps at K = 3 / K = 8, cycles: FairGrad 752 /
// 1,990, NashMTL 479 / 1,713 (thread design 1,550 / 5,139 and 614 / 2,789).
// Two layouts were measured and not taken: every multiplier in one lane
// (695 and 488 at K = 3, but 2,348 and 2,453 at K = 8), and a lane a row of
// J with each pivot row shuffled out before its lanes divide (891 and 647
// at K = 3: a shuffle round on the chain at every pivot).
//
// The floor. Under bitwise equality a step's chain at K = 3 still holds
// one powf (or a multiply and a division), the 2 pivot divisions and the 3
// dependent back-substitution divisions, about 254 + 5 x 58 cycles for
// FairGrad and 62 + 5 x 58 for NashMTL, plus two shuffle latencies and the
// adds; no order of operations that keeps the bits shortens it, so the
// operations bound, some 10^5 times shorter, is out of reach.
//
// MGDA. A Frank-Wolfe step is one chain: G w, its argmin, d = w - e_t,
// G d, d . G d + EPS, the division, the clamp and the update; 186 cycles at
// K = 3 and 436 at K = 8 in one thread (the `thread` design, kept by name).
// Under bitwise equality that chain holds one __fdiv_rn (58) and some 21
// dependent adds, multiplies and selects (~4.9 each), ~160 cycles at K = 3:
// the floor, some 10^5 times the operations bound. Its length is left alone;
// its count is cut. A step is a fixed function of (G, w), so once a step
// leaves w's bits unchanged, every later one would, and w is the 250-step
// result: the default design compares w with the step before, on
// __float_as_uint (signed zeros apart, NaNs alike), after every
// min_norm_design(K).every steps, and stops there. Solves whose optimum is
// a vertex stop within a few steps; interior optima, where the iterates
// zig-zag, run all 250.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (python -m
// gaitpd_torch.tools.mtl_solver_clock). clock64() cycles a step on a seeded
// matrix that runs 250 steps, K = 2 / 3 / 8: thread 129.7 / 185.9 / 436.1;
// one thread with the stop, compared after every 1 / 4 / 8 steps: 170.8 /
// 133.3 / 127.1, 231.9 / 181.0 / 173.5, 505.2 / 478.0 / 927.4; the rows of
// G on lanes (lane i forms row i of G w and of G d, shuffles gather them)
// 225.7 / 186.6 / 180.3, 266.9 / 225.2 / 218.8, 477.2 / 422.2 / 412.5. A
// third layout was not taken: the step towards vertex c on lane c, gamma
// shuffled from the argmin's lane (268.0 / 185.7 / 613.1 at every 4): the
// shuffle costs what the chain saves. Those probe kernels schedule unlike
// the production ones, so the choice was settled on the production kernels
// themselves, each cadence (2, 4, 8, 16) and verdict (at once, or read one
// block later so that the branch waits on nothing) instantiated, device ms
// of a 250-step solve from CUDA graphs: at K = 3 thread 0.0240, one thread
// compared every 16 steps 0.0236 (every 8: 0.0241, every 4: 0.0253); at
// K = 8 thread 0.0579, the rows every 2 lagged 0.0554 (one thread every 8:
// 0.1037, its code too large). At K = 5 no variant with the stop is as
// fast as thread's 0.0341 (the fastest, every 8 lagged, 0.0349: 2.2 %).
// Ends of a cadence: a solve that stops at step 59 took 0.0073 ms at every
// 4 and 0.0077 at every 16 (thread 0.0441).
//
// Launch: the Newton solvers and MGDA at K = 7 and 8 take blocks of
// kWarpsPerBlock warps, a warp a matrix, ceil(N / kWarpsPerBlock) blocks;
// MGDA below K = 7 blocks of 32 threads, a thread a matrix. K is fixed at
// compile time, 1..8, so that every loop over K unrolls and G, J, w and the
// right-hand side stay in registers; 2K <= 16 lanes do the right-hand side.
//
// Plain C interface, bound with ctypes (gaitpd_torch/ops/mtl_solvers.py).

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-8f;
constexpr float kFloor = 1e-6f;  // the Newton solvers' lower clip
constexpr int kMinNormIters = 250;
constexpr int kFairGradIters = 100;
constexpr int kNashMtlIters = 50;
constexpr int kMaxK = 8;
constexpr int kThreads = 32;        // the thread design: a block of 32 matrices
constexpr int kWarpsPerBlock = 4;   // the warp design: a block of 4 matrices
constexpr unsigned kFullMask = 0xffffffffu;

enum Method { kMinNorm, kFairGrad, kNashMtl };
enum Variant { kThreadVariant = 0, kWarpVariant = 1 };

// MGDA's default design at k tasks: its layout (the rows of G on the lanes
// of a warp, else one thread a matrix), the steps between two compares of
// its stop, and whether the compare's verdict is read one block later. At
// each k, the fastest 250-step solve of the production kernels' 19 variants
// (python -m gaitpd_torch.tools.mtl_solver_clock), an immediate verdict
// where one was within 1 % of it.
struct MinNormDesign {
  bool rows;
  int every;
  bool lagged;
};
__host__ __device__ constexpr MinNormDesign min_norm_design(int k) {
  return k <= 3   ? MinNormDesign{false, 16, false}
         : k == 4 ? MinNormDesign{false, 16, true}
         : k <= 6 ? MinNormDesign{false, 8, true}
         : k == 7 ? MinNormDesign{true, 16, false}
                  : MinNormDesign{true, 2, true};
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp on the card: a NaN passes through, else max, then min
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

template <int K>
__device__ __forceinline__ float dot(const float (&a)[K], const float (&b)[K]) {
  float s = mul(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < K; ++i) s = add(s, mul(a[i], b[i]));
  return s;
}

template <int K>
__device__ __forceinline__ void matvec(const float (&g)[K][K], const float (&w)[K],
                                       float (&out)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) out[i] = dot(g[i], w);
}

// v[i] for an index known only at run time, without local memory
template <int K>
__device__ __forceinline__ float pick(const float (&v)[K], int i) {
  float r = v[0];
#pragma unroll
  for (int j = 1; j < K; ++j) r = i == j ? v[j] : r;
  return r;
}

template <int K>
__device__ __forceinline__ void min_norm_init(float (&w)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) w[i] = static_cast<float>(1.0 / K);  // as torch.full(1.0 / k)
}

// One Frank-Wolfe step with the exact line search (minnorm.py:35-55)
template <int K>
__device__ __forceinline__ void min_norm_step(const float (&g)[K][K], float (&w)[K]) {
  float gw[K], e[K], d[K], gd[K];
  matvec(g, w, gw);
  int t = 0;
  float best = gw[0];
#pragma unroll
  for (int j = 1; j < K; ++j) {
    if (gw[j] < best) {
      best = gw[j];
      t = j;
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    e[i] = i == t ? 1.0f : 0.0f;
    d[i] = sub(w[i], e[i]);
  }
  matvec(g, d, gd);
  const float gamma = clamp(div(dot(d, gw), add(dot(d, gd), kEps)), 0.0f, 1.0f);
  const float keep = sub(1.0f, gamma);
#pragma unroll
  for (int i = 0; i < K; ++i) w[i] = add(mul(keep, w[i]), mul(gamma, e[i]));
}

// The thread design: the reference's 250 steps, one thread.
template <int K>
__device__ void min_norm(const float (&g)[K][K], float (&w)[K]) {
  min_norm_init(w);
#pragma unroll 1
  for (int it = 0; it < kMinNormIters; ++it) min_norm_step(g, w);
}

// The same step on the lanes of a warp (the default design at K = 7 and 8):
// lane i < K holds row i of G (the lanes above K repeat row i mod K) and forms
// row i of G w, then of G d; shuffles gather each to every lane, which forms
// the argmin, d, the line search and the update alike. Each entry is the
// serial step's sum in its order, so w keeps its bits.
template <int K>
__device__ __forceinline__ void min_norm_step_rows(const float (&grow)[K], float (&w)[K]) {
  float gw[K], e[K], d[K], gd[K];
  const float gw_mine = dot(grow, w);
#pragma unroll
  for (int j = 0; j < K; ++j) gw[j] = __shfl_sync(kFullMask, gw_mine, j);
  int t = 0;
  float best = gw[0];
#pragma unroll
  for (int j = 1; j < K; ++j) {
    if (gw[j] < best) {
      best = gw[j];
      t = j;
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    e[i] = i == t ? 1.0f : 0.0f;
    d[i] = sub(w[i], e[i]);
  }
  const float gd_mine = dot(grow, d);
#pragma unroll
  for (int j = 0; j < K; ++j) gd[j] = __shfl_sync(kFullMask, gd_mine, j);
  const float gamma = clamp(div(dot(d, gw), add(dot(d, gd), kEps)), 0.0f, 1.0f);
  const float keep = sub(1.0f, gamma);
#pragma unroll
  for (int i = 0; i < K; ++i) w[i] = add(mul(keep, w[i]), mul(gamma, e[i]));
}

// w and v the same bits, entry by entry (signed zeros apart, NaNs alike)
template <int K>
__device__ __forceinline__ bool same_bits(const float (&w)[K], const float (&v)[K]) {
  unsigned diff = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) diff |= __float_as_uint(w[i]) ^ __float_as_uint(v[i]);
  return diff == 0;
}

// Frank-Wolfe from w = 1/K by `step`, ended after the first step s, a
// multiple of Every, that leaves w's bits as they were: a step is a fixed
// function of (G, w), so every later step would too, and w is the 250-step
// result. Lagged: the compare's verdict is read after the next Every steps,
// so that the branch waits on nothing (Every more steps past the fixed
// point). Returns s, or 250 where no such step came.
template <int K, int Every, bool Lagged, class Step>
__device__ __forceinline__ int min_norm_until_fixed(float (&w)[K], Step step) {
  min_norm_init(w);
  bool fixed = false;
  int s = 0;
#pragma unroll 1
  for (; s + Every <= kMinNormIters; s += Every) {
#pragma unroll
    for (int r = 1; r < Every; ++r) step(w);
    float before[K];
#pragma unroll
    for (int i = 0; i < K; ++i) before[i] = w[i];
    step(w);
    if constexpr (Lagged) {
      if (fixed) return s;
      fixed = same_bits(w, before);
    } else if (same_bits(w, before)) {
      return s + Every;
    }
  }
  if constexpr (Lagged) {
    if (fixed) return s;
  }
#pragma unroll 1
  for (; s < kMinNormIters; ++s) step(w);
  return kMinNormIters;
}

// ---------------------------------------------------------------------------
// The warp design: the lanes of one warp share a Newton solve; every lane
// holds G and w, and ends each step with the same w.

// The right-hand side's transcendental or division calls, one a lane: lane
// i < K its task's t1 (FairGrad w_i^e1, NashMTL 1/w_i), lane K + i its t2
// (w_i^e2, 1/(w_i w_i)); the lanes above 2K repeat lane K's.
template <int K, Method M>
__device__ __forceinline__ float rhs_on_lanes(const float (&w)[K], float e1, float e2,
                                              int lane) {
  const bool first = lane < K;
  const float wt = pick(w, first ? lane : lane - K);
  if constexpr (M == kFairGrad) {
    return powf(wt, first ? e1 : e2);
  } else {
    return div(1.0f, first ? wt : mul(wt, wt));
  }
}

// One damped Newton step: w <- max(w - damping (J + EPS I)^-1 F, 1e-6) with
// F_i = (G w)_i - t1_i and J = G + diag(scale t2_i) (FairGrad's scale
// 1/alpha, NashMTL's none), solved as newton_step solves it.
template <int K, Method M>
__device__ __forceinline__ void warp_newton_step(const float (&g)[K][K], float inv_a, float e1,
                                                 float e2, float damping, int lane,
                                                 float (&w)[K]) {
  const float t = rhs_on_lanes<K, M>(w, e1, e2, lane);
  float gw[K], a[K][K], b[K];
  matvec(g, w, gw);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    b[i] = sub(gw[i], __shfl_sync(kFullMask, t, i));
    const float t2 = __shfl_sync(kFullMask, t, K + i);
    const float diag = M == kFairGrad ? mul(inv_a, t2) : t2;
#pragma unroll
    for (int j = 0; j < K; ++j) a[i][j] = g[i][j];
    a[i][i] = add(add(g[i][i], diag), kEps);
  }
  // elimination on every lane alike; where two or more rows lie below a
  // pivot, lane r forms row r's multiplier (the other lanes divide the pivot
  // by itself) and shuffles bring them to every lane
#pragma unroll
  for (int p = 0; p < K; ++p) {
    float m[K];
    if (K - p - 1 >= 2) {
      float num = a[p][p];
#pragma unroll
      for (int r = p + 1; r < K; ++r) num = lane == r ? a[r][p] : num;
      const float mine = div(num, a[p][p]);
#pragma unroll
      for (int r = p + 1; r < K; ++r) m[r] = __shfl_sync(kFullMask, mine, r);
    } else {
#pragma unroll
      for (int r = p + 1; r < K; ++r) m[r] = div(a[r][p], a[p][p]);
    }
#pragma unroll
    for (int r = p + 1; r < K; ++r) {
#pragma unroll
      for (int c = p + 1; c < K; ++c) a[r][c] = sub(a[r][c], mul(m[r], a[p][c]));
      b[r] = sub(b[r], mul(m[r], b[p]));
    }
  }
  // back substitution and the clamp, on every lane alike
  float x[K];
#pragma unroll
  for (int p = K - 1; p >= 0; --p) {
    float s = b[p];
#pragma unroll
    for (int c = p + 1; c < K; ++c) s = sub(s, mul(a[p][c], x[c]));
    x[p] = div(s, a[p][p]);
  }
#pragma unroll
  for (int i = 0; i < K; ++i) w[i] = clamp_min(sub(w[i], mul(damping, x[i])), kFloor);
}

// A whole FairGrad (minnorm.py:125-141) or NashMTL (:144-158) solve on one
// warp; every lane ends with the same w.
template <int K, Method M>
__device__ void warp_newton(const float (&g)[K][K], float alpha, int lane, float (&w)[K]) {
  float inv_a = 0.0f, e1 = 0.0f, e2 = 0.0f;
  if constexpr (M == kFairGrad) {
    inv_a = div(1.0f, alpha);
    e1 = -inv_a;
    e2 = sub(e1, 1.0f);
  }
#pragma unroll
  for (int i = 0; i < K; ++i) w[i] = M == kFairGrad ? static_cast<float>(1.0 / K) : 1.0f;
  const int iters = M == kFairGrad ? kFairGradIters : kNashMtlIters;
  const float damping = M == kFairGrad ? 0.5f : 0.8f;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) warp_newton_step<K, M>(g, inv_a, e1, e2, damping, lane, w);
}

// ---------------------------------------------------------------------------
// Kernels

// MGDA one thread a matrix: Every > 0 its solve with the stop
// (min_norm_until_fixed<K, Every, Lagged>); Every = 0 the reference's 250
// steps (the thread design)
template <int K, Method M, int Every = 0, bool Lagged = false>
__global__ void __launch_bounds__(kThreads)
mtl_solver_kernel(const float* __restrict__ gram, int n, float alpha, float* __restrict__ out) {
  static_assert(M == kMinNorm, "FairGrad and NashMTL run a warp a matrix");
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n) return;
  float g[K][K], w[K];
  const float* gm = gram + static_cast<size_t>(m) * K * K;
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) g[i][j] = gm[i * K + j];
  }
  if constexpr (Every > 0) {
    min_norm_until_fixed<K, Every, Lagged>(w, [&](float (&v)[K]) { min_norm_step(g, v); });
  } else {
    min_norm(g, w);
  }
#pragma unroll
  for (int i = 0; i < K; ++i) out[static_cast<size_t>(m) * K + i] = w[i];
}

// A warp a matrix: MGDA's rows layout with the stop, as mtl_solver_kernel's;
// FairGrad's and NashMTL's Newton solves
template <int K, Method M, int Every = 0, bool Lagged = false>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
mtl_solver_warp_kernel(const float* __restrict__ gram, int n, float alpha,
                       float* __restrict__ out) {
  const int m = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= n) return;  // the whole warp: the shuffles need all 32 lanes
  float w[K];
  const float* gm = gram + static_cast<size_t>(m) * K * K;
  if constexpr (M == kMinNorm) {
    float grow[K];
#pragma unroll
    for (int j = 0; j < K; ++j) grow[j] = gm[(lane % K) * K + j];
    min_norm_until_fixed<K, Every, Lagged>(w, [&](float (&v)[K]) { min_norm_step_rows(grow, v); });
  } else {
    float g[K][K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
#pragma unroll
      for (int j = 0; j < K; ++j) g[i][j] = gm[i * K + j];
    }
    warp_newton<K, M>(g, alpha, lane, w);
  }
  if (lane < K) out[static_cast<size_t>(m) * K + lane] = pick(w, lane);
}

// Host side: one launch for n matrices, K picked at run time.

template <int K, Method M>
void launch_k(const float* gram, float* out, int n, float alpha, int variant, cudaStream_t s) {
  const int thread_blocks = (n + kThreads - 1) / kThreads;
  const int warp_blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if constexpr (M == kMinNorm) {
    constexpr MinNormDesign d = min_norm_design(K);
    if (variant == kThreadVariant) {
      mtl_solver_kernel<K, M><<<thread_blocks, kThreads, 0, s>>>(gram, n, alpha, out);
    } else if constexpr (d.rows) {
      mtl_solver_warp_kernel<K, M, d.every, d.lagged>
          <<<warp_blocks, kWarpsPerBlock * 32, 0, s>>>(gram, n, alpha, out);
    } else {
      mtl_solver_kernel<K, M, d.every, d.lagged>
          <<<thread_blocks, kThreads, 0, s>>>(gram, n, alpha, out);
    }
  } else {
    mtl_solver_warp_kernel<K, M><<<warp_blocks, kWarpsPerBlock * 32, 0, s>>>(gram, n, alpha, out);
  }
}

// Whether `method` has the design `variant`: every solver its default
// (kWarpVariant), MGDA also its thread design
__host__ __device__ constexpr bool has_design(int method, int variant) {
  return variant == kWarpVariant || (method == kMinNorm && variant == kThreadVariant);
}

template <Method M>
int launch(const float* gram, float* out, int n, int k, float alpha, int variant, void* stream) {
  if (n < 0 || k < 1 || k > kMaxK || !has_design(M, variant)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch_k<1, M>(gram, out, n, alpha, variant, s); break;
    case 2: launch_k<2, M>(gram, out, n, alpha, variant, s); break;
    case 3: launch_k<3, M>(gram, out, n, alpha, variant, s); break;
    case 4: launch_k<4, M>(gram, out, n, alpha, variant, s); break;
    case 5: launch_k<5, M>(gram, out, n, alpha, variant, s); break;
    case 6: launch_k<6, M>(gram, out, n, alpha, variant, s); break;
    case 7: launch_k<7, M>(gram, out, n, alpha, variant, s); break;
    default: launch_k<8, M>(gram, out, n, alpha, variant, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each solves n problems on `stream`: gram (n, k, k) -> out (n, k),
// contiguous f32 device pointers, 1 <= k <= 8. Returns a cudaError_t: 0 on
// success, cudaErrorInvalidValue for sizes the kernel does not take.
// min_norm_solver, fairgrad_solver and nashmtl_solver run their default
// design (1; MGDA's with the stop), min_norm_solver_variant MGDA's design by
// number (0 thread, 1 the default).
int min_norm_solver(const float* gram, float* out, int n, int k, void* stream) {
  return launch<kMinNorm>(gram, out, n, k, 0.0f, kWarpVariant, stream);
}

int fairgrad_solver(const float* gram, float* out, int n, int k, float alpha, void* stream) {
  return launch<kFairGrad>(gram, out, n, k, alpha, kWarpVariant, stream);
}

int nashmtl_solver(const float* gram, float* out, int n, int k, void* stream) {
  return launch<kNashMtl>(gram, out, n, k, 0.0f, kWarpVariant, stream);
}

int min_norm_solver_variant(const float* gram, float* out, int n, int k, int variant,
                            void* stream) {
  return launch<kMinNorm>(gram, out, n, k, 0.0f, variant, stream);
}

// The launch of a design of `method` (0 MGDA, 1 FairGrad, 2 NashMTL) at k
// tasks: threads a block, lanes a matrix, the steps between two compares of
// MGDA's stop (0: none, 250 steps) and whether its verdict is lagged.
int mtl_solver_launch_config(int method, int variant, int k, int* threads, int* lanes,
                             int* every, int* lagged) {
  if (method < kMinNorm || method > kNashMtl || k < 1 || k > kMaxK ||
      !has_design(method, variant)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool stop = method == kMinNorm && variant == kWarpVariant;
  const MinNormDesign d = min_norm_design(k);
  const bool warp = variant == kWarpVariant && (method != kMinNorm || d.rows);
  *threads = warp ? kWarpsPerBlock * 32 : kThreads;
  *lanes = warp ? 32 : 1;
  *every = stop ? d.every : 0;
  *lagged = stop && d.lagged;
  return 0;
}

}  // extern "C"
