// clock64() probes of the solvers' dependent chains, for
// gaitpd_torch/tools/mtl_solver_clock.py: the latency of one operation of
// the chain (a dependent chain of `reps` of them, stamped before and after),
// and the cycles of a whole solve of each design of csrc/mtl_solvers.cu, run
// by its own device functions (this file includes that source), of
// FairGrad's and NashMTL's retired one-thread design (kept below), and of
// the layouts measured beside them.
//
// Plain C interface, bound with ctypes.

#include "../csrc/mtl_solvers.cu"

namespace {

// ---------------------------------------------------------------------------
// FairGrad's and NashMTL's first, one-thread design (retired from
// csrc/mtl_solvers.cu; kept here as the yardstick of the probes): one
// thread runs a whole Newton solve.

// x with a x = b: Gaussian elimination without pivoting, back substitution
template <int K>
__device__ __forceinline__ void solve(float (&a)[K][K], float (&b)[K], float (&x)[K]) {
#pragma unroll
  for (int p = 0; p < K; ++p) {
#pragma unroll
    for (int r = p + 1; r < K; ++r) {
      const float m = div(a[r][p], a[p][p]);
#pragma unroll
      for (int c = p + 1; c < K; ++c) a[r][c] = sub(a[r][c], mul(m, a[p][c]));
      b[r] = sub(b[r], mul(m, b[p]));
    }
  }
#pragma unroll
  for (int p = K - 1; p >= 0; --p) {
    float s = b[p];
#pragma unroll
    for (int c = p + 1; c < K; ++c) s = sub(s, mul(a[p][c], x[c]));
    x[p] = div(s, a[p][p]);
  }
}

// w <- max(w - damping (G + diag(diag) + EPS I)^-1 f, 1e-6)
template <int K>
__device__ __forceinline__ void newton_step(const float (&g)[K][K], float (&w)[K],
                                            float (&f)[K], const float (&diag)[K],
                                            float damping) {
  float a[K][K], delta[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) a[i][j] = g[i][j];
    a[i][i] = add(add(g[i][i], diag[i]), kEps);
  }
  solve(a, f, delta);
#pragma unroll
  for (int i = 0; i < K; ++i) w[i] = clamp_min(sub(w[i], mul(damping, delta[i])), kFloor);
}

// G w = w^(-1/alpha) (minnorm.py:125-141)
template <int K>
__device__ void fairgrad(const float (&g)[K][K], float alpha, float (&w)[K]) {
  const float inv_a = div(1.0f, alpha);
  const float e1 = -inv_a;
  const float e2 = sub(e1, 1.0f);
#pragma unroll
  for (int i = 0; i < K; ++i) w[i] = static_cast<float>(1.0 / K);
#pragma unroll 1
  for (int it = 0; it < kFairGradIters; ++it) {
    float gw[K], f[K], diag[K];
    matvec(g, w, gw);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      f[i] = sub(gw[i], powf(w[i], e1));
      diag[i] = mul(inv_a, powf(w[i], e2));
    }
    newton_step(g, w, f, diag, 0.5f);
  }
}

// G a = 1/a (minnorm.py:144-158)
template <int K>
__device__ void nashmtl(const float (&g)[K][K], float (&w)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) w[i] = 1.0f;
#pragma unroll 1
  for (int it = 0; it < kNashMtlIters; ++it) {
    float gw[K], f[K], diag[K];
    matvec(g, w, gw);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      f[i] = sub(gw[i], div(1.0f, w[i]));
      diag[i] = div(1.0f, mul(w[i], w[i]));
    }
    newton_step(g, w, f, diag, 0.8f);
  }
}

enum Probe {
  kCarrier = 0,  // x = base + x * zero: the carrier the powf chain needs
  kPowf = 1,     // x = powf(base + x * zero, e)
  kDiv = 2,      // x = c / x (__fdiv_rn): x and c / x take turns
  kShfl = 3,     // x = __shfl_sync(x, lane + 1)
  kAdd = 4,      // x = x + c
  kDiv2 = 5,     // two independent kDiv chains in one thread
  kDiv3 = 6,     // three
  kPowf2 = 7,    // two independent kPowf chains in one thread
  kRcp = 8,      // x = 1 / x (__frcp_rn)
};

// Two more layouts of a Newton step, beside csrc/mtl_solvers.cu's thread and
// warp designs (variant numbers 2 and 3 of probe_solve):
//   gather: the warp design with every multiplier formed in one lane (the
//     right-hand side's 2K calls on lanes, then newton_step on every lane);
//   rows: lane r < K owns row r of J + EPS I and F_r; each pivot row goes
//     to every lane by shuffles and the lanes below it form their
//     multipliers at once; every lane runs the back substitution.
constexpr int kGatherVariant = 2;
constexpr int kRowsVariant = 3;

template <int K, Method M>
__device__ void gather_newton(const float (&g)[K][K], float alpha, int lane, float (&w)[K]) {
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
  for (int it = 0; it < iters; ++it) {
    const float t = rhs_on_lanes<K, M>(w, e1, e2, lane);
    float gw[K], f[K], diag[K];
    matvec(g, w, gw);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      f[i] = sub(gw[i], __shfl_sync(kFullMask, t, i));
      const float t2 = __shfl_sync(kFullMask, t, K + i);
      diag[i] = M == kFairGrad ? mul(inv_a, t2) : t2;
    }
    newton_step(g, w, f, diag, damping);
  }
}

template <int K, Method M>
__device__ void rows_newton(const float (&g)[K][K], float alpha, int lane, float (&w)[K]) {
  float grow[K];
#pragma unroll
  for (int c = 0; c < K; ++c) grow[c] = lane < K ? g[0][c] : 0.0f;
#pragma unroll
  for (int r = 1; r < K; ++r) {
#pragma unroll
    for (int c = 0; c < K; ++c) grow[c] = lane == r ? g[r][c] : grow[c];
  }
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
  for (int it = 0; it < iters; ++it) {
    float t = 0.0f;
    if (lane < 2 * K) t = rhs_on_lanes<K, M>(w, e1, e2, lane);
    const float gw = dot(grow, w);
    const float t2 = __shfl_down_sync(kFullMask, t, K);
    float b = sub(gw, t);
    const float diag = M == kFairGrad ? mul(inv_a, t2) : t2;
    float a[K];
#pragma unroll
    for (int c = 0; c < K; ++c) a[c] = c == lane ? add(add(grow[c], diag), kEps) : grow[c];
    float u[K][K], v[K];
#pragma unroll
    for (int p = 0; p < K; ++p) {
#pragma unroll
      for (int c = p; c < K; ++c) u[p][c] = __shfl_sync(kFullMask, a[c], p);
      v[p] = __shfl_sync(kFullMask, b, p);
      if (lane > p && lane < K) {
        const float m = div(a[p], u[p][p]);
#pragma unroll
        for (int c = p + 1; c < K; ++c) a[c] = sub(a[c], mul(m, u[p][c]));
        b = sub(b, mul(m, v[p]));
      }
    }
    float x[K];
#pragma unroll
    for (int p = K - 1; p >= 0; --p) {
      float s = v[p];
#pragma unroll
      for (int c = p + 1; c < K; ++c) s = sub(s, mul(u[p][c], x[c]));
      x[p] = div(s, u[p][p]);
    }
#pragma unroll
    for (int i = 0; i < K; ++i) w[i] = clamp_min(sub(w[i], mul(damping, x[i])), kFloor);
  }
}

// MGDA's layouts of a Frank-Wolfe step (probe_min_norm), each but the first
// run under min_norm_until_fixed's stop, its compare after every
// `Every`-th step:
//   thread: csrc/mtl_solvers.cu's thread design, 250 steps, no stop;
//   thread_stop: the same step, one thread, with the stop (the default
//     design below K = 7);
//   vertices: min_norm_step_vertices below, lane c the step towards vertex
//     c (not taken: 185.7 cycles a step at K = 3 and every 4 against
//     thread_stop's 181.0, 268.0 against 133.3 at K = 2);
//   rows: csrc/mtl_solvers.cu's min_norm_step_rows, lane i row i of G w and
//     of G d (the default design at K = 7 and 8).
enum MinNormLayout { kMnThread = 0, kMnThreadStop = 1, kMnVertices = 2, kMnRows = 3 };

// vertices: the step on the lanes of a warp, each lane holding G and w:
// lane c < K forms the step towards vertex c from w alone (d = w - e_c, G d,
// d . G d + EPS), beside G w and its argmin t, which every lane forms alike;
// then d . G w and its own gamma, one division. A shuffle brings gamma from
// lane t to every lane, and every lane applies the update alike. Lane t runs
// exactly the serial step's operations, so w keeps its bits.
template <int K>
__device__ __forceinline__ void min_norm_step_vertices(const float (&g)[K][K], float (&w)[K],
                                                       int lane) {
  float gw[K], d[K], gd[K];
  const int c = lane < K ? lane : 0;  // the lanes above K repeat vertex 0
#pragma unroll
  for (int i = 0; i < K; ++i) d[i] = sub(w[i], i == c ? 1.0f : 0.0f);
  matvec(g, d, gd);
  const float den = add(dot(d, gd), kEps);
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
  const float mine = div(dot(d, gw), den);
  const float gamma = clamp(__shfl_sync(kFullMask, mine, t), 0.0f, 1.0f);
  const float keep = sub(1.0f, gamma);
#pragma unroll
  for (int i = 0; i < K; ++i) w[i] = add(mul(keep, w[i]), mul(gamma, i == t ? 1.0f : 0.0f));
}

// One MGDA solve in layout L on one warp, stamped around by lane 0, which
// also writes w and the step at which the solve stopped (250: none).
template <int K, int L, int Every>
__global__ void min_norm_clock_kernel(const float* __restrict__ gram, float* __restrict__ out,
                                      long long* cycles, int* stop) {
  const int lane = threadIdx.x;
  float g[K][K], grow[K], w[K];
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) g[i][j] = gram[i * K + j];
  }
  int s = kMinNormIters;
  if constexpr (L == kMnThread) {
    min_norm(g, w);
  } else if constexpr (L == kMnThreadStop) {
    s = min_norm_until_fixed<K, Every, false>(w, [&](float (&v)[K]) { min_norm_step(g, v); });
  } else if constexpr (L == kMnVertices) {
    s = min_norm_until_fixed<K, Every, false>(
        w, [&](float (&v)[K]) { min_norm_step_vertices(g, v, lane); });
  } else {
#pragma unroll
    for (int c = 0; c < K; ++c) grow[c] = gram[(lane % K) * K + c];
    s = min_norm_until_fixed<K, Every, false>(w, [&](float (&v)[K]) { min_norm_step_rows(grow, v); });
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) out[i] = w[i];
    *stop = s;
  }
  __syncwarp();
  const long long t1 = clock64();
  if (lane == 0) *cycles = t1 - t0;
}

// csrc/mtl_solvers.cu's MGDA kernels as launched there, at other cadences
// of the stop's compare: layout 0 the thread kernel (every 0: the thread
// design), layout 1 the rows kernel (a warp a matrix), the compare after
// every `every` steps, its verdict read at once or one block later.
template <int K, bool Lagged>
int launch_cadence(int layout, int every, const float* gram, int n, float* out,
                   cudaStream_t s) {
  const int tb = (n + kThreads - 1) / kThreads;
  const int wb = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  constexpr int kW = kWarpsPerBlock * 32;
#define CADENCE(E)                                                                       \
  if (layout == 0) {                                                                     \
    mtl_solver_kernel<K, kMinNorm, E, Lagged><<<tb, kThreads, 0, s>>>(gram, n, 0.0f, out); \
  } else {                                                                               \
    mtl_solver_warp_kernel<K, kMinNorm, E, Lagged><<<wb, kW, 0, s>>>(gram, n, 0.0f, out);  \
  }
  switch (every) {
    case 0:
      if (layout != 0 || Lagged) return static_cast<int>(cudaErrorInvalidValue);
      mtl_solver_kernel<K, kMinNorm><<<tb, kThreads, 0, s>>>(gram, n, 0.0f, out);
      break;
    case 2: CADENCE(2) break;
    case 4: CADENCE(4) break;
    case 8: CADENCE(8) break;
    case 16: CADENCE(16) break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CADENCE
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_cadence_k(int layout, int every, int lagged, const float* gram, int n, float* out,
                     cudaStream_t s) {
  return lagged ? launch_cadence<K, true>(layout, every, gram, n, out, s)
                : launch_cadence<K, false>(layout, every, gram, n, out, s);
}

template <int K, int L>
int launch_min_norm_every(int every, const float* gram, float* out, long long* cycles,
                          int* stop) {
  switch (every) {
    case 1: min_norm_clock_kernel<K, L, 1><<<1, 32>>>(gram, out, cycles, stop); break;
    case 2: min_norm_clock_kernel<K, L, 2><<<1, 32>>>(gram, out, cycles, stop); break;
    case 4: min_norm_clock_kernel<K, L, 4><<<1, 32>>>(gram, out, cycles, stop); break;
    case 8: min_norm_clock_kernel<K, L, 8><<<1, 32>>>(gram, out, cycles, stop); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_min_norm(int layout, int every, const float* gram, float* out, long long* cycles,
                    int* stop) {
  switch (layout) {
    case kMnThread:
      min_norm_clock_kernel<K, kMnThread, 1><<<1, 32>>>(gram, out, cycles, stop);
      return static_cast<int>(cudaGetLastError());
    case kMnThreadStop:
      return launch_min_norm_every<K, kMnThreadStop>(every, gram, out, cycles, stop);
    case kMnVertices:
      return launch_min_norm_every<K, kMnVertices>(every, gram, out, cycles, stop);
    case kMnRows:
      return launch_min_norm_every<K, kMnRows>(every, gram, out, cycles, stop);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One warp; lane 0 stamps. `zero` is a kernel argument, so that the compiler
// cannot fold x * zero away.
__global__ void op_chain_kernel(int probe, int reps, float base, float e, float zero,
                                long long* cycles, float* sink) {
  const int lane = threadIdx.x;
  float x = base + lane * zero;
  __syncwarp();
  const long long t0 = clock64();
  switch (probe) {
    case kCarrier:
#pragma unroll 16
      for (int i = 0; i < reps; ++i) x = add(base, mul(x, zero));
      break;
    case kPowf:
#pragma unroll 16
      for (int i = 0; i < reps; ++i) x = powf(add(base, mul(x, zero)), e);
      break;
    case kDiv:
#pragma unroll 16
      for (int i = 0; i < reps; ++i) x = div(e, x);
      break;
    case kShfl:
#pragma unroll 16
      for (int i = 0; i < reps; ++i) x = __shfl_sync(kFullMask, x, (lane + 1) % 32);
      break;
    case kDiv2: {
      float y = base + 0.5f;
#pragma unroll 16
      for (int i = 0; i < reps; ++i) {
        x = div(e, x);
        y = div(e, y);
      }
      x = add(x, y);
      break;
    }
    case kDiv3: {
      float y = base + 0.5f, z = base + 0.25f;
#pragma unroll 16
      for (int i = 0; i < reps; ++i) {
        x = div(e, x);
        y = div(e, y);
        z = div(e, z);
      }
      x = add(add(x, y), z);
      break;
    }
    case kPowf2: {
      float y = base;
#pragma unroll 16
      for (int i = 0; i < reps; ++i) {
        x = powf(add(base, mul(x, zero)), e);
        y = powf(add(base, mul(y, zero)), e);
      }
      x = add(x, y);
      break;
    }
    case kRcp:
#pragma unroll 16
      for (int i = 0; i < reps; ++i) x = __frcp_rn(x);
      break;
    default:
#pragma unroll 16
      for (int i = 0; i < reps; ++i) x = add(x, e);
      break;
  }
  sink[lane] = x;  // the stamp after the chain waits for its last link
  __syncwarp();
  const long long t1 = clock64();
  if (lane == 0) *cycles = t1 - t0;
}

// One solve of `method` in `variant` at K tasks, stamped around by lane 0.
template <int K, Method M, int V>
__global__ void solve_clock_kernel(const float* __restrict__ gram, float alpha,
                                   float* __restrict__ out, long long* cycles) {
  const int lane = threadIdx.x;
  float g[K][K], w[K];
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) g[i][j] = gram[i * K + j];
  }
  if constexpr (V == kThreadVariant) {
    if constexpr (M == kFairGrad) {
      fairgrad(g, alpha, w);
    } else {
      nashmtl(g, w);
    }
  } else if constexpr (V == kWarpVariant) {
    warp_newton<K, M>(g, alpha, lane, w);
  } else if constexpr (V == kGatherVariant) {
    gather_newton<K, M>(g, alpha, lane, w);
  } else {
    rows_newton<K, M>(g, alpha, lane, w);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) out[i] = w[i];
  }
  __syncwarp();
  const long long t1 = clock64();
  if (lane == 0) *cycles = t1 - t0;
}

template <int K, Method M>
int launch_solve(int variant, const float* gram, float alpha, float* out, long long* cycles) {
  switch (variant) {
    case kThreadVariant:
      solve_clock_kernel<K, M, kThreadVariant><<<1, 32>>>(gram, alpha, out, cycles);
      break;
    case kWarpVariant:
      solve_clock_kernel<K, M, kWarpVariant><<<1, 32>>>(gram, alpha, out, cycles);
      break;
    case kGatherVariant:
      solve_clock_kernel<K, M, kGatherVariant><<<1, 32>>>(gram, alpha, out, cycles);
      break;
    default:
      solve_clock_kernel<K, M, kRowsVariant><<<1, 32>>>(gram, alpha, out, cycles);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int probe_solve_k(int method, int variant, const float* gram, float alpha, float* out,
                  long long* cycles) {
  if (variant < kThreadVariant || variant > kRowsVariant) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (method) {
    case kFairGrad: return launch_solve<K, kFairGrad>(variant, gram, alpha, out, cycles);
    case kNashMtl: return launch_solve<K, kNashMtl>(variant, gram, alpha, out, cycles);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

__global__ void spin_kernel(long long cycles, long long* done) {
  const long long t0 = clock64();
  long long t = t0;
  while (t - t0 < cycles) t = clock64();
  *done = t - t0;
}

}  // namespace

extern "C" {

// probe: a Probe; one warp of 32 lanes (the thread design's solves run on
// every lane alike). cycles and sink are device pointers (1 and 32 entries).
int probe_op(int probe, int reps, float base, float e, float zero, long long* cycles,
             float* sink) {
  op_chain_kernel<<<1, 32>>>(probe, reps, base, e, zero, cycles, sink);
  return static_cast<int>(cudaGetLastError());
}

// method: 1 FairGrad, 2 NashMTL; variant: 0 thread, 1 warp, 2 gather, 3
// rows; k: 3 or 8. gram: k * k floats on the device, out: k.
int probe_solve(int method, int variant, int k, const float* gram, float alpha, float* out,
                long long* cycles) {
  if (k == 3) return probe_solve_k<3>(method, variant, gram, alpha, out, cycles);
  if (k == 8) return probe_solve_k<8>(method, variant, gram, alpha, out, cycles);
  return static_cast<int>(cudaErrorInvalidValue);
}

// layout: a MinNormLayout; every: 1, 2, 4 or 8 (the thread layout: any);
// k: 2..8. gram: k * k floats on the device, out: k, stop: one int.
int probe_min_norm(int layout, int every, int k, const float* gram, float* out,
                   long long* cycles, int* stop) {
  switch (k) {
    case 2: return launch_min_norm<2>(layout, every, gram, out, cycles, stop);
    case 3: return launch_min_norm<3>(layout, every, gram, out, cycles, stop);
    case 4: return launch_min_norm<4>(layout, every, gram, out, cycles, stop);
    case 5: return launch_min_norm<5>(layout, every, gram, out, cycles, stop);
    case 6: return launch_min_norm<6>(layout, every, gram, out, cycles, stop);
    case 7: return launch_min_norm<7>(layout, every, gram, out, cycles, stop);
    case 8: return launch_min_norm<8>(layout, every, gram, out, cycles, stop);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// MGDA's production kernels at K = k (2..8): layout 0 thread, 1 rows, the
// stop's compare after every `every` steps (0: none; the thread layout
// only), its verdict at once or (lagged != 0) one block later; n matrices on
// `stream`.
int probe_min_norm_cadence(int k, int layout, int every, int lagged, const float* gram, int n,
                           float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 2: return launch_cadence_k<2>(layout, every, lagged, gram, n, out, s);
    case 3: return launch_cadence_k<3>(layout, every, lagged, gram, n, out, s);
    case 4: return launch_cadence_k<4>(layout, every, lagged, gram, n, out, s);
    case 5: return launch_cadence_k<5>(layout, every, lagged, gram, n, out, s);
    case 6: return launch_cadence_k<6>(layout, every, lagged, gram, n, out, s);
    case 7: return launch_cadence_k<7>(layout, every, lagged, gram, n, out, s);
    case 8: return launch_cadence_k<8>(layout, every, lagged, gram, n, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One thread spinning for `cycles` SM cycles: its time under CUDA events
// gives the SM clock.
int probe_spin(long long cycles, long long* done) {
  spin_kernel<<<1, 1>>>(cycles, done);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
