// mtl_solvers: the simplex and fixed-point solvers of MGDA, FairGrad and
// NashMTL, for NVIDIA Hopper (sm_90a), one thread per Gram matrix,
// everything in registers.
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
// What bounds it. Neither bytes (K*K + K floats) nor operations (about
// 14,750 f32 operations for MGDA at K = 3, 7,000 for FairGrad, 3,500 for
// NashMTL: a fraction of a microsecond at 67 TFLOP/s) but the latency of
// each solve's chain of dependent scalar operations: at K = 3 one
// Frank-Wolfe step is about 30 dependent operations, one with a division;
// one Newton step about 20 with 6 divisions (and FairGrad's powf). Estimated
// from the CAGrad solver's clock64() readings on the same card (PERF.md:
// 4 cycles an add or multiply, about 37 a division): about 120 cycles a
// Frank-Wolfe step, 400 a FairGrad and 300 a NashMTL step, so 15, 20 and 8
// microseconds at 1,980 MHz.
//
// What the design does about it. A solve is serial by nature; the kernel
// keeps it in one thread's registers (K fixed at compile time, 1..8, so that
// every loop over K unrolls and G, J, w and the right-hand side stay in
// registers), so each step costs its chain's latency and nothing else. The
// main path solves one matrix a step; a batch of N runs N threads.
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
constexpr int kThreads = 32;

enum Method { kMinNorm, kFairGrad, kNashMtl };

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

// Frank-Wolfe with the exact line search (minnorm.py:35-55)
template <int K>
__device__ void min_norm(const float (&g)[K][K], float (&w)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) w[i] = static_cast<float>(1.0 / K);  // as torch.full(1.0 / k)
#pragma unroll 1
  for (int it = 0; it < kMinNormIters; ++it) {
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
}

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

template <int K, Method M>
__global__ void __launch_bounds__(kThreads)
mtl_solver_kernel(const float* __restrict__ gram, int n, float alpha, float* __restrict__ out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n) return;
  float g[K][K], w[K];
  const float* gm = gram + static_cast<size_t>(m) * K * K;
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) g[i][j] = gm[i * K + j];
  }
  if constexpr (M == kMinNorm) {
    min_norm(g, w);
  } else if constexpr (M == kFairGrad) {
    fairgrad(g, alpha, w);
  } else {
    nashmtl(g, w);
  }
#pragma unroll
  for (int i = 0; i < K; ++i) out[static_cast<size_t>(m) * K + i] = w[i];
}

// Host side: one launch for n matrices, K picked at run time.

template <int K, Method M>
void launch_k(const float* gram, float* out, int n, float alpha, cudaStream_t s) {
  const int blocks = (n + kThreads - 1) / kThreads;
  mtl_solver_kernel<K, M><<<blocks, kThreads, 0, s>>>(gram, n, alpha, out);
}

template <Method M>
int launch(const float* gram, float* out, int n, int k, float alpha, void* stream) {
  if (n < 0 || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch_k<1, M>(gram, out, n, alpha, s); break;
    case 2: launch_k<2, M>(gram, out, n, alpha, s); break;
    case 3: launch_k<3, M>(gram, out, n, alpha, s); break;
    case 4: launch_k<4, M>(gram, out, n, alpha, s); break;
    case 5: launch_k<5, M>(gram, out, n, alpha, s); break;
    case 6: launch_k<6, M>(gram, out, n, alpha, s); break;
    case 7: launch_k<7, M>(gram, out, n, alpha, s); break;
    default: launch_k<8, M>(gram, out, n, alpha, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each solves n problems on `stream`: gram (n, k, k) -> out (n, k),
// contiguous f32 device pointers, 1 <= k <= 8. Returns a cudaError_t: 0 on
// success, cudaErrorInvalidValue for sizes the kernel does not take.
int min_norm_solver(const float* gram, float* out, int n, int k, void* stream) {
  return launch<kMinNorm>(gram, out, n, k, 0.0f, stream);
}

int fairgrad_solver(const float* gram, float* out, int n, int k, float alpha, void* stream) {
  return launch<kFairGrad>(gram, out, n, k, alpha, stream);
}

int nashmtl_solver(const float* gram, float* out, int n, int k, void* stream) {
  return launch<kNashMtl>(gram, out, n, k, 0.0f, stream);
}

}  // extern "C"
