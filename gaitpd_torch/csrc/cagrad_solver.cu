// cagrad_solver: the CAGrad dual on the probability simplex, for NVIDIA
// Hopper (sm_90a), one Gram matrix per thread, everything in registers.
//
// Not a TPU kernel. The JAX package solves this inside its compiled step
// (gaitpd/learning/minnorm.py:58-122, cagrad_weights, called from
// gaitpd/learning/mtl.py:403-428, CAGrad.combine); XLA fuses its loops into
// that program. Eager PyTorch would issue some 100 000 launches on 3x3
// tensors for it every training step, and copying the Gram matrix to the
// host would add a synchronisation. This kernel runs the whole solver in one
// launch and reads and writes device memory only.
//
// What it computes, for each (K, K) Gram matrix G and the strength c:
//   c_coef = c sqrt(mean(G) + EPS) + EPS                 (mtl.py:412-413)
//   w = argmin over the simplex of  w . G b + c_coef sqrt(w . G w + EPS),
//       b = 1/K, by the same fixed iterations as the reference: 60 projected
//       gradient steps (step 1/(||G||_F + c_coef + EPS), sort-based simplex
//       projection), each followed by a 30-step golden-section search on
//       [0, 1] and accepted only if it lowers the objective; then 4 rounds
//       of the same search along the K(K-1) directions e_i - e_j, scaled by
//       w_j, in the order i = 0..K-1, j = 0..K-1, j != i (minnorm.py:102-108).
// Every step is one IEEE round-to-nearest operation (__fadd_rn, __fmul_rn,
// __fdiv_rn, __fsqrt_rn: no contraction into FMA), and every sum is added
// left to right, exactly as the plain version
// (gaitpd_torch/learning/minnorm.py) writes it, so the two agree bit for
// bit. The golden-section comparisons near the optimum are decided by
// rounding; any other order of operations would stop elsewhere on the flat
// stretch around it.
//
// What bounds it. Neither bytes (K*K + K floats) nor operations (about
// 2e5 f32 operations at K = 3; nanoseconds at 67 TFLOP/s) but the latency
// of its chain of dependent scalar operations. Counted from the code at
// K = 3, with about 4 cycles for an add or multiply and about 36 for a
// square root or division: a golden-section step is 16 dependent operations
// and one square root (the interval, the two points, one row of G w, the
// dot product, the objective, the compare), about 100 cycles, so a search of
// 30 steps about 3,000; an outer step adds the gradient, the projection and
// the accept test, about 350 more. 60 outer steps (about 201,000 cycles) and
// 4 x 6 polish searches (about 74,000) make about 275,000 cycles: about
// 0.14 ms at the H100 SXM's 1,980 MHz maximum SM clock. No parallelism
// across threads can shorten it: every step depends on the last.
//
// What the design does about it. One thread per Gram matrix, K fixed at
// compile time (1..8) so that G, w and the search direction stay in
// registers and every loop over K unrolls; the sort of the projection is a
// fixed compare-exchange network. The two objective evaluations of each
// golden-section step are independent and written side by side, so their
// instructions interleave and the step costs one evaluation's latency.
// The main path solves one matrix: one block of one busy thread.
//
// Plain C interface, bound with ctypes (gaitpd_torch/ops/cagrad_solver.py).

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-8f;
constexpr float kInvPhi = 0.6180339887498949f;
constexpr int kIters = 60;
constexpr int kLsIters = 30;
constexpr int kPolishRounds = 4;
constexpr int kMaxK = 8;
constexpr int kThreads = 32;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

template <int K>
struct Problem {
  float g[K][K];  // Gram matrix
  float gb[K];    // G b, b = 1/K
  float c;        // c_coef
};

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

// f(w) = w . G b + c_coef sqrt(w . G w + EPS)
template <int K>
__device__ __forceinline__ float objective(const Problem<K>& p, const float (&w)[K]) {
  float gw[K];
  matvec(p.g, w, gw);
  return add(dot(w, p.gb), mul(p.c, __fsqrt_rn(add(dot(w, gw), kEps))));
}

// Euclidean projection onto the simplex (minnorm.py:22-32): sort
// descending, theta from the largest rho with u_rho > (cumsum_rho - 1)/(rho+1).
template <int K>
__device__ __forceinline__ void project_simplex(const float (&v)[K], float (&out)[K]) {
  float u[K];
#pragma unroll
  for (int i = 0; i < K; ++i) u[i] = v[i];
  // odd-even transposition network: K passes of compare-exchange
#pragma unroll
  for (int pass = 0; pass < K; ++pass) {
#pragma unroll
    for (int i = pass & 1; i + 1 < K; i += 2) {
      const float a = u[i], b = u[i + 1];
      u[i] = fmaxf(a, b);
      u[i + 1] = fminf(a, b);
    }
  }
  float cum = u[0], theta = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j > 0) cum = add(cum, u[j]);
    const float t = div(sub(cum, 1.0f), static_cast<float>(j + 1));
    if (j == 0 || sub(u[j], t) > 0.0f) theta = t;  // rho = 0 when no index holds
  }
#pragma unroll
  for (int i = 0; i < K; ++i) out[i] = fmaxf(sub(v[i], theta), 0.0f);
}

// argmin over g in [0, 1] of f(w + g d), 30 golden-section steps.
template <int K>
__device__ float golden(const Problem<K>& p, const float (&w)[K], const float (&d)[K]) {
  float lo = 0.0f, hi = 1.0f;
#pragma unroll 1
  for (int it = 0; it < kLsIters; ++it) {
    const float m1 = sub(hi, mul(kInvPhi, sub(hi, lo)));
    const float m2 = add(lo, mul(kInvPhi, sub(hi, lo)));
    float w1[K], w2[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      w1[i] = add(w[i], mul(m1, d[i]));
      w2[i] = add(w[i], mul(m2, d[i]));
    }
    const float f1 = objective(p, w1);  // independent of f2: they interleave
    const float f2 = objective(p, w2);
    if (f1 > f2) {
      lo = m1;
    } else {
      hi = m2;
    }
  }
  return mul(0.5f, add(lo, hi));
}

// w <- w + golden(w, d) d, kept only if it lowers the objective.
template <int K>
__device__ __forceinline__ void line_step(const Problem<K>& p, float (&w)[K],
                                          const float (&d)[K]) {
  const float step = golden(p, w, d);
  float wn[K];
#pragma unroll
  for (int i = 0; i < K; ++i) wn[i] = add(w[i], mul(step, d[i]));
  if (objective(p, wn) < objective(p, w)) {
#pragma unroll
    for (int i = 0; i < K; ++i) w[i] = wn[i];
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
cagrad_solver_kernel(const float* __restrict__ gram, int n, float c, float* __restrict__ w_out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n) return;
  Problem<K> p;
  const float* gm = gram + static_cast<size_t>(m) * K * K;
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) p.g[i][j] = gm[i * K + j];
  }
  // sums of the entries and of their squares, row-major, left to right
  float total = p.g[0][0], frob = mul(p.g[0][0], p.g[0][0]);
#pragma unroll
  for (int e = 1; e < K * K; ++e) {
    total = add(total, p.g[e / K][e % K]);
    frob = add(frob, mul(p.g[e / K][e % K], p.g[e / K][e % K]));
  }
  p.c = add(mul(c, __fsqrt_rn(add(div(total, static_cast<float>(K * K)), kEps))), kEps);
  float w[K];
#pragma unroll
  for (int i = 0; i < K; ++i) w[i] = static_cast<float>(1.0 / K);  // as torch.full(1.0 / k)
  matvec(p.g, w, p.gb);
  const float lips = add(add(__fsqrt_rn(frob), p.c), kEps);

#pragma unroll 1
  for (int it = 0; it < kIters; ++it) {
    float gw[K], v[K], proj[K], d[K];
    matvec(p.g, w, gw);
    const float root = __fsqrt_rn(add(dot(w, gw), kEps));
#pragma unroll
    for (int i = 0; i < K; ++i) {
      v[i] = sub(w[i], div(add(p.gb[i], div(mul(p.c, gw[i]), root)), lips));
    }
    project_simplex(v, proj);
#pragma unroll
    for (int i = 0; i < K; ++i) d[i] = sub(proj[i], w[i]);
    line_step(p, w, d);
  }

  // Polish along e_i - e_j, scaled by w_j so that w stays >= 0.
#pragma unroll 1
  for (int round = 0; round < kPolishRounds; ++round) {
#pragma unroll 1
    for (int i = 0; i < K; ++i) {
#pragma unroll 1
      for (int j = 0; j < K; ++j) {
        if (j == i) continue;
        float gmax = 0.0f;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          if (q == j) gmax = w[q];
        }
        float d[K];
#pragma unroll
        for (int q = 0; q < K; ++q) d[q] = q == i ? gmax : (q == j ? -gmax : 0.0f);
        line_step(p, w, d);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) w_out[static_cast<size_t>(m) * K + i] = w[i];
}

template <int K>
void launch(const float* gram, float* w, int n, float c, cudaStream_t stream) {
  const int grid = (n + kThreads - 1) / kThreads;
  cagrad_solver_kernel<K><<<grid, kThreads, 0, stream>>>(gram, n, c, w);
}

}  // namespace

extern "C" {

// Solves n problems on `stream`: gram (n, k, k) -> w (n, k), contiguous f32
// device pointers, 1 <= k <= 8. Returns a cudaError_t: 0 on success,
// cudaErrorInvalidValue for sizes the kernel does not take.
int cagrad_solver(const float* gram, float* w, int n, int k, float c, void* stream) {
  if (n < 0 || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch<1>(gram, w, n, c, s); break;
    case 2: launch<2>(gram, w, n, c, s); break;
    case 3: launch<3>(gram, w, n, c, s); break;
    case 4: launch<4>(gram, w, n, c, s); break;
    case 5: launch<5>(gram, w, n, c, s); break;
    case 6: launch<6>(gram, w, n, c, s); break;
    case 7: launch<7>(gram, w, n, c, s); break;
    default: launch<8>(gram, w, n, c, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
