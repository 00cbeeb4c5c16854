// cagrad_solver: the CAGrad dual on the probability simplex, for NVIDIA
// Hopper (sm_90a), one warp per Gram matrix, everything in registers.
//
// Not a TPU kernel. The JAX package solves this inside its compiled step
// (gaitpd/learning/minnorm.py:58-122, cagrad_weights, called from
// gaitpd/learning/mtl.py:403-428, CAGrad.combine); XLA fuses its loops into
// that program. Eager PyTorch would issue some 100 000 launches on 3x3
// tensors for it every training step, and copying the Gram matrix to the
// host would add a synchronisation. This kernel runs the whole solver in one
// launch and reads and writes device memory only.
//
// What it computes, for each (K, K) Gram matrix G and the strength c (one c
// for all matrices, or c[m] for matrix m: an HP grid's instances each have
// their own; both read the same f32 value, so equal values give equal bits):
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
// of its chain of dependent scalar operations. Measured on an NVIDIA H100
// 80GB HBM3 at its 700 W limit, SM clock 1,976 MHz, with clock64() stamps
// (PERF.md): an add or multiply 4 cycles, __fsqrt_rn about
// 43, __fdiv_rn about 37, the K = 3 objective 86; a serial golden-section
// step took about 235 cycles, not one objective's latency, because the two
// evaluations of a step do not overlap (each square root branches to a slow
// path for special operands). 84 searches of 30 steps were 91 % of the
// serial kernel's 652,000 cycles; the rest, about 60,000, is the outer
// steps' gradient, projection and accept tests.
//
// What the design does about it. The (lo, hi) of a golden-section step
// depends only on the earlier steps' comparisons, so a warp speculates 5
// steps at once: lane n < 31 is node n of the depth-5 decision tree (heap
// order; the children of n are 2n+1 after f1 <= f2, hi = m2, and 2n+2 after
// f1 > f2, lo = m1). Each lane replays its path's interval updates from the
// round's (lo, hi) with the serial loop's operations in its order, evaluates
// f at its node's m1 and m2, and compares; one __ballot_sync gathers the 31
// decisions, every lane walks the chosen path through the bits, and one pair
// of __shfl_sync hands the chosen depth-4 node's updated interval to every
// lane. 30 steps become 6 rounds of about 4 interval updates, two
// evaluations, a ballot and a shuffle: about 320 cycles a round against 5 x
// 235 serial. Every floating-point operation that decides w is one the
// serial loop performs, on the same operands, so w stays the plain
// version's bit for bit (degenerate matrices make every comparison false and
// the tree follows its all-"hi" path, as the serial loop). The outer steps
// stay serial, run alike on every lane. The chain estimate at K = 3: 84
// searches of about 1,930 cycles and the 60,000 serial cycles, about 222,000
// cycles, 0.11 ms at 1,980 MHz. G, w and the search direction stay in
// registers, K fixed at compile time (1..8) so that every loop over K
// unrolls; the sort of the projection is a fixed compare-exchange network.
// One warp (one block) a matrix; the main path solves one.
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

constexpr int kDepth = 5;                   // golden-section steps a round
constexpr int kNodes = (1 << kDepth) - 1;   // nodes of a round's decision tree
constexpr int kRounds = kLsIters / kDepth;
static_assert(kLsIters % kDepth == 0, "whole rounds");
static_assert(kNodes < kThreads, "a lane a node");
constexpr unsigned kAll = 0xffffffffu;

// argmin over g in [0, 1] of f(w + g d): 30 golden-section steps, the
// serial loop
//   m1 = hi - invphi (hi - lo); m2 = lo + invphi (hi - lo);
//   if f(w + m1 d) > f(w + m2 d) then lo = m1 else hi = m2,
// taken 5 steps a round across the warp (see the header). Every lane
// returns the same value.
template <int K>
__device__ float golden(const Problem<K>& p, const float (&w)[K], const float (&d)[K],
                        int lane) {
  const int node = lane < kNodes ? lane : 0;  // lane 31 repeats the root
  const int path = node + 1;  // below its leading one, the decisions from the root
  const int depth = 31 - __clz(path);
  float lo = 0.0f, hi = 1.0f;
#pragma unroll 1
  for (int round = 0; round < kRounds; ++round) {
    float a = lo, b = hi;
#pragma unroll
    for (int s = 0; s < kDepth - 1; ++s) {
      const bool right = s < depth && ((path >> (depth - 1 - s)) & 1);
      const bool left = s < depth && !right;
      const float span = sub(b, a);
      const float m1 = sub(b, mul(kInvPhi, span));
      const float m2 = add(a, mul(kInvPhi, span));
      a = right ? m1 : a;
      b = left ? m2 : b;
    }
    const float m1 = sub(b, mul(kInvPhi, sub(b, a)));
    const float m2 = add(a, mul(kInvPhi, sub(b, a)));
    float w1[K], w2[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      w1[i] = add(w[i], mul(m1, d[i]));
      w2[i] = add(w[i], mul(m2, d[i]));
    }
    const bool go_right = objective(p, w1) > objective(p, w2);
    const unsigned decided = __ballot_sync(kAll, go_right);
    int chosen = 0;  // the path's depth-4 node
#pragma unroll
    for (int s = 0; s < kDepth - 1; ++s) chosen = 2 * chosen + 1 + ((decided >> chosen) & 1);
    lo = __shfl_sync(kAll, go_right ? m1 : a, chosen);
    hi = __shfl_sync(kAll, go_right ? b : m2, chosen);
  }
  return mul(0.5f, add(lo, hi));
}

// w <- w + golden(w, d) d, kept only if it lowers the objective.
template <int K>
__device__ __forceinline__ void line_step(const Problem<K>& p, float (&w)[K],
                                          const float (&d)[K], int lane) {
  const float step = golden(p, w, d, lane);
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
cagrad_solver_kernel(const float* __restrict__ gram, int n, float c,
                     const float* __restrict__ c_per, float* __restrict__ w_out) {
  // one warp a matrix: every lane runs the serial steps alike
  const int m = blockIdx.x;
  const int lane = threadIdx.x;
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
  const float cm = c_per != nullptr ? c_per[m] : c;
  p.c = add(mul(cm, __fsqrt_rn(add(div(total, static_cast<float>(K * K)), kEps))), kEps);
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
    line_step(p, w, d, lane);
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
        line_step(p, w, d, lane);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) w_out[static_cast<size_t>(m) * K + i] = w[i];
  }
}

template <int K>
void launch(const float* gram, float* w, int n, float c, const float* c_per,
            cudaStream_t stream) {
  cagrad_solver_kernel<K><<<n, kThreads, 0, stream>>>(gram, n, c, c_per, w);
}

}  // namespace

extern "C" {

// Solves n problems on `stream`: gram (n, k, k) -> w (n, k), contiguous f32
// device pointers, 1 <= k <= 8; the strength c for every matrix, or, where
// c_per is not null, c_per[m] (n f32 on the device) for matrix m. Returns a
// cudaError_t: 0 on success, cudaErrorInvalidValue for sizes the kernel does
// not take.
int cagrad_solver(const float* gram, float* w, int n, int k, float c, const float* c_per,
                  void* stream) {
  if (n < 0 || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch<1>(gram, w, n, c, c_per, s); break;
    case 2: launch<2>(gram, w, n, c, c_per, s); break;
    case 3: launch<3>(gram, w, n, c, c_per, s); break;
    case 4: launch<4>(gram, w, n, c, c_per, s); break;
    case 5: launch<5>(gram, w, n, c, c_per, s); break;
    case 6: launch<6>(gram, w, n, c, c_per, s); break;
    case 7: launch<7>(gram, w, n, c, c_per, s); break;
    default: launch<8>(gram, w, n, c, c_per, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
