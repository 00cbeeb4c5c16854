// cheap_xattn: zero-parameter cross-attention softmax(A B^T / sqrt(d)) B, for
// NVIDIA Hopper (sm_90a), forward and backward. B is both key and value.
//
// Replaces the TPU kernel _xattn_kernel in gaitpd/ops/pallas_blocks.py
// (called by cheap_xattn_pallas) and the backward of its custom_vjp, which is
// the VJP of gaitpd/ops/attention.py::cheap_cross_attention:
//   A (N, Tq, d), B (N, Tk, d)  ->  O (N, Tq, d), f32, for N independent
//   problems, any Tq, Tk >= 1 and any d >= 1.
//
// The main path: the cheap-xattn fusion model sends the six directed stream
// pairs of a batch of 1024 window tuples through one launch each way, N = 6144
// problems of Tq = Tk = 64, d = 12. The problems are tiny (a 64 x 64 score
// matrix, 16 KB), so nothing of the Pallas tiling is carried over: a problem's
// scores never leave the SM, and the work is spread by problems.
//
// Five variants; gaitpd_torch/ops/cheap_xattn.py::_variant chooses one from
// (Tq, Tk, d) and the entry points refuse a variant that does not take the
// sizes:
//   0  one sweep, d = 12 as a compile-time width: Tk <= 64 (backward also
//      Tq <= 64); the main path;
//   1  one sweep, any d <= 64, rows zero-padded to a width of 16, 32 or 64;
//   2  two passes (the first design): d <= 64, chosen only beyond variant
//      3's lengths, Tk > 128 (backward: Tq or Tk > 128), which no model's
//      default path reaches; callable by name at every length;
//   3  one sweep over up to 128 keys, two lanes a query row: d <= 64,
//      64 < Tk <= 128 (backward: Tq and Tk <= 128, one of them > 64): the
//      FBG/FoG cheap-xattn fusion at T 101 and --win_len 128;
//   4  tiles in shared memory: d > 64, any Tq and Tk, forward and backward.
//
// THE SCALE. Variants 0, 1 and 3 multiply the dot product by 1/sqrt(d),
// computed once on the host in double and rounded to f32, as the Pallas
// kernel does (gaitpd/ops/pallas_blocks.py:201 multiplies by `scale`, :250
// sets it to 1.0 / np.sqrt(d)); only the jnp reference divides. Variants 2
// and 4 divide, as the first design did. expf is the accurate one: the build
// has no fast math.
//
// FORWARD, ONE SWEEP (variants 0, 1)
//
// What bounds it. Per problem it reads A and B and writes O, 9,216 bytes
// (56.6 MB in all, 16.9 us at 3.35 TB/s), and does two products of
// 2 * 64 * 64 * 12 FLOP: 24 FMAs a score, 1.21 GFLOP in all, 18.0 us at the
// 67 TFLOP/s of f32 on the CUDA cores. Operations bound it. The score's
// softmax adds issue slots the bound does not count: a scale, a max, a
// subtraction, expf (about eight instructions) and the sum of l.
//
// What the design does about it. A thread owns one query row and keeps it in
// registers. B's rows (64 at most) sit in shared memory; every thread of a warp
// reads the same row at once (a broadcast, 16-byte loads). The thread computes
// its row's scores once, into 64 registers, with their maximum; then one
// sweep over the registers and B gives exp(s - max), their sum l and the
// weighted sum of B's rows, and O = that sum / l. The scores, the maximum and
// the order of every sum are the first design's; only the scale differs.
// About 37 arithmetic instructions and 6 shared loads a score, against the
// first design's 75 (two passes of dot products and an IEEE division each).
// With d = 12 as a compile-time width the row loops carry no guard and no
// dead columns; other d <= 64 read rows zero-padded to 16, 32 or 64, whose
// padding adds exact zeros. Score registers past Tk hold -inf and add nothing.
// Fill: a block of 4 warps takes two 64-row units (a problem's query rows, 64
// at a time) a round, and the grid is as many blocks as the card holds at
// once (the occupancy calculator), each striding over the units: no half-empty
// last wave. At W <= 16 the launch bounds cap a thread at 128 registers (4
// blocks, 16 warps an SM). Strict f32 on the CUDA cores; no TF32.
//
// What it reaches (PERF.md, PR 7): about 0.079 ms at the main shape, 4.4x its
// bound, above the 37 instructions a score of the count above. Two query rows
// a thread (each row of B read once for two scores) was slower, and so was
// the uncapped kernel (168 registers, 12 warps an SM); the tensor cores
// (3xTF32) are the next step.
//
// BACKWARD, ONE SWEEP (variants 0, 1)
//
// For a cotangent dO, with S = A B^T * scale, P = softmax(S), O = P B:
//   dP = dO B^T;  D_i = sum_c dO_ic O_ic;  dS = P * (dP - D);
//   dA = dS B * scale;  dB = dS^T A * scale + P^T dO.
//
// What bounds it. Five products of the forward's size at the main shape,
// 3.02 GFLOP (45 us), against 94 MB of traffic (28 us): operations.
//
// What the design does about it. One block of 4 warps owns one problem, so dB
// needs no sum across blocks and no float atomics: the result is the same
// bits from run to run. A, B and dO are staged in shared memory, and so are
// P and dS * scale of the whole problem (64 x 66 floats each; a row stride of
// 66 puts the two threads of 16 rows in 32 distinct banks). Phase 1, two
// threads per query row i (lanes 2i and 2i + 1), each taking every other key:
// the scores into 32 registers and their max (the pair's by a shuffle); one
// sweep for exp(s - max), l, O_i and dP_ik = dO_i . B_k; the pair's sums by a
// shuffle (half 0 + half 1, so both lanes hold the same bits); D_i; then
// P_ik, dS_ik into shared memory and dA_i = sum_k dS_ik B_k * scale. Phase 2,
// a thread per (key row k, half of the query rows): dB_k = sum_i dS_ik A_i *
// scale + P_ik dO_i, reading P and dS by column (consecutive threads on
// consecutive k: no bank conflicts) and A_i, dO_i by broadcast; the upper
// half's partial row meets the lower's in shared memory, half 0 + half 1.
// About 6 row operations a score (the first design: 10), one expf (was 3), no
// division by sqrt(d), and 4 warps a problem (was 2). Rows past Tq write zero
// P and dS, so phase 2 runs without guards.
//
// ONE SWEEP OVER UP TO 128 KEYS (variant 3), d <= 64
//
// The FBG/FoG cheap-xattn fusion (gaitpd_torch/models/fusion.py,
// cheap_cross_attention_sym) sends both directions of 256 window pairs
// through one launch each way: N = 512 problems of Tq = Tk = 101 at d = 6
// (FBG: 64 at d = 3).
//
// What bounds it. Forward: 2 * 2 * 512 * 101 * 101 * 6 FLOP = 125 MFLOP, 1.87
// us at 67 TFLOP/s, against 3.7 MB of traffic (1.1 us): operations. Backward:
// five products, 4.68 us, against 6.2 MB: operations. Each score also costs
// its softmax's issue slots (a scale, a max, expf, the sum of l), which at
// d = 6 outnumber its FMAs.
//
// What the design does about it. The sweep kernels' scheme, at twice the
// keys: a problem's scores stay on chip and each is computed once, forward
// and backward, with one expf. Two lanes a query row, lane 2r + h taking the
// keys 2j + h (j < 64), so a thread holds at most 64 scores in registers; the
// pair's maximum, l and partial sums meet by one shuffle each, half 0 + half
// 1, so both lanes hold the same bits. A W of 8 (d <= 8) keeps the padding of
// FoG's d = 6 and FBG's 3 at most 2.7x (16 was 5.3x at d = 3). The key loops
// stop at the last pair of keys, and a warp whose 16 query rows all lie past
// Tq does no work: at Tq = 101, 7 of 8 warps run.
// Forward: a block of 4 warps takes a unit of 64 query rows (a problem's
// rows, 64 at a time) a round, B's rows (at most 128) staged in static shared
// memory at row_stride(W), on a persistent grid of as many blocks as the card
// holds at once, each striding over the units. At T 101 a problem is two
// units, of 64 and 37 rows.
// Backward: a block of 8 warps owns a problem, so dB takes no sum across
// blocks and no atomics: the same bits from run to run. A, B and dO are
// staged in shared memory, and so are P and dS * scale of the whole problem,
// sized to its own Tq and Tk (101,824 bytes at T 101, W 8: 2 blocks an SM).
// Phase 1, two lanes a query row: the scores and their max, one sweep for
// e = exp(s - m), l, t = sum e dP (dP_ik = dO_i . B_k into shared memory),
// D = t / l (= dO_i . O_i, O never formed), then P_ik, dS_ik into shared
// memory and dA_i = sum_k dS_ik B_k. Phase 2, a thread per (key row k, half
// of the query rows): dB_k = sum_i dS_ik A_i + P_ik dO_i, reading P and dS by
// column and A_i, dO_i by broadcast, half 0 + half 1. No row statistics go
// to device memory. Strict f32 on the CUDA cores; no TF32.
//
// What it reaches (PERF.md): at the FoG shape from a CUDA graph, 0.0162 ms
// forward and 0.0330 backward, 8.7x and 7.1x their bounds, against 0.0611
// and 0.1816 for variant 2 and 0.1017 and 0.2164 for
// scaled_dot_product_attention and its autograd (H100 80GB HBM3 at 700 W).
// A score's fixed issue slots (scale, max, expf, sums) match its 16 FMAs at
// W 8; the forward holds 16 warps an SM at 109 registers.
//
// TWO PASSES (variant 2), the first design, for Tk > 128 (backward Tq or
// Tk > 128), d <= 64
//
// A block takes one problem and up to 128 query rows; each thread owns one
// query row. B streams through shared memory in tiles of 64 rows. Forward:
// the first pass finds the row's maximum score, the second sums exp(s - max)
// and exp(s - max) * B_k; the score is the dot product divided by sqrt(d).
// Backward: nothing of the forward is saved. Phase 1, a thread per query row:
// max and sum (two passes), D_i from the recomputed O_i, a third pass for
// dA_i; the row's (max, sum, D) go to a scratch buffer. Phase 2, a thread per
// key row: A, dO and the row statistics stream through shared memory and the
// thread recomputes P_ik and dS_ik (the same bits as phase 1) and sums dB_k.
// The register rows hold d <= 64 (arrays of 16, 32 or 64, a template). At
// the FoG shape above it took 0.0612 ms forward and 0.1831 backward from a
// CUDA graph, 33x and 39x its bounds (PERF.md, PR 14): it computes each
// score twice forward and four times backward, a thread a row.
//
// FORWARD, TILES IN SHARED MEMORY (variant 4), d > 64
//
// _xattn_kernel's forward (gaitpd/ops/pallas_blocks.py:184-222) at these
// sizes, with its online softmax over key tiles of 64.
//
// What bounds it. At d = 96, N = 384, Tq = Tk = 64 (the cheap-xattn fusion
// with enc_out_ch 96 at a train batch of 64) it reads A and B and writes O,
// 28.3 MB (8.4 us at 3.35 TB/s), and does two products of 2 * 64 * 64 * 96
// FLOP a problem, 604 MFLOP (9.0 us at 67 TFLOP/s): both bounds are close.
//
// What the design does about it. A block of 4 warps takes units of (problem,
// 64 query rows) in turn, on a grid of as many blocks as the card holds at
// once (the occupancy calculator): at 4 blocks an SM (51 KB each at d 96)
// the card holds 528, so 384 units run in one wave. A unit's A rows and B's (at most 64) are copied into shared
// memory with cp.async, up to 128 columns of d at a time (a wider d in
// chunks), rows zero-filled beyond Tq, Tk and d, at a row stride of an odd
// number of float4 so that a quarter warp's 8 rows lie on distinct banks.
// S = A B^T is computed once: a thread keeps a 4 x 8 tile of scores in
// registers (rows ty + 16 ii, keys tx + 8 jj) and reads per 4 columns four
// float4 of A (a broadcast) and eight of B for 128 FMAs; each dot product
// sums in ascending column over the chunks, as variant 2 does. The scores,
// divided by sqrt(d) and -inf past Tk, take A's place in shared memory; a
// warp a row takes its max and sum l by butterflies (every lane the same
// bits) and writes exp(s - max). Then O = P B: a thread keeps a 4 x 4 tile of
// outputs (4 rows, 4 columns) and reads per 4 keys four float4 of P and four
// of B for 64 FMAs, keys in ascending order, and writes O / l. Only l is
// summed in another order than variant 2's. Strict f32; no atomics: the
// same bits from run to run.
//
// Beyond 64 keys the unit walks B in key tiles of 64, as the Pallas kernel
// walks its kv tiles: each tile's scores raise the row's running maximum m,
// l becomes l * exp(m_old - m) + the tile's sum, and the running sum of P B
// waits in the unit's own output rows (only the thread that wrote an entry
// reads it back), multiplied by that factor before the tile's P B is added;
// the last tile divides by l. Up to 64 keys this is the arithmetic above,
// bit for bit. At Tq = Tk = 128 (N 384: 768 units) the card holds 528
// blocks at once: 1.45 waves.
//
// What it reaches (PERF.md): 0.032 ms at d 96, Tq = Tk = 64 from a CUDA
// graph, 3.6x its bound, against 0.067 for scaled_dot_product_attention and
// 1.22 for the rows-in-device-memory design it replaced (H100 80GB HBM3 at
// 700 W); 0.138 at Tq = Tk = 128, 3.8x its bound, against 0.188 and 5.06:
// the 1.45 waves cost little, each unit's staging round trips and barriers
// hold it back at both lengths.
//
// BACKWARD, TILES IN SHARED MEMORY (variant 4), d > 64
//
// What bounds it. At d = 96, N = 384, Tq = Tk = 64 (the fusion's train
// step at enc_out_ch 96) five products of 2 * 64 * 64 * 96 FLOP a problem,
// 1.51 GFLOP (22.5 us at 67 TFLOP/s), against 47 MB of traffic (14 us):
// operations. The design it replaced computed each score three times over,
// with its rows and sums in device memory.
//
// What the design does about it. One block of 4 warps owns one problem, so
// dB takes no sum across blocks and no atomics: the same bits from run to
// run. The problem is cut into tiles of 64 query rows and 64 keys. For each
// (query tile, key tile) pair, S and dP = dO B^T come from two 4 x 8
// register tiles a thread (rows ty + 16 ii, keys tx + 8 jj), over chunks of
// 32 columns of A, B and dO staged with cp.async at a row stride of 9
// float4 (each dot product in ascending column); they go to shared memory
// (S / sqrt(d), -inf past Tk). A warp a row takes m, l = sum exp(s - m)
// and t = sum exp(s - m) dP by butterflies, D = t / l (= dO . O: O is never
// formed), and writes P = exp(s - m) / l and dS / sqrt(d) = P (dP - D) /
// sqrt(d) in their place. Then, chunk by chunk (the last one, still staged,
// first), a thread sums dA's 4 x 4 tile (4 query rows, 4 columns) over the
// keys, dS B, and dB's (4 keys, 4 columns) over the query rows, dS^T A +
// P^T dO. With one key tile (Tk <= 64) that is all, and each query tile's
// dB adds to the last in the problem's own rows of dB. Beyond 64 keys a
// first phase walks every query tile's key tiles for its rows' (m, l, t),
// rescaled online as the forward does, into the stats scratch, and the
// pairs are then taken key tile by key tile, each recomputing S and dP:
// seven products a pair against five. Shared memory 63,232 bytes, 3 blocks
// an SM (396 at once), 168 registers, no spills.
//
// What it reaches (PERF.md): 0.066 ms at d 96, Tq = Tk = 64 from a CUDA
// graph, 2.9x its bound, against 0.172 for the autograd of
// scaled_dot_product_attention and 3.80 for rows in device memory; 0.363
// at Tq = Tk = 128, 4.0x its bound, against 0.471 and 15.4.
//
// Plain C interface, bound with ctypes (gaitpd_torch/ops/cheap_xattn.py).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxThreads = 128;
constexpr int kTile = 64;  // rows staged in shared memory at a time
constexpr int kMaxD = 64;  // the widest register row; wider d runs the tiled kernels
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// The variants, numbered as gaitpd_torch/ops/cheap_xattn.py::_variant numbers them.
enum Variant { kSweepD12 = 0, kSweep = 1, kTwoPass = 2, kSweep128 = 3, kTiled = 4 };

constexpr int kSweepT = 64;         // keys (backward: and query rows) the sweep kernels hold
constexpr int kSweepThreads = 128;  // 4 warps
constexpr int kSlots = kSweepThreads / kSweepT;  // forward: 64-row units a block takes a round
constexpr int kHalf = kSweepT / 2;               // backward: keys (query rows) a thread takes
constexpr int kPStride = kSweepT + 2;            // row stride of P and dS in shared memory
// Blocks an SM the forward sweep's __launch_bounds__ asks for at W <= 16: 4
// caps it at 128 registers (16 warps an SM; it needs 168 uncapped, 12 warps).
constexpr int kSweepForwardBlocks = 4;

// Row stride of a staged tile of width w: w, or w + 4 where two rows 2j and
// 2j + 1 would fall into the same banks (the backward's pair of threads).
__host__ __device__ constexpr int row_stride(int w) { return w % 32 == 0 ? w + 4 : w; }

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

// ---------------------------------------------------------------------------
// One sweep (variants 0 and 1). W is the register row's width: 12 (d = 12
// exactly), 16, 32 or 64 (rows zero-padded beyond d). The dot and axpy
// helpers run over all W columns: the padding adds exact zeros.

// Copies the `rows` rows of a row-major (rows, d) matrix into a tile of
// `tile_rows` rows (kSweepT by default) and row stride S, zero beyond row
// `rows` and column d. Threads tid, tid + nthreads, ... share the copy.
template <int W, int S = row_stride(W)>
__device__ __forceinline__ void stage_tile(const float* __restrict__ src, float* dst, int rows,
                                           int d, int tid, int nthreads,
                                           int tile_rows = kSweepT) {
  if (W == 12 && S == 12) {  // d = 12: three 16-byte words a row, contiguous in both
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int e = tid; e < tile_rows * 3; e += nthreads) {
      d4[e] = e < rows * 3 ? s4[e] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int e = tid; e < tile_rows * S; e += nthreads) {
      const int r = e / S, c = e - r * S;
      dst[e] = (r < rows && c < d) ? src[r * d + c] : 0.0f;
    }
  }
}

// Row i of a staged tile of row stride S into registers.
template <int W, int S = row_stride(W)>
__device__ __forceinline__ void tile_row(float (&r)[W], const float* tile, int i) {
  const float* row = tile + i * S;
#pragma unroll
  for (int c = 0; c < W; c += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + c);
    r[c] = v.x;
    r[c + 1] = v.y;
    r[c + 2] = v.z;
    r[c + 3] = v.w;
  }
}

// Grid: as many blocks as the card holds at once, at most one per two units.
// A unit is (problem p, query rows [64 y, 64 y + 64)); block x takes units
// 2x, 2x + 1, then 2(x + grid), ... The two halves of the block (two warps
// each) take one unit each, with one tile of B each in static shared memory.
// FULL: Tk = 64, no score is masked.
template <int W, bool FULL>
__global__ void __launch_bounds__(kSweepThreads, W <= 16 ? kSweepForwardBlocks : 1)
cheap_xattn_forward_sweep_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                 float* __restrict__ out, int n, int tq, int tk, int d,
                                 float scale) {
  constexpr int kStride = row_stride(W);
  __shared__ __align__(16) float tiles[kSlots][kSweepT * kStride];
  const int slot = threadIdx.x / kSweepT;
  const int r = threadIdx.x % kSweepT;
  float* tile = tiles[slot];
  const int chunks = (tq + kSweepT - 1) / kSweepT;
  const long long units = static_cast<long long>(n) * chunks;
  for (long long u0 = static_cast<long long>(blockIdx.x) * kSlots; u0 < units;
       u0 += static_cast<long long>(gridDim.x) * kSlots) {
    const long long u = u0 + slot;
    const bool live = u < units;
    const size_t p = live ? static_cast<size_t>(u / chunks) : 0;
    const int i = (live ? static_cast<int>(u % chunks) : 0) * kSweepT + r;
    const bool active = live && i < tq;
    __syncthreads();  // the previous round's reads of the tiles are done
    stage_tile<W>(b + p * tk * d, tile, live ? tk : 0, d, r, kSweepT);
    __syncthreads();
    float q[W];
    load_row<W>(q, a + p * tq * d, i, d, active);
    float s[kSweepT];
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < kSweepT; ++k) {
      const float v = dot_row<W, true>(q, tile + k * kStride, W) * scale;
      s[k] = (FULL || k < tk) ? v : -INFINITY;
      m = fmaxf(m, s[k]);
    }
    // Without a barrier here the compiler keeps the tile's values loaded by
    // the first loop in registers for the second: 64 W floats a thread (255
    // registers and 3 KB of spills at W = 12). After it they are loaded again.
    __syncwarp();
    float l = 0.0f, acc[W];
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int k = 0; k < kSweepT; ++k) {
      const float e = expf(s[k] - m);
      l += e;
      axpy_row<W, true>(acc, e, tile + k * kStride, W);
    }
    if (active) {
      float* o = out + (p * tq + i) * d;
#pragma unroll
      for (int c = 0; c < W; ++c) {
        if (W == 12 || c < d) o[c] = acc[c] / l;
      }
    }
  }
}

// Grid (N): block p owns problem p. Dynamic shared memory:
// sweep_backward_smem(W) bytes (tiles of B, A, dO, then P and dS).
template <int W, bool FULL>
__global__ void __launch_bounds__(kSweepThreads)
cheap_xattn_backward_sweep_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                  const float* __restrict__ g, float* __restrict__ da,
                                  float* __restrict__ db, int tq, int tk, int d, float scale) {
  constexpr int kStride = row_stride(W);
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ float4 smem4[];
  float* bs = reinterpret_cast<float*>(smem4);
  float* as = bs + kSweepT * kStride;
  float* gs = as + kSweepT * kStride;
  float* ps = gs + kSweepT * kStride;
  float* ss = ps + kSweepT * kPStride;
  const size_t p = blockIdx.x;
  stage_tile<W>(b + p * tk * d, bs, tk, d, threadIdx.x, kSweepThreads);
  stage_tile<W>(a + p * tq * d, as, tq, d, threadIdx.x, kSweepThreads);
  stage_tile<W>(g + p * tq * d, gs, tq, d, threadIdx.x, kSweepThreads);
  __syncthreads();

  // Phase 1: query row i, keys k = 2j + h of the pair's half h.
  {
    const int i = threadIdx.x >> 1, h = threadIdx.x & 1;
    const bool active = i < tq;
    float* prow = ps + i * kPStride;
    float* srow = ss + i * kPStride;
    float q[W];
    tile_row<W>(q, as, i);
    float s[kHalf];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const int k = 2 * j + h;
      const float v = dot_row<W, true>(q, bs + k * kStride, W) * scale;
      s[j] = (FULL || k < tk) ? v : -INFINITY;
      m = fmaxf(m, s[j]);
    }
    m = fmaxf(m, __shfl_xor_sync(kAll, m, 1));
    float go[W], o[W];
    tile_row<W>(go, gs, i);
#pragma unroll
    for (int c = 0; c < W; ++c) o[c] = 0.0f;
    float l = 0.0f;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const int k = 2 * j + h;
      const float* row = bs + k * kStride;
      const float e = expf(s[j] - m);
      s[j] = e;
      l += e;
      axpy_row<W, true>(o, e, row, W);
      srow[k] = dot_row<W, true>(go, row, W);  // dP_ik, until dS replaces it
    }
    l += __shfl_xor_sync(kAll, l, 1);
#pragma unroll
    for (int c = 0; c < W; ++c) o[c] += __shfl_xor_sync(kAll, o[c], 1);
    float dsum = 0.0f;  // D_i = dO_i . O_i
#pragma unroll
    for (int c = 0; c < W; ++c) dsum = fmaf(go[c], o[c] / l, dsum);
    float acc[W];  // dA_i
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = 0.0f;
    if (active) {
      const float inv_l = 1.0f / l;
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        const int k = 2 * j + h;
        const float pk = s[j] * inv_l;
        const float ds = pk * (srow[k] - dsum) * scale;
        prow[k] = pk;
        srow[k] = ds;
        axpy_row<W, true>(acc, ds, bs + k * kStride, W);
      }
    } else {  // zero rows of P and dS: phase 2 sums all 64 rows
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        prow[2 * j + h] = 0.0f;
        srow[2 * j + h] = 0.0f;
      }
    }
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] += __shfl_xor_sync(kAll, acc[c], 1);
    if (active && h == 0) {
      float* o_da = da + (p * tq + i) * d;
#pragma unroll
      for (int c = 0; c < W; ++c) {
        if (W == 12 || c < d) o_da[c] = acc[c];
      }
    }
  }
  __syncthreads();

  // Phase 2: key row k, query rows [32 h, 32 h + 32).
  {
    const int k = threadIdx.x % kSweepT, h = threadIdx.x / kSweepT;
    float acc[W];
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = 0.0f;
#pragma unroll 8
    for (int j = 0; j < kHalf; ++j) {
      const int i = h * kHalf + j;
      const float pk = ps[i * kPStride + k];
      const float ds = ss[i * kPStride + k];
      axpy_row<W, true>(acc, pk, gs + i * kStride, W);
      axpy_row<W, true>(acc, ds, as + i * kStride, W);
    }
    float* part = bs + k * kStride;  // B's tile is free: phase 1 is over
    if (h == 1) {
#pragma unroll
      for (int c = 0; c < W; ++c) part[c] = acc[c];
    }
    __syncthreads();
    if (h == 0 && k < tk) {
      float* o_db = db + (p * tk + k) * d;
#pragma unroll
      for (int c = 0; c < W; ++c) {
        if (W == 12 || c < d) o_db[c] = acc[c] + part[c];
      }
    }
  }
}

size_t sweep_backward_smem(int w) {
  return (3 * static_cast<size_t>(kSweepT) * row_stride(w) +
          2 * static_cast<size_t>(kSweepT) * kPStride) * sizeof(float);
}

// ---------------------------------------------------------------------------
// One sweep over up to 128 keys (variant 3). W is the register row's width:
// 8, 12 (d = 12 exactly), 16, 32 or 64, rows zero-padded beyond d. Two lanes
// a query row: lane 2r + h takes the keys k = 2j + h, j < 64, so a thread
// holds at most 64 scores, as in the sweep kernels.

constexpr int kLongT = 128;              // keys (backward: and query rows) variant 3 holds
constexpr int kLongSlots = kLongT / 2;   // score registers a thread: the keys of its parity
constexpr int kLongBwdThreads = 2 * kLongT;  // backward: two lanes for each of 128 query rows
// Blocks an SM the backward's launch bounds ask for at W <= 16 (shared
// memory allows 2 at T 101, d <= 8); they cap a thread at 128 registers.
constexpr int kLongBwdBlocks = 2;

__host__ __device__ constexpr int even_up(int v) { return (v + 1) / 2 * 2; }
__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }
// The backward's row stride of A, B and dO: row_stride(w), but w at W = 64,
// where padded rows would not fit 227 KB at Tq = Tk = 128 (the pair's two
// rows then share banks: a two-way conflict, off every default path).
__host__ __device__ constexpr int long_stride(int w) { return w == 64 ? w : row_stride(w); }
// The row stride of P and dS: the least 2 x (odd) >= Tk, so that the 16
// rows a warp stores at once, two keys each, lie on 32 distinct banks.
__host__ __device__ constexpr int long_pstride(int tk) {
  return even_up(tk) / 2 % 2 == 1 ? even_up(tk) : even_up(tk) + 2;
}

// Grid: as many blocks as the card holds at once, at most one a unit. A
// unit is (problem p, query rows [64 y, 64 y + 64)); block x takes units x,
// x + grid, ... B's rows (Tk rounded up to even, zero beyond Tk: the odd lane
// of the last pair reads a zero row, its score masked) sit in static shared
// memory. A warp whose 16 query rows all lie past Tq skips the unit.
template <int W>
__global__ void __launch_bounds__(kSweepThreads, W <= 16 ? kSweepForwardBlocks : 1)
cheap_xattn_forward_sweep128_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                    float* __restrict__ out, int n, int tq, int tk, int d,
                                    float scale) {
  constexpr int kStride = row_stride(W);
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ __align__(16) float bs[kLongT * kStride];
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1;
  const int row0 = (threadIdx.x >> 5) * 16;  // the warp's first query row in the unit
  const int chunks = (tq + kSweepT - 1) / kSweepT;
  const long long units = static_cast<long long>(n) * chunks;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const size_t p = static_cast<size_t>(u / chunks);
    const int r0 = static_cast<int>(u % chunks) * kSweepT;
    const int i = r0 + r;
    __syncthreads();  // the previous unit's reads of the tile are done
    stage_tile<W>(b + p * tk * d, bs, tk, d, threadIdx.x, kSweepThreads, even_up(tk));
    __syncthreads();
    if (r0 + row0 >= tq) continue;
    const bool active = i < tq;
    float q[W];
    load_row<W>(q, a + p * tq * d, i, d, active);
    float s[kLongSlots];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kLongSlots; ++j) {
      if (2 * j >= tk) break;
      const int k = 2 * j + h;
      const float v = dot_row<W, true>(q, bs + k * kStride, W) * scale;
      s[j] = k < tk ? v : -INFINITY;
      m = fmaxf(m, s[j]);
    }
    m = fmaxf(m, __shfl_xor_sync(kAll, m, 1));
    __syncwarp();  // as in the sweep forward: B's rows are loaded again below
    float l = 0.0f, acc[W];
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < kLongSlots; ++j) {
      if (2 * j >= tk) break;
      const float e = expf(s[j] - m);
      l += e;
      axpy_row<W, true>(acc, e, bs + (2 * j + h) * kStride, W);
    }
    // the pair's sums, half 0 + half 1: both lanes hold the same bits
    l += __shfl_xor_sync(kAll, l, 1);
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] += __shfl_xor_sync(kAll, acc[c], 1);
    if (active && h == 0) {
      float* o = out + (p * tq + i) * d;
#pragma unroll
      for (int c = 0; c < W; ++c) {
        if (W == 12 || c < d) o[c] = acc[c] / l;
      }
    }
  }
}

// Grid (N): block p owns problem p, 256 threads. Dynamic shared memory:
// sweep128_backward_smem(W, Tq, Tk) bytes: A and dO (Tq rounded up to 16
// rows, a warp's worth, zero beyond Tq), B (Tk rounded up to even), then P
// and dS * scale for those query rows at a row stride of long_pstride(Tk).
// Lanes past Tq in a warp with a live row compute on zero rows and store
// into the padding, which phase 2 does not read.
template <int W>
__global__ void __launch_bounds__(kLongBwdThreads, W <= 16 ? kLongBwdBlocks : 1)
cheap_xattn_backward_sweep128_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                     const float* __restrict__ g, float* __restrict__ da,
                                     float* __restrict__ db, int tq, int tk, int d,
                                     float scale) {
  constexpr int kStride = long_stride(W);
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ float4 smem4[];
  const int rows = round16(tq), pstride = long_pstride(tk);
  float* as = reinterpret_cast<float*>(smem4);
  float* gs = as + rows * kStride;
  float* bs = gs + rows * kStride;
  float* ps = bs + even_up(tk) * kStride;
  float* ss = ps + rows * pstride;
  const size_t p = blockIdx.x;
  stage_tile<W, kStride>(b + p * tk * d, bs, tk, d, threadIdx.x, kLongBwdThreads, even_up(tk));
  stage_tile<W, kStride>(a + p * tq * d, as, tq, d, threadIdx.x, kLongBwdThreads, rows);
  stage_tile<W, kStride>(g + p * tq * d, gs, tq, d, threadIdx.x, kLongBwdThreads, rows);
  __syncthreads();

  // Phase 1: query row i, keys k = 2j + h of the pair's half h; warps whose
  // 16 rows all lie past Tq idle.
  if ((threadIdx.x >> 5) * 16 < tq) {
    const int i = threadIdx.x >> 1, h = threadIdx.x & 1;
    float* prow = ps + i * pstride;
    float* srow = ss + i * pstride;
    float q[W];
    tile_row<W, kStride>(q, as, i);
    float s[kLongSlots];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kLongSlots; ++j) {
      if (2 * j >= tk) break;
      const int k = 2 * j + h;
      const float v = dot_row<W, true>(q, bs + k * kStride, W) * scale;
      s[j] = k < tk ? v : -INFINITY;
      m = fmaxf(m, s[j]);
    }
    m = fmaxf(m, __shfl_xor_sync(kAll, m, 1));
    __syncwarp();
    float go[W];
    tile_row<W, kStride>(go, gs, i);
    float l = 0.0f, t = 0.0f;  // l = sum_k e_k, t = sum_k e_k dP_ik
#pragma unroll
    for (int j = 0; j < kLongSlots; ++j) {
      if (2 * j >= tk) break;
      const int k = 2 * j + h;
      const float e = expf(s[j] - m);
      const float dp = dot_row<W, true>(go, bs + k * kStride, W);
      s[j] = e;
      l += e;
      t = fmaf(e, dp, t);
      srow[k] = dp;  // dP_ik, until dS replaces it
    }
    l += __shfl_xor_sync(kAll, l, 1);
    t += __shfl_xor_sync(kAll, t, 1);
    const float dsum = t / l;  // D_i = sum_k P_ik dP_ik = dO_i . O_i
    const float inv_l = 1.0f / l;
    __syncwarp();
    float acc[W];  // dA_i
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < kLongSlots; ++j) {
      if (2 * j >= tk) break;
      const int k = 2 * j + h;
      const float pk = s[j] * inv_l;
      const float ds = pk * (srow[k] - dsum) * scale;
      prow[k] = pk;
      srow[k] = ds;
      axpy_row<W, true>(acc, ds, bs + k * kStride, W);
    }
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] += __shfl_xor_sync(kAll, acc[c], 1);
    if (i < tq && h == 0) {
      float* o_da = da + (p * tq + i) * d;
#pragma unroll
      for (int c = 0; c < W; ++c) {
        if (W == 12 || c < d) o_da[c] = acc[c];
      }
    }
  }
  __syncthreads();

  // Phase 2: key row k, query rows [0, ceil(Tq / 2)) (h = 0) or the rest (h = 1).
  {
    const int k = threadIdx.x % kLongT, h = threadIdx.x / kLongT;
    const int half = (tq + 1) / 2;
    const int i1 = h == 0 ? half : tq;
    float acc[W];
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = 0.0f;
    if (k < tk) {
#pragma unroll 4
      for (int i = h * half; i < i1; ++i) {
        const float pk = ps[i * pstride + k];
        const float ds = ss[i * pstride + k];
        axpy_row<W, true>(acc, pk, gs + i * kStride, W);
        axpy_row<W, true>(acc, ds, as + i * kStride, W);
      }
    }
    float* part = bs + k * kStride;  // B's rows are free: phase 1 is over
    if (h == 1 && k < tk) {
#pragma unroll
      for (int c = 0; c < W; ++c) part[c] = acc[c];
    }
    __syncthreads();
    if (h == 0 && k < tk) {
      float* o_db = db + (p * tk + k) * d;
#pragma unroll
      for (int c = 0; c < W; ++c) {
        if (W == 12 || c < d) o_db[c] = acc[c] + part[c];
      }
    }
  }
}

size_t sweep128_backward_smem(int w, int tq, int tk) {
  const size_t rows = round16(tq);
  return ((2 * rows + even_up(tk)) * long_stride(w) + 2 * rows * long_pstride(tk)) *
         sizeof(float);
}

// ---------------------------------------------------------------------------
// Two passes (variant 2).

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

int threads_for(int rows) {
  const int t = (rows + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// ---------------------------------------------------------------------------
// d > 64 (variant 4): tiles in shared memory, forward and backward (see the
// header).

constexpr int kTiledThreads = 128;          // 4 warps
constexpr int kTiledChunk = 128;            // forward: columns of d staged at a time
constexpr int kTiledPStride = kSweepT + 4;  // row stride of P (and dS): 17 float4, odd
constexpr unsigned kFullWarp = 0xffffffffu;

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }
// The widest chunk of d that is staged, rounded up to 4.
__host__ __device__ constexpr int tiled_width(int d) {
  return round4(d) < kTiledChunk ? round4(d) : kTiledChunk;
}
// Row stride of a staged chunk of width w4 (a multiple of 4): an odd number
// of float4, so that the 8 rows a quarter warp reads 16 bytes of at once lie
// on distinct banks. At d > 64 it is at least kTiledPStride: P fits in A's
// place.
__host__ __device__ constexpr int tiled_stride(int w4) {
  return (w4 / 4) % 2 == 1 ? w4 : w4 + 4;
}
// A's chunk (then P), B's chunk, and each query row's sum l, running maximum
// m and rescale factor, in bytes.
size_t tiled_smem(int d) {
  return (2 * static_cast<size_t>(kSweepT) * tiled_stride(tiled_width(d)) + 3 * kSweepT) *
         sizeof(float);
}

constexpr int kBwdChunk = 32;                            // backward: columns of d a stage
constexpr int kBwdStride = tiled_stride(kBwdChunk);      // 36 floats, 9 float4
// The backward's chunks of A, B and dO, the tiles P and dS, and each query
// row's m, l and D, in bytes: 63,232, 3 blocks an SM.
constexpr size_t kTiledBackwardSmem =
    (3 * kSweepT * kBwdStride + 2 * kSweepT * kTiledPStride + 3 * kSweepT) * sizeof(float);
constexpr int kTiledBackwardBlocks = 3;  // blocks an SM the launch bounds ask for

// Asynchronous copy global -> shared of 4 or 16 bytes; with `full` false the
// destination is zero-filled and nothing is read.
template <bool V4>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (V4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(full ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(full ? 4 : 0));
  }
}

// Columns [c0, c0 + w4) of the first `rows` rows of a row-major (rows, d)
// matrix into a kSweepT-row tile of stride ld; zero beyond row `rows` and
// column d. The caller waits for the copies (cp_async_wait_all).
template <bool V4>
__device__ __forceinline__ void tiled_stage(const float* __restrict__ src, float* dst, int rows,
                                            int d, int c0, int w4, int ld) {
  constexpr int kVec = V4 ? 4 : 1;
  const int per_row = w4 / kVec;
  for (int e = threadIdx.x; e < kSweepT * per_row; e += blockDim.x) {
    const int r = e / per_row, c = (e - r * per_row) * kVec;
    const bool full = r < rows && c0 + c < d;
    cp_async<V4>(dst + r * ld + c, full ? src + static_cast<size_t>(r) * d + c0 + c : src, full);
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullWarp, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullWarp, v, off);
  return v;
}

// The four floats of a float4, for loops over them.
__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Stores (first) or adds (a later tile) four floats at row[0..3], the
// columns past d left out where d is not a multiple of 4 (!V4). Only this
// thread touches these entries: a later tile reads back its own store.
template <bool V4>
__device__ __forceinline__ void store_or_add4(float* row, float4 v, bool first, int cols) {
  if (V4) {
    if (!first) {
      const float4 o = *reinterpret_cast<const float4*>(row);
      v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
    }
    *reinterpret_cast<float4*>(row) = v;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < cols) row[c] = first ? lane4(v, c) : row[c] + lane4(v, c);
    }
  }
}

// A block takes units of (problem, 64 query rows) in turn, and each unit
// walks B's rows in key tiles of 64 with an online softmax. V4: d is a
// multiple of 4 (the rows lie on 16 bytes).
template <bool V4>
__global__ void __launch_bounds__(kTiledThreads)
cheap_xattn_forward_tiled_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                 float* __restrict__ out, int n, int tq, int tk, int d,
                                 float sqrt_d) {
  extern __shared__ float4 smem4[];
  const int ld = tiled_stride(tiled_width(d));
  float* as = reinterpret_cast<float*>(smem4);  // A's chunk; then P (64 x kTiledPStride)
  float* bs = as + kSweepT * ld;                // B's chunk
  float* ls = bs + kSweepT * ld;                // l of each query row
  float* ms = ls + kSweepT;                     // the running maximum m of each query row
  float* cs = ms + kSweepT;                     // exp(m_old - m_new) of the key tile
  float* ps = as;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 3, tx = tid & 7;  // scores: rows ty + 16 ii, keys tx + 8 jj
  const int per_problem = (tq + kSweepT - 1) / kSweepT;
  const long long units = static_cast<long long>(n) * per_problem;
  const int chunks = (d + kTiledChunk - 1) / kTiledChunk;
  const int key_tiles = (tk + kSweepT - 1) / kSweepT;

  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long p = u / per_problem;
    const int r0 = static_cast<int>(u - p * per_problem) * kSweepT;
    const int rows = min(kSweepT, tq - r0);
    const float* ap = a + (static_cast<size_t>(p) * tq + r0) * d;

    for (int kt = 0; kt < key_tiles; ++kt) {
      const int k0 = kt * kSweepT, keys = min(kSweepT, tk - k0);
      const bool first = kt == 0, last = kt == key_tiles - 1;
      const float* bp = b + (static_cast<size_t>(p) * tk + k0) * d;
      const int keys4 = round4(keys);

      // S = A B^T: a 4 x 8 register tile a thread, each dot product in
      // ascending c over the chunks
      float s[4][8];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) s[ii][jj] = 0.0f;
      }
      for (int ch = 0; ch < chunks; ++ch) {
        const int c0 = ch * kTiledChunk;
        const int w4 = min(round4(d - c0), kTiledChunk);
        __syncthreads();  // the last tile's or chunk's reads are done
        tiled_stage<V4>(ap, as, rows, d, c0, w4, ld);
        tiled_stage<V4>(bp, bs, keys, d, c0, w4, ld);
        cp_async_wait_all();
        __syncthreads();
        for (int c = 0; c < w4; c += 4) {
          float4 av[4], bv[8];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            av[ii] = *reinterpret_cast<const float4*>(as + (ty + 16 * ii) * ld + c);
          }
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            bv[jj] = *reinterpret_cast<const float4*>(bs + (tx + 8 * jj) * ld + c);
          }
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              float v = s[ii][jj];
              v = fmaf(av[ii].x, bv[jj].x, v);
              v = fmaf(av[ii].y, bv[jj].y, v);
              v = fmaf(av[ii].z, bv[jj].z, v);
              s[ii][jj] = fmaf(av[ii].w, bv[jj].w, v);
            }
          }
        }
      }
      __syncthreads();  // A is read for the last time: P takes its place
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int key = tx + 8 * jj;
          ps[(ty + 16 * ii) * kTiledPStride + key] = key < keys ? s[ii][jj] / sqrt_d : -INFINITY;
        }
      }
      __syncthreads();

      // softmax numerators: a warp a row, lanes on keys lane and lane + 32;
      // the butterflies leave every lane with the same m and l. A later key
      // tile raises m to the tile's maximum and rescales l by exp(m_old - m).
      for (int i = warp; i < kSweepT; i += kTiledThreads / 32) {
        float* pr = ps + i * kTiledPStride;
        const float v0 = pr[lane], v1 = pr[lane + 32];
        const float m_old = first ? -INFINITY : ms[i];
        const float m = fmaxf(warp_max(fmaxf(v0, v1)), m_old);
        const float e0 = expf(v0 - m), e1 = expf(v1 - m);
        const float l = warp_sum(e0 + e1);
        pr[lane] = e0;
        pr[lane + 32] = e1;
        __syncwarp();  // every lane has read ms[i]
        if (lane == 0) {
          if (first) {
            ls[i] = l;
          } else {
            const float corr = expf(m_old - m);
            ls[i] = fmaf(ls[i], corr, l);
            cs[i] = corr;
          }
          ms[i] = m;
        }
      }

      // O = P B: a 4 x 4 register tile a thread (rows oy + 16 ii, columns
      // 4q .. 4q + 3), keys in ascending order; the last chunk of B staged
      // is taken first. Over several key tiles the unit's own output rows
      // hold the running sum, which only this thread touches: a later tile
      // multiplies it by the rescale factor and adds; the last divides by l.
      for (int ch = chunks - 1; ch >= 0; --ch) {
        const int c0 = ch * kTiledChunk;
        const int w4 = min(round4(d - c0), kTiledChunk);
        if (ch != chunks - 1) {
          __syncthreads();
          tiled_stage<V4>(bp, bs, keys, d, c0, w4, ld);
          cp_async_wait_all();
        }
        __syncthreads();
        const int quads = w4 / 4;
        for (int t = tid; t < (kSweepT / 4) * quads; t += kTiledThreads) {
          const int oy = t / quads, q = t - oy * quads;
          float4 acc[4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) acc[ii] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          for (int k = 0; k < keys4; k += 4) {
            float4 pv[4], bv[4];
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) {
              pv[ii] = *reinterpret_cast<const float4*>(ps + (oy + 16 * ii) * kTiledPStride + k);
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              bv[kk] = *reinterpret_cast<const float4*>(bs + (k + kk) * ld + 4 * q);
            }
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) {
              const float pk[4] = {pv[ii].x, pv[ii].y, pv[ii].z, pv[ii].w};
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                acc[ii].x = fmaf(pk[kk], bv[kk].x, acc[ii].x);
                acc[ii].y = fmaf(pk[kk], bv[kk].y, acc[ii].y);
                acc[ii].z = fmaf(pk[kk], bv[kk].z, acc[ii].z);
                acc[ii].w = fmaf(pk[kk], bv[kk].w, acc[ii].w);
              }
            }
          }
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const int i = oy + 16 * ii;
            if (i >= rows) continue;
            float* orow = out + (static_cast<size_t>(p) * tq + r0 + i) * d + c0 + 4 * q;
            const int cols = d - c0 - 4 * q;
            float o[4] = {acc[ii].x, acc[ii].y, acc[ii].z, acc[ii].w};
            if (!first) {  // this thread's store of the earlier key tiles
              const float corr = cs[i];
              float old[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              if (V4) {
                const float4 v = *reinterpret_cast<const float4*>(orow);
                old[0] = v.x, old[1] = v.y, old[2] = v.z, old[3] = v.w;
              } else {
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  if (c < cols) old[c] = orow[c];
                }
              }
#pragma unroll
              for (int c = 0; c < 4; ++c) o[c] = fmaf(old[c], corr, o[c]);
            }
            if (last) {
              const float l = ls[i];
#pragma unroll
              for (int c = 0; c < 4; ++c) o[c] = o[c] / l;
            }
            if (V4) {
              *reinterpret_cast<float4*>(orow) = make_float4(o[0], o[1], o[2], o[3]);
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                if (c < cols) orow[c] = o[c];
              }
            }
          }
        }
      }
    }
  }
}

// The backward's S = A B^T / sqrt(d) and dP = dO B^T of one (query tile,
// key tile) pair into P's and dS's places in shared memory (S -inf past the
// tile's keys), from 4 x 8 register tiles a thread over chunks of 32
// columns, each dot product in ascending c. Leaves the last chunk of A, B
// and dO staged.
template <bool V4>
__device__ __forceinline__ void backward_scores(const float* __restrict__ ap,
                                                const float* __restrict__ bp,
                                                const float* __restrict__ gp, int rows, int keys,
                                                int d, float sqrt_d, float* as, float* bs,
                                                float* gs, float* ps, float* ss) {
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;  // rows ty + 16 ii, keys tx + 8 jj
  float s[4][8], dp[4][8];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) s[ii][jj] = dp[ii][jj] = 0.0f;
  }
  for (int c0 = 0; c0 < d; c0 += kBwdChunk) {
    const int w4 = min(round4(d - c0), kBwdChunk);
    __syncthreads();  // the last pair's or chunk's reads are done
    tiled_stage<V4>(ap, as, rows, d, c0, w4, kBwdStride);
    tiled_stage<V4>(bp, bs, keys, d, c0, w4, kBwdStride);
    tiled_stage<V4>(gp, gs, rows, d, c0, w4, kBwdStride);
    cp_async_wait_all();
    __syncthreads();
    for (int c = 0; c < w4; c += 4) {
      float4 av[4], gv[4], bv[8];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        av[ii] = *reinterpret_cast<const float4*>(as + (ty + 16 * ii) * kBwdStride + c);
        gv[ii] = *reinterpret_cast<const float4*>(gs + (ty + 16 * ii) * kBwdStride + c);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        bv[jj] = *reinterpret_cast<const float4*>(bs + (tx + 8 * jj) * kBwdStride + c);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          float v = s[ii][jj], w = dp[ii][jj];
          v = fmaf(av[ii].x, bv[jj].x, v);
          w = fmaf(gv[ii].x, bv[jj].x, w);
          v = fmaf(av[ii].y, bv[jj].y, v);
          w = fmaf(gv[ii].y, bv[jj].y, w);
          v = fmaf(av[ii].z, bv[jj].z, v);
          w = fmaf(gv[ii].z, bv[jj].z, w);
          s[ii][jj] = fmaf(av[ii].w, bv[jj].w, v);
          dp[ii][jj] = fmaf(gv[ii].w, bv[jj].w, w);
        }
      }
    }
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int i = ty + 16 * ii, key = tx + 8 * jj;
      ps[i * kTiledPStride + key] = key < keys ? s[ii][jj] / sqrt_d : -INFINITY;
      ss[i * kTiledPStride + key] = dp[ii][jj];
    }
  }
  __syncthreads();
}

// Each query row's softmax statistics over one more key tile, a warp a row:
// the running maximum m (st[i]), l = sum exp(s - m) (st[64 + i]) and
// t = sum exp(s - m) dP (st[128 + i]), the earlier tiles' l and t rescaled
// by exp(m_old - m); after the last tile t becomes D = t / l (= dO . O).
__device__ __forceinline__ void backward_row_stats(const float* ps, const float* ss, float* st,
                                                   bool first, bool last) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < kSweepT; i += kTiledThreads / 32) {
    const float* pr = ps + i * kTiledPStride;
    const float* sr = ss + i * kTiledPStride;
    const float v0 = pr[lane], v1 = pr[lane + 32];
    const float m_old = first ? -INFINITY : st[i];
    const float m = fmaxf(warp_max(fmaxf(v0, v1)), m_old);
    const float e0 = expf(v0 - m), e1 = expf(v1 - m);
    float l = warp_sum(e0 + e1);
    float t = warp_sum(fmaf(e0, sr[lane], e1 * sr[lane + 32]));
    __syncwarp();  // every lane has read st[i]
    if (lane == 0) {
      if (!first) {
        const float corr = expf(m_old - m);
        l = fmaf(st[kSweepT + i], corr, l);
        t = fmaf(st[2 * kSweepT + i], corr, t);
      }
      st[i] = m;
      st[kSweepT + i] = l;
      st[2 * kSweepT + i] = last ? t / l : t;
    }
  }
}

// P = exp(s - m) / l and dS / sqrt(d) = P (dP - D) / sqrt(d) in place of S
// and dP, a warp a row, from the rows' final (m, l, D) in st.
__device__ __forceinline__ void backward_probs(float* ps, float* ss, const float* st,
                                               float sqrt_d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < kSweepT; i += kTiledThreads / 32) {
    const float m = st[i], l = st[kSweepT + i], dsum = st[2 * kSweepT + i];
    float* pr = ps + i * kTiledPStride;
    float* sr = ss + i * kTiledPStride;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = lane + 32 * h;
      const float pk = expf(pr[k] - m) / l;
      pr[k] = pk;
      sr[k] = pk * (sr[k] - dsum) / sqrt_d;
    }
  }
}

// One (query tile, key tile) pair's share of dA and dB, from P and dS / sqrt(d)
// in shared memory, over chunks of 32 columns, the last chunk (still staged)
// first. A thread takes (oy, q) with oy < 16, q < w4 / 4:
//   dA rows oy + 16 ii, columns 4q .. 4q + 3: sum over keys k in ascending
//     order of dS_ik B_k;
//   dB keys 4 oy .. 4 oy + 3, the same columns: sum over query rows i in
//     ascending order of dS_ik A_i + P_ik dO_i.
// The first key tile stores dA's rows, a later one adds to them; likewise
// the first query tile for dB. Only this thread touches those entries.
template <bool V4>
__device__ __forceinline__ void backward_grads(const float* __restrict__ ap,
                                               const float* __restrict__ bp,
                                               const float* __restrict__ gp, float* da_rows,
                                               float* db_rows, int rows, int keys, int d,
                                               bool first_key_tile, bool first_query_tile,
                                               float* as, float* bs, float* gs, const float* ps,
                                               const float* ss) {
  const int tid = threadIdx.x;
  const int keys4 = round4(keys);
  const int last_c0 = (d - 1) / kBwdChunk * kBwdChunk;
  for (int c0 = last_c0; c0 >= 0; c0 -= kBwdChunk) {
    const int w4 = min(round4(d - c0), kBwdChunk);
    if (c0 != last_c0) {
      __syncthreads();  // the last chunk's reads are done
      tiled_stage<V4>(ap, as, rows, d, c0, w4, kBwdStride);
      tiled_stage<V4>(bp, bs, keys, d, c0, w4, kBwdStride);
      tiled_stage<V4>(gp, gs, rows, d, c0, w4, kBwdStride);
      cp_async_wait_all();
    }
    __syncthreads();
    const int quads = w4 / 4;
    if (tid >= (kSweepT / 4) * quads) continue;
    const int oy = tid / quads, q = tid - oy * quads;
    const int cols = d - c0 - 4 * q;
    {  // dA
      float4 acc[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) acc[ii] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int k = 0; k < keys4; k += 4) {
        float4 sv[4], bv[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          sv[ii] = *reinterpret_cast<const float4*>(ss + (oy + 16 * ii) * kTiledPStride + k);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          bv[kk] = *reinterpret_cast<const float4*>(bs + (k + kk) * kBwdStride + 4 * q);
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float w = lane4(sv[ii], kk);
            acc[ii].x = fmaf(w, bv[kk].x, acc[ii].x);
            acc[ii].y = fmaf(w, bv[kk].y, acc[ii].y);
            acc[ii].z = fmaf(w, bv[kk].z, acc[ii].z);
            acc[ii].w = fmaf(w, bv[kk].w, acc[ii].w);
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = oy + 16 * ii;
        if (i < rows) {
          store_or_add4<V4>(da_rows + static_cast<size_t>(i) * d + c0 + 4 * q, acc[ii],
                            first_key_tile, cols);
        }
      }
    }
    {  // dB
      float4 acc[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc[kk] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int i = 0; i < rows; ++i) {
        const float4 sv = *reinterpret_cast<const float4*>(ss + i * kTiledPStride + 4 * oy);
        const float4 pv = *reinterpret_cast<const float4*>(ps + i * kTiledPStride + 4 * oy);
        const float4 av = *reinterpret_cast<const float4*>(as + i * kBwdStride + 4 * q);
        const float4 gv = *reinterpret_cast<const float4*>(gs + i * kBwdStride + 4 * q);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float w = lane4(sv, kk), pk = lane4(pv, kk);
          acc[kk].x = fmaf(pk, gv.x, fmaf(w, av.x, acc[kk].x));
          acc[kk].y = fmaf(pk, gv.y, fmaf(w, av.y, acc[kk].y));
          acc[kk].z = fmaf(pk, gv.z, fmaf(w, av.z, acc[kk].z));
          acc[kk].w = fmaf(pk, gv.w, fmaf(w, av.w, acc[kk].w));
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = 4 * oy + kk;
        if (k < keys) {
          store_or_add4<V4>(db_rows + static_cast<size_t>(k) * d + c0 + 4 * q, acc[kk],
                            first_query_tile, cols);
        }
      }
    }
  }
}

// Grid (N): block p owns problem p, so dA's and dB's rows take no sum
// across blocks. With one key tile (Tk <= 64) a query tile's softmax
// statistics come from the tile itself; with more, a first phase walks the
// query tiles and their key tiles for each row's (m, l, D), kept in the
// stats scratch (N * Tq * 3 floats), and the second recomputes S and dP of
// every pair. Dynamic shared memory: kTiledBackwardSmem bytes.
template <bool V4>
__global__ void __launch_bounds__(kTiledThreads, kTiledBackwardBlocks)
cheap_xattn_backward_tiled_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                  const float* __restrict__ g, float* __restrict__ da,
                                  float* __restrict__ db, float* __restrict__ stats, int tq,
                                  int tk, int d, float sqrt_d) {
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);  // A's chunk
  float* bs = as + kSweepT * kBwdStride;        // B's chunk
  float* gs = bs + kSweepT * kBwdStride;        // dO's chunk
  float* ps = gs + kSweepT * kBwdStride;        // S, then P (64 x kTiledPStride)
  float* ss = ps + kSweepT * kTiledPStride;     // dP, then dS / sqrt(d)
  float* st = ss + kSweepT * kTiledPStride;     // m, l, D of each query row
  const size_t p = blockIdx.x;
  const float* ap = a + p * tq * d;
  const float* bp = b + p * tk * d;
  const float* gp = g + p * tq * d;
  const int query_tiles = (tq + kSweepT - 1) / kSweepT;
  const int key_tiles = (tk + kSweepT - 1) / kSweepT;
  float* sp = key_tiles > 1 ? stats + p * tq * 3 : nullptr;  // unused with one key tile

  if (key_tiles > 1) {  // phase 1: each query row's (m, l, D) over all key tiles
    for (int qt = 0; qt < query_tiles; ++qt) {
      const int q0 = qt * kSweepT, rows = min(kSweepT, tq - q0);
      for (int kt = 0; kt < key_tiles; ++kt) {
        const int k0 = kt * kSweepT;
        backward_scores<V4>(ap + static_cast<size_t>(q0) * d, bp + static_cast<size_t>(k0) * d,
                            gp + static_cast<size_t>(q0) * d, rows, min(kSweepT, tk - k0), d,
                            sqrt_d, as, bs, gs, ps, ss);
        backward_row_stats(ps, ss, st, kt == 0, kt == key_tiles - 1);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < rows; i += kTiledThreads) {
        float* r = sp + 3 * (q0 + i);
        r[0] = st[i];
        r[1] = st[kSweepT + i];
        r[2] = st[2 * kSweepT + i];
      }
    }
  }

  // phase 2: key tiles, and within each the query tiles, in ascending order
  for (int kt = 0; kt < key_tiles; ++kt) {
    const int k0 = kt * kSweepT, keys = min(kSweepT, tk - k0);
    for (int qt = 0; qt < query_tiles; ++qt) {
      const int q0 = qt * kSweepT, rows = min(kSweepT, tq - q0);
      if (key_tiles > 1) {
        // the barriers in backward_scores order these loads after the last
        // pair's reads of st and before this pair's
        for (int i = threadIdx.x; i < kSweepT; i += kTiledThreads) {
          const float* r = sp + 3 * (q0 + i);
          st[i] = i < rows ? r[0] : 0.0f;
          st[kSweepT + i] = i < rows ? r[1] : 1.0f;
          st[2 * kSweepT + i] = i < rows ? r[2] : 0.0f;
        }
      }
      const float* aq = ap + static_cast<size_t>(q0) * d;
      const float* bk = bp + static_cast<size_t>(k0) * d;
      const float* gq = gp + static_cast<size_t>(q0) * d;
      backward_scores<V4>(aq, bk, gq, rows, keys, d, sqrt_d, as, bs, gs, ps, ss);
      if (key_tiles == 1) backward_row_stats(ps, ss, st, true, true);
      __syncthreads();
      backward_probs(ps, ss, st, sqrt_d);
      __syncthreads();
      backward_grads<V4>(aq, bk, gq, da + (p * tq + q0) * d, db + (p * tk + k0) * d, rows, keys,
                         d, kt == 0, qt == 0, as, bs, gs, ps, ss);
    }
  }
}

// ---------------------------------------------------------------------------
// Launches. One function per direction works out a variant's launch, which
// both the entry point and cheap_xattn_config use.

struct Launch {
  const void* kernel;
  dim3 grid;
  int threads;
  size_t smem;  // dynamic shared memory, bytes
};

template <class Kernel>
const void* fn(Kernel kernel) {
  return reinterpret_cast<const void*>(kernel);
}

bool valid_sizes(int n, int tq, int tk, int d) {
  return n >= 1 && tq >= 1 && tk >= 1 && d >= 1;
}

// Whether `variant` takes these sizes.
bool variant_takes(int variant, bool backward, int tq, int tk, int d) {
  const bool sweep = tk <= kSweepT && (!backward || tq <= kSweepT);
  switch (variant) {
    case kSweepD12: return sweep && d == 12;
    case kSweep: return sweep && d <= kMaxD;
    case kTwoPass: return d <= kMaxD;
    case kSweep128: return d <= kMaxD && tk <= kLongT && (!backward || tq <= kLongT);
    case kTiled: return d > kMaxD;
    default: return false;
  }
}

// The sweep kernels' register width for d; variant 3 also takes 8 (d <= 8)
// and 12 (d = 12).
int sweep_width(int variant, int d) {
  if (variant == kSweep128 && (d <= 8 || d == 12)) return d <= 8 ? 8 : 12;
  return variant == kSweepD12 ? 12 : d <= 16 ? 16 : d <= 32 ? 32 : 64;
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Blocks of `kernel` the current card holds at once, over all its SMs.
cudaError_t resident_blocks(const void* kernel, int threads, size_t smem, int* blocks) {
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  *blocks = sms * per_sm;
  return err;
}

cudaError_t forward_launch(int variant, int n, int tq, int tk, int d, Launch* out) {
  if (!valid_sizes(n, tq, tk, d) || !variant_takes(variant, false, tq, tk, d)) {
    return cudaErrorInvalidValue;
  }
  Launch l{nullptr, dim3(1), kSweepThreads, 0};
  const bool v4 = d % 4 == 0;
  if (variant == kSweepD12 || variant == kSweep || variant == kSweep128) {
    const bool full = tk == kSweepT;
    if (variant == kSweep128) {
      switch (sweep_width(variant, d)) {
        case 8: l.kernel = fn(cheap_xattn_forward_sweep128_kernel<8>); break;
        case 12: l.kernel = fn(cheap_xattn_forward_sweep128_kernel<12>); break;
        case 16: l.kernel = fn(cheap_xattn_forward_sweep128_kernel<16>); break;
        case 32: l.kernel = fn(cheap_xattn_forward_sweep128_kernel<32>); break;
        default: l.kernel = fn(cheap_xattn_forward_sweep128_kernel<64>); break;
      }
    } else {
      switch (sweep_width(variant, d)) {
        case 12: l.kernel = full ? fn(cheap_xattn_forward_sweep_kernel<12, true>)
                                 : fn(cheap_xattn_forward_sweep_kernel<12, false>); break;
        case 16: l.kernel = fn(cheap_xattn_forward_sweep_kernel<16, false>); break;
        case 32: l.kernel = fn(cheap_xattn_forward_sweep_kernel<32, false>); break;
        default: l.kernel = fn(cheap_xattn_forward_sweep_kernel<64, false>); break;
      }
    }
    int resident;
    const cudaError_t err = resident_blocks(l.kernel, kSweepThreads, 0, &resident);
    if (err != cudaSuccess) return err;
    const long long units = static_cast<long long>(n) * ((tq + kSweepT - 1) / kSweepT);
    const int per_round = variant == kSweep128 ? 1 : kSlots;  // units a block takes a round
    const long long rounds = (units + per_round - 1) / per_round;
    l.grid = dim3(static_cast<unsigned>(rounds < resident ? rounds : resident));
  } else if (variant == kTwoPass) {
    if (d <= 16) {
      l.kernel = v4 ? fn(cheap_xattn_forward_kernel<16, true>) : fn(cheap_xattn_forward_kernel<16, false>);
    } else if (d <= 32) {
      l.kernel = v4 ? fn(cheap_xattn_forward_kernel<32, true>) : fn(cheap_xattn_forward_kernel<32, false>);
    } else {
      l.kernel = v4 ? fn(cheap_xattn_forward_kernel<64, true>) : fn(cheap_xattn_forward_kernel<64, false>);
    }
    l.threads = threads_for(tq);
    l.smem = static_cast<size_t>(kTile) * d * sizeof(float);
    l.grid = dim3(n, (tq + l.threads - 1) / l.threads);
  } else if (variant == kTiled) {
    l.kernel = v4 ? fn(cheap_xattn_forward_tiled_kernel<true>)
                  : fn(cheap_xattn_forward_tiled_kernel<false>);
    l.threads = kTiledThreads;
    l.smem = tiled_smem(d);
    int resident;
    cudaError_t err = allow_smem(l.kernel, l.smem);  // before the occupancy query
    if (err == cudaSuccess) err = resident_blocks(l.kernel, l.threads, l.smem, &resident);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorInvalidValue;
    const long long units = static_cast<long long>(n) * ((tq + kSweepT - 1) / kSweepT);
    l.grid = dim3(static_cast<unsigned>(units < resident ? units : resident));
  }
  *out = l;
  return allow_smem(l.kernel, l.smem);
}

cudaError_t backward_launch(int variant, int n, int tq, int tk, int d, Launch* out) {
  if (!valid_sizes(n, tq, tk, d) || !variant_takes(variant, true, tq, tk, d)) {
    return cudaErrorInvalidValue;
  }
  Launch l{nullptr, dim3(n), kSweepThreads, 0};
  const bool v4 = d % 4 == 0;
  if (variant == kSweepD12 || variant == kSweep) {
    const int w = sweep_width(variant, d);
    const bool full = tk == kSweepT;
    switch (w) {
      case 12: l.kernel = full ? fn(cheap_xattn_backward_sweep_kernel<12, true>)
                               : fn(cheap_xattn_backward_sweep_kernel<12, false>); break;
      case 16: l.kernel = fn(cheap_xattn_backward_sweep_kernel<16, false>); break;
      case 32: l.kernel = fn(cheap_xattn_backward_sweep_kernel<32, false>); break;
      default: l.kernel = fn(cheap_xattn_backward_sweep_kernel<64, false>); break;
    }
    l.smem = sweep_backward_smem(w);
  } else if (variant == kSweep128) {
    const int w = sweep_width(variant, d);
    switch (w) {
      case 8: l.kernel = fn(cheap_xattn_backward_sweep128_kernel<8>); break;
      case 12: l.kernel = fn(cheap_xattn_backward_sweep128_kernel<12>); break;
      case 16: l.kernel = fn(cheap_xattn_backward_sweep128_kernel<16>); break;
      case 32: l.kernel = fn(cheap_xattn_backward_sweep128_kernel<32>); break;
      default: l.kernel = fn(cheap_xattn_backward_sweep128_kernel<64>); break;
    }
    l.threads = kLongBwdThreads;
    l.smem = sweep128_backward_smem(w, tq, tk);
    if (l.smem > kMaxSmem) return cudaErrorInvalidValue;
  } else if (variant == kTwoPass) {
    if (d <= 16) {
      l.kernel = v4 ? fn(cheap_xattn_backward_kernel<16, true>) : fn(cheap_xattn_backward_kernel<16, false>);
    } else if (d <= 32) {
      l.kernel = v4 ? fn(cheap_xattn_backward_kernel<32, true>) : fn(cheap_xattn_backward_kernel<32, false>);
    } else {
      l.kernel = v4 ? fn(cheap_xattn_backward_kernel<64, true>) : fn(cheap_xattn_backward_kernel<64, false>);
    }
    l.threads = threads_for(tq > tk ? tq : tk);
    l.smem = (2 * static_cast<size_t>(kTile) * d + 3 * kTile) * sizeof(float);
  } else if (variant == kTiled) {
    l.kernel = v4 ? fn(cheap_xattn_backward_tiled_kernel<true>)
                  : fn(cheap_xattn_backward_tiled_kernel<false>);
    l.threads = kTiledThreads;
    l.smem = kTiledBackwardSmem;
  }
  *out = l;
  return allow_smem(l.kernel, l.smem);
}

}  // namespace

extern "C" {

// Launches the forward of `variant` on `stream`. Returns a cudaError_t: 0 on
// success, cudaErrorInvalidValue for sizes the variant does not take (N, Tq,
// Tk or d < 1: see variant_takes).
// a (N, Tq, d), b (N, Tk, d), out (N, Tq, d): contiguous, 16-byte aligned f32
// device pointers.
int cheap_xattn_forward(const float* a, const float* b, float* out, int n, int tq, int tk,
                        int d, int variant, void* stream) {
  Launch l;
  cudaError_t err = forward_launch(variant, n, tq, tk, d, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  float sqrt_d = sqrtf(static_cast<float>(d));
  float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(d)));
  void* sweep_args[] = {&a, &b, &out, &n, &tq, &tk, &d, &scale};
  void* two_pass_args[] = {&a, &b, &out, &tq, &tk, &d, &sqrt_d};
  void* tiled_args[] = {&a, &b, &out, &n, &tq, &tk, &d, &sqrt_d};
  void** args = variant == kTwoPass ? two_pass_args : variant == kTiled ? tiled_args : sweep_args;
  return static_cast<int>(cudaLaunchKernel(l.kernel, l.grid, dim3(l.threads), args, l.smem,
                                           static_cast<cudaStream_t>(stream)));
}

// Launches the backward of `variant` on `stream`. Returns a cudaError_t. a, b
// as the forward; g (N, Tq, d) the cotangent; da (N, Tq, d) and db (N, Tk, d)
// the outputs; stats a scratch buffer of N * Tq * 3 floats for variant 2,
// and for 4 beyond 64 keys (unused otherwise: may be null). All
// contiguous, 16-byte aligned f32 device pointers.
int cheap_xattn_backward(const float* a, const float* b, const float* g, float* da, float* db,
                         float* stats, int n, int tq, int tk, int d, int variant, void* stream) {
  Launch l;
  cudaError_t err = backward_launch(variant, n, tq, tk, d, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  float sqrt_d = sqrtf(static_cast<float>(d));
  float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(d)));
  void* sweep_args[] = {&a, &b, &g, &da, &db, &tq, &tk, &d, &scale};
  void* two_pass_args[] = {&a, &b, &g, &da, &db, &stats, &tq, &tk, &d, &sqrt_d};
  void** args = variant == kTwoPass || variant == kTiled ? two_pass_args : sweep_args;
  return static_cast<int>(cudaLaunchKernel(l.kernel, l.grid, dim3(l.threads), args, l.smem,
                                           static_cast<cudaStream_t>(stream)));
}

// The launch that cheap_xattn_forward (backward = 0) or cheap_xattn_backward
// (backward = 1) makes for `variant` at these sizes on the current card:
// threads a block, dynamic shared memory in bytes, the blocks an SM holds at
// once (the CUDA occupancy calculator: registers and static shared memory
// included) and the blocks of the grid. Returns a cudaError_t.
int cheap_xattn_config(int backward, int variant, int n, int tq, int tk, int d, int* threads,
                       int* smem_bytes, int* blocks_per_sm, int* blocks) {
  Launch l;
  cudaError_t err = backward ? backward_launch(variant, n, tq, tk, d, &l)
                             : forward_launch(variant, n, tq, tk, d, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = l.threads;
  *smem_bytes = static_cast<int>(l.smem);
  *blocks = static_cast<int>(l.grid.x * l.grid.y);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, l.kernel, l.threads, l.smem));
}

}  // extern "C"
