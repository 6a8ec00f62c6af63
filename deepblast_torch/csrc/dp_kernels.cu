// Hand-written Hopper (sm_90a) kernels of the soft alignment DP: skew and
// unskew, forward (with and without residual stores), backward (expected
// alignment, optionally with the gap expectation) and the two adjoint
// passes of training, on the port's batch-major stream layout (B, K, S):
// K = N+M-1 anti-diagonals, S = N+1 slots, 0-based cell (i, j) at
// [b, i+j, i+1] (deepblast_torch/ops/skew.py).
//
// TPU kernels replaced (deepblast_tpu/ops/):
//   skew_kernel            <- skew_bm.py:195 skew_bm (_skew_kernel :152)
//   skew_pair_kernel       <- skew_bm.py:243 skew_bm_pair
//                             (_skew_pair_kernel :164): both operands of a
//                             pair (theta and A, or Zt and Za) in one launch
//   unskew_kernel          <- skew_bm.py:321 unskew_bm (_unskew_kernel :290)
//   forward_kernel<.,true> <- dp_bm.py:1025 decode_stream_bm, forward phases
//                             (_fwd_phase_kernel :932); dp_bm.py:423
//                             forward_bm (_fwd_kernel :383); dp_bm_train.py:179
//                             forward_bm_phased
//   forward_kernel<.,false><- dp_bm.py:509 forward_score_bm
//                             (_fwd_score_kernel :468)
//   backward_kernel        <- dp_bm.py:1025 decode_stream_bm, backward phases
//                             (_bwd_phase_kernel :976); with kWantGap:
//                             dp_bm.py:617 backward_bm (_bwd_kernel :559),
//                             dp_bm_train.py:303 backward_bm_phased
//                             (_bwd_train_kernel :239)
//   adjoint_forward_kernel <- dp_bm.py:709 adjoint_forward_bm (:665);
//                             dp_bm_train.py:442 adjoint_forward_bm_phased
//                             (_afwd_train_kernel :381)
//   adjoint_backward_kernel<- dp_bm.py:827 adjoint_backward_bm (:756);
//                             dp_bm_train.py:595 adjoint_backward_bm_phased
//                             (_abwd_train_kernel :512)
// and the Q-stream kernels of the long-sequence backends (pallas,
// pallas_long), whose skew and unskew (skew_pallas.py:95 skew_pallas,
// :133 unskew_pallas) are skew_kernel and unskew_kernel in this layout:
//   forward_q_kernel       <- dp_pallas.py:223 forward_pallas (_fwd_kernel)
//   backward_q_kernel      <- dp_pallas.py:328 backward_pallas (_bwd_kernel),
//                             with kWantGap also _backward_v2's E (Qx + Qy)
//   adjoint_forward_q_kernel <- dp_pallas.py:423 adjoint_forward_pallas
//                             (_adj_fwd_kernel)
//   adjoint_backward_q_kernel<- dp_pallas.py:548 adjoint_backward_pallas
//                             (_adj_bwd_kernel) with _adjoint_backward_v2's
//                             EdA
// One kernel stands for both the phased and the monolithic TPU entry: the
// phase windows and the mod-Mp row fold there exist because Pallas block
// shapes are static.  The plain PyTorch versions are
// deepblast_torch/ops/skew.py (skew, unskew) and deepblast_torch/ops/dp_ref.py
// (the rest); the arithmetic here follows them operation by operation.
//
// What bounds them on the H100, on paper: bytes (the score-only forward:
// its MUFU and fp32 operations).  Per cell the forward reads 2
// streams (theta, A) and writes 2 (Dx, Dm), the score-only forward reads 2,
// the backward reads 2 (Dx, Dm) and writes 1 (E) or 2 (E, EA), the adjoint
// forward reads 3 or 4 (Dx, Dm, Zt[, Za]) and writes 2 (Dxd, Dmd), the
// adjoint backward reads 5 (Dx, Dm, Dxd, Dmd, E) and writes 2 (Ed, EdA),
// the relayouts read 1 and write 1.  The recurrence is also a chain of K
// dependent diagonal steps per pair, with one or two pairs on an SM at
// the bench's B = 256, so the latency of a step and the instructions
// issued per cell bound them in practice: without fast math one softmax
// max3 (three expf, a logf, an IEEE divide) is ~65 instructions, and the
// strip kernels issue ~210-245 per cell of their unrolled bodies
// (chip_smoke.py kernel_report; PERF.md).
//
// The forward and the backward (the decode's whole DP, and the forward of
// search), and the two adjoint passes of training, are designed for the
// H100 as follows.
//  * Smoothed max on the band only.  On diagonal k only the slots
//    [max(lo, k-m), min(n, k-lo)] hold a cell (about half of a square
//    pair's stream); max3 -- three expf, a logf and an IEEE divide under
//    softmax, ~100 issued instructions a cell at --fmad=false -- runs
//    there alone.  The padding keeps a cheap path that still writes the
//    plain version's value (forward: Dx, Dm by two subtractions, V = 0;
//    adjoint forward: Dxd, Dmd likewise, Vd = 0; backward: E = EA = 0,
//    Q = 0, since Q only multiplies E there; adjoint backward: Ed = 0, and
//    Q, Qd only where E is non-zero).  Rows past a ragged pair's terminal
//    diagonal are a plain store loop (except in the adjoint backward,
//    whose given E may be non-zero there).
//  * Inputs loaded ahead of the chain.  Their addresses depend on nothing
//    in the DP, so each thread keeps the rows of the next D diagonals in
//    flight in a register ring (D = 4, 2, 1 at strip width 2, 6, 20; the
//    adjoint forward, three or four input rows a diagonal, D = 2, 1, 1;
//    the adjoint backward, five, D = 2, 1) and issues row r+D as it starts
//    row r; only the band's values (and A or Za everywhere where Dm or
//    Dmd is stored) are read.  cp.async or TMA would save those
//    registers, but the (B, K, S) rows are not 16-byte aligned at odd S,
//    and 2-byte streams have no 2-byte cp.async.
//  * Synchronisation local to a pair, and lighter.  Thread t owns the T
//    consecutive slots [tT, tT+T) of every diagonal in registers (the V
//    rows of the forward and the Vd rows of the adjoint forward; the
//    products Qx E, Qy E, Qm E of the backward; five products of the
//    adjoint backward), so a block is ceil(S / T / 32) warps instead of
//    S / 32: 9 warps at S = 513, two pairs on most SMs.  A diagonal needs
//    one neighbour slot per strip (s0-1 in the forward passes, s0+T in
//    the reverse passes): by shuffle inside a warp, and through a
//    two-deep `edge` array and one named barrier (bar.sync 1) over the
//    pair's warps between warps.
//  * Every register row holds T slots, so one block of 1,024 threads holds
//    1,024 T slots; T grows with S (2 up to 2,048 slots, then 6, then 20
//    for the forward passes), and only the widest strips come near the 64
//    registers a thread has at 1,024 threads.
// Every cell still rounds as ops/dp_ref.py: the same float operations in
// the same order (the reverse passes' products are formed one row early
// and summed in the plain version's order), so every output is
// bit-identical.
//
// The relayouts move each value once and do no arithmetic: the skew and
// the unskew are tiled relayouts through shared memory, each the other's
// inverse (coalesced accesses of stream rows along the slots, coalesced
// accesses of natural row segments along the columns; the unskew reads
// only the stream's cells).
//
// The Q-stream kernels keep few rows by moving a stream more: the
// forward stores the three soft-argmax streams Q (and the adjoint forward
// the three Qd), and the reverse passes read Q (and Qd) straight from
// device memory instead of recomputing it.  Per cell they move forward 2
// in / 3 out, backward 3 in / 1 or 2 out, adjoint forward 4-5 in / 3 out,
// adjoint backward 7 in / 2 out: the same byte bound regime, with one more
// stream per pass than the default kernels.  Every output slot is written
// (zeros, or finite values outside the valid band), so no uninitialised
// memory can reach a Q * E or Qd * E product (0 * NaN).  All four split
// each pair across the CTAs of a thread-block cluster, the DP rows in
// registers (the note before forward_q_kernel), so a pair holds
// S <= 32,768 slots in each, and so does the pallas_long training step.
//
// Storage menu (deepblast_torch/ops/menu.py; deepblast_tpu/ops/dp_bm.py
// DTypeMenu): the streams of the default kernels and the relayouts are
// templated on their storage type -- float, __nv_bfloat16 (stores round to
// nearest even, __float2bfloat16_rn) or int16_t fixed point (stores
// floor(clip(v * scale, +-32767) + 0.5), loads (float)q * inv, with the
// scale and its inverse passed as float arguments).  Every register and
// every shared-memory row stays float, so the shared-memory rows and the
// limit checks do not change; only the loads and stores convert.  Inputs
// theta and A may be float, bf16 or int16; the differences Dx, Dm, Dxd,
// Dmd float or bf16; E, EA float, bf16 or (the decode only) int16; Ed,
// EdA and the cotangents Zt, Za float or bf16.  A bf16 difference stream
// halves the bytes of the stream it replaces; the value recurrences use
// the unrounded differences, the reverse passes the rounded ones, as the
// TPU kernels.  The Q-stream kernels take no menu (the JAX package gives
// its Q backends none), only the storage of the three Q streams,
// dp_pallas.Q_DTYPE: float or bf16 (TQ).  The forward rounds its Q stores
// to nearest even; the other three hold the 2-byte values in their
// register rings and widen them where a cell reads them; E, EA, Qd, Ed,
// EdA and the cotangents stay float (dp_pallas.py:212-214, :296-310,
// :396-398, :499-502).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (ops/dp_cuda.py compiles
//        the seven DP_PART objects in parallel and links them)
// No fast math (the traceback compares E values exactly), and no FMA
// contraction, so each cell rounds as the plain PyTorch version does.
// Each C entry returns cudaGetLastError() of its launch (the split Q
// kernels' entries the error of cudaLaunchKernelEx, or that).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { OP_SOFTMAX = 0, OP_SPARSEMAX = 1, OP_HARDMAX = 2 };
// storage codes of ops/dp_cuda.py _DTYPE_CODES
enum { DT_F32 = 0, DT_BF16 = 1, DT_I16 = 2 };

typedef __nv_bfloat16 bf16;

// Typed loads and stores of a stream value; compute is float.  `inv`
// dequantizes an int16 value, `scale` quantizes an int16 store (unused by
// the float types).
__device__ __forceinline__ float cvt(float x, float) { return x; }
__device__ __forceinline__ float cvt(bf16 x, float) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float cvt(int16_t q, float inv) {
  return (float)q * inv;
}
template <typename T>
__device__ __forceinline__ float ld(const T *p, size_t i, float inv) {
  return cvt(p[i], inv);
}
// The stored form of v: `scale` quantizes an int16 store (bf16 rounds to
// nearest even); the pointer only picks the type.
__device__ __forceinline__ float enc(const float *, float v, float) {
  return v;
}
__device__ __forceinline__ bf16 enc(const bf16 *, float v, float) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ int16_t enc(const int16_t *, float v,
                                       float scale) {
  return (int16_t)floorf(fminf(fmaxf(v * scale, -32767.0f), 32767.0f) +
                         0.5f);
}
template <typename T>
__device__ __forceinline__ void st(T *p, size_t i, float v, float scale) {
  p[i] = enc(p, v, scale);
}
// the 16 bits of a 2-byte stored value
__device__ __forceinline__ uint32_t bits16(bf16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint32_t bits16(int16_t v) {
  return (uint16_t)v;
}

// Smoothed max of (ax, am, ay) and its argmax (deepblast_torch/ops/smooth.py).
template <int OP>
__device__ __forceinline__ float max3(float ax, float am, float ay,
                                      float &px, float &pm, float &py) {
  if (OP == OP_SOFTMAX) {
    float mx = fmaxf(fmaxf(ax, am), ay);
    float ex = expf(ax - mx);
    float em = expf(am - mx);
    float ey = expf(ay - mx);
    float s = ex + em + ey;
    float inv = 1.0f / s;
    px = ex * inv;
    pm = em * inv;
    py = ey * inv;
    return mx + logf(s);
  } else if (OP == OP_SPARSEMAX) {
    float a_hi = fmaxf(ax, am);
    float a_lo = fminf(ax, am);
    float z1 = fmaxf(a_hi, ay);
    float z3 = fminf(a_lo, ay);
    float z2 = fmaxf(a_lo, fminf(a_hi, ay));
    float c1 = z1 + z2 - 1.0f;
    float c2 = c1 + z3;
    float cond2 = (2.0f * z2 > c1) ? 1.0f : 0.0f;
    float cond3 = (3.0f * z3 > c2) ? 1.0f : 0.0f;
    float rho = 1.0f + cond2 + cond3;
    float cssv = (z1 - 1.0f) + cond2 * z2 + cond3 * z3;
    float tau = cssv / rho;
    px = fmaxf(ax - tau, 0.0f);
    pm = fmaxf(am - tau, 0.0f);
    py = fmaxf(ay - tau, 0.0f);
    return px * (ax - 0.5f * px) + pm * (am - 0.5f * pm) +
           py * (ay - 0.5f * py);
  } else {
    float val = fmaxf(fmaxf(ax, am), ay);
    float ix = (ax == val) ? 1.0f : 0.0f;
    float im = (am == val) ? 1.0f : 0.0f;
    float iy = (ay == val) ? 1.0f : 0.0f;
    float inv = 1.0f / (ix + im + iy);
    px = ix * inv;
    pm = im * inv;
    py = iy * inv;
    return val;
  }
}

// Hessian-vector product of the smoothed max at p along (zx, zm, zy)
// (deepblast_torch/ops/smooth.py hessian3, operation by operation).
template <int OP>
__device__ __forceinline__ void hessian3(float px, float pm, float py,
                                         float zx, float zm, float zy,
                                         float &hx, float &hm, float &hy) {
  if (OP == OP_SOFTMAX) {
    float prodx = px * zx;
    float prodm = pm * zm;
    float prody = py * zy;
    float tot = prodx + prodm + prody;
    hx = prodx - px * tot;
    hm = prodm - pm * tot;
    hy = prody - py * tot;
  } else if (OP == OP_SPARSEMAX) {
    float sx = (px > 0.0f) ? 1.0f : 0.0f;
    float sm = (pm > 0.0f) ? 1.0f : 0.0f;
    float sy = (py > 0.0f) ? 1.0f : 0.0f;
    float support = sx + sm + sy;
    float prodx = sx * zx;
    float prodm = sm * zm;
    float prody = sy * zy;
    float avg = (prodx + prodm + prody) / fmaxf(support, 1.0f);
    hx = prodx - sx * avg;
    hm = prodm - sm * avg;
    hy = prody - sy * avg;
  } else {
    hx = 0.0f;
    hm = 0.0f;
    hy = 0.0f;
  }
}

__device__ __forceinline__ bool cell_valid(int s, int k, int n, int m, int lo) {
  int j = k - s;
  return s >= lo && j >= lo && s <= n && j <= m;
}

// The skew as a tiled relayout.  out[b, r, s] = x[b, s-1, r-s+1] where
// that cell exists, else 0, stored as TO (int16: quantized at `scale`).
// One CTA per tile of SKEW_R diagonals [r0, r0+R) x SKEW_C slots
// [s0, s0+C) of one pair (blockIdx.x; diagonals fastest, so neighbouring
// CTAs read neighbouring column segments of the same rows).  Slot s of
// the tile holds natural row i = s-1, whose cells in the tile are the R
// contiguous columns j in [r0-i, r0-i+R): a warp reads one such segment
// per load (lane = diagonal offset), coalesced along j and masked to
// [0, M), into a shared tile padded against bank conflicts; then the
// block writes the tile's R stream rows coalesced along s, zeros where
// no cell exists (slot 0, off the band).  The 2-byte forms store two
// neighbouring slots as one 32-bit word (pairs start at an even element
// of the stream; a slot whose partner lies in the next tile is stored
// alone).  A tile with no cell at all writes zeros without loading.
// Each input value is read once and each output value written once, so
// the kernel moves the bytes of its bound; the read segments are 128
// bytes at any alignment.
constexpr int SKEW_R = 32, SKEW_C = 128, SKEW_THREADS = 256;

template <typename TO>
__device__ __forceinline__ void skew_body(const float *__restrict__ x, int N,
                                          int M, int K, int S,
                                          TO *__restrict__ out, float scale) {
  __shared__ float tile[SKEW_C][SKEW_R + 1];
  const int tiles_r = (K + SKEW_R - 1) / SKEW_R;
  const int tiles_s = (S + SKEW_C - 1) / SKEW_C;
  const int r0 = (int)(blockIdx.x % tiles_r) * SKEW_R;
  const int t = (int)(blockIdx.x / tiles_r);
  const int s0 = (t % tiles_s) * SKEW_C;
  const int b = t / tiles_s;
  // column j = r - s + 1 of the tile's cells spans
  // [r0 - s0 - C + 2, r0 + R - s0]
  const bool cells = r0 + SKEW_R - s0 >= 0 && r0 - s0 - SKEW_C + 2 < M;
  if (cells) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int w = 0; w < SKEW_C; w += SKEW_THREADS / 32) {
      const int c = w + warp, s = s0 + c, j = r0 - s + 1 + lane;
      float v = 0.0f;
      if (s >= 1 && s < S && j >= 0 && j < M)
        v = x[((size_t)b * N + (s - 1)) * M + j];
      tile[c][lane] = v;
    }
    __syncthreads();
  }
  // positions a row: one slot each, or (2-byte forms) one aligned pair
  // of slots each, the first and last possibly half outside the tile
  constexpr int V = sizeof(TO) == 2 ? 2 : 1;
  constexpr int P = V == 1 ? SKEW_C : SKEW_C / 2 + 1;
  for (int idx = threadIdx.x; idx < SKEW_R * P; idx += SKEW_THREADS) {
    const int rr = idx / P, q = idx - rr * P;
    const int r = r0 + rr;
    if (r >= K) break;
    const size_t row = ((size_t)b * K + r) * S + s0;
    if (V == 1) {
      if (s0 + q < S) st(out, row + q, cells ? tile[q][rr] : 0.0f, scale);
    } else {
      const int c = 2 * q - (int)(row & 1);  // row + c is even
      const bool lo_ok = c >= 0 && c < SKEW_C && s0 + c < S;
      const bool hi_ok = c + 1 < SKEW_C && s0 + c + 1 < S;
      const float lo = cells && lo_ok ? tile[c][rr] : 0.0f;
      const float hi = cells && hi_ok ? tile[c + 1][rr] : 0.0f;
      if (lo_ok && hi_ok) {
        *(uint32_t *)(out + row + c) = bits16(enc(out, lo, scale)) |
                                       (bits16(enc(out, hi, scale)) << 16);
      } else {
        if (lo_ok) st(out, row + c, lo, scale);
        if (hi_ok) st(out, row + c + 1, hi, scale);
      }
    }
  }
}

template <typename TO>
__global__ void __launch_bounds__(SKEW_THREADS)
    skew_kernel(const float *__restrict__ x, int N, int M, int K, int S,
                TO *__restrict__ out, float scale) {
  skew_body(x, N, M, K, S, out, scale);
}

// Both operands of a pair in one launch: blockIdx.y picks the operand, and
// each half of the grid runs skew_kernel's tiles over its own stream, so
// the outputs are bit-identical to two skew_kernel launches.  The TPU fused
// its two skews to overlap their DMA within one pallas_call
// (skew_bm.py:167-180); here one launch puts both streams' tiles in
// flight at once and saves a launch.
template <typename TO>
__global__ void __launch_bounds__(SKEW_THREADS)
    skew_pair_kernel(const float *__restrict__ x, const float *__restrict__ y,
                     int N, int M, int K, int S, TO *__restrict__ ox,
                     TO *__restrict__ oy, float scale) {
  if (blockIdx.y == 0)
    skew_body(x, N, M, K, S, ox, scale);
  else
    skew_body(y, N, M, K, S, oy, scale);
}

// The unskew as a tiled relayout, the skew's access pattern reversed:
// out[b, i, j] = s[b, i+j, i+1] for every natural cell, float (a bf16
// stream widened, an int16 one dequantized by `inv`, 1 / 32767, as cvt
// does).  One CTA per tile of UNSKEW_ROWS natural rows [i0, i0+C) x
// UNSKEW_COLS columns [j0, j0+R) of one pair (blockIdx.x; columns
// fastest, so neighbouring CTAs write neighbouring segments of the same
// rows).  The tile's cells lie on the C+R-1 diagonals r in
// [i0+j0, i0+j0+C+R-2], each diagonal's cells a run of at most R
// consecutive slots of its stream row: slot offset c in [0, R) of
// diagonal r is slot r - j0 - R + 2 + c, natural (i, j) = (r - j0 - R + 1
// + c, j0 + R - 1 - c).  The block reads each run coalesced (lane = slot),
// only the slots that hold a cell of the tile, into a shared tile padded
// to R+2 columns (a run's lanes step one row down and one column left, so
// they fall on distinct banks); the 2-byte forms read aligned pairs of
// slots, one 32-bit word where both halves hold a cell, as the skew stores
// them (the pair's parity is taken from the address, so any 2-byte-aligned
// stream works).  Then each warp writes natural rows of the tile, R
// columns from j0, coalesced (lane = column) and masked to [0, M).  Every
// natural cell lies in exactly one tile, so it is read once and written
// once, and the stream's padding is never loaded: the kernel moves
// B N M values in and B N M floats out, the bytes of its bound.  Natural
// tiles write aligned segments and read runs at any alignment (the
// skew's pattern reversed); at 256 x 512 x 512 they beat tiles of 32
// diagonals x 128 slots, which write at any alignment, by 13%
// (PERF.md).
constexpr int UNSKEW_COLS = 32, UNSKEW_ROWS = 128;

// a stored 2-byte value from its 16 bits
template <typename T>
__device__ __forceinline__ T from_bits16(uint32_t v);
template <>
__device__ __forceinline__ bf16 from_bits16<bf16>(uint32_t v) {
  return __ushort_as_bfloat16((unsigned short)v);
}
template <>
__device__ __forceinline__ int16_t from_bits16<int16_t>(uint32_t v) {
  return (int16_t)(uint16_t)v;
}
// a zero of storage type T (the Q kernels' rings hold stored values)
template <typename T>
__device__ __forceinline__ T zero_of() {
  return from_bits16<T>(0u);
}
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.0f;
}

template <typename TI>
__global__ void __launch_bounds__(SKEW_THREADS)
    unskew_kernel(const TI *__restrict__ s, int N, int M, int K, int S,
                  float inv, float *__restrict__ out) {
  constexpr int R = UNSKEW_COLS, C = UNSKEW_ROWS;
  __shared__ float tile[C][R + 2];
  const int tiles_j = (M + R - 1) / R;
  const int tiles_i = (N + C - 1) / C;
  const int j0 = (int)(blockIdx.x % tiles_j) * R;
  const int t = (int)(blockIdx.x / tiles_j);
  const int i0 = (t % tiles_i) * C;
  const int b = t / tiles_i;
  // slot offset c of diagonal r holds a cell of the tile
  auto cell = [&](int r, int c) {
    const int i = r - j0 - R + 1 + c, j = j0 + R - 1 - c;
    return c >= 0 && c < R && i >= i0 && i < i0 + C && i < N && j < M;
  };
  auto put = [&](int r, int c, float v) {
    tile[r - j0 - R + 1 + c - i0][R - 1 - c] = v;
  };
  // positions a run: one slot each, or (2-byte forms) one aligned pair of
  // slots each, the first and last possibly half outside the run
  constexpr int V = sizeof(TI) == 2 ? 2 : 1;
  constexpr int P = V == 1 ? R : R / 2 + 1;
  for (int idx = threadIdx.x; idx < (C + R - 1) * P; idx += SKEW_THREADS) {
    const int d = idx / P, q = idx - d * P;
    const int r = i0 + j0 + d;
    if (r >= K) break;
    // element of slot offset 0 (its slot may precede the stream row)
    const long long at = ((long long)b * K + r) * S + (r - j0 - R + 2);
    if constexpr (V == 1) {
      if (cell(r, q)) put(r, q, ld(s, (size_t)(at + q), inv));
    } else {
      const int c =
          2 * q - (int)((((uintptr_t)s >> 1) + (uintptr_t)at) & 1);
      const bool lo_ok = cell(r, c), hi_ok = cell(r, c + 1);
      if (lo_ok && hi_ok) {
        const uint32_t w = *(const uint32_t *)(s + at + c);
        put(r, c, cvt(from_bits16<TI>(w & 0xffffu), inv));
        put(r, c + 1, cvt(from_bits16<TI>(w >> 16), inv));
      } else {
        if (lo_ok) put(r, c, ld(s, (size_t)(at + c), inv));
        if (hi_ok) put(r, c + 1, ld(s, (size_t)(at + c + 1), inv));
      }
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int ii = warp; ii < C && i0 + ii < N; ii += SKEW_THREADS / 32) {
    const size_t row = ((size_t)b * N + i0 + ii) * M + j0;
#pragma unroll
    for (int jj = lane; jj < R; jj += 32)
      if (j0 + jj < M) out[row + jj] = tile[ii][jj];
  }
}

// The forward and the backward: one CTA per pair, W = ceil(S / T / 32)
// warps, thread t owning the strip of slots [tT, tT + T) in registers
// (T = 2, 6 or 20 by S: DP_SWITCH_FORWARD_STRIP, DP_SWITCH_BACKWARD_STRIP).
// The input rows of the next D diagonals
// are in flight while the current one computes (a register ring, D =
// ring_for(T)), the smoothed max runs only on the diagonal's band, and the
// neighbour at a strip's edge comes by shuffle inside a warp and through
// `edge` and one named barrier over the pair's warps between warps.

// The ring depth of a strip width: the rows in flight per thread cost 2 T
// registers each, and the block must fit 64 registers a thread at 1,024
// threads.
__host__ __device__ constexpr int ring_for(int T) {
  return T <= 2 ? 4 : (T <= 6 ? 2 : 1);
}

// The pair's barrier: named barrier 1 over the block's warps, which are
// the pair's and no other's.
__device__ __forceinline__ void pair_barrier() {
  asm volatile("bar.sync 1, %0;" ::"r"((int)blockDim.x) : "memory");
}

// The band of diagonal k: slots [max(lo, k - m), min(n, k - lo)].
__device__ __forceinline__ bool in_band(int s, int k, int n, int m, int lo) {
  return s >= max(lo, k - m) && s <= min(n, k - lo);
}

// Forward, diagonals ascending.  Registers: V rows r-1 and r-2 of the
// strip (v1, v2) and, at its left edge, slot s0-1 of both (l1, l2).  Row
// r of the inputs is loaded D rows ahead: A at every slot with residual
// stores (Dm needs it), else on the band only; theta on the band only.
// Inputs of TI (int16 dequantized by `inv`), residuals stored as TD for
// every slot; the value recurrence uses the unrounded differences.  Rows
// past n+m have V[r-1] = V[r-2] = 0: a plain store loop writes their
// Dx = 0 - 0 and Dm = (0 - A) - 0.  The score-only walk stops at the
// terminal row.
template <int OP, bool kStoreResiduals, typename TI, typename TD, int T>
__global__ void __launch_bounds__(1024)
    forward_kernel(const TI *__restrict__ th, const TI *__restrict__ ad,
                   float inv, const int *__restrict__ ln,
                   const int *__restrict__ lm, int K, int S, int lo,
                   float *__restrict__ vt, TD *__restrict__ dxo,
                   TD *__restrict__ dmo) {
  constexpr int D = ring_for(T);
  __shared__ float edge[2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = threadIdx.x * T;
  const int b = blockIdx.x;
  const int n = ln[b], m = lm[b];
  const size_t base = (size_t)b * K * S;
  const int rows = kStoreResiduals ? min(K, n + m + 1) : min(K, n + m - 1);
  float v1[T], v2[T], l1 = 0.0f, l2 = 0.0f;
  TI pa[D][T], pt[D][T];
#pragma unroll
  for (int i = 0; i < T; ++i) v1[i] = v2[i] = 0.0f;

  // issue the loads of slot s0+i of row q into ring slot d
  auto fetch = [&](int d, int q, int i) {
    const int s = s0 + i;
    const bool band = q < rows && in_band(s, q + 2, n, m, lo);
    const bool need_a = kStoreResiduals ? (q < rows && s < S) : band;
    const size_t at = base + (size_t)q * S + s;
    pa[d][i] = need_a ? ad[at] : TI();
    pt[d][i] = band ? th[at] : TI();
  };
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int i = 0; i < T; ++i) fetch(d, d, i);

  for (int r0 = 0; r0 < rows; r0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int r = r0 + d;
      if (r >= rows) break;
      const int k = r + 2;
      const size_t row = base + (size_t)r * S;
      float vn[T];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const int s = s0 + i;
        const float a = cvt(pa[d][i], inv), t = cvt(pt[d][i], inv);
        fetch(d, r + D, i);
        const float v1l = i ? v1[i - 1] : l1;
        const float v2l = i ? v2[i - 1] : l2;
        const float dx = v1l - v1[i];
        const float dm = v2l - a - v1[i];
        if (kStoreResiduals && s < S) {
          st(dxo, row + s, dx, 0.0f);
          st(dmo, row + s, dm, 0.0f);
        }
        float v = 0.0f;
        if (in_band(s, k, n, m, lo)) {
          float px, pm, py;
          const float rel = max3<OP>(dx, dm, 0.0f, px, pm, py);
          v = t + a + v1[i] + rel;
          if (s == n && k == n + m) vt[b] = v;
        }
        vn[i] = v;
      }
      // V[r][s0-1]: the left lane's last slot, or the left warp's
      float left = __shfl_up_sync(0xffffffffu, vn[T - 1], 1);
      if (lane == 31) edge[r & 1][warp] = vn[T - 1];
      pair_barrier();
      if (lane == 0) left = warp ? edge[r & 1][warp - 1] : 0.0f;
      l2 = l1;
      l1 = left;
#pragma unroll
      for (int i = 0; i < T; ++i) {
        v2[i] = v1[i];
        v1[i] = vn[i];
      }
    }
  }
  if (kStoreResiduals) {
    const float zero = 0.0f;
    for (int r = rows; r < K; ++r) {
      const size_t row = base + (size_t)r * S;
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const int s = s0 + i;
        if (s < S) {
          st(dxo, row + s, zero - zero, 0.0f);
          st(dmo, row + s, zero - ld(ad, row + s, inv) - zero, 0.0f);
        }
      }
    }
  }
}

// Backward, diagonals descending.  Registers, per strip slot: the products
// X = Qx E and Y = Qy E of row r+1 and M = Qm E of rows r+1 and r+2 (x1,
// y1, m1, m2), and at its right edge slot s0+T of x1, m1, m2 (rx1, rm1,
// rm2), so that E[r] = (X[r+1] + M[r+2]) at s+1, + Y[r+1] at s, as
// E = shl(Qx1 E1) + shl(Qm2 E2) + Qy1 E1 rounds in the plain version.  Q
// is 0 off the band: it only multiplies E there, which is 0 -- except at
// the terminal slot, which is seeded with Et even where it lies off the
// band (sw with n = 1 or m = 1), so Q is computed there too.  Dx, Dm of
// TD, loaded D rows ahead on the band (and the terminal slot) only.  With kWantGap it also writes
// EA[r] = E[r] (Qx[r] + Qy[r]).  E and EA stored as TE (int16, the
// decode's E: quantized at `escale`) for every slot; rows past n+m-2 hold
// no cell and are stored as zeros.
template <int OP, bool kWantGap, typename TD, typename TE, int T>
__global__ void __launch_bounds__(1024)
    backward_kernel(const TD *__restrict__ dx, const TD *__restrict__ dm,
                    const int *__restrict__ ln, const int *__restrict__ lm,
                    const float *__restrict__ et, int K, int S, int lo,
                    float escale, TE *__restrict__ eo,
                    TE *__restrict__ eao) {
  constexpr int D = ring_for(T);
  __shared__ float edge[2][2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int s0 = threadIdx.x * T;
  const int b = blockIdx.x;
  const int n = ln[b], m = lm[b];
  const float e_t = et[b];
  const size_t base = (size_t)b * K * S;
  const int top = min(K, n + m - 1);  // rows [top, K) hold no cell
  for (int r = K - 1; r >= top; --r) {
    const size_t row = base + (size_t)r * S;
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int s = s0 + i;
      if (s < S) {
        st(eo, row + s, 0.0f, escale);
        if (kWantGap) st(eao, row + s, 0.0f * (0.0f + 0.0f), escale);
      }
    }
  }
  float x1[T], y1[T], m1[T], m2[T];
  float rx1 = 0.0f, rm1 = 0.0f, rm2 = 0.0f;
  TD px_[D][T], pm_[D][T];
#pragma unroll
  for (int i = 0; i < T; ++i) x1[i] = y1[i] = m1[i] = m2[i] = 0.0f;

  // issue the loads of slot s0+i of row q into ring slot d
  auto fetch = [&](int d, int q, int i) {
    const int s = s0 + i;
    const bool band = q >= 0 && (in_band(s, q + 2, n, m, lo) ||
                                 (s == n && q + 2 == n + m));
    const size_t at = base + (size_t)q * S + s;
    px_[d][i] = band ? dx[at] : TD();
    pm_[d][i] = band ? dm[at] : TD();
  };
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int i = 0; i < T; ++i) fetch(d, top - 1 - d, i);

  for (int r0 = top - 1; r0 >= 0; r0 -= D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int r = r0 - d;
      if (r < 0) break;
      const int k = r + 2;
      const size_t row = base + (size_t)r * S;
      float xn[T], yn[T], mn[T];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const int s = s0 + i;
        const float dxs = cvt(px_[d][i], 0.0f), dms = cvt(pm_[d][i], 0.0f);
        fetch(d, r - D, i);
        const bool band = in_band(s, k, n, m, lo);
        const bool term = s == n && k == n + m;
        const float xr = i + 1 < T ? x1[i + 1] : rx1;
        const float mr = i + 1 < T ? m2[i + 1] : rm2;
        float e = xr + mr + y1[i];
        e = band ? e : 0.0f;
        if (term) e = e + e_t;
        float px = 0.0f, pm = 0.0f, py = 0.0f;
        if (band || term) max3<OP>(dxs, dms, 0.0f, px, pm, py);
        if (s < S) {
          st(eo, row + s, e, escale);
          if (kWantGap) st(eao, row + s, e * (px + py), escale);
        }
        xn[i] = px * e;
        yn[i] = py * e;
        mn[i] = pm * e;
      }
      // X[r], M[r] at s0+T: the right lane's first slot, or the right
      // warp's (0 past the last slot)
      float rx = __shfl_down_sync(0xffffffffu, xn[0], 1);
      float rm = __shfl_down_sync(0xffffffffu, mn[0], 1);
      if (lane == 0) {
        edge[r & 1][0][warp] = xn[0];
        edge[r & 1][1][warp] = mn[0];
      }
      pair_barrier();
      if (lane == 31) {
        const bool last = warp + 1 == nwarps;
        rx = last ? 0.0f : edge[r & 1][0][warp + 1];
        rm = last ? 0.0f : edge[r & 1][1][warp + 1];
      }
      rx1 = rx;
      rm2 = rm1;
      rm1 = rm;
#pragma unroll
      for (int i = 0; i < T; ++i) {
        x1[i] = xn[i];
        y1[i] = yn[i];
        m2[i] = m1[i];
        m1[i] = mn[i];
      }
    }
  }
}

// The adjoint forward's ring depth at strip width T: three input rows (Dx,
// Dm, Zt) a ring slot, four with Za, against the forward's two.  A ring of
// 4 at strips of 2 spills in the float32 and Za instances (PERF.md).
__host__ __device__ constexpr int afwd_ring_for(int T) {
  return T <= 2 ? 2 : 1;
}

// Tangent of the forward along (Zt, Za), a strip kernel like the forward
// whose recurrence it differentiates (V becomes Vd, theta and A become Zt
// and Za): one CTA per pair, diagonals ascending, thread t owning the
// slots [tT, tT+T).  Registers: Vd rows r-1 and r-2 of the strip (v1, v2)
// and, at its left edge, slot s0-1 of both (l1, l2), from the left lane by
// shuffle or the left warp through `edge` and the pair's barrier.
// Q = max3(Dx, Dm, 0) and Vd run on the band only (Vd is 0 off it, as the
// plain version masks it); the term order is _afwd_train_kernel's
// (dp_bm_train.py:425-430), Vd = Zt [+ Za] + Vd[r-1] + Qx Dxd + Qm Dmd on
// the unrounded differences.  Dxd = shr(Vd[r-1]) - Vd[r-1] and
// Dmd = shr(Vd[r-2]) [- Za] - Vd[r-1] are stored at every slot, as TD.
// Row r of Dx, Dm and Zt is loaded D rows ahead on the band only, Za at
// every slot (Dmd needs it).  Rows past n+m have Vd[r-1] = Vd[r-2] = 0: a
// plain store loop writes their Dxd = 0 - 0 and Dmd = (0 - Za) - 0.
// Without kHasZa there is no Za stream at all (a zero gap cotangent, the
// training path).  The cotangents Zt, Za of TZ (never int16: they are
// unbounded).
template <int OP, bool kHasZa, typename TD, typename TZ, int T>
__global__ void __launch_bounds__(1024)
    adjoint_forward_kernel(const TD *__restrict__ dx,
                           const TD *__restrict__ dm,
                           const TZ *__restrict__ zt,
                           const TZ *__restrict__ za,
                           const int *__restrict__ ln,
                           const int *__restrict__ lm, int K, int S, int lo,
                           float *__restrict__ vtd, TD *__restrict__ dxdo,
                           TD *__restrict__ dmdo) {
  constexpr int D = afwd_ring_for(T);
  __shared__ float edge[2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = threadIdx.x * T;
  const int b = blockIdx.x;
  const int n = ln[b], m = lm[b];
  const size_t base = (size_t)b * K * S;
  const int rows = min(K, n + m + 1);
  float v1[T], v2[T], l1 = 0.0f, l2 = 0.0f;
  TD px_[D][T], pm_[D][T];
  TZ pz[D][T], pa[D][T];  // pa: Za, unused without it
#pragma unroll
  for (int i = 0; i < T; ++i) v1[i] = v2[i] = 0.0f;

  // issue the loads of slot s0+i of row q into ring slot d
  auto fetch = [&](int d, int q, int i) {
    const int s = s0 + i;
    const bool band = q < rows && in_band(s, q + 2, n, m, lo);
    const size_t at = base + (size_t)q * S + s;
    px_[d][i] = band ? dx[at] : TD();
    pm_[d][i] = band ? dm[at] : TD();
    pz[d][i] = band ? zt[at] : TZ();
    if constexpr (kHasZa) pa[d][i] = q < rows && s < S ? za[at] : TZ();
  };
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int i = 0; i < T; ++i) fetch(d, d, i);

  for (int r0 = 0; r0 < rows; r0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int r = r0 + d;
      if (r >= rows) break;
      const int k = r + 2;
      const size_t row = base + (size_t)r * S;
      float vn[T];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const int s = s0 + i;
        const float a = cvt(px_[d][i], 0.0f), am = cvt(pm_[d][i], 0.0f);
        const float z = cvt(pz[d][i], 0.0f);
        const float zas = kHasZa ? cvt(pa[d][i], 0.0f) : 0.0f;
        fetch(d, r + D, i);
        const float v1l = i ? v1[i - 1] : l1;
        const float v2l = i ? v2[i - 1] : l2;
        const float dxd = v1l - v1[i];
        const float dmd = kHasZa ? v2l - zas - v1[i] : v2l - v1[i];
        if (s < S) {
          st(dxdo, row + s, dxd, 0.0f);
          st(dmdo, row + s, dmd, 0.0f);
        }
        float v = 0.0f;
        if (in_band(s, k, n, m, lo)) {
          float px, pm, py;
          max3<OP>(a, am, 0.0f, px, pm, py);
          v = kHasZa ? z + zas + v1[i] + px * dxd + pm * dmd
                     : z + v1[i] + px * dxd + pm * dmd;
          if (s == n && k == n + m) vtd[b] = v;
        }
        vn[i] = v;
      }
      // Vd[r][s0-1]: the left lane's last slot, or the left warp's
      float left = __shfl_up_sync(0xffffffffu, vn[T - 1], 1);
      if (lane == 31) edge[r & 1][warp] = vn[T - 1];
      pair_barrier();
      if (lane == 0) left = warp ? edge[r & 1][warp - 1] : 0.0f;
      l2 = l1;
      l1 = left;
#pragma unroll
      for (int i = 0; i < T; ++i) {
        v2[i] = v1[i];
        v1[i] = vn[i];
      }
    }
  }
  const float zero = 0.0f;
  for (int r = rows; r < K; ++r) {
    const size_t row = base + (size_t)r * S;
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int s = s0 + i;
      if (s < S) {
        st(dxdo, row + s, zero - zero, 0.0f);
        st(dmdo, row + s,
           kHasZa ? zero - ld(za, row + s, 0.0f) - zero : zero - zero, 0.0f);
      }
    }
  }
}

// The adjoint backward's ring depth at strip width T: five input rows
// (Dx, Dm, Dxd, Dmd, E) a ring slot, against the backward's two.
__host__ __device__ constexpr int abwd_ring_for(int T) {
  return T <= 2 ? 2 : 1;
}

// Tangent of the backward, a strip kernel like the backward: one CTA per
// pair, diagonals descending, thread t owning the slots [tT, tT+T).
// Registers, per strip slot: the products of the rows before that the
// plain version sums (dp_ref.py:303-304),
//   Ed[r] = shl(X[r+1]) + shl(M[r+2]) + Yd[r+1] + Yq[r+1]
// with X = Qdx E + Qx Ed, M = Qdm E + Qm Ed, Yd = Qdy E and Yq = Qy Ed
// (x1, m1, m2, yd1, yq1; Yd and Yq stay two values, as the plain sum
// rounds them apart), and at the strip's right edge slot s0+T of X[r+1],
// M[r+1] and M[r+2] (rx1, rm1, rm2), from the right lane by shuffle or
// the right warp through `edge` and the pair's barrier.  Q = max3(Dx, Dm,
// 0) and Qd = hessian3(Q, (Dxd, Dmd, 0)) are computed on the band, where
// Ed lives, and wherever E is non-zero off it: the plain version reads E
// at every slot, so off the band a product Qd E is 0 only when E is
// (the dispatcher's E is, but the terminal slot, seeded with Et, lies off
// the band in sw with n = 1 or m = 1, and a caller may pass any E); there
// Dx, Dm, Dxd, Dmd are loaded on the spot, since the ring holds them on
// the band only.  E is read at every slot, D rows ahead; Ed is stored
// masked (the terminal seed has zero tangent), and the fused gap adjoint
// EdA = Ed (Qx + Qy) + E (Qdx + Qdy) at every slot (0 where Q is not
// computed: Ed and E are 0 there).  Every row is walked: E may be
// non-zero past the terminal diagonal.  Dx, Dm, Dxd, Dmd of TD; E read
// and Ed, EdA stored as TE (float or bf16: the training expectations are
// unbounded).
template <int OP, typename TD, typename TE, int T>
__global__ void __launch_bounds__(1024)
    adjoint_backward_kernel(const TD *__restrict__ dx,
                            const TD *__restrict__ dm,
                            const TD *__restrict__ dxd,
                            const TD *__restrict__ dmd,
                            const TE *__restrict__ E,
                            const int *__restrict__ ln,
                            const int *__restrict__ lm, int K, int S, int lo,
                            TE *__restrict__ edo, TE *__restrict__ edao) {
  constexpr int D = abwd_ring_for(T);
  __shared__ float edge[2][2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int s0 = threadIdx.x * T;
  const int b = blockIdx.x;
  const int n = ln[b], m = lm[b];
  const size_t base = (size_t)b * K * S;
  float x1[T], m1[T], m2[T], yd1[T], yq1[T];
  float rx1 = 0.0f, rm1 = 0.0f, rm2 = 0.0f;
  TD pdx[D][T], pdm[D][T], pdxd[D][T], pdmd[D][T];
  TE pe[D][T];
#pragma unroll
  for (int i = 0; i < T; ++i) x1[i] = m1[i] = m2[i] = yd1[i] = yq1[i] = 0.0f;

  // issue the loads of slot s0+i of row q into ring slot d: E at every
  // slot, the differences on the band
  auto fetch = [&](int d, int q, int i) {
    const int s = s0 + i;
    const bool band = q >= 0 && in_band(s, q + 2, n, m, lo);
    const size_t at = base + (size_t)q * S + s;
    pe[d][i] = q >= 0 && s < S ? E[at] : TE();
    pdx[d][i] = band ? dx[at] : TD();
    pdm[d][i] = band ? dm[at] : TD();
    pdxd[d][i] = band ? dxd[at] : TD();
    pdmd[d][i] = band ? dmd[at] : TD();
  };
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int i = 0; i < T; ++i) fetch(d, K - 1 - d, i);

  for (int r0 = K - 1; r0 >= 0; r0 -= D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int r = r0 - d;
      if (r < 0) break;
      const int k = r + 2;
      const size_t row = base + (size_t)r * S;
      float xn[T], mn[T];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const int s = s0 + i;
        const float e = cvt(pe[d][i], 0.0f);
        float a = cvt(pdx[d][i], 0.0f), am = cvt(pdm[d][i], 0.0f);
        float ad = cvt(pdxd[d][i], 0.0f), amd = cvt(pdmd[d][i], 0.0f);
        fetch(d, r - D, i);
        const bool band = in_band(s, k, n, m, lo);
        const float xr = i + 1 < T ? x1[i + 1] : rx1;
        const float mr = i + 1 < T ? m2[i + 1] : rm2;
        const float ed = band ? xr + mr + yd1[i] + yq1[i] : 0.0f;
        float x = 0.0f, mm = 0.0f, yd = 0.0f, yq = 0.0f, eda = 0.0f;
        if (band || e != 0.0f) {
          if (!band) {
            a = ld(dx, row + s, 0.0f);
            am = ld(dm, row + s, 0.0f);
            ad = ld(dxd, row + s, 0.0f);
            amd = ld(dmd, row + s, 0.0f);
          }
          float px, pm, py, hx, hm, hy;
          max3<OP>(a, am, 0.0f, px, pm, py);
          hessian3<OP>(px, pm, py, ad, amd, 0.0f, hx, hm, hy);
          x = hx * e + px * ed;
          mm = hm * e + pm * ed;
          yd = hy * e;
          yq = py * ed;
          eda = ed * (px + py) + e * (hx + hy);
        }
        if (s < S) {
          st(edo, row + s, ed, 0.0f);
          st(edao, row + s, eda, 0.0f);
        }
        xn[i] = x;
        mn[i] = mm;
        yd1[i] = yd;
        yq1[i] = yq;
      }
      // X[r], M[r] at s0+T: the right lane's first slot, or the right
      // warp's (0 past the last slot)
      float rx = __shfl_down_sync(0xffffffffu, xn[0], 1);
      float rm = __shfl_down_sync(0xffffffffu, mn[0], 1);
      if (lane == 0) {
        edge[r & 1][0][warp] = xn[0];
        edge[r & 1][1][warp] = mn[0];
      }
      pair_barrier();
      if (lane == 31) {
        const bool last = warp + 1 == nwarps;
        rx = last ? 0.0f : edge[r & 1][0][warp + 1];
        rm = last ? 0.0f : edge[r & 1][1][warp + 1];
      }
      rx1 = rx;
      rm2 = rm1;
      rm1 = rm;
#pragma unroll
      for (int i = 0; i < T; ++i) {
        x1[i] = xn[i];
        m2[i] = m1[i];
        m1[i] = mn[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Q-stream kernels (the pallas / pallas_long backends)
// ---------------------------------------------------------------------------

// The split Q kernels (forward_q_kernel, backward_q_kernel,
// adjoint_forward_q_kernel and adjoint_backward_q_kernel): a pair's slots
// split across the C CTAs of a thread-block cluster, the DP rows in
// registers.  What bounds them on the H100: on paper bytes (the forward
// moves 2 streams in and 3 out, the backward 3 in and 1-2 out, the
// adjoint forward 4-5 in and 3 out, the adjoint backward 7 in and 2
// out), in practice the chain of K dependent diagonals of a pair: each
// diagonal costs one barrier and one dependent max3 (or product) chain,
// so the design spreads a pair over SMs and keeps the chain short (at 8
// x 4096 x 4096 a diagonal takes ~1.3 us, about a third of it the
// cluster barrier, the rest the strip's two dependent slots; PERF.md).
// Where the first versions lost their time: one CTA walked all K
// diagonals of a pair, so at the long path's B = 2-8 pairs 124-130 of
// 132 SMs sat idle and each diagonal (up to 4,097 slots) was issued by
// one SM, from rows in shared memory behind one __syncthreads() a
// diagonal, its loads not issued ahead (and the backward read each Q
// value up to five times).
//  * B clusters of C CTAs (C = 1, 2, 4, 8 or 16, chosen by ops/dp_cuda.py
//    _cluster_size: about 132 / B, and at least enough CTAs for the pair's
//    slots), launched with cudaLaunchKernelEx and a cluster dimension.  CTA
//    c of a cluster owns the contiguous slots [c Sc, (c+1) Sc) of every
//    diagonal, Sc = T x its threads (q_threads: whole warps); its thread
//    t the T = Q_STRIP slots from s0 = c Sc + t T, in registers, as in the
//    strip kernels.  CTAs whose slots lie past S (or a ragged pair's n)
//    compute zeros but take every barrier.
//  * The dependence between CTAs is one slot a diagonal.  The forward
//    passes (diagonals ascending): cell 0 needs V[r-1] and V[r-2] (Vd in
//    the adjoint forward) at s0-1, from the CTA on the left.  The reverse
//    passes (rows descending): the last cell needs X[r+1] and M[r+2] at
//    s0+T (the backward's products Qx E, Qm E; the adjoint backward's
//    Qdx E + Qx Ed, Qdm E + Qm Ed), from the CTA on the right.  The
//    producing thread stores its edge value into the neighbour's shared
//    memory (mapa + st.shared::cluster, a distributed shared-memory
//    store); inside a CTA it comes by shuffle in a warp and through `edge`
//    between warps.
//  * One split cluster barrier a diagonal.  A thread computes its T-1
//    slots that need no neighbour first, stores its edge value, waits
//    (barrier.cluster.wait.acquire) for the barrier of the diagonal before,
//    reads its neighbour's edge, computes its last slot and arrives
//    (barrier.cluster.arrive.release); the wait overlaps the other slots.
//    Since a thread stores the edge of r before it waits on the barrier of
//    r-1, a neighbour may still be reading the edge of r-2: the edge rings
//    are Q_EDGE_RING = 3 diagonals deep (a thread has passed the barrier of
//    r-2, so every reader has read r-3, whose slot it overwrites).  With
//    one CTA a pair (C = 1) the same schedule runs on the block's named
//    barrier at the wait (the kCluster = false instances).
//  * Lifetime: a cluster barrier before the walk (every CTA of the cluster
//    is running before its shared memory is stored into) and a wait on the
//    last diagonal's barrier after it (no CTA exits while a neighbour may
//    still store into it).  Every thread of every CTA arrives at every
//    barrier, so a CTA of padding cannot deadlock the cluster.
//  * Co-scheduling: a cluster of 16 CTAs needs the non-portable cluster
//    size and free SMs in one GPC; the wrapper asks
//    cudaOccupancyMaxActiveClusters for the size it picks and walks down to
//    a smaller one (never below what the pair needs) or raises.
//  * No 16-byte copies: (B, K, S) rows are not 16-byte aligned at odd S, so
//    the input rows of the next diagonals are in flight in a register ring,
//    as in the strip kernels.  The arrive's release (and, with one CTA a
//    pair, the named barrier) waits until the thread's earlier loads are
//    performed, so the reverse passes and the adjoint forward (rings of
//    2) issue row r-D (r+D) right after the arrive of row r, a whole
//    diagonal before the next arrive, not among the cells: 19-22% faster
//    at the long shapes.  The forward keeps its loads in the cells, where
//    the max3 chain hides them (after the arrive it was 8-12% slower at
//    the long shapes; PERF.md).
// A pair holds S <= 32,768 slots: 16 CTAs of 1,024 threads of strips of
// 2 (ops/dp_cuda.py CLUSTER_SLOTS).
constexpr int Q_STRIP = 2, Q_EDGE_RING = 3;
// Input rows in flight (the register ring): the forward 2 (its two input
// rows a diagonal; a ring of 4 spilled and was 6% slower at the bench
// shape), the adjoint backward (seven a diagonal) 2 in a cluster, 1 with
// one CTA a pair (64 registers and spills at 2, and 27% slower at the
// bench shape; in clusters 2 is 2% faster; PERF.md).
constexpr int Q_FWD_RING = 2;
// backward_q (three input rows a diagonal) and adjoint_forward_q (four,
// five with Za): 2 (a ring of 1 was 1-19% slower; PERF.md).
constexpr int Q_BWD_RING = 2, Q_AFWD_RING = 2;
__host__ __device__ constexpr int q_abwd_ring(bool cluster) {
  return cluster ? 2 : 1;
}

// Cluster primitives (PTX, sm_90).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// the shared::cluster address of `p`, a shared variable of this CTA, in
// the CTA of rank `rank`
__device__ __forceinline__ uint32_t cluster_map(const void *p, int rank) {
  uint32_t out, a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(a), "r"(rank));
  return out;
}
__device__ __forceinline__ void cluster_store(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v)
               : "memory");
}
// The split Q kernels' wait: the cluster barrier's, or, one CTA a pair, the
// block's named barrier (whose arrive is part of it).
template <bool kCluster>
__device__ __forceinline__ void q_wait() {
  if (kCluster)
    cluster_wait();
  else
    pair_barrier();
}
template <bool kCluster>
__device__ __forceinline__ void q_arrive() {
  if (kCluster) cluster_arrive();
}

// Forward, diagonals ascending: the direct form of _fwd_kernel
// (dp_pallas.py:197-217), (val, Q) = max3(A + shr(V[r-1]), shr(V[r-2]),
// A + V[r-1]), V[r] = theta + val masked.  Registers: V rows r-1 and r-2 of
// the strip (v1, v2) and, at its left edge, slot s0-1 of both (l1, l2).
// Q is written at every slot (dp_pallas.py MASK_Q = False, :68, :208):
// the reverse passes multiply Q by E and Ed wherever those are non-zero,
// and off-band slots next to the band see non-zero V neighbours, so Q
// there is no function of A alone -- the strip kernels' "smoothed max on
// the band only" does not carry over, and every slot of every diagonal
// runs max3 (the gain comes from the SMs the split puts to work, the rows
// in registers and the lighter barrier).  A is loaded at every slot,
// theta only where the cell is valid (V is masked there), D rows ahead.
template <int OP, bool kCluster, typename TQ>
__global__ void __launch_bounds__(1024)
    forward_q_kernel(const float *__restrict__ th,
                     const float *__restrict__ ad,
                     const int *__restrict__ ln, const int *__restrict__ lm,
                     int K, int S, int lo, int C, float *__restrict__ vt,
                     TQ *__restrict__ qxo, TQ *__restrict__ qmo,
                     TQ *__restrict__ qyo) {
  // slot 0 of a strip waits for the barrier, the others do not
  constexpr int T = Q_STRIP, D = Q_FWD_RING, R = Q_EDGE_RING;
  __shared__ float edge[R][32];  // lane 31 of warp w, for warp w+1
  __shared__ float xedge[R];     // the left CTA's last slot, stored by it
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x % C, b = blockIdx.x / C;
  const int s0 = (c * (int)blockDim.x + (int)threadIdx.x) * T;
  const bool last = threadIdx.x + 1 == blockDim.x;
  const int n = ln[b], m = lm[b];
  const size_t base = (size_t)b * K * S;
  const uint32_t right =
      kCluster && c + 1 < C ? cluster_map(&xedge[0], c + 1) : 0u;
  float v1[T], v2[T], l1 = 0.0f, l2 = 0.0f, up = 0.0f;
  float pa[D][T], pt[D][T];
#pragma unroll
  for (int i = 0; i < T; ++i) v1[i] = v2[i] = 0.0f;

  // issue the loads of slot s0+i of row q into ring slot d
  auto fetch = [&](int d, int q, int i) {
    const int s = s0 + i;
    const size_t at = base + (size_t)q * S + s;
    pa[d][i] = q < K && s < S ? ad[at] : 0.0f;
    pt[d][i] = q < K && cell_valid(s, q + 2, n, m, lo) ? th[at] : 0.0f;
  };
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int i = 0; i < T; ++i) fetch(d, d, i);
  if (kCluster) {
    cluster_arrive();
    cluster_wait();
  }

  for (int r0 = 0; r0 < K; r0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int r = r0 + d;
      if (r >= K) break;
      const int k = r + 2;
      const size_t row = base + (size_t)r * S;
      float vn[T];
      // slot s0+i of row r, its left neighbours V[r-1], V[r-2] at s0+i-1
      auto cell = [&](int i, float v1l, float v2l) {
        const int s = s0 + i;
        const float a = pa[d][i], t = pt[d][i];
        fetch(d, r + D, i);
        float px, pm, py;
        const float val = max3<OP>(a + v1l, v2l, a + v1[i], px, pm, py);
        if (s < S) {
          st(qxo, row + s, px, 0.0f);
          st(qmo, row + s, pm, 0.0f);
          st(qyo, row + s, py, 0.0f);
        }
        const float v = cell_valid(s, k, n, m, lo) ? t + val : 0.0f;
        if (s == n && k == n + m) vt[b] = v;
        vn[i] = v;
      };
#pragma unroll
      for (int i = T - 1; i >= 1; --i) cell(i, v1[i - 1], v2[i - 1]);
      // V[r][s0+T-1] to the right: by shuffle, to the next warp, to the
      // next CTA
      const float nup = __shfl_up_sync(0xffffffffu, vn[T - 1], 1);
      if (lane == 31) edge[r % R][warp] = vn[T - 1];
      if (kCluster && last && c + 1 < C)
        cluster_store(right + (uint32_t)(r % R) * 4u, vn[T - 1]);
      if (r > 0) {
        q_wait<kCluster>();
        // V[r-1][s0-1]
        l1 = lane ? up
                  : (warp ? edge[(r - 1) % R][warp - 1]
                          : (kCluster && c ? xedge[(r - 1) % R] : 0.0f));
      }
      cell(0, l1, l2);
      q_arrive<kCluster>();
      up = nup;
      l2 = l1;
#pragma unroll
      for (int i = 0; i < T; ++i) {
        v2[i] = v1[i];
        v1[i] = vn[i];
      }
    }
  }
  if (kCluster) cluster_wait();
}

// Backward, rows descending: _bwd_kernel's order (dp_pallas.py:301-318)
// with _backward_v2's gap product EA[r] = E[r] (Qx[r] + Qy[r])
// (:595-600) under kWantGap, split across the cluster like the adjoint
// backward, whose dependence runs the same way.  It reads Q and
// recomputes nothing.  The first version kept three rows of E in shared
// memory and read each Q row up to five times (Qx and Qy as rows r+1 and
// r, Qm as row r+2, EA's Qx and Qy as row r); here each Q element is read
// once, at its own row, D rows ahead, and the products of the rows before
// that the plain version sums are carried in registers:
//   E[r] = (shl(X[r+1]) + shl(M[r+2])) + Y[r+1]
// with X = Qx E, M = Qm E and Y = Qy E (x1, m1, m2, y1), masked to the
// band, then + Et at the terminal, and at the strip's right edge slot
// s0+T of X[r+1] and M[r+2] (rx, rmb) from the right lane by shuffle, the
// right warp through `edge`, or the right CTA, which stores them into
// `xedge`.  E is zero off the band but at the terminal (in sw with n = 1
// or m = 1 the terminal lies off the band), so Q is loaded on the band
// ahead of the chain and off it only where E is non-zero, on the spot;
// where E is zero the kernel stores EA = 0 and carries zero products
// without reading Q (the plain version forms 0 x Q, a zero that may be
// -0.0, which compares equal: torch.equal, chip_smoke._exact).
template <bool kWantGap, bool kCluster, typename TQ>
__global__ void __launch_bounds__(1024)
    backward_q_kernel(const TQ *__restrict__ qx,
                      const TQ *__restrict__ qm,
                      const TQ *__restrict__ qy,
                      const int *__restrict__ ln, const int *__restrict__ lm,
                      const float *__restrict__ et, int K, int S, int lo,
                      int C, float *__restrict__ eo,
                      float *__restrict__ eao) {
  // the last slot of a strip waits for the barrier, the others do not
  constexpr int T = Q_STRIP, D = Q_BWD_RING, R = Q_EDGE_RING;
  __shared__ float edge[R][2][32];  // X, M of lane 0 of warp w, for w-1
  __shared__ float xedge[R][2];     // the right CTA's first slot, stored by it
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int c = blockIdx.x % C, b = blockIdx.x / C;
  const int s0 = (c * (int)blockDim.x + (int)threadIdx.x) * T;
  const int n = ln[b], m = lm[b];
  const float e_t = et[b];
  const size_t base = (size_t)b * K * S;
  const uint32_t left =
      kCluster && c > 0 ? cluster_map(&xedge[0][0], c - 1) : 0u;
  float x1[T], m1[T], m2[T], y1[T];
  float rx = 0.0f, rma = 0.0f, rmb = 0.0f, dx = 0.0f, dm = 0.0f;
  TQ px_[D][T], pm_[D][T], py_[D][T];
#pragma unroll
  for (int i = 0; i < T; ++i) x1[i] = m1[i] = m2[i] = y1[i] = 0.0f;

  // issue the loads of slot s0+i of row q into ring slot d: Q on the band,
  // as stored (widened where the cell reads it)
  auto fetch = [&](int d, int q, int i) {
    const int s = s0 + i;
    const bool band = q >= 0 && in_band(s, q + 2, n, m, lo);
    const size_t at = base + (size_t)q * S + s;
    px_[d][i] = band ? qx[at] : zero_of<TQ>();
    pm_[d][i] = band ? qm[at] : zero_of<TQ>();
    py_[d][i] = band ? qy[at] : zero_of<TQ>();
  };
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int i = 0; i < T; ++i) fetch(d, K - 1 - d, i);
  if (kCluster) {
    cluster_arrive();
    cluster_wait();
  }

  for (int r0 = K - 1; r0 >= 0; r0 -= D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int r = r0 - d;
      if (r < 0) break;
      const int k = r + 2;
      const size_t row = base + (size_t)r * S;
      float xn[T], mn[T];
      // slot s0+i of row r, its right neighbours X[r+1], M[r+2] at s0+i+1
      auto cell = [&](int i, float xr, float mr) {
        const int s = s0 + i;
        float ax = cvt(px_[d][i], 0.0f), am = cvt(pm_[d][i], 0.0f),
              ay = cvt(py_[d][i], 0.0f);
        const bool band = in_band(s, k, n, m, lo);
        float e = band ? (xr + mr) + y1[i] : 0.0f;
        if (s == n && k == n + m) e = e + e_t;
        float x = 0.0f, mm = 0.0f, y = 0.0f, ea = 0.0f;
        if (e != 0.0f) {
          if (!band) {
            const size_t at = row + s;
            ax = ld(qx, at, 0.0f);
            am = ld(qm, at, 0.0f);
            ay = ld(qy, at, 0.0f);
          }
          x = ax * e;
          mm = am * e;
          y = ay * e;
          if (kWantGap) ea = e * (ax + ay);
        }
        if (s < S) {
          eo[row + s] = e;
          if (kWantGap) eao[row + s] = ea;
        }
        xn[i] = x;
        mn[i] = mm;
        y1[i] = y;
      };
#pragma unroll
      for (int i = 0; i + 1 < T; ++i) cell(i, x1[i + 1], m2[i + 1]);
      // X[r], M[r] at s0 to the left: by shuffle, to the previous warp, to
      // the previous CTA
      const float ndx = __shfl_down_sync(0xffffffffu, xn[0], 1);
      const float ndm = __shfl_down_sync(0xffffffffu, mn[0], 1);
      if (lane == 0) {
        edge[r % R][0][warp] = xn[0];
        edge[r % R][1][warp] = mn[0];
      }
      if (kCluster && threadIdx.x == 0 && c > 0) {
        cluster_store(left + (uint32_t)(r % R) * 8u, xn[0]);
        cluster_store(left + (uint32_t)(r % R) * 8u + 4u, mn[0]);
      }
      rmb = rma;  // M[r+2] at s0+T
      if (r + 1 < K) {
        q_wait<kCluster>();
        // X[r+1], M[r+1] at s0+T (0 past the last slot)
        if (lane < 31) {
          rx = dx;
          rma = dm;
        } else if (warp + 1 < nwarps) {
          rx = edge[(r + 1) % R][0][warp + 1];
          rma = edge[(r + 1) % R][1][warp + 1];
        } else {
          const bool next = kCluster && c + 1 < C;
          rx = next ? xedge[(r + 1) % R][0] : 0.0f;
          rma = next ? xedge[(r + 1) % R][1] : 0.0f;
        }
      }
      cell(T - 1, rx, rmb);
      q_arrive<kCluster>();
      // row r-D into the ring slot row r has read: after the arrive, whose
      // release waits for the thread's loads in flight
#pragma unroll
      for (int i = 0; i < T; ++i) fetch(d, r - D, i);
      dx = ndx;
      dm = ndm;
#pragma unroll
      for (int i = 0; i < T; ++i) {
        x1[i] = xn[i];
        m2[i] = m1[i];
        m1[i] = mn[i];
      }
    }
  }
  if (kCluster) cluster_wait();
}

// Tangent of the Q forward, diagonals ascending: _adj_fwd_kernel's order
// (dp_pallas.py:392-417), xd = Za + shr(Vd[r-1]), md = shr(Vd[r-2]),
// yd = Za + Vd[r-1], Vd[r] = ((Zt + Qx xd) + Qm md) + Qy yd masked,
// Qd = hessian3(Q, (xd, md, yd)), split across the cluster like the
// forward, whose tangent it is.  Without kHasZa there is no Za stream (a
// zero gap cotangent; 0 + x = x, so it equals the TPU's zeros stream).
// Registers: Vd rows r-1 and r-2 of the strip (v1, v2) and, at its left
// edge, slot s0-1 of both (l1, l2; Vd[r-2] at s0-1 is the diagonal
// before's l1).  The first version kept three rows of Vd in shared memory
// behind one __syncthreads() a diagonal, one CTA a pair.  Qd is written at
// every slot (MASK_Q = False, dp_pallas.py:68): off the band, slots next to
// it see non-zero Vd neighbours and Za, so as in the forward there is no
// band shortcut; Q and Za are loaded at every slot, Zt only where the cell
// is valid (Vd is masked there), D rows ahead.  The dependent chain of a
// diagonal is Vd's three products and sums; hessian3 hangs off it.
template <int OP, bool kHasZa, bool kCluster, typename TQ>
__global__ void __launch_bounds__(1024)
    adjoint_forward_q_kernel(const TQ *__restrict__ qx,
                             const TQ *__restrict__ qm,
                             const TQ *__restrict__ qy,
                             const float *__restrict__ zt,
                             const float *__restrict__ za,
                             const int *__restrict__ ln,
                             const int *__restrict__ lm, int K, int S,
                             int lo, int C, float *__restrict__ vtd,
                             float *__restrict__ qdxo,
                             float *__restrict__ qdmo,
                             float *__restrict__ qdyo) {
  // slot 0 of a strip waits for the barrier, the others do not
  constexpr int T = Q_STRIP, D = Q_AFWD_RING, R = Q_EDGE_RING;
  __shared__ float edge[R][32];  // lane 31 of warp w, for warp w+1
  __shared__ float xedge[R];     // the left CTA's last slot, stored by it
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x % C, b = blockIdx.x / C;
  const int s0 = (c * (int)blockDim.x + (int)threadIdx.x) * T;
  const bool last = threadIdx.x + 1 == blockDim.x;
  const int n = ln[b], m = lm[b];
  const size_t base = (size_t)b * K * S;
  const uint32_t right =
      kCluster && c + 1 < C ? cluster_map(&xedge[0], c + 1) : 0u;
  float v1[T], v2[T], l1 = 0.0f, l2 = 0.0f, up = 0.0f;
  TQ px_[D][T], pm_[D][T], py_[D][T];
  float pz[D][T], pa[D][T];
#pragma unroll
  for (int i = 0; i < T; ++i) v1[i] = v2[i] = 0.0f;

  // issue the loads of slot s0+i of row q into ring slot d (Q as stored,
  // widened where the cell reads it)
  auto fetch = [&](int d, int q, int i) {
    const int s = s0 + i;
    const bool in = q < K && s < S;
    const size_t at = base + (size_t)q * S + s;
    px_[d][i] = in ? qx[at] : zero_of<TQ>();
    pm_[d][i] = in ? qm[at] : zero_of<TQ>();
    py_[d][i] = in ? qy[at] : zero_of<TQ>();
    if (kHasZa) pa[d][i] = in ? za[at] : 0.0f;
    pz[d][i] = q < K && cell_valid(s, q + 2, n, m, lo) ? zt[at] : 0.0f;
  };
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int i = 0; i < T; ++i) fetch(d, d, i);
  if (kCluster) {
    cluster_arrive();
    cluster_wait();
  }

  for (int r0 = 0; r0 < K; r0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int r = r0 + d;
      if (r >= K) break;
      const int k = r + 2;
      const size_t row = base + (size_t)r * S;
      float vn[T];
      // slot s0+i of row r, its left neighbours Vd[r-1], Vd[r-2] at s0+i-1
      auto cell = [&](int i, float v1l, float v2l) {
        const int s = s0 + i;
        const float px = cvt(px_[d][i], 0.0f), pm = cvt(pm_[d][i], 0.0f),
                    py = cvt(py_[d][i], 0.0f);
        const float z = pz[d][i], a = kHasZa ? pa[d][i] : 0.0f;
        float xd = v1l, yd = v1[i];
        if (kHasZa) {
          xd = a + v1l;
          yd = a + v1[i];
        }
        const float md = v2l;
        float v = z + px * xd + pm * md + py * yd;
        float hx, hm, hy;
        hessian3<OP>(px, pm, py, xd, md, yd, hx, hm, hy);
        if (s < S) {
          qdxo[row + s] = hx;
          qdmo[row + s] = hm;
          qdyo[row + s] = hy;
        }
        v = cell_valid(s, k, n, m, lo) ? v : 0.0f;
        if (s == n && k == n + m) vtd[b] = v;
        vn[i] = v;
      };
#pragma unroll
      for (int i = T - 1; i >= 1; --i) cell(i, v1[i - 1], v2[i - 1]);
      // Vd[r][s0+T-1] to the right: by shuffle, to the next warp, to the
      // next CTA
      const float nup = __shfl_up_sync(0xffffffffu, vn[T - 1], 1);
      if (lane == 31) edge[r % R][warp] = vn[T - 1];
      if (kCluster && last && c + 1 < C)
        cluster_store(right + (uint32_t)(r % R) * 4u, vn[T - 1]);
      if (r > 0) {
        q_wait<kCluster>();
        // Vd[r-1][s0-1]
        l1 = lane ? up
                  : (warp ? edge[(r - 1) % R][warp - 1]
                          : (kCluster && c ? xedge[(r - 1) % R] : 0.0f));
      }
      cell(0, l1, l2);
      q_arrive<kCluster>();
      // row r+D into the ring slot row r has read: after the arrive, whose
      // release waits for the thread's loads in flight
#pragma unroll
      for (int i = 0; i < T; ++i) fetch(d, r + D, i);
      up = nup;
      l2 = l1;
#pragma unroll
      for (int i = 0; i < T; ++i) {
        v2[i] = v1[i];
        v1[i] = vn[i];
      }
    }
  }
  if (kCluster) cluster_wait();
}

// Tangent of the Q backward, rows descending: _adj_bwd_kernel's order
// (dp_pallas.py:510-533) and _adjoint_backward_v2's fused
// EdA = Ed (Qx + Qy) + E (Qdx + Qdy) (:603-609), split across the cluster
// like the forward.  It reads Q and Qd and recomputes nothing.  The first
// version kept three rows of Ed and three of the given E in shared memory
// and read each Q/Qd row up to three times (as row r, r+1 and r+2); here
// E, Q and Qd are each read once, D rows ahead, and the products of rows
// r+1 and r+2 that the plain version sums are carried in registers:
//   Ed[r] = shl(X[r+1]) + shl(M[r+2]) + Yd[r+1] + Yq[r+1]
// with X = Qdx E + Qx Ed, M = Qdm E + Qm Ed, Yd = Qdy E and Yq = Qy Ed
// (x1, m1, m2, yd1, yq1; Yd and Yq stay two values, as the plain sum
// rounds them apart), and at the strip's right edge slot s0+T of X[r+1]
// and M[r+2] (rx, rmb), from the right lane by shuffle, the right warp
// through `edge`, or the right CTA, which stores them into `xedge`.  Ed
// is masked to the band; E may be non-zero anywhere (the terminal slot
// of sw with n = 1 or m = 1 lies off the band, and a caller may pass any
// E), so EdA is kept at every slot and the products wherever E or Ed is
// non-zero: E is loaded at every slot, Q and Qd on the band ahead of the
// chain and off it only where E is non-zero, on the spot.  Where both are
// zero the kernel stores EdA = 0 and carries zero products without
// reading Q or Qd; the plain version forms 0 * (Qx + Qy) + 0 * (Qdx +
// Qdy), a zero that may be -0.0, which compares equal (torch.equal,
// chip_smoke._exact).  Every row is walked: E may be non-zero past the
// terminal diagonal.
template <bool kCluster, typename TQ>
__global__ void __launch_bounds__(1024)
    adjoint_backward_q_kernel(const TQ *__restrict__ qx,
                              const TQ *__restrict__ qm,
                              const TQ *__restrict__ qy,
                              const float *__restrict__ qdx,
                              const float *__restrict__ qdm,
                              const float *__restrict__ qdy,
                              const float *__restrict__ E,
                              const int *__restrict__ ln,
                              const int *__restrict__ lm, int K, int S,
                              int lo, int C, float *__restrict__ edo,
                              float *__restrict__ edao) {
  // the last slot of a strip waits for the barrier, the others do not
  constexpr int T = Q_STRIP, D = q_abwd_ring(kCluster), R = Q_EDGE_RING;
  // the ring's loads after the arrive (a ring of one: in the cells, so
  // that row r-1's are in flight while row r waits)
  constexpr bool kLateLoads = D > 1;
  __shared__ float edge[R][2][32];  // X, M of lane 0 of warp w, for w-1
  __shared__ float xedge[R][2];     // the right CTA's first slot, stored by it
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int c = blockIdx.x % C, b = blockIdx.x / C;
  const int s0 = (c * (int)blockDim.x + (int)threadIdx.x) * T;
  const int n = ln[b], m = lm[b];
  const size_t base = (size_t)b * K * S;
  const uint32_t left =
      kCluster && c > 0 ? cluster_map(&xedge[0][0], c - 1) : 0u;
  float x1[T], m1[T], m2[T], yd1[T], yq1[T];
  float rx = 0.0f, rma = 0.0f, rmb = 0.0f, dx = 0.0f, dm = 0.0f;
  float pe[D][T], hx_[D][T], hm_[D][T], hy_[D][T];
  TQ px_[D][T], pm_[D][T], py_[D][T];
#pragma unroll
  for (int i = 0; i < T; ++i) x1[i] = m1[i] = m2[i] = yd1[i] = yq1[i] = 0.0f;

  // issue the loads of slot s0+i of row q into ring slot d: E at every
  // slot, Q (as stored, widened where the cell reads it) and Qd on the band
  auto fetch = [&](int d, int q, int i) {
    const int s = s0 + i;
    const bool band = q >= 0 && in_band(s, q + 2, n, m, lo);
    const size_t at = base + (size_t)q * S + s;
    pe[d][i] = q >= 0 && s < S ? E[at] : 0.0f;
    px_[d][i] = band ? qx[at] : zero_of<TQ>();
    pm_[d][i] = band ? qm[at] : zero_of<TQ>();
    py_[d][i] = band ? qy[at] : zero_of<TQ>();
    hx_[d][i] = band ? qdx[at] : 0.0f;
    hm_[d][i] = band ? qdm[at] : 0.0f;
    hy_[d][i] = band ? qdy[at] : 0.0f;
  };
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int i = 0; i < T; ++i) fetch(d, K - 1 - d, i);
  if (kCluster) {
    cluster_arrive();
    cluster_wait();
  }

  for (int r0 = K - 1; r0 >= 0; r0 -= D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int r = r0 - d;
      if (r < 0) break;
      const int k = r + 2;
      const size_t row = base + (size_t)r * S;
      float xn[T], mn[T];
      // slot s0+i of row r, its right neighbours X[r+1], M[r+2] at s0+i+1
      auto cell = [&](int i, float xr, float mr) {
        const int s = s0 + i;
        const float e = pe[d][i];
        float ax = cvt(px_[d][i], 0.0f), am = cvt(pm_[d][i], 0.0f),
              ay = cvt(py_[d][i], 0.0f);
        float hx = hx_[d][i], hm = hm_[d][i], hy = hy_[d][i];
        if (!kLateLoads) fetch(d, r - D, i);
        const bool band = in_band(s, k, n, m, lo);
        const float ed = band ? xr + mr + yd1[i] + yq1[i] : 0.0f;
        float x = 0.0f, mm = 0.0f, yd = 0.0f, yq = 0.0f, eda = 0.0f;
        if (band || e != 0.0f) {
          if (!band) {
            const size_t at = row + s;
            ax = ld(qx, at, 0.0f);
            am = ld(qm, at, 0.0f);
            ay = ld(qy, at, 0.0f);
            hx = qdx[at];
            hm = qdm[at];
            hy = qdy[at];
          }
          x = hx * e + ax * ed;
          mm = hm * e + am * ed;
          yd = hy * e;
          yq = ay * ed;
          eda = ed * (ax + ay) + e * (hx + hy);
        }
        if (s < S) {
          edo[row + s] = ed;
          edao[row + s] = eda;
        }
        xn[i] = x;
        mn[i] = mm;
        yd1[i] = yd;
        yq1[i] = yq;
      };
#pragma unroll
      for (int i = 0; i + 1 < T; ++i) cell(i, x1[i + 1], m2[i + 1]);
      // X[r], M[r] at s0 to the left: by shuffle, to the previous warp, to
      // the previous CTA
      const float ndx = __shfl_down_sync(0xffffffffu, xn[0], 1);
      const float ndm = __shfl_down_sync(0xffffffffu, mn[0], 1);
      if (lane == 0) {
        edge[r % R][0][warp] = xn[0];
        edge[r % R][1][warp] = mn[0];
      }
      if (kCluster && threadIdx.x == 0 && c > 0) {
        cluster_store(left + (uint32_t)(r % R) * 8u, xn[0]);
        cluster_store(left + (uint32_t)(r % R) * 8u + 4u, mn[0]);
      }
      rmb = rma;  // M[r+2] at s0+T
      if (r + 1 < K) {
        q_wait<kCluster>();
        // X[r+1], M[r+1] at s0+T (0 past the last slot)
        if (lane < 31) {
          rx = dx;
          rma = dm;
        } else if (warp + 1 < nwarps) {
          rx = edge[(r + 1) % R][0][warp + 1];
          rma = edge[(r + 1) % R][1][warp + 1];
        } else {
          const bool next = kCluster && c + 1 < C;
          rx = next ? xedge[(r + 1) % R][0] : 0.0f;
          rma = next ? xedge[(r + 1) % R][1] : 0.0f;
        }
      }
      cell(T - 1, rx, rmb);
      q_arrive<kCluster>();
      if (kLateLoads) {
#pragma unroll
        for (int i = 0; i < T; ++i) fetch(d, r - D, i);
      }
      dx = ndx;
      dm = ndm;
#pragma unroll
      for (int i = 0; i < T; ++i) {
        x1[i] = xn[i];
        m2[i] = m1[i];
        m1[i] = mn[i];
      }
    }
  }
  if (kCluster) cluster_wait();
}

// One CTA per pair of ceil(S / T) threads, rounded up to whole warps.  The
// narrowest strip that fits runs: at the bench shape (S = 513) strips of 2
// (9 warps a pair) beat 4 and 8 (5 and 3 warps) by 1.3-3x (PERF.md, PR 5),
// since the kernels are issue-bound and a wider strip serialises more
// cells on one warp and idles more lanes at the band's ragged edges.
template <typename Kern, typename... A>
cudaError_t launch_strip(Kern kern, int T, int B, int S, cudaStream_t st,
                         A... args) {
  int threads = ((S + T - 1) / T + 31) / 32 * 32;
  kern<<<B, threads, 0, st>>>(args...);
  return cudaGetLastError();
}

// Threads a CTA of the split Q kernels: the pair's S slots over C CTAs of
// strips of Q_STRIP, rounded up to whole warps (ops/dp_cuda.py
// _q_threads).
int q_threads(int S, int C) {
  const int per = C * Q_STRIP * 32;
  return (S + per - 1) / per * 32;
}

// The split Q kernels' launch: B clusters of C CTAs, one cluster a pair
// (consecutive blockIdx.x, so CTA c of pair b is b C + c and its rank in
// the cluster is c), through cudaLaunchKernelEx with a cluster dimension
// attribute; C > 8 needs the non-portable cluster size.  C = 1 launches
// the kCluster = false instance without the attribute.
template <typename... P>
cudaLaunchConfig_t q_config(void (*kern)(P...), int C, int B, int S,
                            cudaStream_t st, cudaLaunchAttribute *attr,
                            cudaError_t *err) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)C);
  cfg.blockDim = dim3((unsigned)q_threads(S, C));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  *err = C > 8 ? cudaFuncSetAttribute(
                     kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)
               : cudaSuccess;
  return cfg;
}

template <typename... P, typename... A>
cudaError_t launch_cluster(void (*kern)(P...), int C, int B, int S,
                           cudaStream_t st, A... args) {
  cudaLaunchAttribute attr[1];
  cudaError_t err;
  cudaLaunchConfig_t cfg = q_config(kern, C, B, S, st, attr, &err);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of C CTAs of `kern` the device can hold at once (the
// blocks a multiprocessor holds x the multiprocessors, for C = 1); 0 means
// a launch of that size would fail.  A negative value is a CUDA error.
template <typename... P>
int max_clusters(void (*kern)(P...), int C, int S) {
  cudaLaunchAttribute attr[1];
  cudaError_t err;
  cudaLaunchConfig_t cfg = q_config(kern, C, 1, S, 0, attr, &err);
  int n = 0;
  if (err == cudaSuccess) {
    if (C > 1) {
      err = cudaOccupancyMaxActiveClusters(&n, (const void *)kern, &cfg);
    } else {
      int dev = 0, sms = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kern, (int)cfg.blockDim.x, 0);
      if (err == cudaSuccess) err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      n *= sms;
    }
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return n;
}

// CTAs of the skew: one per tile of each pair (0 when there is no slot)
unsigned skew_tiles(int B, int K, int S) {
  if (B <= 0 || K <= 0 || S <= 0) return 0;
  return (unsigned)B * ((K + SKEW_R - 1) / SKEW_R) *
         ((S + SKEW_C - 1) / SKEW_C);
}

// CTAs of the unskew: one per natural tile of each pair (0 when there is
// no cell)
unsigned unskew_tiles(int B, int N, int M) {
  if (B <= 0 || N <= 0 || M <= 0) return 0;
  return (unsigned)B * ((N + UNSKEW_ROWS - 1) / UNSKEW_ROWS) *
         ((M + UNSKEW_COLS - 1) / UNSKEW_COLS);
}

}  // namespace

// The entries switch over the operator and the storage codes, one case
// per template instance, and return cudaErrorInvalidValue for a code they
// do not take.  Each case body is a statement that returns.
#define DP_SWITCH_OP(...)                          \
  switch (op) {                                    \
    case OP_SOFTMAX: {                             \
      constexpr int OP = OP_SOFTMAX;               \
      __VA_ARGS__;                                 \
    }                                              \
    case OP_SPARSEMAX: {                           \
      constexpr int OP = OP_SPARSEMAX;             \
      __VA_ARGS__;                                 \
    }                                              \
    case OP_HARDMAX: {                             \
      constexpr int OP = OP_HARDMAX;               \
      __VA_ARGS__;                                 \
    }                                              \
    default:                                       \
      return (int)cudaErrorInvalidValue;           \
  }

// float, bf16 or int16 storage
#define DP_SWITCH_ANY(code, T, ...)                \
  switch (code) {                                  \
    case DT_F32: {                                 \
      typedef float T;                             \
      __VA_ARGS__;                                 \
    }                                              \
    case DT_BF16: {                                \
      typedef bf16 T;                              \
      __VA_ARGS__;                                 \
    }                                              \
    case DT_I16: {                                 \
      typedef int16_t T;                           \
      __VA_ARGS__;                                 \
    }                                              \
    default:                                       \
      return (int)cudaErrorInvalidValue;           \
  }

// float or bf16 storage
#define DP_SWITCH_FLOAT(code, T, ...)              \
  switch (code) {                                  \
    case DT_F32: {                                 \
      typedef float T;                             \
      __VA_ARGS__;                                 \
    }                                              \
    case DT_BF16: {                                \
      typedef bf16 T;                              \
      __VA_ARGS__;                                 \
    }                                              \
    default:                                       \
      return (int)cudaErrorInvalidValue;           \
  }

// The strip width T for S slots: the narrowest of the kernel's widths
// with T x 1,024 >= S; wider pairs return cudaErrorInvalidValue.
#define DP_STRIP_CASE(S, W, T, ...)                \
  if ((S) <= 1024 * (W)) {                         \
    constexpr int T = (W);                         \
    __VA_ARGS__;                                   \
  }
#define DP_SWITCH_FORWARD_STRIP(S, T, ...)         \
  DP_STRIP_CASE(S, 2, T, __VA_ARGS__)              \
  DP_STRIP_CASE(S, 6, T, __VA_ARGS__)              \
  DP_STRIP_CASE(S, 20, T, __VA_ARGS__)             \
  return (int)cudaErrorInvalidValue;
#define DP_SWITCH_BACKWARD_STRIP(S, T, ...)        \
  DP_STRIP_CASE(S, 2, T, __VA_ARGS__)              \
  DP_STRIP_CASE(S, 6, T, __VA_ARGS__)              \
  return (int)cudaErrorInvalidValue;

// The split Q kernels' instance for cluster size C: KCL, a cluster launch,
// for C > 1; C is 1..16.
#define DP_SWITCH_Q_CLUSTER(C, KCL, ...)           \
  if ((C) < 1 || (C) > 16)                         \
    return (int)cudaErrorInvalidValue;             \
  if ((C) == 1) {                                  \
    constexpr bool KCL = false;                    \
    __VA_ARGS__;                                   \
  } else {                                         \
    constexpr bool KCL = true;                     \
    __VA_ARGS__;                                   \
  }

// DP_PART selects the entries of one object when the library is built by
// several nvcc processes at once (ops/dp_cuda.py build): 1 the forward, 2
// the backward, 3 the adjoint backward, 4 the adjoint forward, 5 the split
// Q forward and adjoint backward, 6 the split Q backward and adjoint
// forward, 0 the rest; without it every entry is compiled.
#ifndef DP_PART
#define DP_PART_IS(p) 1
#else
#define DP_PART_IS(p) (DP_PART == (p))
#endif

extern "C" {

#if DP_PART_IS(0)
// x float; out of storage out_dt (int16: quantized at `scale`).
int dp_skew(const float *x, int B, int N, int M, void *out, int out_dt,
            float scale, void *stream) {
  int K = N + M - 1, S = N + 1;
  unsigned blocks = skew_tiles(B, K, S);
  if (!blocks) return (int)cudaSuccess;
  DP_SWITCH_ANY(out_dt, TO,
                skew_kernel<TO><<<blocks, SKEW_THREADS, 0,
                                  (cudaStream_t)stream>>>(
                    x, N, M, K, S, (TO *)out, scale);
                return (int)cudaGetLastError())
}

// Both skews of a pair in one launch: grid (tiles, 2).
int dp_skew_pair(const float *x, const float *y, int B, int N, int M,
                 void *ox, void *oy, int out_dt, float scale, void *stream) {
  int K = N + M - 1, S = N + 1;
  unsigned blocks = skew_tiles(B, K, S);
  if (!blocks) return (int)cudaSuccess;
  dim3 grid(blocks, 2);
  DP_SWITCH_ANY(out_dt, TO,
                skew_pair_kernel<TO><<<grid, SKEW_THREADS, 0,
                                       (cudaStream_t)stream>>>(
                    x, y, N, M, K, S, (TO *)ox, (TO *)oy, scale);
                return (int)cudaGetLastError())
}

// s of storage s_dt (int16: dequantized by `inv`); out float.
int dp_unskew(const void *s, int s_dt, float inv, int B, int K, int S, int N,
              int M, float *out, void *stream) {
  unsigned blocks = unskew_tiles(B, N, M);
  if (!blocks) return (int)cudaSuccess;
  DP_SWITCH_ANY(s_dt, TI,
                unskew_kernel<TI><<<blocks, SKEW_THREADS, 0,
                                    (cudaStream_t)stream>>>(
                    (const TI *)s, N, M, K, S, inv, out);
                return (int)cudaGetLastError())
}

#endif

#if DP_PART_IS(1)
// Inputs of storage in_dt (int16: dequantized by `inv`); store == 0: the
// score-only forward (no residual stores), else Dx, Dm of storage d_dt.
int dp_forward(const void *th, const void *ad, int in_dt, float inv,
               const int *ln, const int *lm, int B, int K, int S, int lo,
               int op, int store, int d_dt, float *vt, void *dxo, void *dmo,
               void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!store) {
    DP_SWITCH_OP(DP_SWITCH_ANY(
        in_dt, TI,
        DP_SWITCH_FORWARD_STRIP(
            S, T,
            return (int)launch_strip(forward_kernel<OP, false, TI, float, T>,
                                     T, B, S, st, (const TI *)th,
                                     (const TI *)ad, inv, ln, lm, K, S, lo,
                                     vt, (float *)nullptr, (float *)nullptr))))
  }
  DP_SWITCH_OP(DP_SWITCH_ANY(
      in_dt, TI,
      DP_SWITCH_FLOAT(
          d_dt, TD,
          DP_SWITCH_FORWARD_STRIP(
              S, T,
              return (int)launch_strip(forward_kernel<OP, true, TI, TD, T>, T,
                                       B, S, st, (const TI *)th,
                                       (const TI *)ad, inv, ln, lm, K, S, lo,
                                       vt, (TD *)dxo, (TD *)dmo)))))
}

#endif

#if DP_PART_IS(2)
// Dx, Dm of storage d_dt; E (and EA unless eao == nullptr) of storage e_dt
// (int16: quantized at `escale`, the decode's E).
int dp_backward(const void *dx, const void *dm, int d_dt, const int *ln,
                const int *lm, const float *et, int B, int K, int S, int lo,
                int op, int e_dt, float escale, void *eo, void *eao,
                void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (eao) {
    DP_SWITCH_OP(DP_SWITCH_FLOAT(
        d_dt, TD,
        DP_SWITCH_ANY(
            e_dt, TE,
            DP_SWITCH_BACKWARD_STRIP(
                S, T,
                return (int)launch_strip(
                    backward_kernel<OP, true, TD, TE, T>, T, B, S, st,
                    (const TD *)dx, (const TD *)dm, ln, lm, et, K, S, lo,
                    escale, (TE *)eo, (TE *)eao)))))
  }
  DP_SWITCH_OP(DP_SWITCH_FLOAT(
      d_dt, TD,
      DP_SWITCH_ANY(
          e_dt, TE,
          DP_SWITCH_BACKWARD_STRIP(
              S, T,
              return (int)launch_strip(
                  backward_kernel<OP, false, TD, TE, T>, T, B, S, st,
                  (const TD *)dx, (const TD *)dm, ln, lm, et, K, S, lo,
                  escale, (TE *)eo, (TE *)nullptr)))))
}

#endif

#if DP_PART_IS(4)
// Dx, Dm (and Dxd, Dmd out) of storage d_dt, Zt and Za of storage z_dt;
// za == nullptr: no gap cotangent, the kernel without a Za stream.
int dp_adjoint_forward(const void *dx, const void *dm, int d_dt,
                       const void *zt, const void *za, int z_dt,
                       const int *ln, const int *lm, int B, int K, int S,
                       int lo, int op, float *vtd, void *dxdo, void *dmdo,
                       void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (za) {
    DP_SWITCH_OP(DP_SWITCH_FLOAT(
        d_dt, TD,
        DP_SWITCH_FLOAT(
            z_dt, TZ,
            DP_SWITCH_FORWARD_STRIP(
                S, T,
                return (int)launch_strip(
                    adjoint_forward_kernel<OP, true, TD, TZ, T>, T, B, S, st,
                    (const TD *)dx, (const TD *)dm, (const TZ *)zt,
                    (const TZ *)za, ln, lm, K, S, lo, vtd, (TD *)dxdo,
                    (TD *)dmdo)))))
  }
  DP_SWITCH_OP(DP_SWITCH_FLOAT(
      d_dt, TD,
      DP_SWITCH_FLOAT(
          z_dt, TZ,
          DP_SWITCH_FORWARD_STRIP(
              S, T,
              return (int)launch_strip(
                  adjoint_forward_kernel<OP, false, TD, TZ, T>, T, B, S, st,
                  (const TD *)dx, (const TD *)dm, (const TZ *)zt,
                  (const TZ *)nullptr, ln, lm, K, S, lo, vtd, (TD *)dxdo,
                  (TD *)dmdo)))))
}

#endif

#if DP_PART_IS(3)
// Dx, Dm, Dxd, Dmd of storage d_dt; E in and Ed, EdA out of storage e_dt.
int dp_adjoint_backward(const void *dx, const void *dm, const void *dxd,
                        const void *dmd, int d_dt, const void *E, int e_dt,
                        const int *ln, const int *lm, int B, int K, int S,
                        int lo, int op, void *edo, void *edao, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  DP_SWITCH_OP(DP_SWITCH_FLOAT(
      d_dt, TD,
      DP_SWITCH_FLOAT(
          e_dt, TE,
          DP_SWITCH_BACKWARD_STRIP(
              S, T,
              return (int)launch_strip(
                  adjoint_backward_kernel<OP, TD, TE, T>, T, B, S, st,
                  (const TD *)dx, (const TD *)dm, (const TD *)dxd,
                  (const TD *)dmd, (const TE *)E, ln, lm, K, S, lo,
                  (TE *)edo, (TE *)edao)))))
}

#endif

#if DP_PART_IS(5)
// The split Q kernels: B clusters of C CTAs (C in 1..16, chosen by
// ops/dp_cuda.py); the Q streams of storage q_dt (float or bf16, written by
// the forward, read by the others), every other stream float.  Part 5 the
// forward and the adjoint backward, part 6 the backward and the adjoint
// forward.
int dp_forward_q(const float *th, const float *ad, const int *ln,
                 const int *lm, int B, int K, int S, int lo, int op, int C,
                 int q_dt, float *vt, void *qxo, void *qmo, void *qyo,
                 void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || K <= 0) return (int)cudaSuccess;
  DP_SWITCH_OP(DP_SWITCH_FLOAT(
      q_dt, TQ,
      DP_SWITCH_Q_CLUSTER(
          C, KCL,
          return (int)launch_cluster(forward_q_kernel<OP, KCL, TQ>, C, B, S,
                                     st, th, ad, ln, lm, K, S, lo, C, vt,
                                     (TQ *)qxo, (TQ *)qmo, (TQ *)qyo))))
}

int dp_adjoint_backward_q(const void *qx, const void *qm, const void *qy,
                          int q_dt, const float *qdx, const float *qdm,
                          const float *qdy, const float *E, const int *ln,
                          const int *lm, int B, int K, int S, int lo, int C,
                          float *edo, float *edao, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || K <= 0) return (int)cudaSuccess;
  DP_SWITCH_FLOAT(
      q_dt, TQ,
      DP_SWITCH_Q_CLUSTER(
          C, KCL,
          return (int)launch_cluster(adjoint_backward_q_kernel<KCL, TQ>, C, B,
                                     S, st, (const TQ *)qx, (const TQ *)qm,
                                     (const TQ *)qy, qdx, qdm, qdy, E, ln, lm,
                                     K, S, lo, C, edo, edao)))
}

int dp_q_clusters_rev(int kernel, int op, int variant, int q_dt, int S,
                      int C);

// How many clusters of C CTAs the device holds at once for a pair of S
// slots: `kernel` 0 forward_q, 1 adjoint_backward_q, 2 backward_q (with the
// gap output if `variant`), 3 adjoint_forward_q (with a Za stream if
// `variant`), the instance of operator `op` and Q storage q_dt that
// launches.  0: a launch of that size would fail; negative: a CUDA error.
int dp_q_clusters(int kernel, int op, int variant, int q_dt, int S, int C) {
  switch (kernel) {
    case 0:
      DP_SWITCH_OP(DP_SWITCH_FLOAT(
          q_dt, TQ,
          DP_SWITCH_Q_CLUSTER(
              C, KCL,
              return max_clusters(forward_q_kernel<OP, KCL, TQ>, C, S))))
    case 1:
      DP_SWITCH_FLOAT(
          q_dt, TQ,
          DP_SWITCH_Q_CLUSTER(
              C, KCL,
              return max_clusters(adjoint_backward_q_kernel<KCL, TQ>, C, S)))
    case 2:
    case 3:
      return dp_q_clusters_rev(kernel, op, variant, q_dt, S, C);
    default:
      return -(int)cudaErrorInvalidValue;
  }
}

#endif

#if DP_PART_IS(6)
// eao == nullptr: E only; else also EA = E (Qx + Qy).
int dp_backward_q(const void *qx, const void *qm, const void *qy, int q_dt,
                  const int *ln, const int *lm, const float *et, int B, int K,
                  int S, int lo, int C, float *eo, float *eao,
                  void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || K <= 0) return (int)cudaSuccess;
  if (eao) {
    DP_SWITCH_FLOAT(
        q_dt, TQ,
        DP_SWITCH_Q_CLUSTER(
            C, KCL,
            return (int)launch_cluster(backward_q_kernel<true, KCL, TQ>, C, B,
                                       S, st, (const TQ *)qx, (const TQ *)qm,
                                       (const TQ *)qy, ln, lm, et, K, S, lo,
                                       C, eo, eao)))
  }
  DP_SWITCH_FLOAT(
      q_dt, TQ,
      DP_SWITCH_Q_CLUSTER(
          C, KCL,
          return (int)launch_cluster(backward_q_kernel<false, KCL, TQ>, C, B,
                                     S, st, (const TQ *)qx, (const TQ *)qm,
                                     (const TQ *)qy, ln, lm, et, K, S, lo, C,
                                     eo, (float *)nullptr)))
}

// za == nullptr: no gap cotangent, the kernel without a Za stream.
int dp_adjoint_forward_q(const void *qx, const void *qm, const void *qy,
                         int q_dt, const float *zt, const float *za,
                         const int *ln, const int *lm, int B, int K, int S,
                         int lo, int op, int C, float *vtd, float *qdxo,
                         float *qdmo, float *qdyo, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || K <= 0) return (int)cudaSuccess;
  if (za) {
    DP_SWITCH_OP(DP_SWITCH_FLOAT(
        q_dt, TQ,
        DP_SWITCH_Q_CLUSTER(
            C, KCL,
            return (int)launch_cluster(
                adjoint_forward_q_kernel<OP, true, KCL, TQ>, C, B, S, st,
                (const TQ *)qx, (const TQ *)qm, (const TQ *)qy, zt, za, ln,
                lm, K, S, lo, C, vtd, qdxo, qdmo, qdyo))))
  }
  DP_SWITCH_OP(DP_SWITCH_FLOAT(
      q_dt, TQ,
      DP_SWITCH_Q_CLUSTER(
          C, KCL,
          return (int)launch_cluster(
              adjoint_forward_q_kernel<OP, false, KCL, TQ>, C, B, S, st,
              (const TQ *)qx, (const TQ *)qm, (const TQ *)qy, zt,
              (const float *)nullptr, ln, lm, K, S, lo, C, vtd, qdxo, qdmo,
              qdyo))))
}

// dp_q_clusters for the backward (kernel 2) and the adjoint forward (3),
// whose instances this part holds.
int dp_q_clusters_rev(int kernel, int op, int variant, int q_dt, int S,
                      int C) {
  if (kernel == 2) {
    if (variant) {
      DP_SWITCH_FLOAT(
          q_dt, TQ,
          DP_SWITCH_Q_CLUSTER(
              C, KCL,
              return max_clusters(backward_q_kernel<true, KCL, TQ>, C, S)))
    }
    DP_SWITCH_FLOAT(
        q_dt, TQ,
        DP_SWITCH_Q_CLUSTER(
            C, KCL,
            return max_clusters(backward_q_kernel<false, KCL, TQ>, C, S)))
  }
  if (variant) {
    DP_SWITCH_OP(DP_SWITCH_FLOAT(
        q_dt, TQ,
        DP_SWITCH_Q_CLUSTER(
            C, KCL,
            return max_clusters(adjoint_forward_q_kernel<OP, true, KCL, TQ>,
                                C, S))))
  }
  DP_SWITCH_OP(DP_SWITCH_FLOAT(
      q_dt, TQ,
      DP_SWITCH_Q_CLUSTER(
          C, KCL,
          return max_clusters(adjoint_forward_q_kernel<OP, false, KCL, TQ>, C,
                              S))))
}

#endif

}  // extern "C"
