// The standalone rotator: the paper's unit applied to B row pairs of int32
// block-FP significands, as the paper's Tables 6-7 measure it.  Vector the
// lead pair once, then replay its control word (flip, sigma) across the
// whole row pair.  Bit-exact to the plain versions in
// repro_torch/kernels/cordic_givens.py.
//
// Replaces: src/repro/kernels/cordic_givens.py,
//   _vectoring_kernel / vectoring_call (B6a),
//   _rotation_kernel / rotation_call (B6b) and
//   _fused_kernel / fused_call (B6c).
//
// What it computes:
//  * vectoring: for each lead pair, flip on x < 0 and iters micro-rotations
//    driving y to 0, their directions packed into sigma; the gain-compensated
//    vectored pair (xr, yr) and the control word (flip, sigma).  Equal to
//    vectoring_reference, which replays the lead by its own control word:
//    the same micro-rotations in the same directions, bit for bit.
//  * rotation: every element of row pair b replayed by (flip[b], sigma[b])
//    and gain-compensated.  Equal to rotation_reference.
//  * fused: both on one row block: sigma from column 0, replayed on every
//    column, column 0 included.  Equal to fused_reference.
// The arithmetic is blockfp_unit.cuh's (vector_pair, replay, gain_mul_q30,
// the wrap-around adds; the fused kernel's micro-rotations are
// microrotation_mask, B4b's, in turn_chains), shared with the block-FP QR
// kernels.
//
// Bound on this card: integer operations.  A rotated element costs about 9
// int32 operations per micro-rotation (HUB) and 14 for the gain compensation
// and the flip, some 230 at iters = 24, against 16 bytes moved (two 4-byte
// reads and two writes); the card issues about 10 operations per byte of its
// memory bandwidth, so the work, not the bytes, is the limit.  In practice
// the fused kernel is bound by the integer ALU pipe, which issues LOP3, SHF
// and IADD3 for 16 lanes a cycle per SM sub-partition: its HUB loop takes
// 87 of them for 8 element pairs and one micro-rotation, which puts rows of
// 8 at 0.58 ms on an H100 (0.63 read, 700 W).
//
// Design:
//  * Every operand is a row view with its own row stride and unit column
//    stride, so givens_rotate_rows_fixed writes vectoring's (B, 1) result and
//    rotation's (B, L-1) result straight into one (B, L) output.
//  * vectoring: one thread per lead pair.
//  * rotation: a purely elementwise pass, one thread per element on a 2-D
//    grid (row blocks on x, column tiles on y); the threads of a row are
//    neighbours, so a warp reads consecutive words.  Each thread reads its
//    row's (flip, sigma) once.
//  * fused: T threads a row (a segment of a warp), each with K of its
//    columns as K independent chains that share the row's (flip, sigma) and
//    interleave (turn_chains).  Lane 0's chain 0 is column 0, the lead pair:
//    it takes micro-rotation i's direction from its own y, so the row is
//    vectored as it is rotated, and the other lanes read that direction by
//    __shfl_sync, one a micro-rotation (none where T = 1: rows of 8 are one
//    thread each with K = 8).  No shared memory, no barrier, no division:
//    the layout is a template (T, K) that the wrapper picks from the row
//    width (cordic_givens._fused_layout).  Where the base pointers and row
//    strides allow, each thread reads and writes 16-byte vectors (kVec: the
//    wrapper checks the alignment), else single words; the lanes of a
//    row's segment touch neighbouring groups or words.  A row wider than
//    T x K (T = 32) takes several tiles: the first records sigma as it
//    vectors, the rest replay it (kTiles).
//  * Ragged edges are masked; no padding to the TPU's (8, 128) tile.
#include <cuda_runtime.h>

#include "blockfp_unit.cuh"

using bfp::i32;
using bfp::Params;

namespace {

constexpr int kThreads = 256;  // threads a block of every kernel here

__global__ void vectoring_kernel(const i32* __restrict__ x,
                                 const i32* __restrict__ y, i32* xo, i32* yo,
                                 long long sx, long long sy, long long sxo,
                                 long long syo, i32* __restrict__ flip,
                                 i32* __restrict__ sig, int B, Params u) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  i32 xl = x[b * sx], yl = y[b * sy];
  i32 f, s;
  bfp::vector_pair(xl, yl, u, f, s);
  xo[b * sxo] = bfp::gain_mul_q30(xl, u.comp);
  yo[b * syo] = bfp::gain_mul_q30(yl, u.comp);
  flip[b] = f;
  sig[b] = s;
}

__global__ void rotation_kernel(const i32* __restrict__ x,
                                const i32* __restrict__ y, i32* xo, i32* yo,
                                long long ldx, long long ldy, long long ldxo,
                                long long ldyo, const i32* __restrict__ flip,
                                const i32* __restrict__ sig, int B, int L,
                                Params u) {
  const long long b = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= B || c >= L) return;
  i32 xv = x[b * ldx + c], yv = y[b * ldy + c];
  bfp::replay(xv, yv, u, __ldg(flip + b), __ldg(sig + b));
  xo[b * ldxo + c] = xv;
  yo[b * ldyo + c] = yv;
}

// The row's lead direction mask v as lane 0 of the thread's T-lane
// segment holds it.
template <int T>
__device__ __forceinline__ i32 from_lead(i32 v) {
  if constexpr (T == 1) {
    return v;
  } else {
    return __shfl_sync(0xffffffffu, v, 0, T);
  }
}

// This thread's K columns of the row tile at c0: with kVec 16-byte groups
// 4 (lane + T j) .. + 3 (the wrapper keeps L a multiple of 4), else
// columns lane + T k; chain q of lane 0 is column c0.  Columns at or past
// L, and a dead row's, read as 0.
template <int T, int K, bool kVec>
__device__ __forceinline__ void load_cols(i32 (&v)[K], const i32* row, int c0,
                                          int lane, int L, bool live) {
#pragma unroll
  for (int q = 0; q < (kVec ? K / 4 : K); ++q) {
    const int c = c0 + (kVec ? 4 * (lane + T * q) : lane + T * q);
    if (kVec) {
      const int4 w = live && c < L ? *reinterpret_cast<const int4*>(row + c)
                                   : make_int4(0, 0, 0, 0);
      v[4 * q] = w.x;
      v[4 * q + 1] = w.y;
      v[4 * q + 2] = w.z;
      v[4 * q + 3] = w.w;
    } else {
      v[q] = live && c < L ? row[c] : 0;
    }
  }
}

// load_cols' inverse, gain-compensated: columns past L are not written.
template <int T, int K, bool kVec>
__device__ __forceinline__ void store_cols(i32* row, const i32 (&v)[K], int c0,
                                           int lane, int L, i32 comp) {
#pragma unroll
  for (int q = 0; q < (kVec ? K / 4 : K); ++q) {
    const int c = c0 + (kVec ? 4 * (lane + T * q) : lane + T * q);
    if (c >= L) continue;
    if (kVec) {
      *reinterpret_cast<int4*>(row + c) = make_int4(
          bfp::gain_mul_q30(v[4 * q], comp),
          bfp::gain_mul_q30(v[4 * q + 1], comp),
          bfp::gain_mul_q30(v[4 * q + 2], comp),
          bfp::gain_mul_q30(v[4 * q + 3], comp));
    } else {
      row[c] = bfp::gain_mul_q30(v[q], comp);
    }
  }
}

// B6c: thread (segment, lane) of a block rotates row b = the block's
// kThreads / T rows + segment, in tiles of T x K columns.  Every lane of a
// warp runs the shuffles: a dead row (b >= B, the last block's ragged
// edge) computes on zeros and stores nothing.
template <bool kHub, int T, int K, bool kVec, bool kTiles>
__global__ void __launch_bounds__(kThreads)
    fused_kernel(const i32* __restrict__ x, const i32* __restrict__ y, i32* xo,
                 i32* yo, long long ldx, long long ldy, long long ldxo,
                 long long ldyo, int B, int L, Params u) {
  const int lane = threadIdx.x % T;  // T is a power of two
  const long long b =
      (long long)blockIdx.x * (kThreads / T) + threadIdx.x / T;
  const bool live = b < B;
  const long long r = live ? b : 0;
  const i32* xr = x + r * ldx;
  const i32* yr = y + r * ldy;
  i32 fm = 0;        // all ones where the row pair is flipped
  bfp::u32 sig = 0;  // the control word, recorded for the later tiles
  for (int c0 = 0; c0 < L; c0 += T * K) {
    i32 xv[K], yv[K];
    load_cols<T, K, kVec>(xv, xr, c0, lane, L, live);
    load_cols<T, K, kVec>(yv, yr, c0, lane, L, live);
    if (c0 == 0) fm = from_lead<T>(xv[0] >> 31);  // flip on x < 0
#pragma unroll
    for (int q = 0; q < K; ++q) {  // _negate: ~v with HUB, else -v
      xv[q] = kHub ? xv[q] ^ fm : bfp::wrap_sub(xv[q] ^ fm, fm);
      yv[q] = kHub ? yv[q] ^ fm : bfp::wrap_sub(yv[q] ^ fm, fm);
    }
    if (c0 == 0) {  // vectoring on the lead as the tile turns
      bfp::turn_chains<kHub, K>(xv, yv, u.iters, [&](int i, i32 y0) {
        const i32 m = from_lead<T>(y0 >> 31);  // d_pos where y < 0
        if (kTiles) sig |= (bfp::u32)(m & 1) << i;
        return m;
      });
    } else {
      bfp::turn_chains<kHub, K>(xv, yv, u.iters, [&](int i, i32) {
        return -(i32)((sig >> i) & 1u);
      });
    }
    if (live) {
      store_cols<T, K, kVec>(xo + r * ldxo, xv, c0, lane, L, u.comp);
      store_cols<T, K, kVec>(yo + r * ldyo, yv, c0, lane, L, u.comp);
    }
    if (!kTiles) break;
  }
}

template <int T, int K>
static int fused_layout_launch(const i32* x, const i32* y, i32* xo, i32* yo,
                               long long ldx, long long ldy, long long ldxo,
                               long long ldyo, int B, int L, bool vec,
                               const Params& u, cudaStream_t stream) {
  const bool tiles = L > T * K;
  if (tiles && T != 32) return (int)cudaErrorInvalidValue;
  const long long rows = kThreads / T;  // rows a block
  const dim3 grid((unsigned)(((long long)B + rows - 1) / rows));
  const auto k = u.hub ? (vec ? (tiles ? fused_kernel<true, T, K, true, T == 32>
                                       : fused_kernel<true, T, K, true, false>)
                              : (tiles ? fused_kernel<true, T, K, false, T == 32>
                                       : fused_kernel<true, T, K, false, false>))
                       : (vec ? (tiles ? fused_kernel<false, T, K, true, T == 32>
                                       : fused_kernel<false, T, K, true, false>)
                              : (tiles ? fused_kernel<false, T, K, false, T == 32>
                                       : fused_kernel<false, T, K, false, false>));
  k<<<grid, kThreads, 0, stream>>>(x, y, xo, yo, ldx, ldy, ldxo, ldyo, B, L,
                                   u);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns the CUDA error of the launch (0 on
// success).  The wrappers never launch an empty grid (B = 0 or L = 0).
int vectoring_launch(const void* x, const void* y, void* xo, void* yo,
                     long long sx, long long sy, long long sxo, long long syo,
                     void* flip, void* sig, int B, int iters, int hub,
                     int comp, void* stream) {
  const Params u = {iters, hub, comp};
  vectoring_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const i32*)x, (const i32*)y, (i32*)xo, (i32*)yo, sx, sy, sxo, syo,
      (i32*)flip, (i32*)sig, B, u);
  return (int)cudaGetLastError();
}

// threads_x: threads along a row (a power of two, at most kThreads); the
// block holds kThreads / threads_x rows.
int rotation_launch(const void* x, const void* y, void* xo, void* yo,
                    long long ldx, long long ldy, long long ldxo,
                    long long ldyo, const void* flip, const void* sig, int B,
                    int L, int threads_x, int iters, int hub, int comp,
                    void* stream) {
  const Params u = {iters, hub, comp};
  const dim3 block(threads_x, kThreads / threads_x);
  const dim3 grid((B + block.y - 1) / block.y, (L + threads_x - 1) / threads_x);
  rotation_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const i32*)x, (const i32*)y, (i32*)xo, (i32*)yo, ldx, ldy, ldxo, ldyo,
      (const i32*)flip, (const i32*)sig, B, L, u);
  return (int)cudaGetLastError();
}

// threads_row (T) and chains (K): one of the layouts below; vec: every
// operand's base is 16-byte aligned, its row stride and L multiples of 4.
int fused_launch(const void* x, const void* y, void* xo, void* yo,
                 long long ldx, long long ldy, long long ldxo, long long ldyo,
                 int B, int L, int threads_row, int chains, int vec,
                 int iters, int hub, int comp, void* stream) {
  const Params u = {iters, hub, comp};
  auto* launch = &fused_layout_launch<1, 8>;
  switch (threads_row * 100 + chains) {
    case 108: launch = &fused_layout_launch<1, 8>; break;
    case 208: launch = &fused_layout_launch<2, 8>; break;
    case 408: launch = &fused_layout_launch<4, 8>; break;
    case 808: launch = &fused_layout_launch<8, 8>; break;
    case 1608: launch = &fused_layout_launch<16, 8>; break;
    case 3208: launch = &fused_layout_launch<32, 8>; break;
    case 3204: launch = &fused_layout_launch<32, 4>; break;
    case 816: launch = &fused_layout_launch<8, 16>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return launch((const i32*)x, (const i32*)y, (i32*)xo, (i32*)yo, ldx, ldy,
                ldxo, ldyo, B, L, vec != 0, u, (cudaStream_t)stream);
}

const char* rotator_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
