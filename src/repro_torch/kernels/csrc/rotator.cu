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
// The arithmetic is blockfp_unit.cuh's (gain_mul_q30, the wrap-around
// adds; the vectoring and rotation kernels turn their chains with the
// multiply-add micro-rotation microrotation_fma in turn_chains_fma, the
// fused kernel with microrotation_mask, B4b's, in turn_chains), shared with
// the block-FP QR kernels.
//
// Bound on this card: integer operations.  A rotated element costs about 9
// int32 operations per micro-rotation (HUB) and 14 for the gain compensation
// and the flip, some 230 at iters = 24, against 16 bytes moved (two 4-byte
// reads and two writes); the card issues about 10 operations per byte of its
// memory bandwidth, so the work, not the bytes, is the limit.  In practice
// the kernels are bound by the integer ALU pipe, which issues LOP3, SHF
// and IADD3 for 16 lanes a cycle per SM sub-partition, half the issue rate:
// the fused kernel's HUB loop takes 87 of them for 8 element pairs and one
// micro-rotation, which puts rows of 8 at 0.58 ms on an H100 (0.63 read,
// 700 W).  The multiply-add micro-rotation moves the two updates onto the
// FMA pipe as IMAD (x + (m | 1) r(y)), leaving the shifts and the HUB
// rounding on the ALU pipe.  The vectoring kernel reads 4-byte lead words
// at the rows' stride, a 32-byte sector each: at rows of 8 its reads and
// writes put it near 0.10 ms whatever its layout.
//
// Design:
//  * Every operand is a row view with its own row stride and unit column
//    stride, so givens_rotate_rows_fixed writes vectoring's (B, 1) result and
//    rotation's (B, L-1) result straight into one (B, L) output.
//  * vectoring: one thread a lead pair, each micro-rotation's direction
//    from the pair's own y; HUB a template parameter, so the loop has no
//    runtime branch.  Two or four lead pairs a thread, as independent
//    chains, read 1-3% slower (the kernel is bound by its strided memory
//    traffic).
//  * rotation: T threads a row, K = 8 columns a thread, turned as K
//    independent chains on the row's known sigma (turn_chains_fma), T the
//    fewest that cover the row up to a warp (the fused kernel's rule,
//    cordic_givens._fused_layout); wider rows take several tiles.  Each
//    thread reads (flip, sigma) once.  Where every operand's base lies
//    the same h words past a 16-byte boundary and the row strides are
//    multiples of 4 words (givens_rotate_rows_fixed's x[:, 1:], h = 1),
//    the threads read whole 16-byte groups from the aligned-down base and
//    store the groups that lie inside the row whole, the row's first and
//    last group in aligned 8- and 4-byte pieces; else single words (kVec
//    false).
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

// B6a: one thread a lead pair b.  The direction of each micro-rotation
// comes from the pair's own y; HUB is a template parameter, so the loop
// has no runtime branch.
template <bool kHub>
__global__ void __launch_bounds__(kThreads)
    vectoring_kernel(const i32* __restrict__ x, const i32* __restrict__ y,
                     i32* xo, i32* yo, long long sx, long long sy,
                     long long sxo, long long syo, i32* __restrict__ flip,
                     i32* __restrict__ sig, int B, Params u) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  i32 xv[1] = {x[b * sx]}, yv[1] = {y[b * sy]};
  const i32 fm = xv[0] >> 31;  // flip on x < 0: _negate where fm
  xv[0] = kHub ? xv[0] ^ fm : bfp::wrap_sub(xv[0] ^ fm, fm);
  yv[0] = kHub ? yv[0] ^ fm : bfp::wrap_sub(yv[0] ^ fm, fm);
  bfp::u32 s = 0;
  bfp::turn_chains_fma<kHub, 1>(xv, yv, u.iters, [&](int i, int, i32 yq) {
    const i32 m = yq >> 31;  // d_pos where y < 0, recorded in sigma
    s |= (bfp::u32)m & (1u << i);
    return m;
  });
  xo[b * sxo] = bfp::gain_mul_q30(xv[0], u.comp);
  yo[b * syo] = bfp::gain_mul_q30(yv[0], u.comp);
  flip[b] = fm & 1;
  sig[b] = (i32)s;
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

// store_cols for B6b's rows, whose ends need not fall on a 16-byte group:
// with kVec the columns are words of the row's aligned-down base, of which
// [h, E) are the row's, and a group that holds a word outside them is
// stored in aligned pieces, 8 bytes where both words of a pair are the
// row's, else 4 (at h = 1, the x[:, 1:] views: words 1 and 2-3, two
// stores where single words take three; each store instruction of a warp
// costs the memory system up to 32 sectors); without, columns c < E.
template <int T, int K, bool kVec>
__device__ __forceinline__ void store_words(i32* row, const i32 (&v)[K],
                                            int c0, int lane, int h, int E,
                                            i32 comp) {
#pragma unroll
  for (int q = 0; q < (kVec ? K / 4 : K); ++q) {
    const int c = c0 + (kVec ? 4 * (lane + T * q) : lane + T * q);
    if (!kVec) {
      if (c < E) row[c] = bfp::gain_mul_q30(v[q], comp);
    } else if (c >= h && c + 4 <= E) {
      *reinterpret_cast<int4*>(row + c) = make_int4(
          bfp::gain_mul_q30(v[4 * q], comp),
          bfp::gain_mul_q30(v[4 * q + 1], comp),
          bfp::gain_mul_q30(v[4 * q + 2], comp),
          bfp::gain_mul_q30(v[4 * q + 3], comp));
    } else {
#pragma unroll
      for (int w = 0; w < 4; w += 2) {
        const bool a = c + w >= h && c + w < E;
        const bool b = c + w + 1 >= h && c + w + 1 < E;
        if (a && b) {
          *reinterpret_cast<int2*>(row + c + w) =
              make_int2(bfp::gain_mul_q30(v[4 * q + w], comp),
                        bfp::gain_mul_q30(v[4 * q + w + 1], comp));
        } else if (a) {
          row[c + w] = bfp::gain_mul_q30(v[4 * q + w], comp);
        } else if (b) {
          row[c + w + 1] = bfp::gain_mul_q30(v[4 * q + w + 1], comp);
        }
      }
    }
  }
}

// B6b: thread (segment, lane) of a block replays row b's control word
// (flip, sigma), b = the block's kThreads / T rows + segment, on the row's
// columns in tiles of T x K, K independent chains a thread.  With kVec
// the operands are the rows' aligned-down bases, the row's words [h, E):
// whole 16-byte groups are read, the head's and the tail's extra words
// turned and not stored.  Micro-rotation i turns every chain in the
// direction -((sigma >> i) & 1); no shuffle, shared memory or barrier.
template <bool kHub, int T, int K, bool kVec>
__global__ void __launch_bounds__(kThreads)
    rotation_kernel(const i32* __restrict__ x, const i32* __restrict__ y,
                    i32* xo, i32* yo, long long ldx, long long ldy,
                    long long ldxo, long long ldyo,
                    const i32* __restrict__ flip,
                    const i32* __restrict__ sig, int B, int h, int E,
                    Params u) {
  const int lane = threadIdx.x % T;  // T is a power of two
  const long long b =
      (long long)blockIdx.x * (kThreads / T) + threadIdx.x / T;
  if (b >= B) return;
  const i32* xr = x + b * ldx;
  const i32* yr = y + b * ldy;
  i32* xw = xo + b * ldxo;
  i32* yw = yo + b * ldyo;
  const i32 fm = -(i32)(__ldg(flip + b) != 0);  // all ones where flipped
  const bfp::u32 s = (bfp::u32)__ldg(sig + b);
  for (int c0 = 0; c0 < E; c0 += T * K) {
    i32 xv[K], yv[K];
    load_cols<T, K, kVec>(xv, xr, c0, lane, E, true);
    load_cols<T, K, kVec>(yv, yr, c0, lane, E, true);
#pragma unroll
    for (int q = 0; q < K; ++q) {  // _negate: ~v with HUB, else -v
      xv[q] = kHub ? xv[q] ^ fm : bfp::wrap_sub(xv[q] ^ fm, fm);
      yv[q] = kHub ? yv[q] ^ fm : bfp::wrap_sub(yv[q] ^ fm, fm);
    }
    bfp::turn_chains_fma<kHub, K>(xv, yv, u.iters, [&](int i, int, i32) {
      return -(i32)((s >> i) & 1u);
    });
    store_words<T, K, kVec>(xw, xv, c0, lane, h, E, u.comp);
    store_words<T, K, kVec>(yw, yv, c0, lane, h, E, u.comp);
  }
}

// Columns a thread of the rotation kernel: the 8 of the fused kernel's
// layout rule, by which cordic_givens._fused_layout picks its threads a row.
constexpr int kRotationChains = 8;

template <int T>
static int rotation_layout_launch(const i32* x, const i32* y, i32* xo,
                                  i32* yo, long long ldx, long long ldy,
                                  long long ldxo, long long ldyo,
                                  const i32* flip, const i32* sig, int B,
                                  int h, int E, bool vec, const Params& u,
                                  cudaStream_t stream) {
  constexpr int K = kRotationChains;
  const long long rows = kThreads / T;  // rows a block
  const dim3 grid((unsigned)(((long long)B + rows - 1) / rows));
  const auto k = u.hub ? (vec ? rotation_kernel<true, T, K, true>
                              : rotation_kernel<true, T, K, false>)
                       : (vec ? rotation_kernel<false, T, K, true>
                              : rotation_kernel<false, T, K, false>);
  k<<<grid, kThreads, 0, stream>>>(x, y, xo, yo, ldx, ldy, ldxo, ldyo, flip,
                                   sig, B, h, E, u);
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
  const auto k = hub ? vectoring_kernel<true> : vectoring_kernel<false>;
  k<<<(unsigned)(((long long)B + kThreads - 1) / kThreads), kThreads, 0,
      (cudaStream_t)stream>>>((const i32*)x, (const i32*)y, (i32*)xo,
                              (i32*)yo, sx, sy, sxo, syo, (i32*)flip,
                              (i32*)sig, B, u);
  return (int)cudaGetLastError();
}

// threads_row (T, a power of two up to 32): the layout, kRotationChains
// columns a thread; rows wider than T x kRotationChains take several
// tiles.  vec: every operand's base is
// `head` words past a 16-byte boundary and its row stride a multiple of 4
// words (the kernel reads whole groups from base - head), else single
// words (head 0).
int rotation_launch(const void* x, const void* y, void* xo, void* yo,
                    long long ldx, long long ldy, long long ldxo,
                    long long ldyo, const void* flip, const void* sig, int B,
                    int L, int head, int threads_row, int vec, int iters,
                    int hub, int comp, void* stream) {
  const Params u = {iters, hub, comp};
  if (head < 0 || head > 3 || (!vec && head)) {
    return (int)cudaErrorInvalidValue;
  }
  auto* launch = &rotation_layout_launch<1>;
  switch (threads_row) {
    case 1: launch = &rotation_layout_launch<1>; break;
    case 2: launch = &rotation_layout_launch<2>; break;
    case 4: launch = &rotation_layout_launch<4>; break;
    case 8: launch = &rotation_layout_launch<8>; break;
    case 16: launch = &rotation_layout_launch<16>; break;
    case 32: launch = &rotation_layout_launch<32>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return launch((const i32*)x - head, (const i32*)y - head, (i32*)xo - head,
                (i32*)yo - head, ldx, ldy, ldxo, ldyo, (const i32*)flip,
                (const i32*)sig, B, head, head + L, vec != 0, u,
                (cudaStream_t)stream);
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
