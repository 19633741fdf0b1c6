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
// the wrap-around adds), shared with the block-FP QR kernels.
//
// Bound on this card: integer operations.  A rotated element costs about 9
// int32 operations per micro-rotation (HUB) and 14 for the gain compensation
// and the flip, some 230 at iters = 24, against 16 bytes moved (two 4-byte
// reads and two writes); the card issues about 10 operations per byte of its
// memory bandwidth, so the work, not the bytes, is the limit.
//
// Design (simple first; speed is later work):
//  * Every operand is a row view with its own row stride and unit column
//    stride, so givens_rotate_rows_fixed writes vectoring's (B, 1) result and
//    rotation's (B, L-1) result straight into one (B, L) output.
//  * vectoring: one thread per lead pair.
//  * rotation: a purely elementwise pass, one thread per element on a 2-D
//    grid (row blocks on x, column tiles on y); the threads of a row are
//    neighbours, so a warp reads consecutive words.  Each thread reads its
//    row's (flip, sigma) once.
//  * fused: a block of kRows rows.  One thread per row vectors the lead into
//    shared memory, one barrier, then the block's threads spread over
//    (row, column) and replay, as stage_loop.cuh does for a stage: each
//    element is read once and written once (the lead twice: it is read again
//    to replay it).
//  * Ragged edges are masked; no padding to the TPU's (8, 128) tile.
#include <cuda_runtime.h>

#include "blockfp_unit.cuh"

using bfp::i32;
using bfp::Params;

namespace {

constexpr int kThreads = 256;  // threads a block of every kernel here
constexpr int kRows = 256;     // rows a block of the fused kernel

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

__global__ void fused_kernel(const i32* __restrict__ x,
                             const i32* __restrict__ y, i32* xo, i32* yo,
                             long long ldx, long long ldy, long long ldxo,
                             long long ldyo, int B, int L, Params u) {
  __shared__ i32 s_flip[kRows], s_sig[kRows];
  const long long b0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, (long long)B - b0);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    bfp::vector_lead(x[(b0 + r) * ldx], y[(b0 + r) * ldy], u, s_flip[r],
                     s_sig[r]);
  }
  __syncthreads();  // every row's control word is in shared memory
  const int n = rows * L;  // the wrapper keeps kRows * L inside int
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / L, c = i - r * L;
    const long long b = b0 + r;
    i32 xv = x[b * ldx + c], yv = y[b * ldy + c];
    bfp::replay(xv, yv, u, s_flip[r], s_sig[r]);
    xo[b * ldxo + c] = xv;
    yo[b * ldyo + c] = yv;
  }
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

int fused_launch(const void* x, const void* y, void* xo, void* yo,
                 long long ldx, long long ldy, long long ldxo, long long ldyo,
                 int B, int L, int iters, int hub, int comp, void* stream) {
  const Params u = {iters, hub, comp};
  fused_kernel<<<(B + kRows - 1) / kRows, kThreads, 0,
                 (cudaStream_t)stream>>>(
      (const i32*)x, (const i32*)y, (i32*)xo, (i32*)yo, ldx, ldy, ldxo, ldyo,
      B, L, u);
  return (int)cudaGetLastError();
}

const char* rotator_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
