// Tiled panel QR over packed FP words: the panel factorization that exports
// each rotation's control word, and the replay of those words over the
// trailing columns.  Bit-exact to the unit.
//
// Replaces: src/repro/kernels/qrd_blocked.py,
//   _panel_factor_packed_kernel / panel_factor_packed_call (B3a) and
//   _panel_apply_packed_kernel / panel_apply_packed_call (B3b).
//
// What it computes:
//  * panel_factor: for each panel-local (piv, tgt, col) step, the unit's
//    rotate_rows on rows piv and tgt of an mr x pw panel from column col,
//    the target lead forced to 0, and the step's control word (flip, sigma)
//    written to the (B, S) outputs.  Equal to panel_factor_packed_reference.
//  * panel_apply: every (piv, tgt, flip, sigma) step replayed with the
//    unit's rotate on the trailing mr x w region.  Equal to
//    panel_apply_packed_reference.
// Together, panel by panel, they run the column-major schedule of the flat
// kernel (qr_packed.cu) in the same order, so the words equal its words.
//
// Bound on this card: integer operations, as for qr_packed.cu: several
// hundred dependent int64 operations per rotated element against one read
// and one write of each word.
//
// Design (simple first; speed is later work):
//  * Both kernels work in place on row-strided views of the (B, m, e)
//    working buffer: a matrix at batch stride sb, rows at stride ld, unit
//    column stride.  No padding, chunking or transposes.
//  * panel_factor: one block holds `tile_b` panels (blockDim.y) in shared
//    memory and runs gru::factor_tile (qr_tile.cuh), the step loop of
//    qr_packed.cu.  A panel is at most 128 x 128 words (128 KiB) on the
//    engine's routes, so one always fits; the wrapper caps tile_b.
//  * panel_apply: once (flip, sigma) are known every column is rotated on
//    its own, so one thread owns one column of one matrix for all S steps
//    and the kernel has no barrier.  Grid (B, column blocks); the column
//    lives in device memory, read and written through the L1 cache.
#include <cuda_runtime.h>

#include "qr_tile.cuh"

using gru::i64;
using gru::UnitParams;

__global__ void panel_factor_kernel(i64* P, long long sb, long long ld, int B,
                                    int mr, int pw, const int* __restrict__ piv,
                                    const int* __restrict__ tgt,
                                    const int* __restrict__ col, int S,
                                    i64* __restrict__ flip,
                                    i64* __restrict__ sig, UnitParams u) {
  extern __shared__ i64 tiles[];
  const long long b = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = b < B;  // the ragged edge of the last block
  i64* src = P + (live ? b : 0) * sb;
  i64* T = tiles + (long long)threadIdx.y * mr * pw;
  if (live) gru::copy_tile(T, pw, src, ld, mr, pw);
  __syncthreads();
  gru::factor_tile(T, pw, pw, piv, tgt, col, 1, S, live, u,
                   flip + (live ? b : 0) * S, sig + (live ? b : 0) * S);
  if (live) gru::copy_tile(src, ld, T, pw, mr, pw);
}

__global__ void panel_apply_kernel(i64* P, long long sb, long long ld, int w,
                                   const int* __restrict__ piv,
                                   const int* __restrict__ tgt, int S,
                                   const i64* __restrict__ flip,
                                   const i64* __restrict__ sig, UnitParams u) {
  const long long b = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= w) return;
  i64* T = P + b * sb + c;
  const i64* f = flip + b * S;
  const i64* g = sig + b * S;
  for (int s = 0; s < S; ++s) {
    i64* px = T + __ldg(piv + s) * ld;
    i64* py = T + __ldg(tgt + s) * ld;
    i64 x = *px, y = *py;
    gru::rotate_pair(x, y, u, __ldg(f + s), __ldg(g + s));
    *px = x;
    *py = y;
  }
}

extern "C" {

// Both launch on `stream` and return cudaGetLastError() (0 on success).
int panel_factor_launch(void* P, long long sb, long long ld, int B, int mr,
                        int pw, const void* piv, const void* tgt,
                        const void* col, int S, void* flip, void* sig,
                        int tile_b, int threads_x,
                        int man_bits, int exp_bits, long long bias,
                        long long max_exp_raw, int N, int iters, int hub,
                        int rne, int unbiased, int detect_identity,
                        long long comp, int p, void* stream) {
  const UnitParams u = {man_bits, exp_bits, bias, max_exp_raw, N, iters, hub,
                        rne, unbiased, detect_identity, comp, p};
  const dim3 block(threads_x, tile_b);
  const dim3 grid((B + tile_b - 1) / tile_b);
  const size_t smem = (size_t)tile_b * mr * pw * sizeof(i64);
  cudaError_t err = cudaFuncSetAttribute(
      panel_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  panel_factor_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (i64*)P, sb, ld, B, mr, pw, (const int*)piv, (const int*)tgt,
      (const int*)col, S, (i64*)flip, (i64*)sig, u);
  return (int)cudaGetLastError();
}

int panel_apply_launch(void* P, long long sb, long long ld, int B, int w,
                       const void* piv, const void* tgt, int S,
                       const void* flip, const void* sig, int threads,
                       int man_bits, int exp_bits, long long bias,
                       long long max_exp_raw, int N, int iters, int hub,
                       int rne, int unbiased, int detect_identity,
                       long long comp, int p, void* stream) {
  const UnitParams u = {man_bits, exp_bits, bias, max_exp_raw, N, iters, hub,
                        rne, unbiased, detect_identity, comp, p};
  const dim3 grid(B, (w + threads - 1) / threads);
  panel_apply_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (i64*)P, sb, ld, w, (const int*)piv, (const int*)tgt, S,
      (const i64*)flip, (const i64*)sig, u);
  return (int)cudaGetLastError();
}

const char* panel_packed_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
