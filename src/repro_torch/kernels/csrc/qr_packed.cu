// Kernel-resident Givens QR over packed FP words, bit-exact to the unit.
//
// Replaces: src/repro/kernels/qrd_blocked.py, _qr_packed_kernel /
// qr_packed_call (the pallas_call of the step-serial packed-word QR).
//
// What it computes: for each (k, j, col) step of a schedule, the unit's
// rotate_rows on rows k and j from column col (input converter, CORDIC
// vectoring on the lead pair, sigma replay across the row, gain
// compensation, output converter), then the target lead forced to 0.
// The output words equal the plain version's (qr_packed_reference).
//
// Bound on this card: integer operations.  The steps are a chain of
// dependent 64-bit integer recurrences over a tile that is read once and
// written once, so memory traffic (2 passes over B*m*e*8 bytes) is tiny
// next to the ALU work (several hundred int64 operations per element per
// rotation).  At the main-path shape, (8192, 32, 64) words with HUB N = 26,
// chip_smoke.py counts 2.49e11 operations: 14.9 ms at an H100 SXM's
// 16.7e12 INT32 operations/s, against 0.08 ms for the two passes at
// 3.35 TB/s.
//
// Design (simple first; speed is later work):
//  * One block factorizes `tile_b` matrices (blockDim.y); the m x e tile of
//    each lives in dynamic shared memory for the whole factorization, so
//    device memory is touched twice.
//  * The schedule travels as an (S, 3) int32 table and is walked in a
//    runtime loop, so one binary serves any schedule.
//  * Threads of a row (blockDim.x) stride over the elements col..e-1.  Each
//    thread runs the lead's vectoring itself (the same work for every
//    thread of the matrix, no broadcast needed), then rotates its own
//    elements in place.  Two barriers a step: after all threads read the
//    lead pair, and after all threads wrote their elements.
#include <cuda_runtime.h>

#include "givens_unit.cuh"

using gru::i64;
using gru::UnitParams;

__global__ void qr_packed_kernel(const i64* __restrict__ in, i64* __restrict__ out,
                                 const int* __restrict__ steps, int B, int m,
                                 int e, int S, UnitParams u) {
  extern __shared__ i64 tiles[];
  const int me = m * e;
  const long long b = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = b < B;  // the ragged edge of the last block
  i64* T = tiles + (size_t)threadIdx.y * me;

  if (live)
    for (int idx = threadIdx.x; idx < me; idx += blockDim.x)
      T[idx] = in[b * me + idx];
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    const int k = __ldg(steps + 3 * s);
    const int j = __ldg(steps + 3 * s + 1);
    const int col = __ldg(steps + 3 * s + 2);
    i64 xl = 0, yl = 0;
    if (live) {
      xl = T[k * e + col];
      yl = T[j * e + col];
    }
    __syncthreads();  // the lead pair is read before its owner overwrites it
    if (live) {
      i64 xf, yf, m_exp, flip, sig;
      gru::to_fixed(xl, yl, u, xf, yf, m_exp);
      gru::vectoring(xf, yf, u, flip, sig);
      for (int idx = col + threadIdx.x; idx < e; idx += blockDim.x) {
        if (idx == col) {
          T[k * e + col] = gru::to_float(gru::apply_gain(xf, u), m_exp, u);
          T[j * e + col] = 0;  // structural zero (systolic array)
        } else {
          i64 x, y, mx;
          gru::to_fixed(T[k * e + idx], T[j * e + idx], u, x, y, mx);
          gru::rotation(x, y, u, flip, sig);
          T[k * e + idx] = gru::to_float(gru::apply_gain(x, u), mx, u);
          T[j * e + idx] = gru::to_float(gru::apply_gain(y, u), mx, u);
        }
      }
    }
    __syncthreads();
  }

  if (live)
    for (int idx = threadIdx.x; idx < me; idx += blockDim.x)
      out[b * me + idx] = T[idx];
}

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int qr_packed_launch(const void* in, void* out, const void* steps, int B, int m,
                     int e, int S, int tile_b, int threads_x, int man_bits,
                     int exp_bits, long long bias, long long max_exp_raw, int N,
                     int iters, int hub, int rne, int unbiased,
                     int detect_identity, long long comp, int p, void* stream) {
  const UnitParams u = {man_bits, exp_bits, bias, max_exp_raw, N, iters, hub,
                        rne, unbiased, detect_identity, comp, p};
  const size_t smem = (size_t)tile_b * m * e * sizeof(i64);
  cudaError_t err = cudaFuncSetAttribute(
      qr_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(threads_x, tile_b);
  const dim3 grid((B + tile_b - 1) / tile_b);
  qr_packed_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const i64*)in, (i64*)out, (const int*)steps, B, m, e, S, u);
  return (int)cudaGetLastError();
}

const char* qr_packed_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
