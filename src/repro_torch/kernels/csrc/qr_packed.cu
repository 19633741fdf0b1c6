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
// chip_smoke.py counts 2.49e11 32-bit operations: 7.45 ms at an H100 SXM's
// integer issue rate (4 warp instructions per clock per SM, 33.4e12/s),
// against 0.08 ms for the two passes at 3.35 TB/s.
//
// Design (simple first; speed is later work):
//  * One block factorizes `tile_b` matrices (blockDim.y).  The m x e tile of
//    each lives in dynamic shared memory for the whole factorization, so
//    device memory is touched twice.  A tile larger than a block's shared
//    memory (tile_b * m * e * 8 > 232448 bytes, e.g. 128 x 128 with Q) is
//    factorized in place in device memory instead: `in` is copied to `out`
//    once and the same step loop runs on `out` (kShared = false), through
//    the L1 and L2 caches.
//  * The schedule travels as an (S, 3) int32 table and is walked in a
//    runtime loop, so one binary serves any schedule.
//  * The step loop is gru::factor_tile (qr_tile.cuh), shared with the panel
//    factorization: threads of a row (blockDim.x) stride over the elements
//    col..e-1; each thread runs the lead's vectoring itself, then rotates
//    its own elements in place; two barriers a step.
#include <cuda_runtime.h>

#include "qr_tile.cuh"

using gru::i64;
using gru::UnitParams;

template <bool kShared>
__global__ void qr_packed_kernel(const i64* __restrict__ in, i64* out,
                                 const int* __restrict__ steps, int B, int m,
                                 int e, int S, UnitParams u) {
  extern __shared__ i64 tiles[];
  const long long me = (long long)m * e;
  const long long b = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = b < B;  // the ragged edge of the last block
  i64* T = kShared ? tiles + threadIdx.y * me : out + (live ? b : 0) * me;

  if (live) gru::copy_tile(T, e, in + b * me, e, m, e);
  __syncthreads();
  gru::factor_tile(T, e, e, steps, steps + 1, steps + 2, 3, S, live, u,
                   nullptr, nullptr);
  if (kShared && live) gru::copy_tile(out + b * me, e, T, e, m, e);
}

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success).  With
// device_tile the working tile lives in `out` (device memory), not in
// shared memory.
int qr_packed_launch(const void* in, void* out, const void* steps, int B, int m,
                     int e, int S, int tile_b, int threads_x, int device_tile,
                     int man_bits, int exp_bits, long long bias,
                     long long max_exp_raw, int N, int iters, int hub, int rne,
                     int unbiased, int detect_identity, long long comp, int p,
                     void* stream) {
  const UnitParams u = {man_bits, exp_bits, bias, max_exp_raw, N, iters, hub,
                        rne, unbiased, detect_identity, comp, p};
  const dim3 block(threads_x, tile_b);
  const dim3 grid((B + tile_b - 1) / tile_b);
  if (device_tile) {
    qr_packed_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const i64*)in, (i64*)out, (const int*)steps, B, m, e, S, u);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)tile_b * m * e * sizeof(i64);
  cudaError_t err = cudaFuncSetAttribute(
      qr_packed_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  qr_packed_kernel<true><<<grid, block, smem, (cudaStream_t)stream>>>(
      (const i64*)in, (i64*)out, (const int*)steps, B, m, e, S, u);
  return (int)cudaGetLastError();
}

const char* qr_packed_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
