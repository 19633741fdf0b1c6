// Kernel-resident Givens QR over packed FP words, bit-exact to the unit.
//
// Replaces: src/repro/kernels/qrd_blocked.py, _qr_packed_kernel /
// qr_packed_call (the pallas_call of the step-serial packed-word QR, B1),
// and _qr_packed_wavefront_kernel / qr_packed_wavefront_call (B5a): the
// Sameh-Kuck stages are disjoint pairs already, so B5a's wrapper gives
// this kernel the caller's stages with their item ends
// (qrd_blocked._wavefront_table) and counts its own launches.
//
// What it computes: for each (k, j, col) step of a schedule, the unit's
// rotate_rows on rows k and j from column col (input converter, CORDIC
// vectoring on the lead pair, sigma replay across the row, gain
// compensation, output converter), then the target lead forced to 0.
// The output words equal the plain version's (qr_packed_reference).
//
// It runs the steps in stages: the wrapper levelizes them
// (qrd_blocked.flat_stage_table), each step one level past the last steps
// on its two rows, so a stage's pairs touch disjoint rows and every row
// meets its steps in their order, and the words are the step order's bit
// for bit.  Any schedule works: column-major (496 steps -> 61 stages at
// 32 x 32 with Q), the solve augmentation (391 -> 47), a flattened
// Sameh-Kuck order (as many stages as its own), or B5a's Sameh-Kuck stages
// as the caller gives them.
//
// Bound on this card: integer operations.  The tile is read once and
// written once (0.08 ms of bytes at (8192, 32, 64) at 3.35 TB/s) against
// some 1136 32-bit operations per rotated element pair (7.45 ms at the SM
// issue rate; chip_smoke.py counts them).  Nothing maps onto tensor cores
// (bit-exact integer recurrences, no product) or TMA (one read, one
// write), so the design cuts issue slots and the sequential depth:
//  * One thread per pair vectors the lead once and keeps the control word
//    (flip, sigma) in shared memory: 61 warp-vectorings a 32 x 32 matrix
//    with Q, where every thread of a row repeating it would issue 992.
//  * The replay spreads over the stage's live (pair, column) items only
//    (wf::run_item_stages, stage_bodies.cuh), so no lane idles on a column
//    left of a lead; the pair steps are B5a's (wf::PackedStage).
//  * One block holds `tile_b` matrices (blockDim.y), each with blockDim.x
//    threads; two barriers a stage.  The wrapper widens blockDim.x for a
//    batch too small to fill the card (qrd_blocked._flat_threads).
//  * The m x e tile lives in dynamic shared memory, or, when the block's
//    tiles and control words exceed 232448 bytes (128 x 128 with Q), in
//    place in device memory (`in` copied to `out` once, kShared = false),
//    through the L1 and L2 caches; the control words stay in shared memory.
#include <cuda_runtime.h>

#include "qr_tile.cuh"
#include "stage_bodies.cuh"
#include "stage_loop.cuh"

using gru::i64;
using gru::UnitParams;

template <bool kShared>
__global__ void qr_packed_kernel(const i64* __restrict__ in, i64* out,
                                 wf::Tables t, int B, int m, int e,
                                 UnitParams u) {
  extern __shared__ i64 flat_smem64[];
  const long long me = (long long)m * e;
  const long long b = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = b < B;  // the ragged edge of the last block
  i64* ctrl = flat_smem64 + (kShared ? (long long)blockDim.y * me : 0) +
              (long long)threadIdx.y * t.P * 2;
  i64* T = kShared ? flat_smem64 + threadIdx.y * me
                   : out + (live ? b : 0) * me;
  if (live) gru::copy_tile(T, e, in + b * me, e, m, e);
  __syncthreads();
  wf::run_item_stages(t, m, e, live, wf::PackedStage{T, e, &u, ctrl});
  if (kShared && live) gru::copy_tile(out + b * me, e, T, e, m, e);
}

extern "C" {

// Launches on `stream`; returns the CUDA error of the launch (0 on
// success).  `tables` is the (4, S, P) int32 stage table of
// qrd_blocked.flat_stage_table.  With device_tile the working tiles live
// in `out` (device memory), not in shared memory; the control words stay
// in shared memory.
int qr_packed_launch(const void* in, void* out, const void* tables, int B,
                     int m, int e, int S, int P, int tile_b, int threads_x,
                     int device_tile, int man_bits, int exp_bits,
                     long long bias, long long max_exp_raw, int N, int iters,
                     int hub, int rne, int unbiased, int detect_identity,
                     long long comp, int p, void* stream) {
  const UnitParams u = {man_bits, exp_bits, bias, max_exp_raw, N, iters, hub,
                        rne, unbiased, detect_identity, comp, p};
  const wf::Tables t = {(const int*)tables, (long long)S * P, P, S, P};
  const dim3 block(threads_x, tile_b);
  const dim3 grid((B + tile_b - 1) / tile_b);
  const size_t ctrl = (size_t)tile_b * P * 2 * sizeof(i64);
  if (device_tile) {
    cudaError_t err = cudaFuncSetAttribute(
        qr_packed_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)ctrl);
    if (err != cudaSuccess) return (int)err;
    qr_packed_kernel<false><<<grid, block, ctrl, (cudaStream_t)stream>>>(
        (const i64*)in, (i64*)out, t, B, m, e, u);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)tile_b * m * e * sizeof(i64) + ctrl;
  cudaError_t err = cudaFuncSetAttribute(
      qr_packed_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  qr_packed_kernel<true><<<grid, block, smem, (cudaStream_t)stream>>>(
      (const i64*)in, (i64*)out, t, B, m, e, u);
  return (int)cudaGetLastError();
}

const char* qr_packed_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
