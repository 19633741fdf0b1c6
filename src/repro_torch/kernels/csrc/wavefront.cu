// Sameh-Kuck wavefront QR on int32 block-FP significands, one resident
// tile per matrix: every pair of a stage rotated at once.  (B5a, its packed
// twin, runs on qr_packed.cu's kernel since the stages carry their item
// ends; see qrd_blocked.qr_packed_wavefront_call.)
//
// Replaces: src/repro/kernels/qrd_blocked.py,
//   _qr_blockfp_wavefront_kernel / qr_blockfp_wavefront_call (B5b), the
//   lax.scan over stages of _wavefront_scan; its body is
//   cordic_givens.fused_rotate_pairs.
//
// What it computes: for each stage of (S, P) pivot, target and column
// tables (padded with pivot row m), every pair's rows rotated from its lead
// column on: vectoring on the lead pair gives the control word (flip,
// sigma), which is replayed on every element of both rows (on the lead it
// gives the vectoring result), and the target lead is forced to 0.  Equal
// to qr_blockfp_wavefront_reference, and so to qr_blockfp on the flattened
// stage schedule: the pairs of a stage touch disjoint rows, and each
// pair's words are those of its step.
//
// Bound on this card: integer operations, as for blockfp.cu: the same
// elements are rotated as on the flat kernel at the same shape, so the
// bound is its.  Its sequential depth is its too: 61 stages at 32 x 32,
// which the flat kernel reaches by levelizing the 496 column-major steps.
//
// Design (simple first; speed is later work):
//  * One block holds `tile_b` matrices (blockDim.y); the stage loop is
//    wf::run_stages (stage_loop.cuh) on the pair step of stage_bodies.cuh,
//    shared with the flat kernel: one thread per pair computes the pair's
//    control word into shared memory, then the block's threads spread over
//    (pair, column) and replay it; two barriers a stage.
//  * The int32 tile lives in dynamic shared memory (at most 128 KiB).
#include <cuda_runtime.h>

#include "stage_bodies.cuh"
#include "stage_loop.cuh"

using bfp::i32;

__global__ void qr_blockfp_wavefront_kernel(const i32* __restrict__ in,
                                            i32* out, wf::Tables t, int B,
                                            int m, int e, bfp::Params u) {
  extern __shared__ i32 wf_smem32[];
  const long long me = (long long)m * e;
  const long long b = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = b < B;  // the ragged edge of the last block
  i32* T = wf_smem32 + threadIdx.y * me;
  i32* ctrl = wf_smem32 + (long long)blockDim.y * me +
              (long long)threadIdx.y * t.P * 2;
  if (live) bfp::copy_tile(T, e, in + b * me, e, m, e);
  __syncthreads();
  wf::run_stages(t, m, e, live, wf::BlockfpStage{T, e, &u, ctrl});
  if (live) bfp::copy_tile(out + b * me, e, T, e, m, e);
}

extern "C" {

// Launches on `stream` and returns the CUDA error of the launch (0 on
// success).  `tables` is the (3, S, P) int32 stage table.
int qr_blockfp_wavefront_launch(const void* in, void* out, const void* tables,
                                int B, int m, int e, int S, int P, int tile_b,
                                int threads_x, int iters, int hub, int comp,
                                void* stream) {
  const bfp::Params u = {iters, hub, comp};
  const wf::Tables t = {(const int*)tables, (long long)S * P, P, S, P};
  const dim3 block(threads_x, tile_b);
  const dim3 grid((B + tile_b - 1) / tile_b);
  const size_t smem = (size_t)tile_b * (m * e + P * 2) * sizeof(i32);
  cudaError_t err = cudaFuncSetAttribute(
      qr_blockfp_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  qr_blockfp_wavefront_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const i32*)in, (i32*)out, t, B, m, e, u);
  return (int)cudaGetLastError();
}

const char* wavefront_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
