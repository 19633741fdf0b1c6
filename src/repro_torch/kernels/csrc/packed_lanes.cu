// Kernel-resident Givens QR over packed FP words carried as dual int32
// lanes: every 64-bit operation of the unit done on (hi, lo) halves with
// 32-bit instructions (lane_unit.cuh), bit-exact to the int64 kernels.
//
// Replaces: src/repro/kernels/qrd_blocked.py,
//   _qr_packed_lanes_kernel / qr_packed_lanes_call (B8a), the step-serial
//   QR of qr_packed_call on the (TB, m, e, 2) hi/lo lane tile, and
//   _qr_packed_lanes_wavefront_kernel / qr_packed_lanes_wavefront_call on
//   _wavefront_scan_lanes (B8b), the Sameh-Kuck wavefront on the same
//   tile.  Both bodies are packed_lanes.LaneUnit.
//
// What it computes: for each step (B8a, an (S, 3) step table) or each
// stage of disjoint pairs (B8b, a (3, S, P) stage table padded with pivot
// row m), vectoring on the lead pair gives the control word (flip, sigma),
// which is replayed on every element of both rows from the lead column on
// (on the lead it gives the vectoring result), and the target lead is
// forced to 0 on both lanes.  The output words equal the plain versions'
// (qr_packed_lanes_reference, qr_packed_lanes_wavefront_reference), and
// through lanes_to_packed those of qr_packed.cu (B1 and B5a) on the same
// words.
//
// Bound on this card: integer operations, as for qr_packed.cu: the same
// elements are rotated at the same shapes, so the bound is B1's (B5a's
// for the wavefront).  The int64 kernels already compile each 64-bit
// operation into 32-bit pairs; this source writes those pairs out, as the
// TPU kernel had to, and so measures what the int64-on-int32 emulation of
// the JAX package costs on Hopper against the compiler's own.
//
// Design (simple first; speed is later work):
//  * Both kernels are one stage loop, wf::run_stages (stage_loop.cuh): a
//    step-serial schedule is a schedule of stages of one pair.  One thread
//    per pair vectors the lead once into shared memory, then the block's
//    threads spread over (pair, column) and replay it; two barriers a
//    stage.
//  * One block holds `tile_b` matrices (blockDim.y).  The (m, e) tile of
//    (hi, lo) words, 8 bytes a word as in B1, lives in dynamic shared
//    memory and is loaded and stored as int2; when the block's tiles do
//    not fit (128 x 256 with Q is 256 KiB) it is factorized in place in
//    device memory (`in` copied to `out` once, kShared = false), as in
//    qr_packed.cu.  The control words, (flip, sigma hi, sigma lo) per
//    pair, stay in shared memory in both modes.
#include <cuda_runtime.h>

#include "lane_unit.cuh"
#include "stage_loop.cuh"

using lane::Params;
using lane::u32;
using lane::W;

// Copies a rows x e tile of lane words between two buffers (row stride e),
// one 8-byte int2 a word; the threads of a row stride over the words.
__device__ __forceinline__ void copy_lane_tile(W* dst, const W* src, int rows,
                                               int e) {
  const int2* s = reinterpret_cast<const int2*>(src);
  int2* d = reinterpret_cast<int2*>(dst);
  for (int idx = threadIdx.x; idx < rows * e; idx += blockDim.x) d[idx] = s[idx];
}

// One pair's step: LaneUnit.vector on the lead pair into ctrl (4 words a
// pair: flip, sigma hi, sigma lo, unused), LaneUnit.rotate of it on each
// element.
struct LaneStage {
  W* T;
  int ld;
  const Params* u;
  u32* ctrl;
  __device__ __forceinline__ void lead(int, int p, int k, int j,
                                       int c) const {
    W x, y, sig;
    int m_exp;
    u32 flip;
    lane::input_convert(T[k * ld + c], T[j * ld + c], *u, x, y, m_exp);
    lane::vectoring(x, y, *u, flip, sig);
    ctrl[4 * p] = flip;
    ctrl[4 * p + 1] = sig.hi;
    ctrl[4 * p + 2] = sig.lo;
  }
  __device__ __forceinline__ void element(int p, int k, int j, int c,
                                          int idx) const {
    W& x = T[k * ld + idx];
    W& y = T[j * ld + idx];
    lane::rotate_pair(x, y, *u, ctrl[4 * p],
                      lane::mk(ctrl[4 * p + 1], ctrl[4 * p + 2]));
    if (idx == c) y = lane::low(0u);  // structural zero (both lanes)
  }
};

template <bool kShared>
__global__ void qr_packed_lanes_kernel(const W* __restrict__ in, W* out,
                                       wf::Tables t, int B, int m, int e,
                                       Params u) {
  extern __shared__ int2 lane_smem[];
  const size_t me = (size_t)m * e;  // offsets are addresses, not datapath
  const size_t b = (size_t)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = b < (size_t)B;  // the ragged edge of the last block
  W* tiles = reinterpret_cast<W*>(lane_smem);
  u32* ctrl = reinterpret_cast<u32*>(tiles + (kShared ? blockDim.y * me : 0)) +
              (size_t)threadIdx.y * t.P * 4;
  W* T = kShared ? tiles + threadIdx.y * me : out + (live ? b : 0) * me;
  if (live) copy_lane_tile(T, in + b * me, m, e);
  __syncthreads();
  wf::run_stages(t, m, e, live, LaneStage{T, e, &u, ctrl});
  if (kShared && live) copy_lane_tile(out + b * me, T, m, e);
}

// Launches the kernel on the tables `t`; returns the CUDA error of the
// launch (0 on success).
static int launch(const void* in, void* out, const wf::Tables& t, int B, int m,
                  int e, int tile_b, int threads_x, int device_tile,
                  const Params& u, void* stream) {
  const dim3 block(threads_x, tile_b);
  const dim3 grid((B + tile_b - 1) / tile_b);
  const size_t ctrl = (size_t)tile_b * t.P * 4 * sizeof(u32);
  const size_t smem = ctrl + (device_tile ? 0 : (size_t)tile_b * m * e * sizeof(W));
  if (device_tile) {
    cudaError_t err = cudaFuncSetAttribute(
        qr_packed_lanes_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    qr_packed_lanes_kernel<false><<<grid, block, smem, (cudaStream_t)stream>>>(
        (const W*)in, (W*)out, t, B, m, e, u);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      qr_packed_lanes_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  qr_packed_lanes_kernel<true><<<grid, block, smem, (cudaStream_t)stream>>>(
      (const W*)in, (W*)out, t, B, m, e, u);
  return (int)cudaGetLastError();
}

extern "C" {

// B8a: `steps` is the (S, 3) int32 step table, S stages of one pair.  With
// device_tile the working tiles live in `out` (device memory).
int qr_packed_lanes_launch(const void* in, void* out, const void* steps, int B,
                           int m, int e, int S, int tile_b, int threads_x,
                           int device_tile, int man_bits, int exp_bits,
                           int bias, int max_exp_raw, int N, int iters,
                           int hub, int rne, int unbiased, int detect_identity,
                           unsigned comp_hi, unsigned comp_lo, int p,
                           void* stream) {
  const Params u = {man_bits, exp_bits, bias, max_exp_raw, N, iters, hub, rne,
                    unbiased, detect_identity, comp_hi, comp_lo, p};
  const wf::Tables t = {(const int*)steps, 1, 3, S, 1};
  return launch(in, out, t, B, m, e, tile_b, threads_x, device_tile, u, stream);
}

// B8b: `tables` is the (3, S, P) int32 stage table.
int qr_packed_lanes_wavefront_launch(const void* in, void* out,
                                     const void* tables, int B, int m, int e,
                                     int S, int P, int tile_b, int threads_x,
                                     int device_tile, int man_bits,
                                     int exp_bits, int bias, int max_exp_raw,
                                     int N, int iters, int hub, int rne,
                                     int unbiased, int detect_identity,
                                     unsigned comp_hi, unsigned comp_lo, int p,
                                     void* stream) {
  const Params u = {man_bits, exp_bits, bias, max_exp_raw, N, iters, hub, rne,
                    unbiased, detect_identity, comp_hi, comp_lo, p};
  const wf::Tables t = {(const int*)tables, S * P, P, S, P};
  return launch(in, out, t, B, m, e, tile_b, threads_x, device_tile, u, stream);
}

const char* packed_lanes_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
