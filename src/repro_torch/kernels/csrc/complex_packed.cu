// Complex Givens QR over packed (re, im) words: the three-rotation
// decomposition in levelized and in Sameh-Kuck stages, bit-exact to the
// unit.
//
// Replaces: src/repro/kernels/qrd_blocked.py,
//   _qr_packed_complex_kernel / qr_packed_complex_call (B7a), whose body is
//   GivensUnit.rotate_rows_complex, and
//   _qr_packed_complex_wavefront_kernel / qr_packed_complex_wavefront_call
//   (B7b), one scan step per Sameh-Kuck stage (_wavefront_scan_complex).
//
// What it computes, for each rotation (rows k, j from lead column c) of a
// schedule: phase vectoring on the lead (re, im) words of both rows (a row
// whose lead imaginary word is +-0 skips its phase rotation), the real
// Givens vectoring on the two realized leads, then on every element from
// column c on the two phase words replayed on each row's (re, im) pair and
// the real word replayed on the (x, y) pair of each lane.  On the lead the
// replays give the vectoring results; the pivot's imaginary lane and both
// lanes of the target are then forced to 0.  Equal to
// qr_packed_complex_reference (the loop of rotate_rows_complex, which
// writes the lead from the vectoring results) and to
// qr_packed_complex_wavefront_reference (which re-reads the realized lead
// from the phase-rotated row, the same word).
//
// Bound on this card: integer operations.  Each complex element column of a
// rotation costs four packed pair rotations (two phase replays, the real
// rotation on each lane) against one for qr_packed.cu, on twice the bytes,
// so the bound is four times B1's at the same (m, e).
//
// Design:
//  * B7a runs any step schedule in levelized stages: the wrapper levelizes
//    the steps (qrd_blocked.flat_stage_table), each step one level past the
//    last steps on its two rows, so a stage's pairs touch disjoint rows and
//    every row meets its steps in their order; the words are the step
//    order's bit for bit.  Column-major at 32 x (32 + 32): 496 steps -> 61
//    stages; the solve's 391 -> 47; 8128 -> 253 at 128 x (128 + 128).  Its
//    loop is the flat kernels' (stage_bodies.cuh) with the lead in two
//    rounds, wf::run_split_item_stages: two threads per pair run the two
//    phase vectorings, a barrier, one thread the real vectoring, into the
//    pair's 8-word record in shared memory (faster at both of the complex
//    path's shapes than one thread running all three); then the matrix's
//    threads replay the three control words over the stage's live (pair,
//    column) items only (wf::replay_items), each doing the four replays
//    of one complex element pair; three barriers a stage.  The wrapper
//    widens a small batch's blocks (qrd_blocked._flat_threads); at most 64
//    registers a thread keep a 1024-thread block launchable.
//  * B7b runs the (3, S, P) Sameh-Kuck stage table with wf::run_stages on
//    the same pair step (wf::ComplexStage), spread over (pair, column);
//    its lead runs all three vectorings on one thread, in registers.
//  * The (m, e, 2) tile of each matrix lives in dynamic shared memory, or,
//    when the block's tiles do not fit (128 x 256 x 2 int64 is 512 KiB), in
//    place in device memory (`in` copied to `out` once, kShared = false).
#include <cuda_runtime.h>

#include "qr_tile.cuh"
#include "stage_bodies.cuh"
#include "stage_loop.cuh"

using gru::i64;
using gru::UnitParams;
using wf::kComplexCtrlWords;

// The factorization of the block's tiles, (m, e, 2) each: in dynamic shared
// memory (kShared) or in place in `out`; kFlat: B7a's loop on the (4, S, P)
// levelized table, else B7b's on the (3, S, P) Sameh-Kuck table.
template <bool kShared, bool kFlat>
__device__ __forceinline__ void factor_tiles(const i64* __restrict__ in,
                                             i64* out, const wf::Tables& t,
                                             int B, int m, int e,
                                             const UnitParams& u) {
  extern __shared__ i64 cx_smem[];
  const long long me = (long long)m * e * 2;
  const long long b = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = b < B;  // the ragged edge of the last block
  i64* ctrl = cx_smem + (kShared ? (long long)blockDim.y * me : 0) +
              (long long)threadIdx.y * t.P * kComplexCtrlWords;
  i64* T = kShared ? cx_smem + threadIdx.y * me : out + (live ? b : 0) * me;
  if (live) gru::copy_tile(T, 2 * e, in + b * me, 2 * e, m, 2 * e);
  __syncthreads();
  const wf::ComplexStage body{T, e, &u, ctrl};
  if (kFlat) {
    wf::run_split_item_stages(t, m, e, live, body);
  } else {
    wf::run_stages(t, m, e, live, body);
  }
  if (kShared && live) gru::copy_tile(out + b * me, 2 * e, T, 2 * e, m, 2 * e);
}

// B7a.  At most 64 registers a thread, so a block of up to 1024 threads
// launches (the wrapper widens a small batch's blocks).
template <bool kShared>
__global__ void __launch_bounds__(1024)
    qr_packed_complex_kernel(const i64* __restrict__ in, i64* out,
                             wf::Tables t, int B, int m, int e, UnitParams u) {
  factor_tiles<kShared, true>(in, out, t, B, m, e, u);
}

// B7b.
template <bool kShared>
__global__ void qr_packed_complex_wavefront_kernel(const i64* __restrict__ in,
                                                   i64* out, wf::Tables t,
                                                   int B, int m, int e,
                                                   UnitParams u) {
  factor_tiles<kShared, false>(in, out, t, B, m, e, u);
}

using Kernel = void (*)(const i64*, i64*, wf::Tables, int, int, int,
                        UnitParams);

static int launch(Kernel shared, Kernel device, const void* in, void* out,
                  const wf::Tables& t, int B, int m, int e, int tile_b,
                  int threads_x, int device_tile, const UnitParams& u,
                  void* stream) {
  const dim3 block(threads_x, tile_b);
  const dim3 grid((B + tile_b - 1) / tile_b);
  const size_t ctrl = (size_t)tile_b * t.P * kComplexCtrlWords * sizeof(i64);
  const size_t smem =
      device_tile ? ctrl : (size_t)tile_b * m * e * 2 * sizeof(i64) + ctrl;
  const Kernel kernel = device_tile ? device : shared;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>((const i64*)in,
                                                      (i64*)out, t, B, m, e, u);
  return (int)cudaGetLastError();
}

extern "C" {

// Each launches on `stream` and returns the CUDA error of the launch (0 on
// success).  B7a takes the (4, S, P) stage table of
// qrd_blocked.flat_stage_table, B7b the (3, S, P) Sameh-Kuck stage table.
// With device_tile the working tiles live in `out` (device memory).
int qr_packed_complex_launch(const void* in, void* out, const void* tables,
                             int B, int m, int e, int S, int P, int tile_b,
                             int threads_x, int device_tile, int man_bits,
                             int exp_bits, long long bias,
                             long long max_exp_raw, int N, int iters, int hub,
                             int rne, int unbiased, int detect_identity,
                             long long comp, int p, void* stream) {
  const UnitParams u = {man_bits, exp_bits, bias, max_exp_raw, N, iters, hub,
                        rne, unbiased, detect_identity, comp, p};
  const wf::Tables t = {(const int*)tables, (long long)S * P, P, S, P};
  return launch(qr_packed_complex_kernel<true>, qr_packed_complex_kernel<false>,
                in, out, t, B, m, e, tile_b, threads_x, device_tile, u,
                stream);
}

int qr_packed_complex_wavefront_launch(
    const void* in, void* out, const void* tables, int B, int m, int e, int S,
    int P, int tile_b, int threads_x, int device_tile, int man_bits,
    int exp_bits, long long bias, long long max_exp_raw, int N, int iters,
    int hub, int rne, int unbiased, int detect_identity, long long comp, int p,
    void* stream) {
  const UnitParams u = {man_bits, exp_bits, bias, max_exp_raw, N, iters, hub,
                        rne, unbiased, detect_identity, comp, p};
  const wf::Tables t = {(const int*)tables, (long long)S * P, P, S, P};
  return launch(qr_packed_complex_wavefront_kernel<true>,
                qr_packed_complex_wavefront_kernel<false>, in, out, t, B, m, e,
                tile_b, threads_x, device_tile, u, stream);
}

const char* complex_packed_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
