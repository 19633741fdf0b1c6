// Complex Givens QR over packed (re, im) words: the three-rotation
// decomposition, step by step and stage by stage, bit-exact to the unit.
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
// Design (simple first; speed is later work):
//  * Both kernels are one stage loop, wf::run_stages (stage_loop.cuh): B7a
//    runs its (S, 3) step table as S stages of one pair, B7b the (3, S, P)
//    Sameh-Kuck stage table.  Per stage, one thread per pair computes the
//    three control words (two phase words with their skip flags, the real
//    word) into shared memory; then the block's threads spread over (pair,
//    column), each doing the four replays of one complex element pair;
//    two barriers a stage.
//  * The (m, e, 2) tile of each matrix lives in dynamic shared memory, or,
//    when the block's tiles do not fit (128 x 256 x 2 int64 is 512 KiB), in
//    place in device memory (`in` copied to `out` once, kShared = false).
#include <cuda_runtime.h>

#include "givens_unit.cuh"
#include "qr_tile.cuh"
#include "stage_loop.cuh"

using gru::i64;
using gru::UnitParams;

// Words of the control record of one pair in shared memory.
constexpr int kCtrlWords = 8;

// The complex step of one pair; element (r, c, lane) of the tile at
// T[(r * ld + c) * 2 + lane].  ctrl per pair: the pivot row's phase word
// and skip flag, the target row's, and the real word.
struct ComplexStage {
  i64* T;
  int ld;
  const UnitParams* u;
  i64* ctrl;
  __device__ __forceinline__ void lead(int, int p, int k, int j,
                                       int c) const {
    const i64* x = T + (k * ld + c) * 2;
    const i64* y = T + (j * ld + c) * 2;
    i64* w = ctrl + kCtrlWords * p;
    i64 magx, magy, xf, yf, m_exp;
    bool skx, sky;
    gru::phase_vector(x[0], x[1], *u, magx, w[0], w[1], skx);
    gru::phase_vector(y[0], y[1], *u, magy, w[3], w[4], sky);
    w[2] = skx;
    w[5] = sky;
    gru::to_fixed(magx, magy, *u, xf, yf, m_exp);
    gru::vectoring(xf, yf, *u, w[6], w[7]);
  }
  __device__ __forceinline__ void element(int p, int k, int j, int c,
                                          int idx) const {
    i64* x = T + (k * ld + idx) * 2;
    i64* y = T + (j * ld + idx) * 2;
    const i64* w = ctrl + kCtrlWords * p;
    i64 xr = x[0], xi = x[1], yr = y[0], yi = y[1];
    gru::phase_rotate(xr, xi, *u, w[0], w[1], w[2] != 0);
    gru::phase_rotate(yr, yi, *u, w[3], w[4], w[5] != 0);
    gru::rotate_pair(xr, yr, *u, w[6], w[7]);
    gru::rotate_pair(xi, yi, *u, w[6], w[7]);
    if (idx == c) {  // structural zeros: the realized pivot is real
      xi = 0;
      yr = 0;
      yi = 0;
    }
    x[0] = xr;
    x[1] = xi;
    y[0] = yr;
    y[1] = yi;
  }
};

template <bool kShared>
__global__ void qr_packed_complex_kernel(const i64* __restrict__ in, i64* out,
                                         wf::Tables t, int B, int m, int e,
                                         UnitParams u) {
  extern __shared__ i64 cx_smem[];
  const long long me = (long long)m * e * 2;
  const long long b = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = b < B;  // the ragged edge of the last block
  i64* ctrl = cx_smem + (kShared ? (long long)blockDim.y * me : 0) +
              (long long)threadIdx.y * t.P * kCtrlWords;
  i64* T = kShared ? cx_smem + threadIdx.y * me : out + (live ? b : 0) * me;
  if (live) gru::copy_tile(T, 2 * e, in + b * me, 2 * e, m, 2 * e);
  __syncthreads();
  wf::run_stages(t, m, e, live, ComplexStage{T, e, &u, ctrl});
  if (kShared && live) gru::copy_tile(out + b * me, 2 * e, T, 2 * e, m, 2 * e);
}

static int launch(const void* in, void* out, const wf::Tables& t, int B, int m,
                  int e, int tile_b, int threads_x, int device_tile,
                  const UnitParams& u, void* stream) {
  const dim3 block(threads_x, tile_b);
  const dim3 grid((B + tile_b - 1) / tile_b);
  const size_t ctrl = (size_t)tile_b * t.P * kCtrlWords * sizeof(i64);
  if (device_tile) {
    cudaError_t err = cudaFuncSetAttribute(
        qr_packed_complex_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ctrl);
    if (err != cudaSuccess) return (int)err;
    qr_packed_complex_kernel<false><<<grid, block, ctrl, (cudaStream_t)stream>>>(
        (const i64*)in, (i64*)out, t, B, m, e, u);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)tile_b * m * e * 2 * sizeof(i64) + ctrl;
  cudaError_t err = cudaFuncSetAttribute(
      qr_packed_complex_kernel<true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  qr_packed_complex_kernel<true><<<grid, block, smem, (cudaStream_t)stream>>>(
      (const i64*)in, (i64*)out, t, B, m, e, u);
  return (int)cudaGetLastError();
}

extern "C" {

// Each launches on `stream` and returns the CUDA error of the launch (0 on
// success).  B7a takes the (S, 3) step table, B7b the (3, S, P) stage
// table.  With device_tile the working tiles live in `out` (device memory).
int qr_packed_complex_launch(const void* in, void* out, const void* steps,
                             int B, int m, int e, int S, int tile_b,
                             int threads_x, int device_tile, int man_bits,
                             int exp_bits, long long bias,
                             long long max_exp_raw, int N, int iters, int hub,
                             int rne, int unbiased, int detect_identity,
                             long long comp, int p, void* stream) {
  const UnitParams u = {man_bits, exp_bits, bias, max_exp_raw, N, iters, hub,
                        rne, unbiased, detect_identity, comp, p};
  const wf::Tables t = {(const int*)steps, 1, 3, S, 1};
  return launch(in, out, t, B, m, e, tile_b, threads_x, device_tile, u,
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
  return launch(in, out, t, B, m, e, tile_b, threads_x, device_tile, u,
                stream);
}

const char* complex_packed_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
