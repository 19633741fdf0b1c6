// Blocked QR over int32 block-FP significands: the flat kernel, the panel
// factorization that exports each rotation's control word, and the replay
// of those words over the trailing columns.  Bit-exact to the plain
// versions in repro_torch/kernels/qrd_blocked.py.
//
// Replaces: src/repro/kernels/qrd_blocked.py,
//   _qr_blockfp_kernel / qr_blockfp_call (B2),
//   _panel_factor_blockfp_kernel / panel_factor_blockfp_call (B4a) and
//   _panel_apply_blockfp_kernel / panel_apply_blockfp_call (B4b); their
//   bodies are cordic_givens.fused_rotate_block, fused_rotate_ctrl and
//   fused_replay.
//
// What it computes:
//  * qr_blockfp: for each (k, j, col) step of a schedule read at run time
//    (column-major, the RLS annihilation order, or any other), the fused
//    step on rows k and j from column col, then the target lead forced to
//    0, run in the stages of qrd_blocked.flat_stage_table (as qr_packed.cu
//    does; the words are the step order's).  Equal to
//    qr_blockfp_reference.
//  * panel_factor_blockfp: the fused steps on an mr x pw panel, run in the
//    stages of ops.panel_stages (qrd_blocked.levelize_steps, as
//    panel_packed.cu runs them; the words are the step order's), writing
//    each step's (flip, sigma) as int32 into the (B, S) outputs in step
//    order.  Equal to panel_factor_blockfp_reference: the JAX body rotates
//    at uniform width and restores the lanes left of the lead; here those
//    lanes are simply not touched.
//  * panel_apply_blockfp: every (piv, tgt, flip, sigma) step replayed on
//    the trailing mr x w region.  Equal to panel_apply_blockfp_reference.
// Panel by panel the last two run the flat kernel's column-major steps in
// the same order, so their words equal its words.
//
// Bound on this card: integer operations.  A rotated element costs about
// 11 int32 operations per micro-rotation (HUB) and 12 for the gain
// compensation, some 280 at iters = 24, against one 4-byte read and one
// write of each significand for the whole factorization (3.02 ms of
// operations against 0.04 ms of bytes at (8192, 32, 64)); nothing maps
// onto tensor cores or TMA.
//
// Design:
//  * qr_blockfp: one block holds `tile_b` matrices (blockDim.y), each m x e
//    tile and its stage's control words in dynamic shared memory for the
//    whole factorization.  On the routes resolve_route allows, the largest
//    tile is 128 x 256 int32 (128 KiB), under a block's 227 KB, so there
//    is no device-memory mode; the wrapper caps tile_b to shared memory
//    and refuses a larger one.  The stage loop is qr_packed.cu's
//    (wf::run_item_stages on wf::BlockfpStage, B5b's pair step): one
//    thread per pair vectors the lead once, then the matrix's threads
//    replay the control word over the stage's live (pair, column) items;
//    two barriers a stage.
//  * panel_factor_blockfp runs the panel's (4, S', P) stage table (pivot,
//    target, column, step index; 2016 steps -> 335 stages a panel call at
//    (1024, 64, 64), 11168 -> 1648 a TSQR call at (32, 4096, 32)) with
//    wf::run_stages on B2's pair step: one thread per pair vectors the
//    lead once and writes the control word to shared memory and to
//    flip/sig at the pair's step index, then the panel's threads spread
//    over (pair, column) and replay it; two barriers a stage.  One block
//    holds `tile_b` panels (blockDim.y) and their control words in shared
//    memory; the wrapper caps tile_b.
//  * panel_factor_blockfp and panel_apply_blockfp work in place on
//    row-strided views of the (B, m, e) working buffer (batch stride sb,
//    row stride ld, unit column stride), as panel_packed.cu does.  The
//    apply gives one thread one column of one matrix for all S steps, with
//    no barrier.
#include <cuda_runtime.h>

#include "blockfp_unit.cuh"
#include "stage_bodies.cuh"
#include "stage_loop.cuh"

using bfp::i32;
using bfp::Params;

__global__ void qr_blockfp_kernel(const i32* __restrict__ in, i32* out,
                                  wf::Tables t, int B, int m, int e,
                                  Params u) {
  extern __shared__ i32 flat_smem32[];
  const long long me = (long long)m * e;
  const long long b = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = b < B;  // the ragged edge of the last block
  i32* T = flat_smem32 + threadIdx.y * me;
  i32* ctrl = flat_smem32 + (long long)blockDim.y * me +
              (long long)threadIdx.y * t.P * 2;
  if (live) bfp::copy_tile(T, e, in + b * me, e, m, e);
  __syncthreads();
  wf::run_item_stages(t, m, e, live, wf::BlockfpStage{T, e, &u, ctrl});
  if (live) bfp::copy_tile(out + b * me, e, T, e, m, e);
}

// B4a's pair step: B2's (wf::BlockfpStage), its control word also written
// to this panel's (S,) outputs at the pair's step index, in step order for
// panel_apply_blockfp.
struct PanelBlockfpStage : wf::BlockfpStage {
  const int* step;  // the (S', P) step indices: entry p of stage s at s * P + p
  int P;
  i32* flip;
  i32* sig;
  __device__ __forceinline__ void lead(int s, int p, int k, int j,
                                       int c) const {
    wf::BlockfpStage::lead(s, p, k, j, c);
    const int st = __ldg(step + s * P + p);
    flip[st] = ctrl[2 * p];
    sig[st] = ctrl[2 * p + 1];
  }
};

__global__ void panel_factor_blockfp_kernel(i32* P, long long sb, long long ld,
                                            int B, int mr, int pw,
                                            wf::Tables t, int S,
                                            i32* __restrict__ flip,
                                            i32* __restrict__ sig, Params u) {
  extern __shared__ i32 panel_smem32[];
  const long long b = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = b < B;  // the ragged edge of the last block
  i32* src = P + (live ? b : 0) * sb;
  i32* T = panel_smem32 + (long long)threadIdx.y * mr * pw;
  i32* ctrl = panel_smem32 + (long long)blockDim.y * mr * pw +
              (long long)threadIdx.y * t.P * 2;
  if (live) bfp::copy_tile(T, pw, src, ld, mr, pw);
  __syncthreads();
  const long long o = (live ? b : 0) * S;
  const PanelBlockfpStage body{{T, pw, &u, ctrl}, t.tab + 3 * t.ts, t.ss,
                               flip + o, sig + o};
  wf::run_stages(t, mr, pw, live, body);
  if (live) bfp::copy_tile(src, ld, T, pw, mr, pw);
}

__global__ void panel_apply_blockfp_kernel(i32* P, long long sb, long long ld,
                                           int w, const int* __restrict__ piv,
                                           const int* __restrict__ tgt, int S,
                                           const i32* __restrict__ flip,
                                           const i32* __restrict__ sig,
                                           Params u) {
  const long long b = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= w) return;
  i32* T = P + b * sb + c;
  const i32* f = flip + b * S;
  const i32* g = sig + b * S;
  for (int s = 0; s < S; ++s) {
    i32* px = T + __ldg(piv + s) * ld;
    i32* py = T + __ldg(tgt + s) * ld;
    i32 x = *px, y = *py;
    bfp::replay(x, y, u, __ldg(f + s), __ldg(g + s));
    *px = x;
    *py = y;
  }
}

extern "C" {

// Each launches on `stream` and returns the CUDA error of the launch (0 on
// success).
int qr_blockfp_launch(const void* in, void* out, const void* tables, int B,
                      int m, int e, int S, int P, int tile_b, int threads_x,
                      int iters, int hub, int comp, void* stream) {
  const Params u = {iters, hub, comp};
  const wf::Tables t = {(const int*)tables, (long long)S * P, P, S, P};
  const dim3 block(threads_x, tile_b);
  const dim3 grid((B + tile_b - 1) / tile_b);
  const size_t smem = (size_t)tile_b * ((size_t)m * e + 2 * P) * sizeof(i32);
  cudaError_t err = cudaFuncSetAttribute(
      qr_blockfp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  qr_blockfp_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const i32*)in, (i32*)out, t, B, m, e, u);
  return (int)cudaGetLastError();
}

int panel_factor_blockfp_launch(void* P, long long sb, long long ld, int B,
                                int mr, int pw, const void* tables, int stages,
                                int pairs, int S, void* flip, void* sig,
                                int tile_b, int threads_x, int iters, int hub,
                                int comp, void* stream) {
  const Params u = {iters, hub, comp};
  const wf::Tables t = {(const int*)tables, (long long)stages * pairs, pairs,
                        stages, pairs};
  const dim3 block(threads_x, tile_b);
  const dim3 grid((B + tile_b - 1) / tile_b);
  const size_t smem = (size_t)tile_b * (mr * pw + 2 * pairs) * sizeof(i32);
  cudaError_t err = cudaFuncSetAttribute(
      panel_factor_blockfp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  panel_factor_blockfp_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (i32*)P, sb, ld, B, mr, pw, t, S, (i32*)flip, (i32*)sig, u);
  return (int)cudaGetLastError();
}

int panel_apply_blockfp_launch(void* P, long long sb, long long ld, int B,
                               int w, const void* piv, const void* tgt, int S,
                               const void* flip, const void* sig, int threads,
                               int iters, int hub, int comp, void* stream) {
  const Params u = {iters, hub, comp};
  const dim3 grid(B, (w + threads - 1) / threads);
  panel_apply_blockfp_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (i32*)P, sb, ld, w, (const int*)piv, (const int*)tgt, S,
      (const i32*)flip, (const i32*)sig, u);
  return (int)cudaGetLastError();
}

const char* blockfp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
