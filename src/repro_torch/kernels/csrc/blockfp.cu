// Blocked QR over int32 block-FP significands: the flat kernel, the panel
// factorization that exports each rotation's control word, and the replay
// of those words over the trailing columns.  Bit-exact to the plain
// versions in repro_torch/kernels/qrd_blocked.py.
//
// Replaces: src/repro/kernels/qrd_blocked.py,
//   _qr_blockfp_kernel / qr_blockfp_call (B2),
//   _panel_factor_blockfp_kernel / panel_factor_blockfp_call (B4a) and
//   _panel_apply_blockfp_kernel / panel_apply_blockfp_call (B4b), and
//   _qr_blockfp_wavefront_kernel / qr_blockfp_wavefront_call (B5b): the
//   Sameh-Kuck stages are disjoint pairs already, so B5b's wrapper gives
//   the flat kernel the caller's stages with their item ends
//   (qrd_blocked._wavefront_table) and counts its own launches.  Their
//   bodies are cordic_givens.fused_rotate_block, fused_rotate_ctrl,
//   fused_replay and fused_rotate_pairs.
//
// What it computes:
//  * qr_blockfp: for each (k, j, col) step of a schedule read at run time
//    (column-major, the RLS annihilation order, or any other), the fused
//    step on rows k and j from column col, then the target lead forced to
//    0, run in the stages of qrd_blocked.flat_stage_table (as qr_packed.cu
//    does; the words are the step order's).  Equal to
//    qr_blockfp_reference; on B5b's stages, to
//    qr_blockfp_wavefront_reference.
//  * panel_factor_blockfp: the fused steps on an mr x pw panel, run in the
//    stages of ops.panel_stages (qrd_blocked.levelize_steps, as
//    panel_packed.cu runs them; the words are the step order's), writing
//    each step's (flip, sigma) as int32 into the (B, S) outputs in step
//    order.  Equal to panel_factor_blockfp_reference: the JAX body rotates
//    at uniform width and restores the lanes left of the lead; here those
//    lanes are simply not touched.
//  * panel_apply_blockfp: every (piv, tgt, flip, sigma) step replayed on
//    the trailing mr x w region, in the same stages as the factor (the
//    words are the step order's).  Equal to panel_apply_blockfp_reference.
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
//    (wf::run_item_stages on wf::BlockfpStage): one thread per pair
//    vectors the lead once, then the matrix's threads replay the control
//    word over the stage's live (pair, column) items; two barriers a
//    stage.
//  * panel_factor_blockfp runs the panel's (4, S', P) stage table (pivot,
//    target, column, step index; 2016 steps -> 335 stages a panel call at
//    (1024, 64, 64), 11168 -> 1648 a TSQR call at (32, 4096, 32)) with
//    wf::run_stages on B2's pair step: one thread per pair vectors the
//    lead once and writes the control word to shared memory and to
//    flip/sig at the pair's step index, then the panel's threads spread
//    over (pair, column) and replay it; two barriers a stage.  One block
//    holds `tile_b` panels (blockDim.y) and their control words in shared
//    memory, the wrapper capping tile_b, or, for a panel beyond shared
//    memory (tile_m 4096 at panel_n 16: 256 KiB), works on the panels in
//    place in device memory with the control words in shared memory
//    (kShared = false), as panel_packed.cu does.
//  * panel_factor_blockfp and panel_apply_blockfp work in place on
//    row-strided views of the (B, m, e) working buffer (batch stride sb,
//    row stride ld, unit column stride), as panel_packed.cu does.
//  * panel_apply_blockfp runs the factor's (4, S', P) stage table (11168
//    steps -> 1648 stages a TSQR call).  A block holds up to 256 trailing
//    columns of one matrix in shared memory, read once and written once,
//    and stages each live pair's rows and (flip, sigma) there (8 B a pair)
//    with each stage's count of them, in windows of the stages that fit
//    beside the columns (all of them at once on the TSQR and panel paths;
//    a tall or wide panel takes several windows, two barriers each).  By
//    default one thread owns one column and replays each stage's live
//    pairs on it, 8, 4, 2 and 1 at a time: the pairs' rows are disjoint,
//    so the chains are independent and interleave, which hides the
//    micro-rotations' latency, and the stage loop has no barrier.  A column's dependent chain is S'
//    stages, not S steps.  For a grid too small to fill the card the
//    wrapper spreads a stage's pairs over 2-8 threads of a column
//    (blockDim.y), with one barrier a stage, and one warp of columns a
//    block.
#include <cuda_runtime.h>

#include "blockfp_unit.cuh"
#include "stage_bodies.cuh"
#include "stage_loop.cuh"

using bfp::i32;
using bfp::microrotation_mask;
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

// kShared: the block's panels are copied into shared memory and back;
// else the stages work on each panel where it lies (row stride ld, which
// the wrapper keeps within int with the panel's rows).  The control words
// are in shared memory either way.
template <bool kShared>
__global__ void panel_factor_blockfp_kernel(i32* P, long long sb, long long ld,
                                            int B, int mr, int pw,
                                            wf::Tables t, int S,
                                            i32* __restrict__ flip,
                                            i32* __restrict__ sig, Params u) {
  extern __shared__ i32 panel_smem32[];
  const long long b = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = b < B;  // the ragged edge of the last block
  i32* src = P + (live ? b : 0) * sb;
  i32* T = kShared ? panel_smem32 + (long long)threadIdx.y * mr * pw : src;
  i32* ctrl = panel_smem32 + (kShared ? (long long)blockDim.y * mr * pw : 0) +
              (long long)threadIdx.y * t.P * 2;
  if (kShared && live) bfp::copy_tile(T, pw, src, ld, mr, pw);
  __syncthreads();
  const long long o = (live ? b : 0) * S;
  const PanelBlockfpStage body{{T, kShared ? pw : (int)ld, &u, ctrl},
                               t.tab + 3 * t.ts, t.ss, flip + o, sig + o};
  wf::run_stages(t, mr, pw, live, body);
  if (kShared && live) bfp::copy_tile(src, ld, T, pw, mr, pw);
}

template <bool kShared>
static int factor_launch(dim3 grid, dim3 block, size_t smem,
                         cudaStream_t stream, i32* P, long long sb,
                         long long ld, int B, int mr, int pw,
                         const wf::Tables& t, int S, i32* flip, i32* sig,
                         const Params& u) {
  cudaError_t err = cudaFuncSetAttribute(
      panel_factor_blockfp_kernel<kShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  panel_factor_blockfp_kernel<kShared><<<grid, block, smem, stream>>>(
      P, sb, ld, B, mr, pw, t, S, flip, sig, u);
  return (int)cudaGetLastError();
}

// B4b's control table in shared memory: one record a pair of a stage.  x
// holds the pair's rows (pivot | target << 16), y its control word (sigma
// | flip << 31: sigma has at most 30 bits, the wrappers refuse iters > 30).
__device__ __forceinline__ int2 apply_record(const wf::Tables& t, long long o,
                                             const i32* f, const i32* g) {
  const int st = __ldg(t.tab + 3 * t.ts + o);
  const bfp::u32 word = ((bfp::u32)__ldg(g + st) & 0x3FFFFFFFu) |
                        (bfp::u32)(__ldg(f + st) != 0) << 31;
  return make_int2(__ldg(t.tab + o) | __ldg(t.tab + t.ts + o) << 16, (int)word);
}

// K pairs of one stage replayed on one column (rows r at col[r * C]): the
// pairs' rows are disjoint, so the K chains are independent and the
// compiler interleaves their micro-rotations.  rec steps by `stride`.
template <bool kHub, int K>
__device__ __forceinline__ void replay_pairs(i32* col, int C, const int2* rec,
                                             int stride, const Params& u) {
  i32 x[K], y[K], g[K];
  int kr[K], jr[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int2 r = rec[q * stride];
    kr[q] = (r.x & 0xFFFF) * C;
    jr[q] = (r.x >> 16) * C;
    g[q] = r.y;
    const bool flip = r.y < 0;
    x[q] = flip ? bfp::negate(col[kr[q]], kHub) : col[kr[q]];
    y[q] = flip ? bfp::negate(col[jr[q]], kHub) : col[jr[q]];
  }
  if (u.iters > 0) {  // micro-rotation 0: shift 0, HUB carries 1
#pragma unroll
    for (int q = 0; q < K; ++q) {
      microrotation_mask<kHub>(x[q], y[q], y[q], x[q], ~0, ~0,
                               -(g[q] & 1));
    }
  }
  for (int i = 1; i < u.iters; ++i) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      microrotation_mask<kHub>(x[q], y[q], y[q] >> i, x[q] >> i,
                               y[q] >> (i - 1), x[q] >> (i - 1),
                               -((g[q] >> i) & 1));
    }
  }
#pragma unroll
  for (int q = 0; q < K; ++q) {
    col[kr[q]] = bfp::gain_mul_q30(x[q], u.comp);
    col[jr[q]] = bfp::gain_mul_q30(y[q], u.comp);
  }
}

// B4b: a block holds C = blockDim.x trailing columns of one matrix in
// shared memory ([row][column]: a warp's lanes on consecutive words), and
// the records of a window of `window` stages' live pairs with each
// stage's count of them.  kWindows: the records are loaded window by
// window, between two barriers; else all S' stages fit one window, loaded
// once, and the stage loop runs once (a stage loop nested in a window
// loop read 3-5% slower on an H100 where one window holds all stages).
// Thread (x, gs) replays a stage's pairs gs, gs + G, ... on column x
// (G = blockDim.y), 8 at a time, then the rest 4, 2, 1 at a time: no
// padded pair is replayed.  With G = 1 a column's pairs are all one
// thread's and the stage loop has no barrier, else one barrier a stage.
template <bool kHub, bool kWindows>
__global__ void __launch_bounds__(256)
    panel_apply_blockfp_kernel(i32* P, long long sb, long long ld, int mr,
                               int w, wf::Tables t, int window, int S,
                               const i32* __restrict__ flip,
                               const i32* __restrict__ sig, Params u) {
  extern __shared__ int2 apply_smem[];
  const int C = blockDim.x, G = blockDim.y;
  const int x = threadIdx.x, gs = threadIdx.y;
  const int tid = gs * C + x;
  const int c0 = blockIdx.y * C;
  const bool live = x < w - c0;  // the ragged edge of the last column block
  const long long b = blockIdx.x;
  int2* rec = apply_smem;                          // (window, P) records
  int* count = (int*)(rec + (long long)window * t.P);  // live pairs a stage
  i32* col = (i32*)(count + window) + x;   // mr x C, row r at col[r * C]
  i32* src = P + b * sb + c0 + x;
  if (live) {
    for (int r = gs; r < mr; r += G) col[r * C] = src[r * ld];
  }
  for (int s0 = 0; s0 < t.S; s0 += window) {
    const int ns = kWindows ? min(window, t.S - s0) : t.S;
    if (kWindows && s0 > 0) __syncthreads();  // the last window's records read
    for (int i = tid; i < ns * t.P; i += C * G) {
      const long long o = (long long)s0 * t.P + i;
      if (__ldg(t.tab + o) < mr) rec[i] = apply_record(t, o, flip + b * S,
                                                       sig + b * S);
    }
    for (int s = tid; s < ns; s += C * G) {  // a stage's live pairs lead it
      const int* piv = t.tab + (long long)(s0 + s) * t.ss;
      int n = 0;
      while (n < t.P && __ldg(piv + n) < mr) ++n;
      count[s] = n;
    }
    __syncthreads();
    for (int s = 0; s < ns; ++s) {
      if (live) {
        const int2* r = rec + (long long)s * t.P + gs;
        int n = (count[s] - gs + G - 1) / G;  // this thread's pairs
        for (; n >= 8; n -= 8, r += 8 * G) {
          replay_pairs<kHub, 8>(col, C, r, G, u);
        }
        if (n & 4) {
          replay_pairs<kHub, 4>(col, C, r, G, u);
          r += 4 * G;
        }
        if (n & 2) {
          replay_pairs<kHub, 2>(col, C, r, G, u);
          r += 2 * G;
        }
        if (n & 1) replay_pairs<kHub, 1>(col, C, r, G, u);
      }
      if (G > 1) __syncthreads();  // the stage's rows written before the next reads
    }
    if (!kWindows) break;
  }
  if (live) {
    for (int r = gs; r < mr; r += G) src[r * ld] = col[r * C];
  }
}

template <bool kHub, bool kWindows>
static int apply_launch(dim3 grid, dim3 block, size_t smem,
                        cudaStream_t stream, i32* P, long long sb,
                        long long ld, int mr, int w, const wf::Tables& t,
                        int window, int S, const i32* flip, const i32* sig,
                        const Params& u) {
  cudaError_t err = cudaFuncSetAttribute(
      panel_apply_blockfp_kernel<kHub, kWindows>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  panel_apply_blockfp_kernel<kHub, kWindows><<<grid, block, smem, stream>>>(
      P, sb, ld, mr, w, t, window, S, flip, sig, u);
  return (int)cudaGetLastError();
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
                                int tile_b, int threads_x, int device_panel,
                                int iters, int hub, int comp, void* stream) {
  const Params u = {iters, hub, comp};
  const wf::Tables t = {(const int*)tables, (long long)stages * pairs, pairs,
                        stages, pairs};
  const dim3 block(threads_x, tile_b);
  const dim3 grid((B + tile_b - 1) / tile_b);
  const size_t ctrl = (size_t)tile_b * 2 * pairs * sizeof(i32);
  const size_t smem = (size_t)tile_b * mr * pw * sizeof(i32) + ctrl;
  return (device_panel ? factor_launch<false> : factor_launch<true>)(
      grid, block, device_panel ? ctrl : smem, (cudaStream_t)stream, (i32*)P,
      sb, ld, B, mr, pw, t, S, (i32*)flip, (i32*)sig, u);
}

int panel_apply_blockfp_launch(void* P, long long sb, long long ld, int B,
                               int mr, int w, const void* tables, int stages,
                               int pairs, int S, const void* flip,
                               const void* sig, int cols, int slot_threads,
                               int window, int iters, int hub, int comp,
                               void* stream) {
  const Params u = {iters, hub, comp};
  const wf::Tables t = {(const int*)tables, (long long)stages * pairs, pairs,
                        stages, pairs};
  const dim3 grid(B, (w + cols - 1) / cols);
  const dim3 block(cols, slot_threads);
  const size_t smem = (size_t)window * pairs * sizeof(int2) +
                      (size_t)window * sizeof(int) +
                      (size_t)mr * cols * sizeof(i32);
  const bool windows = window < stages;
  return (hub ? (windows ? apply_launch<true, true> : apply_launch<true, false>)
              : (windows ? apply_launch<false, true>
                         : apply_launch<false, false>))(
      grid, block, smem, (cudaStream_t)stream, (i32*)P, sb, ld, mr, w, t,
      window, S, (const i32*)flip, (const i32*)sig, u);
}

const char* blockfp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
