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
//    vectoring on the lead pair (piv, col), (tgt, col), its control word
//    (flip, sigma) replayed on both rows from column col, the target lead
//    forced to 0, and the control word written to the (B, S) outputs in
//    step order.  Equal to panel_factor_packed_reference.
//  * panel_apply: every (piv, tgt, flip, sigma) step replayed with the
//    unit's rotate on the trailing mr x w region.  Equal to
//    panel_apply_packed_reference.
// Together, panel by panel, they run the column-major schedule of the flat
// kernel (qr_packed.cu) in the same order, so the words equal its words.
//
// Both run the panel's steps in stages: the wrapper levelizes the step
// tables (qrd_blocked.levelize_steps), each step one level past the last
// steps on its two rows.  A stage's pairs touch disjoint rows and every row
// meets its steps in their order, so the words and the control words are
// those of the step order, bit for bit.  The column-major panel of mr rows
// and nc columns has mr + nc - 2 stages of at most nc pairs against about
// nc * mr steps: 134 against 988 for a TSQR leaf's first panel (128 x 8).
// The stage table is (4, S', P): pivot, target, column and each pair's
// step index, padded with pivot row mr (the pair is skipped).
//
// Bound on this card: integer operations, as for qr_packed.cu: several
// hundred dependent int64 operations per rotated element against one read
// and one write of each word.  What the stages change is the dependent
// chain of a call, on the tree levels of TSQR the whole of its time.
//
// Design:
//  * Both kernels work in place on row-strided views of the (B, m, e)
//    working buffer: a matrix at batch stride sb, rows at stride ld, unit
//    column stride.  No padding, chunking or transposes.
//  * panel_factor: one block holds `tile_b` panels (blockDim.y) and their
//    per-pair control words in shared memory and runs wf::run_stages
//    (stage_loop.cuh) on each: one thread per pair vectors the lead once
//    and writes the control word to shared memory and to flip/sig at the
//    pair's step index, then the panel's threads spread over (pair,
//    column) and replay it; two barriers a stage.  On the engine's default
//    tiles (tile_m 128) a panel fits and the wrapper caps tile_b to shared
//    memory; a taller panel (tile_m 4096 at panel_n 8: 256 KiB) stays in
//    device memory, where the stages work on it in place through the L1
//    and L2 caches (kShared = false; the control words stay in shared
//    memory), as qr_packed.cu does with a tile beyond shared memory.
//  * panel_apply: a block owns one matrix and `blockDim.x` (up to 32) of
//    its trailing columns, which it reads once into shared memory and
//    writes back once.  Its threads spread over (column, pair slot):
//    columns across the lanes of a warp (consecutive 64-bit words, no bank
//    conflict), one pair slot per warp.  Each thread replays its pair's
//    control word, read from flip/sig at the pair's step index, on its
//    column of the pair's two rows; one barrier a stage.  A column's chain
//    of S rotations becomes S' stages shared by up to P threads.
#include <cuda_runtime.h>

#include "qr_tile.cuh"
#include "stage_loop.cuh"

using gru::i64;
using gru::UnitParams;

// B3a's pair step: GivensUnit.vector on the lead pair, its control word
// kept in ctrl (flip, sig per pair) and written to this panel's (S,)
// outputs at the pair's step index, then GivensUnit.rotate of it on each
// element.
struct PanelStage {
  i64* T;
  int ld;
  const UnitParams* u;
  i64* ctrl;
  const int* step;  // the (S', P) step indices: entry p of stage s at s * P + p
  int P;
  i64* flip;
  i64* sig;
  __device__ __forceinline__ void lead(int s, int p, int k, int j,
                                       int c) const {
    i64 x, y, m_exp, f, g;
    gru::to_fixed(T[k * ld + c], T[j * ld + c], *u, x, y, m_exp);
    gru::vectoring(x, y, *u, f, g);
    ctrl[2 * p] = f;
    ctrl[2 * p + 1] = g;
    const int st = __ldg(step + s * P + p);
    flip[st] = f;
    sig[st] = g;
  }
  __device__ __forceinline__ void element(int p, int k, int j, int c,
                                          int idx) const {
    i64& x = T[k * ld + idx];
    i64& y = T[j * ld + idx];
    gru::rotate_pair(x, y, *u, ctrl[2 * p], ctrl[2 * p + 1]);
    if (idx == c) y = 0;  // structural zero (systolic array)
  }
};

// kShared: the block's panels are copied into shared memory and back;
// else the stages work on each panel where it lies (row stride ld, which
// the wrapper keeps within int with the panel's rows).  The control words
// are in shared memory either way.
template <bool kShared>
__global__ void panel_factor_kernel(i64* P, long long sb, long long ld, int B,
                                    int mr, int pw, wf::Tables t, int S,
                                    i64* __restrict__ flip,
                                    i64* __restrict__ sig, UnitParams u) {
  extern __shared__ i64 panel_smem[];
  const long long b = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = b < B;  // the ragged edge of the last block
  i64* src = P + (live ? b : 0) * sb;
  i64* T = kShared ? panel_smem + (long long)threadIdx.y * mr * pw : src;
  i64* ctrl = panel_smem + (kShared ? (long long)blockDim.y * mr * pw : 0) +
              (long long)threadIdx.y * t.P * 2;
  if (kShared && live) gru::copy_tile(T, pw, src, ld, mr, pw);
  __syncthreads();
  const long long o = (live ? b : 0) * S;
  wf::run_stages(t, mr, pw, live,
                 PanelStage{T, kShared ? pw : (int)ld, &u, ctrl,
                            t.tab + 3 * t.ts, t.ss, flip + o, sig + o});
  if (kShared && live) gru::copy_tile(src, ld, T, pw, mr, pw);
}

template <bool kShared>
static int factor_launch(dim3 grid, dim3 block, size_t smem,
                         cudaStream_t stream, i64* P, long long sb,
                         long long ld, int B, int mr, int pw,
                         const wf::Tables& t, int S, i64* flip, i64* sig,
                         const UnitParams& u) {
  cudaError_t err = cudaFuncSetAttribute(
      panel_factor_kernel<kShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  panel_factor_kernel<kShared><<<grid, block, smem, stream>>>(
      P, sb, ld, B, mr, pw, t, S, flip, sig, u);
  return (int)cudaGetLastError();
}

__global__ void panel_apply_kernel(i64* P, long long sb, long long ld, int mr,
                                   int w, wf::Tables t, int S,
                                   const i64* __restrict__ flip,
                                   const i64* __restrict__ sig, UnitParams u) {
  extern __shared__ i64 cols_smem[];
  const int cx = blockDim.x;  // the block's columns, one per lane
  const int x = threadIdx.x, p = threadIdx.y;  // column, pair slot
  const int tid = p * cx + x, nt = cx * blockDim.y;
  const int c0 = blockIdx.y * cx;
  const int wb = min(cx, w - c0);  // the ragged edge of the last column block
  i64* src = P + (long long)blockIdx.x * sb + c0;
  const i64* f = flip + (long long)blockIdx.x * S;
  const i64* g = sig + (long long)blockIdx.x * S;
  for (int idx = tid; idx < mr * cx; idx += nt) {
    const int r = idx / cx, c = idx - r * cx;
    if (c < wb) cols_smem[idx] = src[r * ld + c];
  }
  __syncthreads();
  for (int s = 0; s < t.S; ++s) {
    const int* piv = t.tab + (long long)s * t.ss + p;
    const int k = __ldg(piv);
    if (k < mr && x < wb) {  // a padded pair names row mr
      const int j = __ldg(piv + t.ts);
      const int st = __ldg(piv + 3 * t.ts);
      i64 xv = cols_smem[k * cx + x], yv = cols_smem[j * cx + x];
      gru::rotate_pair(xv, yv, u, __ldg(f + st), __ldg(g + st));
      cols_smem[k * cx + x] = xv;
      cols_smem[j * cx + x] = yv;
    }
    __syncthreads();  // the stage's rows written before the next reads
  }
  for (int idx = tid; idx < mr * cx; idx += nt) {
    const int r = idx / cx, c = idx - r * cx;
    if (c < wb) src[r * ld + c] = cols_smem[idx];
  }
}

extern "C" {

// Both launch on `stream` and return the CUDA error of the launch (0 on
// success).  `tables` is the (4, S', P) int32 stage table: pivot, target,
// column and step index of each pair; S is the step count, the length of
// each matrix's flip and sig rows.
int panel_factor_launch(void* P, long long sb, long long ld, int B, int mr,
                        int pw, const void* tables, int stages, int pairs,
                        int S, void* flip, void* sig, int tile_b,
                        int threads_x, int device_panel, int man_bits,
                        int exp_bits, long long bias, long long max_exp_raw,
                        int N, int iters, int hub, int rne, int unbiased,
                        int detect_identity, long long comp, int p,
                        void* stream) {
  const UnitParams u = {man_bits, exp_bits, bias, max_exp_raw, N, iters, hub,
                        rne, unbiased, detect_identity, comp, p};
  const wf::Tables t = {(const int*)tables, (long long)stages * pairs, pairs,
                        stages, pairs};
  const dim3 block(threads_x, tile_b);
  const dim3 grid((B + tile_b - 1) / tile_b);
  const size_t ctrl = (size_t)tile_b * 2 * pairs * sizeof(i64);
  const size_t smem = (size_t)tile_b * mr * pw * sizeof(i64) + ctrl;
  return (device_panel ? factor_launch<false> : factor_launch<true>)(
      grid, block, device_panel ? ctrl : smem, (cudaStream_t)stream, (i64*)P,
      sb, ld, B, mr, pw, t, S, (i64*)flip, (i64*)sig, u);
}

int panel_apply_launch(void* P, long long sb, long long ld, int B, int mr,
                       int w, const void* tables, int stages, int pairs, int S,
                       const void* flip, const void* sig, int cols,
                       int man_bits, int exp_bits, long long bias,
                       long long max_exp_raw, int N, int iters, int hub,
                       int rne, int unbiased, int detect_identity,
                       long long comp, int p, void* stream) {
  const UnitParams u = {man_bits, exp_bits, bias, max_exp_raw, N, iters, hub,
                        rne, unbiased, detect_identity, comp, p};
  const wf::Tables t = {(const int*)tables, (long long)stages * pairs, pairs,
                        stages, pairs};
  const dim3 block(cols, pairs);
  const dim3 grid(B, (w + cols - 1) / cols);
  const size_t smem = (size_t)mr * cols * sizeof(i64);
  cudaError_t err = cudaFuncSetAttribute(
      panel_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  panel_apply_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (i64*)P, sb, ld, mr, w, t, S, (const i64*)flip, (const i64*)sig, u);
  return (int)cudaGetLastError();
}

const char* panel_packed_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
