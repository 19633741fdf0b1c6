// The pair steps of the packed-word, int32 block-FP and complex stage
// kernels, as bodies of a stage loop (stage_loop.cuh): the complex
// wavefront kernel (complex_packed.cu, B7b) and the panel factorizations
// run them with wf::run_stages, the flat kernels (qr_packed.cu, B1, and
// B5a on the Sameh-Kuck stages; blockfp.cu, B2, and B5b on the Sameh-Kuck
// stages; complex_packed.cu, B7a) on the levels of a step-serial schedule
// or on the caller's stages with wf::run_item_stages below.  All run the
// same arithmetic, so the words agree.
#pragma once

#include "blockfp_unit.cuh"
#include "givens_unit.cuh"
#include "stage_loop.cuh"

namespace wf {

// The packed pair step: GivensUnit.vector on the lead pair, GivensUnit.rotate
// of its control word on each element.  ctrl holds (flip, sig) per pair.
struct PackedStage {
  gru::i64* T;
  int ld;
  const gru::UnitParams* u;
  gru::i64* ctrl;
  __device__ __forceinline__ void lead(int, int p, int k, int j,
                                       int c) const {
    gru::i64 x, y, m_exp;
    gru::to_fixed(T[k * ld + c], T[j * ld + c], *u, x, y, m_exp);
    gru::vectoring(x, y, *u, ctrl[2 * p], ctrl[2 * p + 1]);
  }
  __device__ __forceinline__ void element(int p, int k, int j, int c,
                                          int idx) const {
    gru::i64& x = T[k * ld + idx];
    gru::i64& y = T[j * ld + idx];
    gru::rotate_pair(x, y, *u, ctrl[2 * p], ctrl[2 * p + 1]);
    if (idx == c) y = 0;  // structural zero (systolic array)
  }
};

// The block-FP pair step: fused_rotate_pairs on one pair.
struct BlockfpStage {
  bfp::i32* T;
  int ld;
  const bfp::Params* u;
  bfp::i32* ctrl;
  __device__ __forceinline__ void lead(int, int p, int k, int j,
                                       int c) const {
    bfp::vector_lead(T[k * ld + c], T[j * ld + c], *u, ctrl[2 * p],
                     ctrl[2 * p + 1]);
  }
  __device__ __forceinline__ void element(int p, int k, int j, int c,
                                          int idx) const {
    bfp::i32 x = T[k * ld + idx], y = T[j * ld + idx];
    bfp::replay(x, y, *u, ctrl[2 * p], ctrl[2 * p + 1]);
    T[k * ld + idx] = x;
    T[j * ld + idx] = idx == c ? 0 : y;  // structural zero
  }
};

// Words of the control record of one complex pair in shared memory.
constexpr int kComplexCtrlWords = 8;

// The complex pair step (GivensUnit.rotate_rows_complex), on (re, im) words:
// element (r, c, lane) of the tile at T[(r * ld + c) * 2 + lane].  ctrl per
// pair: the pivot row's phase word and skip flag, the target row's, and the
// real word.
struct ComplexStage {
  gru::i64* T;
  int ld;
  const gru::UnitParams* u;
  gru::i64* ctrl;
  // The whole lead on one thread (wf::run_stages, B7b): both magnitudes
  // stay in registers.
  __device__ __forceinline__ void lead(int, int p, int k, int j,
                                       int c) const {
    const gru::i64* x = T + (k * ld + c) * 2;
    const gru::i64* y = T + (j * ld + c) * 2;
    gru::i64* w = ctrl + kComplexCtrlWords * p;
    gru::i64 magx, magy, xf, yf, m_exp;
    bool skx, sky;
    gru::phase_vector(x[0], x[1], *u, magx, w[0], w[1], skx);
    gru::phase_vector(y[0], y[1], *u, magy, w[3], w[4], sky);
    w[2] = skx;
    w[5] = sky;
    gru::to_fixed(magx, magy, *u, xf, yf, m_exp);
    gru::vectoring(xf, yf, *u, w[6], w[7]);
  }
  // The lead in parts, which run_split_item_stages (B7a) runs in two
  // rounds: phase() for one row's lead (half 0 the pivot row, 1 the target
  // row), which leaves the realized |z| in w[6 + half], then real(), which
  // vectors the two.
  __device__ __forceinline__ void phase(int p, int half, int r, int c) const {
    const gru::i64* z = T + (r * ld + c) * 2;
    gru::i64* w = ctrl + kComplexCtrlWords * p;
    bool sk;
    gru::phase_vector(z[0], z[1], *u, w[6 + half], w[3 * half],
                      w[3 * half + 1], sk);
    w[3 * half + 2] = sk;
  }
  __device__ __forceinline__ void real(int p) const {
    gru::i64* w = ctrl + kComplexCtrlWords * p;
    gru::i64 xf, yf, m_exp;
    gru::to_fixed(w[6], w[7], *u, xf, yf, m_exp);
    gru::vectoring(xf, yf, *u, w[6], w[7]);
  }
  __device__ __forceinline__ void element(int p, int k, int j, int c,
                                          int idx) const {
    gru::i64* x = T + (k * ld + idx) * 2;
    gru::i64* y = T + (j * ld + idx) * 2;
    const gru::i64* w = ctrl + kComplexCtrlWords * p;
    gru::i64 xr = x[0], xi = x[1], yr = y[0], yi = y[1];
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

// The replay of a stage's control words over its live (pair, column) items
// only, so no lane idles on a column left of a lead or on a padded pair.
// Row 3 of the flat kernels' (4, S, P) table holds each pair's inclusive
// item end: pair p owns the items [end[p] - (e - c_p), end[p]) of its
// stage, columns c_p..e-1, and a padded pair owns none.  A thread's items
// rise by blockDim.x, so it finds each one's pair by walking end forward
// from the last (one or two loads an item at the flat routes' shapes; a
// binary search from 0 cost up to six dependent loads) and its column as
// e - end[p] + i.
template <class Body>
__device__ __forceinline__ void replay_items(const int* piv, long long ts,
                                             int P, int e, const Body& body) {
  const int* tgt = piv + ts;
  const int* col = piv + 2 * ts;
  const int* end = piv + 3 * ts;
  const int total = __ldg(end + P - 1);
  int p = 0;  // the pair of item i: the first whose end exceeds i
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    while (__ldg(end + p) <= i) ++p;
    body.element(p, __ldg(piv + p), __ldg(tgt + p), __ldg(col + p),
                 e - __ldg(end + p) + i);
  }
}

// The flat kernels' stage loop: wf::run_stages with the replay over the
// stage's live items (replay_items).
template <class Body>
__device__ __forceinline__ void run_item_stages(const Tables& t, int m, int e,
                                                bool live, const Body& body) {
  for (int s = 0; s < t.S; ++s) {
    const int* piv = t.tab + (long long)s * t.ss;
    if (live) {
      for (int p = threadIdx.x; p < t.P; p += blockDim.x) {
        const int k = __ldg(piv + p);
        if (k < m) body.lead(s, p, k, __ldg(piv + t.ts + p),
                             __ldg(piv + 2 * t.ts + p));
      }
    }
    __syncthreads();  // control words written; lead words read
    if (live) replay_items(piv, t.ts, t.P, e, body);
    __syncthreads();  // the stage's rows written before the next reads
  }
}

// run_item_stages for a body whose lead is three serial vectorings (the
// complex pair step): the two phase vectorings of each pair on two
// threads, a barrier, then the real vectoring on one; three barriers a
// stage.
template <class Body>
__device__ __forceinline__ void run_split_item_stages(const Tables& t, int m,
                                                      int e, bool live,
                                                      const Body& body) {
  for (int s = 0; s < t.S; ++s) {
    const int* piv = t.tab + (long long)s * t.ss;
    if (live) {
      for (int q = threadIdx.x; q < 2 * t.P; q += blockDim.x) {
        const int p = q >> 1, k = __ldg(piv + p);
        if (k < m) body.phase(p, q & 1, (q & 1) ? __ldg(piv + t.ts + p) : k,
                              __ldg(piv + 2 * t.ts + p));
      }
    }
    __syncthreads();  // phase words and magnitudes written; leads read
    if (live) {
      for (int p = threadIdx.x; p < t.P; p += blockDim.x) {
        if (__ldg(piv + p) < m) body.real(p);
      }
    }
    __syncthreads();  // real words written
    if (live) replay_items(piv, t.ts, t.P, e, body);
    __syncthreads();  // the stage's rows written before the next reads
  }
}

}  // namespace wf
