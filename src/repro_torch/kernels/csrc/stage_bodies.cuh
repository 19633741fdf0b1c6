// The pair steps of the packed-word and int32 block-FP stage kernels, as
// bodies of a stage loop (stage_loop.cuh): the wavefront kernels
// (wavefront.cu, B5a/B5b) run them on Sameh-Kuck stages with
// wf::run_stages, the flat kernels (qr_packed.cu, B1; blockfp.cu, B2) on
// the levels of a step-serial schedule with wf::run_item_stages below.
// Both run the same arithmetic, so the words agree.
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

// The flat kernels' stage loop: wf::run_stages with the replay spread over
// the stage's live (pair, column) items only, so no lane idles on a column
// left of a lead or on a padded pair.  Row 3 of the (4, S, P) table holds
// each pair's inclusive item end: pair p owns the items
// [end[p] - (e - c_p), end[p]) of its stage, columns c_p..e-1, and a
// padded pair owns none.  A thread's items rise by blockDim.x, so it finds
// each one's pair by walking end forward from the last (one or two loads
// an item at the flat routes' shapes; a binary search from 0 cost up to
// six dependent loads) and its column as e - end[p] + i.
template <class Body>
__device__ __forceinline__ void run_item_stages(const Tables& t, int m, int e,
                                                bool live, const Body& body) {
  for (int s = 0; s < t.S; ++s) {
    const int* piv = t.tab + (long long)s * t.ss;
    const int* tgt = piv + t.ts;
    const int* col = piv + 2 * t.ts;
    const int* end = piv + 3 * t.ts;
    if (live) {
      for (int p = threadIdx.x; p < t.P; p += blockDim.x) {
        const int k = __ldg(piv + p);
        if (k < m) body.lead(s, p, k, __ldg(tgt + p), __ldg(col + p));
      }
    }
    __syncthreads();  // control words written; lead words read
    if (live) {
      const int total = __ldg(end + t.P - 1);
      int p = 0;  // the pair of item i: the first whose end exceeds i
      for (int i = threadIdx.x; i < total; i += blockDim.x) {
        while (__ldg(end + p) <= i) ++p;
        body.element(p, __ldg(piv + p), __ldg(tgt + p), __ldg(col + p),
                     e - __ldg(end + p) + i);
      }
    }
    __syncthreads();  // the stage's rows written before the next reads
  }
}

}  // namespace wf
