// The stage loop shared by the complex wavefront kernel (complex_packed.cu),
// the lane kernels (packed_lanes.cu) and the panel factorizations
// (panel_packed.cu, blockfp.cu): every stage of a schedule on a tile that
// one block holds, in shared memory or in device memory.
//
// A stage is a set of rotations on disjoint row pairs (a Sameh-Kuck stage,
// a level of a levelized step-serial schedule, or a single step of one),
// so all its pairs run at once and the block waits at two barriers a
// stage, not a rotation:
//  1. one thread per pair reads the pair's lead words and computes the
//     control words, which it keeps in the block's shared memory;
//  2. the threads of the block spread over (pair, column) and replay the
//     control words on every element of both rows from the lead column on.
// Lanes left of the lead are never touched, which is what the JAX kernels'
// restore of those lanes does.  A padded pair (pivot row m) is skipped,
// which is what their out-of-range gather and dropped scatter do.
#pragma once

namespace wf {

// The three tables of a schedule: entry p of stage s of the pivot, target
// and column tables at tab[s * ss + p], tab[ts + s * ss + p] and
// tab[2 * ts + s * ss + p].  A (3, S, P) stage table has ts = S * P and
// ss = P; an (S, 3) step table is S stages of one pair with ts = 1, ss = 3.
struct Tables {
  const int* tab;
  long long ts;
  int ss;
  int S;
  int P;
};

// Runs every stage on the tile that `body` addresses.  Body provides
//   lead(s, p, k, j, c)       control words of pair p of stage s (rows k,
//                             j, column c)
//   element(p, k, j, c, idx)  pair p's control words replayed on column idx
// Every thread of the block calls this, `live` or not (the barriers).
template <class Body>
__device__ __forceinline__ void run_stages(const Tables& t, int m, int e,
                                           bool live, const Body& body) {
  for (int s = 0; s < t.S; ++s) {
    const int* piv = t.tab + (long long)s * t.ss;
    const int* tgt = piv + t.ts;
    const int* col = piv + 2 * t.ts;
    if (live) {
      for (int p = threadIdx.x; p < t.P; p += blockDim.x) {
        const int k = __ldg(piv + p);
        if (k < m) body.lead(s, p, k, __ldg(tgt + p), __ldg(col + p));
      }
    }
    __syncthreads();  // control words written; lead words read
    if (live) {
      for (int i = threadIdx.x; i < t.P * e; i += blockDim.x) {
        const int p = i / e, idx = i - p * e;
        const int k = __ldg(piv + p);
        const int c = __ldg(col + p);
        if (k < m && idx >= c) body.element(p, k, __ldg(tgt + p), c, idx);
      }
    }
    __syncthreads();  // the stage's rows written before the next reads
  }
}

}  // namespace wf
