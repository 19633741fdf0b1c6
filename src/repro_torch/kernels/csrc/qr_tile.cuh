// The step loop of the packed-word flat QR kernel (qr_packed.cu): every
// schedule step on a tile that one block holds, in shared memory or in
// device memory; and the tile copy it shares with panel_packed.cu.
#pragma once

#include "givens_unit.cuh"

namespace gru {

// Copies a rows x e tile between two buffers with row strides ldd and lds;
// the threads of a row (blockDim.x) stride over the elements.
__device__ __forceinline__ void copy_tile(i64* dst, long long ldd, const i64* src,
                                          long long lds, int rows, int e) {
  for (int idx = threadIdx.x; idx < rows * e; idx += blockDim.x) {
    const int r = idx / e, c = idx - r * e;
    dst[r * ldd + c] = src[r * lds + c];
  }
}

// Runs the S steps (piv[s*ts], tgt[s*ts], col[s*ts]) on the tile T, whose
// rows hold e elements at stride ld: the unit's rotate_rows on rows piv and
// tgt from column col, then the target lead forced to 0.  Each thread of
// the row runs the lead's vectoring itself and rotates its own elements in
// place; two barriers a step, so every thread of the block calls this,
// `live` or not.  With flip_out, thread 0 also writes each step's control
// word (flip_out[s], sig_out[s]).  The lead is written from vectoring's own
// x, which equals sigma replayed on the lead bit for bit (the same
// micro-rotations in the same directions).
__device__ __forceinline__ void factor_tile(i64* T, long long ld, int e,
                                            const int* __restrict__ piv,
                                            const int* __restrict__ tgt,
                                            const int* __restrict__ col, int ts,
                                            int S, bool live, const UnitParams& u,
                                            i64* flip_out, i64* sig_out) {
  for (int s = 0; s < S; ++s) {
    const int k = __ldg(piv + s * ts);
    const int j = __ldg(tgt + s * ts);
    const int c = __ldg(col + s * ts);
    i64* rx = T + k * ld;
    i64* ry = T + j * ld;
    i64 xl = 0, yl = 0;
    if (live) {
      xl = rx[c];
      yl = ry[c];
    }
    __syncthreads();  // the lead pair is read before its owner overwrites it
    if (live) {
      i64 xf, yf, m_exp, flip, sig;
      to_fixed(xl, yl, u, xf, yf, m_exp);
      vectoring(xf, yf, u, flip, sig);
      if (flip_out != nullptr && threadIdx.x == 0) {
        flip_out[s] = flip;
        sig_out[s] = sig;
      }
      for (int idx = c + threadIdx.x; idx < e; idx += blockDim.x) {
        if (idx == c) {
          rx[c] = to_float(apply_gain(xf, u), m_exp, u);
          ry[c] = 0;  // structural zero (systolic array)
        } else {
          rotate_pair(rx[idx], ry[idx], u, flip, sig);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace gru
