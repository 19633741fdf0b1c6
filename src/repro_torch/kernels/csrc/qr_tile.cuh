// The tile copy of the packed-word kernels that hold a matrix's tile in
// shared memory or work on it in place in device memory (qr_packed.cu,
// panel_packed.cu, complex_packed.cu).
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

}  // namespace gru
