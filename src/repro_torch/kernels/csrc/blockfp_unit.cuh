// The int32 block-FP CORDIC Givens step as device functions: one function
// per function of repro_torch/kernels/cordic_givens.py (the plain version),
// the tile copy of the block-FP kernels (blockfp.cu), and the K-chain
// turns of the standalone rotator (rotator.cu): turn_chains on the mask
// micro-rotation (the fused kernel's), turn_chains_fma on the multiply-add
// one (the vectoring and rotation kernels').
//
// Hazards of C++ that XLA's int32 does not have, and what is done here:
//  * Signed overflow is undefined behaviour in C++, while XLA's int32 adds,
//    subtracts and multiplies wrap.  Every add, subtract and product is
//    done in uint32_t and cast back (wrap_add / wrap_sub / wrap_mul); the
//    cast of an out-of-range uint32_t to int32_t is modular in nvcc.
//  * In gain_mul_q30 each 15 x 15-bit partial product is wrapped to int32
//    *before* its arithmetic >> 15 / >> 30, as XLA computes it; a widened
//    int64 product shifted would give other bits once a product leaves
//    int32.
//  * A right shift of a negative int32 is arithmetic in nvcc (shr.s32), as
//    in XLA and PyTorch; every shift count is a constant or 0 <= i <= 29
//    (the wrappers refuse iters > 30), so no count reaches 32.
//  * The HUB carry-in form x + ~ys + (1 - cy) is summed in the plain
//    version's order (wrapping adds are associative, so any order gives the
//    same bits).
#pragma once

#include <cstdint>

namespace bfp {

using i32 = int32_t;
using u32 = uint32_t;

// The datapath's scalars: CORDIC depth, HUB or conventional arithmetic, and
// the Q30 gain compensation constant comp_q30(iters).
struct Params {
  int iters;
  int hub;
  i32 comp;
};

__device__ __forceinline__ i32 wrap_add(i32 a, i32 b) {
  return (i32)((u32)a + (u32)b);
}
__device__ __forceinline__ i32 wrap_sub(i32 a, i32 b) {
  return (i32)((u32)a - (u32)b);
}
__device__ __forceinline__ i32 wrap_mul(i32 a, i32 b) {
  return (i32)((u32)a * (u32)b);
}

// _negate: inversion for HUB, two's complement negation otherwise.
__device__ __forceinline__ i32 negate(i32 v, int hub) {
  return hub ? ~v : wrap_sub(0, v);
}

// _gain_mul_q30: (v * comp) >> 30 in four 15 x 15-bit partial products.
__device__ __forceinline__ i32 gain_mul_q30(i32 v, i32 comp) {
  const i32 c_hi = comp >> 15, c_lo = comp & 0x7FFF;
  const i32 v_hi = v >> 15, v_lo = v & 0x7FFF;  // arithmetic: keeps the sign
  i32 acc = wrap_mul(v_hi, c_hi);
  acc = wrap_add(acc, wrap_mul(v_hi, c_lo) >> 15);
  acc = wrap_add(acc, wrap_mul(v_lo, c_hi) >> 15);
  return wrap_add(acc, wrap_mul(v_lo, c_lo) >> 30);
}

// _microrotation: x' = x - d (y >> i), y' = y + d (x >> i), d = +1 where
// d_pos; with HUB the subtraction adds the inverted operand and the
// carry-in 1 - c, the addition the carry-in c (paper Fig. 6).
__device__ __forceinline__ void microrotation(i32& x, i32& y, int i, bool d_pos,
                                              int hub) {
  const i32 ys = y >> i, xs = x >> i;
  i32 xn, yn;
  if (hub) {
    const i32 cy = i == 0 ? 1 : (y >> (i - 1)) & 1;
    const i32 cx = i == 0 ? 1 : (x >> (i - 1)) & 1;
    xn = d_pos ? wrap_add(wrap_add(x, ~ys), 1 - cy)
               : wrap_add(wrap_add(x, ys), cy);
    yn = d_pos ? wrap_add(wrap_add(y, xs), cx)
               : wrap_add(wrap_add(y, ~xs), 1 - cx);
  } else {
    xn = d_pos ? wrap_sub(x, ys) : wrap_add(x, ys);
    yn = d_pos ? wrap_add(y, xs) : wrap_sub(y, xs);
  }
  x = xn;
  y = yn;
}

// microrotation() with the direction as a mask m (all ones where d_pos)
// and its bit d = -m, without a select: x - ys - cy = x + ~ys + (1 - cy)
// and x + ys + cy are x + (ys ^ m) + (cy ^ d), in wrapping arithmetic, and
// the y update is the same with ~m; conventional: cy = cx = 0.  ys2 and
// xs2 are y and x shifted by i - 1, whose low bit is the HUB carry (HUB
// micro-rotation 0, whose carries are 1, passes ~0).
template <bool kHub>
__device__ __forceinline__ void microrotation_mask(i32& x, i32& y, i32 ys,
                                                   i32 xs, i32 ys2, i32 xs2,
                                                   i32 m) {
  const i32 d = m & 1;
  const i32 cy = kHub ? (ys2 ^ d) & 1 : d;
  const i32 cx = kHub ? (xs2 ^ d ^ 1) & 1 : d ^ 1;
  x = bfp::wrap_add(bfp::wrap_add(x, ys ^ m), cy);
  y = bfp::wrap_add(bfp::wrap_add(y, xs ^ ~m), cx);
}

// K element pairs of one row pair turned by one control word as K
// independent chains, which the compiler interleaves: micro-rotation i in
// the direction of the mask dir(i, y[0]) (all ones where d_pos), shared by
// the chains; the caller flips them first and compensates the gain after.
// dir sees chain 0's y before the micro-rotation, so a chain 0 that is the
// lead pair vectors as it goes (d_pos where its y is negative), and a
// known sigma gives -((sigma >> i) & 1).  Micro-rotation 0 as in
// blockfp.cu's replay_pairs: shift 0, HUB carries 1.
template <bool kHub, int K, class Dir>
__device__ __forceinline__ void turn_chains(i32 (&x)[K], i32 (&y)[K],
                                            int iters, const Dir& dir) {
  if (iters > 0) {
    const i32 m = dir(0, y[0]);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      microrotation_mask<kHub>(x[q], y[q], y[q], x[q], ~0, ~0, m);
    }
  }
  for (int i = 1; i < iters; ++i) {
    const i32 m = dir(i, y[0]);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      microrotation_mask<kHub>(x[q], y[q], y[q] >> i, x[q] >> i,
                               y[q] >> (i - 1), x[q] >> (i - 1), m);
    }
  }
}

// The operand of micro-rotation i in the multiply-add form below: v >> i,
// and with HUB its carry bit i - 1 of v added (1 at i = 0), the ys + cy
// that _microrotation subtracts or adds.  kStep is 0 or 1 for those
// micro-rotations and 2 for any i >= 2, where ((v >> (i - 1)) + 1) >> 1
// is (v >> i) + bit i - 1 and cannot overflow (|v >> (i - 1)| < 2^30).
template <bool kHub, int kStep>
__device__ __forceinline__ i32 carry_shift(i32 v, int i) {
  if constexpr (!kHub) {
    return v >> (kStep < 2 ? kStep : i);
  } else if constexpr (kStep == 0) {
    return wrap_add(v, 1);
  } else if constexpr (kStep == 1) {
    return (v >> 1) + (v & 1);
  } else {
    return ((v >> (i - 1)) + 1) >> 1;
  }
}

// microrotation() as two wrapping multiply-adds, which issue as IMAD on
// the FMA pipe beside the shifts on the integer ALU pipe: x - d ry and
// y + d rx are x + (m | 1) ry and y + (~m | 1) rx, where the mask m is all
// ones where d_pos (m | 1 = -1 = -d) and ry, rx are carry_shift of y and x.
__device__ __forceinline__ void microrotation_fma(i32& x, i32& y, i32 ry,
                                                  i32 rx, i32 m) {
  x = wrap_add(x, wrap_mul(m | 1, ry));
  y = wrap_add(y, wrap_mul(~m | 1, rx));
}

// Micro-rotation i (kStep as carry_shift's) of K independent chains; chain
// q turns in the direction of the mask dir(i, q, y[q]), which sees its y
// before the micro-rotation.
template <bool kHub, int kStep, int K, class Dir>
__device__ __forceinline__ void fma_step(i32 (&x)[K], i32 (&y)[K], int i,
                                         const Dir& dir) {
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const i32 m = dir(i, q, y[q]);
    microrotation_fma(x[q], y[q], carry_shift<kHub, kStep>(y[q], i),
                      carry_shift<kHub, kStep>(x[q], i), m);
  }
}

// turn_chains in the multiply-add form, each chain with a direction of its
// own: dir(i, q, y[q]) gives chain q's mask for micro-rotation i, so a
// known control word gives -((sigma >> i) & 1) to every chain, and a chain
// that vectors its own pair gives y[q] >> 31.  Micro-rotations 0 and 1
// are peeled, so the loop over i >= 2 has no branch.
template <bool kHub, int K, class Dir>
__device__ __forceinline__ void turn_chains_fma(i32 (&x)[K], i32 (&y)[K],
                                                int iters, const Dir& dir) {
  if (iters > 0) fma_step<kHub, 0>(x, y, 0, dir);
  if (iters > 1) fma_step<kHub, 1>(x, y, 1, dir);
  for (int i = 2; i < iters; ++i) fma_step<kHub, 2>(x, y, i, dir);
}

// The lead pair's vectoring in place: flip on x < 0, then iters
// micro-rotations driving y to 0, their directions packed into sig (bit i =
// d_pos of micro-rotation i).  (xl, yl) become the vectored pair, before
// the gain compensation.
__device__ __forceinline__ void vector_pair(i32& xl, i32& yl, const Params& u,
                                            i32& flip, i32& sig) {
  flip = xl < 0;
  if (flip) {
    xl = negate(xl, u.hub);
    yl = negate(yl, u.hub);
  }
  sig = 0;
  for (int i = 0; i < u.iters; ++i) {
    const bool d_pos = yl < 0;
    microrotation(xl, yl, i, d_pos, u.hub);
    sig |= (i32)d_pos << i;
  }
}

// vector_pair for the control word alone.
__device__ __forceinline__ void vector_lead(i32 xl, i32 yl, const Params& u,
                                            i32& flip, i32& sig) {
  vector_pair(xl, yl, u, flip, sig);
}

// fused_replay on one element pair: the control word (flip, sig) replayed,
// then the gain compensated.  On the lead pair it gives vectoring's own
// result bit for bit (the same micro-rotations in the same directions).
__device__ __forceinline__ void replay(i32& x, i32& y, const Params& u,
                                       i32 flip, i32 sig) {
  if (flip) {
    x = negate(x, u.hub);
    y = negate(y, u.hub);
  }
  for (int i = 0; i < u.iters; ++i) {
    microrotation(x, y, i, (sig >> i) & 1, u.hub);
  }
  x = gain_mul_q30(x, u.comp);
  y = gain_mul_q30(y, u.comp);
}

// Copies a rows x e tile between two buffers with row strides ldd and lds;
// the threads of a row (blockDim.x) stride over the elements.
__device__ __forceinline__ void copy_tile(i32* dst, long long ldd,
                                          const i32* src, long long lds,
                                          int rows, int e) {
  for (int idx = threadIdx.x; idx < rows * e; idx += blockDim.x) {
    const int r = idx / e, c = idx - r * e;
    dst[r * ldd + c] = src[r * lds + c];
  }
}

}  // namespace bfp
