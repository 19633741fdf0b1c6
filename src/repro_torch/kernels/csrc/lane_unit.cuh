// The paper's Givens rotation unit on dual 32-bit lanes, as CUDA device
// functions: one per function of the plain PyTorch version
// (repro_torch/kernels/packed_lanes.py), so the lane words agree bit for
// bit.  A packed int64 word travels as a (hi, lo) pair of uint32 halves;
// every 64-bit operation of the unit is done on the pair with 32-bit
// instructions only, as the TPU kernel had to (no 64-bit integer type
// appears here).
//
// Arithmetic rules (each one a bit-exactness or undefined-behaviour trap):
//  * Every add, subtract and product is on uint32_t, which wraps; a carry
//    is read with an unsigned compare, a borrow likewise.
//  * The 32 x 32 -> 64-bit product is __umulhi plus the low product, which
//    is what _mul32x32's 16-bit digits compute; the cross terms of mul64
//    keep their low 32 bits (uint32 products).
//  * Shifting a 32-bit value by 32 or more is undefined in C++.  Every
//    count is first clamped to [0, 63] (shift_norm, as _shift_norm), then
//    split: counts below 32 carry the cross-lane bits with the clamping
//    funnel shifts __funnelshift_lc / __funnelshift_rc, counts of 32 and
//    more shift only the other half, by count - 32 <= 31.
//  * `>>` on a negative int32_t is arithmetic under nvcc (shr.s32), as in
//    XLA and PyTorch.
//  * ilog2_64 is an exact integer search (__clz on the nonzero half); the
//    int64 unit goes through float64 frexp, and the two agree for
//    0 < a < 2^53, which N <= 50 guarantees.
//  * The clamps are the lane unit's, not the int64 unit's: _align's
//    truncating shift clamps to 62 and rshift_rne64 to 63.
//  * The gain constant is computed on the host (numpy, as the JAX package
//    does) and passed in as two halves.
#pragma once

#include <cstdint>

namespace lane {

using u32 = uint32_t;
using i32 = int32_t;

// One packed word: the layout of the (hi, lo) int32 pair of the stacked
// (..., 2) storage, 8-byte aligned so a word loads as one int2.
struct __align__(8) W {
  u32 hi;
  u32 lo;
};

struct Params {
  int man_bits;
  int exp_bits;
  int bias;
  int max_exp_raw;
  int N;
  int iters;
  int hub;              // HUB datapath (else conventional IEEE-like)
  int rne;              // IEEE input alignment: 1 = 'rne', 0 = 'trunc'
  int unbiased;         // HUB: unbiased extension
  int detect_identity;  // HUB: exact 1.0 detection
  u32 comp_hi;          // round(2^p / K(iters)), high half
  u32 comp_lo;          // and low half
  int p;                // shift of the gain constant
};

__device__ __forceinline__ W mk(u32 hi, u32 lo) {
  W w;
  w.hi = hi;
  w.lo = lo;
  return w;
}

// _low: a small nonnegative int as a word.
__device__ __forceinline__ W low(u32 x) { return mk(0u, x); }

// -- 64-bit integer primitives over (hi, lo) pairs ----------------------------

__device__ __forceinline__ W add64(W a, W b) {
  const u32 l = a.lo + b.lo;
  const u32 carry = l < a.lo ? 1u : 0u;
  return mk(a.hi + b.hi + carry, l);
}

__device__ __forceinline__ W sub64(W a, W b) {
  const u32 borrow = a.lo < b.lo ? 1u : 0u;
  return mk(a.hi - b.hi - borrow, a.lo - b.lo);
}

__device__ __forceinline__ W not64(W a) { return mk(~a.hi, ~a.lo); }

__device__ __forceinline__ W neg64(W a) { return add64(not64(a), low(1u)); }

__device__ __forceinline__ W and64(W a, W b) { return mk(a.hi & b.hi, a.lo & b.lo); }

__device__ __forceinline__ W or64(W a, W b) { return mk(a.hi | b.hi, a.lo | b.lo); }

__device__ __forceinline__ bool eq64(W a, W b) { return a.hi == b.hi && a.lo == b.lo; }

// Unsigned a < b.
__device__ __forceinline__ bool ltu64(W a, W b) {
  return a.hi < b.hi || (a.hi == b.hi && a.lo < b.lo);
}

__device__ __forceinline__ bool is_neg64(W a) { return (i32)a.hi < 0; }

__device__ __forceinline__ W where64(bool c, W a, W b) { return c ? a : b; }

// _shift_norm: a shift count clamped to [0, 63].
__device__ __forceinline__ int shift_norm(int s) { return s < 0 ? 0 : (s > 63 ? 63 : s); }

__device__ __forceinline__ W shl64(W v, int s_in) {
  const int s = shift_norm(s_in);
  if (s >= 32) return mk(v.lo << (s - 32), 0u);
  // high 32 bits of (hi:lo) << s; the clamping form is defined at s == 0
  return mk(__funnelshift_lc(v.lo, v.hi, (u32)s), v.lo << s);
}

// Logical (zero-fill) right shift.
__device__ __forceinline__ W shr64(W v, int s_in) {
  const int s = shift_norm(s_in);
  if (s >= 32) return mk(0u, v.hi >> (s - 32));
  return mk(v.hi >> s, __funnelshift_rc(v.lo, v.hi, (u32)s));
}

// Arithmetic (sign-fill) right shift.
__device__ __forceinline__ W sar64(W v, int s_in) {
  const int s = shift_norm(s_in);
  const i32 hs = (i32)v.hi;
  if (s >= 32) return mk((u32)(hs >> 31), (u32)(hs >> (s - 32)));
  return mk((u32)(hs >> s), __funnelshift_rc(v.lo, v.hi, (u32)s));
}

// Low 64 bits of the product (signed == unsigned mod 2^64).
__device__ __forceinline__ W mul64(W a, W b) {
  const u32 hi = __umulhi(a.lo, b.lo);  // _mul32x32's high half
  const u32 cross = a.lo * b.hi + a.hi * b.lo;
  return mk(hi + cross, a.lo * b.lo);
}

// floor(log2(u)) for u >= 1 (0 for u == 0).
__device__ __forceinline__ int ilog2_32(u32 u) { return u == 0u ? 0 : 31 - __clz(u); }

// floor(log2(v)) for a positive word.
__device__ __forceinline__ int ilog2_64(W v) {
  return v.hi != 0u ? ilog2_32(v.hi) + 32 : ilog2_32(v.lo);
}

// Arithmetic right shift with round-to-nearest-even on the dropped bits.
__device__ __forceinline__ W rshift_rne64(W v, int sh_in) {
  const int sh = sh_in < 0 ? 0 : sh_in;
  const W q = sar64(v, sh);
  const W rem = sub64(v, shl64(q, sh));
  const W half = sh > 0 ? shl64(low(1u), sh - 1) : low(0u);
  const bool up =
      sh > 0 && (ltu64(half, rem) || (eq64(rem, half) && (q.lo & 1u) == 1u));
  return add64(q, low(up ? 1u : 0u));
}

// -- converter datapath (repro_torch/kernels/packed_lanes.py) -----------------

// A word with the low `bits` bits set, bits in [0, 63]: (1 << bits) - 1.
__device__ __forceinline__ W low_bits(int bits) {
  return sub64(shl64(low(1u), bits), low(1u));
}

__device__ __forceinline__ void unpack(W p, const Params& u, int& sign,
                                       int& exp_raw, W& man) {
  man = and64(p, low_bits(u.man_bits));
  exp_raw = (int)(shr64(p, u.man_bits).lo & ((1u << u.exp_bits) - 1u));
  sign = (int)(shr64(p, u.exp_bits + u.man_bits).lo & 1u);
}

__device__ __forceinline__ void align(W xfix, W yfix, int ex, int ey,
                                      const Params& u, bool rne, W& xout,
                                      W& yout, int& m_exp) {
  const int d_xy = ex - ey;
  const bool x_is_low = d_xy < 0;
  const int sh = x_is_low ? -d_xy : d_xy;
  const W lo = where64(x_is_low, xfix, yfix);
  W lo_sh = rne ? rshift_rne64(lo, sh) : sar64(lo, sh < 62 ? sh : 62);
  if (sh >= u.N + 2) lo_sh = low(0u);
  xout = where64(x_is_low, lo_sh, xfix);
  yout = where64(x_is_low, yfix, lo_sh);
  m_exp = ex > ey ? ex : ey;
}

__device__ __forceinline__ W expand_ieee(int sign, int exp_raw, W man,
                                         const Params& u) {
  const int k_ext = u.N - 2 - u.man_bits;
  W mag = shl64(or64(man, shl64(low(1u), u.man_bits)), k_ext);
  if (exp_raw == 0) mag = low(0u);
  return sign == 1 ? neg64(mag) : mag;
}

__device__ __forceinline__ W expand_hub(int sign, int exp_raw, W man,
                                        const Params& u) {
  const int k = u.N - 2 - u.man_bits;
  const W base = shl64(or64(man, shl64(low(1u), u.man_bits)), k);
  const W top = shl64(low(1u), k - 1 > 0 ? k - 1 : 0);
  W ext = top;
  if (u.unbiased && (man.lo & 1u) == 0u) ext = sub64(top, low(1u));
  if (k <= 0) ext = low(0u);
  if (u.detect_identity && exp_raw == u.bias && eq64(man, low(0u))) ext = low(0u);
  W mag = or64(base, ext);
  if (exp_raw == 0) mag = low(0u);
  return sign == 1 ? not64(mag) : mag;  // HUB negation: bit inversion
}

// _input_convert
__device__ __forceinline__ void input_convert(W xp, W yp, const Params& u,
                                              W& xf, W& yf, int& m_exp) {
  int sx, ex, sy, ey;
  W mx, my;
  unpack(xp, u, sx, ex, mx);
  unpack(yp, u, sy, ey, my);
  if (u.hub) {
    align(expand_hub(sx, ex, mx, u), expand_hub(sy, ey, my, u), ex, ey, u,
          false, xf, yf, m_exp);
  } else {
    align(expand_ieee(sx, ex, mx, u), expand_ieee(sy, ey, my, u), ex, ey, u,
          u.rne != 0, xf, yf, m_exp);
  }
}

__device__ __forceinline__ W saturate_pack(int sign, int exp_new, W man,
                                           const Params& u, bool flush_zero) {
  const bool overflow = exp_new > u.max_exp_raw;
  const int exp_out = exp_new < 1 ? 1 : (overflow ? u.max_exp_raw : exp_new);
  if (overflow) man = low_bits(u.man_bits);
  const W szero = shl64(low((u32)sign), u.exp_bits + u.man_bits);
  if (exp_new <= 0 || flush_zero) return szero;
  return or64(szero, or64(shl64(low((u32)exp_out), u.man_bits), man));
}

__device__ __forceinline__ W output_ieee(W v, int m_exp, const Params& u) {
  const bool neg = is_neg64(v);
  const W a = neg ? neg64(v) : v;
  const bool is_zero = eq64(a, low(0u));
  const W a_safe = is_zero ? low(1u) : a;
  int k = ilog2_64(a_safe);
  const int m = u.man_bits;
  const int down = k - m > 0 ? k - m : 0;
  const int up = m - k > 0 ? m - k : 0;
  W q = shl64(rshift_rne64(a_safe, down), up);
  const i32 carry = (i32)shr64(q, m + 1).lo;  // 0 or 1
  if (carry > 0) q = sar64(q, 1);
  k += carry;
  const W man = sub64(q, shl64(low(1u), m));
  return saturate_pack(neg ? 1 : 0, m_exp + k - (u.N - 2), man, u, is_zero);
}

__device__ __forceinline__ W output_hub(W v, int m_exp, const Params& u) {
  const bool neg = is_neg64(v);
  const W stored = neg ? not64(v) : v;
  const W A = or64(shl64(stored, 1), low(1u));  // append the explicit ILSB
  const int k2 = ilog2_64(A);
  const int m = u.man_bits;
  const int down = k2 - m > 0 ? k2 - m : 0;
  const int up = m - k2 > 0 ? m - k2 : 0;
  const W hi = sar64(A, down);                  // truncation == RN for HUB
  W fill = low(0u);
  if (u.unbiased && up > 0) {
    const W one = shl64(low(1u), up - 1);
    fill = (stored.lo & 1u) == 1u ? one : sub64(one, low(1u));
  }
  const W q = or64(shl64(hi, up), fill);
  const W man = sub64(q, shl64(low(1u), m));
  return saturate_pack(neg ? 1 : 0, m_exp + (k2 - 1) - (u.N - 2), man, u,
                       false);
}

__device__ __forceinline__ W output_convert(W v, int m_exp, const Params& u) {
  return u.hub ? output_hub(v, m_exp, u) : output_ieee(v, m_exp, u);
}

// -- CORDIC core --------------------------------------------------------------

__device__ __forceinline__ W negate_fx(W v, bool hub) { return hub ? not64(v) : neg64(v); }

// HUB carry-in: the ILSB (1) at i == 0, else bit (i-1) of the pre-shift y.
__device__ __forceinline__ u32 carry_bit(W y, int i) {
  return i == 0 ? 1u : sar64(y, i - 1).lo & 1u;
}

__device__ __forceinline__ void microrotation(W& x, W& y, int i, bool d_pos,
                                              bool hub) {
  const W ys = sar64(y, i);
  const W xs = sar64(x, i);
  W xn, yn;
  if (hub) {
    const u32 cy = carry_bit(y, i);
    const u32 cx = carry_bit(x, i);
    xn = d_pos ? add64(add64(x, not64(ys)), low(1u - cy))  // x - (y>>i)
               : add64(add64(x, ys), low(cy));             // x + (y>>i)
    yn = d_pos ? add64(add64(y, xs), low(cx))              // y + (x>>i)
               : add64(add64(y, not64(xs)), low(1u - cx)); // y - (x>>i)
  } else {
    xn = d_pos ? sub64(x, ys) : add64(x, ys);
    yn = d_pos ? add64(y, xs) : sub64(y, xs);
  }
  x = xn;
  y = yn;
}

// _vectoring (gain not applied): flip is 0/1, sig one bit per
// micro-rotation.
__device__ __forceinline__ void vectoring(W& x, W& y, const Params& u,
                                          u32& flip, W& sig) {
  const bool hub = u.hub != 0;
  flip = is_neg64(x) ? 1u : 0u;
  if (flip) {
    x = negate_fx(x, hub);
    y = negate_fx(y, hub);
  }
  sig = low(0u);
  for (int i = 0; i < u.iters; ++i) {
    const bool d_pos = is_neg64(y);
    microrotation(x, y, i, d_pos, hub);
    sig = or64(sig, shl64(low(d_pos ? 1u : 0u), i));
  }
}

// _rotation (gain not applied)
__device__ __forceinline__ void rotation(W& x, W& y, const Params& u, u32 flip,
                                         W sig) {
  const bool hub = u.hub != 0;
  if (flip) {
    x = negate_fx(x, hub);
    y = negate_fx(y, hub);
  }
  for (int i = 0; i < u.iters; ++i)
    microrotation(x, y, i, (shr64(sig, i).lo & 1u) == 1u, hub);
}

// _fixmul with the unit's gain constant (_apply_gain).
__device__ __forceinline__ W apply_gain(W v, const Params& u) {
  const W comp = mk(u.comp_hi, u.comp_lo);
  const W v_lo = and64(v, low(0xFFFFu));
  const W v_hi = sar64(v, 16);
  W acc = add64(mul64(v_hi, comp), sar64(mul64(v_lo, comp), 16));
  const int sh = u.p - 16;
  if (!u.hub) acc = add64(acc, shl64(low(1u), sh - 1));  // round half up
  return sar64(acc, sh);
}

// LaneUnit.rotate on one word pair: (flip, sig) replayed in place.
__device__ __forceinline__ void rotate_pair(W& xp, W& yp, const Params& u,
                                            u32 flip, W sig) {
  W x, y;
  int m_exp;
  input_convert(xp, yp, u, x, y, m_exp);
  rotation(x, y, u, flip, sig);
  xp = output_convert(apply_gain(x, u), m_exp, u);
  yp = output_convert(apply_gain(y, u), m_exp, u);
}

}  // namespace lane
