// The paper's Givens rotation unit as CUDA device functions, one per
// function of the plain PyTorch version (repro_torch/core/converters.py,
// cordic.py, givens.py), so the packed words agree bit for bit.
//
// Arithmetic rules (each one a bit-exactness or undefined-behaviour trap):
//  * Signed 64-bit arithmetic is safe inside validated configs: the
//    bit-width verifier of the JAX package (repro.analysis.bitflow) bounds
//    every intermediate, fixmul's partial products included, below 2^63
//    for N <= 50.  `>>` on a negative long long is arithmetic under nvcc.
//  * Left shifts and field masks go through unsigned long long, so
//    shifting into or past the sign bit is defined.
//  * Every shift count stays in [0, 63].  The alignment distance
//    |ex - ey| is unbounded; results for distances >= N + 2 are discarded,
//    so the count is clamped before shifting (the plain version clamps at
//    the same places).
//  * ilog2 is 63 - clz; the plain version goes through float64 frexp.
//    They agree for 0 < a < 2^53, which N <= 50 guarantees.
//  * The gain constant is computed on the host (numpy, as the JAX package
//    does) and passed in; it is never recomputed in device double.
#pragma once

namespace gru {

typedef long long i64;
typedef unsigned long long u64;

struct UnitParams {
  int man_bits;
  int exp_bits;
  i64 bias;
  i64 max_exp_raw;
  int N;
  int iters;
  int hub;              // HUB datapath (else conventional IEEE-like)
  int rne;              // IEEE input alignment: 1 = 'rne', 0 = 'trunc'
  int unbiased;         // HUB: unbiased extension
  int detect_identity;  // HUB: exact 1.0 detection
  i64 comp;             // round(2^p / K(iters))
  int p;                // shift of the gain constant
};

__device__ __forceinline__ i64 shl(i64 v, int s) {  // s in [0, 63]
  return (i64)((u64)v << s);
}

__device__ __forceinline__ int clamp_shift(i64 sh, int hi) {
  return sh < 0 ? 0 : (sh > hi ? hi : (int)sh);
}

__device__ __forceinline__ i64 ilog2(i64 a) {  // a > 0
  return 63 - __clzll(a);
}

// formats.unpack_fields / pack_fields
__device__ __forceinline__ void unpack_fields(i64 packed, const UnitParams& u,
                                              i64& sign, i64& exp_raw, i64& man) {
  const u64 w = (u64)packed;
  man = (i64)(w & ((1ULL << u.man_bits) - 1ULL));
  exp_raw = (i64)((w >> u.man_bits) & ((1ULL << u.exp_bits) - 1ULL));
  sign = (i64)((w >> (u.exp_bits + u.man_bits)) & 1ULL);
}

__device__ __forceinline__ i64 pack_fields(i64 sign, i64 exp_raw, i64 man,
                                           const UnitParams& u) {
  return (i64)(((u64)sign << (u.exp_bits + u.man_bits)) |
               ((u64)exp_raw << u.man_bits) | (u64)man);
}

// converters._rshift_rne
__device__ __forceinline__ i64 rshift_rne(i64 v, i64 sh_in) {
  const int sh = clamp_shift(sh_in, 63);
  const i64 q = v >> sh;
  const i64 rem = (i64)((u64)v - ((u64)q << sh));
  const i64 half = sh > 0 ? (i64)(1ULL << (sh - 1)) : 0;
  const bool up = sh > 0 && (rem > half || (rem == half && (q & 1) == 1));
  return q + (up ? 1 : 0);
}

// converters._align
__device__ __forceinline__ void align(i64 xf, i64 yf, i64 ex, i64 ey,
                                      const UnitParams& u, bool rne,
                                      i64& xout, i64& yout, i64& m_exp) {
  const i64 d = ex - ey;
  const bool x_is_low = d < 0;
  const i64 sh = x_is_low ? -d : d;
  const i64 lo = x_is_low ? xf : yf;
  i64 lo_sh = rne ? rshift_rne(lo, sh) : (lo >> clamp_shift(sh, 62));
  if (sh >= u.N + 2) lo_sh = 0;
  xout = x_is_low ? lo_sh : xf;
  yout = x_is_low ? yf : lo_sh;
  m_exp = ex > ey ? ex : ey;
}

// converters._expand_ieee
__device__ __forceinline__ i64 expand_ieee(i64 sign, i64 exp_raw, i64 man,
                                           const UnitParams& u) {
  const int k_ext = u.N - 2 - u.man_bits;
  i64 mag = shl((1LL << u.man_bits) | man, k_ext);
  if (exp_raw == 0) mag = 0;
  return sign == 1 ? -mag : mag;
}

// converters._expand_hub
__device__ __forceinline__ i64 expand_hub(i64 sign, i64 exp_raw, i64 man,
                                          const UnitParams& u) {
  const int k = u.N - 2 - u.man_bits;
  const i64 base = shl((1LL << u.man_bits) | man, k);
  const i64 top = 1LL << (k - 1 > 0 ? k - 1 : 0);
  i64 ext = u.unbiased ? ((man & 1) == 1 ? top : top - 1) : top;
  if (k <= 0) ext = 0;
  if (u.detect_identity && exp_raw == u.bias && man == 0) ext = 0;
  i64 mag = base | ext;
  if (exp_raw == 0) mag = 0;
  return sign == 1 ? ~mag : mag;  // HUB negation: bit inversion
}

// GivensUnit._to_fixed: input_convert_ieee / input_convert_hub
__device__ __forceinline__ void to_fixed(i64 xp, i64 yp, const UnitParams& u,
                                         i64& xf, i64& yf, i64& m_exp) {
  i64 sx, ex, mx, sy, ey, my;
  unpack_fields(xp, u, sx, ex, mx);
  unpack_fields(yp, u, sy, ey, my);
  if (u.hub) {
    align(expand_hub(sx, ex, mx, u), expand_hub(sy, ey, my, u), ex, ey, u,
          false, xf, yf, m_exp);
  } else {
    align(expand_ieee(sx, ex, mx, u), expand_ieee(sy, ey, my, u), ex, ey, u,
          u.rne != 0, xf, yf, m_exp);
  }
}

// converters._saturate_pack
__device__ __forceinline__ i64 saturate_pack(i64 sign, i64 exp_new, i64 man,
                                             const UnitParams& u, bool flush) {
  const bool overflow = exp_new > u.max_exp_raw;
  const i64 exp_out = exp_new < 1 ? 1 : (overflow ? u.max_exp_raw : exp_new);
  if (overflow) man = (1LL << u.man_bits) - 1;
  if (exp_new <= 0 || flush) return (i64)((u64)sign << (u.exp_bits + u.man_bits));
  return pack_fields(sign, exp_out, man, u);
}

// converters.output_convert_ieee
__device__ __forceinline__ i64 output_convert_ieee(i64 v, i64 m_exp,
                                                   const UnitParams& u) {
  const i64 sign = v < 0 ? 1 : 0;
  const i64 a = v < 0 ? -v : v;
  const bool is_zero = a == 0;
  const i64 a_safe = is_zero ? 1 : a;
  i64 k = ilog2(a_safe);
  const int m = u.man_bits;
  const i64 down = k - m > 0 ? k - m : 0;
  const int up = clamp_shift(m - k, 63);
  i64 q = shl(rshift_rne(a_safe, down), up);
  const i64 carry = q >> (m + 1);  // rounding may carry out: q == 2^(m+1)
  if (carry > 0) q >>= 1;
  k += carry;
  const i64 man = q - (1LL << m);
  return saturate_pack(sign, m_exp + k - (u.N - 2), man, u, is_zero);
}

// converters.output_convert_hub
__device__ __forceinline__ i64 output_convert_hub(i64 v, i64 m_exp,
                                                  const UnitParams& u) {
  const i64 sign = v < 0 ? 1 : 0;
  const i64 stored = sign ? ~v : v;
  const i64 A = shl(stored, 1) | 1;
  const i64 k2 = ilog2(A);
  const int m = u.man_bits;
  const int down = clamp_shift(k2 - m, 63);
  const int up = clamp_shift(m - k2, 63);
  const i64 hi = A >> down;
  i64 fill = 0;
  if (u.unbiased && up > 0) {
    const i64 top = 1LL << (up - 1);
    fill = (stored & 1) == 1 ? top : top - 1;
  }
  const i64 q = shl(hi, up) | fill;
  const i64 man = q - (1LL << m);
  return saturate_pack(sign, m_exp + (k2 - 1) - (u.N - 2), man, u, false);
}

// GivensUnit._to_float
__device__ __forceinline__ i64 to_float(i64 v, i64 m_exp, const UnitParams& u) {
  return u.hub ? output_convert_hub(v, m_exp, u) : output_convert_ieee(v, m_exp, u);
}

// cordic._microrotation
__device__ __forceinline__ void microrotation(i64& x, i64& y, int i, bool d_pos,
                                              bool hub) {
  const i64 ys = y >> i;
  const i64 xs = x >> i;
  i64 xn, yn;
  if (hub) {
    const i64 cy = i == 0 ? 1 : (y >> (i - 1)) & 1;
    const i64 cx = i == 0 ? 1 : (x >> (i - 1)) & 1;
    xn = d_pos ? x + ~ys + (1 - cy) : x + ys + cy;
    yn = d_pos ? y + xs + cx : y + ~xs + (1 - cx);
  } else {
    xn = d_pos ? x - ys : x + ys;
    yn = d_pos ? y + xs : y - xs;
  }
  x = xn;
  y = yn;
}

// cordic.vectoring (gain not applied)
__device__ __forceinline__ void vectoring(i64& x, i64& y, const UnitParams& u,
                                          i64& flip, i64& sig) {
  const bool hub = u.hub != 0;
  flip = x < 0 ? 1 : 0;
  if (flip) {
    x = hub ? ~x : -x;
    y = hub ? ~y : -y;
  }
  sig = 0;
  for (int i = 0; i < u.iters; ++i) {
    const bool d_pos = y < 0;
    microrotation(x, y, i, d_pos, hub);
    if (d_pos) sig |= (i64)(1ULL << i);
  }
}

// cordic.rotation (gain not applied)
__device__ __forceinline__ void rotation(i64& x, i64& y, const UnitParams& u,
                                         i64 flip, i64 sig) {
  const bool hub = u.hub != 0;
  if (flip) {
    x = hub ? ~x : -x;
    y = hub ? ~y : -y;
  }
  for (int i = 0; i < u.iters; ++i)
    microrotation(x, y, i, ((sig >> i) & 1) == 1, hub);
}

// cordic.fixmul with the unit's gain constant (cordic.apply_gain)
__device__ __forceinline__ i64 apply_gain(i64 v, const UnitParams& u) {
  const i64 v_lo = v & 0xFFFF;
  const i64 v_hi = v >> 16;
  i64 acc = v_hi * u.comp + ((v_lo * u.comp) >> 16);
  const int sh = u.p - 16;
  if (!u.hub) acc += 1LL << (sh - 1);  // round half up; HUB truncates
  return acc >> sh;
}

// GivensUnit.rotate on one packed element pair: replay (flip, sig) in place.
__device__ __forceinline__ void rotate_pair(i64& xp, i64& yp, const UnitParams& u,
                                            i64 flip, i64 sig) {
  i64 x, y, m_exp;
  to_fixed(xp, yp, u, x, y, m_exp);
  rotation(x, y, u, flip, sig);
  xp = to_float(apply_gain(x, u), m_exp, u);
  yp = to_float(apply_gain(y, u), m_exp, u);
}

// formats.packed_is_zero: the word encodes +-0 (raw exponent field 0).
__device__ __forceinline__ bool packed_is_zero(i64 packed, const UnitParams& u) {
  return (((u64)packed >> u.man_bits) & ((1ULL << u.exp_bits) - 1ULL)) == 0;
}

// GivensUnit.phase_vector: vectoring on the (re, im) lane pair of a complex
// lead entry.  Returns the realized entry |z| packed (the raw real word
// where skip), the phase control word (flip, sig), and skip: the imaginary
// word is +-0, so the phase rotation is the exact identity.
__device__ __forceinline__ void phase_vector(i64 re, i64 im, const UnitParams& u,
                                             i64& mag, i64& flip, i64& sig,
                                             bool& skip) {
  i64 x, y, m_exp;
  to_fixed(re, im, u, x, y, m_exp);
  vectoring(x, y, u, flip, sig);
  skip = packed_is_zero(im, u);
  mag = skip ? re : to_float(apply_gain(x, u), m_exp, u);
}

// GivensUnit.phase_rotate: the phase control word replayed on one (re, im)
// pair in place; where skip the pair passes through untouched.
__device__ __forceinline__ void phase_rotate(i64& re, i64& im, const UnitParams& u,
                                             i64 flip, i64 sig, bool skip) {
  if (!skip) rotate_pair(re, im, u, flip, sig);
}

}  // namespace gru
