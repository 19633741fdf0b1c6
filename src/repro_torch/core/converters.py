"""FP <-> block fixed-point converters (torch port of `repro.core.converters`).

Input converter: two packed FP words -> two aligned N-bit two's-complement
significands sharing the larger exponent (block FP).  Output converter: a
rotated w-bit fixed-point value + the common exponent -> a packed FP word
(normalize, round, underflow flush).  Every paper variant: IEEE input
alignment 'rne' or 'trunc'; HUB biased/unbiased extension and identity
detection.

`N` is a static Python int here.  Significands use F = N-2 fraction bits;
the CORDIC datapath width is w = N+2.

Every shift count is kept inside [0, 63].  XLA defines shifts by 64 or
more; C++ does not, and the CUDA kernel (`kernels/csrc/givens_unit.cuh`)
mirrors these functions, so the plain version clamps exactly where the
kernel does.  Clamping never changes a result that is used: alignment
distances of N+2 or more are discarded (`_align`).
"""
from __future__ import annotations

import torch

from .formats import FloatFormat, pack_fields, unpack_fields

__all__ = ["input_convert_ieee", "input_convert_hub",
           "output_convert_ieee", "output_convert_hub", "ilog2"]

#: Largest shift count the port ever uses (the word is 64 bits).
MAX_SHIFT = 63


def ilog2(a):
    """floor(log2(a)) for int64 a > 0 (exact for a < 2^53).

    Goes through float64 `frexp` as the JAX original does; the kernel uses
    a count of leading zeros, which agrees for 0 < a < 2^53.
    """
    _, e = torch.frexp(a.to(torch.float64))
    return (e - 1).to(torch.int64)


def _rshift_rne(v, sh):
    """Arithmetic right shift with round-to-nearest-even on the dropped bits.

    ``sh`` is clamped to [0, 63]; callers discard results for larger
    distances.
    """
    sh = torch.clamp(sh, 0, MAX_SHIFT)
    q = v >> sh
    rem = v - (q << sh)
    one = torch.ones_like(sh)
    half = torch.where(sh > 0, one << torch.clamp(sh - 1, min=0), 0)
    round_up = ((rem > half) | ((rem == half) & ((q & 1) == 1))) & (sh > 0)
    return q + round_up.to(torch.int64)


def _align(xfix, yfix, ex, ey, N, round_mode):
    """Shift the significand with the smaller exponent right by |ex - ey|.

    round_mode: 'rne' | 'trunc' (conventional) | 'hub' (truncation *is* RN).
    The shifter forces exact zero when the distance exceeds the word width.
    """
    d_xy = ex - ey
    x_is_low = d_xy < 0
    sh = torch.abs(d_xy)
    lo = torch.where(x_is_low, xfix, yfix)
    if round_mode == "rne":
        lo_sh = _rshift_rne(lo, sh)
    else:  # 'trunc' and 'hub': plain arithmetic shift
        lo_sh = lo >> torch.clamp(sh, max=62)
    lo_sh = torch.where(sh >= N + 2, 0, lo_sh)
    xout = torch.where(x_is_low, lo_sh, xfix)
    yout = torch.where(x_is_low, yfix, lo_sh)
    m_exp = torch.maximum(ex, ey)
    return xout, yout, m_exp


def _expand_ieee(sign, exp_raw, man, fmt: FloatFormat, N):
    """Packed fields -> N-bit two's-complement significand (no alignment yet)."""
    is_zero = exp_raw == 0
    k_ext = N - 2 - fmt.man_bits  # appended zeros; requires N >= m + 2
    mag = ((1 << fmt.man_bits) | man) << k_ext
    mag = torch.where(is_zero, 0, mag)
    return torch.where(sign == 1, -mag, mag)


def input_convert_ieee(x_packed, y_packed, fmt: FloatFormat, N, rounding="rne"):
    """Conventional input converter (Fig. 2). rounding: 'rne' | 'trunc'."""
    sx, ex, mx = unpack_fields(x_packed, fmt)
    sy, ey, my = unpack_fields(y_packed, fmt)
    xf = _expand_ieee(sx, ex, mx, fmt, N)
    yf = _expand_ieee(sy, ey, my, fmt, N)
    return _align(xf, yf, ex, ey, N, rounding)


def _expand_hub(sign, exp_raw, man, fmt: FloatFormat, N,
                unbiased: bool, detect_identity: bool):
    """Packed HUB fields -> N-bit HUB significand (Fig. 5).

    Extension below the m explicit fraction bits (k = N-2-m bits):
      biased   : ILSB '1' then zeros                     ('1000...')
      unbiased : explicit-LSB then its inverse repeated  ('1000..'/'0111..')
      identity : exact 1.0 detected (exp==bias, man==0) -> all-zero extension.
    """
    is_zero = exp_raw == 0
    k = N - 2 - fmt.man_bits
    base = ((1 << fmt.man_bits) | man) << k
    top = 1 << max(k - 1, 0)
    if unbiased:
        ext = torch.where((man & 1) == 1, top, top - 1)
    else:
        ext = torch.full_like(man, top)
    if k <= 0:
        ext = torch.zeros_like(man)
    if detect_identity:
        is_one = (exp_raw == fmt.bias) & (man == 0)
        ext = torch.where(is_one, 0, ext)
    mag = base | ext
    mag = torch.where(is_zero, 0, mag)
    # HUB negation: pure bit inversion (the ILSB absorbs the +1).
    return torch.where(sign == 1, ~mag, mag)


def input_convert_hub(x_packed, y_packed, fmt: FloatFormat, N,
                      unbiased=True, detect_identity=True):
    """HUB input converter (Fig. 5)."""
    sx, ex, mx = unpack_fields(x_packed, fmt)
    sy, ey, my = unpack_fields(y_packed, fmt)
    xf = _expand_hub(sx, ex, mx, fmt, N, unbiased, detect_identity)
    yf = _expand_hub(sy, ey, my, fmt, N, unbiased, detect_identity)
    return _align(xf, yf, ex, ey, N, "hub")


def _saturate_pack(sign, exp_new, man, fmt: FloatFormat, flush_zero):
    overflow = exp_new > fmt.max_exp_raw
    exp_out = torch.clamp(exp_new, 1, fmt.max_exp_raw)
    man = torch.where(overflow, (1 << fmt.man_bits) - 1, man)
    packed = pack_fields(sign, exp_out, man, fmt)
    underflow = (exp_new <= 0) | flush_zero
    return torch.where(underflow, sign << (fmt.exp_bits + fmt.man_bits), packed)


def output_convert_ieee(v, m_exp, fmt: FloatFormat, N):
    """Conventional output converter (Fig. 4): normalize + RNE + exponent."""
    sign = (v < 0).to(torch.int64)
    a = torch.abs(v)
    is_zero = a == 0
    a_safe = torch.where(is_zero, 1, a)
    k = ilog2(a_safe)  # leading-one position
    m = fmt.man_bits
    # Keep m+1 significant bits with RNE on the discarded ones.
    down = torch.clamp(k - m, min=0)
    up = torch.clamp(m - k, min=0)
    q = _rshift_rne(a_safe, down) << up
    # Rounding may carry out: q == 2^(m+1).
    carry = q >> (m + 1)
    q = torch.where(carry > 0, q >> 1, q)
    k = k + carry
    man = q - (1 << m)
    exp_new = m_exp + k - (N - 2)
    return _saturate_pack(sign, exp_new, man, fmt, is_zero)


def output_convert_hub(v, m_exp, fmt: FloatFormat, N, unbiased=True):
    """HUB output converter (Fig. 7): invert-negate, append ILSB, truncate.

    No sticky bit, no round-up adder, no mantissa-overflow path — truncation
    of a HUB word is round-to-nearest.
    """
    sign = (v < 0).to(torch.int64)
    stored = torch.where(sign == 1, ~v, v)  # |value| stored part, >= 0
    A = (stored << 1) | 1                    # append the explicit ILSB
    k2 = ilog2(A)                            # A >= 1 always
    m = fmt.man_bits
    down = torch.clamp(k2 - m, min=0)
    up = torch.clamp(m - k2, min=0)
    hi = A >> down                           # truncation == RN for HUB
    if unbiased:
        # bits shifted in during left normalization: first = stored LSB,
        # rest = its inverse ('1000...' / '0111...'), Sec. 4.3.
        top = torch.ones_like(up) << torch.clamp(up - 1, min=0)
        fill = torch.where((stored & 1) == 1, top, top - 1)
        fill = torch.where(up > 0, fill, 0)
    else:
        fill = 0
    q = (hi << up) | fill
    man = q - (1 << m)
    exp_new = m_exp + (k2 - 1) - (N - 2)
    return _saturate_pack(sign, exp_new, man, fmt, torch.zeros_like(sign, dtype=torch.bool))
