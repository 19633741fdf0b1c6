"""Floating-point formats and packed-integer codecs (torch port of
`repro.core.formats`).

Packed int64 words with the layout ``[ sign(1) | exponent(e) | mantissa(m) ]``:

- Conventional decode:  (-1)^s * (1 + M/2^m)            * 2^(E - bias)
- HUB decode:           (-1)^s * (1 + M/2^m + 2^-(m+1)) * 2^(E - bias)
- E == 0 encodes exact zero in either format (no subnormals).

Encoding from binary64 rounds to nearest-even for the conventional format
and truncates for HUB (truncation *is* round-to-nearest for HUB).  Every
function takes torch tensors on any device and is bit-identical to the
JAX original.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "FloatFormat", "HALF", "SINGLE", "DOUBLE",
    "encode_ieee", "decode_ieee", "encode_hub", "decode_hub",
    "pack_fields", "unpack_fields", "packed_is_zero",
]


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """An IEEE754-like storage format: 1 sign, `exp_bits`, `man_bits`."""

    exp_bits: int
    man_bits: int
    name: str = ""

    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def max_exp_raw(self) -> int:
        # Largest *raw* exponent we emit; the all-ones code is avoided so the
        # packed space stays NaN/Inf-free (the converters saturate instead).
        return (1 << self.exp_bits) - 2

    @property
    def total_bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits

    def __post_init__(self):
        # 64 fits: the sign bit may occupy bit 63 (int64 wraps are benign —
        # packed words are bit patterns, all field accesses go through masks).
        if self.total_bits > 64:
            raise ValueError("packed format must fit int64")


HALF = FloatFormat(5, 10, "half")
SINGLE = FloatFormat(8, 23, "single")
DOUBLE = FloatFormat(11, 52, "double")


def _i64(v):
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64)
    return torch.tensor(v, dtype=torch.int64)


def _exp2(e):
    """Exact 2^e as float64 for int64 e, built from the exponent field.

    `torch.ldexp` multiplies by ``pow(2, e)``, whose exactness rests on each
    device's `pow`; this form is exact by construction for every exponent
    a format with at most 11 exponent bits can hold (e clamped to the
    float64 normal range).
    """
    e = torch.clamp(e, -1022, 1023)
    return ((e + 1023) << 52).view(torch.float64)


def pack_fields(sign, exp_raw, man, fmt: FloatFormat):
    """Assemble packed int64 words from (sign, raw exponent, mantissa)."""
    sign, exp_raw, man = _i64(sign), _i64(exp_raw), _i64(man)
    return (sign << (fmt.exp_bits + fmt.man_bits)) | (exp_raw << fmt.man_bits) | man


def unpack_fields(packed, fmt: FloatFormat):
    """Split packed words into (sign, raw exponent, mantissa)."""
    packed = _i64(packed)
    man = packed & ((1 << fmt.man_bits) - 1)
    exp_raw = (packed >> fmt.man_bits) & ((1 << fmt.exp_bits) - 1)
    sign = (packed >> (fmt.exp_bits + fmt.man_bits)) & 1
    return sign, exp_raw, man


def packed_is_zero(packed, fmt: FloatFormat):
    """True where a packed word encodes ±0 (raw exponent field 0)."""
    packed = _i64(packed)
    return ((packed >> fmt.man_bits) & ((1 << fmt.exp_bits) - 1)) == 0


def _split_finite(x):
    """x (float64) -> sign, unbiased exponent, significand in [1, 2), is_zero."""
    x = torch.as_tensor(x, dtype=torch.float64)
    sign = torch.signbit(x).to(torch.int64)
    ax = torch.abs(x)
    is_zero = ax == 0.0
    # frexp: ax = f * 2^e with f in [0.5, 1)  ->  significand 2f in [1,2).
    f, e = torch.frexp(torch.where(is_zero, torch.ones_like(ax), ax))
    return sign, (e - 1).to(torch.int64), 2.0 * f, is_zero


def _saturate_encode(sign, e, man, is_zero, fmt: FloatFormat):
    exp_raw = e + fmt.bias
    underflow = exp_raw < 1
    overflow = exp_raw > fmt.max_exp_raw
    exp_raw = torch.clamp(exp_raw, 1, fmt.max_exp_raw)
    man = torch.where(overflow, (1 << fmt.man_bits) - 1, man)
    packed = pack_fields(sign, exp_raw, man, fmt)
    return torch.where(is_zero | underflow,
                       sign << (fmt.exp_bits + fmt.man_bits), packed)


def encode_ieee(x, fmt: FloatFormat):
    """binary64 -> packed conventional word (RNE; saturates, flushes to 0)."""
    sign, e, sig, is_zero = _split_finite(x)
    scale = float(1 << fmt.man_bits)
    man = torch.round((sig - 1.0) * scale).to(torch.int64)  # half to even
    # Mantissa rounding may carry out (sig ~ 2.0).
    carry = man >> fmt.man_bits
    man = torch.where(carry > 0, 0, man)
    return _saturate_encode(sign, e + carry, man, is_zero, fmt)


def _decode(sign, exp_raw, sig, fmt: FloatFormat):
    val = sig * _exp2(exp_raw - fmt.bias)
    val = torch.where(exp_raw == 0, 0.0, val)
    return torch.where(sign == 1, -val, val)


def decode_ieee(packed, fmt: FloatFormat):
    """packed conventional word -> binary64."""
    sign, exp_raw, man = unpack_fields(packed, fmt)
    sig = 1.0 + man.to(torch.float64) / float(1 << fmt.man_bits)
    return _decode(sign, exp_raw, sig, fmt)


def encode_hub(x, fmt: FloatFormat):
    """binary64 -> packed HUB word.

    Round-to-nearest for HUB is *truncation* of the mantissa field.
    """
    sign, e, sig, is_zero = _split_finite(x)
    scale = float(1 << fmt.man_bits)
    man = torch.floor((sig - 1.0) * scale).to(torch.int64)  # truncate == RN(HUB)
    man = torch.clamp(man, 0, (1 << fmt.man_bits) - 1)  # sig==2.0 cannot occur
    return _saturate_encode(sign, e, man, is_zero, fmt)


def decode_hub(packed, fmt: FloatFormat):
    """packed HUB word -> binary64 (includes the ILSB term 2^-(m+1))."""
    sign, exp_raw, man = unpack_fields(packed, fmt)
    scale = float(1 << fmt.man_bits)
    sig = 1.0 + (man.to(torch.float64) + 0.5) / scale
    return _decode(sign, exp_raw, sig, fmt)
