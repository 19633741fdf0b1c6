# The paper's unit as torch int64 ops (bit-identical to `repro.core`) and
# the QR routines built on it.
from .formats import (FloatFormat, HALF, SINGLE, DOUBLE,
                      encode_ieee, decode_ieee, encode_hub, decode_hub,
                      pack_fields, unpack_fields, packed_is_zero)
from .givens import GivensConfig, GivensUnit
from .qrd import (qr_cordic, qr_cordic_pallas, qr_cordic_wavefront,
                  qr_cordic_complex, givens_schedule, sameh_kuck_schedule)
from . import cordic, converters

__all__ = [
    "FloatFormat", "HALF", "SINGLE", "DOUBLE",
    "encode_ieee", "decode_ieee", "encode_hub", "decode_hub",
    "pack_fields", "unpack_fields", "packed_is_zero",
    "GivensConfig", "GivensUnit",
    "qr_cordic", "qr_cordic_pallas", "qr_cordic_wavefront",
    "qr_cordic_complex", "givens_schedule",
    "sameh_kuck_schedule", "cordic", "converters",
]
