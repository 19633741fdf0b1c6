# The paper's unit as torch int64 ops (bit-identical to `repro.core`), the
# QR routines built on it, the baselines and the HUB primitive.
from .formats import (FloatFormat, HALF, SINGLE, DOUBLE,
                      encode_ieee, decode_ieee, encode_hub, decode_hub,
                      pack_fields, unpack_fields, packed_is_zero)
from .givens import GivensConfig, GivensUnit
from .qrd import (QRDEngine, qr_cordic, qr_cordic_pallas, qr_blockfp_pallas,
                  qr_cordic_wavefront, qr_blockfp_wavefront,
                  qr_cordic_complex, qr_cordic_complex_pallas,
                  qr_cordic_complex_wavefront, qr_givens_float, qr_jnp,
                  qr_fixed, snr_db, givens_schedule, sameh_kuck_schedule)
from .hub import hub_quantize, hub_error_bound
from . import cordic, converters

__all__ = [
    "FloatFormat", "HALF", "SINGLE", "DOUBLE",
    "encode_ieee", "decode_ieee", "encode_hub", "decode_hub",
    "pack_fields", "unpack_fields", "packed_is_zero",
    "GivensConfig", "GivensUnit",
    "QRDEngine", "qr_cordic", "qr_cordic_pallas", "qr_blockfp_pallas",
    "qr_cordic_wavefront", "qr_blockfp_wavefront",
    "qr_cordic_complex", "qr_cordic_complex_pallas",
    "qr_cordic_complex_wavefront", "qr_givens_float", "qr_jnp", "qr_fixed",
    "snr_db", "givens_schedule", "sameh_kuck_schedule",
    "hub_quantize", "hub_error_bound",
    "cordic", "converters",
]
