"""Built-in backend registrations (torch port of `repro.qrd.backends`).

The JAX package's six built-ins, with the same capability records and
routing:

  'jnp'             the LAPACK reference, ``torch.linalg.qr`` in the
                    config's dtype (schedule-agnostic)
  'givens_float'    float Givens rotations, column-major schedule, any
                    float or complex dtype
  'cordic'          the paper's unit, host loop (the kernels' plain
                    versions); ``schedule='sameh_kuck'`` takes the flattened
                    stage order, complex operands the three-rotation loop
  'cordic_pallas'   the same unit in the CUDA kernels, bit-identical to it:
                    the flat kernel, or with ``schedule='sameh_kuck'`` the
                    wavefront kernel; complex operands on the complex flat
                    or wavefront kernel
  'blockfp_pallas'  the int32 block-FP fast path on its flat or wavefront
                    CUDA kernel (real dtypes only)
  'fixed'           the 32-bit fixed-point rotator of [20]
                    (schedule-agnostic)

The three baselines run no kernel of this package.  Importing this module
(``repro_torch.qrd`` does) populates the registry.
"""
from __future__ import annotations

from repro_torch.core import qrd as _q
from repro_torch.core.givens import GivensUnit

from .registry import (BackendCapabilities, available_backends,
                       register_backend)

__all__ = ["register_builtin_backends"]


def _flat_steps(config, m, n):
    """Schedule for step-serial backends: None = column-major default."""
    if config.schedule == "sameh_kuck":
        return tuple(s for st in _q.sameh_kuck_schedule(m, n) for s in st)
    return None


def _build_jnp(config, m, n, compute_q):
    return lambda A: _q.qr_jnp(A, config.dtype, compute_q=compute_q)


def _build_givens_float(config, m, n, compute_q):
    return lambda A: _q.qr_givens_float(A, dtype=config.dtype,
                                        compute_q=compute_q)


def _build_cordic(config, m, n, compute_q):
    unit = GivensUnit(config.givens)
    steps = _flat_steps(config, m, n)
    if config.is_complex():               # the three-rotation datapath
        return lambda A: _q.qr_cordic_complex(A, unit, compute_q=compute_q,
                                              steps=steps)
    return lambda A: _q.qr_cordic(A, unit, compute_q=compute_q, steps=steps)


def _build_cordic_pallas(config, m, n, compute_q):
    unit = GivensUnit(config.givens)
    tile_b, layout = config.tile_b, config.table_layout
    if config.schedule == "sameh_kuck":   # the wavefront kernels
        stages = _q.sameh_kuck_schedule(m, n)
        if config.is_complex():
            return lambda A: _q.qr_cordic_complex_wavefront(
                A, unit, compute_q=compute_q, stages=stages, tile_b=tile_b,
                table_layout=layout)
        return lambda A: _q.qr_cordic_wavefront(
            A, unit, compute_q=compute_q, stages=stages, tile_b=tile_b,
            table_layout=layout)
    if config.is_complex():
        return lambda A: _q.qr_cordic_complex_pallas(
            A, unit, compute_q=compute_q, tile_b=tile_b)
    return lambda A: _q.qr_cordic_pallas(A, unit, compute_q=compute_q,
                                         tile_b=tile_b)


def _build_blockfp_pallas(config, m, n, compute_q):
    iters, hub, frac = (config.blockfp_iters(), config.blockfp_hub(),
                        config.frac)
    tile_b, layout = config.tile_b, config.table_layout
    if config.schedule == "sameh_kuck":
        stages = _q.sameh_kuck_schedule(m, n)
        return lambda A: _q.qr_blockfp_wavefront(
            A, compute_q=compute_q, iters=iters, hub=hub, frac=frac,
            stages=stages, tile_b=tile_b, table_layout=layout)
    return lambda A: _q.qr_blockfp_pallas(A, compute_q=compute_q, iters=iters,
                                          hub=hub, frac=frac, tile_b=tile_b)


def _build_fixed(config, m, n, compute_q):
    return lambda A: _q.qr_fixed(A, config.fixed_width, config.fixed_iters,
                                 config.fixed_scale_exp, compute_q=compute_q)


def register_builtin_backends(overwrite=False):
    """Populate the registry with the six built-in backends (idempotent)."""
    entries = (
        ("jnp", _build_jnp, BackendCapabilities(
            bit_exact=False, wavefront=False, sharding=False,
            dtypes=("float16", "float32", "float64",
                    "complex64", "complex128"),
            description="jnp.linalg.qr Householder reference "
                        "(schedule-agnostic; 'sameh_kuck' degrades to it)")),
        ("givens_float", _build_givens_float, BackendCapabilities(
            bit_exact=False, wavefront=False, sharding=False,
            dtypes=("float16", "float32", "float64",
                    "complex64", "complex128"),
            description="float Givens baseline, column-major schedule "
                        "(complex via conjugate rotations)")),
        ("cordic", _build_cordic, BackendCapabilities(
            bit_exact=True, wavefront=False, sharding=True,
            dtypes=("float64", "complex128"),
            description="the paper's unit, host reference loop "
                        "('sameh_kuck' consumes the flattened stage order; "
                        "complex via the three-rotation decomposition)")),
        ("cordic_pallas", _build_cordic_pallas, BackendCapabilities(
            bit_exact=True, wavefront=True, sharding=True,
            dtypes=("float64", "complex128"),
            max_shape=(128, 128), supports_tiling=True,
            description="kernel-resident unit, bit-identical to 'cordic'; "
                        "'sameh_kuck' routes onto the wavefront datapath")),
        ("blockfp_pallas", _build_blockfp_pallas, BackendCapabilities(
            bit_exact=False, wavefront=True, sharding=True,
            max_shape=(128, 128), supports_tiling=True,
            description="int32 block-FP blocked kernel (fast TPU path)")),
        ("fixed", _build_fixed, BackendCapabilities(
            bit_exact=False, wavefront=False, sharding=False,
            description="32-bit fixed-point rotator of [20] "
                        "(Fig. 11 baseline; schedule-agnostic)")),
    )
    registered = available_backends()
    for name, builder, caps in entries:
        if overwrite or name not in registered:
            register_backend(name, builder, caps, overwrite=overwrite)


register_builtin_backends()
