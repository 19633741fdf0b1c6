"""QR decomposition routines on the Givens rotation unit (torch port of the
`repro.core.qrd` pieces on the main path).

An m x n input is triangularized by the column-major Givens schedule, and
Q is obtained by augmenting the rows with the identity (the 1.0 entries of
I enter the unit as data).  Three routines on packed words, bit-identical
to each other and to `repro.core.qrd`:

  `qr_cordic`         the host loop: the plain PyTorch version of the kernel
  `qr_cordic_pallas`  the kernel: every schedule step on one resident tile
                      (`repro_torch.kernels.ops.qr_packed`)
  `qr_cordic_panel`   the panel route: panel factorizations whose control
                      words are replayed over the trailing columns
                      (`repro_torch.kernels.ops.qr_packed_panel`)

  `qr_cordic_wavefront` the Sameh–Kuck wavefront: every stage's disjoint
                      row pairs at once, bit-identical to the others on the
                      flattened stage schedule
                      (`repro_torch.kernels.ops.qr_packed_wavefront`)

three on the int32 block-FP fast path, bit-identical to each other:

  `qr_blockfp_pallas` quantize once, every step in one kernel, decode once
                      (`repro_torch.kernels.ops.givens_block_apply`)
  `qr_blockfp_panel`  its panel route
                      (`repro_torch.kernels.ops.givens_block_apply_panel`)
  `qr_blockfp_wavefront` its wavefront
                      (`repro_torch.kernels.ops.givens_block_apply_wavefront`)

three on the complex datapath (the three-rotation decomposition on
(re, im) lane pairs), bit-identical to each other: `qr_cordic_complex` (the
host loop), `qr_cordic_complex_pallas` and `qr_cordic_complex_wavefront`;
and the three baselines the paper compares the unit with, which run no
kernel of this package:

  `qr_givens_float`   float Givens rotations on the same schedule, any
                      float or complex dtype
  `qr_jnp`            the LAPACK reference, ``torch.linalg.qr``
  `qr_fixed`          the W-bit fixed-point rotator of [20]

with the error metric `snr_db` and the legacy dataclass facade
`QRDEngine` over `repro_torch.qrd.QRDEngine`.

The names ``*_pallas`` are kept so configurations carry over between the
two packages; on the GPU they are the CUDA kernels of ``kernels/csrc``.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Any

import numpy as np
import torch

from . import cordic
from .givens import GivensConfig, GivensUnit

__all__ = ["qr_cordic", "qr_cordic_pallas", "qr_cordic_panel",
           "qr_cordic_wavefront", "qr_blockfp_pallas", "qr_blockfp_panel",
           "qr_blockfp_wavefront", "qr_cordic_complex",
           "qr_cordic_complex_pallas", "qr_cordic_complex_wavefront",
           "qr_givens_float", "qr_jnp", "qr_fixed", "QRDEngine", "snr_db",
           "givens_schedule", "sameh_kuck_schedule"]

#: Bound on the host-side schedule memoization.
SCHEDULE_CACHE_SIZE = 128


@lru_cache(maxsize=SCHEDULE_CACHE_SIZE)
def givens_schedule(m: int, n: int):
    """Column-major zeroing order for an m x n matrix (memoized).

    ``(pivot_row, target_row, col)`` triples: entry ``(target_row, col)`` is
    annihilated against the diagonal row ``col``, one column at a time.
    """
    return tuple((k, j, k)
                 for k in range(min(m - 1, n))
                 for j in range(k + 1, m))


@lru_cache(maxsize=SCHEDULE_CACHE_SIZE)
def sameh_kuck_schedule(m: int, n: int):
    """Sameh–Kuck parallel pairing schedule [Sameh & Kuck, JACM 1978].

    Entry ``(r, c)`` is annihilated against the adjacent row ``r - 1`` at
    stage ``(m - 1 - r) + 2 c``; rotations within a stage touch disjoint row
    pairs.  One inner tuple of ``(pivot_row, target_row, col)`` per stage;
    any flattening of the stage order gives identical results.
    """
    stages: dict[int, list] = {}
    for c in range(min(m - 1, n)):
        for r in range(m - 1, c, -1):
            stages.setdefault((m - 1 - r) + 2 * c, []).append((r - 1, r, c))
    return tuple(tuple(stages[t]) for t in sorted(stages))


def _split_qr(out, m, n, compute_q):
    """Split a decoded working matrix [R' | Qt] and force R's structure."""
    R = out[..., :n]
    tri = torch.tril(torch.ones((m, n), dtype=torch.bool, device=out.device), -1)
    R = torch.where(tri, 0.0, R)
    if not compute_q:
        return None, R
    Q = out[..., n:].transpose(-1, -2)
    return Q, R


def _augment(A, compute_q):
    """Append the identity columns, in A's dtype: rows of e = n + m
    elements (or e = n)."""
    if not compute_q:
        return A
    m = A.shape[-2]
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    return torch.cat([A, eye.expand(A.shape[:-1] + (m,))], dim=-1)


def _packed_qr(A, unit: GivensUnit, compute_q, steps, run):
    A = torch.as_tensor(A, dtype=torch.float64)
    m, n = A.shape[-2], A.shape[-1]
    P = unit.encode(_augment(A, compute_q))
    if steps is None:
        steps = givens_schedule(m, n)
    out = unit.decode(run(P, tuple(steps)))
    return _split_qr(out, m, n, compute_q)


def _override(unit: GivensUnit, N, iters) -> GivensUnit:
    """``unit`` with its significand width and CORDIC depth overridden where
    ``N``/``iters`` are given (Python ints, 0-d tensors or numpy integers),
    resolved on the host as `GivensUnit.vector` resolves them."""
    if N is None and iters is None:
        return unit
    N, iters = unit._widths(N, iters)
    return GivensUnit(dataclasses.replace(unit.cfg, n=N, iters=iters))


def qr_cordic(A, unit: GivensUnit, N=None, iters=None, compute_q=True,
              steps=None):
    """QRD of a batch of matrices with the paper's unit (host loop).

    Runs `repro_torch.kernels.qrd_blocked.qr_packed_reference`, the plain
    PyTorch version of the kernel, on whatever device ``A`` lies.

    Parameters
    ----------
    A : (..., m, n) tensor or array_like, converted to float64.
    unit : GivensUnit — the configured rotator (IEEE or HUB datapath).
    N, iters : optional — override the config's significand width and
        CORDIC depth (the paper's Fig. 9 sweep); None takes the config's.
    compute_q : bool — augment the rows with the identity to accumulate Qᵀ.
    steps : sequence[(int, int, int)], optional — defaults to column-major.

    Returns
    -------
    (Q, R) : float64 tensors (Q is None when ``compute_q=False``), with R's
    structural zeros forced.
    """
    from repro_torch.kernels.qrd_blocked import qr_packed_reference
    cfg = _override(unit, N, iters).cfg

    def run(P, steps):
        m, e = P.shape[-2:]
        out = qr_packed_reference(P.reshape((-1, m, e)), cfg=cfg,
                                  steps=steps)
        return out.reshape(P.shape)
    return _packed_qr(A, unit, compute_q, steps, run)


def qr_cordic_pallas(A, unit: GivensUnit, compute_q=True, steps=None,
                     tile_b=None):
    """Kernel-resident QRD: the whole triangularization in one kernel launch.

    Semantically `qr_cordic` with the loop inside the kernel: the working
    tile stays in shared memory across all schedule steps.  (Q, R) are
    bit-identical to `qr_cordic`.  On a CUDA tensor this launches the CUDA
    kernel; on a CPU tensor it runs the kernel's plain PyTorch version.

    ``tile_b`` is the number of matrices one CUDA block factorizes (None:
    `repro_torch.kernels.qrd_blocked.TILE_B`).
    """
    from repro_torch.kernels import ops

    def run(P, steps):
        return ops.qr_packed(P, cfg=unit.cfg, steps=steps, tile_b=tile_b)
    return _packed_qr(A, unit, compute_q, steps, run)


def qr_cordic_panel(A, unit: GivensUnit, compute_q=True, panel_n=8,
                    tile_b=None):
    """Tiled panel QRD over packed words: production m at kernel speed.

    The scaling form of `qr_cordic_pallas`: the triangularization proceeds
    panel by panel, the rotation control words exported from each panel
    factorization and replayed over the trailing columns
    (`repro_torch.kernels.ops.qr_packed_panel`).  Column-major order is
    preserved exactly, so (Q, R) are **bit-identical** to `qr_cordic` /
    `qr_cordic_pallas` with the default schedule (IEEE and HUB).

    Parameters
    ----------
    A : (..., m, n) tensor or array_like, converted to float64.
    unit : GivensUnit — the configured rotator.
    compute_q : bool — augment the rows with the identity to accumulate Qᵀ.
    panel_n : int — panel width.
    tile_b : int, optional — panels per CUDA block of the factorization.

    Returns
    -------
    (Q, R) : float64 tensors (Q is None when ``compute_q=False``).
    """
    from repro_torch.kernels import ops

    A = torch.as_tensor(A, dtype=torch.float64)
    m, n = A.shape[-2], A.shape[-1]
    P = unit.encode(_augment(A, compute_q))
    out = unit.decode(ops.qr_packed_panel(P, cfg=unit.cfg, n_cols=n,
                                          panel_n=panel_n, tile_b=tile_b))
    return _split_qr(out, m, n, compute_q)


def qr_blockfp_pallas(A, compute_q=True, iters=24, hub=True, frac=24,
                      steps=None, tile_b=None):
    """Blocked QRD on the int32 block-FP kernel (the fast path).

    The working matrix is quantized once to per-column block fixed point,
    every rotation step runs in int32 inside one kernel launch, and a
    single decode at the end recovers floats.  Not bit-identical to
    `qr_cordic` (Q30 gain, no per-step renormalization): the accuracy is
    that of an F-fraction-bit fixed-point datapath per column.  On a CUDA
    tensor this launches `csrc/blockfp.cu`; on a CPU tensor it runs the
    kernel's plain PyTorch version.

    Parameters
    ----------
    A : (..., m, n) tensor or array_like, converted to float64.
    compute_q : bool — augment the rows with the identity to accumulate Qᵀ.
    iters, hub, frac : CORDIC depth (at most 30), HUB or conventional
        arithmetic, fraction bits (F = 24 holds m up to 128 inside int32).
    steps : sequence[(int, int, int)], optional — defaults to column-major.
    tile_b : int, optional — matrices per CUDA block.

    Returns
    -------
    (Q, R) : float64 tensors (Q is None when ``compute_q=False``).
    """
    from repro_torch.kernels import ops

    A = torch.as_tensor(A, dtype=torch.float64)
    m, n = A.shape[-2], A.shape[-1]
    if steps is None:
        steps = givens_schedule(m, n)
    out = ops.givens_block_apply(_augment(A, compute_q), tuple(steps),
                                 iters=iters, hub=hub, frac=frac,
                                 tile_b=tile_b)
    return _split_qr(out, m, n, compute_q)


def qr_blockfp_panel(A, compute_q=True, iters=24, hub=True, frac=24,
                     panel_n=8, tile_b=None):
    """Tiled panel QRD on the int32 block-FP datapath.

    The scaling form of `qr_blockfp_pallas`: quantize once, sweep the
    panels with exported and replayed control words, decode once
    (`repro_torch.kernels.ops.givens_block_apply_panel`).  Bit-identical to
    `qr_blockfp_pallas` with the default schedule.

    Parameters as `qr_blockfp_pallas` plus ``panel_n`` (panel width);
    ``tile_b`` is the number of panels per CUDA block of the factorization.

    Returns
    -------
    (Q, R) : float64 tensors (Q is None when ``compute_q=False``).
    """
    from repro_torch.kernels import ops

    A = torch.as_tensor(A, dtype=torch.float64)
    m, n = A.shape[-2], A.shape[-1]
    out = ops.givens_block_apply_panel(_augment(A, compute_q), n_cols=n,
                                       iters=iters, hub=hub, frac=frac,
                                       panel_n=panel_n, tile_b=tile_b)
    return _split_qr(out, m, n, compute_q)


def _as_stages(m, n, stages):
    """A stage schedule as a tuple of tuples (the Sameh–Kuck one by
    default)."""
    if stages is None:
        return sameh_kuck_schedule(m, n)
    return tuple(tuple(tuple(int(v) for v in s) for s in st) for st in stages)


def qr_cordic_wavefront(A, unit: GivensUnit, compute_q=True, stages=None,
                        tile_b=None, table_layout=None):
    """Wavefront QRD over packed words: one kernel stage per Sameh–Kuck
    stage.

    All rotations of a stage touch disjoint row pairs and run at once, so
    the sequential depth falls from ``len(steps)`` rotations to
    ``len(stages)`` stages; (Q, R) are bit-identical to `qr_cordic` on the
    flattened stage schedule.  On a CUDA tensor this launches B1's
    kernel (``csrc/qr_packed.cu``) on the stages; on a CPU tensor it runs
    the kernel's plain version.

    Parameters
    ----------
    A : (..., m, n) tensor or array_like, converted to float64.
    unit : GivensUnit — the configured rotator.
    compute_q : bool — augment the rows with the identity to accumulate Qᵀ.
    stages : sequence[sequence[(int, int, int)]], optional — defaults to
        ``sameh_kuck_schedule(m, n)``; each stage's row pairs disjoint.
    tile_b : int, optional — matrices per CUDA block.
    table_layout : 'split' | 'stacked', optional — accepted for the JAX
        package's signature.

    Returns
    -------
    (Q, R) : float64 tensors (Q is None when ``compute_q=False``).
    """
    from repro_torch.kernels import ops

    A = torch.as_tensor(A, dtype=torch.float64)
    m, n = A.shape[-2], A.shape[-1]
    P = unit.encode(_augment(A, compute_q))
    out = unit.decode(ops.qr_packed_wavefront(
        P, cfg=unit.cfg, stages=_as_stages(m, n, stages), tile_b=tile_b,
        table_layout=table_layout))
    return _split_qr(out, m, n, compute_q)


def qr_blockfp_wavefront(A, compute_q=True, iters=24, hub=True, frac=24,
                         stages=None, tile_b=None, table_layout=None):
    """Wavefront QRD on the int32 block-FP datapath: quantize once, rotate
    every stage's disjoint row pairs at once, decode once.  Bit-identical
    to `qr_blockfp_pallas` on the flattened stage schedule.

    Parameters as `qr_blockfp_pallas`, with ``stages`` (default
    ``sameh_kuck_schedule(m, n)``) in place of ``steps``, and the accepted
    ``table_layout`` of `qr_cordic_wavefront`.

    Returns
    -------
    (Q, R) : float64 tensors (Q is None when ``compute_q=False``).
    """
    from repro_torch.kernels import ops

    A = torch.as_tensor(A, dtype=torch.float64)
    m, n = A.shape[-2], A.shape[-1]
    out = ops.givens_block_apply_wavefront(
        _augment(A, compute_q), _as_stages(m, n, stages), iters=iters,
        hub=hub, frac=frac, tile_b=tile_b, table_layout=table_layout)
    return _split_qr(out, m, n, compute_q)


# --------------------------------------------------------------------------
# Complex datapath: three-rotation Givens on (re, im) lane pairs.
# --------------------------------------------------------------------------
def _augment_complex(A, compute_q):
    """Append the (real) identity columns to a complex working matrix."""
    if not compute_q:
        return A
    m = A.shape[-2]
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    return torch.cat([A, eye.expand(A.shape[:-1] + (m,))], dim=-1)


def _encode_complex(unit, C):
    """complex (..., m, e) -> packed (..., m, e, 2) (re, im) words."""
    return torch.stack([unit.encode(C.real), unit.encode(C.imag)], dim=-1)


def _decode_complex(unit, P):
    """packed (..., m, e, 2) -> complex128 (..., m, e)."""
    out = unit.decode(P)
    return torch.complex(out[..., 0], out[..., 1])


def _split_qr_complex(C, m, n, compute_q):
    """Split a decoded complex working matrix [R' | G] into (Q, R).

    The rotations accumulate the unitary G with ``G A = R``, so ``Q =
    G^H``: the conjugate transpose, where the real datapath transposes.
    """
    R = C[..., :n]
    tri = torch.tril(torch.ones((m, n), dtype=torch.bool, device=C.device), -1)
    R = torch.where(tri, torch.zeros((), dtype=R.dtype, device=C.device), R)
    if not compute_q:
        return None, R
    Q = C[..., n:].transpose(-1, -2).conj().resolve_conj()
    return Q, R


def _complex_qr(A, unit, compute_q, run):
    A = torch.as_tensor(A).to(torch.complex128)
    m, n = A.shape[-2], A.shape[-1]
    P = _encode_complex(unit, _augment_complex(A, compute_q))
    return _split_qr_complex(_decode_complex(unit, run(P, m, n)), m, n,
                             compute_q)


def qr_cordic_complex(A, unit: GivensUnit, N=None, iters=None, compute_q=True,
                      steps=None):
    """Complex QRD of a batch of matrices with the paper's unit (host loop).

    Every schedule step runs the three-rotation decomposition
    (`GivensUnit.rotate_rows_complex`): two phase rotations realize the
    lead entries, then the real Givens replays across the re and im lanes.
    R comes out with a real non-negative diagonal; purely real inputs give
    `qr_cordic`'s words on the real lanes and exact zeros on the imaginary
    ones.  Runs `repro_torch.kernels.qrd_blocked.qr_packed_complex_reference`,
    the plain version of the complex kernel, on whatever device ``A`` lies.

    Parameters
    ----------
    A : (..., m, n) tensor or array_like, converted to complex128.
    unit : GivensUnit — the configured rotator (IEEE or HUB datapath).
    N, iters : optional — override the config's significand width and
        CORDIC depth, as in `qr_cordic`.
    compute_q : bool — augment the rows with the identity to accumulate the
        unitary G; ``Q = G^H``.
    steps : sequence[(int, int, int)], optional — defaults to column-major.

    Returns
    -------
    (Q, R) : complex128 tensors (Q is None when ``compute_q=False``), R's
    structural zeros forced and its diagonal exactly real.
    """
    from repro_torch.kernels.qrd_blocked import qr_packed_complex_reference
    cfg = _override(unit, N, iters).cfg

    def run(P, m, n):
        s = givens_schedule(m, n) if steps is None else tuple(steps)
        e = P.shape[-2]
        out = qr_packed_complex_reference(P.reshape((-1, m, e, 2)),
                                          cfg=cfg, steps=s)
        return out.reshape(P.shape)
    return _complex_qr(A, unit, compute_q, run)


def qr_cordic_complex_pallas(A, unit: GivensUnit, compute_q=True, steps=None,
                             tile_b=None):
    """Kernel-resident complex QRD: every step in one kernel launch
    (``csrc/complex_packed.cu`` on a CUDA tensor, its plain version on a
    CPU tensor).  (Q, R) bit-identical to `qr_cordic_complex`; parameters
    as there, plus ``tile_b`` (matrices per CUDA block)."""
    from repro_torch.kernels import ops

    def run(P, m, n):
        s = givens_schedule(m, n) if steps is None else tuple(steps)
        return ops.qr_packed_complex(P, cfg=unit.cfg, steps=s, tile_b=tile_b)
    return _complex_qr(A, unit, compute_q, run)


def qr_cordic_complex_wavefront(A, unit: GivensUnit, compute_q=True,
                                stages=None, tile_b=None, table_layout=None):
    """Wavefront complex QRD: every Sameh–Kuck stage's disjoint row pairs
    run the three-rotation decomposition at once.  (Q, R) bit-identical to
    `qr_cordic_complex` on the flattened stage schedule; parameters as
    `qr_cordic_wavefront`."""
    from repro_torch.kernels import ops

    def run(P, m, n):
        return ops.qr_packed_complex_wavefront(
            P, cfg=unit.cfg, stages=_as_stages(m, n, stages), tile_b=tile_b,
            table_layout=table_layout)
    return _complex_qr(A, unit, compute_q, run)


# --------------------------------------------------------------------------
# Baselines: float Givens, the LAPACK reference, the fixed-point rotator
# --------------------------------------------------------------------------
def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, numpy dtype or dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def qr_givens_float(A, dtype=torch.float32, compute_q=True):
    """Batched QR via float Givens rotations (same schedule as the unit).

    The algorithmic baseline: the column-major schedule and augmented
    identity of the unit, in plain ``dtype`` floating point.  Complex dtypes
    use the conjugate rotation ``G = [[conj(a), conj(b)], [-b, a]] / r``
    with ``r = sqrt(|a|^2 + |b|^2)``, which reduces to the real rotation on
    real inputs.  float16 computes op by op in float16, as the JAX package
    does.

    Parameters
    ----------
    A : (..., m, n) tensor or array_like, cast to ``dtype`` on its device.
    dtype : torch dtype, numpy dtype or name.
    compute_q : bool.

    Returns
    -------
    (Q, R) in ``dtype`` (Q is None when ``compute_q=False``); for complex
    dtypes Q is the conjugate transpose of the accumulated rotations and
    R's diagonal is real and non-negative.
    """
    dtype = _torch_dtype(dtype)
    A = torch.as_tensor(A).to(dtype)
    m, n = A.shape[-2], A.shape[-1]
    W = _augment(A, True) if compute_q else A.clone()   # updated in place
    for (k, j, col) in givens_schedule(m, n):
        a = W[..., k, col]
        b = W[..., j, col]
        r = torch.sqrt(a.abs() ** 2 + b.abs() ** 2)
        safe = r > 0
        rs = torch.where(safe, r, 1.0).to(dtype)
        c = torch.where(safe, a.conj() / rs, 1.0).to(dtype)
        s = torch.where(safe, b.conj() / rs, 0.0).to(dtype)
        rk = c[..., None] * W[..., k, :] + s[..., None] * W[..., j, :]
        rj = (-s.conj()[..., None] * W[..., k, :]
              + c.conj()[..., None] * W[..., j, :])
        rj[..., col] = 0
        rk[..., col] = r.to(dtype)
        W[..., k, :] = rk
        W[..., j, :] = rj
    R = W[..., :n]
    if not compute_q:
        return None, R
    return W[..., n:].transpose(-1, -2).conj().resolve_conj(), R


def qr_jnp(A, dtype=torch.float32, compute_q=True):
    """LAPACK-style reference (the JAX package's ``jnp.linalg.qr``).

    A : (..., m, n); returns complete-mode ``(Q, R)`` from
    ``torch.linalg.qr`` in ``dtype`` on A's device (LAPACK on the CPU,
    cuSOLVER or MAGMA on the GPU), or ``(None, R)`` with
    ``compute_q=False``.  float16 raises ``NotImplementedError``, as the
    JAX package's LAPACK QR does: neither library has a half-precision QR,
    and the JAX package does not widen.
    """
    dtype = _torch_dtype(dtype)
    if dtype == torch.float16:
        raise NotImplementedError("qr_jnp: LAPACK has no float16 QR "
                                  "(jnp.linalg.qr refuses it too); use "
                                  "float32 or 'givens_float'")
    Q, R = torch.linalg.qr(torch.as_tensor(A).to(dtype), mode="complete")
    return (Q if compute_q else None), R


def qr_fixed(A, width=32, iters=27, scale_exp=0, compute_q=True):
    """Batched QRD in pure fixed point (W-bit, F = width - 2 fraction bits).

    The Fig. 11 baseline [20]: inputs scaled by 2^(F - scale_exp) and
    quantized RNE to the integer grid, the whole decomposition in
    int64-carried W-bit two's complement with CORDIC (`cordic.vectoring`,
    `cordic.rotation`) and gain compensation (`cordic.fixmul`).  The scale
    and the gain constant are the JAX package's: it forms ``2^k`` with
    XLA's ``exp2``, not an exact power of two, and the port reads the same
    constants from `repro_torch.kernels.ops._scale_table`, so its words
    and floats are bit-equal to `repro.core.qrd.qr_fixed`.

    A : (..., m, n); returns float64 ``(Q, R)`` on A's device (Q is None
    when ``compute_q=False``).
    """
    from repro_torch.kernels.ops import _SCALE_K, _scale_table

    A = torch.as_tensor(A).to(torch.float64)
    m, n = A.shape[-2], A.shape[-1]
    W = _augment(A, compute_q)
    table = _scale_table()
    scale = float(table[width - 2 - scale_exp + _SCALE_K])
    X = torch.round(W * scale).to(torch.int64)   # RNE onto the grid
    p = cordic.gain_shift(width + 2)
    comp = int(np.rint(np.float64(1.0) / np.float64(cordic.GAIN_TABLE[iters])
                       * table[p + _SCALE_K]))

    def gain(v):
        return cordic.fixmul(v, comp, p, round_nearest=True)

    for (k, j, col) in givens_schedule(m, n):
        xl, _, flip, sig = cordic.vectoring(X[..., k, col], X[..., j, col],
                                            iters, hub=False)
        xr, yr = cordic.rotation(X[..., k, col + 1:], X[..., j, col + 1:],
                                 flip[..., None], sig[..., None], iters,
                                 hub=False)
        X[..., k, col] = gain(xl)
        X[..., j, col] = 0
        X[..., k, col + 1:] = gain(xr)
        X[..., j, col + 1:] = gain(yr)
    out = X.to(torch.float64) / scale
    return _split_qr(out, m, n, compute_q)


# --------------------------------------------------------------------------
# Engine facade + error metric
# --------------------------------------------------------------------------
@dataclasses.dataclass
class QRDEngine:
    """Backend-selectable batched QRD: the legacy facade over
    `repro_torch.qrd.QRDEngine` (the JAX package's `repro.core.QRDEngine`).

    Every call rebuilds a `repro_torch.qrd.QRDConfig` from the (mutable)
    fields, so a field changed between calls misses the built-callable
    cache instead of returning stale results.  New code should use
    `repro_torch.qrd.QRDEngine` directly.

    Parameters
    ----------
    backend : str — any registered backend
        (`repro_torch.qrd.available_backends()`).
    givens_config : GivensConfig — unit parameters of the cordic family;
        ``'blockfp_pallas'`` uses its ``hub`` flag and resolved depth.
    schedule : ``'col'`` or ``'sameh_kuck'``.
    fixed_width, fixed_iters, fixed_scale_exp : the ``'fixed'`` baseline.
    device : where the engine runs: ``None`` is the GPU, ``"cpu"`` runs
        the kernels' plain versions.

    Call with ``engine(A, compute_q=...)``; returns ``(Q, R)``.
    """

    backend: str = "jnp"
    givens_config: GivensConfig = dataclasses.field(default_factory=GivensConfig)
    schedule: str = "col"
    fixed_width: int = 32
    fixed_iters: int = 27
    fixed_scale_exp: int = 0
    device: Any = None

    def _to_config(self):
        from repro_torch import qrd as _api
        return _api.QRDConfig(backend=self.backend, schedule=self.schedule,
                              givens=self.givens_config,
                              fixed_width=self.fixed_width,
                              fixed_iters=self.fixed_iters,
                              fixed_scale_exp=self.fixed_scale_exp)

    def __post_init__(self):
        # fail at construction: bad backend or schedule names and invalid
        # unit configurations should not surface deep inside a run
        from repro_torch import qrd as _api
        self._engine = _api.QRDEngine(self._to_config(), device=self.device)

    @property
    def _fn_cache(self):
        """The underlying bounded built-callable LRU."""
        return self._engine._fn_cache

    def __call__(self, A, compute_q=True):
        return self._engine._dispatch(A, compute_q, self._to_config())

    def solve(self, A, b, return_residuals=False):
        """Batched least squares — see `repro_torch.qrd.QRDEngine.solve`."""
        eng = self._engine
        eng.config = self._to_config()
        return eng.solve(A, b, return_residuals=return_residuals)

    def rls(self, n, lam=0.99, delta=1e-3, block=None):
        """Streaming QRD-RLS state — see `repro_torch.qrd.QRDEngine.rls`."""
        eng = self._engine
        eng.config = self._to_config()
        return eng.rls(n, lam=lam, delta=delta, block=block)


def snr_db(A, Q, R):
    """The paper's error metric: SNR of the reconstruction ``Q @ R``
    against A, in dB, per matrix.

    Computed in float64 on Q's device (A and R follow it); the caller takes
    the mean over the batch (the paper reports the mean of 10,000
    matrices).
    """
    Q = torch.as_tensor(Q)
    A = torch.as_tensor(A).to(device=Q.device, dtype=torch.float64)
    B = torch.matmul(Q.to(torch.float64),
                     torch.as_tensor(R).to(device=Q.device,
                                           dtype=torch.float64))
    num = torch.sum(A * A, dim=(-2, -1))
    den = torch.sum((A - B) ** 2, dim=(-2, -1))
    return 10.0 * torch.log10(num / torch.clamp(den, min=1e-300))
