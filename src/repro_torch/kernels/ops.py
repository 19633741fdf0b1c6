"""Public wrappers over the CUDA kernels (torch port of the ported part of
`repro.kernels.ops`).

The QR kernels take one flat batch axis; these wrappers accept any
leading batch shape and restore it.  Ragged batches need no padding here:
the kernels mask the ragged edge of their last block.  The standalone
rotator's row API takes (B,) lead pairs and (B, L) row pairs, as the JAX
package's does: `vectoring_fixed`, `rotation_fixed`,
`givens_rotate_rows_fixed` and `givens_rotate_rows_fused` (kernels of
``csrc/rotator.cu``; no padding to the TPU's (8, 128) tile).  The entry
points that take array_like operands run them on the GPU (the row API
unless the caller passes ``device="cpu"``); a tensor stays on its device
(`_operands`).  The QR wrappers run two datapaths:

* packed FP words (int64), bit-exact to the unit: `qr_packed`,
  `qr_packed_panel`, the Sameh–Kuck wavefront `qr_packed_wavefront`, and
  the complex datapath on (..., m, e, 2) (re, im) words, `qr_packed_complex`
  and `qr_packed_complex_wavefront`;
* int32 block-FP significands, quantized once per (matrix, column) by
  `_blockfp_encode` and decoded once by `_blockfp_decode`:
  `givens_block_apply` (any schedule, e.g. `rls_block_steps`),
  `givens_block_apply_panel` and `givens_block_apply_wavefront`.

The wavefront wrappers take the stage schedule as (S, Pmax) tables
(`_stage_tables`).  `qr_packed` and `qr_packed_wavefront` also run the
JAX package's dual-int32 ``lanes`` route (``lanes=True``): the same words
as (hi, lo) int32 halves through the kernels of ``csrc/packed_lanes.cu``,
bit-identical to the int64 route.  The JAX package takes lanes by default
because a TPU cannot compile int64; int64 is native on the GPU, so here
``lanes=None`` means int64.
"""
from __future__ import annotations

import math
from fractions import Fraction
from functools import lru_cache

import numpy as np
import torch

from repro_torch.core.qrd import SCHEDULE_CACHE_SIZE

from . import cordic_givens as cg
from . import qrd_blocked as qb
from ._launch import resolve_device

__all__ = ["vectoring_fixed", "rotation_fixed", "givens_rotate_rows_fixed",
           "givens_rotate_rows_fused", "qr_packed", "qr_packed_wavefront", "qr_packed_complex",
           "qr_packed_complex_wavefront", "panel_steps", "panel_stages",
           "qr_packed_panel",
           "givens_block_apply", "givens_block_apply_wavefront",
           "givens_block_apply_panel", "rls_block_steps"]


def _operands(dtype, device, *vs):
    """``vs`` as ``dtype`` tensors, where the entry points run them.

    With ``device=None`` a tensor stays on its device (a CUDA tensor runs
    the kernel, a CPU tensor its plain version) and anything else (numpy
    arrays, lists) joins the first tensor operand, or goes to the GPU when
    there is none (`_launch.resolve_device`: it raises when CUDA is
    unavailable and names ``device='cpu'``).  A given ``device`` takes
    every operand there.  Integers wrap to int32 as
    ``.astype(jnp.int32)`` does.
    """
    if device is None:
        on = [v.device for v in vs if isinstance(v, torch.Tensor)]
        device = on[0] if on else resolve_device()
        vs = [v if isinstance(v, torch.Tensor)
              else torch.as_tensor(v, device=device) for v in vs]
    else:
        vs = [torch.as_tensor(v, device=device) for v in vs]
    return tuple(v if v.dtype == dtype else v.to(dtype) for v in vs)


def _rows(v):
    """int32 rows with unit column stride (the kernels' layout)."""
    return v if v.dim() != 2 or v.stride(-1) == 1 else v.contiguous()


def vectoring_fixed(x, y, *, iters=24, hub=False, device=None):
    """Vectoring kernel: compute per-row CORDIC control words.

    Parameters
    ----------
    x, y : (B,) int32 tensors or array_like
        Lead pairs as block-FP significands (w = iters + 2 <= 30 bits;
        callers align exponents beforehand).  Other integer types are cast
        to int32 with wrap-around.
    iters, hub : CORDIC depth and HUB arithmetic flag.
    device : str or torch.device, optional
        Where to run: tensors stay on their device and other operands go to
        the GPU unless this says otherwise (``"cpu"`` runs the plain
        version); see `_operands`.

    Returns
    -------
    (xr, yr, flip, sigma) : four (B,) int32 tensors on the operands' device
        The gain-compensated rotated pair (``yr`` near 0), the coarse
        pi-flip bit, and the packed sigma direction bits (bit i == 1 means
        d_i = +1).
    """
    x, y = _operands(torch.int32, device, x, y)
    return cg.vectoring_call(x, y, iters=iters, hub=hub)


def rotation_fixed(x, y, flip, sigma, *, iters=24, hub=False, device=None):
    """Rotation kernel: replay stored control words across full rows.

    Parameters
    ----------
    x, y : (B, L) int32 tensors or array_like — row elements as block-FP
        significands.
    flip, sigma : (B,) int32 — per-row control words from
        `vectoring_fixed`.
    device : where to run, as in `vectoring_fixed`.

    Returns
    -------
    (xr, yr) : (B, L) int32 gain-compensated rotated rows.
    """
    x, y, flip, sigma = _operands(torch.int32, device, x, y, flip, sigma)
    return cg.rotation_call(_rows(x), _rows(y), flip.contiguous(),
                            sigma.contiguous(), iters=iters, hub=hub)


def givens_rotate_rows_fixed(x_rows, y_rows, *, iters=24, hub=False,
                             device=None):
    """Full fixed-point Givens rotation of B row pairs of length L.

    x_rows, y_rows : (B, L) int32 block-FP significands (element 0 is the
    lead pair), tensors or array_like; ``device`` as in `vectoring_fixed`.
    Vectoring on column 0 and rotation of columns 1: write straight into
    one (B, L) output pair (two launches, no concatenation).  Returns the
    rotated rows; ``y[:, 0]`` is the zeroed entry's residual, kept as
    computed (callers force it to 0 where they need the structural zero).
    """
    x, y = map(_rows, _operands(torch.int32, device, x_rows, y_rows))
    xo = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    yo = torch.empty_like(xo)
    _, _, flip, sig = cg.vectoring_call(x[:, 0], y[:, 0], iters=iters,
                                        hub=hub, out=(xo[:, 0], yo[:, 0]))
    cg.rotation_call(x[:, 1:], y[:, 1:], flip, sig, iters=iters, hub=hub,
                     out=(xo[:, 1:], yo[:, 1:]))
    return xo, yo


def givens_rotate_rows_fused(x_rows, y_rows, *, iters=24, hub=False,
                             device=None):
    """Fused single-pass variant: vectoring and rotation in one launch,
    each element read once and written once.  Bit-identical to
    `givens_rotate_rows_fixed` (the rotation of the lead pair by its own
    sigma is the vectoring result); operands and ``device`` as there."""
    x, y = map(_rows, _operands(torch.int32, device, x_rows, y_rows))
    return cg.fused_call(x, y, iters=iters, hub=hub)


@lru_cache(maxsize=SCHEDULE_CACHE_SIZE)
def rls_block_steps(n: int, block: int):
    """Annihilation schedule for a QRD-RLS block update (memoized).

    For a working tile ``[sqrt(lam)-weighted R | z]`` of ``n`` state rows
    with ``block`` snapshot rows stacked underneath (rows
    ``n .. n+block-1``), column ``k`` of every snapshot row is annihilated
    against the diagonal pivot row ``k``: the blocked replay of the
    per-snapshot QRD-RLS recursion (`repro_torch.qrd.rls.RLSState.flush`
    feeds it to `givens_block_apply`).

    Returns a tuple of ``(pivot_row, target_row, col)`` triples.
    """
    return tuple((k, n + j, k) for k in range(n) for j in range(block))


def qr_packed(P, *, cfg, steps, tile_b=None, lanes=None):
    """Kernel-resident blocked QR over packed FP words (bit-exact path).

    Parameters
    ----------
    P : (..., m, e) int64 tensor
        Packed FP words of the augmented working matrices; any leading
        batch shape.
    cfg : GivensConfig — unit configuration.
    steps : tuple[(int, int, int), ...] — ``(pivot_row, target_row, col)``.
    tile_b : int, optional — matrices per CUDA block (`qrd_blocked.TILE_B`).
    lanes : bool, optional
        Carry the words as dual int32 lanes (`qrd_blocked.
        qr_packed_lanes_call`) instead of int64; the words are the same.
        None means False: int64 is native on the GPU, where the JAX
        package's default (lanes whenever the kernel compiles) exists
        because a TPU cannot compile int64.

    Returns
    -------
    (..., m, e) int64 — triangularized packed words, bit-identical to
    running `GivensUnit.rotate_rows` step by step (`qr_cordic`).
    """
    batch = P.shape[:-2]
    m, e = P.shape[-2:]
    Pf = P.to(torch.int64).reshape((-1, m, e)).contiguous()
    if lanes:
        out = cg.lanes_to_packed(qb.qr_packed_lanes_call(
            cg.packed_to_lanes(Pf), cfg=cfg, steps=steps, tile_b=tile_b))
    else:
        out = qb.qr_packed_call(Pf, cfg=cfg, steps=steps, tile_b=tile_b)
    return out.reshape(batch + (m, e))


def _resolve_layout(table_layout):
    return "split" if table_layout is None else table_layout


@lru_cache(maxsize=SCHEDULE_CACHE_SIZE)
def _stage_tables(stages, m):
    """Stage tables of the wavefront kernels (memoized).

    stages : tuple[tuple[(pivot, target, col), ...], ...]
        One inner tuple per Sameh–Kuck stage (`sameh_kuck_schedule`).
    m : int
        Rows of the working tile; padded pairs carry the out-of-range row
        ``m`` and column 0, and the kernels skip them.

    Returns three read-only (S, Pmax) int32 numpy arrays: pivot rows,
    target rows, lead columns, one row per stage.  A stage whose rotations
    share a row, or name a row outside the tile, raises ValueError: the
    pairs of a stage run at once.
    """
    S = len(stages)
    Pmax = max(len(st) for st in stages)
    piv = np.full((S, Pmax), m, np.int32)
    tgt = np.full((S, Pmax), m, np.int32)
    col = np.zeros((S, Pmax), np.int32)
    for s, st in enumerate(stages):
        rows = [r for (kk, jj, _) in st for r in (kk, jj)]
        if len(rows) != len(set(rows)):
            raise ValueError(f"stage {s} rotations touch overlapping rows")
        if not all(0 <= r < m for r in rows):
            raise ValueError(f"stage {s} row index out of range for m={m}")
        for p, (kk, jj, cc) in enumerate(st):
            piv[s, p], tgt[s, p], col[s, p] = kk, jj, cc
    for t in (piv, tgt, col):
        t.setflags(write=False)
    return piv, tgt, col


def qr_packed_wavefront(P, *, cfg, stages, tile_b=None, lanes=None,
                        table_layout=None):
    """Wavefront QR over packed FP words (bit-exact path).

    The stage-parallel counterpart of `qr_packed`: all rotations of a
    Sameh–Kuck stage run at once (their row pairs are disjoint), so the
    sequential depth is the number of stages, not of rotations.

    Parameters
    ----------
    P : (..., m, e) int64 tensor — packed words; any leading batch shape.
    cfg : GivensConfig — unit configuration.
    stages : tuple[tuple[(int, int, int), ...], ...] — the stage schedule
        (`sameh_kuck_schedule(m, n)`); each stage's row pairs disjoint.
    tile_b : int, optional — matrices per CUDA block.
    lanes : bool, optional — dual int32 lanes
        (`qrd_blocked.qr_packed_lanes_wavefront_call`) instead of int64, as
        in `qr_packed` (None means False).
    table_layout : 'split' | 'stacked', optional — the JAX package's table
        transfer layout; accepted, the words do not depend on it.

    Returns
    -------
    (..., m, e) int64 — bit-identical to `qr_packed` on the flattened
    stage schedule.
    """
    batch = P.shape[:-2]
    m, e = P.shape[-2:]
    piv, tgt, col = _stage_tables(stages, m)
    Pf = P.to(torch.int64).reshape((-1, m, e)).contiguous()
    kw = dict(cfg=cfg, tile_b=tile_b,
              table_layout=_resolve_layout(table_layout))
    if lanes:
        out = cg.lanes_to_packed(qb.qr_packed_lanes_wavefront_call(
            cg.packed_to_lanes(Pf), piv, tgt, col, **kw))
    else:
        out = qb.qr_packed_wavefront_call(Pf, piv, tgt, col, **kw)
    return out.reshape(batch + (m, e))


def qr_packed_complex(P, *, cfg, steps, tile_b=None):
    """Complex QR over packed (re, im) words (bit-exact path).

    Parameters
    ----------
    P : (..., m, e, 2) int64 tensor — packed words of the augmented complex
        working matrices, the trailing axis the (re, im) lanes.
    cfg : GivensConfig — unit configuration.
    steps : tuple[(int, int, int), ...] — ``(pivot_row, target_row, col)``.
    tile_b : int, optional — matrices per CUDA block.

    Returns
    -------
    (..., m, e, 2) int64 — bit-identical to running
    `GivensUnit.rotate_rows_complex` step by step (`qr_cordic_complex`).
    """
    batch = P.shape[:-3]
    m, e = P.shape[-3:-1]
    Pf = P.to(torch.int64).reshape((-1, m, e, 2)).contiguous()
    out = qb.qr_packed_complex_call(Pf, cfg=cfg, steps=steps, tile_b=tile_b)
    return out.reshape(batch + (m, e, 2))


def qr_packed_complex_wavefront(P, *, cfg, stages, tile_b=None,
                                table_layout=None):
    """Wavefront complex QR over packed (re, im) words: the stage tables of
    `qr_packed_wavefront` on the operand of `qr_packed_complex`.

    Returns
    -------
    (..., m, e, 2) int64 — bit-identical to `qr_packed_complex` on the
    flattened stage schedule.
    """
    batch = P.shape[:-3]
    m, e = P.shape[-3:-1]
    piv, tgt, col = _stage_tables(stages, m)
    Pf = P.to(torch.int64).reshape((-1, m, e, 2)).contiguous()
    out = qb.qr_packed_complex_wavefront_call(
        Pf, piv, tgt, col, cfg=cfg, tile_b=tile_b,
        table_layout=_resolve_layout(table_layout))
    return out.reshape(batch + (m, e, 2))


@lru_cache(maxsize=SCHEDULE_CACHE_SIZE)
def panel_steps(mr: int, ncols: int):
    """Panel-local column-major step tables (memoized, bounded).

    The column-major schedule restricted to one panel: ``mr`` resident
    rows (global rows ``c0..m-1``, panel-relative), annihilating local
    columns ``0..ncols-1`` in `givens_schedule` order, so concatenating
    every panel's steps (offset by its ``c0``) reproduces the flat
    column-major schedule exactly: the panel route is bit-identical to the
    flat kernel.

    Returns three read-only (S,) int32 numpy arrays: pivot rows, target
    rows, columns (all panel-local).
    """
    trips = [(c, r, c) for c in range(min(mr - 1, ncols))
             for r in range(c + 1, mr)]
    tables = np.asarray(trips, np.int32).reshape(-1, 3).T.copy()
    tables.setflags(write=False)
    return tables[0], tables[1], tables[2]


@lru_cache(maxsize=SCHEDULE_CACHE_SIZE)
def panel_stages(mr: int, ncols: int):
    """The stages of `panel_steps` (memoized, bounded), as the panel kernels
    run them.

    Each step goes one level past the last steps on its two rows
    (`qrd_blocked.levelize_steps`), so a stage's pairs touch disjoint rows
    and every row meets its steps in column-major order: the words are
    those of the step order.  ``mr + min(mr - 1, ncols) - 2`` stages of at
    most ``ncols`` pairs, against ``panel_steps``' ~``ncols * mr`` steps.

    Returns
    -------
    (tables, step) — read-only int32 numpy arrays: the (3, S', P) pivot,
    target and column stage tables, padded with pivot = target = ``mr``
    and column 0 (the layout of `_stage_tables`), and the (S', P) index of
    each pair's step in `panel_steps` (-1 where padded).
    """
    lv = qb.levelize_steps(*panel_steps(mr, ncols), mr)
    return lv[:3], lv[3]


def qr_packed_panel(P, *, cfg, n_cols, panel_n=8, tile_b=None):
    """Tiled panel QR over packed FP words (bit-exact path).

    The scaling counterpart of `qr_packed`: the triangularization proceeds
    panel by panel.  For each panel of ``panel_n`` columns,
    `qrd_blocked.panel_factor_packed_call` runs the panel's steps on a
    resident (mr, panel_n) tile and exports the (flip, sigma) control
    words, and `qrd_blocked.panel_apply_packed_call` replays them over the
    trailing columns.  Rows above the panel's first column are final after
    the previous panels and never re-enter a kernel.  Both kernels work in
    place on strided views of one working buffer: no padding or copies.
    Column-major order is preserved exactly, so the result is
    **bit-identical** to `qr_packed` on `givens_schedule(m, n)` (IEEE and
    HUB).

    Parameters
    ----------
    P : (..., m, e) int64 tensor
        Packed FP words of the augmented working matrices; any leading
        batch shape.  Not modified.
    cfg : GivensConfig — unit configuration.
    n_cols : int
        Number of leading columns to annihilate (the matrix's n; the other
        ``e - n`` columns, identity columns for Q, only ride the trailing
        updates).
    panel_n : int — panel width.
    tile_b : int, optional — panels per CUDA block of the factorization.

    Returns
    -------
    (..., m, e) int64 — triangularized packed words.
    """
    batch = P.shape[:-2]
    m, e = P.shape[-2:]
    W = P.to(torch.int64).reshape((-1, m, e)).clone()
    for c0 in range(0, min(n_cols, m - 1), panel_n):
        nc = min(panel_n, n_cols - c0)
        piv, tgt, col = panel_steps(m - c0, nc)
        _, flip, sig = qb.panel_factor_packed_call(
            W[:, c0:, c0:c0 + nc], piv, tgt, col, cfg=cfg, tile_b=tile_b)
        if c0 + nc < e:
            qb.panel_apply_packed_call(W[:, c0:, c0 + nc:], piv, tgt, flip,
                                       sig, cfg=cfg)
    return W.reshape(batch + (m, e))


#: Integer exponents covered by `_scale_table`: every ``frac - ex`` and
#: ``ex - frac`` a float64 column and ``frac`` <= 50 can give.
_SCALE_K = 1100


def _fma(a: float, b: float, c: float) -> float:
    """``a * b + c`` rounded once to float64 (exact rational arithmetic)."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _xla_exp(x: float) -> float:
    """float64 ``exp`` as XLA computes it on the CPU: Cephes' rational
    approximation (Eigen's ``pexp_double``) with every multiply-add fused.
    Evaluated on the host, once per table entry."""
    x = min(max(x, -709.784), 709.784)
    fx = math.floor(_fma(1.4426950408889634073599, x, 0.5))
    x = _fma(-fx, 0.693145751953125, x)
    x = _fma(-fx, 1.42860682030941723212e-6, x)
    x2 = x * x
    px = _fma(_fma(1.26177193074810590878e-4, x2, 3.02994407707441961300e-2),
              x2, 9.99999999999999999910e-1) * x
    qx = _fma(_fma(_fma(3.00198505138664455042e-6, x2,
                        2.52448340349684104192e-3),
                   x2, 2.27265548208155028766e-1),
              x2, 2.00000000000000000009e0)
    x = _fma(2.0, px / (qx - px), 1.0)
    try:
        return math.ldexp(x, fx)
    except OverflowError:
        return math.inf


@lru_cache(maxsize=1)
def _scale_table() -> np.ndarray:
    """The block-FP scales ``exp2(k)`` of the JAX package for integer
    ``k`` in [-_SCALE_K, _SCALE_K], as float64.

    The JAX package scales by ``jnp.exp2``, which XLA lowers to
    ``exp(x * ln 2)`` (ln 2 rounded to float64, the product rounded, then
    XLA's own ``exp``): not exact powers of two (off by up to about 1e-13
    relative), and 0 below 2^-1022.  The port uses the same constants, so
    its significands and its decoded floats equal the JAX package's bit for
    bit; a test holds this table to ``jnp.exp2`` over its whole range.
    """
    ln2 = 0.69314718055994529
    return np.array([0.0 if k < -1022 else _xla_exp(ln2 * k)
                     for k in range(-_SCALE_K, _SCALE_K + 1)])


@lru_cache(maxsize=None)
def _scale_on(device: str):
    return torch.as_tensor(_scale_table(), device=device)


def _scale(k):
    """The JAX package's ``exp2(k)`` for an integer tensor ``k``, looked up
    in `_scale_table` on ``k``'s device."""
    idx = torch.clamp(k.to(torch.int64), -_SCALE_K, _SCALE_K) + _SCALE_K
    return _scale_on(str(k.device))[idx]


def _blockfp_encode(Wf, frac):
    """float64 (B, m, e) -> int32 significands + per-(matrix, column)
    exponent.

    One shared exponent ``ex`` per (matrix, column), with the column's
    amax in [2^(ex-1), 2^ex) (``torch.frexp``, mantissa in [0.5, 1)); an
    all-zero column gets ``ex = 0``.  Significands are ``round(W *
    scale(frac - ex))``, half to even, so ``|X| <= 2^frac``.  Valid under
    any Givens schedule: rotations only combine same-column elements of two
    rows, so the per-column scales are invariant.  The scales are the JAX
    package's (`_scale_table`).
    """
    amax = Wf.abs().amax(dim=-2, keepdim=True)
    _, ex = torch.frexp(torch.where(amax > 0, amax, 1.0))
    ex = torch.where(amax > 0, ex, 0)
    X = torch.round(Wf * _scale(frac - ex))
    return X.to(torch.int32), ex


def _blockfp_decode(X, ex, frac):
    """int32 significands and their column exponents -> float64."""
    return X.to(torch.float64) * _scale(ex - frac)


def givens_block_apply(W, steps, *, iters=24, hub=True, frac=24,
                       tile_b=None):
    """Apply a Givens schedule to float matrices on the int32 block-FP
    kernel.

    ``W`` is quantized **once** to int32 significands with one shared
    exponent per (matrix, column), every step of ``steps`` runs in int32
    inside one launch of `qrd_blocked.qr_blockfp_call`, and one decode
    recovers floats.

    Parameters
    ----------
    W : (..., m, e) float tensor or array_like
        Working matrices (``[A | I]`` for a QRD, or ``[R | z]`` over new
        rows for an RLS block update); any leading batch shape.  A tensor
        runs on its device, anything else on the GPU (`_operands`).
    steps : tuple[(int, int, int), ...] — ``(pivot_row, target_row, col)``.
    iters, hub : CORDIC depth (at most 30) and HUB arithmetic flag.
    frac : int
        Fraction bits F of the significands.  F = 24 leaves 2 CORDIC growth
        bits and log2(sqrt(m)) bits of column-norm growth inside int32 up
        to m = 128 (29.5 bits).
    tile_b : int, optional — matrices per CUDA block.

    Returns
    -------
    (..., m, e) float64 — the rotated working matrices.
    """
    (W,) = _operands(torch.float64, None, W)
    batch = W.shape[:-2]
    m, e = W.shape[-2:]
    X, ex = _blockfp_encode(W.reshape((-1, m, e)), frac)
    out = qb.qr_blockfp_call(X.contiguous(), iters=iters, hub=hub,
                             steps=steps, tile_b=tile_b)
    return _blockfp_decode(out, ex, frac).reshape(batch + (m, e))


def givens_block_apply_wavefront(W, stages, *, iters=24, hub=True, frac=24,
                                 tile_b=None, table_layout=None):
    """The wavefront variant of `givens_block_apply`: quantize once, rotate
    every stage's disjoint row pairs at once in one launch of
    `qrd_blocked.qr_blockfp_wavefront_call`, decode once.

    Parameters as `givens_block_apply`, with ``stages`` (the stage
    schedule, each stage's row pairs disjoint) in place of ``steps`` and the
    accepted ``table_layout`` of `qr_packed_wavefront`.

    Returns
    -------
    (..., m, e) float64 — bit-identical to `givens_block_apply` on the
    flattened stage schedule.
    """
    (W,) = _operands(torch.float64, None, W)
    batch = W.shape[:-2]
    m, e = W.shape[-2:]
    piv, tgt, col = _stage_tables(stages, m)
    X, ex = _blockfp_encode(W.reshape((-1, m, e)), frac)
    out = qb.qr_blockfp_wavefront_call(
        X.contiguous(), piv, tgt, col, iters=iters, hub=hub, tile_b=tile_b,
        table_layout=_resolve_layout(table_layout))
    return _blockfp_decode(out, ex, frac).reshape(batch + (m, e))


def givens_block_apply_panel(W, *, n_cols, iters=24, hub=True, frac=24,
                             panel_n=8, tile_b=None):
    """Tiled panel QR on the int32 block-FP datapath.

    `givens_block_apply` on the column-major schedule at production
    shapes: quantize once (the per-(matrix, column) exponents are invariant
    under the whole rotation set, so the panel/trailing split needs no
    re-quantization), sweep the panels with
    `qrd_blocked.panel_factor_blockfp_call` and
    `qrd_blocked.panel_apply_blockfp_call` in place on strided views of
    one working buffer (the loop of `qr_packed_panel`), decode once.
    Bit-identical to `givens_block_apply` on `givens_schedule(m, n_cols)`.

    Parameters as `givens_block_apply` plus ``n_cols`` (leading columns to
    annihilate) and ``panel_n`` (panel width).

    Returns
    -------
    (..., m, e) float64 — the triangularized working matrices.
    """
    (W,) = _operands(torch.float64, None, W)
    batch = W.shape[:-2]
    m, e = W.shape[-2:]
    X, ex = _blockfp_encode(W.reshape((-1, m, e)), frac)
    for c0 in range(0, min(n_cols, m - 1), panel_n):
        nc = min(panel_n, n_cols - c0)
        piv, tgt, col = panel_steps(m - c0, nc)
        _, flip, sig = qb.panel_factor_blockfp_call(
            X[:, c0:, c0:c0 + nc], piv, tgt, col, iters=iters, hub=hub,
            tile_b=tile_b)
        if c0 + nc < e:
            qb.panel_apply_blockfp_call(X[:, c0:, c0 + nc:], piv, tgt, flip,
                                        sig, iters=iters, hub=hub)
    return _blockfp_decode(X, ex, frac).reshape(batch + (m, e))
