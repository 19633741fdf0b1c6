"""Public wrappers over the CUDA kernels (torch port of the main-path part
of `repro.kernels.ops`).

The kernels take one flat batch axis; these wrappers accept any leading
batch shape and restore it.  Ragged batches need no padding here: the
kernels mask the ragged edge of their last block.  The dual-int32
``lanes`` route of the JAX package is ROADMAP B8 and not ported yet.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from repro_torch.core.qrd import SCHEDULE_CACHE_SIZE

from . import qrd_blocked as qb

__all__ = ["qr_packed", "panel_steps", "qr_packed_panel"]

def qr_packed(P, *, cfg, steps, tile_b=None):
    """Kernel-resident blocked QR over packed FP words (bit-exact path).

    Parameters
    ----------
    P : (..., m, e) int64 tensor
        Packed FP words of the augmented working matrices; any leading
        batch shape.
    cfg : GivensConfig — unit configuration.
    steps : tuple[(int, int, int), ...] — ``(pivot_row, target_row, col)``.
    tile_b : int, optional — matrices per CUDA block (`qrd_blocked.TILE_B`).

    Returns
    -------
    (..., m, e) int64 — triangularized packed words, bit-identical to
    running `GivensUnit.rotate_rows` step by step (`qr_cordic`).
    """
    batch = P.shape[:-2]
    m, e = P.shape[-2:]
    Pf = P.to(torch.int64).reshape((-1, m, e)).contiguous()
    out = qb.qr_packed_call(Pf, cfg=cfg, steps=steps, tile_b=tile_b)
    return out.reshape(batch + (m, e))


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
