"""Public wrappers over the CUDA kernels (torch port of the main-path part
of `repro.kernels.ops`).

The kernels take one flat batch axis; these wrappers accept any leading
batch shape and restore it.  Ragged batches need no padding here: the
kernel masks the ragged edge of its last block.  The dual-int32 ``lanes``
route of the JAX package is ROADMAP B8 and not ported yet.
"""
from __future__ import annotations

import torch

from . import qrd_blocked as qb

__all__ = ["qr_packed"]


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
