"""The int32 block-FP CORDIC Givens step (torch port of the arithmetic of
`repro.kernels.cordic_givens`), as plain PyTorch on integer tensors.

The datapath: significands of w = N + 2 <= 30 bits in int32 lanes, a
flip on x < 0, ``iters`` micro-rotations on the lead pair that pack their
directions into the control word sigma, sigma replayed on every other
element of the two rows, and the CORDIC gain compensated by a Q30
constant in four 15 x 15-bit partial products so every intermediate
stays inside int32.  With ``hub`` the adds and subtracts follow the
Half-Unit-Biased rules (negate by inversion, the carry-in of Fig. 6).

These functions are the plain versions of the block-FP CUDA kernels
(``csrc/blockfp.cu``, device functions in ``csrc/blockfp_unit.cuh``):

* `fused_rotate_block` — one step of the flat kernel
  (`repro_torch.kernels.qrd_blocked.qr_blockfp_call`);
* `fused_rotate_ctrl`  — one step of the panel factorization, exporting
  the control words (`panel_factor_blockfp_call`);
* `fused_replay`       — the replay of exported control words over the
  trailing columns (`panel_apply_blockfp_call`);
* `fused_rotate_pairs` — one Sameh–Kuck stage of the wavefront kernel
  (`qr_blockfp_wavefront_call`, ``csrc/wavefront.cu``).

The arithmetic follows the operands' integer type: on int32 tensors it
wraps as XLA's int32 does (two's complement), on int64 tensors the same
expressions run without wrapping, which is how the tests show whether a
case left int32.  The B6 kernels of the JAX module (`vectoring_call`,
`rotation_call`, `fused_call`) are ROADMAP B6 and not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cordic import GAIN_TABLE

__all__ = ["comp_q30", "fused_rotate_block", "fused_rotate_ctrl",
           "fused_replay", "fused_rotate_pairs", "MAX_ITERS"]

#: Deepest CORDIC the int32 datapath takes: sigma packs one bit per
#: micro-rotation into an int32, and the shift counts stay below 31.
MAX_ITERS = 30


def comp_q30(iters: int) -> int:
    """Gain compensation constant in Q30: round(2^30 / K(iters))."""
    return int(np.rint(2.0 ** 30 / GAIN_TABLE[iters]))


def _gain_mul_q30(v, comp: int):
    """(v * comp) >> 30 with all partial products inside int32.

    v: w-bit significands (|v| < 2^29); comp: Q30 constant < 2^30.  Both
    are split into 15-bit halves; each partial product is formed in the
    operand's type (wrapping on int32) before its arithmetic shift.
    """
    c_hi = comp >> 15
    c_lo = comp & 0x7FFF
    v_hi = v >> 15          # arithmetic: keeps the sign
    v_lo = v & 0x7FFF
    return (v_hi * c_hi
            + ((v_hi * c_lo) >> 15)
            + ((v_lo * c_hi) >> 15)
            + ((v_lo * c_lo) >> 30))


def _microrotation(v, i: int, d, hub: bool):
    """One micro-rotation of the stacked pair ``v = (x, y)``, shape (2, ...):
    x' = x - d (y >> i), y' = y + d (x >> i), with d = +1 or -1 per lane.

    With ``hub`` the JAX package writes the subtraction as
    ``x + ~ys + (1 - cy)`` and the addition as ``x + ys + cy``, where cy is
    bit i-1 of y (1 at i = 0).  In two's complement ``~ys + 1 - cy`` is
    ``-(ys + cy)``, so both are ``x - d (ys + cy)``, which is what is
    computed here: the same bits, wrapping on int32 or not on int64.
    The CUDA code keeps the JAX form.
    """
    s = v >> i
    if hub:
        s = s + ((v >> (i - 1)) & 1 if i else 1)
    return v + torch.stack([-d, d]) * s.flip(0)


def _negate(v, hub: bool):
    return ~v if hub else -v


def _check_iters(iters: int):
    if not 0 <= iters <= MAX_ITERS:
        raise ValueError(f"iters={iters}: the int32 datapath takes at most "
                         f"{MAX_ITERS} micro-rotations")


def _flip(v, flip, hub: bool):
    """Both rows of the stacked pair negated where ``flip``."""
    return torch.where(flip, _negate(v, hub), v)


def _vector(xl, yl, iters: int, hub: bool):
    """Vectoring on lead pairs (any shape): ``(flip, sig)``, flip as bool
    and sigma as the operand's integer type (bit i set where micro-rotation
    i turned the pair with d = +1, i.e. where y was negative)."""
    _check_iters(iters)
    flip = xl < 0
    v = _flip(torch.stack([xl, yl]), flip, hub)
    sig = torch.zeros_like(xl)
    for i in range(iters):
        d_pos = v[1] < 0
        v = _microrotation(v, i, 2 * d_pos.to(v.dtype) - 1, hub)
        sig = sig | (d_pos.to(sig.dtype) << i)
    return flip, sig


def fused_rotate_block(x, y, *, iters: int, hub: bool, comp: int):
    """Fused Givens step on two (TB, L) row blocks, lead pair at column 0.

    Vectoring on the lead column derives the control words (flip, sigma);
    then the whole block, lead column included (its replay by its own
    sigma is the vectoring result), rotates with the words and is
    gain-compensated.  Returns the rotated ``(x, y)``.
    """
    flip, sig = _vector(x[:, :1], y[:, :1], iters, hub)
    return fused_replay(x, y, flip[:, 0], sig[:, 0], iters=iters, hub=hub,
                        comp=comp)


def fused_rotate_ctrl(x, y, lead, *, iters: int, hub: bool, comp: int):
    """`fused_rotate_block` at uniform panel width, exporting the control
    words.

    x, y : (TB, pw) rows; lead : (1, pw) 0/1 one-hot of the lead
    (annihilated) column, whose pair is selected by contraction.  Returns
    ``(rx, ry, flip, sig)``: the rows rotated at every lane (lanes left of
    the lead must be restored by the caller) and the (TB,) control words,
    flip as 0/1, in the operands' type.
    """
    sel = lead.to(x.dtype)
    xl = torch.sum(x * sel, dim=-1, dtype=x.dtype)
    yl = torch.sum(y * sel, dim=-1, dtype=y.dtype)
    flip, sig = _vector(xl, yl, iters, hub)
    flip = flip.to(x.dtype)
    rx, ry = fused_replay(x, y, flip, sig, iters=iters, hub=hub, comp=comp)
    return rx, ry, flip, sig


def fused_rotate_pairs(x, y, lead, *, iters: int, hub: bool, comp: int):
    """Fused Givens step on a whole pair axis of row blocks: one stage.

    x, y : (TB, P, e) pivot and target rows of the stage's P pairs, at
    uniform width e; lead : (P, e) 0/1 or bool one-hot of each pair's lead
    column.  Vectoring on each pair's lead gives one control word per
    (matrix, pair); it is replayed across the whole row, lanes left of the
    lead included (the caller restores those) and the lead itself, where
    the replay equals the vectoring result.  Returns the rotated
    ``(x, y)``.
    """
    sel = lead[None].to(x.dtype)
    xl = torch.sum(x * sel, dim=-1, dtype=x.dtype)   # (TB, P) lead pairs
    yl = torch.sum(y * sel, dim=-1, dtype=y.dtype)
    flip, sig = _vector(xl, yl, iters, hub)
    return fused_replay(x, y, flip, sig, iters=iters, hub=hub, comp=comp)


def fused_replay(x, y, flip, sig, *, iters: int, hub: bool, comp: int):
    """Replay exported ``(flip, sigma)`` control words over two row blocks.

    x, y : (..., L) rows; flip, sig : (...,) control words (flip as 0/1
    or bool), one per row pair.  Replaying sigma on the pair that produced it reproduces the
    vectoring output bit for bit, and on any other column applies the same
    micro-rotation sequence.
    """
    _check_iters(iters)
    v = _flip(torch.stack([x, y]), (flip != 0)[..., None], hub)
    bits = (sig[..., None] >> torch.arange(iters, device=sig.device)) & 1
    d = 2 * bits.to(v.dtype) - 1                     # (TB, iters): +1 / -1
    for i in range(iters):
        v = _microrotation(v, i, d[..., i:i + 1], hub)
    v = _gain_mul_q30(v, comp)
    return v[0], v[1]
