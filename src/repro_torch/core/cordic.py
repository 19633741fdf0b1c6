"""Fixed-point CORDIC core with sigma-bit reuse (torch port of
`repro.core.cordic`).

The X-Y CORDIC datapath without a Z (angle) datapath: vectoring produces
the per-microrotation direction bits sigma_i plus one coarse "flip" bit for
the x<0 pre-rotation; rotation replays them on further element pairs.

Values are w-bit two's-complement integers in int64 tensors, F = N - 2
fraction bits and w = N + 2 total bits.  Conventional mode truncates on
right shifts; HUB mode (Sec. 4.2) carries an implicit LSB, so the adder
carry-in is the (i-1)-th bit of the pre-shift coordinate and negation is
bit inversion.  `iters` is a static Python int here, so the micro-rotation
loop is a Python loop.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "MAX_ITERS", "GAIN_TABLE", "cordic_gain", "gain_comp_constant",
    "gain_shift", "fixmul", "vectoring", "rotation", "apply_gain",
    "vectoring_rotation",
]

MAX_ITERS = 60

# K(k) = prod_{i<k} sqrt(1 + 2^-2i); GAIN_TABLE[k] is the gain after k
# micro-rotations.  Computed in numpy exactly as the JAX package does, so
# the compensation constants agree to the bit.
_g = np.cumprod([np.sqrt(1.0 + 2.0 ** (-2.0 * i)) for i in range(MAX_ITERS)])
GAIN_TABLE = np.concatenate([[1.0], _g])


def cordic_gain(iters: int) -> float:
    """The CORDIC gain K(iters) after ``iters`` micro-rotations."""
    return float(GAIN_TABLE[iters])


def gain_comp_constant(iters: int, p: int) -> int:
    """Integer compensation constant: round(2^p / K(iters)), on the host."""
    inv_gain = np.float64(1.0) / np.float64(GAIN_TABLE[iters])
    return int(np.rint(inv_gain * np.exp2(np.float64(p))))


def gain_shift(w: int) -> int:
    """Shift p of the gain constant: 78 - w capped to 46 keeps every partial
    product of `fixmul` inside int64."""
    return int(min(78 - w, 46))


def fixmul(v, comp: int, p: int, round_nearest: bool):
    """(v * comp) >> p for w-bit v and ~p-bit comp without int64 overflow.

    Splits v into 16-bit low / high halves so partial products stay < 2^63.
    `round_nearest=True` adds half an LSB before the final shift; HUB mode
    passes False (truncation is round-to-nearest for HUB).
    """
    v_lo = v & 0xFFFF
    v_hi = v >> 16  # arithmetic; keeps the sign
    acc = v_hi * comp + ((v_lo * comp) >> 16)
    sh = p - 16
    if round_nearest:
        acc = acc + (1 << (sh - 1))
    return acc >> sh


def _negate(v, hub: bool):
    return ~v if hub else -v


def _carry_bit(y, i: int):
    """HUB carry-in: ILSB (1) at i == 0, else bit (i-1) of the pre-shift y."""
    if i == 0:
        return 1
    return (y >> (i - 1)) & 1


def _microrotation(x, y, i: int, d_pos, hub: bool):
    """One micro-rotation:  x' = x - d*(y>>i),  y' = y + d*(x>>i).

    d_pos is a boolean tensor: True => d = +1, False => d = -1.
    """
    ys = y >> i
    xs = x >> i
    if hub:
        cy = _carry_bit(y, i)
        cx = _carry_bit(x, i)
        x_sub = x + ~ys + (1 - cy)   # x - (y>>i)
        x_add = x + ys + cy          # x + (y>>i)
        y_add = y + xs + cx          # y + (x>>i)
        y_sub = y + ~xs + (1 - cx)   # y - (x>>i)
    else:
        x_sub = x - ys
        x_add = x + ys
        y_add = y + xs
        y_sub = y - xs
    return torch.where(d_pos, x_sub, x_add), torch.where(d_pos, y_add, y_sub)


def vectoring(x, y, iters: int, hub: bool):
    """Vectoring mode: drive y -> 0, recording direction bits.

    Returns (x_rot, y_rot, flip, sigmas): flip is int64 0/1 (pi pre-rotation
    when x < 0), sigmas an int64 bitmask (bit i == 1 means d_i = +1).  Gain
    compensation is NOT applied here (see `apply_gain`).
    """
    flip = (x < 0).to(torch.int64)
    x = torch.where(flip == 1, _negate(x, hub), x)
    y = torch.where(flip == 1, _negate(y, hub), y)
    sig = torch.zeros_like(x)
    for i in range(iters):
        d_pos = y < 0
        x, y = _microrotation(x, y, i, d_pos, hub)
        sig = sig | (d_pos.to(torch.int64) << i)
    return x, y, flip, sig


def rotation(x, y, flip, sigmas, iters: int, hub: bool):
    """Rotation mode: replay the stored (flip, sigma) micro-rotation sequence."""
    x = torch.where(flip == 1, _negate(x, hub), x)
    y = torch.where(flip == 1, _negate(y, hub), y)
    for i in range(iters):
        d_pos = ((sigmas >> i) & 1) == 1
        x, y = _microrotation(x, y, i, d_pos, hub)
    return x, y


def apply_gain(x, y, iters: int, w: int, hub: bool):
    """Compensate the CORDIC gain: multiply by round(2^p / K(iters)) >> p."""
    p = gain_shift(w)
    comp = gain_comp_constant(iters, p)
    return (fixmul(x, comp, p, round_nearest=not hub),
            fixmul(y, comp, p, round_nearest=not hub))


def vectoring_rotation(x_lead, y_lead, x_rest, y_rest, iters: int, w: int,
                       hub: bool):
    """Full Givens rotation of two rows in the fixed-point domain.

    (x_lead, y_lead): the leading element pair (any batch shape).
    (x_rest, y_rest): the remaining element pairs, with one extra trailing
    axis that the (flip, sigma) state broadcasts across.
    Returns the rotated (r_lead, y0_lead, x_rest', y_rest'), gain
    compensated.
    """
    xl, yl, flip, sig = vectoring(x_lead, y_lead, iters, hub)
    xr, yr = rotation(x_rest, y_rest, flip[..., None], sig[..., None], iters,
                      hub)
    xl, yl = apply_gain(xl, yl, iters, w, hub)
    xr, yr = apply_gain(xr, yr, iters, w, hub)
    return xl, yl, xr, yr
