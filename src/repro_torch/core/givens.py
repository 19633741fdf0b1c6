"""The FP Givens rotation unit (paper Fig. 1), torch port of
`repro.core.givens`: input converter + sigma-reusing CORDIC + output
converter, on packed int64 words.

  vector(x, y)            -> (r, y0, state)   # vectoring: compute the angle
  rotate(x, y, state)     -> (x', y')         # rotation: replay the angle

Both are vectorized over any batch shape; `rotate` broadcasts one state over
a trailing axis of row elements.  `annihilate` is the pivot-anywhere step of
QRD-RLS.  The complex datapath is the three-rotation decomposition on
(re, im) lane pairs: `phase_vector`, `phase_rotate` and
`rotate_rows_complex` (complex QRD-RLS's `annihilate_complex` is ROADMAP A9).
"""
from __future__ import annotations

import dataclasses

import torch

from . import converters as conv
from . import cordic
from .formats import (FloatFormat, SINGLE, encode_hub, encode_ieee,
                      decode_hub, decode_ieee, packed_is_zero)

__all__ = ["GivensConfig", "GivensUnit"]


@dataclasses.dataclass(frozen=True)
class GivensConfig:
    """Implementation parameters of the unit (paper Sec. 5 sweep space)."""

    fmt: FloatFormat = SINGLE
    n: int = 26                 # internal significand width N
    iters: int | None = None    # CORDIC micro-rotations; None -> paper default
    hub: bool = False           # conventional (IEEE-like) vs HUB datapath
    input_rounding: str = "trunc"   # IEEE input converter: 'rne' | 'trunc'
    unbiased: bool = True           # HUB converters: unbiased extension
    detect_identity: bool = True    # HUB input converter: detect exact 1.0

    def default_iters(self) -> int:
        # Fig. 9: conventional peaks at N-3 micro-rotations, HUB at N-2.
        return self.n - 2 if self.hub else self.n - 3

    def resolved_iters(self) -> int:
        return self.default_iters() if self.iters is None else self.iters

    def validate(self):
        if self.n < self.fmt.man_bits + 2:
            raise ValueError("need N >= man_bits + 2 for a lossless expand")
        if self.n + 3 > 53:
            raise ValueError("bit-accurate emulation supports N <= 50 "
                             "(int64 lanes + exact float64 ilog2)")
        if self.input_rounding not in ("rne", "trunc"):
            raise ValueError(self.input_rounding)


class GivensUnit:
    """Bit-accurate facade over the converter + CORDIC pipeline (Fig. 1).

    All methods operate on *packed* FP words (int64 tensors with the
    ``[sign | exponent | mantissa]`` layout of ``cfg.fmt``), on any device
    and batch shape.  The CUDA kernel `kernels/csrc/qr_packed.cu` runs the
    same dataflow per element; this class is its plain PyTorch version.
    """

    def __init__(self, config: GivensConfig):
        config.validate()
        self.cfg = config

    def encode(self, x):
        """float tensor -> int64 packed words of ``cfg.fmt`` (IEEE or HUB)."""
        f = encode_hub if self.cfg.hub else encode_ieee
        return f(x, self.cfg.fmt)

    def decode(self, packed):
        """int64 packed words -> float64 values (packed-zero -> ±0.0)."""
        f = decode_hub if self.cfg.hub else decode_ieee
        return f(packed, self.cfg.fmt)

    def _to_fixed(self, xp, yp, N):
        if self.cfg.hub:
            return conv.input_convert_hub(
                xp, yp, self.cfg.fmt, N,
                unbiased=self.cfg.unbiased,
                detect_identity=self.cfg.detect_identity)
        return conv.input_convert_ieee(
            xp, yp, self.cfg.fmt, N, rounding=self.cfg.input_rounding)

    def _to_float(self, v, m_exp, N):
        if self.cfg.hub:
            return conv.output_convert_hub(
                v, m_exp, self.cfg.fmt, N, unbiased=self.cfg.unbiased)
        return conv.output_convert_ieee(v, m_exp, self.cfg.fmt, N)

    def _widths(self, N, iters):
        """``(N, iters)``: each override as a Python int (a 0-d tensor or a
        numpy integer is accepted), or the config's value where None."""
        return (self.cfg.n if N is None else int(N),
                self.cfg.resolved_iters() if iters is None else int(iters))

    def vector(self, xp, yp, N=None, iters=None):
        """Vectoring on the leading pair -> ``(r_packed, y_packed, (flip, sigmas))``.

        ``N`` and ``iters`` override the config's significand width and
        CORDIC depth (the paper's Fig. 9 sweep); None takes the config's.
        """
        N, iters = self._widths(N, iters)
        xf, yf, m_exp = self._to_fixed(xp, yp, N)
        xr, yr, flip, sig = cordic.vectoring(xf, yf, iters, self.cfg.hub)
        xr, yr = cordic.apply_gain(xr, yr, iters, N + 2, self.cfg.hub)
        return (self._to_float(xr, m_exp, N),
                self._to_float(yr, m_exp, N),
                (flip, sig))

    def rotate(self, xp, yp, state, N=None, iters=None):
        """Replay ``state = (flip, sigmas)`` on another element pair;
        ``N``/``iters`` as in `vector`."""
        N, iters = self._widths(N, iters)
        flip, sig = state
        xf, yf, m_exp = self._to_fixed(xp, yp, N)
        xr, yr = cordic.rotation(xf, yf, flip, sig, iters, self.cfg.hub)
        xr, yr = cordic.apply_gain(xr, yr, iters, N + 2, self.cfg.hub)
        return (self._to_float(xr, m_exp, N),
                self._to_float(yr, m_exp, N))

    def rotate_rows(self, row_x, row_y, N=None, iters=None):
        """Full Givens rotation of two packed rows (..., e).

        Vectoring on element 0, rotation broadcast over elements 1..e-1.
        Returns the rotated rows; row_y[..., 0] is the (near-)zeroed entry.
        ``N``/``iters`` as in `vector`.
        """
        rx0, ry0, (flip, sig) = self.vector(row_x[..., 0], row_y[..., 0],
                                            N, iters)
        rx, ry = self.rotate(row_x[..., 1:], row_y[..., 1:],
                             (flip[..., None], sig[..., None]), N, iters)
        return (torch.cat([rx0[..., None], rx], dim=-1),
                torch.cat([ry0[..., None], ry], dim=-1))

    # -- complex datapath: the three-rotation decomposition ------------------
    def phase_vector(self, re_p, im_p, N=None, iters=None):
        """Vectoring on the (re, im) lane pair of one complex entry.

        Returns ``(mag_packed, state, skip)``: the realized entry (|z|
        packed; the raw real lane where ``skip``), the replayable ``(flip,
        sigmas)`` phase control word, and the lanes whose imaginary word is
        ±0, where the phase rotation is the exact identity (purely real
        inputs then follow the real datapath bit for bit).  ``N``/``iters``
        as in `vector`.
        """
        mag, _, state = self.vector(re_p, im_p, N, iters)
        skip = packed_is_zero(im_p, self.cfg.fmt)
        return torch.where(skip, re_p, mag), state, skip

    def phase_rotate(self, re_p, im_p, state, skip, N=None, iters=None):
        """Replay a phase control word on further (re, im) lane pairs;
        where ``skip`` the inputs pass through untouched."""
        rr, ri = self.rotate(re_p, im_p, state, N, iters)
        return torch.where(skip, re_p, rr), torch.where(skip, im_p, ri)

    def rotate_rows_complex(self, row_x, row_y, N=None, iters=None):
        """Complex Givens rotation of two packed rows of (re, im) lanes.

        Two phase rotations realize the lead entries of the pivot and the
        target row, then the real Givens on the realized leads replays
        across the re and the im lanes independently.

        Parameters
        ----------
        row_x, row_y : (..., e, 2) int64 packed words — pivot and target
            row; the trailing axis holds the (re, im) lanes.

        Returns
        -------
        (row_x', row_y') with the structural zeros forced:
        ``row_y'[..., 0, :] == 0`` and ``row_x'[..., 0, 1] == 0`` (the
        realized pivot is real).  ``N``/``iters`` as in `vector`.
        """
        xr, xi = row_x[..., 0], row_x[..., 1]
        yr, yi = row_y[..., 0], row_y[..., 1]
        magx, (fx, sx), skx = self.phase_vector(xr[..., 0], xi[..., 0], N,
                                                iters)
        magy, (fy, sy), sky = self.phase_vector(yr[..., 0], yi[..., 0], N,
                                                iters)
        pxr, pxi = self.phase_rotate(xr[..., 1:], xi[..., 1:],
                                     (fx[..., None], sx[..., None]),
                                     skx[..., None], N, iters)
        pyr, pyi = self.phase_rotate(yr[..., 1:], yi[..., 1:],
                                     (fy[..., None], sy[..., None]),
                                     sky[..., None], N, iters)
        r, _, (flip, sig) = self.vector(magx, magy, N, iters)
        st = (flip[..., None], sig[..., None])
        oxr, oyr = self.rotate(pxr, pyr, st, N, iters)
        oxi, oyi = self.rotate(pxi, pyi, st, N, iters)
        zero = torch.zeros_like(r)[..., None]
        out_x = torch.stack([torch.cat([r[..., None], oxr], dim=-1),
                             torch.cat([zero, oxi], dim=-1)], dim=-1)
        out_y = torch.stack([torch.cat([zero, oyr], dim=-1),
                             torch.cat([zero, oyi], dim=-1)], dim=-1)
        return out_x, out_y

    def annihilate(self, row_x, row_y, col, N=None, iters=None):
        """Givens-rotate two packed rows so ``row_y[col]`` is zeroed.

        The pivot-anywhere form of `rotate_rows`, the step of the QRD-RLS
        unit mode (`repro_torch.qrd.rls.RLSState`): the rows are rolled so
        the pivot column leads, rotated (vectoring on the pivot pair, sigma
        replayed across the rest), the annihilated entry forced to the
        structural packed zero, and rolled back.

        Parameters
        ----------
        row_x, row_y : (..., e) int64 packed FP words — pivot and target row.
        col : int — pivot column; ``row_y[..., col]`` is annihilated against
            ``row_x[..., col]``.
        N, iters : optional overrides, as in `vector`.

        Returns
        -------
        (row_x', row_y') packed rows with ``row_y'[..., col] == 0``.
        """
        rx = torch.roll(row_x, -col, dims=-1)
        ry = torch.roll(row_y, -col, dims=-1)
        ox, oy = self.rotate_rows(rx, ry, N, iters)
        oy[..., 0] = 0              # the zeroed entry is structural
        return torch.roll(ox, col, dims=-1), torch.roll(oy, col, dims=-1)
