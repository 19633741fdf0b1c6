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
  (`qr_blockfp_wavefront_call`, B2's kernel on the stages).

and the module holds the standalone rotator's three CUDA kernels
(``csrc/rotator.cu``), which replace their namesakes of
`repro.kernels.cordic_givens`, with their launch wrappers, launch counters
and plain versions:

* `vectoring_call`  — vectoring on (B,) lead pairs: the gain-compensated
  pair and the control words (flip, sigma); plain `vectoring_reference`;
* `rotation_call`   — (flip, sigma) replayed on (B, L) row pairs; plain
  `rotation_reference` (`fused_replay`);
* `fused_call`      — both on (B, L) rows, the lead at column 0; plain
  `fused_reference` (`fused_rotate_block`).

Each wrapper dispatches on the operands' device: CUDA tensors launch the
kernel (or raise), CPU tensors run the plain version.

The arithmetic follows the operands' integer type: on int32 tensors it
wraps as XLA's int32 does (two's complement), on int64 tensors the same
expressions run without wrapping, which is how the tests show whether a
case left int32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cordic import GAIN_TABLE

from . import _launch

__all__ = ["packed_to_lanes", "lanes_to_packed", "comp_q30", "fused_rotate_block", "fused_rotate_ctrl",
           "fused_replay", "fused_rotate_pairs", "MAX_ITERS",
           "vectoring_call", "vectoring_reference", "VECTORING_LAUNCHES",
           "rotation_call", "rotation_reference", "ROTATION_LAUNCHES",
           "fused_call", "fused_reference", "FUSED_LAUNCHES"]

#: Deepest CORDIC the int32 datapath takes: sigma packs one bit per
#: micro-rotation into an int32, and the shift counts stay below 31.
MAX_ITERS = 30

#: Launches of each rotator kernel in this process (comparisons included);
#: callers reset them to 0 to count one run.
VECTORING_LAUNCHES = 0
ROTATION_LAUNCHES = 0
FUSED_LAUNCHES = 0

#: Threads a row the rotation kernel is compiled for (``rotation_launch``),
#: each turning `FUSED_CHAINS` columns as independent chains and taking any
#: row width in tiles; `rotation_call` picks by the fused kernel's rule
#: (`_fused_layout`).
ROTATION_THREADS = (1, 2, 4, 8, 16, 32)

#: Columns a thread of the fused kernel turns as independent chains, and
#: the (threads a row, columns a thread) layouts it is compiled for
#: (``fused_launch``): 8 columns a thread on 1-32 threads a row, which
#: `_fused_layout` picks by row width, and two others for the readings at
#: rows of 128.
FUSED_CHAINS = 8
FUSED_LAYOUTS = ((1, 8), (2, 8), (4, 8), (8, 8), (16, 8), (32, 8), (32, 4),
                 (8, 16))


def packed_to_lanes(p):
    """Packed int64 FP words -> stacked (hi, lo) int32 lane words (..., 2):
    ``[..., 0] = int32(p >> 32)``, ``[..., 1] = int32(p)``, on p's device.
    Exact (two's complement) and inverted by `lanes_to_packed`; the operand
    of the dual-int32 kernels (`repro_torch.kernels.packed_lanes`)."""
    p = torch.as_tensor(p).to(torch.int64)
    lo = ((p & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    return torch.stack([(p >> 32).to(torch.int32), lo.to(torch.int32)],
                       dim=-1)


def lanes_to_packed(L):
    """Stacked (hi, lo) int32 lane words (..., 2) -> packed int64 FP words,
    on L's device."""
    hi = L[..., 0].to(torch.int64)
    lo = L[..., 1].to(torch.int64) & 0xFFFFFFFF
    return (hi << 32) | lo


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


# ---------------------------------------------------------------------------
# The standalone rotator (csrc/rotator.cu)
# ---------------------------------------------------------------------------
def vectoring_reference(x, y, *, iters: int, hub: bool):
    """Plain PyTorch version of the vectoring kernel, on any device.

    x, y : (B,) integer lead pairs.  Returns ``(xr, yr, flip, sig)``: the
    gain-compensated vectored pair (``yr`` the residual, near 0) and the
    control words, flip as 0/1, all in the operands' type.  The pair is the
    lead replayed by its own control word, which is the vectoring result
    bit for bit.
    """
    flip, sig = _vector(x, y, iters, hub)
    flip = flip.to(x.dtype)
    xr, yr = fused_replay(x[:, None], y[:, None], flip, sig, iters=iters,
                          hub=hub, comp=comp_q30(iters))
    return xr[:, 0], yr[:, 0], flip, sig


def rotation_reference(x, y, flip, sig, *, iters: int, hub: bool):
    """Plain PyTorch version of the rotation kernel, on any device: the
    (B,) control words replayed on the (B, L) row pairs (`fused_replay`)."""
    return fused_replay(x, y, flip, sig, iters=iters, hub=hub,
                        comp=comp_q30(iters))


def fused_reference(x, y, *, iters: int, hub: bool):
    """Plain PyTorch version of the fused kernel, on any device: the (B, L)
    row pairs through `fused_rotate_block`, the lead at column 0."""
    if x.shape[-1] == 0:
        return x.clone(), y.clone()
    return fused_rotate_block(x, y, iters=iters, hub=hub,
                              comp=comp_q30(iters))


def _rotator_args(iters: int, hub: bool):
    """(iters, hub, comp) as the rotator kernels take them."""
    _check_iters(iters)
    return int(iters), int(bool(hub)), comp_q30(iters)


def _outputs(fn: str, x, out, plain=None):
    """The output pair of a wrapper.  On the CPU, ``plain`` (the plain
    version's pair) written into ``out`` when given, else ``plain`` itself.
    On the card, ``out`` checked against ``x``, or two new tensors like
    ``x``."""
    if plain is not None:
        if out is None:
            return plain
        for o, p in zip(out, plain):
            o.copy_(p)
        return out
    if out is None:
        return (torch.empty(x.shape, dtype=torch.int32, device=x.device),
                torch.empty(x.shape, dtype=torch.int32, device=x.device))
    _launch.check_operand(fn, x, *out, ndim=x.dim(), dtype=torch.int32)
    return out


def vectoring_call(x, y, *, iters: int, hub: bool, out=None):
    """Vectoring on lead pairs: one CUDA launch.

    Parameters
    ----------
    x, y : (B,) int32 — lead pairs of block-FP significands, any stride
        (e.g. column 0 of a (B, L) row block).  On CPU tensors the plain
        version runs instead of the kernel.
    iters, hub : CORDIC depth (at most 30) and HUB or conventional
        arithmetic.
    out : pair of (B,) int32 tensors, optional — where the vectored pair is
        written (any stride), e.g. column 0 of the rotated rows.

    Returns
    -------
    (xr, yr, flip, sig) : the gain-compensated vectored pair (``out`` when
    given) and the (B,) int32 control words.
    """
    global VECTORING_LAUNCHES
    args = _rotator_args(iters, hub)
    if _launch.check_operand("vectoring_call", x, y, ndim=1,
                             dtype=torch.int32):
        xr, yr, flip, sig = vectoring_reference(x, y, iters=iters, hub=hub)
        return (*_outputs("vectoring_call", x, out, (xr, yr)), flip, sig)
    xo, yo = _outputs("vectoring_call", x, out)
    (B,) = x.shape
    flip = torch.empty(B, dtype=torch.int32, device=x.device)
    sig = torch.empty_like(flip)
    if B == 0:
        return xo, yo, flip, sig
    err = _launch.lib("rotator").vectoring_launch(
        *_vectoring_argv(x, y, xo, yo, flip, sig, args))
    _launch.check_launch("rotator", err)
    VECTORING_LAUNCHES += 1
    return xo, yo, flip, sig


def _vectoring_argv(x, y, xo, yo, flip, sig, args):
    """The arguments of ``vectoring_launch`` for B6a on the (B,) CUDA
    operands; ``args`` are `_rotator_args`."""
    ops = (x, y, xo, yo)
    return (*(t.data_ptr() for t in ops), *(t.stride(0) for t in ops),
            flip.data_ptr(), sig.data_ptr(), x.shape[0], *args,
            _launch.stream(x))


def rotation_call(x, y, flip, sig, *, iters: int, hub: bool, out=None):
    """Replay control words across row pairs: one CUDA launch.

    Parameters
    ----------
    x, y : (B, L) int32 — row pairs of block-FP significands, any row
        stride, unit column stride.  On CPU tensors the plain version runs
        instead of the kernel.
    flip, sig : (B,) int32 control words (`vectoring_call`), one per row
        pair.
    iters, hub : CORDIC depth (at most 30) and HUB or conventional
        arithmetic.
    out : pair of (B, L) int32 tensors, optional — where the rotated rows
        are written (any row stride, unit column stride).

    Returns
    -------
    (xr, yr) : the (B, L) gain-compensated rotated rows (``out`` when
    given).  An empty operand (B = 0 or L = 0) launches nothing.

    The kernel turns each row on `_fused_layout` threads, each replaying
    the row's control word on its columns as independent chains; it reads
    whole 16-byte groups where the operands' bases share their offset from
    a 16-byte boundary and the row strides allow (`_rotation_head`), as
    for the ``x[:, 1:]`` views of `givens_rotate_rows_fixed`.
    """
    args = _rotator_args(iters, hub)
    if _launch.check_operand("rotation_call", x, y, ndim=2,
                             dtype=torch.int32):
        _launch.check_operand("rotation_call", flip, sig, ndim=1,
                              dtype=torch.int32)
        return _outputs("rotation_call", x, out,
                        rotation_reference(x, y, flip, sig, iters=iters,
                                           hub=hub))
    return _rotation_launch(x, y, flip, sig, args, out=out)


def _rotation_head(ops):
    """The head of B6b's 16-byte path on the (B, L) operands ``ops``: the
    words h that every base lies past a 16-byte boundary, where that is one
    h and each row stride is a multiple of 4 words (any stride for one
    row); else None (single words)."""
    heads = {t.data_ptr() % 16 // 4 for t in ops}
    if len(heads) == 1 and all(t.shape[0] == 1 or t.stride(0) % 4 == 0
                               for t in ops):
        return heads.pop()
    return None


def _rotation_argv(x, y, flip, sig, xo, yo, args, threads=None):
    """The arguments of ``rotation_launch`` for B6b on the (B, L) CUDA
    operands at ``threads`` a row, by default those of `_fused_layout` on
    the row's words from its 16-byte groups' start; ``args`` are
    `_rotator_args`."""
    ops = (x, y, xo, yo)
    head = _rotation_head(ops)
    B, L = x.shape
    T = threads or _fused_layout(L + (head or 0))[0]
    return (*(t.data_ptr() for t in ops), *(t.stride(0) for t in ops),
            flip.data_ptr(), sig.data_ptr(), B, L, head or 0, T,
            int(head is not None), *args, _launch.stream(x))


def _rotation_launch(x, y, flip, sig, args, threads=None, out=None):
    """B6b on (B, L) CUDA row pairs at ``threads`` a row, one of
    `ROTATION_THREADS` (by default the wrapper's): the rotated rows, in
    ``out`` when given."""
    global ROTATION_LAUNCHES
    B, L = x.shape
    if (_launch.check_operand("rotation_call", flip, sig, ndim=1,
                              dtype=torch.int32)
            or flip.shape != (B,) or flip.device != x.device
            or not (flip.is_contiguous() and sig.is_contiguous())):
        raise ValueError(f"rotation_call: flip and sig must be contiguous "
                         f"({B},) int32 tensors on {x.device}")
    if threads is not None and threads not in ROTATION_THREADS:
        raise ValueError(f"rotation_call: no layout of {threads} threads a "
                         f"row (compiled: {ROTATION_THREADS})")
    if L > 2 ** 31 - 1 - 3 - 32 * FUSED_CHAINS:
        raise ValueError(f"rotation_call: rows of {L} elements exceed the "
                         f"kernel's int32 column index")
    xo, yo = _outputs("rotation_call", x, out)
    if B == 0 or L == 0:
        return xo, yo
    err = _launch.lib("rotator").rotation_launch(
        *_rotation_argv(x, y, flip, sig, xo, yo, args, threads))
    _launch.check_launch("rotator", err)
    ROTATION_LAUNCHES += 1
    return xo, yo


def _fused_layout(L: int):
    """(threads a row, columns a thread) of the fused kernel on rows of L:
    `FUSED_CHAINS` columns a thread, on the fewest threads a row (a power
    of two, at most a warp) that cover the row; a row wider than 32 x
    `FUSED_CHAINS` takes several tiles."""
    threads = 1
    while threads < 32 and threads * FUSED_CHAINS < L:
        threads *= 2
    return threads, FUSED_CHAINS


def fused_call(x, y, *, iters: int, hub: bool):
    """Vectoring on column 0 and its replay on the whole row pair, in one
    pass: one CUDA launch.

    Parameters
    ----------
    x, y : (B, L) int32 — row pairs, the lead pair at column 0, any row
        stride, unit column stride.  On CPU tensors the plain version runs
        instead of the kernel.
    iters, hub : CORDIC depth (at most 30) and HUB or conventional
        arithmetic.

    Returns
    -------
    (xr, yr) : (B, L) int32 rotated rows, bit-identical to `vectoring_call`
    on column 0 followed by `rotation_call` on the rest.  An empty operand
    launches nothing.

    The kernel turns each row on `_fused_layout` threads, each rotating
    its columns as independent chains while the row's lead is vectored;
    it reads and writes 16-byte vectors where the operands' base pointers
    and row strides allow.
    """
    args = _rotator_args(iters, hub)
    if _launch.check_operand("fused_call", x, y, ndim=2, dtype=torch.int32):
        return fused_reference(x, y, iters=iters, hub=hub)
    return _fused_launch(x, y, args, *_fused_layout(x.shape[1]))


def _fused_vectors(ops) -> bool:
    """Whether the fused kernel moves the (B, L) operands ``ops`` in 16-byte
    vectors: L a multiple of 4, each base 16-byte aligned and each row
    stride a multiple of 4 words (any stride for one row)."""
    B, L = ops[0].shape
    return L % 4 == 0 and all(t.data_ptr() % 16 == 0
                              and (B == 1 or t.stride(0) % 4 == 0)
                              for t in ops)


def _fused_launch(x, y, args, threads_row: int, chains: int):
    """B6c on CUDA tensors at a layout of `FUSED_LAYOUTS` (``threads_row``
    threads a row, ``chains`` columns a thread; only 32 threads a row take
    rows wider than one tile); ``args`` are `_rotator_args`.  Returns new
    (B, L) outputs."""
    global FUSED_LAUNCHES
    B, L = x.shape
    tile = threads_row * chains
    if (threads_row, chains) not in FUSED_LAYOUTS or (L > tile
                                                      and threads_row != 32):
        raise ValueError(f"fused_call: no layout of {threads_row} threads a "
                         f"row with {chains} columns each for rows of {L}")
    if L > 2 ** 31 - 1 - tile:
        raise ValueError(f"fused_call: rows of {L} elements exceed the "
                         f"kernel's int32 column index")
    xo, yo = _outputs("fused_call", x, None)
    if B == 0 or L == 0:
        return xo, yo
    ops = (x, y, xo, yo)
    err = _launch.lib("rotator").fused_launch(
        *(t.data_ptr() for t in ops), *(t.stride(0) for t in ops), B, L,
        threads_row, chains, int(_fused_vectors(ops)), *args,
        _launch.stream(x))
    _launch.check_launch("rotator", err)
    FUSED_LAUNCHES += 1
    return xo, yo
