"""Kernel-resident QR over packed FP words: the CUDA kernels, their launch
wrappers, launch counters and plain PyTorch versions.

* `qr_packed_call` (``csrc/qr_packed.cu``) replaces
  `repro.kernels.qrd_blocked.qr_packed_call`: every schedule step of the
  flat route on one resident m x e tile, run in stages of disjoint row
  pairs (`flat_stage_table`), bit-identical to `qr_packed_reference`, the
  loop of `GivensUnit.rotate_rows` over the steps.  A tile beyond a
  block's shared memory is factorized in place in device memory.
* `panel_factor_packed_call` and `panel_apply_packed_call`
  (``csrc/panel_packed.cu``) replace their namesakes of the JAX package:
  the panel route's factorization of an mr x pw panel, exporting each
  step's control word ``(flip, sigma)``, and the replay of those words over
  the trailing columns.  Both run the panel's steps in stages of disjoint
  row pairs (`levelize_steps`).  Bit-identical to
  `panel_factor_packed_reference` and `panel_apply_packed_reference`,
  loops of `GivensUnit.vector` and `GivensUnit.rotate` in step order.
* `qr_blockfp_call`, `panel_factor_blockfp_call` and
  `panel_apply_blockfp_call` (``csrc/blockfp.cu``) replace their namesakes
  of the JAX package on the int32 block-FP datapath: the same three jobs on
  int32 significands with one shared exponent per (matrix, column) (the
  flat one in the stages of `flat_stage_table`, the panel factor and
  apply in those of `levelize_steps`),
  bit-identical to `qr_blockfp_reference`,
  `panel_factor_blockfp_reference` and `panel_apply_blockfp_reference`,
  loops of `repro_torch.kernels.cordic_givens.fused_rotate_block`,
  `fused_rotate_ctrl` and `fused_replay`.
* `qr_packed_wavefront_call` and `qr_blockfp_wavefront_call` (B1's and
  B2's kernels, ``csrc/qr_packed.cu`` and ``csrc/blockfp.cu``, on the
  caller's stages) replace their namesakes of the JAX package: the
  Sameh–Kuck wavefront, every pair of a stage rotated at once (their row
  pairs are disjoint), on packed words and on int32 block-FP significands.
  The schedule travels as (S, Pmax) stage tables padded with row ``m``
  (`repro_torch.kernels.ops._stage_tables`).  Bit-identical to
  `qr_packed_wavefront_reference` and `qr_blockfp_wavefront_reference`,
  which equal the flat kernels on the flattened stage schedule.
* `qr_packed_complex_call` and `qr_packed_complex_wavefront_call`
  (``csrc/complex_packed.cu``) replace their namesakes of the JAX package:
  the three-rotation complex Givens QR on (B, m, e, 2) packed (re, im)
  words, in the levelized stages of `flat_stage_table` and in Sameh–Kuck
  stages.  Bit-identical to
  `qr_packed_complex_reference`, the loop of
  `GivensUnit.rotate_rows_complex`, and to
  `qr_packed_complex_wavefront_reference`.
* `qr_packed_lanes_call` and `qr_packed_lanes_wavefront_call`
  (``csrc/packed_lanes.cu``) replace their namesakes of the JAX package:
  the flat and the wavefront packed-word QR on (B, m, e, 2) int32 (hi, lo)
  lane words, the unit's int64 arithmetic done on 32-bit halves.
  Bit-identical to `qr_packed_lanes_reference`, the loop of
  `packed_lanes.LaneUnit.rotate_rows`, and to
  `qr_packed_lanes_wavefront_reference`; through
  `cordic_givens.lanes_to_packed`, to `qr_packed_call` and
  `qr_packed_wavefront_call` on the same words.

Each wrapper dispatches on the operand's device: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain version.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from repro_torch.core import cordic
from repro_torch.core.givens import GivensConfig, GivensUnit
from repro_torch.core.qrd import SCHEDULE_CACHE_SIZE

from . import cordic_givens as cg
from ._launch import check_launch as _check_launch
from ._launch import check_operand as _check_operand
from ._launch import lib as _lib
from ._launch import stream as _stream
from .packed_lanes import LaneUnit

__all__ = ["qr_packed_call", "qr_packed_reference", "QR_PACKED_LAUNCHES",
           "panel_factor_packed_call", "panel_factor_packed_reference",
           "PANEL_FACTOR_LAUNCHES", "panel_apply_packed_call",
           "panel_apply_packed_reference", "PANEL_APPLY_LAUNCHES",
           "qr_blockfp_call", "qr_blockfp_reference", "QR_BLOCKFP_LAUNCHES",
           "panel_factor_blockfp_call", "panel_factor_blockfp_reference",
           "PANEL_FACTOR_BLOCKFP_LAUNCHES", "panel_apply_blockfp_call",
           "panel_apply_blockfp_reference", "PANEL_APPLY_BLOCKFP_LAUNCHES",
           "qr_packed_wavefront_call", "qr_packed_wavefront_reference",
           "QR_PACKED_WAVEFRONT_LAUNCHES", "qr_blockfp_wavefront_call",
           "qr_blockfp_wavefront_reference", "QR_BLOCKFP_WAVEFRONT_LAUNCHES",
           "qr_packed_complex_call", "qr_packed_complex_reference",
           "QR_PACKED_COMPLEX_LAUNCHES", "qr_packed_complex_wavefront_call",
           "qr_packed_complex_wavefront_reference",
           "QR_PACKED_COMPLEX_WAVEFRONT_LAUNCHES", "qr_packed_lanes_call",
           "qr_packed_lanes_reference", "QR_PACKED_LANES_LAUNCHES",
           "qr_packed_lanes_wavefront_call",
           "qr_packed_lanes_wavefront_reference",
           "QR_PACKED_LANES_WAVEFRONT_LAUNCHES", "TABLE_LAYOUTS",
           "TILE_B", "FLAT_THREADS", "FLAT_MAX_THREADS", "PANEL_TILE_B",
           "MAX_SHARED_BYTES", "kernel_params",
           "levelize_steps", "flat_stage_table"]

#: Matrices per CUDA block when the caller gives no ``tile_b``.  For the
#: flat kernels B1 and B2 at (8192, 32, 64) on an H100, tile_b 2 and 4 at
#: 32 threads a matrix read up to 2.3% (B1) and 0.6% (B2) faster than 1;
#: 1 stays, because more than one matrix a block leaves SMs idle for a
#: batch of fewer matrices than tile_b x the SMs (132 at 128 x 128).
TILE_B = 1

#: Threads per matrix of the flat kernels' stage loop at a batch that
#: fills the card, by kernel: of 32 to 256 at tile_b 1, the fastest at the
#: flat route's (8192, 32, 64) on an H100 (`_flat_threads`); the complex
#: kernel's at (8192, 32, 64, 2); B5a's and B5b's (B1's and B2's kernels
#: on the Sameh–Kuck stages) at the wavefront path's (8192, 32, 64).
FLAT_THREADS = {"qr_packed": 128, "qr_blockfp": 32, "qr_packed_complex": 256,
                "qr_packed_wavefront": 128, "qr_blockfp_wavefront": 32}

#: The most threads per matrix `_flat_threads` widens a small batch's
#: blocks to: of 256, 512 and 1024, the fastest for B1 and B2 at
#: (132, 128, 256), one matrix an SM, on an H100.
FLAT_MAX_THREADS = 512

#: Panels per CUDA block of the packed panel factorization when the caller
#: gives no ``tile_b`` (of 1, 2 and 4, the fastest at the TSQR leaves' and
#: tree nodes' panels on an H100).
PANEL_TILE_B = 2

#: Dynamic shared memory one block may use on Hopper (227 KB).  The packed
#: flat, wavefront and complex kernels factorize a block's tiles beyond it
#: in place in device memory, and the panel factorizations their panels
#: (`_panel_tile`); the block-FP flat and wavefront kernel B2 keeps its
#: tiles within it.
MAX_SHARED_BYTES = 232448

#: Launches of each CUDA kernel in this process (comparisons included);
#: callers reset them to 0 to count one run.
QR_PACKED_LAUNCHES = 0
PANEL_FACTOR_LAUNCHES = 0
PANEL_APPLY_LAUNCHES = 0
QR_BLOCKFP_LAUNCHES = 0
PANEL_FACTOR_BLOCKFP_LAUNCHES = 0
PANEL_APPLY_BLOCKFP_LAUNCHES = 0
QR_PACKED_WAVEFRONT_LAUNCHES = 0
QR_BLOCKFP_WAVEFRONT_LAUNCHES = 0
QR_PACKED_COMPLEX_LAUNCHES = 0
QR_PACKED_COMPLEX_WAVEFRONT_LAUNCHES = 0
QR_PACKED_LANES_LAUNCHES = 0
QR_PACKED_LANES_WAVEFRONT_LAUNCHES = 0

#: How the JAX package's wavefront kernels take their stage tables (three
#: operands or one stacked operand).  Both are accepted; on the GPU the
#: three tables always travel as one (3, S, Pmax) tensor, so the layout
#: does not change the words.
TABLE_LAYOUTS = ("split", "stacked")


def qr_packed_reference(P, *, cfg: GivensConfig, steps):
    """Plain PyTorch version of the kernel, on any device.

    P : (B, m, e) int64 packed words.  Returns new (B, m, e) int64 words:
    for each ``(k, j, col)`` step, rows k and j from ``col`` go through
    `GivensUnit.rotate_rows` and the target lead is forced to 0.
    """
    unit = GivensUnit(cfg)
    P = P.clone()
    for (k, j, col) in steps:
        rx, ry = unit.rotate_rows(P[:, k, col:], P[:, j, col:])
        ry[:, 0] = 0                     # structural zero (systolic array)
        P[:, k, col:] = rx
        P[:, j, col:] = ry
    return P


def panel_factor_packed_reference(P, piv, tgt, col, *, cfg: GivensConfig):
    """Plain PyTorch version of the panel factorization, on any device.

    P : (B, mr, pw) int64 packed words; piv, tgt, col : (S,) panel-local
    step tables.  Returns new ``(out, flip, sig)``: for each step the
    lead pair ``(piv, col), (tgt, col)`` goes through `GivensUnit.vector`,
    its control word is replayed with `GivensUnit.rotate` on both rows from
    ``col`` (the lead included) and the target lead is forced to 0;
    ``flip`` and ``sig`` are the (B, S) int64 control words.
    """
    unit = GivensUnit(cfg)
    P = P.clone()
    flips, sigs = [], []
    for k, j, c in zip(*(_host_table(t) for t in (piv, tgt, col))):
        _, _, (flip, sig) = unit.vector(P[:, k, c], P[:, j, c])
        rx, ry = unit.rotate(P[:, k, c:], P[:, j, c:],
                             (flip[:, None], sig[:, None]))
        ry[:, 0] = 0                     # structural zero (systolic array)
        P[:, k, c:] = rx
        P[:, j, c:] = ry
        flips.append(flip)
        sigs.append(sig)
    empty = P.new_zeros((P.shape[0], 0))
    return (P, torch.stack(flips, 1) if flips else empty,
            torch.stack(sigs, 1) if sigs else empty)


def panel_apply_packed_reference(T, piv, tgt, flip, sig, *, cfg: GivensConfig):
    """Plain PyTorch version of the trailing-column replay, on any device.

    T : (B, mr, w) int64 packed words; piv, tgt : (S,) panel-local row
    tables; flip, sig : (B, S) int64 control words.  Returns new (B, mr, w)
    words: each step's control word replayed with `GivensUnit.rotate` on
    whole rows piv and tgt.
    """
    unit = GivensUnit(cfg)
    T = T.clone()
    for s, (k, j) in enumerate(zip(_host_table(piv), _host_table(tgt))):
        rx, ry = unit.rotate(T[:, k], T[:, j],
                             (flip[:, s, None], sig[:, s, None]))
        T[:, k] = rx
        T[:, j] = ry
    return T


def kernel_params(cfg: GivensConfig) -> dict:
    """The unit's scalars as the kernel takes them; the gain constant is
    computed on the host exactly as `cordic.apply_gain` does."""
    cfg.validate()
    fmt = cfg.fmt
    p = cordic.gain_shift(cfg.n + 2)
    return dict(man_bits=fmt.man_bits, exp_bits=fmt.exp_bits, bias=fmt.bias,
                max_exp_raw=fmt.max_exp_raw, N=cfg.n,
                iters=cfg.resolved_iters(), hub=int(cfg.hub),
                rne=int(cfg.input_rounding == "rne"),
                unbiased=int(cfg.unbiased),
                detect_identity=int(cfg.detect_identity),
                comp=cordic.gain_comp_constant(cfg.resolved_iters(), p), p=p)


@lru_cache(maxsize=SCHEDULE_CACHE_SIZE)
def _unit_args(cfg: GivensConfig):
    return tuple(kernel_params(cfg).values())


@lru_cache(maxsize=SCHEDULE_CACHE_SIZE)
def _lane_args(cfg: GivensConfig):
    """`kernel_params` as the lane kernels take them: every scalar a 32-bit
    int, the gain constant split into its (hi, lo) halves."""
    k = kernel_params(cfg)
    comp = k.pop("comp")
    p = k.pop("p")
    return (*k.values(), comp >> 32, comp & 0xFFFFFFFF, p)


def _block_shape(fn: str, tile_b, threads_x: int) -> int:
    """Tiles per block (default `TILE_B`); a block of more than 1024
    threads raises ValueError."""
    tile_b = TILE_B if tile_b is None else int(tile_b)
    if tile_b < 1 or threads_x * tile_b > 1024:
        raise ValueError(f"{fn}: tile_b={tile_b} gives a block of "
                         f"{threads_x} x {tile_b} threads (at most 1024)")
    return tile_b


def _shared_tile_b(tile_b, fn: str, threads_x: int, tile_bytes: int) -> int:
    """Tiles per block of a kernel that keeps them in shared memory (B2,
    and B5b on its kernel): `TILE_B` capped to `MAX_SHARED_BYTES` when the
    caller gives none; a block of more than 1024 threads, or an explicit
    ``tile_b`` whose tiles do not fit, raises ValueError."""
    if tile_b is None:
        tile_b = max(1, min(TILE_B, MAX_SHARED_BYTES // tile_bytes))
    tile_b = _block_shape(fn, tile_b, threads_x)
    if tile_b * tile_bytes > MAX_SHARED_BYTES:
        raise ValueError(f"{fn}: tile_b={tile_b} tiles of {tile_bytes} B need "
                         f"{tile_b * tile_bytes} B of shared memory (at most "
                         f"{MAX_SHARED_BYTES})")
    return tile_b


def _panel_tile(fn: str, tile_b, threads_x: int, mr: int, pw: int, ld: int,
                pairs: int, word_bytes: int):
    """``(tile_b, device_panel)`` of a panel factorization (B3a, B4a) on
    (mr, pw) panels of ``word_bytes`` words at row stride ``ld`` with
    ``pairs`` control words a stage.  The panels and their control words
    go to shared memory when ``tile_b`` of them fit `MAX_SHARED_BYTES`:
    by default `PANEL_TILE_B`, capped to what fits.  Else the kernel works
    on the panels where they lie in device memory, `PANEL_TILE_B` or the
    caller's ``tile_b`` a block, with only the control words in shared
    memory (``device_panel`` True).  A block of more than 1024 threads, or
    a device-memory panel whose rows reach past the kernel's int row
    offsets, raises ValueError."""
    need = (mr * pw + 2 * pairs) * word_bytes
    if tile_b is None:
        tile_b = min(PANEL_TILE_B, MAX_SHARED_BYTES // need) or PANEL_TILE_B
    tile_b = _block_shape(fn, tile_b, threads_x)
    device_panel = tile_b * need > MAX_SHARED_BYTES
    if device_panel and mr * ld >= 2 ** 31:
        raise ValueError(f"{fn}: {mr} rows at row stride {ld} exceed the "
                         f"kernel's int32 row offsets")
    return tile_b, device_panel


def _check_steps(steps, m: int, e: int):
    """Every ``(k, j, col)`` step names two rows of an m x e working tile
    and a column of it; anything else raises ValueError."""
    for (k, j, col) in steps:
        if not (0 <= k < m and 0 <= j < m and k != j and 0 <= col < e):
            raise ValueError(f"schedule step {(k, j, col)} is out of range "
                             f"for a {m} x {e} working tile")


@lru_cache(maxsize=SCHEDULE_CACHE_SIZE)
def _step_table(steps, m: int, e: int, device: str):
    _check_steps(steps, m, e)
    return torch.tensor(steps, dtype=torch.int32,
                        device=device).reshape(len(steps), 3)


def flat_stage_table(steps, m: int, e: int) -> np.ndarray:
    """The (4, S', P) int32 stage table the flat kernels (B1, B2) run a
    step-serial schedule from: `levelize_steps` of ``steps`` on m rows,
    with row 3, the step indices, replaced by each pair's inclusive end
    among the stage's live (pair, column) items.  Pair p of a stage owns
    the items ``end[p] - (e - col[p]) .. end[p] - 1``, the columns
    ``col[p] .. e - 1`` of its two rows; a padded pair (row m) owns none.
    Out-of-range steps raise ValueError."""
    steps = tuple(tuple(int(v) for v in s) for s in steps)
    _check_steps(steps, m, e)
    piv, tgt, col = (tuple(s[i] for s in steps) for i in range(3))
    return _with_item_ends(levelize_steps(piv, tgt, col, m)[:3], m, e)


def _with_item_ends(tab, m: int, e: int) -> np.ndarray:
    """A read-only (4, S, P) int32 copy of the (3, S, P) stage tables
    ``tab`` with row 3 each pair's inclusive end among its stage's live
    (pair, column) items: the cumsum of ``e - col`` over the stage's
    pairs, a padded pair (pivot row m) adding none."""
    item_end = np.cumsum(np.where(tab[0] < m, e - tab[2], 0), axis=1)
    out = np.concatenate([tab, item_end[None]]).astype(np.int32)
    out.setflags(write=False)
    return out


@lru_cache(maxsize=SCHEDULE_CACHE_SIZE)
def _flat_stage_table(steps, m: int, e: int, device: str):
    """`flat_stage_table` as a cached int32 tensor on ``device``, keyed on
    the steps as the caller gives them (a tuple of triples): a call on a
    memoized schedule hashes it, and converts none of its steps."""
    return torch.tensor(flat_stage_table(steps, m, e), device=device)


@lru_cache(maxsize=None)
def _card_threads(device: str) -> int:
    """Threads the card holds at once: SMs x threads an SM."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count * props.max_threads_per_multi_processor


def _flat_threads(kernel: str, pairs: int, e: int, B: int, tile_b,
                  device: str) -> int:
    """Threads per matrix of the flat kernel ``kernel`` ('qr_packed',
    'qr_blockfp', 'qr_packed_complex', or B5a's 'qr_packed_wavefront' and
    B5b's 'qr_blockfp_wavefront'): its
    `FLAT_THREADS`, doubled while the grid's threads
    still fit the card at once (`_card_threads`) — a batch too small to
    fill the card spreads each matrix over more threads rather than leave
    SMs idle — up to `FLAT_MAX_THREADS`, and at most one per (pair, column)
    of the widest stage, in whole warps, and 1024 per block (a ``tile_b``
    beyond 32 then fails `_block_shape`)."""
    tile_b = TILE_B if tile_b is None else max(int(tile_b), 1)
    cap = min(max(-(-pairs * e // 32) * 32, 32), max(1024 // tile_b, 32))
    threads = min(FLAT_THREADS[kernel], cap)
    cap = min(cap, FLAT_MAX_THREADS)
    room = _card_threads(device) if B else 0
    while 2 * threads <= cap and -(-B // tile_b) * tile_b * 2 * threads <= room:
        threads *= 2
    return threads


def _host_table(t) -> tuple:
    """A (S,) step table (numpy array, tensor or sequence) as a tuple of
    ints."""
    if isinstance(t, torch.Tensor):
        t = t.cpu()
    if isinstance(t, (torch.Tensor, np.ndarray)):
        return tuple(t.tolist())
    return tuple(int(v) for v in t)


def _check_panel_steps(rows, cols, mr: int, pw: int):
    """Panel-local step tables in range: rows is a tuple of (S,) row tables,
    cols the column table or None; anything else raises ValueError."""
    S = len(rows[0])
    if any(len(t) != S for t in rows) or (cols is not None and len(cols) != S):
        raise ValueError("panel step tables differ in length")
    for s in range(S):
        k, j = rows[0][s], rows[1][s]
        if not (0 <= k < mr and 0 <= j < mr and k != j) or (
                cols is not None and not 0 <= cols[s] < pw):
            raise ValueError(f"panel step {s} ({k}, {j}) is out of range for "
                             f"a panel of {mr} x {pw}")


def levelize_steps(piv, tgt, col, m: int):
    """Stage tables of a step-serial schedule on ``m`` rows.

    Step ``s`` on rows ``piv[s]`` and ``tgt[s]`` goes to level ``1 +`` the
    larger of the levels of the last earlier steps on those two rows.  The
    steps of one level then touch disjoint rows, and every row meets its
    steps in their original order, so running the levels in turn, the
    pairs of a level at once, gives every word and every control word of
    the step order, bit for bit.  The column-major schedule of an mr x nc
    panel has ``mr + min(mr - 1, nc) - 2`` levels.

    Parameters
    ----------
    piv, tgt : sequences of ints, the (S,) pivot and target rows.
    col : sequence of ints or None, the (S,) lead columns (None: zeros).
    m : int, the rows of the tile; padded pairs name row ``m``.

    Returns
    -------
    A read-only (4, S', P) int32 array: pivot rows, target rows, lead
    columns and each pair's step index, one row per level, the pairs of a
    level in step order, padded to the widest level with pivot = target =
    ``m``, column 0 and step -1 (the layout of `ops._stage_tables`, plus the
    step indices).
    """
    last = {}
    levels = []
    for s, (k, j) in enumerate(zip(piv, tgt)):
        lv = max(last.get(k, 0), last.get(j, 0))
        last[k] = last[j] = lv + 1
        if lv == len(levels):
            levels.append([])
        levels[lv].append(s)
    out = np.zeros((4, len(levels), max(map(len, levels), default=0)),
                   np.int32)
    out[:2] = m
    out[3] = -1
    for lv, steps in enumerate(levels):
        for p, s in enumerate(steps):
            out[:, lv, p] = (piv[s], tgt[s], 0 if col is None else col[s], s)
    out.setflags(write=False)
    return out


@lru_cache(maxsize=SCHEDULE_CACHE_SIZE)
def _panel_levels(rows, mr: int):
    """`levelize_steps` of the validated panel-local row tables ``rows`` (a
    tuple of (S,) tables) on ``mr`` rows, lead columns 0: the stages a
    panel's factor and apply share (the levels depend on the rows only)."""
    _check_panel_steps(rows, None, mr, 0)
    return levelize_steps(*rows, None, mr)


@lru_cache(maxsize=SCHEDULE_CACHE_SIZE)
def _panel_stage_table(rows, cols, mr: int, pw: int, device: str):
    """(4, S', P) int32 device copy of `_panel_levels` with, where ``cols``
    (the (S,) column table, validated against ``pw``) is given, each
    pair's lead column in row 2; None leaves it 0, for the applies."""
    table = _panel_levels(rows, mr)
    if cols is not None:
        _check_panel_steps(rows, cols, mr, pw)
        table = table.copy()
        table[2] = np.where(table[3] >= 0,
                            np.asarray(cols, np.int32)[table[3]], 0)
    return torch.tensor(table, device=device)


def qr_packed_call(P, *, cfg: GivensConfig, steps, tile_b: int | None = None):
    """Blocked QR over packed FP words: one CUDA launch per call.

    Parameters
    ----------
    P : (B, m, e) int64, contiguous
        Packed FP words of the augmented working matrices.  On a CPU tensor
        the plain version runs instead of the kernel.
    cfg : GivensConfig
        Unit configuration (format, N, iters, HUB flags).
    steps : tuple[(int, int, int), ...]
        Rotation schedule ``(pivot_row, target_row, col)``.
    tile_b : int, optional
        Matrices per CUDA block (default `TILE_B`); the last block masks the
        ragged edge, so any B works.

    Returns
    -------
    (B, m, e) int64 — the triangularized packed words.  When the block's
    tiles and control words exceed `MAX_SHARED_BYTES` the kernel works on
    the tiles in place in the output's device memory instead of shared
    memory; the words are the same.

    The kernel runs the steps in the levels of `flat_stage_table` (derived
    on the host and cached): one thread per pair vectors its lead once,
    then the matrix's threads (`_flat_threads`) replay the control words
    over the stage's live (pair, column) items; the words equal the step
    order's.  Out-of-range steps raise ValueError.
    """
    steps = tuple(map(tuple, steps))
    if _check_operand("qr_packed_call", P):
        return qr_packed_reference(P, cfg=cfg, steps=steps)
    B, m, e = P.shape
    table = _flat_stage_table(steps, m, e, str(P.device))
    threads_x = _flat_threads("qr_packed", table.shape[2], e, B, tile_b,
                              str(P.device))
    return _qr_packed_launch(P, table, cfg, tile_b, threads_x)


def _qr_packed_launch(P, table, cfg: GivensConfig, tile_b, threads_x: int,
                      kernel: str = "qr_packed"):
    """B1's kernel on a CUDA tensor: the stages of ``table`` (with each
    pair's item end, `_flat_stage_table`) with ``threads_x`` threads a
    matrix and ``tile_b`` matrices a block.  ``kernel`` is the wrapper the
    launch counts for: 'qr_packed' (B1) or 'qr_packed_wavefront' (B5a, on
    `_wavefront_table`)."""
    fn = f"{kernel}_call"
    if not P.is_contiguous():
        raise ValueError(f"{fn}: expected a contiguous tensor")
    B, m, e = P.shape
    stages, pairs = table.shape[1:]
    tile_b = _block_shape(fn, tile_b, threads_x)
    device_tile = tile_b * (m * e + 2 * pairs) * 8 > MAX_SHARED_BYTES
    out = torch.empty_like(P)
    if B == 0:
        return out
    err = _lib("qr_packed").qr_packed_launch(
        P.data_ptr(), out.data_ptr(), table.data_ptr(), B, m, e, stages,
        pairs, tile_b, threads_x, int(device_tile),
        *_unit_args(cfg), _stream(P))
    _check_launch("qr_packed", err)
    globals()[f"{kernel.upper()}_LAUNCHES"] += 1
    return out


def panel_factor_packed_call(P, piv, tgt, col, *, cfg: GivensConfig,
                             tile_b: int | None = None):
    """Panel factorization over packed FP words, exporting control words;
    one CUDA launch, **in place** on ``P``.

    Parameters
    ----------
    P : (B, mr, pw) int64
        One panel of each working matrix: the ``mr`` not-yet-final rows
        (global rows ``c0..m-1`` for the panel starting at column ``c0``)
        and its ``pw`` columns.  May be a view with any batch and row
        strides (a slice of the (B, m, e) working buffer) but unit column
        stride.  On a CPU tensor the plain version runs instead.
    piv, tgt, col : (S,) int
        Panel-local step tables (`repro_torch.kernels.ops.panel_steps`).
    cfg : GivensConfig
        Unit configuration.
    tile_b : int, optional
        Panels per CUDA block; by default `PANEL_TILE_B`, capped so that
        the block's panels and control words fit in `MAX_SHARED_BYTES` of
        shared memory.  Panels that do not fit (tile_m 4096 at panel_n 8,
        or an explicit ``tile_b`` too large) are factorized in place in
        device memory instead (`_panel_tile`); the words are the same.

    Returns
    -------
    (P, flip, sig) — ``P`` factored in place (upper-triangular head over
    zeros); ``flip``/``sig`` (B, S) int64 in step order, the control words
    replayable over the trailing columns with `panel_apply_packed_call`.

    The kernel runs the steps in stages of disjoint row pairs
    (`levelize_steps`, derived on the host and cached): one thread per
    pair vectors its lead once, the panel's threads replay the control
    word across the pair's rows; the words equal the step order's.
    """
    global PANEL_FACTOR_LAUNCHES
    if _check_operand("panel_factor_packed_call", P):
        out, flip, sig = panel_factor_packed_reference(P, piv, tgt, col,
                                                       cfg=cfg)
        P.copy_(out)
        return P, flip, sig
    B, mr, pw = P.shape
    rows = (_host_table(piv), _host_table(tgt))
    table = _panel_stage_table(rows, _host_table(col), mr, pw, str(P.device))
    S = len(rows[0])
    stages, pairs = table.shape[1:]
    threads_x = _stage_threads(pairs, pw)
    tile_b, device_panel = _panel_tile("panel_factor_packed_call", tile_b,
                                       threads_x, mr, pw, P.stride(1), pairs,
                                       8)
    flip = torch.empty((B, S), dtype=torch.int64, device=P.device)
    sig = torch.empty_like(flip)
    if B == 0 or S == 0:
        return P, flip, sig
    err = _lib("panel_packed").panel_factor_launch(
        P.data_ptr(), P.stride(0), P.stride(1), B, mr, pw, table.data_ptr(),
        stages, pairs, S, flip.data_ptr(), sig.data_ptr(), tile_b, threads_x,
        int(device_panel), *_unit_args(cfg), _stream(P))
    _check_launch("panel_packed", err)
    PANEL_FACTOR_LAUNCHES += 1
    return P, flip, sig


def _apply_cols(fn: str, mr: int, w: int, pairs: int) -> int:
    """Trailing columns per block of the panel apply kernel, whose threads
    are (column, pair slot): one column per lane of a warp, fewer when the
    region is narrower, the block would exceed 1024 threads or its mr rows
    would exceed `MAX_SHARED_BYTES` (at least one column must fit, else
    ValueError)."""
    cols = min(32, w, 1024 // pairs, MAX_SHARED_BYTES // (mr * 8))
    if cols < 1:
        raise ValueError(f"{fn}: {mr} rows and {pairs} pairs a stage do not "
                         f"fit one block ({MAX_SHARED_BYTES} B of shared "
                         f"memory, 1024 threads)")
    return cols


def panel_apply_packed_call(T, piv, tgt, flip, sig, *, cfg: GivensConfig):
    """Replay a panel's control words over the trailing columns; one CUDA
    launch, **in place** on ``T``.

    Parameters
    ----------
    T : (B, mr, w) int64
        The trailing region right of the panel, the same ``mr`` rows.  May
        be a view with any batch and row strides but unit column stride.
        On a CPU tensor the plain version runs instead.
    piv, tgt : (S,) int — panel-local step row tables.
    flip, sig : (B, S) int64 — control words from `panel_factor_packed_call`,
        in step order.

    Returns
    -------
    ``T``, updated in place.  The kernel runs the steps in the stages of
    `levelize_steps`: a CUDA block holds up to 32 trailing columns of one
    matrix in shared memory, its threads spread over (column, pair slot),
    one barrier a stage; the words equal the step order's.
    """
    global PANEL_APPLY_LAUNCHES
    if _check_operand("panel_apply_packed_call", T):
        T.copy_(panel_apply_packed_reference(T, piv, tgt, flip, sig, cfg=cfg))
        return T
    B, mr, w = T.shape
    rows = (_host_table(piv), _host_table(tgt))
    table = _panel_stage_table(rows, None, mr, 0, str(T.device))  # no columns
    S = len(rows[0])
    stages, pairs = table.shape[1:]
    if (flip.shape != (B, S) or sig.shape != (B, S) or flip.device != T.device
            or sig.device != T.device or not flip.is_contiguous()
            or not sig.is_contiguous() or flip.dtype != torch.int64
            or sig.dtype != torch.int64):
        raise ValueError(f"flip and sig must be contiguous ({B}, {S}) int64 "
                         f"tensors on {T.device}")
    if B == 0 or S == 0 or w == 0:
        return T
    cols = _apply_cols("panel_apply_packed_call", mr, w, pairs)
    err = _lib("panel_packed").panel_apply_launch(
        T.data_ptr(), T.stride(0), T.stride(1), B, mr, w, table.data_ptr(),
        stages, pairs, S, flip.data_ptr(), sig.data_ptr(), cols,
        *_unit_args(cfg), _stream(T))
    _check_launch("panel_packed", err)
    PANEL_APPLY_LAUNCHES += 1
    return T


# ---------------------------------------------------------------------------
# int32 block-FP datapath (csrc/blockfp.cu)
# ---------------------------------------------------------------------------
def qr_blockfp_reference(X, *, iters: int, hub: bool, steps):
    """Plain PyTorch version of the flat block-FP kernel, on any device.

    X : (B, m, e) integer significands (int32; int64 runs the same
    arithmetic without wrapping).  Returns new (B, m, e) significands: for
    each ``(k, j, col)`` step, rows k and j from ``col`` go through
    `cordic_givens.fused_rotate_block` and the target lead is forced to 0.
    """
    comp = cg.comp_q30(iters)
    X = X.clone()
    for (k, j, col) in steps:
        rx, ry = cg.fused_rotate_block(X[:, k, col:], X[:, j, col:],
                                       iters=iters, hub=hub, comp=comp)
        ry[:, 0] = 0                     # structural zero (systolic array)
        X[:, k, col:] = rx
        X[:, j, col:] = ry
    return X


def panel_factor_blockfp_reference(X, piv, tgt, col, *, iters: int,
                                   hub: bool):
    """Plain PyTorch version of the block-FP panel factorization.

    X : (B, mr, pw) integer significands; piv, tgt, col : (S,) panel-local
    step tables.  Returns new ``(out, flip, sig)``: for each step the rows
    go through `cordic_givens.fused_rotate_ctrl` at the panel's width with
    the lead selected by a one-hot, the lanes left of the lead are
    restored and the target lead is forced to 0; ``flip`` and ``sig`` are
    the (B, S) control words in X's type.
    """
    comp = cg.comp_q30(iters)
    X = X.clone()
    colid = torch.arange(X.shape[-1], device=X.device)[None]
    flips, sigs = [], []
    for k, j, c in zip(*(_host_table(t) for t in (piv, tgt, col))):
        x, y = X[:, k], X[:, j]
        lead = colid == c
        active = colid >= c
        rx, ry, flip, sig = cg.fused_rotate_ctrl(x, y, lead, iters=iters,
                                                 hub=hub, comp=comp)
        rx = torch.where(active, rx, x)  # untouched left lanes
        ry = torch.where(active, ry, y)
        ry = torch.where(lead, 0, ry)    # structural zero
        X[:, k] = rx
        X[:, j] = ry
        flips.append(flip)
        sigs.append(sig)
    empty = X.new_zeros((X.shape[0], 0))
    return (X, torch.stack(flips, 1) if flips else empty,
            torch.stack(sigs, 1) if sigs else empty)


def panel_apply_blockfp_reference(T, piv, tgt, flip, sig, *, iters: int,
                                  hub: bool):
    """Plain PyTorch version of the block-FP trailing-column replay.

    T : (B, mr, w) integer significands; piv, tgt : (S,) panel-local row
    tables; flip, sig : (B, S) control words.  Returns new (B, mr, w)
    significands: each step's control word replayed with
    `cordic_givens.fused_replay` on whole rows piv and tgt.
    """
    comp = cg.comp_q30(iters)
    T = T.clone()
    for s, (k, j) in enumerate(zip(_host_table(piv), _host_table(tgt))):
        rx, ry = cg.fused_replay(T[:, k], T[:, j], flip[:, s], sig[:, s],
                                 iters=iters, hub=hub, comp=comp)
        T[:, k] = rx
        T[:, j] = ry
    return T


def _blockfp_args(iters: int, hub: bool):
    """(iters, hub, comp) as the block-FP kernels take them."""
    cg._check_iters(iters)
    return int(iters), int(bool(hub)), cg.comp_q30(iters)


def qr_blockfp_call(X, *, iters: int, hub: bool, steps,
                    tile_b: int | None = None):
    """Blocked QR over int32 block-FP significands: one CUDA launch.

    Parameters
    ----------
    X : (B, m, e) int32, contiguous
        Significands with F fraction bits and one shared exponent per
        (matrix, column) (`repro_torch.kernels.ops.givens_block_apply`
        quantizes them).  On a CPU tensor the plain version runs instead.
    iters, hub : CORDIC depth (at most 30) and HUB or conventional
        arithmetic.
    steps : tuple[(int, int, int), ...]
        Rotation schedule ``(pivot_row, target_row, col)``, read by the
        kernel at run time (column-major, `ops.rls_block_steps`, ...).
    tile_b : int, optional
        Matrices per CUDA block (default `TILE_B`, capped to shared
        memory); an explicit one whose tiles exceed `MAX_SHARED_BYTES`
        raises ValueError.  The last block masks the ragged edge.

    Returns
    -------
    (B, m, e) int32 — the triangularized significands (same scales).  The
    kernel runs the steps in stages, as `qr_packed_call` does.
    """
    steps = tuple(map(tuple, steps))
    args = _blockfp_args(iters, hub)
    if _check_operand("qr_blockfp_call", X, dtype=torch.int32):
        return qr_blockfp_reference(X, iters=iters, hub=hub, steps=steps)
    B, m, e = X.shape
    table = _flat_stage_table(steps, m, e, str(X.device))
    threads_x = _flat_threads("qr_blockfp", table.shape[2], e, B, tile_b,
                              str(X.device))
    return _qr_blockfp_launch(X, table, args, tile_b, threads_x)


def _qr_blockfp_launch(X, table, args, tile_b, threads_x: int,
                       kernel: str = "qr_blockfp"):
    """B2's kernel on a CUDA tensor, as `_qr_packed_launch`; ``args`` are
    `_blockfp_args`.  ``kernel`` is the wrapper the launch counts for:
    'qr_blockfp' (B2) or 'qr_blockfp_wavefront' (B5b, on
    `_wavefront_table`).  The tiles stay in shared memory: a ``tile_b``
    whose tiles and control words do not fit raises ValueError."""
    fn = f"{kernel}_call"
    if not X.is_contiguous():
        raise ValueError(f"{fn}: expected a contiguous tensor")
    B, m, e = X.shape
    stages, pairs = table.shape[1:]
    tile_b = _shared_tile_b(tile_b, fn, threads_x, (m * e + 2 * pairs) * 4)
    out = torch.empty_like(X)
    if B == 0:
        return out
    err = _lib("blockfp").qr_blockfp_launch(
        X.data_ptr(), out.data_ptr(), table.data_ptr(), B, m, e, stages,
        pairs, tile_b, threads_x, *args, _stream(X))
    _check_launch("blockfp", err)
    globals()[f"{kernel.upper()}_LAUNCHES"] += 1
    return out


def panel_factor_blockfp_call(X, piv, tgt, col, *, iters: int, hub: bool,
                              tile_b: int | None = None):
    """Panel factorization over int32 block-FP significands, exporting
    control words; one CUDA launch, **in place** on ``X``.

    Parameters as `panel_factor_packed_call` with ``X : (B, mr, pw) int32``
    (a view with any batch and row strides, unit column stride) and the
    datapath's ``iters``/``hub``.  The per-column shared exponents are
    invariant under the whole rotation set, so the panel/trailing split
    needs no re-quantization.

    Returns
    -------
    (X, flip, sig) — ``X`` factored in place; ``flip``/``sig`` (B, S) int32
    control words, in step order, for `panel_apply_blockfp_call`.

    The kernel runs the steps in the stages of `levelize_steps`, as
    `panel_factor_packed_call` does, its panels in shared memory or, when
    they do not fit, in device memory (`_panel_tile`); the words equal the
    step order's.
    """
    global PANEL_FACTOR_BLOCKFP_LAUNCHES
    args = _blockfp_args(iters, hub)
    if _check_operand("panel_factor_blockfp_call", X, dtype=torch.int32):
        out, flip, sig = panel_factor_blockfp_reference(X, piv, tgt, col,
                                                        iters=iters, hub=hub)
        X.copy_(out)
        return X, flip, sig
    B, mr, pw = X.shape
    rows = (_host_table(piv), _host_table(tgt))
    table = _panel_stage_table(rows, _host_table(col), mr, pw, str(X.device))
    S = len(rows[0])
    stages, pairs = table.shape[1:]
    threads_x = _stage_threads(pairs, pw)
    tile_b, device_panel = _panel_tile("panel_factor_blockfp_call", tile_b,
                                       threads_x, mr, pw, X.stride(1), pairs,
                                       4)
    flip = torch.empty((B, S), dtype=torch.int32, device=X.device)
    sig = torch.empty_like(flip)
    if B == 0 or S == 0:
        return X, flip, sig
    err = _lib("blockfp").panel_factor_blockfp_launch(
        X.data_ptr(), X.stride(0), X.stride(1), B, mr, pw, table.data_ptr(),
        stages, pairs, S, flip.data_ptr(), sig.data_ptr(), tile_b, threads_x,
        int(device_panel), *args, _stream(X))
    _check_launch("blockfp", err)
    PANEL_FACTOR_BLOCKFP_LAUNCHES += 1
    return X, flip, sig


def _apply_slot_threads(w: int, pairs: int, B: int, device: str):
    """Threads a column's stage is spread over in the block-FP panel apply
    B4b: 1 where the grid's B x w threads fill an eighth of what the card
    holds (`_card_threads`); a smaller grid doubles them, up to 8 and to
    the stage's pairs, while its threads stay within that eighth."""
    slot_threads = 1
    while (slot_threads < min(pairs, 8)
           and 8 * B * w * slot_threads <= _card_threads(device)):
        slot_threads *= 2
    return slot_threads


def panel_apply_blockfp_call(T, piv, tgt, flip, sig, *, iters: int,
                             hub: bool):
    """Replay a panel's int32 control words over the trailing block-FP
    columns; one CUDA launch, **in place** on ``T``.

    Parameters as `panel_apply_packed_call` with ``T : (B, mr, w) int32``,
    ``flip``/``sig`` (B, S) int32 from `panel_factor_blockfp_call` and the
    datapath's ``iters``/``hub``.

    Returns
    -------
    ``T``, updated in place.  The kernel runs the steps in the stages of
    `levelize_steps` (derived on the host and cached): a CUDA block holds
    up to 256 trailing columns of one matrix in shared memory, and a
    thread replays each stage's live pairs on its column, up to 8 at a time
    (their rows are disjoint), with no barrier; a batch too small to fill
    the card spreads a stage's pairs over up to 8 threads a column, one
    barrier a stage, and one warp of columns a block
    (`_apply_slot_threads`).  The words equal the step order's.
    """
    args = _blockfp_args(iters, hub)
    if _check_operand("panel_apply_blockfp_call", T, dtype=torch.int32):
        T.copy_(panel_apply_blockfp_reference(T, piv, tgt, flip, sig,
                                              iters=iters, hub=hub))
        return T
    B, mr, w = T.shape
    rows = (_host_table(piv), _host_table(tgt))
    table = _panel_stage_table(rows, None, mr, 0, str(T.device))  # no columns
    S = len(rows[0])
    if (flip.shape != (B, S) or sig.shape != (B, S) or flip.device != T.device
            or sig.device != T.device or not flip.is_contiguous()
            or not sig.is_contiguous() or flip.dtype != torch.int32
            or sig.dtype != torch.int32):
        raise ValueError(f"flip and sig must be contiguous ({B}, {S}) int32 "
                         f"tensors on {T.device}")
    if B == 0 or S == 0 or w == 0:
        return T
    slot_threads = _apply_slot_threads(w, table.shape[2], B, str(T.device))
    return _panel_apply_blockfp_launch(T, table, flip, sig, args,
                                       256 if slot_threads == 1 else 32,
                                       slot_threads)


def _panel_apply_blockfp_launch(T, table, flip, sig, args, cols: int,
                                slot_threads: int):
    """B4b on a CUDA tensor, in place: the stages of ``table``
    (`_panel_stage_table`) with the control words ``flip``/``sig`` and the
    datapath's ``args`` (`_blockfp_args`); a block holds at most ``cols``
    trailing columns, balanced over the column blocks in whole warps and
    cut to what fits `MAX_SHARED_BYTES` beside one stage's records, with
    ``slot_threads`` threads a column (cols x slot_threads at most 256,
    the kernel's launch bound).  The stage records go to shared memory in
    windows of the stages that fit beside the columns: all of them at
    once unless the panel is tall or wide.  Returns ``T``."""
    global PANEL_APPLY_BLOCKFP_LAUNCHES
    B, mr, w = T.shape
    stages, pairs = table.shape[1:]
    record = pairs * 8 + 4            # a stage's records and its count
    cols = min(cols, 256 // slot_threads,
               (MAX_SHARED_BYTES - record) // (mr * 4))
    if cols < 1:
        raise ValueError(f"panel_apply_blockfp_call: {mr} rows and a stage "
                         f"of {pairs} pairs do not fit one block "
                         f"({MAX_SHARED_BYTES} B of shared memory)")
    per_block = -(-w // -(-w // cols))
    cols = min(-(-per_block // 32) * 32, cols, w)
    window = min(stages, (MAX_SHARED_BYTES - mr * cols * 4) // record)
    err = _lib("blockfp").panel_apply_blockfp_launch(
        T.data_ptr(), T.stride(0), T.stride(1), B, mr, w, table.data_ptr(),
        stages, pairs, flip.shape[1], flip.data_ptr(), sig.data_ptr(), cols,
        slot_threads, window, *args, _stream(T))
    _check_launch("blockfp", err)
    PANEL_APPLY_BLOCKFP_LAUNCHES += 1
    return T


# ---------------------------------------------------------------------------
# The Sameh–Kuck wavefront (B1's and B2's kernels on the caller's stages)
# and the complex datapath (csrc/complex_packed.cu)
# ---------------------------------------------------------------------------
def _stage_key(piv, tgt, col):
    """Three (S, Pmax) stage tables (numpy arrays, tensors or nested
    sequences) as one hashable key: their shapes and int32 bytes."""
    arrs = [np.ascontiguousarray(t.cpu() if isinstance(t, torch.Tensor) else t,
                                 dtype=np.int32) for t in (piv, tgt, col)]
    return tuple((a.shape, a.tobytes()) for a in arrs)


@lru_cache(maxsize=SCHEDULE_CACHE_SIZE)
def _wavefront_table(key, m: int, e: int, device: str):
    """B5a's and B5b's (4, S, Pmax) int32 table on ``device``: the
    validated stage tables behind `_stage_key` (`_stage_table`) and, as row
    3, each pair's item end (`_with_item_ends`, the rule of
    `flat_stage_table`)."""
    return torch.tensor(_with_item_ends(_stage_table(key, m, e, "cpu").numpy(),
                                        m, e), device=device)


@lru_cache(maxsize=SCHEDULE_CACHE_SIZE)
def _stage_table(key, m: int, e: int, device: str):
    """Validated (3, S, Pmax) int32 copy on ``device`` of the stage tables
    behind `_stage_key`.

    A pair is padding when its pivot is ``m`` (the kernels skip it); every
    other pair must name two rows below ``m`` and a column below ``e``, and
    the rows of a stage must be disjoint: the pairs of a stage run at once,
    so overlapping rows would race.
    """
    piv, tgt, col = (np.frombuffer(raw, np.int32).reshape(shape)
                     for shape, raw in key)
    if not (piv.ndim == 2 and piv.shape == tgt.shape == col.shape):
        raise ValueError(f"stage tables must be three (S, Pmax) tables of one "
                         f"shape, got {[k[0] for k in key]}")
    for s, (ks, js, cs) in enumerate(zip(piv.tolist(), tgt.tolist(),
                                         col.tolist())):
        rows = []
        for k, j, c in zip(ks, js, cs):
            if k == m and j == m:
                continue                          # padded pair
            if not (0 <= k < m and 0 <= j < m and k != j and 0 <= c < e):
                raise ValueError(f"stage {s} pair {(k, j, c)} is out of range "
                                 f"for a {m} x {e} working tile")
            rows += [k, j]
        if len(rows) != len(set(rows)):
            raise ValueError(f"stage {s} rotations touch overlapping rows")
    return torch.tensor(np.stack([piv, tgt, col]), device=device)


def _check_layout(table_layout: str):
    if table_layout not in TABLE_LAYOUTS:
        raise ValueError(f"table_layout must be one of {TABLE_LAYOUTS}, "
                         f"got {table_layout!r}")


def _stage_threads(pairs: int, e: int) -> int:
    """Threads of a row of the stage loop `wf::run_stages`: one per
    (pair, column) of the widest stage in whole warps, at most 256."""
    return min(max(-(-pairs * e // 32) * 32, 32), 256)


def _wavefront_scan(P, piv, tgt, col, stage_fn, pair=None):
    """Plain-PyTorch stage loop of the wavefront kernels.

    For each stage: gather the pivot and target rows of all Pmax pairs
    into (B, Pmax, e[, 2]) tensors, rotate them with ``stage_fn(X, Y,
    lead)`` at uniform width (``lead`` the (Pmax, e) one-hot of each pair's
    lead column), restore the elements left of the lead, force the
    structural zeros and scatter the rows back.  ``pair`` names the
    trailing axis of size 2 of (B, m, e, 2) words: ``'complex'`` (re, im)
    words, whose target lead is zeroed on both lanes and the pivot lead on
    its imaginary lane (the realized pivot is real); ``'lanes'`` (hi, lo)
    halves of one word, whose target lead is zeroed on both lanes only.
    None: (B, m, e) words, the target lead zeroed.  Padded pairs name row
    ``m``: a zero sentinel row appended to the tile, which they read as
    zeros and whose writes are discarded.
    """
    B, m, e = P.shape[:3]
    Pz = torch.cat([P, P.new_zeros((B, 1) + P.shape[2:])], dim=1)
    tabs = [torch.tensor(np.asarray(t), dtype=torch.int64,
                            device=P.device) for t in (piv, tgt, col)]
    colid = torch.arange(e, device=P.device)
    im = torch.arange(2, device=P.device) == 1
    for pv, tg, cl in zip(*tabs):
        X, Y = Pz[:, pv], Pz[:, tg]
        lead = colid[None] == cl[:, None]               # (Pmax, e)
        active = colid[None] >= cl[:, None]
        rx, ry = stage_fn(X, Y, lead)
        lm, am = (lead[..., None], active[..., None]) if pair else (lead, active)
        rx = torch.where(am, rx, X)                    # untouched left lanes
        ry = torch.where(am, ry, Y)
        if pair == "complex":
            rx = torch.where(lm & im, 0, rx)           # realized pivot is real
        ry = torch.where(lm, 0, ry)                    # structural zero
        Pz[:, pv] = rx
        Pz[:, tg] = ry
        Pz[:, m] = 0                                   # the sentinel stays 0
    return Pz[:, :m].contiguous()


def _lead_words(X, lead):
    """The lead word of each pair: (B, Pmax, e) rows, (Pmax, e) one-hot."""
    return torch.sum(X * lead.to(X.dtype), dim=-1, dtype=X.dtype)


def qr_packed_wavefront_reference(P, piv, tgt, col, *, cfg: GivensConfig):
    """Plain PyTorch version of the packed wavefront kernel, on any device.

    P : (B, m, e) int64 packed words; piv, tgt, col : (S, Pmax) stage
    tables.  Each stage: `GivensUnit.vector` on every pair's lead, its
    control word replayed with `GivensUnit.rotate` across both rows.
    Equal to `qr_packed_reference` on the flattened stage schedule.
    """
    unit = GivensUnit(cfg)

    def stage(X, Y, lead):
        _, _, (flip, sig) = unit.vector(_lead_words(X, lead),
                                        _lead_words(Y, lead))
        return unit.rotate(X, Y, (flip[..., None], sig[..., None]))
    return _wavefront_scan(P, piv, tgt, col, stage)


def qr_blockfp_wavefront_reference(X, piv, tgt, col, *, iters: int,
                                   hub: bool):
    """Plain PyTorch version of the block-FP wavefront kernel, on any
    device: each stage through `cordic_givens.fused_rotate_pairs`.  Equal to
    `qr_blockfp_reference` on the flattened stage schedule."""
    comp = cg.comp_q30(iters)

    def stage(x, y, lead):
        return cg.fused_rotate_pairs(x, y, lead, iters=iters, hub=hub,
                                     comp=comp)
    return _wavefront_scan(X, piv, tgt, col, stage)


def qr_packed_complex_reference(P, *, cfg: GivensConfig, steps):
    """Plain PyTorch version of the complex kernel, on any device.

    P : (B, m, e, 2) int64 packed (re, im) words.  For each ``(k, j, col)``
    step, rows k and j from ``col`` go through
    `GivensUnit.rotate_rows_complex` (structural zeros included).
    """
    unit = GivensUnit(cfg)
    P = P.clone()
    for (k, j, col) in steps:
        rx, ry = unit.rotate_rows_complex(P[:, k, col:], P[:, j, col:])
        P[:, k, col:] = rx
        P[:, j, col:] = ry
    return P


def qr_packed_complex_wavefront_reference(P, piv, tgt, col, *,
                                          cfg: GivensConfig):
    """Plain PyTorch version of the complex wavefront kernel, on any device.

    Each stage: phase vectoring on every pair's lead (re, im) words, the
    phase words replayed across both rows, the realized leads read back
    from the phase-rotated real lanes, and the real Givens on them replayed
    across the re and the im lanes.  Equal to `qr_packed_complex_reference`
    on the flattened stage schedule.
    """
    unit = GivensUnit(cfg)

    def stage(X, Y, lead):
        xr, xi, yr, yi = X[..., 0], X[..., 1], Y[..., 0], Y[..., 1]
        _, (fx, sx), skx = unit.phase_vector(_lead_words(xr, lead),
                                             _lead_words(xi, lead))
        _, (fy, sy), sky = unit.phase_vector(_lead_words(yr, lead),
                                             _lead_words(yi, lead))
        pxr, pxi = unit.phase_rotate(xr, xi, (fx[..., None], sx[..., None]),
                                     skx[..., None])
        pyr, pyi = unit.phase_rotate(yr, yi, (fy[..., None], sy[..., None]),
                                     sky[..., None])
        _, _, (flip, sig) = unit.vector(_lead_words(pxr, lead),
                                        _lead_words(pyr, lead))
        st = (flip[..., None], sig[..., None])
        rxr, ryr = unit.rotate(pxr, pyr, st)
        rxi, ryi = unit.rotate(pxi, pyi, st)
        return torch.stack([rxr, rxi], -1), torch.stack([ryr, ryi], -1)
    return _wavefront_scan(P, piv, tgt, col, stage, pair="complex")


def _packed_launch(fn: str, lib: str, P, table, sizes, pairs: int,
                   threads_x: int, ctrl_words: int, tile_b, unit_args):
    """Launch the stage-loop kernel behind ``fn`` on P's (B, m, e[, 2])
    packed tiles; ``sizes`` are the launch's table sizes after (B, m, e),
    ``unit_args`` the unit's scalars (`_unit_args`, `_lane_args`).  The
    tiles live in shared memory when a block's tiles and per-pair control
    words (``ctrl_words`` of 8 bytes per pair) fit `MAX_SHARED_BYTES`, else
    in place in the output's device memory.  Returns the output."""
    if not P.is_contiguous():
        raise ValueError(f"{fn}: expected a contiguous tensor")
    B, m, e = P.shape[:3]
    tile_b = _block_shape(fn, tile_b, threads_x)
    tile_bytes = P[0].numel() * P.element_size() if B else 0
    device_tile = (tile_b * (tile_bytes + pairs * ctrl_words * 8)
                   > MAX_SHARED_BYTES)
    out = torch.empty_like(P)
    if B == 0:
        return out
    launch = getattr(_lib(lib), fn.removesuffix("_call") + "_launch")
    err = launch(P.data_ptr(), out.data_ptr(), table.data_ptr(), B, m, e,
                 *sizes, tile_b, threads_x, int(device_tile), *unit_args,
                 _stream(P))
    _check_launch(lib, err)
    return out


def qr_packed_wavefront_call(P, piv, tgt, col, *, cfg: GivensConfig,
                             tile_b: int | None = None,
                             table_layout: str = "split"):
    """Wavefront QR over packed FP words: one CUDA launch per call.

    Parameters
    ----------
    P : (B, m, e) int64, contiguous
        Packed FP words of the augmented working matrices.  On a CPU tensor
        the plain version runs instead of the kernel.
    piv, tgt, col : (S, Pmax) int
        Stage tables, one row per Sameh–Kuck stage, padded with ``piv =
        tgt = m`` (`repro_torch.kernels.ops._stage_tables`).
    cfg : GivensConfig — unit configuration.
    tile_b : int, optional — matrices per CUDA block (default `TILE_B`).
    table_layout : 'split' | 'stacked' — accepted for the JAX package's
        signature; the words do not depend on it.

    Returns
    -------
    (B, m, e) int64 — the triangularized words, bit-identical to
    `qr_packed_call` on the flattened stage schedule.  A block's tiles
    beyond `MAX_SHARED_BYTES` are factorized in place in device memory.

    The kernel is B1's (``csrc/qr_packed.cu``) on the caller's stages with
    each pair's item end (`_wavefront_table`, cached): one thread per pair
    vectors its lead once, then the matrix's threads (`_flat_threads`)
    replay the control words over the stage's live (pair, column) items.
    """
    _check_layout(table_layout)
    if _check_operand("qr_packed_wavefront_call", P):
        return qr_packed_wavefront_reference(P, piv, tgt, col, cfg=cfg)
    B, m, e = P.shape
    table = _wavefront_table(_stage_key(piv, tgt, col), m, e, str(P.device))
    threads_x = _flat_threads("qr_packed_wavefront", table.shape[2], e, B,
                              tile_b, str(P.device))
    return _qr_packed_launch(P, table, cfg, tile_b, threads_x,
                             "qr_packed_wavefront")


def qr_blockfp_wavefront_call(X, piv, tgt, col, *, iters: int, hub: bool,
                              tile_b: int | None = None,
                              table_layout: str = "split"):
    """Wavefront QR over int32 block-FP significands: one CUDA launch.

    Parameters as `qr_blockfp_call`, with the step schedule replaced by the
    (S, Pmax) stage tables of `qr_packed_wavefront_call`.  The tiles stay
    in shared memory (the largest, 128 x 256 int32, is 128 KiB); an
    explicit ``tile_b`` whose tiles do not fit raises ValueError.

    Returns
    -------
    (B, m, e) int32 — bit-identical to `qr_blockfp_call` on the flattened
    stage schedule.

    The kernel is B2's (``csrc/blockfp.cu``) on the caller's stages with
    each pair's item end (`_wavefront_table`, cached), as
    `qr_packed_wavefront_call` runs B1's.
    """
    _check_layout(table_layout)
    args = _blockfp_args(iters, hub)
    if _check_operand("qr_blockfp_wavefront_call", X, dtype=torch.int32):
        return qr_blockfp_wavefront_reference(X, piv, tgt, col, iters=iters,
                                              hub=hub)
    B, m, e = X.shape
    table = _wavefront_table(_stage_key(piv, tgt, col), m, e, str(X.device))
    threads_x = _flat_threads("qr_blockfp_wavefront", table.shape[2], e, B,
                              tile_b, str(X.device))
    return _qr_blockfp_launch(X, table, args, tile_b, threads_x,
                              "qr_blockfp_wavefront")


def _check_pairs(fn: str, P, pair: str = "(re, im)",
                 dtype=torch.int64) -> bool:
    """`_check_operand` for (B, m, e, 2) words, the trailing axis the
    ``pair`` of each element, whose shape is checked on any device."""
    if P.dim() != 4 or P.shape[-1] != 2:
        raise ValueError(f"{fn}: expected (B, m, e, 2) {pair} words, got "
                         f"{tuple(P.shape)}")
    return _check_operand(fn, P, ndim=4, dtype=dtype)


def qr_packed_complex_call(P, *, cfg: GivensConfig, steps,
                           tile_b: int | None = None):
    """Complex QR over packed (re, im) words: one CUDA launch per call.

    Parameters
    ----------
    P : (B, m, e, 2) int64, contiguous
        Packed words of the augmented complex working matrices, the
        trailing axis the (re, im) lanes.  On a CPU tensor the plain
        version runs instead of the kernel.
    cfg : GivensConfig — unit configuration.
    steps : tuple[(int, int, int), ...] — ``(pivot_row, target_row, col)``.
    tile_b : int, optional — matrices per CUDA block (default `TILE_B`).

    Returns
    -------
    (B, m, e, 2) int64 — bit-identical to `qr_packed_complex_reference`.
    A block's tiles beyond `MAX_SHARED_BYTES` are factorized in place in
    device memory.

    The kernel runs the steps in the levels of `flat_stage_table` with the
    matrix's threads (`_flat_threads`) over the stage's live (pair,
    column) items, as `qr_packed_call` does; the words equal the step
    order's.  Out-of-range steps raise ValueError.
    """
    steps = tuple(map(tuple, steps))
    if _check_pairs("qr_packed_complex_call", P):
        return qr_packed_complex_reference(P, cfg=cfg, steps=steps)
    B, m, e, _ = P.shape
    table = _flat_stage_table(steps, m, e, str(P.device))
    threads_x = _flat_threads("qr_packed_complex", table.shape[2], e, B,
                              tile_b, str(P.device))
    return _qr_packed_complex_launch(P, table, cfg, tile_b, threads_x)


def _qr_packed_complex_launch(P, table, cfg: GivensConfig, tile_b,
                              threads_x: int):
    """B7a on a CUDA tensor: the stages of ``table`` (`_flat_stage_table`)
    with ``threads_x`` threads a matrix and ``tile_b`` matrices a block."""
    global QR_PACKED_COMPLEX_LAUNCHES
    pairs = table.shape[2]
    out = _packed_launch("qr_packed_complex_call", "complex_packed", P, table,
                         table.shape[1:], pairs, threads_x, 8, tile_b,
                         _unit_args(cfg))
    QR_PACKED_COMPLEX_LAUNCHES += int(P.shape[0] > 0)
    return out


def qr_packed_complex_wavefront_call(P, piv, tgt, col, *, cfg: GivensConfig,
                                     tile_b: int | None = None,
                                     table_layout: str = "split"):
    """Complex wavefront QR over packed (re, im) words: one CUDA launch.

    Parameters as `qr_packed_wavefront_call` with the (B, m, e, 2) operand
    of `qr_packed_complex_call`.

    Returns
    -------
    (B, m, e, 2) int64 — bit-identical to `qr_packed_complex_call` on the
    flattened stage schedule.
    """
    global QR_PACKED_COMPLEX_WAVEFRONT_LAUNCHES
    _check_layout(table_layout)
    if _check_pairs("qr_packed_complex_wavefront_call", P):
        return qr_packed_complex_wavefront_reference(P, piv, tgt, col,
                                                     cfg=cfg)
    B, m, e, _ = P.shape
    table = _stage_table(_stage_key(piv, tgt, col), m, e, str(P.device))
    S, pairs = table.shape[1:]
    out = _packed_launch("qr_packed_complex_wavefront_call", "complex_packed",
                         P, table, (S, pairs), pairs,
                         _stage_threads(pairs, e), 8, tile_b,
                         _unit_args(cfg))
    QR_PACKED_COMPLEX_WAVEFRONT_LAUNCHES += int(B > 0)
    return out


# ---------------------------------------------------------------------------
# The packed words on dual int32 lanes (csrc/packed_lanes.cu)
# ---------------------------------------------------------------------------
def qr_packed_lanes_reference(P, *, cfg: GivensConfig, steps):
    """Plain PyTorch version of the lane kernel, on any device.

    P : (B, m, e, 2) int32 (hi, lo) lane words.  Returns new lane words:
    for each ``(k, j, col)`` step, rows k and j from ``col`` go through
    `packed_lanes.LaneUnit.rotate_rows` and the target lead is forced to 0
    on both lanes.
    """
    unit = LaneUnit(cfg)
    P = P.clone()
    for (k, j, col) in steps:
        rx, ry = unit.rotate_rows(P[:, k, col:], P[:, j, col:])
        ry[:, 0] = 0                     # structural zero (both lanes)
        P[:, k, col:] = rx
        P[:, j, col:] = ry
    return P


def qr_packed_lanes_wavefront_reference(P, piv, tgt, col, *,
                                        cfg: GivensConfig):
    """Plain PyTorch version of the lane wavefront kernel, on any device.

    P : (B, m, e, 2) int32 lane words; piv, tgt, col : (S, Pmax) stage
    tables.  Each stage: `LaneUnit.vector` on every pair's lead, its
    control word replayed with `LaneUnit.rotate` across both rows, the
    target lead forced to 0 on both lanes.  Equal to
    `qr_packed_lanes_reference` on the flattened stage schedule.
    """
    unit = LaneUnit(cfg)

    def stage(X, Y, lead):
        sel = lead[..., None].to(X.dtype)              # (Pmax, e, 1)
        xl = torch.sum(X * sel, dim=-2, dtype=X.dtype)  # (B, Pmax, 2)
        yl = torch.sum(Y * sel, dim=-2, dtype=Y.dtype)
        _, _, (flip, sig) = unit.vector(xl, yl)
        return unit.rotate(X, Y, (flip[..., None], sig[..., None, :]))
    return _wavefront_scan(P, piv, tgt, col, stage, pair="lanes")


def qr_packed_lanes_call(P, *, cfg: GivensConfig, steps,
                         tile_b: int | None = None):
    """Blocked QR over dual-int32 packed lane words: one CUDA launch.

    Parameters
    ----------
    P : (B, m, e, 2) int32, contiguous
        The (hi, lo) halves of packed FP words
        (`cordic_givens.packed_to_lanes`).  On a CPU tensor the plain
        version runs instead of the kernel.
    cfg : GivensConfig — unit configuration.
    steps : tuple[(int, int, int), ...] — ``(pivot_row, target_row, col)``.
    tile_b : int, optional — matrices per CUDA block (default `TILE_B`).

    Returns
    -------
    (B, m, e, 2) int32 — ``lanes_to_packed(out) == qr_packed_call(packed)``
    bit for bit.  A block's tiles beyond `MAX_SHARED_BYTES` are factorized
    in place in device memory.
    """
    global QR_PACKED_LANES_LAUNCHES
    steps = tuple(tuple(int(v) for v in s) for s in steps)
    if _check_pairs("qr_packed_lanes_call", P, "(hi, lo) lane", torch.int32):
        return qr_packed_lanes_reference(P, cfg=cfg, steps=steps)
    B, m, e, _ = P.shape
    table = _step_table(steps, m, e, str(P.device))
    out = _packed_launch("qr_packed_lanes_call", "packed_lanes", P, table,
                         (len(steps),), 1, _stage_threads(1, e), 2, tile_b,
                         _lane_args(cfg))
    QR_PACKED_LANES_LAUNCHES += int(B > 0)
    return out


def qr_packed_lanes_wavefront_call(P, piv, tgt, col, *, cfg: GivensConfig,
                                   tile_b: int | None = None,
                                   table_layout: str = "split"):
    """Wavefront QR over dual-int32 packed lane words: one CUDA launch.

    Parameters as `qr_packed_wavefront_call` with the (B, m, e, 2) int32
    operand of `qr_packed_lanes_call`.

    Returns
    -------
    (B, m, e, 2) int32 — bit-identical to `qr_packed_lanes_call` on the
    flattened stage schedule, and through `lanes_to_packed` to
    `qr_packed_wavefront_call`.
    """
    global QR_PACKED_LANES_WAVEFRONT_LAUNCHES
    _check_layout(table_layout)
    if _check_pairs("qr_packed_lanes_wavefront_call", P, "(hi, lo) lane",
                    torch.int32):
        return qr_packed_lanes_wavefront_reference(P, piv, tgt, col, cfg=cfg)
    B, m, e, _ = P.shape
    table = _stage_table(_stage_key(piv, tgt, col), m, e, str(P.device))
    S, pairs = table.shape[1:]
    out = _packed_launch("qr_packed_lanes_wavefront_call", "packed_lanes", P,
                         table, (S, pairs), pairs, _stage_threads(pairs, e),
                         2, tile_b, _lane_args(cfg))
    QR_PACKED_LANES_WAVEFRONT_LAUNCHES += int(B > 0)
    return out
