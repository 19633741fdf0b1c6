"""Kernel-resident blocked QR over packed FP words: the CUDA kernel
``csrc/qr_packed.cu``, its launch wrapper and its plain PyTorch version.

Replaces `repro.kernels.qrd_blocked.qr_packed_call` / `_qr_packed_kernel`:
the whole (batched) m x e working tile stays on-chip while every schedule
step runs the unit's full dataflow on it, and the result is written back
once.  The output is bit-identical to `qr_packed_reference`, the loop of
`GivensUnit.rotate_rows` over the steps.

`qr_packed_call` dispatches on the operand's device: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs `qr_packed_reference`.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.core import cordic
from repro_torch.core.givens import GivensConfig, GivensUnit

from . import _build

__all__ = ["qr_packed_call", "qr_packed_reference", "QR_PACKED_LAUNCHES",
           "TILE_B", "MAX_SHARED_BYTES", "kernel_params"]

#: Matrices per CUDA block when the caller gives no ``tile_b``.
TILE_B = 1

#: Dynamic shared memory one block may use on Hopper (227 KB).
MAX_SHARED_BYTES = 232448

#: Launches of the CUDA kernel in this process (comparisons included);
#: callers reset it to 0 to count one run.
QR_PACKED_LAUNCHES = 0

_SCHEDULE_CACHE_SIZE = 128


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


_C_INT, _C_LL, _C_PTR = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


@lru_cache(maxsize=1)
def _lib():
    lib = _build.load("qr_packed")
    lib.qr_packed_launch.argtypes = (
        [_C_PTR, _C_PTR, _C_PTR] + [_C_INT] * 8 + [_C_LL, _C_LL]
        + [_C_INT] * 6 + [_C_LL, _C_INT, _C_PTR])
    lib.qr_packed_launch.restype = _C_INT
    lib.qr_packed_error_string.argtypes = [_C_INT]
    lib.qr_packed_error_string.restype = ctypes.c_char_p
    return lib


@lru_cache(maxsize=_SCHEDULE_CACHE_SIZE)
def _step_table(steps, m: int, e: int, device: str):
    for (k, j, col) in steps:
        if not (0 <= k < m and 0 <= j < m and k != j and 0 <= col < e):
            raise ValueError(f"schedule step {(k, j, col)} is out of range "
                             f"for a {m} x {e} working tile")
    return torch.tensor(steps, dtype=torch.int32,
                        device=device).reshape(len(steps), 3)


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
    (B, m, e) int64 — the triangularized packed words.
    """
    global QR_PACKED_LAUNCHES
    steps = tuple(tuple(int(v) for v in s) for s in steps)
    if P.device.type == "cpu":
        return qr_packed_reference(P, cfg=cfg, steps=steps)
    if P.device.type != "cuda":
        raise ValueError(f"qr_packed_call runs on CUDA or CPU tensors, got "
                         f"{P.device}")
    if P.dtype != torch.int64 or P.dim() != 3 or not P.is_contiguous():
        raise ValueError(f"expected a contiguous (B, m, e) int64 tensor, got "
                         f"{P.dtype} {tuple(P.shape)}")
    tile_b = TILE_B if tile_b is None else int(tile_b)
    B, m, e = P.shape
    threads_x = min(max(32, -(-e // 32) * 32), 256)
    if tile_b < 1 or threads_x * tile_b > 1024:
        raise ValueError(f"tile_b={tile_b} gives a block of {threads_x} x "
                         f"{tile_b} threads (at most 1024)")
    smem = tile_b * m * e * 8
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"working tile {tile_b} x {m} x {e} int64 needs "
                         f"{smem} bytes of shared memory; a block has "
                         f"{MAX_SHARED_BYTES}")
    out = torch.empty_like(P)
    if B == 0:
        return out
    table = _step_table(steps, m, e, str(P.device))
    kp = kernel_params(cfg)
    lib = _lib()
    stream = torch.cuda.current_stream(P.device).cuda_stream
    err = lib.qr_packed_launch(
        P.data_ptr(), out.data_ptr(), table.data_ptr(), B, m, e, len(steps),
        tile_b, threads_x, kp["man_bits"], kp["exp_bits"], kp["bias"],
        kp["max_exp_raw"], kp["N"], kp["iters"], kp["hub"], kp["rne"],
        kp["unbiased"], kp["detect_identity"], kp["comp"], kp["p"], stream)
    if err != 0:
        raise RuntimeError(f"qr_packed kernel launch failed: CUDA error {err} "
                           f"({lib.qr_packed_error_string(err).decode()})")
    QR_PACKED_LAUNCHES += 1
    return out
