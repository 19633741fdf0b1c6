"""Launch plumbing shared by the CUDA kernel wrappers (`qrd_blocked`,
`cordic_givens`): the C signatures of every launch function, the ctypes
handle of each built source, the stream and error checks, the operand
check that sends a CPU tensor to the plain version, and the default
device of the entry points.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build

__all__ = ["SIGNATURES", "lib", "stream", "check_launch", "check_operand",
           "resolve_device"]

C_INT, C_LL, C_PTR = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p

#: ctypes types of `qrd_blocked.kernel_params`, in the order every packed
#: launch takes them, followed by the stream.
UNIT_ARGTYPES = [C_INT] * 2 + [C_LL] * 2 + [C_INT] * 6 + [C_LL, C_INT, C_PTR]

#: ctypes types of `qrd_blocked._lane_args` (every scalar 32-bit, the gain
#: constant's two halves unsigned), followed by the stream.
LANE_ARGTYPES = [C_INT] * 10 + [ctypes.c_uint] * 2 + [C_INT, C_PTR]

#: The launch functions of each source: their C argument types.
SIGNATURES = {
    # (in, out, stage table, B, m, e, stages, pairs, tile_b, threads_x,
    #  device_tile, ...)
    "qr_packed_launch": [C_PTR] * 3 + [C_INT] * 8 + UNIT_ARGTYPES,
    # (P, sb, ld, B, mr, pw | w, stage table, stages, pairs, S, flip, sig,
    #  then the factor's tile_b, threads_x, device_panel | the apply's cols,
    #  ...)
    "panel_factor_launch": ([C_PTR, C_LL, C_LL] + [C_INT] * 3 + [C_PTR]
                            + [C_INT] * 3 + [C_PTR] * 2 + [C_INT] * 3
                            + UNIT_ARGTYPES),
    "panel_apply_launch": ([C_PTR, C_LL, C_LL] + [C_INT] * 3 + [C_PTR]
                           + [C_INT] * 3 + [C_PTR] * 2 + [C_INT]
                           + UNIT_ARGTYPES),
    # block-FP launches end in (iters, hub, comp, stream)
    "qr_blockfp_launch": [C_PTR] * 3 + [C_INT] * 10 + [C_PTR],
    # (P, sb, ld, B, mr, pw, stage table, stages, pairs, S, flip, sig,
    #  tile_b, threads_x, device_panel, ...)
    "panel_factor_blockfp_launch": ([C_PTR, C_LL, C_LL] + [C_INT] * 3
                                    + [C_PTR] + [C_INT] * 3 + [C_PTR] * 2
                                    + [C_INT] * 6 + [C_PTR]),
    # (P, sb, ld, B, mr, w, stage table, stages, pairs, S, flip, sig, cols,
    #  slot threads, window, ...)
    "panel_apply_blockfp_launch": ([C_PTR, C_LL, C_LL] + [C_INT] * 3
                                   + [C_PTR] + [C_INT] * 3 + [C_PTR] * 2
                                   + [C_INT] * 6 + [C_PTR]),
    # (in, out, stage table, B, m, e, S, P, tile_b, threads_x, device_tile)
    "qr_packed_complex_launch": [C_PTR] * 3 + [C_INT] * 8 + UNIT_ARGTYPES,
    "qr_packed_complex_wavefront_launch": ([C_PTR] * 3 + [C_INT] * 8
                                           + UNIT_ARGTYPES),
    # the lanes: (in, out, steps | stage table, B, m, e, S[, P], tile_b,
    #  threads_x, device_tile, ...)
    "qr_packed_lanes_launch": [C_PTR] * 3 + [C_INT] * 7 + LANE_ARGTYPES,
    "qr_packed_lanes_wavefront_launch": ([C_PTR] * 3 + [C_INT] * 8
                                         + LANE_ARGTYPES),
    # the rotator: (x, y, xo, yo, four row strides, ...)
    "vectoring_launch": ([C_PTR] * 4 + [C_LL] * 4 + [C_PTR] * 2 + [C_INT] * 4
                         + [C_PTR]),
    # (..., flip, sig, B, L, head, threads a row, vec, iters, hub, comp)
    "rotation_launch": ([C_PTR] * 4 + [C_LL] * 4 + [C_PTR] * 2 + [C_INT] * 8
                        + [C_PTR]),
    # (..., B, L, threads a row, columns a thread, vec, iters, hub, comp)
    "fused_launch": [C_PTR] * 4 + [C_LL] * 4 + [C_INT] * 8 + [C_PTR],
}


@lru_cache(maxsize=None)
def lib(name: str):
    """The ctypes handle of ``csrc/<name>.cu`` with its launch signatures."""
    handle = _build.load(name)
    for fn, argtypes in SIGNATURES.items():
        if hasattr(handle, fn):
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = C_INT
    err_string = getattr(handle, f"{name}_error_string")
    err_string.argtypes = [C_INT]
    err_string.restype = ctypes.c_char_p
    return handle


def stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, err: int):
    if err != 0:
        msg = getattr(lib(name), f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")


def check_operand(fn: str, *ts, ndim: int = 3, dtype=torch.int64):
    """True when the operands lie on the CPU (run the plain version).
    Otherwise they must be CUDA tensors on one device, of ``dtype``,
    ``ndim`` dims and one shape, with unit stride along the last axis when
    they have more than one axis and are not empty; anything else raises
    ValueError."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{fn}: operands on different devices "
                         f"{[str(t.device) for t in ts]}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{fn} runs on CUDA or CPU tensors, got {dev}")
    for t in ts:
        if (t.dtype != dtype or t.dim() != ndim or t.shape != ts[0].shape
                or (ndim > 1 and t.numel() and t.stride(-1) != 1)):
            raise ValueError(
                f"{fn}: expected {ndim}-d {dtype} tensors of shape "
                f"{tuple(ts[0].shape)}"
                + (" with unit column stride" if ndim > 1 else "")
                + f", got {t.dtype} {tuple(t.shape)} strides {t.stride()}")
    return False


def resolve_device(device=None) -> torch.device:
    """``None`` -> the GPU, which must exist; anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port runs on the GPU by default and no CUDA device is "
                "available; pass device='cpu' to run the kernels' plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
