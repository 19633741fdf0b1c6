"""HUB (Half-Unit-Biased) numerics as a standalone primitive (torch port of
`repro.core.hub`).

HUB rounding as a cheap round-to-nearest cast for float tensors: truncate
the mantissa to m bits, and the implicit half-ULP makes the represented
value the round-to-nearest of every real in the bin.  The worst-case error
equals RNE's, with no sticky or round-up logic.

`hub_quantize(x, man_bits)` returns the float value *represented by* the
HUB word (truncated mantissa + half ULP), so downstream float math sees
exactly what a HUB unit would compute.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["hub_quantize", "hub_error_bound"]

#: The smallest normal float64 and float32.  The JAX package computes on
#: XLA's CPU, which reads subnormal float64 operands as zero (so it
#: quantizes them to +0) and flushes subnormal results of its float64 to
#: float32 conversion to a zero of their sign; its float16 conversion keeps
#: them.
_TINY = float(np.finfo(np.float64).tiny)
_TINY32 = float(np.finfo(np.float32).tiny)


def _result_dtype(x):
    """The dtype `jnp.result_type(x)` gives: the tensor's or array's own,
    float64 for a Python float, int64 for a Python int."""
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.as_tensor(np.asarray(x)).dtype


def hub_quantize(x, man_bits: int):
    """Round a float tensor to an m-bit-mantissa HUB value (value-level
    emulation), computed in float64 for exactness.

    Parameters
    ----------
    x : tensor, array_like or scalar.
    man_bits : int — mantissa bits m of the HUB format.

    Returns
    -------
    A tensor of ``x``'s dtype (float64 for a Python float), bit-equal to
    `repro.core.hub.hub_quantize`: zero and subnormal float64 inputs give
    +0 and subnormal float32 results a signed zero, as on XLA's CPU, and
    ``sig * 2**e`` is formed as ``jnp.ldexp`` forms it, with the exponent
    split so the largest finite doubles do not overflow early.
    """
    out_dtype = _result_dtype(x)
    xd = torch.as_tensor(x).to(torch.float64)
    sign = torch.sign(xd)
    ax = xd.abs()
    is_zero = ax < _TINY
    f, e = torch.frexp(torch.where(is_zero, 1.0, ax))  # f in [0.5, 1)
    scale = float(1 << (man_bits + 1))
    # truncate to man_bits fractional bits of the [1, 2) significand, + ILSB
    sig = (torch.floor(f * scale) + 0.5) / scale      # in [0.5, 1]
    # jnp.ldexp(sig, e): frexp(sig) is (sig, 0) here (sig == 1.0 only for
    # man_bits >= 52, where it is (0.5, 1)); a positive exponent lends one
    # to the mantissa so that 2**e stays finite
    fs, es = torch.frexp(sig)
    ee = (es + e).to(torch.float64)
    fs = torch.where(ee > 0, fs * 2, fs)
    ee = torch.where(ee > 0, ee - 1, ee)
    out = sign * (fs * torch.pow(2.0, ee))
    out = torch.where(is_zero, 0.0, out).to(out_dtype)
    if out_dtype == torch.float32:
        out = torch.where(out.abs() < _TINY32, out * 0.0, out)
    return out


def hub_error_bound(man_bits: int) -> float:
    """Worst-case relative rounding error (same bound as RNE): 2^-(m+1)."""
    return 2.0 ** -(man_bits + 1)
