"""Problem-level least squares on the QRD engines (torch port of
`repro.qrd.solve`).

For ``min_x ||A x - b||`` the engine triangularizes the augmented matrix
``[A | b]``: the rotations that reduce A to R land ``Qᵀ b`` in the appended
columns, so a ``compute_q=False`` decomposition plus a triangular
back-substitution yields x without forming Q.  The substitution is plain
PyTorch, as the JAX version runs outside any kernel.
"""
from __future__ import annotations

import torch

__all__ = ["back_substitute", "lstsq_from_triangular", "SOLVE_TOLERANCES"]


#: Documented per-backend tolerances of ``engine.solve`` against a float64
#: least-squares solve (relative error on x, well-conditioned inputs of
#: moderate dynamic range).  The same table as the JAX package; the
#: bit-accurate cordic family is limited by its N=26-bit significand.
SOLVE_TOLERANCES = {
    "jnp": 1e-3,
    "givens_float": 1e-3,
    "cordic": 1e-5,
    "cordic_pallas": 1e-5,
    "blockfp_pallas": 1e-3,
    "fixed": 1e-2,
    "jnp:complex": 1e-3,
    "givens_float:complex": 1e-3,
    "cordic:complex": 3e-5,
    "cordic_pallas:complex": 3e-5,
}


def _work_dtype(*xs):
    return (torch.complex128 if any(x.is_complex() for x in xs)
            else torch.float64)


def back_substitute(R, y):
    """Solve the upper-triangular system ``R x = y``, batched.

    Parameters
    ----------
    R : (..., n, n) tensor — upper-triangular (entries below the diagonal
        are ignored).
    y : (..., n) or (..., n, k) tensor — right-hand sides.

    Returns
    -------
    x with the shape of ``y`` — float64, or complex128 when either operand
    is complex.  Rows are solved bottom-up, one row product per step; a
    zero diagonal gives inf/nan, as direct substitution does.
    """
    R = torch.as_tensor(R)
    y = torch.as_tensor(y)
    work_dtype = _work_dtype(R, y)
    R = R.to(work_dtype)
    y = y.to(work_dtype)
    vec = y.dim() == R.dim() - 1
    if vec:
        y = y[..., None]
    n = R.shape[-1]
    if y.shape[-2] != n:
        raise ValueError(f"shape mismatch: R is (..., {n}, {n}), "
                         f"y rows = {y.shape[-2]}")
    x = torch.zeros_like(y)
    for row in range(n - 1, -1, -1):
        # rows below `row` are already solved; rows above still hold the
        # zero init, and R's upper-triangular structure ignores them.
        acc = torch.einsum("...j,...jk->...k", R[..., row, :], x)
        x[..., row, :] = (y[..., row, :] - acc) / R[..., row, row][..., None]
    return x[..., 0] if vec else x


def lstsq_from_triangular(Raug, n):
    """Extract the least-squares solution from a triangularized ``[A | b]``.

    Returns ``(x, resid)``: ``x`` is ``(..., n, k)`` and ``resid`` the
    ``(..., k)`` real residual two-norms read off the annihilated tail of
    the b columns.
    """
    Raug = torch.as_tensor(Raug)
    Raug = Raug.to(_work_dtype(Raug))
    R = Raug[..., :n, :n]
    C = Raug[..., :n, n:]
    x = back_substitute(R, C)
    tail = Raug[..., n:, n:]
    resid = torch.sqrt(torch.sum(torch.real(tail * torch.conj(tail)), dim=-2))
    return x, resid
