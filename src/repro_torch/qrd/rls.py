"""Streaming QRD-RLS state, real dtypes (torch port of `repro.qrd.rls`).

QRD-RLS never forms the covariance matrix: the carried state is the pair
``[R | z]`` of the forgetting-factor-weighted data matrix, and every new
snapshot ``(x, d)`` is annihilated into it by Givens rotations.  Three
update paths, as in the JAX package:

* ``mode='unit'`` — per snapshot on the bit-accurate `GivensUnit`: the n
  pivot annihilations (`GivensUnit.annihilate`) on packed words;
* ``mode='block'`` — ``block`` snapshots are stacked under ``[R | z]`` and
  annihilated by ONE launch of the block-FP kernel
  (`repro_torch.kernels.ops.givens_block_apply` on `ops.rls_block_steps`),
  with the exponential forgetting telescoped exactly (state weighted
  lam^(b/2), pending row i by lam^((b-1-i)/2));
* ``mode='float'`` — a plain float64 Givens loop (the algorithmic
  baseline).

The state lives as float64 tensors on the device it was made for (the
engine's).  The forgetting weights are float64 products computed as the
JAX package computes them, so the carried ``R`` and ``z`` of the unit and
block modes are the same bits on every device.  Complex QRD-RLS needs the
unit's pivot-anywhere complex step, `GivensUnit.annihilate_complex`, which
is not ported yet (ROADMAP A9); the complex QR datapath it builds on is.
"""
from __future__ import annotations

import numpy as np
import torch

from .engine import resolve_device
from .solve import back_substitute

__all__ = ["RLSState", "validate_lam"]

_MODES = ("float", "unit", "block")


def validate_lam(lam, what="forgetting factor"):
    """Validate ``0 < lam <= 1`` (scalar or array) loudly; returns it as a
    float64 numpy array.

    lam <= 0 destroys the carried factor (the sqrt(lam) weighting zeroes
    R), lam > 1 amplifies history without bound and NaN poisons the state
    on the first update, so every entry point funnels through here.
    """
    raw = np.asarray(lam)
    if raw.dtype.kind == "c":
        raise TypeError(f"{what} must be real, got complex {lam!r}")
    if raw.dtype.kind not in "fiu":
        raise TypeError(f"{what} must be numeric, got {raw.dtype}")
    # lint: allow[narrowing-cast] real/int-only here, complex rejected above
    arr = raw.astype(np.float64)
    if arr.size == 0:
        raise ValueError(f"{what} must be non-empty")
    if not np.all((arr > 0.0) & (arr <= 1.0)):
        raise ValueError(f"{what} must be in (0, 1], got {lam!r}")
    return arr


class RLSState:
    """Carried QRD-RLS state ``[R | z]`` with streaming updates.

    Parameters
    ----------
    n : int
        Filter length (size of the carried upper-triangular R).
    lam : float
        Forgetting factor in (0, 1].
    delta : float
        Initial diagonal loading: ``R0 = delta * I``.
    mode : str
        ``'float'`` | ``'unit'`` | ``'block'`` (see the module docstring);
        usually chosen by `repro_torch.qrd.QRDEngine.rls` from the backend.
    unit : GivensUnit, required for ``mode='unit'``.
    block, hub, iters, frac, tile_b :
        Block-FP parameters (``mode='block'``): snapshots per kernel launch
        and the datapath knobs of `repro_torch.kernels.ops.givens_block_apply`.
    dtype : str
        ``'float64'``; ``'complex128'`` raises NotImplementedError (ROADMAP
        A9).
    device : str or torch.device, optional
        Where the state lives and the updates run.  ``None`` (default) is
        the GPU, which must exist, as for `repro_torch.qrd.QRDEngine`;
        ``'cpu'`` runs the kernels' plain PyTorch versions.

    Attributes
    ----------
    R : (n, n) float64 tensor — carried triangular factor.
    z : (n,) float64 tensor — carried rotated target vector.
    updates : int — snapshots absorbed (committed + pending).

    Notes
    -----
    In ``mode='block'`` snapshots accumulate in a pending buffer and are
    committed ``block`` at a time; `weights` reads the *committed* state
    (call `flush` first to force a partial block through the kernel).
    """

    def __init__(self, n, lam=0.99, delta=1e-3, *, mode="float", unit=None,
                 block=4, hub=True, iters=24, frac=24, tile_b=None,
                 dtype="float64", device=None):
        if mode not in _MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of {_MODES}")
        validate_lam(lam)
        if mode == "unit" and unit is None:
            raise ValueError("mode='unit' needs a GivensUnit")
        if dtype not in ("float64", "complex128"):
            raise ValueError(f"dtype must be 'float64' or 'complex128', "
                             f"got {dtype!r}")
        if mode == "block" and dtype == "complex128":
            raise TypeError("the blocked-kernel RLS path has no complex "
                            "datapath; use mode='unit' or mode='float' for "
                            "complex QRD-RLS")
        if dtype == "complex128":
            raise NotImplementedError("complex QRD-RLS is not ported yet "
                                      "(ROADMAP A9, annihilate_complex)")
        self.n = int(n)
        self.lam = float(lam)
        self.mode = mode
        self.unit = unit
        self.block = int(block)
        self.device = resolve_device(device)
        self._blockfp = dict(hub=hub, iters=iters, frac=frac, tile_b=tile_b)
        self.R = torch.eye(self.n, dtype=torch.float64,
                           device=self.device) * float(delta)
        self.z = torch.zeros(self.n, dtype=torch.float64, device=self.device)
        self.updates = 0
        self._pending: list[torch.Tensor] = []

    # -- update paths ---------------------------------------------------------
    def _work(self, weight):
        return torch.cat([self.R, self.z[:, None]], dim=1) * weight

    def _row(self, x, d):
        x = torch.as_tensor(x)
        if x.is_complex() or torch.as_tensor(d).is_complex():
            raise TypeError("complex snapshot on a real-dtype RLS state (no "
                            "silent real cast)")
        x = x.to(device=self.device, dtype=torch.float64).reshape(-1)
        d = torch.as_tensor(d, dtype=torch.float64, device=self.device)
        row = torch.cat([x, d.reshape(1)])
        if row.shape[0] != self.n + 1:
            raise ValueError(f"snapshot length {row.shape[0] - 1} != n="
                             f"{self.n}")
        return row

    def update(self, x, d):
        """Absorb one snapshot: rotate ``[x, d]`` into ``[√λ R | √λ z]``.

        Parameters
        ----------
        x : (n,) array_like — input/regressor snapshot.
        d : scalar — desired response.

        Returns
        -------
        self (for chaining).
        """
        row = self._row(x, d)
        self.updates += 1
        if self.mode == "block":
            self._pending.append(row)
            if len(self._pending) >= self.block:
                self.flush()
            return self
        work = self._work(float(np.sqrt(self.lam)))
        if self.mode == "unit":
            unit = self.unit
            P = unit.encode(work)
            prow = unit.encode(row)
            for k in range(self.n):
                xk, prow = unit.annihilate(P[k], prow, k)
                P[k] = xk
            out = unit.decode(P)
        else:
            out = work
            for k in range(self.n):
                a, b = out[k, k], row[k]
                r = torch.hypot(a.abs(), b.abs())
                if r.item() == 0.0:
                    continue
                c, s = a / r, b / r
                wk = c * out[k] + s * row
                row = -s * out[k] + c * row
                row[k] = 0.0
                out[k] = wk
                out[k, k] = r
        self.R, self.z = out[:, :self.n], out[:, self.n]
        return self

    def flush(self):
        """Commit pending snapshots through the block-FP kernel
        (mode='block').

        One `givens_block_apply` launch annihilates all ``b`` stacked rows
        column by column against the carried state; the forgetting weights
        (state x lam^(b/2), row i x lam^((b-1-i)/2)) telescope to the
        per-snapshot recursion exactly.  No-op when nothing is pending.
        """
        b = len(self._pending)
        if b == 0:
            return self
        from repro_torch.kernels import ops

        lam_half = np.sqrt(self.lam)
        top = self._work(float(lam_half ** b))
        rows = torch.stack([row * float(lam_half ** (b - 1 - i))
                            for i, row in enumerate(self._pending)])
        W = torch.cat([top, rows], dim=0)[None]          # (1, n+b, n+1)
        steps = ops.rls_block_steps(self.n, b)
        Wp = ops.givens_block_apply(W, steps, **self._blockfp)[0]
        self.R, self.z = Wp[:self.n, :self.n], Wp[:self.n, self.n]
        self._pending = []
        return self

    # -- export / import ------------------------------------------------------
    def to_arrays(self):
        """Export the full state as a dict of tensors on the state's device.

        The pending buffer is a fixed-shape ``(block, n+1)`` tensor (rows
        beyond ``pending_count`` are zero), so the export has a static
        structure; its keys and shapes are those of the JAX package's
        ``RLSState.to_arrays``, so a state moves between the two packages
        through numpy.

        Returns
        -------
        dict with ``R`` (n, n), ``z`` (n,), ``lam`` float64, ``updates``
        int64, ``pending`` (block, n+1) — (0, n+1) for the unblocked modes —
        and ``pending_count`` int64.
        """
        cap = self.block if self.mode == "block" else 0
        pending = torch.zeros((cap, self.n + 1), dtype=torch.float64,
                              device=self.device)
        for i, row in enumerate(self._pending):
            pending[i] = row
        scalar = dict(device=self.device)
        return {"R": self.R.clone(), "z": self.z.clone(),
                "lam": torch.tensor(self.lam, dtype=torch.float64, **scalar),
                "updates": torch.tensor(self.updates, dtype=torch.int64,
                                        **scalar),
                "pending": pending,
                "pending_count": torch.tensor(len(self._pending),
                                              dtype=torch.int64, **scalar)}

    def from_arrays(self, arrays):
        """Load a `to_arrays` export (tensors or the JAX package's numpy
        arrays) into this compatibly configured state.

        The receiving state supplies the configuration (mode, unit, kernel
        knobs); ``arrays`` the carried numbers.  Shapes, dtype kind and
        lam are validated; pending snapshots need ``mode='block'``.
        """
        def tensor(v):
            return torch.as_tensor(v).to(self.device)

        R, z = tensor(arrays["R"]), tensor(arrays["z"])
        if tuple(R.shape) != (self.n, self.n) or tuple(z.shape) != (self.n,):
            raise ValueError(f"state shape mismatch: R {tuple(R.shape)}, z "
                             f"{tuple(z.shape)} vs n={self.n}")
        if R.is_complex():
            raise TypeError(f"dtype kind mismatch: imported {R.dtype} into a "
                            "float64 state (no silent cast)")
        count = int(arrays.get("pending_count", 0))
        pending = tensor(arrays.get("pending", np.zeros((0, self.n + 1))))
        if count:
            if self.mode != "block":
                raise ValueError(f"{count} pending snapshot(s) in the import "
                                 f"but mode={self.mode!r} has no pending "
                                 "buffer (flush() the source first)")
            if count > pending.shape[0] or tuple(pending.shape[1:]) != (
                    self.n + 1,):
                raise ValueError(f"pending buffer {tuple(pending.shape)} "
                                 f"cannot hold {count} rows of length "
                                 f"{self.n + 1}")
        lam = arrays["lam"]
        self.lam = float(validate_lam(
            lam.item() if isinstance(lam, torch.Tensor) else lam).item())
        self.R = R.to(torch.float64).clone()
        self.z = z.to(torch.float64).clone()
        self.updates = int(arrays["updates"])
        self._pending = [pending[i].to(torch.float64).clone()
                         for i in range(count)]
        return self

    # -- readout --------------------------------------------------------------
    def weights(self, ridge=1e-12):
        """Back-substitute the carried ``R w = z`` for the filter weights.

        Parameters
        ----------
        ridge : float
            Diagonal loading added to R before the solve (guards the
            cold-started diagonal).

        Returns
        -------
        (n,) float64 tensor on the state's device.
        """
        R = self.R
        if ridge:
            R = R + ridge * torch.eye(self.n, dtype=R.dtype, device=R.device)
        return back_substitute(R, self.z)

    def predict(self, x):
        """Filter output ``xᵀ w`` for a snapshot ``x``."""
        x = torch.as_tensor(x)
        if x.is_complex():
            raise TypeError("complex snapshot on a real-dtype RLS state "
                            "(no silent real cast)")
        return float(x.to(device=self.device, dtype=torch.float64)
                     @ self.weights())
