"""The QRD engine: registry-dispatched, problem-level API (torch port of
`repro.qrd.engine`).

* **decompose** — ``engine(A)``: batched ``(Q, R)`` via the registered
  backend, one built callable per ``(m, n, compute_q, config)`` held in a
  bounded LRU.
* **solve** — ``engine.solve(A, b)``: batched least squares via the Q-free
  augmented-column trick + `repro_torch.qrd.solve.back_substitute`.

The engine runs on the GPU unless it is given ``device="cpu"``; on the CPU
every kernel's plain PyTorch version runs instead.  Shapes beyond the flat
route go to the panel or TSQR route (`repro_torch.qrd.tiled`).

* **rls** — ``engine.rls(n)``: a streaming QRD-RLS state on the engine's
  device (`repro_torch.qrd.rls.RLSState`, real dtypes).

The RLS fleet (ROADMAP A11), complex RLS (A9), sharding meshes (A12) and
autotuned tiles (A10) are not ported yet.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from repro_torch.kernels._launch import resolve_device

from .config import QRDConfig, _dtype_name
from .solve import lstsq_from_triangular

__all__ = ["QRDEngine"]


class QRDEngine:
    """Registry-dispatched batched QRD with problem-level methods.

    Parameters
    ----------
    config : QRDConfig, optional
        The problem configuration; defaults to ``QRDConfig()``.
    device : str or torch.device, optional
        Where operands are factorized.  ``None`` is the GPU and raises
        ``RuntimeError`` when CUDA is unavailable; ``"cpu"`` runs the plain
        PyTorch versions of the kernels.
    max_cache : int
        Bound on the built-callable LRU.
    **overrides
        Field overrides applied on top of ``config``, e.g.
        ``backend='cordic_pallas'``; ``givens_config=`` is an alias for
        ``givens=``.

    Examples
    --------
    >>> eng = QRDEngine(backend='cordic_pallas',
    ...                 givens=GivensConfig(hub=True, n=26))
    >>> Q, R = eng(A)                      # decomposition, on the GPU
    >>> x = eng.solve(A, b)                # batched least squares
    """

    def __init__(self, config: QRDConfig | None = None, *, device=None,
                 max_cache=32, **overrides):
        self.device = resolve_device(device)
        if config is None:
            config = QRDConfig()
        if "givens_config" in overrides:
            overrides["givens"] = overrides.pop("givens_config")
        if overrides:
            config = config.replace(**overrides)
        self._spec = config.validate()   # raises early: bad backend/schedule
        if config.mesh is not None:
            raise NotImplementedError("mesh dispatch is not ported yet "
                                      "(ROADMAP A12)")
        self.config = config
        if max_cache < 1:
            raise ValueError("max_cache must be >= 1")
        self._max_cache = int(max_cache)
        self._fn_cache: OrderedDict = OrderedDict()

    @property
    def capabilities(self):
        """The configured backend's `BackendCapabilities`."""
        return self._spec.capabilities

    def __repr__(self):
        return (f"QRDEngine(backend={self.config.backend!r}, "
                f"schedule={self.config.schedule!r}, device={self.device}, "
                f"cached={len(self._fn_cache)}/{self._max_cache})")

    # -- decomposition --------------------------------------------------------
    def _validate_operand(self, A, config: QRDConfig):
        """Validate the operand dtype against the backend's capabilities.

        * bool/integer operands are promoted to float64 explicitly;
        * complex operands require a complex-capable backend — otherwise
          ``TypeError`` names the backend and the complex-capable set — and
          upgrade the config's dtype to the matching complex dtype;
        * non-numeric input fails in ``torch.as_tensor``.

        Returns the (possibly promoted) operand and the routing config.
        """
        A = torch.as_tensor(A)
        if A.dtype == torch.bool or not (A.is_floating_point()
                                         or A.is_complex()):
            A = A.to(torch.float64)
        elif A.is_complex():
            if not config.is_complex():
                from . import registry
                caps = registry.get_backend(config.backend).capabilities
                if not caps.supports_complex:
                    raise TypeError(
                        f"complex operand (dtype {A.dtype}) but backend "
                        f"{config.backend!r} has no complex datapath; "
                        "complex-capable backends: "
                        f"{', '.join(registry.complex_capable_backends())}.")
                config = config.replace(dtype=_dtype_name(A.dtype))
        return A, config

    def _dispatch(self, A, compute_q, config: QRDConfig | None = None):
        """Registry dispatch with the bounded built-callable LRU; the
        route (flat, panel or tsqr) comes from
        `repro_torch.qrd.tiled.resolve_route`.  ``config`` defaults to the
        engine's own; the legacy facade (`repro_torch.core.QRDEngine`)
        passes one rebuilt from its mutable fields."""
        if config is None:
            config = self.config
        A, config = self._validate_operand(A, config)
        if A.dim() < 2:
            raise ValueError(f"expected (..., m, n) operand, got {tuple(A.shape)}")
        m, n = A.shape[-2], A.shape[-1]
        key = (m, n, bool(compute_q), config.cache_key())
        fn = self._fn_cache.pop(key, None)
        if fn is None:
            from . import tiled
            spec = config.validate()
            route = tiled.resolve_route(config, m, n, spec.capabilities)
            if route == "flat":
                fn = spec.builder(config, m, n, bool(compute_q))
            else:
                fn = tiled.build_tiled(route, config, m, n, bool(compute_q),
                                       spec.capabilities)
        self._fn_cache[key] = fn           # (re-)insert as most-recent
        while len(self._fn_cache) > self._max_cache:
            self._fn_cache.popitem(last=False)
        return fn(A.to(self.device))

    def __call__(self, A, compute_q=True):
        """Batched QRD: ``A (..., m, n) -> (Q, R)`` (Q None w/o compute_q)."""
        return self._dispatch(A, compute_q)

    decompose = __call__

    # -- least squares --------------------------------------------------------
    def solve(self, A, b, return_residuals=False):
        """Batched least squares ``min_x ||A x - b||`` without forming Q.

        Triangularizes ``[A | b]`` with ``compute_q=False`` (the appended
        columns come out as ``Qᵀ b``), then back-substitutes.  Accuracy
        against a float64 least-squares solve is documented per backend in
        `repro_torch.qrd.solve.SOLVE_TOLERANCES`.

        Parameters
        ----------
        A : (..., m, n) tensor or array_like, with ``m >= n``.
        b : (..., m) or (..., m, k) tensor or array_like.
        return_residuals : bool — also return the ``(..., k)`` residual
            two-norms ``||A x - b||``.

        Returns
        -------
        x : (..., n) or (..., n, k) float64 on the engine's device, or
        ``(x, residuals)``.
        """
        A = torch.as_tensor(A)
        b = torch.as_tensor(b)
        if self.config.is_complex() or A.is_complex() or b.is_complex():
            work_dtype = torch.complex128
        else:
            work_dtype = torch.float64
        A = A.to(device=self.device, dtype=work_dtype)
        b = b.to(device=self.device, dtype=work_dtype)
        m, n = A.shape[-2], A.shape[-1]
        if m < n:
            raise ValueError(f"solve() needs m >= n (got {m} x {n}); "
                             "underdetermined systems have no unique "
                             "least-squares triangular solve")
        vec = b.dim() == A.dim() - 1
        B = b[..., None] if vec else b
        if B.dim() != A.dim() or B.shape[-2] != m:
            raise ValueError(f"b rows must match A rows: A {tuple(A.shape)}, "
                             f"b {tuple(b.shape)}")
        aug = torch.cat([A, B], dim=-1)
        _, Raug = self._dispatch(aug, False)
        x, resid = lstsq_from_triangular(Raug, n)
        if vec:
            x, resid = x[..., 0], resid[..., 0]
        return (x, resid) if return_residuals else x

    # -- streaming RLS --------------------------------------------------------
    def rls(self, n, lam=0.99, delta=1e-3, block=None):
        """Create a streaming QRD-RLS state bound to this engine's backend
        and device.

        Parameters
        ----------
        n : int
            Filter length (columns of the carried R).
        lam : float
            Forgetting factor in (0, 1].
        delta : float
            Initial diagonal loading of R.
        block : int, optional
            Update granularity.  ``None`` selects the backend's natural
            path: the cordic family updates per snapshot on the
            bit-accurate unit (`GivensUnit.annihilate`),
            ``'blockfp_pallas'`` batches ``block=4`` snapshots per launch
            of the block-FP kernel, and any other backend uses a plain
            float64 rotation loop.  An explicit ``block`` forces the
            block-FP path on any backend.

        Returns
        -------
        `repro_torch.qrd.rls.RLSState` on the engine's device —
        ``state.update(x, d)`` / ``state.weights()``.  A complex-dtype
        config raises: complex QRD-RLS is ROADMAP A9.
        """
        from repro_torch.core.givens import GivensUnit
        from .rls import RLSState, validate_lam

        validate_lam(lam)  # eagerly, before any mode routing can raise
        cfg = self.config
        if block is not None or cfg.backend == "blockfp_pallas":
            if cfg.is_complex():
                raise TypeError(
                    "the blocked-kernel RLS path has no complex datapath; "
                    "use the cordic family (mode='unit') or a float "
                    "backend for complex QRD-RLS")
            return RLSState(n, lam=lam, delta=delta, mode="block",
                            block=4 if block is None else int(block),
                            hub=cfg.blockfp_hub(), iters=cfg.blockfp_iters(),
                            frac=cfg.frac, tile_b=cfg.tile_b,
                            device=self.device)
        dtype = "complex128" if cfg.is_complex() else "float64"
        if cfg.backend in ("cordic", "cordic_pallas"):
            return RLSState(n, lam=lam, delta=delta, mode="unit",
                            unit=GivensUnit(cfg.givens), dtype=dtype,
                            device=self.device)
        return RLSState(n, lam=lam, delta=delta, mode="float", dtype=dtype,
                        device=self.device)

    def fleet(self, *args, **kwargs):
        """QRD-RLS serving fleet; not ported yet (ROADMAP A11)."""
        raise NotImplementedError("the QRD-RLS fleet is not ported yet "
                                  "(ROADMAP A11)")
