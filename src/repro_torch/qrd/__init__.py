"""repro_torch.qrd — the QRD API of the port (mirrors `repro.qrd`).

* `QRDConfig` — one config for backend, schedule and unit parameters; its
  JSON round-trips with `repro.qrd.QRDConfig`;
* `register_backend` / `list_backends` — the backend registry (the six
  built-ins ``'jnp'``, ``'givens_float'``, ``'cordic'``,
  ``'cordic_pallas'``, ``'blockfp_pallas'`` and ``'fixed'`` are entries
  like any third-party backend);
* `QRDEngine` — registry-dispatched decomposition plus ``solve()`` and
  ``rls()``, on the GPU by default;
* `RLSState` / `validate_lam` — streaming QRD-RLS (real dtypes);
* `back_substitute` — the batched triangular solve.
"""
from .registry import (BackendCapabilities, BackendSpec, register_backend,
                       unregister_backend, get_backend, list_backends,
                       available_backends, complex_capable_backends)
from .config import QRDConfig
from .solve import back_substitute, lstsq_from_triangular, SOLVE_TOLERANCES
from . import backends as _backends  # populates the registry on import
from .engine import QRDEngine
from .rls import RLSState, validate_lam

__all__ = [
    "BackendCapabilities", "BackendSpec", "register_backend",
    "unregister_backend", "get_backend", "list_backends",
    "available_backends", "complex_capable_backends",
    "QRDConfig", "QRDEngine", "RLSState", "validate_lam",
    "back_substitute", "lstsq_from_triangular", "SOLVE_TOLERANCES",
]
