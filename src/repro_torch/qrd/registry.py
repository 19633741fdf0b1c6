"""Backend registry for the QRD API (torch port of `repro.qrd.registry`).

Every backend is an entry mapping a name to a *builder* plus a
:class:`BackendCapabilities` record.  The engine looks backends up here,
validates the requested configuration against the capability metadata,
and builds one ``(A) -> (Q, R)`` callable per shape.

Builder contract
----------------
``builder(config, m, n, compute_q) -> callable``

* ``config``   : the resolved :class:`repro_torch.qrd.config.QRDConfig`;
* ``m, n``     : static matrix shape (trailing two axes of the operand);
* ``compute_q``: whether the returned callable must produce Q.

The returned callable maps a ``(..., m, n)`` tensor (the engine's validated
operand) to ``(Q, R)`` on the tensor's device, with ``Q is None`` when ``compute_q=False``.  The
engine memoizes it per ``(m, n, compute_q, config)`` in a bounded LRU.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["BackendCapabilities", "BackendSpec", "register_backend",
           "unregister_backend", "get_backend", "list_backends",
           "available_backends", "complex_capable_backends"]


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """What a QRD backend can do — drives validation and error messages.

    Parameters
    ----------
    bit_exact : bool
        The backend reproduces the paper's unit bit-for-bit (the
        ``'cordic'`` family contract, DESIGN.md §5).
    schedules : tuple[str, ...]
        Rotation schedules the backend understands.  Backends that do not
        consume a Givens schedule at all (``'jnp'``) list only ``'col'``
        and are rejected early when another schedule is requested.
    wavefront : bool
        ``schedule='sameh_kuck'`` routes onto the stage-parallel wavefront
        datapath instead of a flattened step order.
    sharding : bool
        The backend composes with a batch-sharding mesh
        (``QRDConfig.mesh``; ROADMAP A12).
    dtypes : tuple[str, ...]
        Dtypes the backend can produce.  These gate the *dtype family*
        (real vs complex), not the exact precision: requesting a dtype
        of a listed family is always valid, and the backend outputs its
        natural precision for that family (the bit-accurate backends
        list only float64/complex128 and return those regardless of the
        requested precision — their accuracy comes from ``givens.fmt``,
        exactly as the real path has always worked with the default
        float32 config).  Complex entries declare the backend
        complex-capable: `QRDConfig` validation rejects complex dtypes on
        backends without one, and `QRDEngine` routes complex operands
        onto the complex datapath only where one is declared.
    max_shape : tuple[int, int] or None
        Largest ``(m, n)`` a *single flat* (one-tile) factorization may
        have on this backend, or ``None`` for "unbounded" (host loops and
        reference paths).  Bounded backends are the kernel-resident ones.
        The engine consults this to route oversized operands onto the
        tiled layer and to raise a shape error naming the capacity.
    supports_tiling : bool
        The backend's kernels compose with the tiled panel/TSQR layer
        (`repro_torch.qrd.tiled`): its rotation control words can be exported
        from a panel factorization and replayed across trailing panels.
    description : str
        One line for docs and error messages.
    """

    bit_exact: bool = False
    schedules: tuple[str, ...] = ("col", "sameh_kuck")
    wavefront: bool = False
    sharding: bool = False
    dtypes: tuple[str, ...] = ("float64",)
    max_shape: tuple[int, int] | None = None
    supports_tiling: bool = False
    description: str = ""

    @property
    def supports_complex(self) -> bool:
        """Whether the backend declares a complex datapath."""
        return any(d.startswith("complex") for d in self.dtypes)

    def fits_flat(self, m: int, n: int) -> bool:
        """Whether an ``(m, n)`` operand fits one flat (untiled) kernel call."""
        if self.max_shape is None:
            return True
        return m <= self.max_shape[0] and n <= self.max_shape[1]


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """A registry entry: name + builder + capabilities."""

    name: str
    builder: Callable
    capabilities: BackendCapabilities


_REGISTRY: dict[str, BackendSpec] = {}


def register_backend(name: str, builder: Callable,
                     capabilities: BackendCapabilities | None = None,
                     *, overwrite: bool = False) -> BackendSpec:
    """Register a QRD backend under ``name``.

    Parameters
    ----------
    name : str
        Registry key — becomes a valid ``QRDConfig.backend`` value.
    builder : callable
        ``builder(config, m, n, compute_q) -> (A) -> (Q, R)`` (see module
        docstring for the full contract).
    capabilities : BackendCapabilities, optional
        Capability metadata; defaults to the conservative record (not
        bit-exact, both schedules, no wavefront/sharding).
    overwrite : bool
        Allow replacing an existing entry (default: raise on collision so
        a typo cannot silently shadow a built-in).

    Returns
    -------
    BackendSpec — the stored entry.
    """
    if not name or not isinstance(name, str):
        raise ValueError(f"backend name must be a non-empty str, got {name!r}")
    if not callable(builder):
        raise TypeError(f"builder for {name!r} must be callable")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered "
                         "(pass overwrite=True to replace)")
    spec = BackendSpec(name, builder, capabilities or BackendCapabilities())
    _REGISTRY[name] = spec
    return spec


def unregister_backend(name: str) -> None:
    """Remove a backend (mainly for tests of third-party registration)."""
    _REGISTRY.pop(name, None)


def get_backend(name: str) -> BackendSpec:
    """Look a backend up; unknown names raise with the available set."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered backends: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def list_backends() -> dict[str, BackendCapabilities]:
    """Name -> capabilities for every registered backend (sorted copy)."""
    return {k: _REGISTRY[k].capabilities for k in sorted(_REGISTRY)}


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def complex_capable_backends() -> tuple[str, ...]:
    """Names of registered backends with a complex datapath (sorted).

    The single source of truth for 'complex-capable backends: ...' error
    messages (`QRDConfig.validate`, `QRDEngine._validate_operand`).
    """
    return tuple(n for n in sorted(_REGISTRY)
                 if _REGISTRY[n].capabilities.supports_complex)
