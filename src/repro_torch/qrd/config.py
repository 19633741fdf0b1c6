"""Unified QRD problem configuration (torch port of `repro.qrd.config`).

The fields, their defaults and the JSON form are those of the JAX package,
so ``QRDConfig.from_json(other.to_json())`` carries a configuration between
the two packages unchanged.  Two fields stay for that round-trip only:
``interpret`` (the port has no interpret mode: a kernel runs on the GPU,
its plain version on the CPU) and ``mesh`` (not ported yet).
The device is not part of the configuration: it belongs to the engine.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch

from repro_torch.core.formats import FloatFormat
from repro_torch.core.givens import GivensConfig

__all__ = ["QRDConfig"]


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


@dataclasses.dataclass(frozen=True)
class QRDConfig:
    """Everything a QRD problem dispatch depends on.

    Parameters
    ----------
    backend : str
        A registered backend name (`repro_torch.qrd.available_backends`).
    schedule : str
        ``'col'`` (column-major) or ``'sameh_kuck'`` (parallel pairing).
    givens : GivensConfig
        Unit parameters for the cordic family.
    iters, hub, frac : block-FP kernel knobs (`blockfp_iters`, `blockfp_hub`).
    fixed_width, fixed_iters, fixed_scale_exp : ``'fixed'`` baseline knobs.
    dtype : str, numpy or torch dtype
        Element dtype of the problem, normalized to its name.  The
        bit-accurate backends return float64; complex dtypes select the
        complex datapath (complex128 results).
    interpret : bool, optional
        Kept for the JSON round-trip only; the port has no interpret mode.
    tile_b : int, optional
        Matrices per CUDA block of the packed-word kernel; ``None`` takes
        `repro_torch.kernels.qrd_blocked.TILE_B`.
    table_layout : ``'split'`` or ``'stacked'``, the JAX package's transfer
        layout of the wavefront's stage tables; accepted and validated, the
        words do not depend on it.
    tiling : str, optional
        ``None``/``'auto'``, ``'flat'``, ``'panel'`` or ``'tsqr'``
        (`repro_torch.qrd.tiled.resolve_route`).
    tile_m, panel_n : int, optional
        TSQR leaf rows and panel width of the tiled routes; ``None`` takes
        the backend's row capacity and `tiled.DEFAULT_PANEL_N`.
    mesh : sharding mesh; excluded from hash/equality and from `as_dict`.
    """

    backend: str = "jnp"
    schedule: str = "col"
    givens: GivensConfig = dataclasses.field(default_factory=GivensConfig)
    iters: int | None = None
    hub: bool | None = None
    frac: int = 24
    fixed_width: int = 32
    fixed_iters: int = 27
    fixed_scale_exp: int = 0
    dtype: str = "float32"
    interpret: bool | None = None
    tile_b: int | None = None
    table_layout: str | None = None
    tiling: str | None = None
    tile_m: int | None = None
    panel_n: int | None = None
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    SCHEDULES = ("col", "sameh_kuck")
    TABLE_LAYOUTS = (None, "split", "stacked")
    TILINGS = (None, "auto", "flat", "panel", "tsqr")

    def __post_init__(self):
        try:
            name = _dtype_name(self.dtype)
        except TypeError:
            raise TypeError(f"dtype must be a dtype or dtype name, got "
                            f"{self.dtype!r}") from None
        object.__setattr__(self, "dtype", name)

    def replace(self, **changes) -> "QRDConfig":
        return dataclasses.replace(self, **changes)

    def is_complex(self) -> bool:
        """Whether this config selects the complex datapath."""
        return np.dtype(self.dtype).kind == "c"

    def as_dict(self) -> dict:
        """JSON-ready dict of every arithmetic field (``mesh`` excluded)."""
        d = dataclasses.asdict(self)
        d.pop("mesh", None)
        return d

    def to_json(self, **json_kwargs) -> str:
        """Serialize to JSON (deterministic key order)."""
        json_kwargs.setdefault("sort_keys", True)
        return json.dumps(self.as_dict(), **json_kwargs)

    @classmethod
    def from_dict(cls, d: dict) -> "QRDConfig":
        """Inverse of `as_dict` (strict: unknown keys raise)."""
        d = dict(d)
        g = d.get("givens")
        if isinstance(g, dict):
            g = dict(g)
            fmt = g.get("fmt")
            if isinstance(fmt, dict):
                g["fmt"] = FloatFormat(**fmt)
            d["givens"] = GivensConfig(**g)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown QRDConfig field(s) {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "QRDConfig":
        """Inverse of `to_json`: ``QRDConfig.from_json(cfg.to_json()) == cfg``."""
        return cls.from_dict(json.loads(s))

    # -- resolved block-FP parameters ----------------------------------------
    def blockfp_iters(self) -> int:
        """CORDIC depth of the block-FP datapath: ``iters``, else the unit's
        resolved depth."""
        return self.givens.resolved_iters() if self.iters is None else self.iters

    def blockfp_hub(self) -> bool:
        """HUB arithmetic of the block-FP datapath: ``hub``, else the
        unit's."""
        return self.givens.hub if self.hub is None else self.hub

    def cache_key(self):
        """Hashable key covering everything dispatch depends on (``mesh``
        by identity)."""
        return (self, None if self.mesh is None else id(self.mesh))

    def validate(self):
        """Early validation against the registry's capability metadata."""
        from . import registry
        spec = registry.get_backend(self.backend)  # raises w/ available set
        caps = spec.capabilities
        if self.schedule not in self.SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}; "
                             f"expected one of {self.SCHEDULES}")
        if self.table_layout not in self.TABLE_LAYOUTS:
            raise ValueError(
                f"unknown table_layout {self.table_layout!r}; "
                f"expected one of {self.TABLE_LAYOUTS}")
        if self.tile_b is not None and self.tile_b < 1:
            raise ValueError(f"tile_b must be >= 1, got {self.tile_b}")
        if self.tiling not in self.TILINGS:
            raise ValueError(f"unknown tiling {self.tiling!r}; "
                             f"expected one of {self.TILINGS}")
        if self.tile_m is not None and self.tile_m < 2:
            raise ValueError(f"tile_m must be >= 2, got {self.tile_m}")
        if self.panel_n is not None and self.panel_n < 1:
            raise ValueError(f"panel_n must be >= 1, got {self.panel_n}")
        if (self.tiling in ("panel", "tsqr")
                and not caps.supports_tiling):
            tiled = [n for n, c in registry.list_backends().items()
                     if c.supports_tiling]
            raise ValueError(
                f"backend {self.backend!r} has no tiled datapath "
                f"(tiling={self.tiling!r}); tiling-capable backends: "
                f"{', '.join(tiled)}")
        if self.schedule not in caps.schedules:
            raise ValueError(
                f"backend {self.backend!r} does not support "
                f"schedule={self.schedule!r} (supported: {caps.schedules})")
        if np.dtype(self.dtype).kind not in "fc":
            raise TypeError(
                f"dtype {self.dtype!r} is not a floating or complex dtype; "
                "QRD backends operate on real or complex matrices")
        if self.is_complex() and not caps.supports_complex:
            raise TypeError(
                f"backend {self.backend!r} has no complex datapath "
                f"(dtype={self.dtype!r}); complex-capable backends: "
                f"{', '.join(registry.complex_capable_backends())}")
        if self.mesh is not None and not caps.sharding:
            capable = [n for n, c in registry.list_backends().items()
                       if c.sharding]
            raise ValueError(
                f"backend {self.backend!r} has no sharding capability; "
                f"mesh dispatch is available on: {', '.join(capable)}")
        if caps.bit_exact:
            self.givens.validate()
        return spec
