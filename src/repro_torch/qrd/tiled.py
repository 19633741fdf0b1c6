"""Route selection for the tiled QRD layer (torch port of the routing part
of `repro.qrd.tiled`).

`resolve_route` decides flat | panel | tsqr exactly as the JAX package does
(copied line for line), so a shape lands on the same route in both
packages.  Only the flat route is ported: the panel and TSQR routines and
their kernels are ROADMAP A7 (kernels B3), and `build_tiled` raises until
then, so an operand beyond the flat limit fails loudly.
"""
from __future__ import annotations

__all__ = ["FLAT_LIMIT", "resolve_route", "build_tiled"]

# auto routes shapes at or under this bound onto the flat datapath --
# small problems fit comfortably and all pre-tiling callers stay on
# byte-identical code paths (same kernels, same jit cache entries).
FLAT_LIMIT = 32


def _capacity_error(config, caps, m, n, detail):
    max_m, max_n = caps.max_shape
    return ValueError(
        f"operand {m}x{n} exceeds backend {config.backend!r} kernel "
        f"capacity max_shape={caps.max_shape} ({detail}); "
        f"tiled alternatives: tiling='panel' keeps m <= {max_m} rows "
        f"kernel-resident with unbounded columns, tiling='tsqr' handles "
        f"tall-skinny m > {max_m} with n <= {max_m // 2} (tree nodes "
        f"stack R pairs to 2n x n), and tiling='auto' selects between "
        f"them.  See DESIGN.md §14.")


def resolve_route(config, m, n, caps) -> str:
    """Pick the datapath route for an (m, n) problem: flat | panel | tsqr.

    Deterministic in ``(m, n, config)``.  Raises ``ValueError`` naming
    the backend's ``max_shape`` and the tiled alternative whenever the
    requested (or only available) route cannot hold the operand —
    previously such shapes died deep inside Pallas with an opaque VMEM
    or iota-shape error.
    """
    tiling = "auto" if config.tiling is None else config.tiling

    # Backends without a tiled datapath (host references, float
    # baselines) have max_shape=None and always run flat.
    if not caps.supports_tiling:
        return "flat"
    # The complex datapath and the sameh_kuck wavefront ordering only
    # exist flat: the tiled routes replay the column-major schedule.
    forced_tiled = tiling in ("panel", "tsqr")
    if config.is_complex() or config.schedule == "sameh_kuck":
        which = ("complex datapath" if config.is_complex()
                 else "schedule='sameh_kuck'")
        if forced_tiled:
            raise ValueError(
                f"tiling={tiling!r} is only defined for the real "
                f"column-major datapath, but this config uses {which}; "
                "the tiled routes replay the flat column-major ordering "
                "(schedule='col')")
        if not caps.fits_flat(m, n):
            raise _capacity_error(
                config, caps, m, n,
                f"{which} runs flat only, and the whole augmented tile "
                "must fit VMEM")
        return "flat"

    max_m, max_n = caps.max_shape
    if tiling == "flat":
        if not caps.fits_flat(m, n):
            raise _capacity_error(
                config, caps, m, n,
                "tiling='flat' keeps the whole augmented tile "
                "kernel-resident")
        return "flat"
    if tiling == "panel":
        if m > max_m:
            raise _capacity_error(
                config, caps, m, n,
                "the panel route keeps all m rows kernel-resident")
        return "panel"
    if tiling == "tsqr":
        if 2 * n > max_m or n > max_n:
            raise _capacity_error(
                config, caps, m, n,
                "tsqr tree nodes stack R pairs to 2n x n tiles")
        return "tsqr"

    # -- auto -------------------------------------------------------------
    if m <= FLAT_LIMIT and n <= FLAT_LIMIT:
        return "flat"
    tsqr_ok = 2 * n <= max_m and n <= max_n
    if tsqr_ok and (m > max_m or m >= 4 * n):
        return "tsqr"          # over row capacity, or decisively tall-skinny
    if m <= max_m:
        return "panel"
    raise _capacity_error(
        config, caps, m, n,
        "m exceeds the row capacity and n is too wide for tsqr tree nodes")


def build_tiled(route, config, m, n, compute_q, caps):
    """The tiled routes (panel, TSQR); not ported yet."""
    raise NotImplementedError("panel/tsqr routes: ROADMAP A7/B3")
