"""Tiled QRD routes: panel factorization and TSQR tree reduction (torch
port of `repro.qrd.tiled`, DESIGN.md §14).

The flat kernel keeps the whole augmented ``(m, n + m)`` tile resident,
which caps it at `BackendCapabilities.max_shape`.  Two routes lift that
cap; every rotation is still computed once (vectoring on the lead pair)
and replayed everywhere else from its ``(flip, sigma)`` control word:

* **panel** — sweep the columns in ``panel_n``-wide panels: the CUDA
  kernel `panel_factor_packed_call` (``panel_factor_blockfp_call`` on the
  block-FP lane) factorizes a panel and exports the control words of its
  rotations, `panel_apply_packed_call` (``panel_apply_blockfp_call``)
  replays them over the trailing columns.  The panel step tables concatenate to
  `repro_torch.core.qrd.givens_schedule`, so R and Q are bit-identical to
  the flat route.  m is bounded by ``max_shape[0]``; n is not.
* **tsqr** — rows are zero-padded to ``L * tile_m`` and split into L leaf
  tiles; every leaf is factorized by the panel route in one batched call,
  then a binary tree of ``(2n, n)`` stacked R-pair factorizations reduces
  the L leaf R factors to one, one batched call per level.  Returns the
  economy factors ``Q (m, n), R (n, n)``; R is bit-identical to
  `tsqr_host_reference`, Q (a float64 composition of the node factors)
  equal to it within float64 rounding.

`resolve_route` decides flat | panel | tsqr exactly as the JAX package does
(copied line for line), so a shape lands on the same route in both
packages.  Sharding the tree over a mesh is ROADMAP A12.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["FLAT_LIMIT", "DEFAULT_PANEL_N", "resolve_route", "resolve_tiles",
           "build_tiled", "tsqr_host_reference"]

# auto routes shapes at or under this bound onto the flat datapath --
# small problems fit comfortably and all pre-tiling callers stay on
# byte-identical code paths (same kernels, same jit cache entries).
FLAT_LIMIT = 32

# default panel width when config.panel_n is None.
DEFAULT_PANEL_N = 8


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


def resolve_tiles(config, caps):
    """Resolve ``(tile_m, panel_n)``: explicit config values win, else the
    backend's row capacity and `DEFAULT_PANEL_N`."""
    tile_m = config.tile_m if config.tile_m is not None else caps.max_shape[0]
    panel_n = config.panel_n if config.panel_n is not None else DEFAULT_PANEL_N
    return tile_m, panel_n


def _leaf_qr_fn(config, panel_n):
    """The batched small-QR primitive both tiled routes are built from:
    ``qr(X, compute_q) -> (Q, R)`` on the panel route of the configured
    backend (full-shape factors, `repro_torch.core.qrd._split_qr`
    contract): packed words for ``cordic_pallas``, int32 block-FP
    significands otherwise."""
    from repro_torch.core import qrd as _q
    from repro_torch.core.givens import GivensUnit

    if config.backend == "cordic_pallas":
        unit = GivensUnit(config.givens)

        def qr(X, cq):
            return _q.qr_cordic_panel(X, unit, compute_q=cq, panel_n=panel_n,
                                      tile_b=config.tile_b)
        return qr

    iters, hub, frac = (config.blockfp_iters(), config.blockfp_hub(),
                        config.frac)

    def qr(X, cq):
        return _q.qr_blockfp_panel(X, compute_q=cq, iters=iters, hub=hub,
                                   frac=frac, panel_n=panel_n,
                                   tile_b=config.tile_b)
    return qr


def build_tiled(route, config, m, n, compute_q, caps):
    """Builder for the tiled routes — same contract as a registry builder
    (``(A) -> (Q, R)``), selected by `resolve_route`.

    ``route='panel'`` returns full factors like the flat route
    (``Q (m, m), R (m, n)``); ``route='tsqr'`` returns the economy
    factors (``Q (m, n), R (n, n)``).
    """
    tile_m, panel_n = resolve_tiles(config, caps)
    qr = _leaf_qr_fn(config, panel_n)
    if route == "panel":
        return lambda A: qr(A, compute_q)
    if route != "tsqr":
        raise ValueError(f"unknown tiled route {route!r}")
    return lambda A: _tsqr(A, leaf_qr=qr, tile_m=tile_m, compute_q=compute_q)


def _tsqr(A, *, leaf_qr, tile_m, compute_q):
    """TSQR binary tree reduction over batched tall-skinny operands.

    The tree plan (pairings, owner/side maps) is static numpy; only the
    node factorizations and the (n, n) compositions run on the device.
    Zero rows padding the last leaf ride through its factorization
    (columns of zeros rotate to zeros; the pad rows of Q are sliced off).
    R is produced entirely by the bit-exact rotation datapath and equals
    `tsqr_host_reference` bit for bit; Q is a float64 matrix product, equal
    to it within rounding (the summation order differs).
    """
    A = torch.as_tensor(A, dtype=torch.float64)
    m, n = A.shape[-2], A.shape[-1]
    batch = A.shape[:-2]
    Af = A.reshape((-1, m, n))
    B = Af.shape[0]
    L = -(-m // tile_m)
    pad = L * tile_m - m
    if pad:
        Af = torch.nn.functional.pad(Af, (0, 0, 0, pad))

    Qf, Rf = leaf_qr(Af.reshape(B * L, tile_m, n), compute_q)
    Rs = Rf[..., :n, :].reshape(B, L, n, n)
    if compute_q:
        Qleaf = Qf[..., :n].reshape(B, L, tile_m, n)   # economy leaf Q
        eye = torch.eye(n, dtype=Qleaf.dtype, device=Qleaf.device)
        comp = eye.expand(B, L, n, n)                  # per-leaf B factors

    owner = np.arange(L)        # which live R-slot each leaf feeds (static)
    cur = L
    while cur > 1:
        pairs, odd = cur // 2, cur % 2
        stack = torch.cat([Rs[:, 0:2 * pairs:2], Rs[:, 1:2 * pairs:2]],
                          dim=-2).reshape(B * pairs, 2 * n, n)
        Qn, Rn = leaf_qr(stack, compute_q)
        new_Rs = Rn[..., :n, :].reshape(B, pairs, n, n)
        if odd:                 # unpaired last node carries to the next level
            new_Rs = torch.cat([new_Rs, Rs[:, -1:]], dim=1)
        if compute_q:
            Qe = Qn[..., :n].reshape(B, pairs, 2 * n, n)
            # T-stack layout [top halves | bottom halves | I]; each leaf
            # selects its consumer node's half (or I when carried) by a
            # static index.
            T = torch.cat([Qe[:, :, :n, :], Qe[:, :, n:, :],
                           eye.expand(B, 1, n, n)], dim=1)
            sel = np.where(owner < 2 * pairs,
                           owner // 2 + (owner % 2) * pairs, 2 * pairs)
            comp = torch.einsum("blij,bljk->blik", comp,
                                T[:, torch.as_tensor(sel, device=T.device)])
        owner = np.where(owner < 2 * pairs, owner // 2, pairs)
        Rs, cur = new_Rs, pairs + odd

    R = Rs[:, 0].reshape(batch + (n, n))
    if not compute_q:
        return None, R
    Q = torch.einsum("blij,bljk->blik", Qleaf, comp)
    Q = Q.reshape(B, L * tile_m, n)[:, :m]
    return Q.reshape(batch + (m, n)), R


def tsqr_host_reference(A, node_qr, tile_m):
    """Host-loop TSQR oracle for the bit-exactness checks.

    Runs the *same* padded tree plan as `_tsqr` but factorizes every node
    one at a time through ``node_qr(X) -> (Q, R)`` (full-shape factors,
    e.g. `repro_torch.core.qrd.qr_cordic` or the flat kernel's
    `qr_cordic_pallas`), an execution path independent of the batched
    panel kernels that shares only the rotation ordering.  ``A`` is one
    (m, n) matrix; the work runs on its device.  Returns economy
    ``(Q (m, n), R (n, n))``: R compares bitwise against the tsqr route,
    Q to float64 rounding.
    """
    A = torch.as_tensor(A, dtype=torch.float64)
    m, n = A.shape
    L = -(-m // tile_m)
    Af = A.new_zeros((L * tile_m, n))
    Af[:m] = A
    Qs, Rs = [], []
    for leaf in range(L):
        Q, R = node_qr(Af[leaf * tile_m:(leaf + 1) * tile_m])
        Qs.append(Q[:, :n])
        Rs.append(R[:n, :])
    comp = [torch.eye(n, dtype=A.dtype, device=A.device) for _ in range(L)]
    owner = list(range(L))
    while len(Rs) > 1:
        pairs = len(Rs) // 2
        new_Rs, tops, bots = [], [], []
        for p in range(pairs):
            Q, R = node_qr(torch.cat([Rs[2 * p], Rs[2 * p + 1]]))
            Qe = Q[:, :n]
            new_Rs.append(R[:n, :])
            tops.append(Qe[:n])
            bots.append(Qe[n:])
        if len(Rs) % 2:
            new_Rs.append(Rs[-1])
        for leaf in range(L):
            o = owner[leaf]
            if o < 2 * pairs:
                half = tops[o // 2] if o % 2 == 0 else bots[o // 2]
                comp[leaf] = comp[leaf] @ half
                owner[leaf] = o // 2
            else:
                owner[leaf] = pairs
        Rs = new_Rs
    Q = torch.cat([Qs[leaf] @ comp[leaf] for leaf in range(L)])[:m]
    return Q, Rs[0]
