#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the main path from ``src/repro_torch/kernels/
csrc``, holds each against its plain PyTorch version on the card, drives
the three routes of ``QRDEngine(backend='cordic_pallas')`` and ``.solve``
at full width — flat (8192 x 32 x 32), panel (1024 x 64 x 64) and TSQR
(32 x 4096 x 32) — then the same routes of the int32 block-FP lane
``QRDEngine(backend='blockfp_pallas')`` and its streaming QRD-RLS
(``engine.rls``), checks the results, times the kernels with CUDA events,
and prints one JSON line describing each kernel followed by a final
``{"ok": true, "device": ...}`` line.  Any failed phase exits non-zero.
There is no CPU fallback: without a CUDA device the script fails.  It
imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.core.formats import HALF, SINGLE, pack_fields  # noqa: E402
from repro_torch.core.givens import GivensConfig, GivensUnit  # noqa: E402
from repro_torch.core.qrd import givens_schedule  # noqa: E402
from repro_torch.core.qrd import qr_blockfp_pallas, qr_cordic_pallas  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import qrd_blocked as qb  # noqa: E402
from repro_torch.qrd import QRDEngine, RLSState, SOLVE_TOLERANCES  # noqa: E402
from repro_torch.qrd.tiled import tsqr_host_reference  # noqa: E402

SEED = 0

#: Main-path shapes: a batch of 32 x 32 decompositions with Q, and a batch
#: of 32 x 16 least-squares problems with one right-hand side.
BATCH, M, N_COLS, N_SOLVE = 8192, 32, 32, 16

#: The tiled routes at full width, both with Q: a batch of 64 x 64 (auto
#: tiling picks the panel route, panel_n = 8) and a batch of 4096 x 32 (auto
#: picks TSQR with tile_m = 128: 32 leaves, 5 tree levels).
PANEL_BATCH, PANEL_M = 1024, 64
TSQR_BATCH, TSQR_M, TSQR_N, TSQR_TILE_M = 32, 4096, 32, 128
PANEL_N = 8

#: TSQR's factor limits on the packed lane, as the JAX package's own TSQR
#: test holds them, and the absolute limit on both lanes' TSQR solves
#: against a float64 least-squares solve.  That limit is borrowed from the
#: JAX package's cordic_pallas TSQR solve test
#: (tests/test_qrd_tiled.py::test_solve_routes_through_tsqr); the JAX
#: package sets no TSQR solve limit of its own for either lane, so the
#: relative error against each backend's SOLVE_TOLERANCES entry is printed
#: beside it, met or unmet.
TSQR_TOL = 1e-4

#: The flat kernel beyond shared memory: 128 x 128 with Q is a 128 x 256
#: int64 tile, 256 KiB a matrix, factorized in device memory.
BIG_BATCH, BIG_M = 132, 128

#: (m, n, compute_q) of the panel kernels' parity phase (panel widths 3
#: and 8 each).
PANEL_PARITY_SHAPES = ((12, 6, True), (20, 5, False))

COUNTERS = {"qr_packed": "QR_PACKED_LAUNCHES",
            "panel_factor_packed": "PANEL_FACTOR_LAUNCHES",
            "panel_apply_packed": "PANEL_APPLY_LAUNCHES",
            "qr_blockfp": "QR_BLOCKFP_LAUNCHES",
            "panel_factor_blockfp": "PANEL_FACTOR_BLOCKFP_LAUNCHES",
            "panel_apply_blockfp": "PANEL_APPLY_BLOCKFP_LAUNCHES"}

#: The panel kernels of each lane, and the bytes of one word.
LANES = {"packed": ("panel_factor_packed", "panel_apply_packed"),
         "blockfp": ("panel_factor_blockfp", "panel_apply_blockfp")}
WORD_BYTES = {"packed": 8, "blockfp": 4}

#: Accuracy limits of the main path: relative QR residual and loss of
#: orthogonality, per matrix (Frobenius norms); the unit's 26-bit
#: significand gives about 1e-6 at this size.
QR_TOL = 1e-5


def qr_tol(m):
    """`QR_TOL` at m = 32, growing in proportion to m.  The unit's own loss
    of orthogonality grows with m past 1e-5: the worst matrix of the panel
    path (IEEE, 64 x 64) reads 1.056e-5 and that of the 128 x 128 phase
    (HUB) 1.339e-5, and the JAX package reads the same on those matrices on
    the CPU (``tools/orth_witness.py``).  The linear law is a limit fitted
    to these readings, not a derived bound."""
    return QR_TOL * max(1, m / 32)


#: Integer instruction rate of an H100 SXM: each SM issues at most 4 warp
#: instructions (4 x 32 thread operations) per clock, x 132 SMs x 1.98 GHz
#: boost clock (Hopper architecture white paper).  Integer work issues on
#: both the INT32 and the FMA pipes (IMAD, moves), so the 64 INT32 lanes per
#: SM are not its ceiling: the panel apply kernel ran faster than a bound
#: taken from them.  And the HBM3 bandwidth.
INT_OPS_PER_S = 4 * 32 * 132 * 1.98e9
HBM_BYTES_PER_S = 3.35e12

#: Operation count of the packed datapath, per rotated element per
#: rotation: 8 per micro-rotation, 12 for the gain multiply, 80 for the two
#: converters, times 2 for 64-bit words on 32-bit ALUs.
OPS_PER_MICROROTATION, OPS_GAIN, OPS_CONVERT, INT64_WORD_FACTOR = 8, 12, 80, 2

#: Operation count of the int32 block-FP datapath (csrc/blockfp_unit.cuh),
#: per rotated element per rotation: per micro-rotation the shift, the
#: direction bit, the add and the select, and with HUB the carry bit (shift
#: and mask), the inversion and the carry-in add; 12 for the Q30 gain
#: multiply (4 products, 5 shifts and masks, 3 adds); 2 for the flip.
OPS_BFP_MICROROTATION = {True: 9, False: 4}
OPS_BFP_GAIN, OPS_BFP_FLIP = 12, 2

#: The block-FP lane's limits, the JAX package's own: mean SNR of QR
#: against A and loss of orthogonality (tests/test_qrd_blocked.py), and
#: the solve's SOLVE_TOLERANCES entry.
BFP_SNR_DB, BFP_ORTH_TOL = 90.0, 1e-4

#: Streaming QRD-RLS: the adaptive beamformer of
#: examples/adaptive_beamforming.py (8 antennas, 200 snapshots, lambda
#: 0.99), blocks of 4 snapshots per kernel launch; its weights against
#: float mode as the JAX package's block-mode test holds them.
N_ANT, SNAPSHOTS, LAMBDA, RLS_BLOCK, RLS_TOL = 8, 200, 0.99, 4, 5e-3


def parity_configs():
    """The four datapath variants in SINGLE (N=26) and HALF (N=13, 11 iters)."""
    variants = (dict(input_rounding="trunc"), dict(input_rounding="rne"),
                dict(hub=True), dict(hub=True, unbiased=False,
                                     detect_identity=False))
    return [GivensConfig(fmt=fmt, n=n, iters=iters, **v)
            for fmt, n, iters in ((SINGLE, 26, None), (HALF, 13, 11))
            for v in variants]


#: (m, n, compute_q) of the parity phase.
PARITY_SHAPES = ((4, 4, True), (6, 3, True), (3, 5, False), (16, 16, True),
                 (32, 32, True))


def edge_words(cfg: GivensConfig, B, m, e, rng, device):
    """Packed words at the datapath's edges: random exponents over the whole
    range, exponent gaps of N+1, N+2, 64 and more against the lead of
    column 0, zeros, exact 1.0 and the largest exponent of both signs."""
    fmt = cfg.fmt
    exp = rng.integers(1, fmt.max_exp_raw + 1, size=(B, m, e))
    man = rng.integers(0, 1 << fmt.man_bits, size=(B, m, e))
    sign = rng.integers(0, 2, size=(B, m, e))
    for r, gap in enumerate((cfg.n + 1, cfg.n + 2, 64, 200), start=1):
        if r < m:
            exp[:, r, 0] = np.clip(exp[:, 0, 0] - gap, 1, None)
    exp[:, :, -1] = 0
    exp[:, 0, min(1, e - 1)] = fmt.bias
    man[:, 0, min(1, e - 1)] = 0
    exp[:, -1, :] = fmt.max_exp_raw
    return pack_fields(*(torch.tensor(a, device=device) for a in (sign, exp, man)),
                       fmt)


def encoded_words(cfg: GivensConfig, B, m, n, compute_q, rng, device):
    """Packed words of random [A | I] working matrices of moderate range."""
    A = rng.normal(size=(B, m, n)) * np.exp2(rng.integers(-8, 8, size=(B, m, n)))
    if compute_q:
        A = np.concatenate([A, np.broadcast_to(np.eye(m), (B, m, m))], axis=-1)
    return GivensUnit(cfg).encode(torch.tensor(A, device=device))


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def reset_counts():
    for attr in COUNTERS.values():
        setattr(qb, attr, 0)


def read_counts():
    return {name: getattr(qb, attr) for name, attr in COUNTERS.items()}


def check_kernel(P, cfg, steps, tile_b=None):
    """Kernel against plain version on the same words: bit-equal or fail."""
    out = qb.qr_packed_call(P, cfg=cfg, steps=steps, tile_b=tile_b)
    ref = qb.qr_packed_reference(P, cfg=cfg, steps=steps)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        bad = (out != ref).nonzero()[0].tolist()
        fail(f"qr_packed differs from its plain version for {cfg} at "
             f"{tuple(P.shape)}, tile_b={tile_b}: first word {bad} "
             f"kernel {out[tuple(bad)].item():#x} plain {ref[tuple(bad)].item():#x}")


def parity_phase(device):
    rng = np.random.default_rng(SEED)
    n_cases = 0
    for cfg in parity_configs():
        for (m, n, cq) in PARITY_SHAPES:
            e = n + (m if cq else 0)
            steps = givens_schedule(m, n)
            for P in (encoded_words(cfg, 16, m, n, cq, rng, device),
                      edge_words(cfg, 16, m, e, rng, device)):
                check_kernel(P, cfg, steps)
                n_cases += 1
        # a ragged batch: 5 matrices in blocks of 4 (and 2)
        P = encoded_words(cfg, 5, 6, 4, True, rng, device)
        for tile_b in (4, 2):
            check_kernel(P, cfg, givens_schedule(6, 4), tile_b=tile_b)
            n_cases += 1
    print(f"parity: qr_packed bit-equal to qr_packed_reference on {n_cases} "
          f"cases ({len(parity_configs())} configs x shapes "
          f"{[s[:2] for s in PARITY_SHAPES]} random + edge words, ragged B=5)",
          flush=True)


def qr_errors(A, Q, R):
    """Largest relative residual |QR - A|/|A| and loss of orthogonality
    |QtQ - I| over the batch (Frobenius norms), and the index of the matrix
    with the largest loss of orthogonality."""
    eye = torch.eye(Q.shape[-1], dtype=A.dtype, device=A.device)
    fro = lambda X: torch.linalg.matrix_norm(X)  # noqa: E731
    resid = (fro(Q @ R - A) / fro(A)).max().item()
    orth = fro(Q.transpose(-1, -2) @ Q - eye)
    return resid, orth.max().item(), int(orth.argmax())


def panel_operand():
    """The panel path's batch of 64 x 64 matrices, from its seed."""
    return np.random.default_rng(SEED + 3).normal(
        size=(PANEL_BATCH, PANEL_M, PANEL_M))


def big_operand():
    """The batch of 128 x 128 matrices of the flat route beyond shared
    memory, from its seed."""
    return np.random.default_rng(SEED + 6).normal(size=(BIG_BATCH, BIG_M, BIG_M))


def tsqr_operands():
    """The TSQR paths' batch of 4096 x 32 matrices and right-hand sides,
    from their seed."""
    rng = np.random.default_rng(SEED + 4)
    return (rng.normal(size=(TSQR_BATCH, TSQR_M, TSQR_N)),
            rng.normal(size=(TSQR_BATCH, TSQR_M)))


def main_path(device):
    """The user's path at full width; returns launches and the operands."""
    rng = np.random.default_rng(SEED + 1)
    A = torch.tensor(rng.normal(size=(BATCH, M, N_COLS)), device=device)
    As = torch.tensor(rng.normal(size=(BATCH, M, N_SOLVE)), device=device)
    b = torch.tensor(rng.normal(size=(BATCH, M)), device=device)
    hub = GivensConfig(hub=True, n=26)
    ieee = GivensConfig(n=26)
    engines = {name: QRDEngine(backend="cordic_pallas", dtype="float64",
                               givens=g, device=device)
               for name, g in (("hub", hub), ("ieee", ieee))}

    reset_counts()
    t0 = time.perf_counter()
    results = {name: eng(A) for name, eng in engines.items()}
    x = engines["hub"].solve(As, b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["qr_packed"]

    if launches < 3:
        fail(f"main path launched qr_packed {launches} times, expected 3")
    for name, (Q, R) in results.items():
        if not (torch.isfinite(Q).all() and torch.isfinite(R).all()):
            fail(f"{name}: non-finite factors")
        if Q.shape != (BATCH, M, M) or R.shape != (BATCH, M, N_COLS):
            fail(f"{name}: shapes {tuple(Q.shape)} {tuple(R.shape)}")
        if torch.count_nonzero(torch.tril(R, -1)).item() != 0:
            fail(f"{name}: R has non-zero entries below the diagonal")
        resid, orth, _ = qr_errors(A, Q, R)
        if not (resid <= QR_TOL and orth <= QR_TOL):
            fail(f"{name}: |QR-A|/|A| = {resid}, |QtQ-I| = {orth} (limit {QR_TOL})")
        print(f"main path {name}: Q {tuple(Q.shape)} R {tuple(R.shape)} "
              f"max |QR-A|/|A| = {resid:.3e}, max |QtQ-I| = {orth:.3e}", flush=True)
    ref = torch.linalg.lstsq(As, b[..., None]).solution[..., 0]
    sol_err = (torch.linalg.vector_norm(x - ref, dim=-1)
               / torch.linalg.vector_norm(ref, dim=-1)).max().item()
    tol = SOLVE_TOLERANCES["cordic_pallas"]
    if not (x.shape == (BATCH, N_SOLVE) and torch.isfinite(x).all() and sol_err <= tol):
        fail(f"solve: relative error {sol_err} (limit {tol}), shape {tuple(x.shape)}")
    print(f"main path solve: x {tuple(x.shape)} max |x-x_lstsq|/|x_lstsq| = "
          f"{sol_err:.3e} (limit {tol})", flush=True)
    print(f"main path: launches {counts}, {wall:.3f} s wall "
          f"(first calls, build excluded)", flush=True)
    return launches, A, As, b, hub


def _event_ms(fn, repeats):
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def active_elements(m, n, e):
    return sum((m - 1 - c) * 2 * (e - c) for c in range(min(m - 1, n)))


def _bound(cfg, elements, nbytes):
    """Least time for the work: int64 operations, as 32-bit instructions,
    over the SM's issue rate, against the bytes moved at HBM bandwidth."""
    per_elem = (OPS_PER_MICROROTATION * cfg.resolved_iters() + OPS_GAIN
                + OPS_CONVERT) * INT64_WORD_FACTOR
    ops_ms = elements * per_elem / INT_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def bound(cfg, B, m, n, e):
    """The flat kernel's bound: its rotated elements, two passes over the
    tile."""
    return _bound(cfg, B * active_elements(m, n, e), 2 * B * m * e * 8)


def panel_route_work(B, m, n, e, pw=PANEL_N, lane="packed"):
    """Launches, rotated elements and bytes of each panel kernel of
    ``lane`` in one panel-route call on B working tiles of m x e (n columns
    annihilated).  Bytes: each input word read once and each output word
    written once (the panel or trailing region both ways, the (B, S)
    control words)."""
    factor, apply_ = LANES[lane]
    wb = WORD_BYTES[lane]
    work = {name: dict(launches=0, elements=0, bytes=0)
            for name in (factor, apply_)}
    for c0 in range(0, min(n, m - 1), pw):
        nc, mr = min(pw, n - c0), m - c0
        w = e - c0 - nc
        cols = range(min(mr - 1, nc))
        S = sum(mr - 1 - c for c in cols)
        f = work[factor]
        f["launches"] += 1
        f["elements"] += B * sum((mr - 1 - c) * 2 * (nc - c) for c in cols)
        f["bytes"] += B * (2 * mr * nc + 2 * S) * wb
        if w > 0:
            a = work[apply_]
            a["launches"] += 1
            a["elements"] += B * S * 2 * w
            a["bytes"] += B * (2 * mr * w + 2 * S) * wb
    return work


def tsqr_work(B, m, n, tile_m, compute_q, lane="packed"):
    """`panel_route_work` summed over a TSQR call: the leaves, then one
    batch of stacked (2n, n) R pairs per tree level."""
    L = -(-m // tile_m)
    parts = [panel_route_work(B * L, tile_m, n, n + (tile_m if compute_q else 0),
                              lane=lane)]
    cur = L
    while cur > 1:
        pairs = cur // 2
        parts.append(panel_route_work(B * pairs, 2 * n, n,
                                      n + (2 * n if compute_q else 0),
                                      lane=lane))
        cur = pairs + cur % 2
    return {name: {key: sum(p[name][key] for p in parts)
                   for key in parts[0][name]} for name in parts[0]}


def compare(what, got, want):
    """Bit-equality of two int64 tensors (or tuples of them), or fail."""
    if torch.is_tensor(got):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        if g.shape != w.shape:
            fail(f"{what}: shapes {tuple(g.shape)} and {tuple(w.shape)}")
        if not torch.equal(g, w):
            bad = tuple((g != w).nonzero()[0].tolist())
            fail(f"{what}: first differing word {bad}: "
                 f"kernel {g[bad].item():#x} plain {w[bad].item():#x}")


def check_panel_sweep(P, cfg, n_cols, pw, tile_b=None):
    """The panel route on the card with every launch held against its plain
    version on the same inputs, and the result against the flat kernel:
    bit-equal or fail."""
    m, e = P.shape[-2:]
    W = P.clone()
    what = f"{cfg} at {tuple(P.shape)}, pw={pw}, tile_b={tile_b}"
    for c0 in range(0, min(n_cols, m - 1), pw):
        nc = min(pw, n_cols - c0)
        piv, tgt, col = ops.panel_steps(m - c0, nc)
        tile = W[:, c0:, c0:c0 + nc]
        want = qb.panel_factor_packed_reference(tile, piv, tgt, col, cfg=cfg)
        got = qb.panel_factor_packed_call(tile, piv, tgt, col, cfg=cfg,
                                          tile_b=tile_b)
        compare(f"panel_factor_packed, {what}, panel {c0}", got, want)
        if c0 + nc < e:
            T = W[:, c0:, c0 + nc:]
            want = qb.panel_apply_packed_reference(T, piv, tgt, got[1], got[2],
                                                   cfg=cfg)
            qb.panel_apply_packed_call(T, piv, tgt, got[1], got[2], cfg=cfg)
            compare(f"panel_apply_packed, {what}, panel {c0}", T, want)
    flat = qb.qr_packed_call(P.contiguous(), cfg=cfg,
                             steps=givens_schedule(m, n_cols))
    compare(f"panel route against qr_packed, {what}", W, flat)


def panel_parity_phase(device):
    rng = np.random.default_rng(SEED + 2)
    n_cases = 0
    for cfg in parity_configs():
        for (m, n, cq) in PANEL_PARITY_SHAPES:
            e = n + (m if cq else 0)
            for P in (encoded_words(cfg, 16, m, n, cq, rng, device),
                      edge_words(cfg, 16, m, e, rng, device)):
                for pw in (3, 8):
                    check_panel_sweep(P, cfg, n, pw)
                    n_cases += 1
        # a ragged batch: 5 matrices in blocks of 4 (and 2)
        P = encoded_words(cfg, 5, 10, 4, True, rng, device)
        for tile_b in (4, 2):
            check_panel_sweep(P, cfg, 4, 3, tile_b=tile_b)
            n_cases += 1
    print(f"parity: panel_factor_packed and panel_apply_packed bit-equal to "
          f"their plain versions at every launch, and the panel route to "
          f"qr_packed, on {n_cases} cases ({len(parity_configs())} configs x "
          f"shapes {[s[:2] for s in PANEL_PARITY_SHAPES]} x panel widths 3, 8, "
          f"random + edge words, ragged B=5)", flush=True)


def _engine(device, g, **kw):
    return QRDEngine(backend="cordic_pallas", dtype="float64", givens=g,
                     device=device, **kw)


def flat_device_phase(device):
    """The flat kernel with its tile in device memory: bit-equal to its plain
    version at a small shape (forced by lowering the shared-memory limit),
    and to the panel route at 128 x 128 with Q, where it must be used."""
    rng = np.random.default_rng(SEED + 5)
    limit = qb.MAX_SHARED_BYTES
    qb.MAX_SHARED_BYTES = 0
    n_cases = 0
    for cfg in parity_configs():
        for P in (encoded_words(cfg, 5, 12, 6, True, rng, device),
                  edge_words(cfg, 5, 12, 18, rng, device)):
            check_kernel(P, cfg, givens_schedule(12, 6), tile_b=2)
            n_cases += 1
    qb.MAX_SHARED_BYTES = limit
    print(f"parity: qr_packed with the tile in device memory bit-equal to "
          f"qr_packed_reference on {n_cases} cases (12 x 6 with Q, ragged B=5 "
          f"in blocks of 2)", flush=True)

    g = GivensConfig(hub=True, n=26)
    A = torch.tensor(big_operand(), device=device)
    e = 2 * BIG_M
    if BIG_M * e * 8 <= qb.MAX_SHARED_BYTES:
        fail(f"{BIG_M} x {e} fits shared memory; the phase needs a larger tile")
    reset_counts()
    Qf, Rf = _engine(device, g, tiling="flat")(A)
    flat_counts = read_counts()
    Qp, Rp = _engine(device, g)(A)                    # auto -> panel
    panel_counts = {k: v - flat_counts[k] for k, v in read_counts().items()}
    torch.cuda.synchronize()
    if flat_counts["qr_packed"] != 1 or panel_counts["qr_packed"] != 0:
        fail(f"128 x 128: launches flat {flat_counts}, panel {panel_counts}")
    compare("flat (device-memory tile) against panel route, Q", Qf.view(torch.int64),
            Qp.view(torch.int64))
    compare("flat (device-memory tile) against panel route, R", Rf.view(torch.int64),
            Rp.view(torch.int64))
    resid, orth, worst = qr_errors(A, Qf, Rf)
    if not (resid <= qr_tol(BIG_M) and orth <= qr_tol(BIG_M)):
        fail(f"128 x 128: |QR-A|/|A| = {resid}, |QtQ-I| = {orth} "
             f"(limit {qr_tol(BIG_M)})")
    unit = GivensUnit(g)
    eye = torch.eye(BIG_M, dtype=torch.float64, device=device).expand(A.shape)
    P = unit.encode(torch.cat([A, eye], dim=-1)).contiguous()
    steps = givens_schedule(BIG_M, BIG_M)
    ms, _ = _event_ms(lambda: qb.qr_packed_call(P, cfg=g, steps=steps), 3)
    bound_ms, bound_by = bound(g, BIG_BATCH, BIG_M, BIG_M, e)
    print(f"flat route at {tuple(A.shape)} with Q: tile {BIG_M} x {e} int64 "
          f"({BIG_M * e * 8} B > {qb.MAX_SHARED_BYTES} B of shared memory) in "
          f"device memory; Q and R bit-equal to the panel route; max "
          f"|QR-A|/|A| = {resid:.3e}, |QtQ-I| = {orth:.3e} (matrix {worst}; limit "
          f"{qr_tol(BIG_M):.0e}); kernel {ms:.3f} ms "
          f"(median of 3), bound {bound_ms:.3f} ms ({bound_by})", flush=True)
    return dict(ms=ms, bound_ms=bound_ms, shape=[BIG_BATCH, BIG_M, e])


@contextlib.contextmanager
def wrapped_panel_kernels(wrap, lane="packed"):
    """Route the panel kernels' wrappers of ``lane`` through
    ``wrap(fn, name)`` inside the block (the panel loops look them up on
    `qb` at each call)."""
    attrs = {name: f"{name}_call" for name in LANES[lane]}
    orig = {name: getattr(qb, attr) for name, attr in attrs.items()}
    for name, attr in attrs.items():
        setattr(qb, attr, wrap(orig[name], name))
    yield
    for name, attr in attrs.items():
        setattr(qb, attr, orig[name])


def capture_first(store):
    """A `wrapped_panel_kernels` wrapper that keeps a copy of the arguments
    of each kernel's first launch (its inputs, before the in-place call)."""
    def wrap(fn, name):
        def call(*args, **kw):
            if name not in store:
                store[name] = ([a.clone() if torch.is_tensor(a) else a
                                for a in args], kw)
            return fn(*args, **kw)
        return call
    return wrap


def check_launches(path, counts, work):
    """The launches counted in one engine call against the route's plan."""
    want = {name: work[name]["launches"] if name in work else 0
            for name in counts}
    if counts != want:
        fail(f"{path}: launches {counts}, expected {want}")


def counted_call(fn, *args):
    """``fn(*args)`` with every count set to 0 just before and read just
    after; returns the result and the counts of that one call."""
    reset_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, read_counts()


def add_counts(*counts):
    return {name: sum(c[name] for c in counts) for name in COUNTERS}


def tiled_timing(path, eng, A, work, repeats=5, lane="packed"):
    """Each panel kernel's device time per engine call (CUDA events around
    every launch, summed), median of ``repeats`` warm calls; each call's
    launches, counted from its events, must match the route's plan
    ``work``."""
    events = []

    def timed(fn, name):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            events.append((name, start, end))
            return out
        return call

    totals = {name: [] for name in LANES[lane]}
    walls = []
    with wrapped_panel_kernels(timed, lane):
        eng(A)                                   # warm
        torch.cuda.synchronize()
        for _ in range(repeats):
            events.clear()
            t0 = time.perf_counter()
            _, counts = counted_call(eng, A)
            walls.append(time.perf_counter() - t0)
            check_launches(f"{path}, timed call", counts, work)
            timed_calls = {name: sum(n == name for n, _, _ in events)
                           for name in COUNTERS}
            if timed_calls != counts:
                fail(f"{path}: timed {timed_calls} launches, counted {counts}")
            for name in totals:
                totals[name].append(sum(s.elapsed_time(e)
                                        for n, s, e in events if n == name))
    ms = {name: statistics.median(v) for name, v in totals.items()}
    wall_ms = statistics.median(walls) * 1e3
    print(f"timing {path} at {tuple(A.shape)}: " + ", ".join(
        f"{name} {t:.3f} ms per engine call" for name, t in ms.items())
        + f"; engine call {wall_ms:.3f} ms host wall (median of {repeats})",
        flush=True)
    return ms, wall_ms


def plain_check(captured, cfg):
    """Each panel kernel against its plain version on the inputs of its first
    launch on a full-width path: bit-equal, with both timed."""
    out = {}
    unit = GivensUnit(cfg)
    for name, (args, kw) in captured.items():
        call = getattr(qb, f"{name}_call")
        reference = getattr(qb, f"{name}_reference")
        times = []
        for _ in range(5):
            x = args[0].clone()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            got = call(x, *args[1:], **kw)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        t0 = time.perf_counter()
        want = reference(*args, **{k: v for k, v in kw.items()
                                   if k != "tile_b"})
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        compare(f"{name} at its first full-width launch {tuple(args[0].shape)}",
                got, want)
        if isinstance(got, tuple):
            got, want = got[0], want[0]
        if got.dtype == torch.int64:
            err = (unit.decode(got) - unit.decode(want)).abs().max().item()
        else:                  # block-FP significands, in units of the LSB
            err = float((got - want).abs().max().item())
        out[name] = dict(kernel_ms=statistics.median(times), plain_ms=plain_ms,
                         max_abs_err=err, shape=list(args[0].shape))
        print(f"{name} at {tuple(args[0].shape)} ({len(args[1])} steps): "
              f"kernel {out[name]['kernel_ms']:.3f} ms, plain {plain_ms:.1f} ms, "
              f"bit-equal", flush=True)
    return out


def timing_phase(A, As, b, cfg):
    """Kernel and plain version at the main path's shapes, same words."""
    unit = GivensUnit(cfg)
    eye = torch.eye(M, dtype=torch.float64, device=A.device).expand(BATCH, M, M)
    P = unit.encode(torch.cat([A, eye], dim=-1)).contiguous()
    Ps = unit.encode(torch.cat([As, b[..., None]], dim=-1)).contiguous()
    steps = givens_schedule(M, N_COLS)
    qb.qr_packed_call(P, cfg=cfg, steps=steps)                 # warm
    ms, out = _event_ms(lambda: qb.qr_packed_call(P, cfg=cfg, steps=steps), 5)
    plain_ms, ref = _event_ms(lambda: qb.qr_packed_reference(P, cfg=cfg, steps=steps), 2)
    if not torch.equal(out, ref):
        fail("qr_packed differs from its plain version at the main-path shape")
    max_abs_err = (unit.decode(out) - unit.decode(ref)).abs().max().item()
    steps_s = givens_schedule(M, N_SOLVE + 1)
    check_kernel(Ps, cfg, steps_s)
    bound_ms, bound_by = bound(cfg, BATCH, M, N_COLS, M + N_COLS)
    print(f"timing at {tuple(P.shape)} int64, {len(steps)} steps: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by})", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=max_abs_err, shape=list(P.shape))


# ---------------------------------------------------------------------------
# The int32 block-FP lane: QRDEngine(backend='blockfp_pallas') and engine.rls
# ---------------------------------------------------------------------------
#: (hub, iters) of the block-FP parity phase.
BFP_CONFIGS = ((True, 24), (False, 24), (True, 30), (False, 30))

#: The block-FP lane's tiled limits, the JAX package's own for its panel
#: and TSQR routes (tests/test_qrd_tiled.py): max |QR - A| and max
#: |QtQ - I|, elementwise.
BFP_TILED_RESID, BFP_TILED_ORTH = 2e-3, 1e-3


def bfp_words(B, m, e, rng, device, edge=False):
    """int32 significands of B working tiles, random in [-2^24, 2^24]; with
    ``edge`` a column at +2^24 in every row (the largest amax), an all-zero
    column, a -2^24 corner and an all-zero tile."""
    X = rng.integers(-2 ** 24, 2 ** 24 + 1, size=(B, m, e))
    if edge:
        X[:, :, 0] = 2 ** 24
        X[:, :, e - 1] = 0
        X[:, -1, min(1, e - 1)] = -2 ** 24
        X[0] = 0
    return torch.tensor(X.astype(np.int32), device=device)


def check_bfp_flat(X, hub, iters, steps, tile_b=None):
    """B2 against its plain version on the same words: bit-equal or fail."""
    out = qb.qr_blockfp_call(X, iters=iters, hub=hub, steps=steps,
                             tile_b=tile_b)
    ref = qb.qr_blockfp_reference(X, iters=iters, hub=hub, steps=steps)
    torch.cuda.synchronize()
    compare(f"qr_blockfp hub={hub} iters={iters} at {tuple(X.shape)}, "
            f"tile_b={tile_b}", out, ref)
    return out


def check_bfp_panel_sweep(X, hub, iters, n_cols, pw, tile_b=None):
    """The block-FP panel route with every B4a/B4b launch held against its
    plain version, and the result against B2: bit-equal or fail."""
    m, e = X.shape[-2:]
    W = X.clone()
    what = f"hub={hub} iters={iters} at {tuple(X.shape)}, pw={pw}, tile_b={tile_b}"
    kw = dict(iters=iters, hub=hub)
    for c0 in range(0, min(n_cols, m - 1), pw):
        nc = min(pw, n_cols - c0)
        piv, tgt, col = ops.panel_steps(m - c0, nc)
        tile = W[:, c0:, c0:c0 + nc]
        want = qb.panel_factor_blockfp_reference(tile, piv, tgt, col, **kw)
        got = qb.panel_factor_blockfp_call(tile, piv, tgt, col, tile_b=tile_b,
                                           **kw)
        compare(f"panel_factor_blockfp, {what}, panel {c0}", got, want)
        if c0 + nc < e:
            T = W[:, c0:, c0 + nc:]
            want = qb.panel_apply_blockfp_reference(T, piv, tgt, got[1],
                                                    got[2], **kw)
            qb.panel_apply_blockfp_call(T, piv, tgt, got[1], got[2], **kw)
            compare(f"panel_apply_blockfp, {what}, panel {c0}", T, want)
    flat = qb.qr_blockfp_call(X.contiguous(), steps=givens_schedule(m, n_cols),
                              **kw)
    compare(f"block-FP panel route against qr_blockfp, {what}", W, flat)


def blockfp_parity_phase(device):
    """B2, B4a and B4b bit-equal to their plain versions: HUB and
    conventional, iters 24 and 30, random and edge significands, ragged
    batches, and B2 on the RLS block schedule."""
    rng = np.random.default_rng(SEED + 7)
    n_flat = n_panel = 0
    for hub, iters in BFP_CONFIGS:
        shapes = PARITY_SHAPES if iters == 24 else PARITY_SHAPES[:-1]
        for (m, n, cq) in shapes:
            e = n + (m if cq else 0)
            for edge in (False, True):
                check_bfp_flat(bfp_words(16, m, e, rng, device, edge), hub,
                               iters, givens_schedule(m, n))
                n_flat += 1
        X = bfp_words(5, 6, 10, rng, device)
        for tile_b in (4, 2):                 # a ragged batch of 5
            check_bfp_flat(X, hub, iters, givens_schedule(6, 4), tile_b)
            n_flat += 1
        for (m, n, cq) in PANEL_PARITY_SHAPES:
            e = n + (m if cq else 0)
            for edge in (False, True):
                X = bfp_words(16, m, e, rng, device, edge)
                for pw in (3, 8):
                    check_bfp_panel_sweep(X, hub, iters, n, pw)
                    n_panel += 1
        X = bfp_words(5, 10, 14, rng, device)
        for tile_b in (4, 2):
            check_bfp_panel_sweep(X, hub, iters, 4, 3, tile_b)
            n_panel += 1
    X = bfp_words(16, N_ANT + RLS_BLOCK, N_ANT + 1, rng, device)
    check_bfp_flat(X, True, 24, ops.rls_block_steps(N_ANT, RLS_BLOCK))
    n_flat += 1
    print(f"parity: qr_blockfp bit-equal to qr_blockfp_reference on {n_flat} "
          f"cases, panel_factor_blockfp and panel_apply_blockfp to theirs at "
          f"every launch of {n_panel} panel sweeps (each also equal to "
          f"qr_blockfp); (hub, iters) in {BFP_CONFIGS}, random + edge "
          f"significands, ragged B=5, RLS schedule "
          f"rls_block_steps({N_ANT}, {RLS_BLOCK})", flush=True)


def snr_db(A, Q, R):
    """The paper's error metric, as the JAX package's `snr_db` computes it:
    10 log10(|A|^2 / |A - QR|^2) per matrix (Frobenius norms)."""
    num = torch.sum(A * A, dim=(-2, -1))
    den = torch.sum((A - Q @ R) ** 2, dim=(-2, -1))
    return 10.0 * torch.log10(num / torch.clamp(den, min=1e-300))


def max_orth(Q):
    """Largest |QtQ - I| entry over the batch."""
    eye = torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)
    return (Q.transpose(-1, -2) @ Q - eye).abs().max().item()


def bfp_engine(device, hub=True, iters=24, **kw):
    return QRDEngine(backend="blockfp_pallas", dtype="float64",
                     givens=GivensConfig(hub=hub, n=26), hub=hub, iters=iters,
                     device=device, **kw)


def blockfp_flat_path(device, A, As, b):
    """QRDEngine(backend='blockfp_pallas') at the main path's shapes: Q, R
    and solve, on the flat kernel B2."""
    eng = bfp_engine(device)
    t0 = time.perf_counter()
    (Q, R), call_counts = counted_call(eng, A)
    x, solve_counts = counted_call(eng.solve, As, b)
    wall = time.perf_counter() - t0
    want = {name: 1 if name == "qr_blockfp" else 0 for name in COUNTERS}
    for what, counts in (("engine call", call_counts), ("solve", solve_counts)):
        if counts != want:
            fail(f"block-FP flat path, {what}: launches {counts}, expected {want}")
    if Q.shape != (BATCH, M, M) or R.shape != (BATCH, M, N_COLS):
        fail(f"block-FP flat: shapes {tuple(Q.shape)} {tuple(R.shape)}")
    if not (torch.isfinite(Q).all() and torch.isfinite(R).all()):
        fail("block-FP flat: non-finite factors")
    if torch.count_nonzero(torch.tril(R, -1)).item() != 0:
        fail("block-FP flat: R has non-zero entries below the diagonal")
    snr = snr_db(A, Q, R)
    orth = max_orth(Q)
    if not (snr.mean().item() > BFP_SNR_DB and orth < BFP_ORTH_TOL):
        fail(f"block-FP flat: mean SNR {snr.mean().item()} dB (limit > "
             f"{BFP_SNR_DB}), max |QtQ-I| {orth} (limit {BFP_ORTH_TOL})")
    ref = torch.linalg.lstsq(As, b[..., None]).solution[..., 0]
    sol_err = (torch.linalg.vector_norm(x - ref, dim=-1)
               / torch.linalg.vector_norm(ref, dim=-1)).max().item()
    tol = SOLVE_TOLERANCES["blockfp_pallas"]
    if not (x.shape == (BATCH, N_SOLVE) and torch.isfinite(x).all()
            and sol_err <= tol):
        fail(f"block-FP solve: relative error {sol_err} (limit {tol})")
    print(f"block-FP flat path: Q {tuple(Q.shape)} R {tuple(R.shape)} mean SNR "
          f"{snr.mean().item():.2f} dB (min {snr.min().item():.2f}; limit > "
          f"{BFP_SNR_DB}), max |QtQ-I| = {orth:.3e} (limit {BFP_ORTH_TOL}); "
          f"solve x {tuple(x.shape)} max |x-x_lstsq|/|x_lstsq| = {sol_err:.3e} "
          f"(limit {tol}); launches {call_counts} in the engine call and "
          f"{solve_counts} in the solve, each as planned; {wall:.3f} s wall "
          f"(first calls)", flush=True)
    return {"flat": call_counts["qr_blockfp"], "solve": solve_counts["qr_blockfp"]}


def blockfp_big_phase(device):
    """B2 at 128 x 128 with Q (a 128 x 256 int32 tile, 128 KiB of shared
    memory) against the block-FP panel route."""
    A = torch.tensor(big_operand(), device=device)
    (Qf, Rf), flat_counts = counted_call(bfp_engine(device, tiling="flat"), A)
    (Qp, Rp), panel_counts = counted_call(bfp_engine(device), A)  # auto -> panel
    if flat_counts["qr_blockfp"] != 1 or panel_counts["qr_blockfp"] != 0:
        fail(f"block-FP 128 x 128: launches flat {flat_counts}, panel "
             f"{panel_counts}")
    compare("block-FP 128 x 128: flat against panel route, Q",
            Qf.view(torch.int64), Qp.view(torch.int64))
    compare("block-FP 128 x 128: flat against panel route, R",
            Rf.view(torch.int64), Rp.view(torch.int64))
    snr, orth = snr_db(A, Qf, Rf), max_orth(Qf)
    print(f"block-FP flat route at {tuple(A.shape)} with Q: tile {BIG_M} x "
          f"{2 * BIG_M} int32 ({BIG_M * 2 * BIG_M * 4} B of shared memory); Q "
          f"and R bit-equal to the panel route; mean SNR "
          f"{snr.mean().item():.2f} dB, max |QtQ-I| = {orth:.3e}", flush=True)


#: The two lanes of the tiled paths: the engine variants of the panel path
#: (their ``hub`` argument), the flat kernel that is the panel route's
#: reference and the TSQR host tree's node, and the backend whose
#: SOLVE_TOLERANCES entry the TSQR solve is read against.
PATH_LANES = {
    "packed": dict(label="", variants={"hub": True, "ieee": False},
                   flat="qr_packed", backend="cordic_pallas"),
    "blockfp": dict(label="block-FP ", variants={"hub": True, "conv": False},
                    flat="qr_blockfp", backend="blockfp_pallas"),
}


def lane_engine(lane, device, hub=True, **kw):
    """The lane's QRDEngine: N = 26, and iters 24 on the block-FP lane."""
    if lane == "packed":
        return _engine(device, GivensConfig(hub=hub, n=26), **kw)
    return bfp_engine(device, hub=hub, **kw)


def lane_node_qr(lane):
    """The lane's flat QR (HUB), the TSQR host tree's node factorization."""
    if lane == "packed":
        unit = GivensUnit(GivensConfig(hub=True, n=26))
        return lambda X: qr_cordic_pallas(X, unit)
    return lambda X: qr_blockfp_pallas(X, iters=24, hub=True)


def lane_errors(lane, route, A, Q, R):
    """A tiled route's factor errors against the lane's limits: per matrix
    on the packed lane (Frobenius norms; `qr_tol` on the panel route,
    `TSQR_TOL` through TSQR), elementwise on the block-FP lane, as the JAX
    package's tiled tests hold it.  Returns (within the limits, text)."""
    if lane == "packed":
        tol = qr_tol(PANEL_M) if route == "panel" else TSQR_TOL
        resid, orth, worst = qr_errors(A, Q, R)
        return (resid <= tol and orth <= tol,
                f"max |QR-A|/|A| = {resid:.3e}, max |QtQ-I| = {orth:.3e} "
                f"(matrix {worst}; limit {tol:.0e}; {QR_TOL:.0e} at 32 x 32)")
    resid, orth = (Q @ R - A).abs().max().item(), max_orth(Q)
    return (resid < BFP_TILED_RESID and orth < BFP_TILED_ORTH,
            f"mean SNR {snr_db(A, Q, R).mean().item():.2f} dB, max |QR-A| = "
            f"{resid:.3e} (limit {BFP_TILED_RESID}), max |QtQ-I| = {orth:.3e} "
            f"(limit {BFP_TILED_ORTH})")


def flat_kernel_ms(lane, A):
    """The lane's flat kernel on the HUB words of [A | I], warm, median of
    5: the flat kernel's time beside the panel kernels' on one batch."""
    m, n = A.shape[-2:]
    eye = torch.eye(m, dtype=torch.float64, device=A.device).expand(
        *A.shape[:-1], m)
    W = torch.cat([A, eye], dim=-1)
    steps = givens_schedule(m, n)
    if lane == "packed":
        g = GivensConfig(hub=True, n=26)
        P = GivensUnit(g).encode(W).contiguous()
        call = lambda: qb.qr_packed_call(P, cfg=g, steps=steps)  # noqa: E731
    else:
        P = ops._blockfp_encode(W, 24)[0].contiguous()
        call = lambda: qb.qr_blockfp_call(P, iters=24, hub=True,  # noqa: E731
                                          steps=steps)
    call()                                                        # warm
    ms, _ = _event_ms(call, 5)
    return ms, list(P.shape)


def panel_path(device, lane):
    """auto -> panel at full width with Q, both datapaths of ``lane``,
    against the lane's flat route on the same batch."""
    spec = PATH_LANES[lane]
    label = spec["label"]
    A = torch.tensor(panel_operand(), device=device)
    engines = {name: lane_engine(lane, device, hub=hub)
               for name, hub in spec["variants"].items()}
    work = panel_route_work(PANEL_BATCH, PANEL_M, PANEL_M, 2 * PANEL_M,
                            lane=lane)
    captured, results, per_call = {}, {}, {}
    with wrapped_panel_kernels(capture_first(captured), lane):
        t0 = time.perf_counter()
        for name, eng in engines.items():
            results[name], per_call[name] = counted_call(eng, A)
            check_launches(f"{label}panel path {name}", per_call[name], work)
        wall = time.perf_counter() - t0
    for name, (Q, R) in results.items():
        if Q.shape != (PANEL_BATCH, PANEL_M, PANEL_M) or R.shape != Q.shape:
            fail(f"{label}panel {name}: shapes {tuple(Q.shape)} {tuple(R.shape)}")
        if torch.count_nonzero(torch.tril(R, -1)).item() != 0:
            fail(f"{label}panel {name}: R has non-zero entries below the "
                 f"diagonal")
        Qf, Rf = lane_engine(lane, device, hub=spec["variants"][name],
                             tiling="flat")(A)
        compare(f"{label}panel {name}: Q against the flat route",
                Q.view(torch.int64), Qf.view(torch.int64))
        compare(f"{label}panel {name}: R against the flat route",
                R.view(torch.int64), Rf.view(torch.int64))
        ok, text = lane_errors(lane, "panel", A, Q, R)
        if not ok:
            fail(f"{label}panel {name}: {text}")
        print(f"{label}panel path {name}: Q {tuple(Q.shape)} R "
              f"{tuple(R.shape)} bit-equal to the flat route; {text}",
              flush=True)
    print(f"{label}panel path: launches per engine call {per_call}, each as "
          f"planned; {wall:.3f} s wall (first calls)", flush=True)
    flat_ms, flat_shape = flat_kernel_ms(lane, A)
    print(f"flat kernel {spec['flat']} on the same hub batch "
          f"{tuple(flat_shape)}: {flat_ms:.3f} ms (median of 5)", flush=True)
    return dict(counts=add_counts(*per_call.values()), per_call=per_call["hub"],
                captured=captured, A=A, engine=engines["hub"], work=work,
                flat_ms=flat_ms, flat_shape=flat_shape)


def tsqr_path(device, lane):
    """auto -> TSQR at full width with Q, and solve, against the host tree
    replay on the lane's flat kernel and a float64 least-squares solve."""
    spec = PATH_LANES[lane]
    label = spec["label"]
    A, b = (torch.tensor(a, device=device) for a in tsqr_operands())
    eng = lane_engine(lane, device)
    work = tsqr_work(TSQR_BATCH, TSQR_M, TSQR_N, TSQR_TILE_M, True, lane)
    solve_work = tsqr_work(TSQR_BATCH, TSQR_M, TSQR_N + 1, TSQR_TILE_M, False,
                           lane)
    captured = {}
    with wrapped_panel_kernels(capture_first(captured), lane):
        t0 = time.perf_counter()
        (Q, R), call_counts = counted_call(eng, A)
        check_launches(f"{label}tsqr path, engine call", call_counts, work)
        x, solve_counts = counted_call(eng.solve, A, b)
        check_launches(f"{label}tsqr path, solve", solve_counts, solve_work)
        wall = time.perf_counter() - t0
    if Q.shape != (TSQR_BATCH, TSQR_M, TSQR_N) or R.shape != (TSQR_BATCH, TSQR_N, TSQR_N):
        fail(f"{label}tsqr: shapes {tuple(Q.shape)} {tuple(R.shape)}")
    if not (torch.isfinite(Q).all() and torch.isfinite(R).all()):
        fail(f"{label}tsqr: non-finite factors")
    if torch.count_nonzero(torch.tril(R, -1)).item() != 0:
        fail(f"{label}tsqr: R has non-zero entries below the diagonal")
    node_qr = lane_node_qr(lane)
    q_diff = 0.0
    for i in (0, TSQR_BATCH - 1):
        Qr, Rr = tsqr_host_reference(A[i], node_qr, TSQR_TILE_M)
        compare(f"{label}tsqr: R of matrix {i} against the host tree on "
                f"{spec['flat']}", R[i].view(torch.int64), Rr.view(torch.int64))
        q_diff = max(q_diff, (Q[i] - Qr).abs().max().item())
    if not q_diff <= 1e-12:
        fail(f"{label}tsqr: Q differs from the host tree by {q_diff} "
             f"(limit 1e-12)")
    ok, text = lane_errors(lane, "tsqr", A, Q, R)
    if not ok:
        fail(f"{label}tsqr: {text}")
    ref = torch.linalg.lstsq(A, b[..., None]).solution[..., 0]
    abs_err = (x - ref).abs().max().item()
    rel = (torch.linalg.vector_norm(x - ref, dim=-1)
           / torch.linalg.vector_norm(ref, dim=-1))
    if not (x.shape == (TSQR_BATCH, TSQR_N) and torch.isfinite(x).all()
            and abs_err <= TSQR_TOL):
        fail(f"{label}tsqr solve: max |x - x_lstsq| = {abs_err} (limit "
             f"{TSQR_TOL})")
    tol = SOLVE_TOLERANCES[spec["backend"]]
    rel_max = rel.max().item()
    print(f"{label}tsqr path: Q {tuple(Q.shape)} R {tuple(R.shape)}; R "
          f"bit-equal to the host tree on {spec['flat']} for matrices 0 and "
          f"{TSQR_BATCH - 1}, Q within {q_diff:.3e}; {text}", flush=True)
    print(f"{label}tsqr solve: x {tuple(x.shape)} max |x-x_lstsq| = "
          f"{abs_err:.3e} (limit {TSQR_TOL}, borrowed from the JAX package's "
          f"cordic_pallas TSQR solve test); max |x-x_lstsq|/|x_lstsq| = "
          f"{rel_max:.3e} (matrix {int(rel.argmax())}) against "
          f"SOLVE_TOLERANCES['{spec['backend']}'] = {tol}: "
          f"{'met' if rel_max <= tol else 'UNMET (reported, not gated)'}",
          flush=True)
    print(f"{label}tsqr path: launches {call_counts} in the engine call and "
          f"{solve_counts} in the solve, each as planned; {wall:.3f} s wall "
          f"(first calls)", flush=True)
    return dict(counts=add_counts(call_counts, solve_counts),
                per_call=call_counts, captured=captured, A=A, engine=eng,
                work=work)


def rls_phase(device):
    """engine.rls at the beamformer's size: the carried state on the card
    bit-equal to the same state on the CPU, and its weights near float
    mode's."""
    rng = np.random.default_rng(SEED + 8)
    w_true = rng.normal(size=N_ANT)
    xs = rng.normal(size=(SNAPSHOTS, N_ANT))
    ds = xs @ w_true + 0.01 * rng.normal(size=SNAPSHOTS)
    states = {where: QRDEngine(backend="blockfp_pallas", dtype="float64",
                               givens=GivensConfig(hub=True, n=26),
                               device=where).rls(N_ANT, lam=LAMBDA)
              for where in (device, "cpu")}
    reset_counts()
    t0 = time.perf_counter()
    for x, d in zip(xs, ds):
        states[device].update(x, d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    for x, d in zip(xs, ds):
        states["cpu"].update(x, d)
    flushes = SNAPSHOTS // RLS_BLOCK
    want = {name: flushes if name == "qr_blockfp" else 0 for name in COUNTERS}
    if counts != want:
        fail(f"rls: launches {counts}, expected {want} ({flushes} flushes)")
    gpu, cpu = states[device], states["cpu"]
    if gpu._pending or gpu.block != RLS_BLOCK or gpu.mode != "block":
        fail(f"rls: mode {gpu.mode}, block {gpu.block}, {len(gpu._pending)} pending")
    compare("rls: R on the card against the CPU", gpu.R.cpu().view(torch.int64),
            cpu.R.view(torch.int64))
    compare("rls: z on the card against the CPU", gpu.z.cpu().view(torch.int64),
            cpu.z.view(torch.int64))
    w_gpu, w_cpu = gpu.weights().cpu(), cpu.weights()
    w_diff = (w_gpu - w_cpu).abs().max().item()
    flt = RLSState(N_ANT, lam=LAMBDA, mode="float", device="cpu")
    for x, d in zip(xs, ds):
        flt.update(x, d)
    f_diff = (w_gpu - flt.weights()).abs().max().item()
    err = np.linalg.norm(w_gpu.numpy() - w_true)
    if not (w_diff <= 1e-12 and f_diff <= RLS_TOL):
        fail(f"rls: weights card vs CPU {w_diff} (limit 1e-12), vs float mode "
             f"{f_diff} (limit {RLS_TOL})")
    print(f"rls: engine.rls({N_ANT}, lam={LAMBDA}) block {RLS_BLOCK}, "
          f"{SNAPSHOTS} snapshots: R and z on the card bit-equal to the CPU "
          f"state; weights within {w_diff:.3e} of the CPU's (limit 1e-12) and "
          f"{f_diff:.3e} of float mode's (limit {RLS_TOL}); |w - w_true| = "
          f"{err:.3e}; {counts['qr_blockfp']} qr_blockfp launches for "
          f"{flushes} flushes; {wall:.3f} s wall on the card", flush=True)
    return counts["qr_blockfp"]


def bfp_bound(hub, iters, elements, nbytes):
    """Least time for block-FP work: int32 operations over the SM's issue
    rate, against the bytes moved at HBM bandwidth."""
    per_elem = OPS_BFP_MICROROTATION[hub] * iters + OPS_BFP_GAIN + OPS_BFP_FLIP
    ops_ms = elements * per_elem / INT_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def blockfp_timing_phase(A):
    """B2 and its plain version at the main path's shape, same words."""
    eye = torch.eye(M, dtype=torch.float64, device=A.device).expand(BATCH, M, M)
    X, _ = ops._blockfp_encode(torch.cat([A, eye], dim=-1), 24)
    X = X.contiguous()
    steps = givens_schedule(M, N_COLS)
    kw = dict(iters=24, hub=True, steps=steps)
    qb.qr_blockfp_call(X, **kw)                                    # warm
    ms, out = _event_ms(lambda: qb.qr_blockfp_call(X, **kw), 5)
    plain_ms, ref = _event_ms(lambda: qb.qr_blockfp_reference(X, **kw), 1)
    compare("qr_blockfp at the main-path shape", out, ref)
    e = M + N_COLS
    bound_ms, bound_by = bfp_bound(True, 24, BATCH * active_elements(M, N_COLS, e),
                                   2 * BATCH * M * e * 4)
    print(f"timing qr_blockfp at {tuple(X.shape)} int32, {len(steps)} steps: "
          f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by})", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=float((out - ref).abs().max().item()),
                shape=list(X.shape))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)

    return run(device)


def run(device):
    """Every phase on ``device``; returns 0 or exits non-zero."""
    t0 = time.perf_counter()
    sources = ["qr_packed", "panel_packed", "blockfp"]
    _build.build(sources)                      # one nvcc each, in parallel
    print(f"build: {', '.join(s + '.cu' for s in sources)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in sources:
        info = _build.BUILD_INFO.get(name, {})
        print(f"ptxas {name}: {' | '.join(info.get('ptxas', []))}", flush=True)

    parity_phase(device)
    panel_parity_phase(device)
    big = flat_device_phase(device)
    launches, A, As, b, cfg = main_path(device)
    timing = timing_phase(A, As, b, cfg)
    panel = panel_path(device, "packed")
    tsqr = tsqr_path(device, "packed")
    panel_ms, panel_wall = tiled_timing("panel path", panel["engine"],
                                        panel["A"], panel["work"])
    tsqr_ms, tsqr_wall = tiled_timing("tsqr path", tsqr["engine"], tsqr["A"],
                                      tsqr["work"])
    plain = {"panel": plain_check(panel["captured"], cfg),
             "tsqr": plain_check(tsqr["captured"], cfg)}

    blockfp_parity_phase(device)
    bfp_flat = blockfp_flat_path(device, A, As, b)
    bfp_timing = blockfp_timing_phase(A)
    blockfp_big_phase(device)
    bfp_panel = panel_path(device, "blockfp")
    bfp_tsqr = tsqr_path(device, "blockfp")
    bfp_rls_launches = rls_phase(device)
    bfp_panel_ms, bfp_panel_wall = tiled_timing(
        "block-FP panel path", bfp_panel["engine"], bfp_panel["A"],
        bfp_panel["work"], lane="blockfp")
    bfp_tsqr_ms, bfp_tsqr_wall = tiled_timing(
        "block-FP tsqr path", bfp_tsqr["engine"], bfp_tsqr["A"],
        bfp_tsqr["work"], lane="blockfp")
    bfp_plain = plain_check(bfp_panel["captured"], cfg)

    kernels = [{
        "name": "qr_packed",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/qr_packed.cu",
        "replaces": "src/repro/kernels/qrd_blocked.py:171",
        "replaces_function": "qr_packed_call / _qr_packed_kernel",
        "launches": launches,
        "parity": "bit-equal",
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
        "shape": timing["shape"],
        "config": "hub n=26 iters=24",
        "panel_shape_ms": panel["flat_ms"],
        "panel_shape": panel["flat_shape"],
        "device_tile_ms": big["ms"],
        "device_tile_bound_ms": big["bound_ms"],
        "device_tile_shape": big["shape"],
    }]
    replaces = {"panel_factor_packed": ("src/repro/kernels/qrd_blocked.py:764",
                                        "panel_factor_packed_call / "
                                        "_panel_factor_packed_kernel"),
                "panel_apply_packed": ("src/repro/kernels/qrd_blocked.py:837",
                                       "panel_apply_packed_call / "
                                       "_panel_apply_packed_kernel")}
    for name, (where, function) in replaces.items():
        bound_ms, bound_by = _bound(cfg, panel["work"][name]["elements"],
                                    panel["work"][name]["bytes"])
        tsqr_bound_ms, _ = _bound(cfg, tsqr["work"][name]["elements"],
                                  tsqr["work"][name]["bytes"])
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/panel_packed.cu",
            "replaces": where,
            "replaces_function": function,
            "launches": panel["counts"][name] + tsqr["counts"][name],
            "launches_by_path": {"panel": panel["counts"][name],
                                 "tsqr": tsqr["counts"][name]},
            "launches_per_engine_call": {"panel": panel["per_call"][name],
                                         "tsqr": tsqr["per_call"][name]},
            "parity": "bit-equal",
            "max_abs_err": max(plain[p][name]["max_abs_err"] for p in plain),
            "ms": panel_ms[name],
            "plain_ms": plain["panel"][name]["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "shape": [PANEL_BATCH, PANEL_M, PANEL_M],
            "ms_is": "kernel total per engine call, panel path, median of 5",
            "plain_ms_is": "one launch, the first of the panel path",
            "plain_shape": plain["panel"][name]["shape"],
            "kernel_ms_same_launch": plain["panel"][name]["kernel_ms"],
            "tsqr_ms": tsqr_ms[name],
            "tsqr_bound_ms": tsqr_bound_ms,
            "tsqr_shape": [TSQR_BATCH, TSQR_M, TSQR_N],
            "tsqr_plain_ms": plain["tsqr"][name]["plain_ms"],
            "tsqr_plain_shape": plain["tsqr"][name]["shape"],
            "tsqr_kernel_ms_same_launch": plain["tsqr"][name]["kernel_ms"],
            "config": "hub n=26 iters=24",
        })
    kernels.append({
        "name": "qr_blockfp",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/blockfp.cu",
        "replaces": "src/repro/kernels/qrd_blocked.py:668",
        "replaces_function": "qr_blockfp_call / _qr_blockfp_kernel",
        "launches": bfp_flat["flat"] + bfp_flat["solve"],
        "launches_by_path": {"flat": bfp_flat["flat"] + bfp_flat["solve"],
                             "rls": bfp_rls_launches},
        "launches_per_engine_call": {
            "flat": bfp_flat["flat"], "solve": bfp_flat["solve"],
            "rls_flush": bfp_rls_launches / (SNAPSHOTS // RLS_BLOCK)},
        "parity": "bit-equal",
        "max_abs_err": bfp_timing["max_abs_err"],
        "ms": bfp_timing["ms"],
        "plain_ms": bfp_timing["plain_ms"],
        "bound_ms": bfp_timing["bound_ms"],
        "bound_by": bfp_timing["bound_by"],
        "library_ms": None,
        "shape": bfp_timing["shape"],
        "config": "hub iters=24 frac=24",
        "packed_lane_ms_same_shape": timing["ms"],
        "panel_shape_ms": bfp_panel["flat_ms"],
        "panel_shape": bfp_panel["flat_shape"],
        "packed_lane_panel_shape_ms": panel["flat_ms"],
    })
    bfp_replaces = {"panel_factor_blockfp": ("src/repro/kernels/qrd_blocked.py:917",
                                             "panel_factor_blockfp_call / "
                                             "_panel_factor_blockfp_kernel",
                                             "panel_factor_packed"),
                    "panel_apply_blockfp": ("src/repro/kernels/qrd_blocked.py:968",
                                            "panel_apply_blockfp_call / "
                                            "_panel_apply_blockfp_kernel",
                                            "panel_apply_packed")}
    for name, (where, function, twin) in bfp_replaces.items():
        bound_ms, bound_by = bfp_bound(True, 24, bfp_panel["work"][name]["elements"],
                                       bfp_panel["work"][name]["bytes"])
        tsqr_bound_ms, _ = bfp_bound(True, 24, bfp_tsqr["work"][name]["elements"],
                                     bfp_tsqr["work"][name]["bytes"])
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/blockfp.cu",
            "replaces": where,
            "replaces_function": function,
            "launches": bfp_panel["counts"][name] + bfp_tsqr["counts"][name],
            "launches_by_path": {"panel": bfp_panel["counts"][name],
                                 "tsqr": bfp_tsqr["counts"][name]},
            "launches_per_engine_call": {"panel": bfp_panel["per_call"][name],
                                         "tsqr": bfp_tsqr["per_call"][name]},
            "parity": "bit-equal",
            "max_abs_err": bfp_plain[name]["max_abs_err"],
            "ms": bfp_panel_ms[name],
            "plain_ms": bfp_plain[name]["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "shape": [PANEL_BATCH, PANEL_M, PANEL_M],
            "ms_is": "kernel total per engine call, panel path, median of 5",
            "plain_ms_is": "one launch, the first of the panel path",
            "plain_shape": bfp_plain[name]["shape"],
            "kernel_ms_same_launch": bfp_plain[name]["kernel_ms"],
            "tsqr_ms": bfp_tsqr_ms[name],
            "tsqr_bound_ms": tsqr_bound_ms,
            "tsqr_shape": [TSQR_BATCH, TSQR_M, TSQR_N],
            "packed_lane_ms_same_shape": panel_ms[twin],
            "packed_lane_tsqr_ms": tsqr_ms[twin],
            "config": "hub iters=24 frac=24",
        })
    print(f"engine call host wall: panel path {panel_wall:.3f} ms, tsqr path "
          f"{tsqr_wall:.3f} ms; block-FP panel path {bfp_panel_wall:.3f} ms, "
          f"tsqr path {bfp_tsqr_wall:.3f} ms", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
