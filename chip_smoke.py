#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--block-grid]

Builds every CUDA kernel of the main path from ``src/repro_torch/kernels/
csrc``, holds each against its plain PyTorch version on the card, drives
the three routes of ``QRDEngine(backend='cordic_pallas')`` and ``.solve``
at full width — flat (8192 x 32 x 32), panel (1024 x 64 x 64) and TSQR
(32 x 4096 x 32) — then the same routes of the int32 block-FP lane
``QRDEngine(backend='blockfp_pallas')`` and its streaming QRD-RLS
(``engine.rls``), the TSQR route of both lanes at tile_m 4096 (whose
panels the panel factors hold in device memory), then the Sameh–Kuck
wavefront of both lanes (``schedule='sameh_kuck'``) and the complex
datapath (``dtype='complex128'``, both schedules, and the MIMO
detector's 4 x 4 solve), then
the dual-int32 lane route of the packed words (``ops.qr_packed`` and
``ops.qr_packed_wavefront`` with ``lanes=True``, against the engine's
int64 route), the standalone rotator's row API
(``givens_rotate_rows_fixed`` and ``_fused``) at 32 Mi elements, the three
baselines (``jnp``, ``givens_float``, ``fixed``) and
``examples/torch_quickstart.py``,
checks the results, times the kernels with CUDA events (the panel
kernels also by TSQR level, the block-FP ones also kernel only on their
captured launches, and every block-FP panel apply launch of the tiled
paths is held against its plain version on two matrices), and
prints one JSON line describing each kernel followed by a final
``{"ok": true, "device": ...}`` line.  Any failed phase exits non-zero.
There is no CPU fallback: without a CUDA device the script fails.  It
imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.core.formats import HALF, SINGLE, pack_fields, packed_is_zero  # noqa: E402
from repro_torch.core.givens import GivensConfig, GivensUnit  # noqa: E402
from repro_torch.core.qrd import givens_schedule, sameh_kuck_schedule  # noqa: E402
from repro_torch.core.qrd import _split_qr as split_qr  # noqa: E402
from repro_torch.core.qrd import snr_db as port_snr_db  # noqa: E402
from repro_torch.core.qrd import (qr_blockfp_panel, qr_blockfp_pallas,  # noqa: E402
                                  qr_cordic_complex_pallas,
                                  qr_cordic_pallas)
from repro_torch.kernels import _build, _launch, ops  # noqa: E402
from repro_torch.kernels import cordic_givens as cg  # noqa: E402
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

#: The TSQR route at tile_m 4096 on a small batch with Q: a leaf's
#: 4096-row panel exceeds a block's shared memory at the lane's panel width
#: (packed 4096 x 8 int64 words, block-FP 4096 x 16 int32 significands), so
#: the panel factors work on it in device memory (`qb._panel_tile`).
TALL_BATCH, TALL_M, TALL_N, TALL_TILE_M = 2, 8192, 32, 4096
TALL_PANEL_N = {"packed": 8, "blockfp": 16}

#: The flat kernel beyond shared memory: 128 x 128 with Q is a 128 x 256
#: int64 tile, 256 KiB a matrix, factorized in device memory.
BIG_BATCH, BIG_M = 132, 128

#: (m, n, compute_q) of the panel kernels' parity phase (panel widths 3
#: and 8 each).
PANEL_PARITY_SHAPES = ((12, 6, True), (20, 5, False))

#: Each kernel's launch counter: its wrapper module and attribute.
COUNTERS = {"qr_packed": (qb, "QR_PACKED_LAUNCHES"),
            "panel_factor_packed": (qb, "PANEL_FACTOR_LAUNCHES"),
            "panel_apply_packed": (qb, "PANEL_APPLY_LAUNCHES"),
            "qr_blockfp": (qb, "QR_BLOCKFP_LAUNCHES"),
            "panel_factor_blockfp": (qb, "PANEL_FACTOR_BLOCKFP_LAUNCHES"),
            "panel_apply_blockfp": (qb, "PANEL_APPLY_BLOCKFP_LAUNCHES"),
            "qr_packed_wavefront": (qb, "QR_PACKED_WAVEFRONT_LAUNCHES"),
            "qr_blockfp_wavefront": (qb, "QR_BLOCKFP_WAVEFRONT_LAUNCHES"),
            "qr_packed_complex": (qb, "QR_PACKED_COMPLEX_LAUNCHES"),
            "qr_packed_complex_wavefront": (
                qb, "QR_PACKED_COMPLEX_WAVEFRONT_LAUNCHES"),
            "qr_packed_lanes": (qb, "QR_PACKED_LANES_LAUNCHES"),
            "qr_packed_lanes_wavefront": (
                qb, "QR_PACKED_LANES_WAVEFRONT_LAUNCHES"),
            "vectoring": (cg, "VECTORING_LAUNCHES"),
            "rotation": (cg, "ROTATION_LAUNCHES"),
            "fused": (cg, "FUSED_LAUNCHES")}

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
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def read_counts():
    return {name: getattr(module, attr)
            for name, (module, attr) in COUNTERS.items()}


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


def tall_operand():
    """The batch of 8192 x 32 matrices of the TSQR route at tile_m 4096,
    from its seed."""
    return np.random.default_rng(SEED + 21).normal(
        size=(TALL_BATCH, TALL_M, TALL_N))


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
    """Launches, rotated elements, bytes, steps and stages of each panel
    kernel of ``lane`` in one panel-route call on B working tiles of m x e
    (n columns annihilated).  Bytes: each input word read once and each
    output word written once (the panel or trailing region both ways, the
    (B, S) control words).  Steps: the dependent steps of the launches in
    step order (`ops.panel_steps`); stages: the levels the packed kernels
    run them in (`ops.panel_stages`)."""
    factor, apply_ = LANES[lane]
    wb = WORD_BYTES[lane]
    work = {name: dict(launches=0, elements=0, bytes=0, steps=0, stages=0)
            for name in (factor, apply_)}
    for c0 in range(0, min(n, m - 1), pw):
        nc, mr = min(pw, n - c0), m - c0
        w = e - c0 - nc
        cols = range(min(mr - 1, nc))
        S = sum(mr - 1 - c for c in cols)
        stages = ops.panel_stages(mr, nc)[1].shape[0]
        f = work[factor]
        f["launches"] += 1
        f["elements"] += B * sum((mr - 1 - c) * 2 * (nc - c) for c in cols)
        f["bytes"] += B * (2 * mr * nc + 2 * S) * wb
        f["steps"] += S
        f["stages"] += stages
        if w > 0:
            a = work[apply_]
            a["launches"] += 1
            a["elements"] += B * S * 2 * w
            a["bytes"] += B * (2 * mr * w + 2 * S) * wb
            a["steps"] += S
            a["stages"] += stages
    return work


def tsqr_work(B, m, n, tile_m, compute_q, lane="packed", pw=PANEL_N):
    """`panel_route_work` summed over a TSQR call: the leaves, then one
    batch of stacked (2n, n) R pairs per tree level."""
    L = -(-m // tile_m)
    parts = [panel_route_work(B * L, tile_m, n, n + (tile_m if compute_q else 0),
                              pw, lane)]
    cur = L
    while cur > 1:
        pairs = cur // 2
        parts.append(panel_route_work(B * pairs, 2 * n, n,
                                      n + (2 * n if compute_q else 0), pw,
                                      lane))
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


def check_panel_sweep(P, cfg, n_cols, pw, tile_b=None, plain_panels=None):
    """The panel route on the card with every launch (or the launches of
    the first ``plain_panels`` panels) held against its plain version on
    the same inputs, and the result against the flat kernel: bit-equal or
    fail."""
    m, e = P.shape[-2:]
    W = P.clone()
    what = f"{cfg} at {tuple(P.shape)}, pw={pw}, tile_b={tile_b}"
    for i, c0 in enumerate(range(0, min(n_cols, m - 1), pw)):
        plain = plain_panels is None or i < plain_panels
        nc = min(pw, n_cols - c0)
        piv, tgt, col = ops.panel_steps(m - c0, nc)
        tile = W[:, c0:, c0:c0 + nc]
        if plain:
            want = qb.panel_factor_packed_reference(tile, piv, tgt, col,
                                                    cfg=cfg)
        got = qb.panel_factor_packed_call(tile, piv, tgt, col, cfg=cfg,
                                          tile_b=tile_b)
        if plain:
            compare(f"panel_factor_packed, {what}, panel {c0}", got, want)
        if c0 + nc < e:
            T = W[:, c0:, c0 + nc:]
            if plain:
                want = qb.panel_apply_packed_reference(T, piv, tgt, got[1],
                                                       got[2], cfg=cfg)
            qb.panel_apply_packed_call(T, piv, tgt, got[1], got[2], cfg=cfg)
            if plain:
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
          f"(median of 3; {flat_shape(steps, BIG_BATCH, BIG_M, e, A.device)}), "
          f"bound {bound_ms:.3f} ms ({bound_by})", flush=True)
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


def capture_first(store, checked=None):
    """A `wrapped_panel_kernels` wrapper that keeps a copy of the arguments
    of each kernel's first launch (its inputs, before the in-place call).
    With a list ``checked``, every launch of the block-FP panel apply B4b
    is also held against its plain version (`checked_apply`) and its shape
    appended to the list."""
    def wrap(fn, name):
        def call(*args, **kw):
            if name not in store:
                store[name] = ([a.clone() if torch.is_tensor(a) else a
                                for a in args], kw)
            if checked is not None and name == "panel_apply_blockfp":
                checked.append(tuple(args[0].shape))
                return checked_apply(fn, args, kw)
            return fn(*args, **kw)
        return call
    return wrap


def checked_apply(fn, args, kw):
    """One B4b launch, its first and last matrix held against the plain
    version on the same inputs: bit-equal or fail."""
    T, piv, tgt, flip, sig = args
    ends = [0, T.shape[0] - 1]
    want = qb.panel_apply_blockfp_reference(T[ends], piv, tgt, flip[ends],
                                            sig[ends], **kw)
    out = fn(*args, **kw)
    compare(f"panel_apply_blockfp at {tuple(T.shape)} ({len(piv)} steps), "
            f"matrices {ends}, against its plain version", T[ends], want)
    return out


def print_checked(path, checked):
    """The launches `checked_apply` held against the plain version."""
    if checked:
        print(f"{path}: panel_apply_blockfp bit-equal to its plain version "
              f"on the first and last matrix of each of its {len(checked)} "
              f"launches ({max(checked)} .. {min(checked)})", flush=True)


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


def launch_work(name, args, lane):
    """Rotated elements and bytes of one panel-kernel launch on ``args``
    (as `panel_route_work` counts them)."""
    B, mr, w = args[0].shape
    cols = qb._host_table(args[3]) if "factor" in name else None
    S = len(qb._host_table(args[1]))
    wb = WORD_BYTES[lane]
    if cols is None:
        return B * S * 2 * w, B * (2 * mr * w + 2 * S) * wb
    return B * sum(2 * (w - c) for c in cols), B * (2 * mr * w + 2 * S) * wb


def level_lines(path, lane, launches, repeats):
    """The panel kernels' time per engine call, in all and summed by tree
    level (the launch's batch: TSQR's leaves, then its levels; a panel call
    has one), median over the ``repeats`` calls of ``launches`` ((name,
    shape, ms, elements, bytes) per launch, call after call), beside each
    level's bound.  Prints one line per kernel launched."""
    for name in LANES[lane]:
        mine = [x for x in launches if x[0] == name]
        if not mine:
            continue
        per_call = len(mine) // repeats
        levels = {}
        for i, (_, (B, mr, w), ms, elements, nbytes) in enumerate(mine):
            lv = levels.setdefault(B, dict(mr=set(), w=set(), ms=[0.0] * repeats,
                                           n=0, elements=0, bytes=0))
            lv["ms"][i // per_call] += ms
            lv["mr"].add(mr)
            lv["w"].add(w)
            if i < per_call:
                lv["n"] += 1
                lv["elements"] += elements
                lv["bytes"] += nbytes
        cells = []
        for B, lv in sorted(levels.items(), reverse=True):
            bound_ms = (bfp_bound(True, 24, lv["elements"], lv["bytes"])
                        if lane == "blockfp" else
                        _bound(GivensConfig(hub=True, n=26), lv["elements"],
                               lv["bytes"]))[0]
            cells.append(f"B {B} (mr {max(lv['mr'])}..{min(lv['mr'])}, w "
                         f"{max(lv['w'])}..{min(lv['w'])}): {lv['n']} launches "
                         f"{statistics.median(lv['ms']):.3f} ms, bound "
                         f"{bound_ms:.3f}")
        total = statistics.median(map(sum, zip(*(lv["ms"] for lv in levels.values()))))
        print(f"levels {path} {name}, ms per engine call (median of "
              f"{repeats}): {total:.3f}; by level: " + "; ".join(cells),
              flush=True)


def tiled_timing(path, eng, A, work, repeats=5, lane="packed"):
    """Each panel kernel's device time per engine call (CUDA events around
    every launch, summed), median of ``repeats`` warm calls; each call's
    launches, counted from its events, must match the route's plan
    ``work``.  Prints the total, and by tree level (`level_lines`)."""
    events = []

    def timed(fn, name):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            events.append((name, start, end, tuple(args[0].shape),
                           *launch_work(name, args, lane)))
            return out
        return call

    totals = {name: [] for name in LANES[lane]}
    walls, launches = [], []
    with wrapped_panel_kernels(timed, lane):
        eng(A)                                   # warm
        torch.cuda.synchronize()
        for _ in range(repeats):
            events.clear()
            t0 = time.perf_counter()
            _, counts = counted_call(eng, A)
            walls.append(time.perf_counter() - t0)
            check_launches(f"{path}, timed call", counts, work)
            timed_calls = {name: sum(ev[0] == name for ev in events)
                           for name in COUNTERS}
            if timed_calls != counts:
                fail(f"{path}: timed {timed_calls} launches, counted {counts}")
            launches += [(n, shape, s.elapsed_time(e), *rest)
                         for n, s, e, shape, *rest in events]
            for name in totals:
                totals[name].append(sum(s.elapsed_time(e)
                                        for n, s, e, *_ in events if n == name))
    ms = {name: statistics.median(v) for name, v in totals.items()}
    wall_ms = statistics.median(walls) * 1e3
    print(f"timing {path} at {tuple(A.shape)}: " + ", ".join(
        f"{name} {t:.3f} ms per engine call ({work[name]['steps']} steps"
        f" run in {work[name]['stages']} stages)"
        for name, t in ms.items())
        + f"; engine call {wall_ms:.3f} ms host wall (median of {repeats})",
        flush=True)
    level_lines(path, lane, launches, repeats)
    return ms, wall_ms


#: Threads a column the block-FP panel apply B4b is also read at, kernel
#: only, with ``--block-grid`` (at every launch, whatever its batch).
APPLY_SLOTS = (1, 2, 4, 8)

#: Clock cycles the card sleeps before a replay, long enough for the host
#: to queue every launch of a TSQR call behind it (about 0.1 s).
REPLAY_SLEEP_CYCLES = 200_000_000


def strided_copy(T):
    """A copy of ``T`` with its strides (a row-strided view stays one)."""
    out = torch.empty_strided(T.size(), T.stride(), dtype=T.dtype,
                              device=T.device)
    return out.copy_(T)


def capture_launches(eng, A, lane="blockfp"):
    """(name, args, kw) of every panel-kernel launch of one engine call,
    each tensor copied before the in-place call."""
    store = []

    def wrap(fn, name):
        def call(*args, **kw):
            store.append((name, [strided_copy(a) if torch.is_tensor(a) else a
                                 for a in args], kw))
            return fn(*args, **kw)
        return call

    with wrapped_panel_kernels(wrap, lane):
        eng(A)
    torch.cuda.synchronize()
    return store


def replay_launch(name, T, args, kw, slots):
    """One captured launch on ``T``: through its wrapper, or with ``slots``
    B4b at that many threads a column (`qb._panel_apply_blockfp_launch`,
    one warp of columns a block unless one thread a column)."""
    if slots is None:
        return getattr(qb, f"{name}_call")(T, *args[1:], **kw)
    _, piv, tgt, flip, sig = args
    table = qb._panel_stage_table((qb._host_table(piv), qb._host_table(tgt)),
                                  None, T.shape[1], 0, str(T.device))
    return qb._panel_apply_blockfp_launch(T, table, flip, sig,
                                          qb._blockfp_args(**kw),
                                          256 if slots == 1 else 32, slots)


def replay(launches, slots):
    """One pass over captured ``launches`` on fresh copies of their first
    operands, queued behind a sleep of the card, so that the events around
    each launch time its kernel alone, without the host's work: the (name,
    shape, ms, elements, bytes) of each (as `level_lines` takes them) and
    the outputs."""
    work = [strided_copy(args[0]) for _, args, _ in launches]
    torch.cuda._sleep(REPLAY_SLEEP_CYCLES)
    events = []
    for T, (name, args, kw) in zip(work, launches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        replay_launch(name, T, args, kw, slots)
        end.record()
        events.append((name, tuple(T.shape), start, end,
                       launch_work(name, args, "blockfp")))
    torch.cuda.synchronize()
    return [(name, shape, start.elapsed_time(end), *w)
            for name, shape, start, end, w in events], work


def panel_replay_phase(paths, grid=False, rounds=5):
    """The block-FP panel kernels B4a and B4b kernel only: every launch of
    one HUB engine call of each of ``paths`` (label -> a `panel_path` or
    `tsqr_path` result) captured, then replayed (`replay`) in ``rounds``
    turns, summed by TSQR level (`level_lines`), beside the same kernels'
    times in the path (the ``levels`` lines of `tiled_timing`, which hold
    the host's work inside a launch's events while the card waits for
    it).  With ``grid`` (``--block-grid``) B4b is also read at each of
    `APPLY_SLOTS` threads a column, in turns with its wrapper's shape,
    after holding every launch bit-equal to the wrapper's words."""
    for label, res in paths.items():
        launches = capture_launches(res["engine"], res["A"])
        applies = [x for x in launches if x[0] == "panel_apply_blockfp"]
        settings = [None] + (list(APPLY_SLOTS) if grid else [])
        if grid:
            want = replay(applies, None)[1]
            for slots in APPLY_SLOTS:
                for i, (got, w) in enumerate(zip(replay(applies, slots)[1],
                                                 want)):
                    compare(f"panel_apply_blockfp {label} launch {i} at "
                            f"{slots} threads a column", got, w)
        readings = {slots: [] for slots in settings}
        for _ in range(rounds):
            for slots in settings + settings[::-1]:
                readings[slots] += replay(launches if slots is None else
                                          applies, slots)[0]
        for slots in settings:
            level_lines(f"{label} path, kernel only" + (
                "" if slots is None else f", {slots} threads a column"),
                "blockfp", readings[slots], 2 * rounds)


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


def flat_shape(steps, B, m, e, device, kernel="qr_packed"):
    """What the flat kernel B1 ('qr_packed') or B2 ('qr_blockfp') launches
    by default for ``steps`` on B m x e tiles: a text of steps -> stages,
    tile_b and threads a matrix."""
    table = qb.flat_stage_table(steps, m, e)
    threads = qb._flat_threads(kernel, table.shape[2], e, B, None, str(device))
    return (f"{len(steps)} steps -> {table.shape[1]} stages of up to "
            f"{table.shape[2]} pairs, tile_b {qb.TILE_B}, {threads} threads a "
            f"matrix")


def steps_stages(steps, m, e):
    """(steps, stages) of a step schedule on an m x e tile, as the flat
    kernels run it (`qb.flat_stage_table`)."""
    return len(steps), int(qb.flat_stage_table(steps, m, e).shape[1])


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
    print(f"timing at {tuple(P.shape)} int64, "
          f"{flat_shape(steps, BATCH, M, M + N_COLS, P.device)}: kernel "
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
    checked = [] if lane == "blockfp" else None
    with wrapped_panel_kernels(capture_first(captured, checked), lane):
        t0 = time.perf_counter()
        for name, eng in engines.items():
            results[name], per_call[name] = counted_call(eng, A)
            check_launches(f"{label}panel path {name}", per_call[name], work)
        wall = time.perf_counter() - t0
    print_checked(f"{label}panel path", checked)
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
          f"planned; {wall:.3f} s wall (first calls"
          f"{', B4b plain checks included' if checked else ''})", flush=True)
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
    checked = [] if lane == "blockfp" else None
    t0 = time.perf_counter()
    with wrapped_panel_kernels(capture_first(captured, checked), lane):
        (Q, R), call_counts = counted_call(eng, A)
    check_launches(f"{label}tsqr path, engine call", call_counts, work)
    x, solve_counts = counted_call(eng.solve, A, b)
    check_launches(f"{label}tsqr path, solve", solve_counts, solve_work)
    wall = time.perf_counter() - t0
    print_checked(f"{label}tsqr path", checked)
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
          f"(first calls{', B4b plain checks included' if checked else ''})",
          flush=True)
    return dict(counts=add_counts(call_counts, solve_counts),
                per_call=call_counts, captured=captured, A=A, engine=eng,
                work=work)


def tall_node_qr(lane):
    """The node factorization of the host tree at tile_m 4096, outside the
    panel kernels under test: the packed lane's flat kernel (its 4096 x
    4128 tile in device memory), and on the block-FP lane, whose flat
    kernel keeps its tile in shared memory, the block-FP panel route at
    panel_n 8 (its panels in shared memory; the panel route's words are
    the flat route's at any panel width)."""
    if lane == "packed":
        return lane_node_qr(lane)
    return lambda X: qr_blockfp_panel(X, iters=24, hub=True, panel_n=8)


def tall_tsqr_phase(device):
    """The TSQR route at tile_m `TALL_TILE_M` on both lanes, with Q: each
    leaf's panels exceed a block's shared memory, so the panel factors
    work on them in device memory.  R bit-equal to the host tree on
    `tall_node_qr` for every matrix, Q within 1e-12 of it, launches as
    planned; the panel kernels timed per engine call (`tiled_timing`)."""
    A = torch.tensor(tall_operand(), device=device)
    out = {}
    for lane, pw in TALL_PANEL_N.items():
        label = PATH_LANES[lane]["label"]
        factor = LANES[lane][0]
        mr = TALL_TILE_M
        pairs = ops.panel_stages(mr, pw)[1].shape[1]
        _, device_panel = qb._panel_tile(
            factor, None, qb._stage_threads(pairs, pw), mr, pw, TALL_N + mr,
            pairs, WORD_BYTES[lane])
        if not device_panel:
            fail(f"{label}tall tsqr: a {mr} x {pw} panel fits shared memory; "
                 f"the phase needs a larger one")
        eng = lane_engine(lane, device, tiling="tsqr", tile_m=TALL_TILE_M,
                          panel_n=pw)
        work = tsqr_work(TALL_BATCH, TALL_M, TALL_N, TALL_TILE_M, True, lane,
                         pw)
        t0 = time.perf_counter()
        (Q, R), counts = counted_call(eng, A)
        wall = time.perf_counter() - t0
        check_launches(f"{label}tall tsqr path", counts, work)
        if not (torch.isfinite(Q).all() and torch.isfinite(R).all()):
            fail(f"{label}tall tsqr: non-finite factors")
        q_diff = 0.0
        for i in range(TALL_BATCH):
            Qr, Rr = tsqr_host_reference(A[i], tall_node_qr(lane), TALL_TILE_M)
            compare(f"{label}tall tsqr: R of matrix {i} against the host tree",
                    R[i].view(torch.int64), Rr.view(torch.int64))
            q_diff = max(q_diff, (Q[i] - Qr).abs().max().item())
        if not q_diff <= 1e-12:
            fail(f"{label}tall tsqr: Q differs from the host tree by {q_diff} "
                 f"(limit 1e-12)")
        print(f"{label}tall tsqr path at {tuple(A.shape)}, tile_m "
              f"{TALL_TILE_M}, panel_n {pw}: {mr} x {pw} panels in device "
              f"memory; R bit-equal to the host tree for all "
              f"{TALL_BATCH} matrices, Q within {q_diff:.3e}; launches "
              f"{ {k: v for k, v in counts.items() if v} }; {wall:.3f} s wall "
              f"(first call)", flush=True)
        ms, wall_ms = tiled_timing(f"{label}tall tsqr path", eng, A, work,
                                   repeats=3, lane=lane)
        out[lane] = dict(ms=ms[factor], launches=counts[factor], work=work,
                         shape=[TALL_BATCH, TALL_M, TALL_N], panel=[mr, pw])
    return out


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
    print(f"timing qr_blockfp at {tuple(X.shape)} int32, "
          f"{flat_shape(steps, BATCH, M, e, X.device, 'qr_blockfp')}: kernel "
          f"{ms:.3f} ms, "
          f"plain {plain_ms:.1f} ms, bound {bound_ms:.3f} ms ({bound_by})",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=float((out - ref).abs().max().item()),
                shape=list(X.shape))


#: Block shapes the flat kernels B1 and B2 are also read at: (tile_b,
#: threads a matrix) at the main path's shape, and threads a matrix at
#: (BIG_BATCH, BIG_M, 2 BIG_M), one matrix an SM.
FLAT_BLOCKS = tuple(itertools.product((1, 2, 4), (32, 64, 128, 256)))
FLAT_BIG_THREADS = (256, 512, 1024)


def block_lines(main, main_shape, big, big_shape, wrappers, defaults,
                blocks=FLAT_BLOCKS, big_threads=FLAT_BIG_THREADS):
    """Flat kernels read at other block shapes than their wrappers' own.
    ``main`` and ``big`` map a kernel's name to ``(launch, want)``, where
    ``launch(tile_b, threads)`` runs the kernel on its cached stage table
    (no host work of the wrapper in the window) and ``want`` is the
    wrapper's output, which every reading must equal.  Each of ``main`` at
    the (tile_b, threads) of ``blocks`` (two rounds, median of 5 each),
    each of ``big``, one matrix an SM, at ``big_threads`` threads and
    through its wrapper ``wrappers[name]`` (five interleaved rounds, median
    of 3 each); ``defaults[name]`` is the wrapper's threads at the big
    shape.  Prints the `flat blocks` lines."""
    def read(name, launch, want, tile_b, threads, repeats):
        ms, out = _event_ms(lambda: launch(tile_b, threads), repeats)
        compare(f"{name} at tile_b {tile_b}, {threads} threads", out, want)
        return ms

    for name, (launch, want) in main.items():
        rounds = [[read(name, launch, want, tb, th, 5) for tb, th in blocks]
                  for _ in range(2)]
        cells = ", ".join(f"{tb}x{th} {a:.3f}/{b:.3f}"
                          for (tb, th), a, b in zip(blocks, *rounds))
        print(f"flat blocks {name} at {main_shape}, tile_b x threads "
              f"ms (two rounds, median of 5): {cells}", flush=True)
    readings = {(name, th): [] for name in big
                for th in big_threads + ("wrapper",)}
    for _ in range(5):
        for name, (launch, want) in big.items():
            for th in big_threads:
                readings[name, th].append(read(name, launch, want, 1, th, 3))
            ms, out = _event_ms(wrappers[name], 3)
            compare(f"{name} wrapper at {big_shape}", out, want)
            readings[name, "wrapper"].append(ms)
    for name in big:
        cells = "; ".join(f"{th}: " + ", ".join(f"{v:.3f}" for v in readings[name, th])
                          for th in big_threads + ("wrapper",))
        print(f"flat blocks {name} at {big_shape} (tile_b 1; the wrapper "
              f"runs {defaults[name]} threads), ms in five rounds (median of 3 "
              f"each): {cells}", flush=True)


def flat_block_phase(A, cfg):
    """B1 and B2 at other block shapes (`block_lines`): at the main path's
    shape and, one matrix an SM, at (BIG_BATCH, BIG_M, 2 BIG_M)."""
    unit = GivensUnit(cfg)
    bfp_args = qb._blockfp_args(24, True)

    def operands(A, m):
        eye = torch.eye(m, dtype=torch.float64, device=A.device).expand(
            A.shape[0], m, m)
        W = torch.cat([A, eye], dim=-1)
        X, _ = ops._blockfp_encode(W, 24)
        steps = givens_schedule(m, m)
        table = qb._flat_stage_table(steps, m, 2 * m, str(A.device))
        return unit.encode(W).contiguous(), X.contiguous(), steps, table

    def kernels(P, X, steps, table):
        return {"B1": (lambda tb, th: qb._qr_packed_launch(P, table, cfg, tb, th),
                       qb.qr_packed_call(P, cfg=cfg, steps=steps)),
                "B2": (lambda tb, th: qb._qr_blockfp_launch(X, table, bfp_args,
                                                            tb, th),
                       qb.qr_blockfp_call(X, iters=24, hub=True, steps=steps))}

    main = kernels(*operands(A, M))
    P, X, steps, table = operands(torch.tensor(big_operand(), device=A.device),
                                  BIG_M)
    wrappers = {"B1": lambda: qb.qr_packed_call(P, cfg=cfg, steps=steps),
                "B2": lambda: qb.qr_blockfp_call(X, iters=24, hub=True,
                                                 steps=steps)}
    defaults = {name: qb._flat_threads(kernel, table.shape[2], 2 * BIG_M,
                                       BIG_BATCH, None, str(A.device))
                for name, kernel in (("B1", "qr_packed"), ("B2", "qr_blockfp"))}
    block_lines(main, (BATCH, M, 2 * M), kernels(P, X, steps, table),
                tuple(P.shape), wrappers, defaults)


# ---------------------------------------------------------------------------
# The Sameh–Kuck wavefront (B5a, B5b) and the complex datapath (B7a, B7b)
# ---------------------------------------------------------------------------
#: (m, n, compute_q) of the wavefront parity phase: square and non-square
#: shapes (stages with fewer pairs than the widest: the tables' padding).
WF_PARITY_SHAPES = ((4, 4, True), (6, 3, True), (3, 6, True), (2, 3, False),
                    (32, 32, True))

#: (m, n, compute_q) of the complex parity phase.
CPLX_PARITY_SHAPES = ((4, 4, True), (6, 3, True), (3, 6, True), (2, 3, False))

#: The complex limit of the JAX package: max |QR - A| and max |QhQ - I|,
#: elementwise, at 5 x 4 (tests/test_qrd_complex.py).
CPLX_TOL = 2e-5

#: The batch at which each plain version's one launch is timed (at the full
#: batch the complex plain loop alone would take minutes).
PLAIN_BATCH = 1024

#: The MIMO detector of examples/mimo_detection.py: 4 x 4 complex channels,
#: one received vector each.  SOLVE_TOLERANCES is documented for
#: well-conditioned inputs, and a batch of random square channels has an
#: ill-conditioned tail (2-norm condition numbers: median 7.4, 99.9% below
#: 193, the largest 1601 in this batch); its forward error is gated on the
#: matrices with a condition number up to MIMO_KAPPA_MAX, a bound of this
#: script's choosing, and every matrix's backward error at the same limit.
MIMO_BATCH, MIMO_M, MIMO_KAPPA_MAX = 65536, 4, 100.0

#: The wavefront kernel of each lane.
WF_KERNELS = {"packed": "qr_packed_wavefront", "blockfp": "qr_blockfp_wavefront"}


def flat_order(m, n):
    """The Sameh–Kuck stages of an m x n matrix flattened into steps."""
    return tuple(s for st in sameh_kuck_schedule(m, n) for s in st)


def stage_tables(m, n):
    return ops._stage_tables(sameh_kuck_schedule(m, n), m)


def check_plain(what, kernel, reference, X, *args, **kw):
    """A kernel against its plain version on the same words: bit-equal or
    fail.  ``tile_b`` and ``table_layout`` go to the kernel only."""
    got = kernel(X, *args, **kw)
    want = reference(X, *args, **{k: v for k, v in kw.items()
                                  if k not in ("tile_b", "table_layout")})
    torch.cuda.synchronize()
    compare(what, got, want)
    return got


def wavefront_parity_phase(device):
    """B5a and B5b bit-equal to their plain versions, and to B1 and B2 on
    the flattened stage schedule: HUB and IEEE at N = 26, HUB and
    conventional x iters 24 and 30, square and non-square shapes, random
    and edge words, ragged batches, both table layouts."""
    rng = np.random.default_rng(SEED + 9)
    layouts = itertools.cycle(qb.TABLE_LAYOUTS)
    n_packed = n_bfp = 0
    for cfg in parity_configs()[:4]:
        for (m, n, cq) in WF_PARITY_SHAPES:
            e = n + (m if cq else 0)
            tabs = stage_tables(m, n)
            for P in (encoded_words(cfg, 16, m, n, cq, rng, device),
                      edge_words(cfg, 16, m, e, rng, device)):
                what = f"qr_packed_wavefront {cfg} at {tuple(P.shape)}"
                got = check_plain(what, qb.qr_packed_wavefront_call,
                                  qb.qr_packed_wavefront_reference, P, *tabs,
                                  cfg=cfg, table_layout=next(layouts))
                compare(f"{what} against qr_packed on the flattened stages",
                        got, qb.qr_packed_call(P, cfg=cfg,
                                               steps=flat_order(m, n)))
                n_packed += 1
        P = encoded_words(cfg, 5, 6, 4, True, rng, device)
        for tile_b in (4, 2):                 # a ragged batch of 5
            check_plain(f"qr_packed_wavefront {cfg}, tile_b={tile_b}",
                        qb.qr_packed_wavefront_call,
                        qb.qr_packed_wavefront_reference, P,
                        *stage_tables(6, 4), cfg=cfg, tile_b=tile_b)
            n_packed += 1
    for hub, iters in BFP_CONFIGS:
        kw = dict(iters=iters, hub=hub)
        for (m, n, cq) in WF_PARITY_SHAPES:
            e = n + (m if cq else 0)
            tabs = stage_tables(m, n)
            for edge in (False, True):
                X = bfp_words(16, m, e, rng, device, edge)
                what = f"qr_blockfp_wavefront {kw} at {tuple(X.shape)}"
                got = check_plain(what, qb.qr_blockfp_wavefront_call,
                                  qb.qr_blockfp_wavefront_reference, X, *tabs,
                                  table_layout=next(layouts), **kw)
                compare(f"{what} against qr_blockfp on the flattened stages",
                        got, qb.qr_blockfp_call(X, steps=flat_order(m, n),
                                                **kw))
                n_bfp += 1
        X = bfp_words(5, 6, 10, rng, device)
        for tile_b in (4, 2):
            check_plain(f"qr_blockfp_wavefront {kw}, tile_b={tile_b}",
                        qb.qr_blockfp_wavefront_call,
                        qb.qr_blockfp_wavefront_reference, X,
                        *stage_tables(6, 4), tile_b=tile_b, **kw)
            n_bfp += 1
    print(f"parity: qr_packed_wavefront bit-equal to its plain version and to "
          f"qr_packed on the flattened stages on {n_packed} cases (4 configs "
          f"at N=26); qr_blockfp_wavefront to its plain version and to "
          f"qr_blockfp on {n_bfp} cases ((hub, iters) in {BFP_CONFIGS}); "
          f"shapes {[s[:2] for s in WF_PARITY_SHAPES]}, random + edge words, "
          f"ragged B=5, table layouts {qb.TABLE_LAYOUTS}", flush=True)


def complex_words(cfg, B, m, n, compute_q, rng, device, edge=False):
    """Packed (re, im) words of random complex [A | I] working matrices of
    moderate range.  With ``edge``: `edge_words` on the real lanes, exactly
    real leads (imaginary words +0 and -0) in columns 0 and 1 of every
    other row, a zero lead (both lanes) in row 1 and an all-zero column."""
    A = ((rng.normal(size=(B, m, n)) + 1j * rng.normal(size=(B, m, n)))
         * np.exp2(rng.integers(-8, 8, size=(B, m, n))))
    if compute_q:
        A = np.concatenate([A, np.broadcast_to(np.eye(m), (B, m, m))], axis=-1)
    unit = GivensUnit(cfg)
    P = torch.stack([unit.encode(torch.tensor(A.real)),
                     unit.encode(torch.tensor(A.imag))], dim=-1).to(device)
    if edge:
        e = P.shape[-2]
        neg_zero = 1 << (cfg.fmt.exp_bits + cfg.fmt.man_bits)
        P[..., 0] = edge_words(cfg, B, m, e, rng, device)
        P[:, 0::2, :min(2, e), 1] = 0
        P[:, 1::4, :min(2, e), 1] = neg_zero
        if m > 1:
            P[:, 1, 0, :] = 0
        P[:, :, min(2, e - 1), :] = 0
    return P.contiguous()


def complex_parity_phase(device):
    """B7a and B7b bit-equal to their plain versions: HUB and IEEE at
    N = 26, random and edge words, ragged batches; B7b also to B7a on the
    flattened stages; on purely real words B7a gives B1's words on the real
    lane and exact 0 on the imaginary lane (B7b: B5a's)."""
    rng = np.random.default_rng(SEED + 10)
    layouts = itertools.cycle(qb.TABLE_LAYOUTS)
    n_flat = n_wf = 0
    for i, cfg in enumerate(parity_configs()[:4]):
        shapes = CPLX_PARITY_SHAPES + (((16, 16, True),) if i % 2 else ())
        for (m, n, cq) in shapes:
            tabs = stage_tables(m, n)
            for edge in (False, True):
                P = complex_words(cfg, 8, m, n, cq, rng, device, edge)
                what = f"{cfg} at {tuple(P.shape)}, edge={edge}"
                check_plain(f"qr_packed_complex {what}", qb.qr_packed_complex_call,
                            qb.qr_packed_complex_reference, P, cfg=cfg,
                            steps=givens_schedule(m, n))
                got = check_plain(f"qr_packed_complex_wavefront {what}",
                                  qb.qr_packed_complex_wavefront_call,
                                  qb.qr_packed_complex_wavefront_reference, P,
                                  *tabs, cfg=cfg, table_layout=next(layouts))
                compare(f"qr_packed_complex_wavefront {what} against "
                        f"qr_packed_complex on the flattened stages", got,
                        qb.qr_packed_complex_call(P, cfg=cfg,
                                                  steps=flat_order(m, n)))
                n_flat += 1
                n_wf += 1
        P = complex_words(cfg, 8, 6, 3, True, rng, device)
        P[..., 1] = 0                             # purely real
        real = P[..., 0].contiguous()
        got = check_plain(f"qr_packed_complex {cfg}, purely real",
                          qb.qr_packed_complex_call, qb.qr_packed_complex_reference,
                          P, cfg=cfg, steps=givens_schedule(6, 3))
        compare(f"qr_packed_complex {cfg}, purely real: real lane against "
                f"qr_packed", got[..., 0].contiguous(),
                qb.qr_packed_call(real, cfg=cfg, steps=givens_schedule(6, 3)))
        if not packed_is_zero(got[..., 1], cfg.fmt).all():
            fail(f"qr_packed_complex {cfg}, purely real: an imaginary word "
                 f"is not +-0")
        got = qb.qr_packed_complex_wavefront_call(P, *stage_tables(6, 3), cfg=cfg)
        compare(f"qr_packed_complex_wavefront {cfg}, purely real: against "
                f"qr_packed_wavefront", got[..., 0].contiguous(),
                qb.qr_packed_wavefront_call(real, *stage_tables(6, 3), cfg=cfg))
        if not packed_is_zero(got[..., 1], cfg.fmt).all():
            fail(f"qr_packed_complex_wavefront {cfg}, purely real: an "
                 f"imaginary word is not +-0")
        n_flat += 1
        n_wf += 1
        P = complex_words(cfg, 5, 6, 4, True, rng, device)
        for tile_b in (4, 2):                 # a ragged batch of 5
            check_plain(f"qr_packed_complex {cfg}, tile_b={tile_b}",
                        qb.qr_packed_complex_call, qb.qr_packed_complex_reference,
                        P, cfg=cfg, steps=givens_schedule(6, 4), tile_b=tile_b)
            check_plain(f"qr_packed_complex_wavefront {cfg}, tile_b={tile_b}",
                        qb.qr_packed_complex_wavefront_call,
                        qb.qr_packed_complex_wavefront_reference, P,
                        *stage_tables(6, 4), cfg=cfg, tile_b=tile_b)
            n_flat += 1
            n_wf += 1
    print(f"parity: qr_packed_complex bit-equal to its plain version on "
          f"{n_flat} cases, qr_packed_complex_wavefront to its plain version "
          f"and to qr_packed_complex on the flattened stages on {n_wf} cases "
          f"(4 configs at N=26; shapes {[s[:2] for s in CPLX_PARITY_SHAPES]} "
          f"and 16 x 16; random + edge words with exactly real and zero "
          f"leads and an all-zero column; purely real words against "
          f"qr_packed / qr_packed_wavefront with +-0 imaginary words; "
          f"ragged B=5)", flush=True)


def lane_flat_qr(lane):
    """The lane's flat kernel route (HUB) on a given step order."""
    if lane == "packed":
        unit = GivensUnit(GivensConfig(hub=True, n=26))
        return lambda X, steps: qr_cordic_pallas(X, unit, steps=steps)
    return lambda X, steps: qr_blockfp_pallas(X, iters=24, hub=True,
                                              steps=steps)


def lane_words(lane, A):
    """The HUB words of [A | I] on the lane (packed int64 or block-FP
    int32) and the lane's wavefront and flat kernels on them, the flat one
    on the flattened stage schedule; and their plain versions."""
    m, n = A.shape[-2:]
    eye = torch.eye(m, dtype=A.dtype, device=A.device).expand(*A.shape[:-1], m)
    W = torch.cat([A, eye], dim=-1)
    tabs, steps = stage_tables(m, n), flat_order(m, n)
    if lane == "packed":
        g = GivensConfig(hub=True, n=26)
        X = GivensUnit(g).encode(W).contiguous()
        return X, dict(
            wavefront=lambda X: qb.qr_packed_wavefront_call(X, *tabs, cfg=g),
            flat=lambda X: qb.qr_packed_call(X, cfg=g, steps=steps),
            plain=lambda X: qb.qr_packed_wavefront_reference(X, *tabs, cfg=g),
            decode=GivensUnit(g).decode)
    X = ops._blockfp_encode(W, 24)[0].contiguous()
    kw = dict(iters=24, hub=True)
    return X, dict(
        wavefront=lambda X: qb.qr_blockfp_wavefront_call(X, *tabs, **kw),
        flat=lambda X: qb.qr_blockfp_call(X, steps=steps, **kw),
        plain=lambda X: qb.qr_blockfp_wavefront_reference(X, *tabs, **kw),
        decode=lambda X: X.to(torch.float64))


def kernel_pair_timing(what, X, first, second, repeats=5, Y=None,
                       as_second=None):
    """Two kernels on the same words, warm, each timed with CUDA events
    (median of ``repeats``), in turns: first, second, second, first.
    Their outputs must be bit-equal.  Returns both times.  ``Y`` is the
    second's operand when it takes the words in another form (default X),
    and ``as_second`` brings the first's output to that form."""
    Y = X if Y is None else Y
    first(X)
    second(Y)
    t1, out1 = _event_ms(lambda: first(X), repeats)
    t2, out2 = _event_ms(lambda: second(Y), repeats)
    t2b, _ = _event_ms(lambda: second(Y), repeats)
    t1b, _ = _event_ms(lambda: first(X), repeats)
    compare(what, out1 if as_second is None else as_second(out1), out2)
    return statistics.median([t1, t1b]), statistics.median([t2, t2b])


def plain_timing(what, kernel, plain, X, decode, batch=PLAIN_BATCH):
    """One launch of a plain version at ``batch`` matrices beside the
    kernel on the same words: bit-equal or fail.  Returns (plain ms, max
    |decoded kernel - decoded plain|)."""
    Xp = X[:batch].contiguous()
    got = kernel(Xp)
    plain_ms, want = _event_ms(lambda: plain(Xp), 1)
    compare(f"{what} at {tuple(Xp.shape)} against its plain version", got, want)
    return plain_ms, (decode(got) - decode(want)).abs().max().item()


def wavefront_path(device, lane, A, As, b):
    """QRDEngine(schedule='sameh_kuck') on ``lane`` at the main path's
    shapes: Q and R bit-equal to the flat kernel on the flattened stage
    schedule, the flat path's limits, the solve, one wavefront launch per
    engine call; the wavefront kernel timed beside the flat kernel on the
    same words, and its plain version at `PLAIN_BATCH`."""
    spec = PATH_LANES[lane]
    label = spec["label"]
    kernel = WF_KERNELS[lane]
    eng = lane_engine(lane, device, schedule="sameh_kuck")
    (Q, R), call_counts = counted_call(eng, A)
    x, solve_counts = counted_call(eng.solve, As, b)
    want = {name: int(name == kernel) for name in COUNTERS}
    for what, counts in (("engine call", call_counts), ("solve", solve_counts)):
        if counts != want:
            fail(f"{label}wavefront path, {what}: launches {counts}, expected "
                 f"{want}")
    if Q.shape != (BATCH, M, M) or R.shape != (BATCH, M, N_COLS):
        fail(f"{label}wavefront: shapes {tuple(Q.shape)} {tuple(R.shape)}")
    if not (torch.isfinite(Q).all() and torch.isfinite(R).all()):
        fail(f"{label}wavefront: non-finite factors")
    if torch.count_nonzero(torch.tril(R, -1)).item() != 0:
        fail(f"{label}wavefront: R has non-zero entries below the diagonal")
    Qf, Rf = lane_flat_qr(lane)(A, flat_order(M, N_COLS))
    compare(f"{label}wavefront: Q against {spec['flat']} on the flattened "
            f"stages", Q.view(torch.int64), Qf.view(torch.int64))
    compare(f"{label}wavefront: R against {spec['flat']} on the flattened "
            f"stages", R.view(torch.int64), Rf.view(torch.int64))
    if lane == "packed":
        resid, orth, worst = qr_errors(A, Q, R)
        ok = resid <= QR_TOL and orth <= QR_TOL
        text = (f"max |QR-A|/|A| = {resid:.3e}, max |QtQ-I| = {orth:.3e} "
                f"(matrix {worst}; limit {QR_TOL})")
    else:
        snr, orth = snr_db(A, Q, R), max_orth(Q)
        ok = snr.mean().item() > BFP_SNR_DB and orth < BFP_ORTH_TOL
        text = (f"mean SNR {snr.mean().item():.2f} dB (min "
                f"{snr.min().item():.2f}; limit > {BFP_SNR_DB}), max |QtQ-I| = "
                f"{orth:.3e} (limit {BFP_ORTH_TOL})")
    if not ok:
        fail(f"{label}wavefront: {text}")
    ref = torch.linalg.lstsq(As, b[..., None]).solution[..., 0]
    sol_err = (torch.linalg.vector_norm(x - ref, dim=-1)
               / torch.linalg.vector_norm(ref, dim=-1)).max().item()
    tol = SOLVE_TOLERANCES[spec["backend"]]
    if not (x.shape == (BATCH, N_SOLVE) and torch.isfinite(x).all()
            and sol_err <= tol):
        fail(f"{label}wavefront solve: relative error {sol_err} (limit {tol})")
    X, fns = lane_words(lane, A)
    ms, flat_ms = kernel_pair_timing(f"{kernel} against {spec['flat']} on the "
                                     f"flattened stages", X, fns["wavefront"],
                                     fns["flat"])
    plain_ms, err = plain_timing(kernel, fns["wavefront"], fns["plain"], X,
                                 fns["decode"])
    print(f"{label}wavefront path (sameh_kuck): Q {tuple(Q.shape)} R "
          f"{tuple(R.shape)} bit-equal to {spec['flat']} on the flattened "
          f"stages; {text}; solve x {tuple(x.shape)} max |x-x_lstsq|/"
          f"|x_lstsq| = {sol_err:.3e} (limit {tol}); launches {call_counts} "
          f"in the engine call and {solve_counts} in the solve, each as "
          f"planned", flush=True)
    print(f"timing {kernel} at {tuple(X.shape)}: {ms:.3f} ms, {spec['flat']} on "
          f"the same words {flat_ms:.3f} ms (medians of 2 x 5, in turns); "
          f"plain version {plain_ms:.1f} ms for one launch at "
          f"{PLAIN_BATCH} matrices", flush=True)
    return dict(launches=call_counts[kernel] + solve_counts[kernel],
                per_call=call_counts[kernel], ms=ms, flat_ms=flat_ms,
                plain_ms=plain_ms, max_abs_err=err, shape=list(X.shape))


def wavefront_big_phase(device):
    """B5a with its tiles in device memory: QRDEngine(schedule=
    'sameh_kuck') at 128 x 128 with Q against B1 on the flattened stages."""
    A = torch.tensor(big_operand(), device=device)
    e = 2 * BIG_M
    if BIG_M * e * 8 <= qb.MAX_SHARED_BYTES:
        fail(f"{BIG_M} x {e} fits shared memory; the phase needs a larger tile")
    (Q, R), counts = counted_call(lane_engine("packed", device,
                                              schedule="sameh_kuck"), A)
    if counts["qr_packed_wavefront"] != 1 or sum(counts.values()) != 1:
        fail(f"wavefront 128 x 128: launches {counts}")
    Qf, Rf = lane_flat_qr("packed")(A, flat_order(BIG_M, BIG_M))
    compare("wavefront 128 x 128 (device-memory tile): Q against qr_packed on "
            "the flattened stages", Q.view(torch.int64), Qf.view(torch.int64))
    compare("wavefront 128 x 128 (device-memory tile): R against qr_packed on "
            "the flattened stages", R.view(torch.int64), Rf.view(torch.int64))
    resid, orth, worst = qr_errors(A, Q, R)
    if not (resid <= qr_tol(BIG_M) and orth <= qr_tol(BIG_M)):
        fail(f"wavefront 128 x 128: |QR-A|/|A| = {resid}, |QtQ-I| = {orth} "
             f"(limit {qr_tol(BIG_M)})")
    X, fns = lane_words("packed", A)
    ms, flat_ms = kernel_pair_timing("qr_packed_wavefront at 128 x 128", X,
                                     fns["wavefront"], fns["flat"], repeats=3)
    print(f"wavefront at {tuple(A.shape)} with Q: tile {BIG_M} x {e} int64 in "
          f"device memory; Q and R bit-equal to qr_packed on the flattened "
          f"stages; max |QR-A|/|A| = {resid:.3e}, |QtQ-I| = {orth:.3e} (matrix "
          f"{worst}; limit {qr_tol(BIG_M):.0e}); qr_packed_wavefront {ms:.3f} "
          f"ms, qr_packed {flat_ms:.3f} ms on the same words (medians of "
          f"2 x 3, in turns)", flush=True)
    return dict(ms=ms, flat_ms=flat_ms, shape=list(X.shape),
                launches=counts["qr_packed_wavefront"])


def complex_operands(B, m, n, seed):
    """Random complex (B, m, n) matrices, from a seed."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, m, n)) + 1j * rng.normal(size=(B, m, n))


def complex_errors(A, Q, R):
    """Per matrix: the relative residual |QR - A|/|A| and |QhQ - I|
    (Frobenius), and the largest elementwise |QR - A| and |QhQ - I|.
    Returns (max resid, max orth, worst orth matrix, max-abs resid,
    max-abs orth, worst max-abs matrix)."""
    eye = torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)
    D = Q @ R - A
    O = Q.mH @ Q - eye
    fro = torch.linalg.matrix_norm
    resid = fro(D) / fro(A)
    orth = fro(O)
    mabs = torch.maximum(D.abs().amax(dim=(-2, -1)), O.abs().amax(dim=(-2, -1)))
    return (resid.max().item(), orth.max().item(), int(orth.argmax()),
            D.abs().max().item(), O.abs().max().item(), int(mabs.argmax()))


def check_complex_factors(what, A, Q, R, fro_tol):
    """Shapes, finiteness, R's exact structure (the pivots' diagonal
    entries real and non-negative, the lower triangle zero), and the
    accuracy: the JAX package's max-abs limit
    `CPLX_TOL` where met, else printed as unmet and gated at ``fro_tol``
    (per matrix, Frobenius).  Returns the printed text."""
    B, m, n = A.shape
    if Q.shape != (B, m, m) or R.shape != (B, m, n):
        fail(f"{what}: shapes {tuple(Q.shape)} {tuple(R.shape)}")
    if not (torch.isfinite(torch.view_as_real(Q)).all()
            and torch.isfinite(torch.view_as_real(R)).all()):
        fail(f"{what}: non-finite factors")
    if torch.count_nonzero(torch.tril(R, -1)).item() != 0:
        fail(f"{what}: R has non-zero entries below the diagonal")
    # the pivots' realized leads; with m == n the last diagonal entry is
    # no pivot and keeps its phase
    d = torch.diagonal(R, dim1=-2, dim2=-1)[..., :min(m - 1, n)]
    if not (torch.all(d.imag == 0) and torch.all(d.real >= 0)):
        fail(f"{what}: R's pivot diagonal is not real and non-negative")
    resid, orth, worst, abs_resid, abs_orth, worst_abs = complex_errors(A, Q, R)
    met = abs_resid <= CPLX_TOL and abs_orth <= CPLX_TOL
    if not met and not (resid <= fro_tol and orth <= fro_tol):
        fail(f"{what}: max |QR-A| = {abs_resid}, max |QhQ-I| = {abs_orth} "
             f"(JAX limit {CPLX_TOL}); per matrix |QR-A|/|A| = {resid}, "
             f"|QhQ-I| = {orth} (limit {fro_tol})")
    return (f"max |QR-A| = {abs_resid:.3e}, max |QhQ-I| = {abs_orth:.3e} "
            f"(matrix {worst_abs}) against the JAX package's {CPLX_TOL:.0e} "
            f"(5 x 4): {'met' if met else f'UNMET, gated at {fro_tol:.1e} per matrix'}; "
            f"per matrix max |QR-A|/|A| = {resid:.3e}, |QhQ-I| = {orth:.3e} "
            f"(matrix {worst}); R's first {min(m - 1, n)} diagonal entries "
            f"real and >= 0, lower triangle 0")


def complex_engine(device, schedule):
    return QRDEngine(backend="cordic_pallas", dtype="complex128",
                     givens=GivensConfig(hub=True, n=26), schedule=schedule,
                     device=device)


def check_complex_solve(what, eng, A, b, kernel, kappa_max=None):
    """A complex solve on the card: one launch of ``kernel``, and the
    relative error against a float64 least-squares solve within
    SOLVE_TOLERANCES['cordic_pallas:complex'].  That limit is documented
    for well-conditioned inputs; with ``kappa_max`` it is gated only on
    the matrices whose 2-norm condition number is at most ``kappa_max``,
    the largest error over all matrices is printed met or unmet, and every
    matrix is held to the same limit as a normwise backward error
    |Ax - b| / (|A| |x| + |b|), which a backward-stable solve keeps small
    whatever the conditioning.  Returns (the launches counted, text)."""
    x, counts = counted_call(eng.solve, A, b)
    want = {name: int(name == kernel) for name in COUNTERS}
    if counts != want:
        fail(f"{what}: launches {counts}, expected {want}")
    ref = torch.linalg.lstsq(A, b[..., None]).solution[..., 0]
    rel = (torch.linalg.vector_norm(x - ref, dim=-1)
           / torch.linalg.vector_norm(ref, dim=-1))
    err = rel.max().item()
    tol = SOLVE_TOLERANCES["cordic_pallas:complex"]
    if not (x.shape == A.shape[:-2] + (A.shape[-1],) and x.is_complex()
            and torch.isfinite(torch.view_as_real(x)).all()):
        fail(f"{what}: x {tuple(x.shape)} {x.dtype}, or not finite")
    if kappa_max is None:
        if not err <= tol:
            fail(f"{what}: relative error {err} (limit {tol})")
        return counts, (f"{what}: x {tuple(x.shape)} max |x-x_lstsq|/"
                        f"|x_lstsq| = {err:.3e} (limit {tol}), 1 {kernel} "
                        f"launch")
    kappa = torch.linalg.cond(A)
    well = kappa <= kappa_max
    err_well = rel[well].max().item()
    resid = torch.linalg.vector_norm(
        (A @ x[..., None])[..., 0] - b, dim=-1)
    eta = (resid / (torch.linalg.matrix_norm(A, ord=2)
                    * torch.linalg.vector_norm(x, dim=-1)
                    + torch.linalg.vector_norm(b, dim=-1))).max().item()
    if not (err_well <= tol and eta <= tol):
        fail(f"{what}: relative error {err_well} on the matrices with "
             f"cond <= {kappa_max}, backward error {eta} (limit {tol})")
    worst = int(rel.argmax())
    return counts, (
        f"{what}: x {tuple(x.shape)}; max |x-x_lstsq|/|x_lstsq| = {err:.3e} "
        f"(matrix {worst}, cond {kappa[worst].item():.1f}) against "
        f"SOLVE_TOLERANCES['cordic_pallas:complex'] = {tol}: "
        f"{'met' if err <= tol else f'UNMET on {int((rel > tol).sum())} of {rel.numel()} matrices'}; "
        f"gated: {err_well:.3e} on the {int(well.sum())} matrices with cond "
        f"<= {kappa_max} and backward error {eta:.3e} on all (limit {tol}); "
        f"1 {kernel} launch")


def complex_path(device):
    """QRDEngine(backend='cordic_pallas', dtype='complex128') at full width
    on both schedules, the complex solves (and the MIMO detector's), and
    both complex kernels with their tiles in device memory at 128 x 128;
    the kernels timed, and their plain versions at `PLAIN_BATCH`."""
    g = GivensConfig(hub=True, n=26)
    unit = GivensUnit(g)
    A = torch.tensor(complex_operands(BATCH, M, N_COLS, SEED + 11), device=device)
    engines = {s: complex_engine(device, s) for s in ("col", "sameh_kuck")}
    kernels = {"col": "qr_packed_complex",
               "sameh_kuck": "qr_packed_complex_wavefront"}
    results, lines, launched, per_call = {}, [], [], {}
    for sched, eng in engines.items():
        results[sched], counts = counted_call(eng, A)
        launched.append(counts)
        per_call[kernels[sched]] = counts[kernels[sched]]
        want = {name: int(name == kernels[sched]) for name in COUNTERS}
        if counts != want:
            fail(f"complex path {sched}: launches {counts}, expected {want}")
        lines.append(f"complex path {sched}: Q {tuple(results[sched][0].shape)} "
                     f"{results[sched][0].dtype}, " + check_complex_factors(
                         f"complex path {sched}", A, *results[sched],
                         qr_tol(M)))
    Qf, Rf = qr_cordic_complex_pallas(A, unit, steps=flat_order(M, N_COLS))
    for name, got, want in (("Q", results["sameh_kuck"][0], Qf),
                            ("R", results["sameh_kuck"][1], Rf)):
        compare(f"complex wavefront: {name} against qr_packed_complex on the "
                f"flattened stages", torch.view_as_real(got).view(torch.int64),
                torch.view_as_real(want).view(torch.int64))
    for line in lines:
        print(line, flush=True)
    print("complex path: the wavefront's Q and R bit-equal to "
          "qr_packed_complex on the flattened stages", flush=True)

    rng = np.random.default_rng(SEED + 12)
    As = torch.tensor(complex_operands(BATCH, M, N_SOLVE, SEED + 13), device=device)
    b = torch.tensor(rng.normal(size=(BATCH, M)) + 1j * rng.normal(size=(BATCH, M)),
                     device=device)
    Am = torch.tensor(complex_operands(MIMO_BATCH, MIMO_M, MIMO_M, SEED + 14),
                      device=device)
    bm = torch.tensor(rng.normal(size=(MIMO_BATCH, MIMO_M))
                      + 1j * rng.normal(size=(MIMO_BATCH, MIMO_M)), device=device)
    for sched, eng in engines.items():
        counts, text = check_complex_solve(f"complex solve {sched}", eng, As, b,
                                           kernels[sched])
        launched.append(counts)
        print(text, flush=True)
    counts, text = check_complex_solve("MIMO detector solve (col)",
                                       engines["col"], Am, bm,
                                       "qr_packed_complex",
                                       kappa_max=MIMO_KAPPA_MAX)
    launched.append(counts)
    print(text, flush=True)

    # the complex words of [A | I] and both kernels on them
    eye = torch.eye(M, dtype=A.dtype, device=device).expand(BATCH, M, M)
    W = torch.cat([A, eye], dim=-1)
    P = torch.stack([unit.encode(W.real), unit.encode(W.imag)], dim=-1).contiguous()
    tabs, steps = stage_tables(M, N_COLS), givens_schedule(M, N_COLS)
    flat = lambda X: qb.qr_packed_complex_call(X, cfg=g, steps=steps)  # noqa: E731
    wave = lambda X: qb.qr_packed_complex_wavefront_call(X, *tabs, cfg=g)  # noqa: E731
    flat_so = lambda X: qb.qr_packed_complex_call(  # noqa: E731
        X, cfg=g, steps=flat_order(M, N_COLS))
    wave_ms, flat_so_ms = kernel_pair_timing(
        "qr_packed_complex_wavefront against qr_packed_complex on the "
        "flattened stages", P, wave, flat_so)
    flat(P)
    flat_ms, _ = _event_ms(lambda: flat(P), 5)
    decode = unit.decode
    plain = {}
    plain["qr_packed_complex"] = plain_timing(
        "qr_packed_complex", flat, lambda X: qb.qr_packed_complex_reference(
            X, cfg=g, steps=steps), P, decode)
    plain["qr_packed_complex_wavefront"] = plain_timing(
        "qr_packed_complex_wavefront", wave,
        lambda X: qb.qr_packed_complex_wavefront_reference(X, *tabs, cfg=g),
        P, decode)
    print(f"timing at {tuple(P.shape)}: qr_packed_complex {flat_ms:.3f} ms "
          f"(column-major, median of 5); qr_packed_complex_wavefront "
          f"{wave_ms:.3f} ms, qr_packed_complex on the flattened stages "
          f"{flat_so_ms:.3f} ms (medians of 2 x 5, in turns); plain versions "
          f"{plain['qr_packed_complex'][0]:.1f} and "
          f"{plain['qr_packed_complex_wavefront'][0]:.1f} ms for one launch at "
          f"{PLAIN_BATCH} matrices", flush=True)
    orders = {"path": (steps, BATCH, M, M + N_COLS),
              "solve": (givens_schedule(M, N_SOLVE + 1), BATCH, M, N_SOLVE + 1),
              "128x128": (givens_schedule(BIG_M, BIG_M), BIG_BATCH, BIG_M,
                          2 * BIG_M)}
    print("qr_packed_complex (B7a) on the column-major steps: " + "; ".join(
        f"{name} {flat_shape(o[0], *o[1:], device, 'qr_packed_complex')}"
        for name, o in orders.items()), flush=True)

    # 128 x 128 with Q: (128, 256, 2) int64 tiles, 512 KiB, in device memory
    Ab = torch.tensor(complex_operands(BIG_BATCH, BIG_M, BIG_M, SEED + 15),
                      device=device)
    (Qb, Rb), counts = counted_call(engines["sameh_kuck"], Ab)
    launched.append(counts)
    if counts["qr_packed_complex_wavefront"] != 1 or sum(counts.values()) != 1:
        fail(f"complex 128 x 128: launches {counts}")
    Qbf, Rbf = qr_cordic_complex_pallas(Ab, unit, steps=flat_order(BIG_M, BIG_M))
    for name, got, want in (("Q", Qb, Qbf), ("R", Rb, Rbf)):
        compare(f"complex 128 x 128 (device-memory tiles): wavefront {name} "
                f"against qr_packed_complex on the flattened stages",
                torch.view_as_real(got).view(torch.int64),
                torch.view_as_real(want).view(torch.int64))
    text = check_complex_factors("complex 128 x 128", Ab, Qb, Rb, qr_tol(BIG_M))
    eye = torch.eye(BIG_M, dtype=Ab.dtype, device=device).expand(
        BIG_BATCH, BIG_M, BIG_M)
    Wb = torch.cat([Ab, eye], dim=-1)
    Pb = torch.stack([unit.encode(Wb.real), unit.encode(Wb.imag)],
                     dim=-1).contiguous()
    tabs_b = stage_tables(BIG_M, BIG_M)
    big_wave_ms, big_flat_ms = kernel_pair_timing(
        "complex 128 x 128: wavefront against flat on the flattened stages",
        Pb, lambda X: qb.qr_packed_complex_wavefront_call(X, *tabs_b, cfg=g),
        lambda X: qb.qr_packed_complex_call(X, cfg=g,
                                            steps=flat_order(BIG_M, BIG_M)),
        repeats=3)
    print(f"complex at {tuple(Ab.shape)} with Q: tiles {BIG_M} x {2 * BIG_M} x 2 "
          f"int64 ({BIG_M * 2 * BIG_M * 16} B) in device memory; wavefront Q "
          f"and R bit-equal to qr_packed_complex on the flattened stages; "
          f"{text}; qr_packed_complex_wavefront {big_wave_ms:.3f} ms, "
          f"qr_packed_complex {big_flat_ms:.3f} ms on the same words (medians "
          f"of 2 x 3, in turns)", flush=True)
    return dict(ms={"qr_packed_complex": flat_ms,
                    "qr_packed_complex_wavefront": wave_ms},
                flat_stage_order_ms=flat_so_ms, plain=plain,
                per_call=per_call,
                launches=add_counts(*launched),
                shape=list(P.shape), big_ms={"qr_packed_complex": big_flat_ms,
                                             "qr_packed_complex_wavefront":
                                                 big_wave_ms},
                big_shape=list(Pb.shape), words=(P, Pb),
                stages={name: steps_stages(o[0], o[2], o[3])
                        for name, o in orders.items()})


def wavefront_block_phase(A, grid=False):
    """B5a and B5b (B1's and B2's kernels on the Sameh–Kuck stages) at
    other block shapes (`block_lines`), kernel only on their cached table
    (`qb._wavefront_table`): on the HUB words [A | I] of the wavefront
    path at (BATCH, M, 2 M) and, one matrix an SM, at (BIG_BATCH, BIG_M,
    2 BIG_M) (B5a's tiles in device memory, B5b's int32 tiles in shared
    memory): by default at the wrapper's own block shape at the first, and
    at its `FLAT_THREADS` entry and its widened threads at the second; with
    ``grid`` (``--block-grid``) at `FLAT_BLOCKS` and `FLAT_BIG_THREADS`,
    the readings that chose the entries."""
    g = GivensConfig(hub=True, n=26)
    bfp_args = qb._blockfp_args(24, True)
    launchers = {"packed": lambda X, table, tb, th: qb._qr_packed_launch(
                     X, table, g, tb, th, "qr_packed_wavefront"),
                 "blockfp": lambda X, table, tb, th: qb._qr_blockfp_launch(
                     X, table, bfp_args, tb, th, "qr_blockfp_wavefront")}

    def kernel(lane, A):
        X, fns = lane_words(lane, A)
        B, m, e = X.shape
        table = qb._wavefront_table(qb._stage_key(*stage_tables(m, A.shape[2])),
                                    m, e, str(X.device))
        threads = qb._flat_threads(WF_KERNELS[lane], table.shape[2], e, B,
                                   None, str(X.device))
        launch = launchers[lane]
        return threads, tuple(X.shape), (
            lambda tb, th: launch(X, table, tb, th),
            fns["wavefront"](X)), lambda: fns["wavefront"](X)

    big_A = torch.tensor(big_operand(), device=A.device)
    for lane, name in (("packed", "B5a"), ("blockfp", "B5b")):
        threads, shape, main, _ = kernel(lane, A)
        default, big_shape, big, wrapper = kernel(lane, big_A)
        blocks, big_threads = (FLAT_BLOCKS, FLAT_BIG_THREADS) if grid else (
            ((qb.TILE_B, threads),),
            tuple(sorted({qb.FLAT_THREADS[WF_KERNELS[lane]], default})))
        block_lines({name: main}, shape, {name: big}, big_shape,
                    {name: wrapper}, {name: default}, blocks, big_threads)


def complex_block_phase(P, Pb, cfg, grid=False):
    """B7a at other block shapes (`block_lines`) on the column-major steps
    of the complex path's words [A | I] at (BATCH, M, 2 M, 2) and, one
    matrix an SM, at (BIG_BATCH, BIG_M, 2 BIG_M, 2), tiles in device
    memory: by default at the wrapper's own block shape at the first, and
    at its `FLAT_THREADS` entry and its widened threads at the second; with
    ``grid`` (``--block-grid``) at `FLAT_BLOCKS` and `FLAT_BIG_THREADS`,
    the readings that chose the entry."""
    def kernel(X):
        m = X.shape[1]
        steps = givens_schedule(m, m)
        table = qb._flat_stage_table(steps, m, X.shape[2], str(X.device))
        want = qb.qr_packed_complex_call(X, cfg=cfg, steps=steps)
        threads = qb._flat_threads("qr_packed_complex", table.shape[2],
                                   X.shape[2], X.shape[0], None, str(X.device))
        return threads, {"B7a": (lambda tb, th: qb._qr_packed_complex_launch(
            X, table, cfg, tb, th), want)}, (
                lambda: qb.qr_packed_complex_call(X, cfg=cfg, steps=steps))

    threads, main, _ = kernel(P)
    default, big, wrapper = kernel(Pb)
    blocks, big_threads = (FLAT_BLOCKS, FLAT_BIG_THREADS) if grid else (
        ((qb.TILE_B, threads),),
        tuple(sorted({qb.FLAT_THREADS["qr_packed_complex"], default})))
    block_lines(main, tuple(P.shape), big, tuple(Pb.shape), {"B7a": wrapper},
                {"B7a": default}, blocks, big_threads)


# ---------------------------------------------------------------------------
# The packed words on dual int32 lanes (B8a, B8b): ops.qr_packed and
# ops.qr_packed_wavefront with lanes=True
# ---------------------------------------------------------------------------
#: (m, n, compute_q) of the lane kernels' parity phase: every
#: configuration takes the first two, the first configuration all three
#: (on an H100 the plain versions take about 70 ms a step, whatever the
#: batch: B8a's 496 steps took 35.7 s at 64 matrices).
LANE_PARITY_SHAPES = ((4, 4, True), (3, 5, False), (6, 3, True))

#: The batch at which the lane kernels' plain versions are timed: the
#: emulated 64-bit loop issues several thousand PyTorch calls a step, so
#: its time is that of the calls, nearly whatever the batch.
LANE_PLAIN_BATCH = 64

#: Each lane kernel: the TPU kernel it replaces, and the int64 kernel that
#: computes the same words.
LANE_KERNELS = {
    "qr_packed_lanes": ("src/repro/kernels/qrd_blocked.py:229",
                        "qr_packed_lanes_call / _qr_packed_lanes_kernel",
                        "qr_packed"),
    "qr_packed_lanes_wavefront": (
        "src/repro/kernels/qrd_blocked.py:306",
        "qr_packed_lanes_wavefront_call / _qr_packed_lanes_wavefront_kernel",
        "qr_packed_wavefront")}


def lane_kernels(g, steps, tabs):
    """Each lane kernel of ``g`` and its int64 twin (both on their own
    words), and the lane kernel's plain version."""
    return {
        "qr_packed_lanes": (
            lambda L: qb.qr_packed_lanes_call(L, cfg=g, steps=steps),
            lambda P: qb.qr_packed_call(P, cfg=g, steps=steps),
            lambda L: qb.qr_packed_lanes_reference(L, cfg=g, steps=steps)),
        "qr_packed_lanes_wavefront": (
            lambda L: qb.qr_packed_lanes_wavefront_call(L, *tabs, cfg=g),
            lambda P: qb.qr_packed_wavefront_call(P, *tabs, cfg=g),
            lambda L: qb.qr_packed_lanes_wavefront_reference(L, *tabs, cfg=g))}


def lanes_parity_phase(device):
    """B8a and B8b bit-equal to their plain versions, through
    `lanes_to_packed` to B1 and B5a on the same words, and B8b to B8a on
    the flattened stages: the four variants at N = 26 and HUB and IEEE at
    N = 50 (the widest N), random and edge words in one batch, both table
    layouts, ragged batches, and both kernels with their tiles in device
    memory (forced by lowering the shared-memory limit)."""
    rng = np.random.default_rng(SEED + 16)
    layouts = itertools.cycle(qb.TABLE_LAYOUTS)
    configs = parity_configs()[:4] + [GivensConfig(n=50),
                                      GivensConfig(hub=True, n=50)]
    n_cases = 0
    for i, cfg in enumerate(configs):
        for (m, n, cq) in LANE_PARITY_SHAPES[:None if i == 0 else 2]:
            e = n + (m if cq else 0)
            P = torch.cat([encoded_words(cfg, 8, m, n, cq, rng, device),
                           edge_words(cfg, 8, m, e, rng, device)]).contiguous()
            L = cg.packed_to_lanes(P)
            steps, tabs = givens_schedule(m, n), stage_tables(m, n)
            what = f"{cfg} at {tuple(L.shape)}"
            flat = check_plain(f"qr_packed_lanes {what}", qb.qr_packed_lanes_call,
                               qb.qr_packed_lanes_reference, L, cfg=cfg,
                               steps=steps)
            compare(f"qr_packed_lanes {what} against qr_packed",
                    cg.lanes_to_packed(flat),
                    qb.qr_packed_call(P, cfg=cfg, steps=steps))
            wave = check_plain(f"qr_packed_lanes_wavefront {what}",
                               qb.qr_packed_lanes_wavefront_call,
                               qb.qr_packed_lanes_wavefront_reference, L, *tabs,
                               cfg=cfg, table_layout=next(layouts))
            compare(f"qr_packed_lanes_wavefront {what} against "
                    f"qr_packed_wavefront", cg.lanes_to_packed(wave),
                    qb.qr_packed_wavefront_call(P, *tabs, cfg=cfg))
            compare(f"qr_packed_lanes_wavefront {what} against "
                    f"qr_packed_lanes on the flattened stages", wave,
                    qb.qr_packed_lanes_call(L, cfg=cfg, steps=flat_order(m, n)))
            n_cases += 1
    cfg = parity_configs()[2]
    L = cg.packed_to_lanes(encoded_words(cfg, 5, 6, 4, True, rng, device))
    limit = qb.MAX_SHARED_BYTES
    for tile_b, shared in ((4, limit), (2, limit), (2, 0)):
        qb.MAX_SHARED_BYTES = shared          # 0: tiles in device memory
        what = f"{cfg}, tile_b={tile_b}, shared limit {shared} B"
        check_plain(f"qr_packed_lanes {what}", qb.qr_packed_lanes_call,
                    qb.qr_packed_lanes_reference, L, cfg=cfg,
                    steps=givens_schedule(6, 4), tile_b=tile_b)
        check_plain(f"qr_packed_lanes_wavefront {what}",
                    qb.qr_packed_lanes_wavefront_call,
                    qb.qr_packed_lanes_wavefront_reference, L,
                    *stage_tables(6, 4), cfg=cfg, tile_b=tile_b)
        n_cases += 1
    qb.MAX_SHARED_BYTES = limit
    print(f"parity: qr_packed_lanes and qr_packed_lanes_wavefront bit-equal to "
          f"their plain versions and, through lanes_to_packed, to qr_packed and "
          f"qr_packed_wavefront, the wavefront also to qr_packed_lanes on the "
          f"flattened stages, on {n_cases} cases (4 configs at N=26, HUB and "
          f"IEEE at N=50; shapes {[s[:2] for s in LANE_PARITY_SHAPES[:2]]}, "
          f"and {LANE_PARITY_SHAPES[2][:2]} for the first; random + edge words, "
          f"table layouts {qb.TABLE_LAYOUTS}; ragged B=5, tiles in shared and "
          f"in device memory)", flush=True)


def lanes_full_phase(device, A):
    """B8a and B8b at full width: `lanes_to_packed` of each bit-equal to B1
    and B5a on the main path's words, HUB and IEEE at (8192, 32, 64), and
    with the tiles in device memory at (132, 128, 256); HUB timed against
    B1 and B5a on the same words, and the plain versions at
    `LANE_PLAIN_BATCH` matrices."""
    out = {name: {} for name in LANE_KERNELS}
    for label, g in (("hub", GivensConfig(hub=True, n=26)),
                     ("ieee", GivensConfig(n=26))):
        unit = GivensUnit(g)
        eye = torch.eye(M, dtype=A.dtype, device=device).expand(BATCH, M, M)
        P = unit.encode(torch.cat([A, eye], dim=-1)).contiguous()
        L = cg.packed_to_lanes(P)
        fns = lane_kernels(g, givens_schedule(M, N_COLS), stage_tables(M, N_COLS))
        for name, (lane_fn, int64_fn, plain) in fns.items():
            twin = LANE_KERNELS[name][2]
            what = f"{name} ({label}) at {tuple(L.shape)} against {twin}"
            if label == "ieee":
                compare(what, cg.lanes_to_packed(lane_fn(L)), int64_fn(P))
                continue
            ms, twin_ms = kernel_pair_timing(what, L, lane_fn, int64_fn, Y=P,
                                             as_second=cg.lanes_to_packed)
            decode = lambda X: unit.decode(cg.lanes_to_packed(X))  # noqa: E731
            plain_ms, err = plain_timing(name, lane_fn, plain, L, decode,
                                         batch=LANE_PLAIN_BATCH)
            out[name].update(ms=ms, int64_ms=twin_ms, plain_ms=plain_ms,
                             max_abs_err=err, shape=list(L.shape))
    Ab = torch.tensor(big_operand(), device=device)
    e = 2 * BIG_M
    if BIG_M * e * 8 <= qb.MAX_SHARED_BYTES:
        fail(f"{BIG_M} x {e} fits shared memory; the phase needs a larger tile")
    g = GivensConfig(hub=True, n=26)
    eye = torch.eye(BIG_M, dtype=Ab.dtype, device=device).expand(Ab.shape)
    P = GivensUnit(g).encode(torch.cat([Ab, eye], dim=-1)).contiguous()
    L = cg.packed_to_lanes(P)
    fns = lane_kernels(g, givens_schedule(BIG_M, BIG_M), stage_tables(BIG_M, BIG_M))
    for name, (lane_fn, int64_fn, _) in fns.items():
        ms, twin_ms = kernel_pair_timing(
            f"{name} at {tuple(L.shape)} (tiles in device memory) against "
            f"{LANE_KERNELS[name][2]}", L, lane_fn, int64_fn, repeats=3, Y=P,
            as_second=cg.lanes_to_packed)
        out[name].update(device_tile_ms=ms, device_tile_int64_ms=twin_ms,
                         device_tile_shape=list(L.shape))
    for name, r in out.items():
        twin = LANE_KERNELS[name][2]
        print(f"timing {name} at {tuple(r['shape'])}: {r['ms']:.3f} ms, {twin} "
              f"on the same words {r['int64_ms']:.3f} ms "
              f"({r['ms'] / r['int64_ms']:.2f}x; medians of 2 x 5, in turns); "
              f"at {tuple(r['device_tile_shape'])} in device memory "
              f"{r['device_tile_ms']:.3f} ms, {twin} {r['device_tile_int64_ms']:.3f} "
              f"ms (medians of 2 x 3); plain version {r['plain_ms']:.1f} ms for "
              f"one launch at {LANE_PLAIN_BATCH} matrices; HUB and IEEE words "
              f"bit-equal to {twin}'s through lanes_to_packed", flush=True)
    return out


def lanes_path(device, A):
    """The lanes route through its entry points: `ops.qr_packed(lanes=True)`
    and `ops.qr_packed_wavefront(lanes=True)` on the words that
    `qr_cordic_pallas` / `qr_cordic_wavefront` encode from the main path's
    A, HUB and IEEE; each call counted alone, one launch of its lane kernel
    and none of any other; decoded and split, Q and R bit-equal to
    QRDEngine(backend='cordic_pallas') on the column-major and the
    sameh_kuck schedules."""
    launches = {name: 0 for name in LANE_KERNELS}
    eye = torch.eye(M, dtype=A.dtype, device=device).expand(BATCH, M, M)
    for label, g in (("hub", GivensConfig(hub=True, n=26)),
                     ("ieee", GivensConfig(n=26))):
        unit = GivensUnit(g)
        P = unit.encode(torch.cat([A, eye], dim=-1))
        calls = {
            "qr_packed_lanes": ("col", lambda: ops.qr_packed(
                P, cfg=g, steps=givens_schedule(M, N_COLS), lanes=True)),
            "qr_packed_lanes_wavefront": ("sameh_kuck", lambda: ops.qr_packed_wavefront(
                P, cfg=g, stages=sameh_kuck_schedule(M, N_COLS), lanes=True))}
        for name, (sched, call) in calls.items():
            out, counts = counted_call(call)
            want = {k: int(k == name) for k in COUNTERS}
            if counts != want:
                fail(f"lanes path {name} ({label}): launches {counts}, expected "
                     f"{want}")
            launches[name] += counts[name]
            Q, R = split_qr(unit.decode(out), M, N_COLS, True)
            Qe, Re = _engine(device, g, schedule=sched)(A)
            for what, got, ref in (("Q", Q, Qe), ("R", R, Re)):
                compare(f"lanes path {name} ({label}): {what} against "
                        f"QRDEngine(schedule={sched!r})", got.view(torch.int64),
                        ref.view(torch.int64))
    print(f"lanes path: ops.qr_packed(lanes=True) and "
          f"ops.qr_packed_wavefront(lanes=True) at {(BATCH, M, M + N_COLS)}, HUB "
          f"and IEEE: one launch each of its lane kernel ({launches}), Q and R "
          f"bit-equal to QRDEngine(backend='cordic_pallas') on the column-major "
          f"and sameh_kuck schedules", flush=True)
    return launches


def lane_entries(full, path_launches, timing, big):
    """The kernels line's entries of B8a and B8b; the bound is B1's (the
    same elements are rotated), at both shapes."""
    entries = []
    for name, (where, function, twin) in LANE_KERNELS.items():
        r = full[name]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/packed_lanes.cu",
            "replaces": where,
            "replaces_function": function,
            "launches": path_launches[name],
            "launches_per_call": {"ops.qr_packed(lanes=True)"
                                  if name == "qr_packed_lanes" else
                                  "ops.qr_packed_wavefront(lanes=True)": 1},
            "parity": "bit-equal",
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": None,
            "shape": r["shape"],
            "plain_shape": [LANE_PLAIN_BATCH] + r["shape"][1:],
            "plain_ms_is": f"one launch at {LANE_PLAIN_BATCH} matrices",
            "int64_kernel": twin,
            "int64_kernel_ms_same_words": r["int64_ms"],
            "device_tile_ms": r["device_tile_ms"],
            "device_tile_int64_ms": r["device_tile_int64_ms"],
            "device_tile_bound_ms": big["bound_ms"],
            "device_tile_shape": r["device_tile_shape"],
            "config": "hub n=26 iters=24",
        })
    return entries


# ---------------------------------------------------------------------------
# The standalone rotator (B6a, B6b, B6c), the three baselines and the
# quickstart
# ---------------------------------------------------------------------------
#: The rotator's parity cases: batches, row widths (the lead pair included)
#: and CORDIC depths, on random significands and on edge words (which wrap
#: as XLA's int32 does).
ROT_BATCHES = (1, 7, 8, 33, 4099)
ROT_WIDTHS = (1, 2, 5, 128, 300, 1025)
ROT_ITERS = (8, 16, 24, 28, 30)
ROT_EDGE = (0, 1, -1, 2 ** 29 - 1, -(2 ** 29 - 1), -2 ** 31, 2 ** 31 - 1)

#: The rotator at full size, HUB, N = 26 (iters 24), 32 Mi elements an
#: operand (128 MiB of int32): rows of 8 (the paper's 4 x 4 QRD with Q,
#: benchmarks/table6_7_throughput.py's E) and of 128 (the row of its
#: measured_kernel_rate).
ROT_FULL = ((4194304, 8), (262144, 128))
ROT_ITERS_FULL = 24

#: The rotator kernels' names in COUNTERS, the TPU kernels they replace.
ROT_KERNELS = {"vectoring": ("src/repro/kernels/cordic_givens.py:132",
                             "vectoring_call / _vectoring_kernel", "B6a"),
               "rotation": ("src/repro/kernels/cordic_givens.py:171",
                            "rotation_call / _rotation_kernel", "B6b"),
               "fused": ("src/repro/kernels/cordic_givens.py:330",
                         "fused_call / _fused_kernel", "B6c")}

#: The baselines on the card: (backend, dtype) at (batch, m, n), QR and
#: solve; the forward error of a square solve is gated on the matrices of
#: condition number <= BASELINE_KAPPA (the tolerances are documented for
#: well-conditioned inputs), the backward error on all.
BASELINES = (("jnp", "float32"), ("givens_float", "float32"),
             ("givens_float", "complex64"), ("fixed", "float32"))
BASELINE_SHAPES = ((8192, 4, 4), (1024, 32, 32))
BASELINE_KAPPA = 100.0
JNP_CPU_TOL = 1e-4
#: 'fixed' and 'givens_float' on the card against the same call on the CPU,
#: on the first BASELINE_CPU_SLICE matrices of the batch: 'fixed' word for
#: word (its rotations are integer arithmetic), 'givens_float' within
#: GIVENS_FLOAT_CPU_ULPS float32 ulps of 1 (Q) and of max|A| (R).
BASELINE_CPU_SLICE = 64
GIVENS_FLOAT_CPU_ULPS = 32


def rotator_rows(B, W, rng, device, edge=False):
    """(2, B, W) int32 significands uniform(-1.9, 1.9) * 2^24 (as
    tests/test_kernels.py makes them); with ``edge`` a quarter of them are
    edge words."""
    X = np.rint(rng.uniform(-1.9, 1.9, size=(2, B, W)) * 2.0 ** 24)
    X = X.astype(np.int64)
    if edge:
        mask = rng.random(X.shape) < 0.25
        X[mask] = rng.choice(np.array(ROT_EDGE, np.int64), size=int(mask.sum()))
    return torch.tensor(X.astype(np.int32), device=device)


def check_rotator(x, y, kw, what):
    """B6a on column 0 (a strided view), B6b on columns 1: (row stride W),
    B6c on the rows: each bit-equal to its plain version on the same
    tensors, and givens_rotate_rows_fixed bit-equal to the fused rows."""
    v = cg.vectoring_call(x[:, 0], y[:, 0], **kw)
    compare(f"vectoring {what}", v, cg.vectoring_reference(x[:, 0], y[:, 0], **kw))
    r = cg.rotation_call(x[:, 1:], y[:, 1:], v[2], v[3], **kw)
    compare(f"rotation {what}", r,
            cg.rotation_reference(x[:, 1:], y[:, 1:], v[2], v[3], **kw))
    f = cg.fused_call(x, y, **kw)
    compare(f"fused {what}", f, cg.fused_reference(x, y, **kw))
    compare(f"givens_rotate_rows_fixed vs _fused {what}",
            ops.givens_rotate_rows_fixed(x, y, **kw), f)


def rotator_parity_phase(device):
    """B6a, B6b, B6c against their plain versions on every (B, W, iters,
    hub) case, random and edge words; B = 0 launches nothing."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 15)
    n = 0
    for B, W in itertools.product(ROT_BATCHES, ROT_WIDTHS):
        for edge in (False, True):
            X = rotator_rows(B, W, rng, device, edge)
            for iters, hub in itertools.product(ROT_ITERS, (True, False)):
                check_rotator(X[0], X[1], dict(iters=iters, hub=hub),
                              f"B={B} W={W} iters={iters} hub={hub} "
                              f"edge={edge}")
                n += 1
    X = rotator_rows(0, 5, rng, device)
    _, counts = counted_call(lambda: check_rotator(X[0], X[1],
                                                   dict(iters=24, hub=True),
                                                   "B=0"))
    if any(counts.values()):
        fail(f"rotator with B = 0 launched {counts}")
    torch.cuda.synchronize()
    print(f"rotator parity: vectoring, rotation and fused bit-equal to their "
          f"plain versions and givens_rotate_rows_fixed to _fused on {n} "
          f"cases (B in {ROT_BATCHES}, W in {ROT_WIDTHS}, iters in "
          f"{ROT_ITERS}, HUB and conventional, random and edge words); "
          f"B = 0 launches nothing; {time.perf_counter() - t0:.1f} s",
          flush=True)


def _rot_bytes_ops(name, B, L):
    """Elements rotated and bytes moved by one rotator kernel on (B, L) rows
    (each input read once, each output written once)."""
    if name == "vectoring":        # a lead pair in, the pair and (flip, sigma) out
        return B, 24 * B
    if name == "rotation":         # the rows but the lead, and the words read
        return B * (L - 1), 16 * B * (L - 1) + 8 * B
    return B * L, 16 * B * L       # fused, and the row API


def rotator_full_phase(device):
    """The row API at full size: the main path of the rotator, counted;
    then each kernel and the API functions timed (median of 5 warm CUDA
    event timings), the plain versions timed once, all bit-equal."""
    rng = np.random.default_rng(SEED + 16)
    kw = dict(iters=ROT_ITERS_FULL, hub=True)
    rows = [rotator_rows(B, L, rng, device) for B, L in ROT_FULL]
    reset_counts()
    t0 = time.perf_counter()
    outs = [(ops.givens_rotate_rows_fixed(X[0], X[1], **kw),
             ops.givens_rotate_rows_fused(X[0], X[1], **kw)) for X in rows]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = {name: (2 if name in ROT_KERNELS else 0) for name in COUNTERS}
    if counts != want:
        fail(f"rotator main path: launches {counts}, expected {want}")
    print(f"rotator main path: givens_rotate_rows_fixed and _fused at "
          f"{ROT_FULL} (B, L): launches {counts}, {wall:.3f} s wall (first "
          f"calls)", flush=True)
    result = {"launches": {k: counts[k] for k in ROT_KERNELS}, "shapes": {}}
    for (B, L), X, (fixed, fused) in zip(ROT_FULL, rows, outs):
        x, y = X[0], X[1]
        compare(f"givens_rotate_rows_fixed vs _fused at {(B, L)}", fixed, fused)
        v = cg.vectoring_call(x[:, 0], y[:, 0], **kw)
        calls = {"vectoring": (lambda: cg.vectoring_call(x[:, 0], y[:, 0], **kw),
                               lambda: cg.vectoring_reference(x[:, 0], y[:, 0],
                                                              **kw)),
                 "rotation": (lambda: cg.rotation_call(x[:, 1:], y[:, 1:], v[2],
                                                       v[3], **kw),
                              lambda: cg.rotation_reference(x[:, 1:], y[:, 1:],
                                                            v[2], v[3], **kw)),
                 "fused": (lambda: cg.fused_call(x, y, **kw),
                           lambda: cg.fused_reference(x, y, **kw))}
        entry = {}
        for name, (kernel, plain) in calls.items():
            kernel()
            ms, got = _event_ms(kernel, 5)
            plain_ms, want_out = _event_ms(plain, 1)
            compare(f"{name} at {(B, L)} against its plain version", got,
                    want_out)
            elements, nbytes = _rot_bytes_ops(name, B, L)
            bound_ms, bound_by = bfp_bound(True, ROT_ITERS_FULL, elements,
                                           nbytes)
            entry[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by,
                               max_abs_err=max((g - w).abs().max().item()
                                               for g, w in zip(got, want_out)))
        for api in ("givens_rotate_rows_fixed", "givens_rotate_rows_fused"):
            fn = getattr(ops, api)
            fn(x, y, **kw)
            ms, _ = _event_ms(lambda: fn(x, y, **kw), 5)
            bound_ms, bound_by = bfp_bound(True, ROT_ITERS_FULL,
                                           *_rot_bytes_ops("fused", B, L))
            entry[api] = dict(ms=ms, rotations_per_s=B / (ms * 1e-3),
                              bound_ms=bound_ms, bound_by=bound_by)
        result["shapes"][(B, L)] = entry
        print(f"rotator at (B, L) = ({B}, {L}), HUB iters {ROT_ITERS_FULL}, "
              f"{B * L} elements an operand:", flush=True)
        for name, e in entry.items():
            extra = (f"plain {e['plain_ms']:.3f} ms" if "plain_ms" in e else
                     f"{e['rotations_per_s']:.4e} rotations (row pairs)/s")
            print(f"  {name}: {e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
                  f"({e['bound_by']}), {extra}", flush=True)
    return result


def fused_layout_phase(device, grid=False):
    """B6c kernel only (`cg._fused_launch`) at the row API's full shapes,
    HUB, iters `ROT_ITERS_FULL`: by default at the layout its wrapper
    picks (`cg._fused_layout`) on operands it moves in 16-byte vectors;
    with ``grid`` (``--block-grid``) also at every other layout of
    `cg.FUSED_LAYOUTS` that takes the row, and at the kept layout on row
    views of odd stride, which take the single-word path.  Two rounds,
    median of 5 each, every reading bit-equal to the wrapper's words."""
    rng = np.random.default_rng(SEED + 16)
    args = cg._rotator_args(ROT_ITERS_FULL, True)
    for B, L in ROT_FULL:
        X = rotator_rows(B, L, rng, device)
        want = cg.fused_call(X[0], X[1], iters=ROT_ITERS_FULL, hub=True)
        kept = cg._fused_layout(L)
        cases = [(kept, X[0], X[1])]
        if grid:
            cases += [((T, K), X[0], X[1]) for T, K in cg.FUSED_LAYOUTS
                      if (T, K) != kept and (L <= T * K or T == 32)]
            Z = torch.zeros((2, B, L + 1), dtype=torch.int32, device=device)
            Z[..., :L] = X
            cases.append((kept, Z[0, :, :L], Z[1, :, :L]))
        cells = []
        for (T, K), x, y in cases:
            vectors = cg._fused_vectors((x, y, *want))
            cg._fused_launch(x, y, args, T, K)
            ms = []
            for _ in range(2):
                t, out = _event_ms(lambda: cg._fused_launch(x, y, args, T, K),
                                   5)
                compare(f"fused at {T} x {K}, ({B}, {L})", out, want)
                ms.append(t)
            cells.append(f"{T}x{K}{'' if vectors else ' single-word'} "
                         f"{ms[0]:.4f}/{ms[1]:.4f}")
        print(f"fused layouts at (B, L) = ({B}, {L}), threads a row x columns "
              f"a thread, ms (two rounds, median of 5; the wrapper takes "
              f"{kept[0]}x{kept[1]}): " + ", ".join(cells), flush=True)


def _queued_ms(launch, repeats=5):
    """Median ms of ``repeats`` calls of ``launch`` (a ctypes entry point
    that returns its CUDA error) queued behind a sleep of the card, each
    between its own events, so that no host work is inside a window."""
    torch.cuda._sleep(REPLAY_SLEEP_CYCLES)
    events, errs = [], []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        errs.append(launch())
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    for err in errs:
        _launch.check_launch("rotator", err)
    return statistics.median(s.elapsed_time(e) for s, e in events)


def rotator_kernel_phase(device, rounds=2):
    """B6a and B6b kernel only at the row API's full shapes, HUB, iters
    `ROT_ITERS_FULL`: each launched through its ctypes entry point on
    arguments built before the window (`cg._vectoring_argv` and
    `cg._rotation_argv`) and queued behind a sleep of the card
    (`_queued_ms`).  B6a on column 0 of the rows into column 0 of an
    output, as `givens_rotate_rows_fixed` runs it, and into contiguous
    (B,) outputs; B6b on the fixed path's ``x[:, 1:]`` views into the
    output's (a base one word past a 16-byte boundary), on the
    contiguous (B, L) rows, and on a contiguous (B, L - 1) copy (a row
    stride that is not a multiple of 4 words).  ``rounds`` rounds, median
    of 5 each, every reading bit-equal to the plain version.  Returns
    {(B, L): {case: [ms of each round]}}."""
    lib = _launch.lib("rotator")
    rng = np.random.default_rng(SEED + 16)
    kw = dict(iters=ROT_ITERS_FULL, hub=True)
    args = cg._rotator_args(ROT_ITERS_FULL, True)
    result = {}
    for B, L in ROT_FULL:
        X = rotator_rows(B, L, rng, device)
        x, y = X[0], X[1]
        O = torch.empty_like(X)
        flip = torch.empty(B, dtype=torch.int32, device=device)
        sig = torch.empty_like(flip)
        want_v = cg.vectoring_reference(x[:, 0], y[:, 0], **kw)
        cases = {}
        for label, out in (("B6a", (O[0][:, 0], O[1][:, 0])),
                           ("B6a, contiguous outputs",
                            (torch.empty_like(flip), torch.empty_like(flip)))):
            cases[label] = (
                lib.vectoring_launch,
                cg._vectoring_argv(x[:, 0], y[:, 0], *out, flip, sig, args),
                (*out, flip, sig), want_v)
        c = (x[:, 1:].contiguous(), y[:, 1:].contiguous())
        for label, (xs, ys), out in (
                ("B6b x[:, 1:]", (x[:, 1:], y[:, 1:]),
                 (O[0][:, 1:], O[1][:, 1:])),
                ("B6b rows", (x, y), (torch.empty_like(x), torch.empty_like(y))),
                (f"B6b contiguous (B, {L - 1})", c,
                 (torch.empty_like(c[0]), torch.empty_like(c[1])))):
            cases[label] = (lib.rotation_launch,
                            cg._rotation_argv(xs, ys, want_v[2], want_v[3],
                                              *out, args),
                            out, cg.rotation_reference(xs, ys, want_v[2],
                                                       want_v[3], **kw))
        readings = {name: [] for name in cases}
        for _ in range(rounds):
            for name, (fn, argv, got, want) in cases.items():
                for t in got:
                    t.fill_(0)
                readings[name].append(_queued_ms(lambda: fn(*argv)))
                compare(f"{name} kernel only at {(B, L)}", got, want)
        result[B, L] = readings
        print(f"rotator kernel only at (B, L) = ({B}, {L}), HUB iters "
              f"{ROT_ITERS_FULL}, ms ({rounds} rounds, median of 5 each, "
              f"behind a sleep of the card): " + "; ".join(
                  f"{name} " + "/".join(f"{t:.4f}" for t in ms)
                  for name, ms in readings.items()), flush=True)
    return result


def cplx_snr_db(A, Q, R):
    """`snr_db` with |.|^2, for complex factors."""
    num = torch.sum(A.abs() ** 2, dim=(-2, -1))
    den = torch.sum((A - Q @ R).abs() ** 2, dim=(-2, -1))
    return 10.0 * torch.log10(num / torch.clamp(den, min=1e-300))


def _r_normalized(R):
    """R with rows scaled so its diagonal is >= 0 (LAPACK and cuSOLVER may
    pick other reflector signs)."""
    d = torch.sgn(torch.diagonal(R, dim1=-2, dim2=-1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    k = d.shape[-1]
    Rn = R.clone()
    Rn[..., :k, :] = R[..., :k, :] * d.conj()[..., :, None]
    return Rn


def baseline_solve_gate(what, x, A, b, tol):
    """The solve's relative error against a float64 least-squares solve:
    the largest over all matrices printed met or unmet, gated at ``tol`` on
    the matrices of condition number <= BASELINE_KAPPA, and the normwise
    backward error |Ax - b| / (|A| |x| + |b|) gated at ``tol`` on all."""
    ref = torch.linalg.lstsq(A, b[..., None]).solution[..., 0]
    rel = (torch.linalg.vector_norm(x - ref, dim=-1)
           / torch.linalg.vector_norm(ref, dim=-1))
    kappa = torch.linalg.cond(A)
    well = kappa <= BASELINE_KAPPA
    err, err_well = rel.max().item(), rel[well].max().item()
    resid = torch.linalg.vector_norm((A @ x[..., None])[..., 0] - b, dim=-1)
    eta = (resid / (torch.linalg.matrix_norm(A, ord=2)
                    * torch.linalg.vector_norm(x, dim=-1)
                    + torch.linalg.vector_norm(b, dim=-1))).max().item()
    if not (torch.isfinite(torch.view_as_real(x) if x.is_complex() else x).all()
            and err_well <= tol and eta <= tol):
        fail(f"{what}: relative error {err_well} on the matrices with cond <= "
             f"{BASELINE_KAPPA}, backward error {eta} (limit {tol})")
    worst = int(rel.argmax())
    return (f"solve max |x-x_lstsq|/|x_lstsq| {err:.3e} (matrix {worst}, "
            f"cond {kappa[worst].item():.1f}): "
            f"{'met' if err <= tol else f'UNMET on {int((rel > tol).sum())} of {rel.numel()}'}"
            f" against {tol}; gated {err_well:.3e} on {int(well.sum())} with "
            f"cond <= {BASELINE_KAPPA:g}, backward {eta:.3e}")


def baseline_cpu_gate(what, eng, A, Q, R):
    """The card's (Q, R) of a 'fixed' or 'givens_float' engine against the
    same call with device='cpu' on the first BASELINE_CPU_SLICE matrices:
    'fixed' bit-equal, 'givens_float' within GIVENS_FLOAT_CPU_ULPS float32
    ulps of 1 for Q and of max|A| for R."""
    k = min(BASELINE_CPU_SLICE, A.shape[0])
    cfg = eng.config
    Qc, Rc = QRDEngine(cfg, device="cpu")(A[:k].cpu())
    if cfg.backend == "fixed":
        same = torch.equal(Q[:k].cpu(), Qc) and torch.equal(R[:k].cpu(), Rc)
        if not same:
            fail(f"{what}: card differs from the CPU on the first {k} "
                 f"matrices")
        return f"card == CPU word for word on the first {k} matrices"
    ulp = torch.finfo(torch.float32).eps
    amax = A[:k].abs().max().item()
    dQ = (Q[:k].cpu() - Qc).abs().max().item()
    dR = (R[:k].cpu() - Rc).abs().max().item()
    if not (dQ <= GIVENS_FLOAT_CPU_ULPS * ulp
            and dR <= GIVENS_FLOAT_CPU_ULPS * ulp * amax):
        fail(f"{what}: card vs CPU max |dQ| {dQ}, max |dR| {dR} on the "
             f"first {k} matrices (limits {GIVENS_FLOAT_CPU_ULPS} ulps of 1 "
             f"and of max|A| {amax})")
    return (f"card vs CPU on the first {k}: max |dQ| {dQ / ulp:.2f} ulps, "
            f"max |dR| {dR / (ulp * amax):.2f} ulps of max|A| (limit "
            f"{GIVENS_FLOAT_CPU_ULPS})")


def baselines_phase(device):
    """QRDEngine(backend='jnp' | 'givens_float' | 'fixed') on the card: QR
    and solve at both shapes, mean SNR, the solve within SOLVE_TOLERANCES
    (gated as `baseline_solve_gate` says), 'jnp' on the card within
    JNP_CPU_TOL of 'jnp' on the CPU, and the other two held to their CPU
    results (`baseline_cpu_gate`).  These backends launch no kernel of
    the package."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 17)
    out = {}
    for (B, m, n) in BASELINE_SHAPES:
        A = rng.normal(size=(B, m, n))
        Ai = rng.normal(size=(B, m, n))
        b = rng.normal(size=(B, m))
        bi = rng.normal(size=(B, m))
        for backend, dtype in BASELINES:
            cplx = dtype.startswith("complex")
            Ad = torch.tensor(A + 1j * Ai if cplx else A, device=device)
            bd = torch.tensor(b + 1j * bi if cplx else b, device=device)
            eng = QRDEngine(backend=backend, dtype=dtype, device=device)
            t1 = time.perf_counter()
            (Q, R), counts = counted_call(eng, Ad)
            x, solve_counts = counted_call(eng.solve, Ad, bd)
            wall = time.perf_counter() - t1
            if any(counts.values()) or any(solve_counts.values()):
                fail(f"{backend}: launched {counts} {solve_counts}")
            want_dtype = (getattr(torch, dtype) if backend != "fixed"
                          else torch.float64)
            if (Q.shape != (B, m, m) or R.shape != (B, m, n)
                    or R.dtype != want_dtype
                    or not torch.isfinite(torch.view_as_real(R) if cplx else R).all()
                    or not torch.isfinite(torch.view_as_real(Q) if cplx else Q).all()):
                fail(f"{backend} {dtype} at {(B, m, n)}: Q {tuple(Q.shape)} R "
                     f"{tuple(R.shape)} {R.dtype}, or not finite")
            Q64 = Q.to(torch.complex128 if cplx else torch.float64)
            R64 = R.to(Q64.dtype)
            snr = (cplx_snr_db(Ad, Q64, R64) if cplx
                   else port_snr_db(Ad, Q, R)).mean().item()
            key = backend + (":complex" if cplx else "")
            gate = baseline_solve_gate(f"{backend} {dtype} solve at {(B, m, n)}",
                                       x, Ad, bd, SOLVE_TOLERANCES[key])
            line = (f"baseline {backend} {dtype} at {(B, m, n)}: mean SNR "
                    f"{snr:.2f} dB; {gate}; {wall:.3f} s wall")
            if backend == "jnp":
                Qc, Rc = QRDEngine(backend="jnp", device="cpu")(A)
                dR = (_r_normalized(R).cpu() - _r_normalized(Rc)).abs().max().item()
                dQR = (Q @ R).cpu().sub(Qc @ Rc).abs().max().item()
                if not (dR <= JNP_CPU_TOL and dQR <= JNP_CPU_TOL):
                    fail(f"jnp at {(B, m, n)}: card vs CPU max |dR| {dR}, "
                         f"max |d(QR)| {dQR} (limit {JNP_CPU_TOL})")
                line += (f"; card vs CPU max |dR| (diag R >= 0) {dR:.3e}, "
                         f"max |d(QR)| {dQR:.3e} (limit {JNP_CPU_TOL})")
            else:
                line += "; " + baseline_cpu_gate(
                    f"{backend} {dtype} at {(B, m, n)}", eng, Ad, Q, R)
            print(line, flush=True)
            out[backend, dtype, (B, m, n)] = snr
    print(f"baselines: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def quickstart_phase():
    """examples/torch_quickstart.main('cuda') to its end, its own
    assertions included, with the counts set to 0 just before and read
    just after: its cordic_pallas QRD launches qr_packed once."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "examples"))
    import torch_quickstart
    t0 = time.perf_counter()
    res, counts = counted_call(torch_quickstart.main, "cuda")
    want = {name: int(name == "qr_packed") for name in COUNTERS}
    if counts != want:
        fail(f"quickstart: launches {counts}, expected {want}")
    print(f"quickstart: torch_quickstart.main('cuda') passed its assertions "
          f"in {time.perf_counter() - t0:.1f} s; launches {counts}; {res}",
          flush=True)
    return counts


def _rot_shape(name, B, L):
    """The operand shape of a rotator kernel on (B, L) rows."""
    return {"vectoring": [B], "rotation": [B, L - 1], "fused": [B, L]}[name]


def rotator_entries(rot, kernel_only):
    """The kernels line's entries of B6a, B6b and B6c from
    `rotator_full_phase`'s result (times at rows of 8, with those at rows
    of 128 beside them) and, for B6a and B6b, `rotator_kernel_phase`'s
    (``kernel_only``); prints the row API's rates."""
    entries = []
    (B8, L8), (B128, L128) = ROT_FULL
    # the kernel-only cases that read each kernel as the fixed path runs it
    case = {"vectoring": "B6a", "rotation": "B6b x[:, 1:]"}
    for name, (where, function, tag) in ROT_KERNELS.items():
        e8 = rot["shapes"][B8, L8][name]
        e128 = rot["shapes"][B128, L128][name]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rotator.cu",
            "replaces": where,
            "replaces_function": function,
            "tpu_kernel": tag,
            "launches": rot["launches"][name],
            "launches_per_call": ({"givens_rotate_rows_fused": 1}
                                  if name == "fused" else
                                  {"givens_rotate_rows_fixed": 1}),
            "parity": "bit-equal",
            "max_abs_err": max(e8["max_abs_err"], e128["max_abs_err"]),
            "ms": e8["ms"],
            "plain_ms": e8["plain_ms"],
            "bound_ms": e8["bound_ms"],
            "bound_by": e8["bound_by"],
            "library_ms": None,
            "shape": _rot_shape(name, B8, L8),
            "ms_is": "median of 5 warm launches",
            "plain_ms_is": "one call on the same tensors",
            "l128_ms": e128["ms"],
            "l128_plain_ms": e128["plain_ms"],
            "l128_bound_ms": e128["bound_ms"],
            "l128_shape": _rot_shape(name, B128, L128),
            "config": f"hub iters={ROT_ITERS_FULL}",
        })
        if name in case:
            entries[-1].update(
                kernel_only_ms=kernel_only[B8, L8][case[name]],
                l128_kernel_only_ms=kernel_only[B128, L128][case[name]],
                kernel_only_ms_is="two rounds, median of 5 each, launched "
                                  "through the ctypes entry point")
    print_row_api(rot)
    return entries


def print_row_api(rot):
    """The row API's times and rates from `rotator_full_phase`'s result."""
    for api in ("givens_rotate_rows_fixed", "givens_rotate_rows_fused"):
        print(f"{api}: " + ", ".join(
            f"(B, L) = {shape}: {e[api]['ms']:.4f} ms, "
            f"{e[api]['rotations_per_s']:.4e} rotations/s, bound "
            f"{e[api]['bound_ms']:.4f} ms" for shape, e in rot["shapes"].items()),
            flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--block-grid", action="store_true",
                        help="read B5a, B5b and B7a at every block shape "
                             "of FLAT_BLOCKS and FLAT_BIG_THREADS, not only "
                             "their own, B4b kernel only at every count of "
                             "APPLY_SLOTS, and B6c at every layout of "
                             "cg.FUSED_LAYOUTS")
    args = parser.parse_args()
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

    return run(device, args.block_grid)


def run(device, block_grid=False):
    """Every phase on ``device``; returns 0 or exits non-zero."""
    t0 = time.perf_counter()
    sources = ["qr_packed", "panel_packed", "blockfp",
               "complex_packed", "rotator", "packed_lanes"]
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
    flat_block_phase(A, cfg)
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
    panel_replay_phase({"block-FP panel": bfp_panel, "block-FP tsqr": bfp_tsqr},
                       block_grid)
    tall = tall_tsqr_phase(device)

    wavefront_parity_phase(device)
    wave = {lane: wavefront_path(device, lane, A, As, b) for lane in LANES}
    wave_big = wavefront_big_phase(device)
    wavefront_block_phase(A, block_grid)
    complex_parity_phase(device)
    cplx = complex_path(device)
    complex_block_phase(*cplx["words"], cfg, block_grid)
    t_lanes = time.perf_counter()
    lanes_parity_phase(device)
    lanes = lanes_full_phase(device, A)
    lane_launches = lanes_path(device, A)
    print(f"lanes phases: {time.perf_counter() - t_lanes:.1f} s", flush=True)
    rotator_parity_phase(device)
    rot = rotator_full_phase(device)
    fused_layout_phase(device, block_grid)
    rot_kernel = rotator_kernel_phase(device)
    baselines_phase(device)
    quickstart_phase()

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
    bfp_elements = BATCH * active_elements(M, N_COLS, M + N_COLS)
    wave_bounds = {"packed": (timing["bound_ms"], timing["bound_by"]),
                   "blockfp": (bfp_timing["bound_ms"], bfp_timing["bound_by"])}
    wave_src = {"packed": ("src/repro/kernels/qrd_blocked.py:587",
                           "qr_packed_wavefront_call / "
                           "_qr_packed_wavefront_kernel", timing),
                "blockfp": ("src/repro/kernels/qrd_blocked.py:637",
                            "qr_blockfp_wavefront_call / "
                            "_qr_blockfp_wavefront_kernel", bfp_timing)}
    for lane, (where, function, flat_timing) in wave_src.items():
        w = wave[lane]
        bound_ms, bound_by = wave_bounds[lane]
        entry = {
            "name": WF_KERNELS[lane],
            "route": "cuda",
            "source": ("src/repro_torch/kernels/csrc/qr_packed.cu"
                       if lane == "packed" else
                       "src/repro_torch/kernels/csrc/blockfp.cu"),
            "replaces": where,
            "replaces_function": function,
            "launches": w["launches"] + (wave_big["launches"]
                                         if lane == "packed" else 0),
            "launches_per_engine_call": w["per_call"],
            "parity": "bit-equal",
            "max_abs_err": w["max_abs_err"],
            "ms": w["ms"],
            "plain_ms": w["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "shape": w["shape"],
            "plain_shape": [PLAIN_BATCH] + w["shape"][1:],
            "plain_ms_is": f"one launch at {PLAIN_BATCH} matrices",
            "flat_kernel_ms_same_words": w["flat_ms"],
            "flat_kernel_ms_main_timing": flat_timing["ms"],
            "config": ("hub n=26 iters=24" if lane == "packed"
                       else "hub iters=24 frac=24"),
        }
        if lane == "packed":
            entry.update(device_tile_ms=wave_big["ms"],
                         device_tile_flat_ms=wave_big["flat_ms"],
                         device_tile_shape=wave_big["shape"])
        kernels.append(entry)
    cplx_src = {"qr_packed_complex": ("src/repro/kernels/qrd_blocked.py:358",
                                      "qr_packed_complex_call / "
                                      "_qr_packed_complex_kernel"),
                "qr_packed_complex_wavefront": (
                    "src/repro/kernels/qrd_blocked.py:468",
                    "qr_packed_complex_wavefront_call / "
                    "_qr_packed_complex_wavefront_kernel")}
    # four packed pair rotations per complex element column, on twice the
    # bytes of the real tile
    cplx_bound = _bound(cfg, 4 * bfp_elements, 2 * BATCH * M * (M + N_COLS) * 16)
    for name, (where, function) in cplx_src.items():
        plain_ms, err = cplx["plain"][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/complex_packed.cu",
            "replaces": where,
            "replaces_function": function,
            "launches": cplx["launches"][name],
            "launches_per_engine_call": cplx["per_call"][name],
            "parity": "bit-equal",
            "max_abs_err": err,
            "ms": cplx["ms"][name],
            "plain_ms": plain_ms,
            "bound_ms": cplx_bound[0],
            "bound_by": cplx_bound[1],
            "library_ms": None,
            "shape": cplx["shape"],
            "plain_shape": [PLAIN_BATCH] + cplx["shape"][1:],
            "plain_ms_is": f"one launch at {PLAIN_BATCH} matrices",
            "real_qr_packed_ms_same_shape": timing["ms"],
            "device_tile_ms": cplx["big_ms"][name],
            "device_tile_shape": cplx["big_shape"],
            "config": "hub n=26 iters=24",
        })
    for entry in kernels:
        lane = {"panel_factor_packed": "packed",
                "panel_factor_blockfp": "blockfp"}.get(entry["name"])
        if lane:
            t = tall[lane]
            w = t["work"][entry["name"]]
            entry.update(
                device_panel_ms=t["ms"],
                device_panel_bound_ms=(
                    _bound(cfg, w["elements"], w["bytes"]) if lane == "packed"
                    else bfp_bound(True, 24, w["elements"], w["bytes"]))[0],
                device_panel_launches=t["launches"],
                device_panel_shape=t["shape"], device_panel_tile=t["panel"])
    kernels += lane_entries(lanes, lane_launches, timing, big)
    kernels += rotator_entries(rot, rot_kernel)
    stages = {
        "qr_packed": {"path": steps_stages(givens_schedule(M, N_COLS), M,
                                           M + N_COLS),
                      "solve": steps_stages(givens_schedule(M, N_SOLVE + 1), M,
                                            N_SOLVE + 1)},
        "qr_packed_complex": cplx["stages"],
        "qr_packed_wavefront": {"path": (len(flat_order(M, N_COLS)),
                                         len(sameh_kuck_schedule(M, N_COLS)))}}
    for name, panel_work, tsqr_work_ in (
            ("panel_factor_packed", panel["work"], tsqr["work"]),
            ("panel_factor_blockfp", bfp_panel["work"], bfp_tsqr["work"]),
            ("panel_apply_blockfp", bfp_panel["work"], bfp_tsqr["work"])):
        stages[name] = {path: (w[name]["steps"], w[name]["stages"])
                        for path, w in (("panel", panel_work),
                                        ("tsqr", tsqr_work_))}
    labels = {"qr_packed": "B1", "qr_packed_complex": "B7a",
              "qr_packed_wavefront": "B5a", "panel_factor_packed": "B3a",
              "panel_factor_blockfp": "B4a", "panel_apply_blockfp": "B4b"}
    print("steps -> stages per engine call: " + "; ".join(
        f"{name} ({labels[name]}) " + ", ".join(
            f"{path} {st} -> {sg}" for path, (st, sg) in by_path.items())
        for name, by_path in stages.items()), flush=True)
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
