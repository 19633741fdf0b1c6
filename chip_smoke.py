#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the main path from ``src/repro_torch/kernels/
csrc``, holds each against its plain PyTorch version on the card, drives
the main path — ``QRDEngine(backend='cordic_pallas')`` and ``.solve`` — at
full width, checks the results, and prints one JSON line describing each
kernel followed by a final ``{"ok": true, "device": ...}`` line.  Any
failed phase exits non-zero.  There is no CPU fallback: without a CUDA
device the script fails.  It imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

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
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import qrd_blocked as qb  # noqa: E402
from repro_torch.qrd import QRDEngine, SOLVE_TOLERANCES  # noqa: E402

SEED = 0

#: Main-path shapes: a batch of 32 x 32 decompositions with Q, and a batch
#: of 32 x 16 least-squares problems with one right-hand side.
BATCH, M, N_COLS, N_SOLVE = 8192, 32, 32, 16

#: Accuracy limits of the main path: relative QR residual and loss of
#: orthogonality, per matrix (Frobenius norms); the unit's 26-bit
#: significand gives about 1e-6 at this size.
QR_TOL = 1e-5

#: INT32 ALU rate of an H100 SXM: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz
#: boost clock (Hopper architecture white paper), and its HBM3 bandwidth.
INT32_OPS_PER_S = 64 * 132 * 1.98e9
HBM_BYTES_PER_S = 3.35e12

#: Operation count of the packed datapath, per rotated element per
#: rotation: 8 per micro-rotation, 12 for the gain multiply, 80 for the two
#: converters, times 2 for 64-bit words on 32-bit ALUs.
OPS_PER_MICROROTATION, OPS_GAIN, OPS_CONVERT, INT64_WORD_FACTOR = 8, 12, 80, 2


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
    eye = torch.eye(A.shape[-2], dtype=A.dtype, device=A.device)
    fro = lambda X: torch.linalg.matrix_norm(X)  # noqa: E731
    resid = (fro(Q @ R - A) / fro(A)).max().item()
    orth = fro(Q.transpose(-1, -2) @ Q - eye).max().item()
    return resid, orth


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

    qb.QR_PACKED_LAUNCHES = 0
    t0 = time.perf_counter()
    results = {name: eng(A) for name, eng in engines.items()}
    x = engines["hub"].solve(As, b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = qb.QR_PACKED_LAUNCHES

    if launches < 3:
        fail(f"main path launched qr_packed {launches} times, expected 3")
    for name, (Q, R) in results.items():
        if not (torch.isfinite(Q).all() and torch.isfinite(R).all()):
            fail(f"{name}: non-finite factors")
        if Q.shape != (BATCH, M, M) or R.shape != (BATCH, M, N_COLS):
            fail(f"{name}: shapes {tuple(Q.shape)} {tuple(R.shape)}")
        if torch.count_nonzero(torch.tril(R, -1)).item() != 0:
            fail(f"{name}: R has non-zero entries below the diagonal")
        resid, orth = qr_errors(A, Q, R)
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
    print(f"main path: {launches} qr_packed launches, {wall:.3f} s wall "
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


def bound(cfg, B, m, n, e):
    """Least time for the work: int64 operations over the INT32 ALU rate,
    against two passes over the tile at HBM bandwidth."""
    per_elem = (OPS_PER_MICROROTATION * cfg.resolved_iters() + OPS_GAIN
                + OPS_CONVERT) * INT64_WORD_FACTOR
    ops_ms = B * active_elements(m, n, e) * per_elem / INT32_OPS_PER_S * 1e3
    bytes_ms = 2 * B * m * e * 8 / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


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

    t0 = time.perf_counter()
    _build.build(["qr_packed"])
    info = _build.BUILD_INFO.get("qr_packed", {})
    print(f"build: qr_packed.cu in {time.perf_counter() - t0:.1f} s; ptxas: "
          f"{' | '.join(info.get('ptxas', []))}", flush=True)

    parity_phase(device)
    launches, A, As, b, cfg = main_path(device)
    timing = timing_phase(A, As, b, cfg)

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
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
