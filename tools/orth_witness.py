#!/usr/bin/env python3
"""The unit's loss of orthogonality at 64 x 64 and 128 x 128, and the
block-FP TSQR solve's error at 4096 x 32, read by the JAX package and by
the port's plain version on the CPU.

    PYTHONPATH=src python tools/orth_witness.py --panel-ieee I --big-hub J
    PYTHONPATH=src python tools/orth_witness.py --blockfp-tsqr-solve K
    PYTHONPATH=src python tools/orth_witness.py --packed-tsqr-solve K
    PYTHONPATH=src python tools/orth_witness.py --complex K --big-complex J
    PYTHONPATH=src python tools/orth_witness.py --mimo-solve K

``chip_smoke.py`` prints, for its panel path (1024 x 64 x 64, IEEE N = 26)
and for the flat route beyond shared memory (132 x 128 x 128, HUB N = 26),
the index of the matrix with the largest |QtQ - I| (Frobenius).  This
script rebuilds those operands from the same seeds, takes matrix I of the
first and matrix J of the second, and factorizes each with the JAX
package's `repro.qrd.QRDEngine` (backend ``cordic_pallas``, panel route,
Pallas in interpret mode) and with the port's `QRDEngine(device='cpu')`,
whose panel kernels run their plain versions there.  It prints, per matrix,
both packages' |QR - A|/|A| and |QtQ - I|, whether their Q and R are
bit-equal, and numpy's float64 Householder QR for scale.  For the TSQR
solve (32 x 4096 x 32, one right-hand side, HUB N = 26; ``blockfp_pallas``
iters 24 or ``cordic_pallas``) it takes matrix K of
``chip_smoke.tsqr_operands()`` (the matrix with the largest relative error
that ``chip_smoke.py`` prints for that lane), solves it with both
packages, and prints both relative errors against numpy's least-squares
solve and the largest difference between the two solutions (their R
factors are bit-equal; the back-substitutions sum in their own orders).
For the complex datapath (``cordic_pallas``, ``dtype='complex128'``, HUB
N = 26) ``--complex K`` takes matrix K of the 32 x 32 complex operand of
``chip_smoke.complex_path`` and ``--big-complex J`` matrix J of its
128 x 128 one (the worst matrices ``chip_smoke.py`` prints), factorizes
each on both schedules with the JAX package (its complex wavefront kernel
body, jitted outside Pallas, on the Sameh–Kuck stages or on the
column-major steps as one-step stages, which the JAX package holds equal
to its flat complex kernel) and with the port on the CPU, and prints both
packages' largest |QR - A| and |QhQ - I| (elementwise, the JAX package's
complex limit is 2e-5 at 5 x 4) and per matrix (Frobenius), and whether
their Q and R are bit-equal.  ``--mimo-solve K`` solves matrix K of the
MIMO detector's 4 x 4 complex batch of ``chip_smoke.complex_path`` with
its right-hand side in both packages (the JAX package's ``cordic``
backend, bit-identical to its ``cordic_pallas``) and prints both relative
errors against numpy, the matrix's condition number and both solutions'
largest difference.  With ``--out`` it also writes the readings as JSON.  Each case takes
minutes on one CPU core.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from repro.core.givens import GivensConfig as JConfig  # noqa: E402
from repro.qrd import QRDConfig as JQRDConfig  # noqa: E402
from repro.qrd import QRDEngine as JEngine  # noqa: E402
from repro_torch.core.givens import GivensConfig  # noqa: E402
from repro_torch.qrd import QRDEngine  # noqa: E402


def errors(A, Q, R):
    """|QR - A|/|A| and |QtQ - I| (Frobenius), in float64 with numpy."""
    Q, R = np.asarray(Q, np.float64), np.asarray(R, np.float64)
    resid = np.linalg.norm(Q @ R - A) / np.linalg.norm(A)
    orth = np.linalg.norm(Q.T @ Q - np.eye(Q.shape[1]))
    return float(resid), float(orth)


def witness(label, A, hub):
    """One matrix through both packages and numpy; returns the readings."""
    t0 = time.perf_counter()
    Qj, Rj = JEngine(JQRDConfig(backend="cordic_pallas",
                                givens=JConfig(hub=hub, n=26)))(A)
    Qj, Rj = np.asarray(Qj), np.asarray(Rj)
    t1 = time.perf_counter()
    Qt, Rt = QRDEngine(backend="cordic_pallas", dtype="float64",
                       givens=GivensConfig(hub=hub, n=26), device="cpu")(A)
    Qt, Rt = Qt.numpy(), Rt.numpy()
    t2 = time.perf_counter()
    bits = (np.array_equal(Qj.view(np.int64), Qt.view(np.int64))
            and np.array_equal(Rj.view(np.int64), Rt.view(np.int64)))
    out = {"case": label, "hub": hub, "shape": list(A.shape),
           "jax": dict(zip(("resid", "orth"), errors(A, Qj, Rj))),
           "port_cpu": dict(zip(("resid", "orth"), errors(A, Qt, Rt))),
           "numpy_householder": dict(zip(("resid", "orth"),
                                         errors(A, *np.linalg.qr(A)))),
           "q_r_bit_equal": bool(bits), "jax_s": t1 - t0, "port_s": t2 - t1}
    print(json.dumps(out), flush=True)
    return out


class _Ref:
    """A stand-in for a Pallas ref, so a JAX kernel body runs outside
    Pallas."""

    def __init__(self, v=None):
        self.v = v

    def __getitem__(self, idx):
        return self.v

    def __setitem__(self, idx, v):
        self.v = v


def complex_errors(A, Q, R):
    """Largest |QR - A| and |QhQ - I| (elementwise), and |QR - A|/|A| and
    |QhQ - I| (Frobenius), in complex128 with numpy."""
    Q, R = np.asarray(Q, np.complex128), np.asarray(R, np.complex128)
    D = Q @ R - A
    O = Q.conj().T @ Q - np.eye(Q.shape[1])
    return {"max_abs_resid": float(np.abs(D).max()),
            "max_abs_orth": float(np.abs(O).max()),
            "resid": float(np.linalg.norm(D) / np.linalg.norm(A)),
            "orth": float(np.linalg.norm(O))}


def complex_witness(label, A, schedule):
    """One complex matrix through both packages on ``schedule``; returns
    the readings."""
    import jax
    import jax.numpy as jnp
    from repro.core import qrd as jq
    from repro.core.givens import GivensUnit as JUnit
    from repro.kernels import ops as jops
    from repro.kernels import qrd_blocked as jqb

    m, n = A.shape
    unit = JUnit(JConfig(hub=True, n=26))
    stages = (jq.sameh_kuck_schedule(m, n) if schedule == "sameh_kuck"
              else tuple((s,) for s in jq.givens_schedule(m, n)))
    tables = jops._stage_tables(stages, m)

    def body(P, piv, tgt, col):
        out = _Ref()
        jqb._qr_packed_complex_wavefront_kernel(
            _Ref(piv), _Ref(tgt), _Ref(col), _Ref(P), out, cfg=unit.cfg,
            S=piv.shape[0], table_layout="split")
        return out.v

    t0 = time.perf_counter()
    P = jq._encode_complex(unit, jq._augment_complex(jnp.asarray(A[None]),
                                                     True))
    words = jax.jit(body)(P, *(jnp.asarray(t) for t in tables))
    Qj, Rj = (np.asarray(x)[0] for x in jq._split_qr_complex(
        jq._decode_complex(unit, words), m, n, True))
    t1 = time.perf_counter()
    Qt, Rt = QRDEngine(backend="cordic_pallas", dtype="complex128",
                       schedule=schedule, givens=GivensConfig(hub=True, n=26),
                       device="cpu")(A)
    Qt, Rt = (np.ascontiguousarray(x.resolve_conj().numpy()) for x in (Qt, Rt))
    Qj, Rj = np.ascontiguousarray(Qj), np.ascontiguousarray(Rj)
    t2 = time.perf_counter()
    bits = (np.array_equal(Qj.view(np.int64), Qt.view(np.int64))
            and np.array_equal(Rj.view(np.int64), Rt.view(np.int64)))
    out = {"case": label, "schedule": schedule, "shape": list(A.shape),
           "jax": complex_errors(A, Qj, Rj),
           "port_cpu": complex_errors(A, Qt, Rt),
           "numpy_householder": complex_errors(A, *np.linalg.qr(A)),
           "q_r_bit_equal": bool(bits), "jax_s": t1 - t0, "port_s": t2 - t1}
    print(json.dumps(out), flush=True)
    return out


def mimo_witness(i):
    """Matrix i of the complex path's MIMO batch solved by both packages;
    returns the readings."""
    rng = np.random.default_rng(chip_smoke.SEED + 12)
    rng.normal(size=(2, chip_smoke.BATCH, chip_smoke.M))   # the 32 x 16 rhs
    shape = (chip_smoke.MIMO_BATCH, chip_smoke.MIMO_M)
    b = (rng.normal(size=shape) + 1j * rng.normal(size=shape))[i]
    A = chip_smoke.complex_operands(chip_smoke.MIMO_BATCH, chip_smoke.MIMO_M,
                                    chip_smoke.MIMO_M, chip_smoke.SEED + 14)[i]
    t0 = time.perf_counter()
    xj = np.asarray(JEngine(JQRDConfig(backend="cordic", dtype="complex128",
                                       givens=JConfig(hub=True, n=26)))
                    .solve(A, b))
    t1 = time.perf_counter()
    xt = QRDEngine(backend="cordic_pallas", dtype="complex128",
                   givens=GivensConfig(hub=True, n=26),
                   device="cpu").solve(A, b).numpy()
    t2 = time.perf_counter()
    ref = np.linalg.solve(A, b)
    rel = lambda x: float(np.linalg.norm(x - ref) / np.linalg.norm(ref))  # noqa: E731
    out = {"case": f"MIMO batch [{i}] solve", "shape": list(A.shape),
           "cond": float(np.linalg.cond(A)),
           "jax_rel": rel(xj), "port_cpu_rel": rel(xt),
           "x_max_diff": float(np.abs(xj - xt).max()),
           "jax_s": t1 - t0, "port_s": t2 - t1}
    print(json.dumps(out), flush=True)
    return out


def solve_witness(i, backend):
    """Matrix i of the TSQR operands solved on ``backend``'s lane by both
    packages; returns the readings."""
    A, b = (a[i] for a in chip_smoke.tsqr_operands())
    kw = dict(backend=backend)
    if backend == "blockfp_pallas":
        kw.update(hub=True, iters=24)
    t0 = time.perf_counter()
    xj = np.asarray(JEngine(JQRDConfig(givens=JConfig(hub=True, n=26),
                                       **kw)).solve(A, b))
    t1 = time.perf_counter()
    xt = QRDEngine(dtype="float64", givens=GivensConfig(hub=True, n=26),
                   device="cpu", **kw).solve(A, b).numpy()
    t2 = time.perf_counter()
    ref = np.linalg.lstsq(A, b, rcond=None)[0]
    rel = lambda x: float(np.linalg.norm(x - ref) / np.linalg.norm(ref))  # noqa: E731
    out = {"case": f"tsqr_operands()[{i}] solve", "backend": backend,
           "shape": list(A.shape),
           "jax_rel": rel(xj), "port_cpu_rel": rel(xt),
           "jax_abs": float(np.abs(xj - ref).max()),
           "port_cpu_abs": float(np.abs(xt - ref).max()),
           "x_max_diff": float(np.abs(xj - xt).max()),
           "jax_s": t1 - t0, "port_s": t2 - t1}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--panel-ieee", type=int,
                    help="index into chip_smoke.panel_operand() (IEEE N=26)")
    ap.add_argument("--big-hub", type=int,
                    help="index into chip_smoke.big_operand() (HUB N=26)")
    ap.add_argument("--blockfp-tsqr-solve", type=int,
                    help="index into chip_smoke.tsqr_operands() (block-FP)")
    ap.add_argument("--packed-tsqr-solve", type=int,
                    help="index into chip_smoke.tsqr_operands() (packed)")
    ap.add_argument("--complex", type=int, dest="complex_",
                    help="index into the complex path's 32 x 32 operand")
    ap.add_argument("--big-complex", type=int,
                    help="index into the complex path's 128 x 128 operand")
    ap.add_argument("--mimo-solve", type=int,
                    help="index into the complex path's MIMO 4 x 4 batch")
    ap.add_argument("--out", help="write the readings here as JSON")
    args = ap.parse_args(argv)
    results = []
    if args.panel_ieee is not None:
        results.append(witness(f"panel_operand()[{args.panel_ieee}]",
                               chip_smoke.panel_operand()[args.panel_ieee],
                               hub=False))
    if args.big_hub is not None:
        results.append(witness(f"big_operand()[{args.big_hub}]",
                               chip_smoke.big_operand()[args.big_hub],
                               hub=True))
    if args.blockfp_tsqr_solve is not None:
        results.append(solve_witness(args.blockfp_tsqr_solve,
                                     "blockfp_pallas"))
    if args.packed_tsqr_solve is not None:
        results.append(solve_witness(args.packed_tsqr_solve, "cordic_pallas"))
    for index, (B, m, seed) in ((args.complex_, (chip_smoke.BATCH, chip_smoke.M,
                                                 chip_smoke.SEED + 11)),
                                (args.big_complex, (chip_smoke.BIG_BATCH,
                                                    chip_smoke.BIG_M,
                                                    chip_smoke.SEED + 15))):
        if index is None:
            continue
        A = chip_smoke.complex_operands(B, m, m, seed)[index]
        for schedule in ("col", "sameh_kuck"):
            results.append(complex_witness(
                f"complex_operands({B}, {m}, {m})[{index}]", A, schedule))
    if args.mimo_solve is not None:
        results.append(mimo_witness(args.mimo_solve))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    ok = all(r["q_r_bit_equal"] if "q_r_bit_equal" in r
             else r["x_max_diff"] <= 1e-12 for r in results)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
