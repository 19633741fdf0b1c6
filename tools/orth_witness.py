#!/usr/bin/env python3
"""The unit's loss of orthogonality at 64 x 64 and 128 x 128, and the
block-FP TSQR solve's error at 4096 x 32, read by the JAX package and by
the port's plain version on the CPU.

    PYTHONPATH=src python tools/orth_witness.py --panel-ieee I --big-hub J
    PYTHONPATH=src python tools/orth_witness.py --blockfp-tsqr-solve K
    PYTHONPATH=src python tools/orth_witness.py --packed-tsqr-solve K

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
With ``--out`` it also writes the readings as JSON.  Each case takes
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
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    ok = all(r["q_r_bit_equal"] if "q_r_bit_equal" in r
             else r["x_max_diff"] <= 1e-12 for r in results)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
