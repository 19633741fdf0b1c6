"""Quickstart on the PyTorch port: the FP Givens rotation unit and the
solver-grade QRD API, on the GPU.

    PYTHONPATH=src python examples/torch_quickstart.py               # GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # CPU

The same five steps as ``examples/quickstart.py``, on `repro_torch`.  On
the CPU every kernel's plain PyTorch version runs instead of the kernel.
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import qrd  # noqa: E402
from repro_torch.core import (GivensConfig, GivensUnit, QRDEngine,  # noqa: E402
                              hub_quantize, snr_db)


def main(device="cuda"):
    device = torch.device(device)

    # --- 1. a single Givens rotation, bit-accurate --------------------------
    unit = GivensUnit(GivensConfig(hub=True, n=26))   # paper's best config
    x, y = (torch.tensor(v, dtype=torch.float64, device=device)
            for v in (3.0, 4.0))
    r, y0, angle_state = unit.vector(unit.encode(x), unit.encode(y))
    print(f"vectoring (3,4): r = {float(unit.decode(r)):.7f}  "
          f"(exact 5), residual y = {float(unit.decode(y0)):.2e}")

    # the sigma bits ARE the angle: replay them on another pair (paper Sec 3.2)
    x2, y2 = unit.rotate(
        unit.encode(torch.tensor(10.0, dtype=torch.float64, device=device)),
        unit.encode(torch.tensor(0.0, dtype=torch.float64, device=device)),
        angle_state)
    print(f"rotate (10,0) by the same angle -> "
          f"({float(unit.decode(x2)):.5f}, {float(unit.decode(y2)):.5f})  "
          f"(exact (6, -8))")

    # --- 2. batched QR decomposition on the registry-dispatched engine ------
    print("\nregistered backends:", ", ".join(qrd.available_backends()))
    rng = np.random.default_rng(0)
    A = rng.normal(size=(1000, 4, 4))
    results = {}
    for backend in ("cordic", "cordic_pallas", "givens_float", "jnp"):
        eng = qrd.QRDEngine(backend=backend,
                            givens=GivensConfig(hub=True, n=26), device=device)
        Q, R = eng(A)
        results[backend] = (Q, R)
        print(f"QRD[{backend:13s}] mean SNR = "
              f"{float(torch.mean(snr_db(A, Q, R))):7.2f} dB")
    # the kernel-resident blocked engine is bit-identical to the loop
    exact = all(torch.equal(results["cordic"][i], results["cordic_pallas"][i])
                for i in range(2))
    print(f"cordic_pallas bit-identical to cordic: {exact}")
    assert exact
    # the legacy dataclass still works, as a facade over the same registry
    lQ, lR = QRDEngine(backend="cordic",
                       givens_config=GivensConfig(hub=True, n=26),
                       device=device)(A)
    assert torch.equal(lQ, results["cordic"][0])

    # --- 3. problem level: least squares without forming Q ------------------
    Am = rng.normal(size=(8, 6, 3))
    b = rng.normal(size=(8, 6))
    eng = qrd.QRDEngine(backend="cordic", givens=GivensConfig(hub=True, n=26),
                        device=device)
    xs, resid = eng.solve(Am, b, return_residuals=True)
    ref = np.stack([np.linalg.lstsq(Am[i], b[i], rcond=None)[0]
                    for i in range(8)])
    err = float(np.max(np.abs(xs.cpu().numpy() - ref)))
    print(f"\nsolve() vs np.linalg.lstsq: max |dx| = {err:.2e} "
          f"(tolerances: repro_torch.qrd.SOLVE_TOLERANCES)")
    assert err < 1e-4

    # --- 4. streaming QRD-RLS (adaptive filtering) --------------------------
    n = 4
    w_true = rng.normal(size=n)
    state = eng.rls(n, lam=0.995)
    for _ in range(200):
        xv = rng.normal(size=n)
        state.update(xv, w_true @ xv + 0.01 * rng.normal())
    werr = float(np.linalg.norm(state.weights().cpu().numpy() - w_true))
    print(f"QRD-RLS on the unit: ||w - w_true|| = {werr:.4f} "
          f"after {state.updates} snapshots")
    assert werr < 0.05

    # --- 5. HUB numerics as a primitive -------------------------------------
    v = torch.tensor(1.2345678, dtype=torch.float64, device=device)
    print(f"\nhub_quantize(1.2345678, m=10) = "
          f"{float(hub_quantize(v, 10)):.7f} (round-to-nearest by truncation)")
    return {"snr_db": {k: float(torch.mean(snr_db(A, *v)))
                       for k, v in results.items()},
            "solve_err": err, "rls_err": werr}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    main(ap.parse_args().device)
