#!/usr/bin/env python3
"""The block-FP panel kernels B4a and B4b, the wavefronts B5a and B5b and
the rotator's fused kernel B6c of one tree, timed with this checkout's
``chip_smoke.py`` helpers on one GPU.

    python3 tools/tree_ab.py TREE [--block-grid]

TREE is the root of a checkout (``.``, or another commit's ``git
archive`` unpacked in a directory that ``.gitignore`` lists); its
``src/repro_torch`` is imported before ``chip_smoke``, which then runs on
it.  Prints the block-FP panel and TSQR paths' ``timing`` and ``levels``
lines in the path (`chip_smoke.tiled_timing`, median of 5) and kernel
only (`chip_smoke.panel_replay_phase`, median of 10; with
``--block-grid`` B4b also at 1, 2, 4 and 8 threads a column, for a tree
that has `qrd_blocked._panel_apply_blockfp_launch`), then B5a beside B1
on the same words at (8192, 32, 64) and, tiles in device memory, at
(132, 128, 256), B5b beside B2 at (8192, 32, 64), B6c through its
wrapper at the row API's full shapes (two medians of 5 each), and B6a and
B6b kernel only there (`chip_smoke.rotator_kernel_phase`, through their
ctypes entry points, whose arguments the tree's `cordic_givens` builds),
and the row API's rotations per second (`chip_smoke.rotator_full_phase`,
wrappers included).  Run it on two trees in turns (parent, change,
change, parent) in one call to compare them.
"""
import os
import sys

if len(sys.argv) not in (2, 3) or sys.argv[2:] not in ([], ["--block-grid"]):
    sys.exit(__doc__)
TREE = os.path.abspath(sys.argv[1])
sys.path.insert(0, os.path.join(TREE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import cordic_givens as cg  # noqa: E402
from repro_torch.kernels import qrd_blocked as qb  # noqa: E402
from repro_torch.qrd import tiled  # noqa: E402,F401

sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main():
    if not qb.__file__.startswith(TREE) or cs.qb is not qb:
        sys.exit(f"tree_ab: imported {qb.__file__}, not {TREE}'s package")
    print(f"tree {sys.argv[1]}: {qb.__file__}", flush=True)
    if not torch.cuda.is_available():
        sys.exit("tree_ab: no CUDA device")
    _build.build(["blockfp", "qr_packed", "panel_packed", "rotator"])
    dev = torch.device("cuda")
    paths = {}
    for label, A, kw, work in (
            ("block-FP panel", torch.tensor(cs.panel_operand(), device=dev),
             dict(hub=True), cs.panel_route_work(cs.PANEL_BATCH, cs.PANEL_M,
                                                 cs.PANEL_M, 2 * cs.PANEL_M,
                                                 lane="blockfp")),
            ("block-FP tsqr", torch.tensor(cs.tsqr_operands()[0], device=dev),
             {}, cs.tsqr_work(cs.TSQR_BATCH, cs.TSQR_M, cs.TSQR_N,
                              cs.TSQR_TILE_M, True, "blockfp"))):
        eng = cs.lane_engine("blockfp", dev, **kw)
        cs.tiled_timing(label + " path", eng, A, work, lane="blockfp")
        paths[label] = dict(engine=eng, A=A)
    cs.panel_replay_phase(paths, sys.argv[2:] == ["--block-grid"])
    rng = np.random.default_rng(cs.SEED + 1)
    A = torch.tensor(rng.normal(size=(cs.BATCH, cs.M, cs.N_COLS)), device=dev)
    for label, Aw in (("(8192, 32, 64)", A),
                      ("(132, 128, 256), device memory",
                       torch.tensor(cs.big_operand(), device=dev))):
        X, fns = cs.lane_words("packed", Aw)
        if not torch.equal(fns["wavefront"](X), fns["flat"](X)):
            sys.exit(f"tree_ab: B5a differs from B1 at {label}")
        ms = {k: [cs._event_ms(lambda: fns[k](X), 5)[0] for _ in range(2)]
              for k in ("wavefront", "flat")}
        print(f"ab B5a at {label}: {ms['wavefront'][0]:.3f}, "
              f"{ms['wavefront'][1]:.3f} ms; B1 {ms['flat'][0]:.3f}, "
              f"{ms['flat'][1]:.3f} (median of 5 each)", flush=True)
    X, fns = cs.lane_words("blockfp", A)
    if not torch.equal(fns["wavefront"](X), fns["flat"](X)):
        sys.exit("tree_ab: B5b differs from B2 at (8192, 32, 64)")
    ms = {k: [cs._event_ms(lambda: fns[k](X), 5)[0] for _ in range(2)]
          for k in ("wavefront", "flat")}
    print(f"ab B5b at {tuple(X.shape)}: {ms['wavefront'][0]:.3f}, "
          f"{ms['wavefront'][1]:.3f} ms; B2 {ms['flat'][0]:.3f}, "
          f"{ms['flat'][1]:.3f} (median of 5 each)", flush=True)
    kw = dict(iters=cs.ROT_ITERS_FULL, hub=True)
    for B, L in cs.ROT_FULL:
        R = cs.rotator_rows(B, L, rng, dev)
        got = cg.fused_call(R[0], R[1], **kw)
        if not all(map(torch.equal, got, cg.fused_reference(R[0], R[1], **kw))):
            sys.exit(f"tree_ab: B6c differs from its plain version at {(B, L)}")
        ms = [cs._event_ms(lambda: cg.fused_call(R[0], R[1], **kw), 5)[0]
              for _ in range(2)]
        print(f"ab B6c at ({B}, {L}): {ms[0]:.4f}, {ms[1]:.4f} ms (median of "
              f"5 each)", flush=True)
    cs.rotator_kernel_phase(dev)
    cs.print_row_api(cs.rotator_full_phase(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
