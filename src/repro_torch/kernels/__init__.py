# Hand-written CUDA kernels for Hopper (sources in csrc/, built by _build.py):
#   qrd_blocked.py   kernel-resident QR, packed-word (flat, panel factor,
#                    panel apply, wavefront, complex flat and wavefront,
#                    dual-int32 lanes flat and wavefront)
#                    and int32 block-FP (flat, panel factor and apply,
#                    wavefront): launch wrappers, plain PyTorch versions,
#                    launch counters
#   cordic_givens.py the int32 block-FP CORDIC step, plain PyTorch (the
#                    block-FP kernels' plain versions are built from it),
#                    and the standalone rotator's kernels (vectoring,
#                    rotation, fused): wrappers, plain versions, counters
#   packed_lanes.py  the unit on dual int32 (hi, lo) lanes, plain PyTorch:
#                    the lane kernels' plain versions are built from it
#   ops.py           public wrappers (leading batch shape), the rotator's
#                    row API, panel loops, stage tables, block-FP
#                    encode/decode, the RLS block schedule
#   _launch.py       launch signatures, library handles, stream and error
#                    checks shared by the wrappers
from . import cordic_givens, ops, packed_lanes, qrd_blocked

__all__ = ["cordic_givens", "ops", "packed_lanes", "qrd_blocked"]
