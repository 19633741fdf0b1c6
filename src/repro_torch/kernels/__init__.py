# Hand-written CUDA kernels for Hopper (sources in csrc/, built by _build.py):
#   qrd_blocked.py   kernel-resident QR, packed-word (flat, panel factor,
#                    panel apply, wavefront, complex flat and wavefront)
#                    and int32 block-FP (flat, panel factor and apply,
#                    wavefront): launch wrappers, plain PyTorch versions,
#                    launch counters
#   cordic_givens.py the int32 block-FP CORDIC step, plain PyTorch (the
#                    block-FP kernels' plain versions are built from it)
#   ops.py           public wrappers (leading batch shape), panel loops,
#                    stage tables, block-FP encode/decode, the RLS block
#                    schedule
from . import cordic_givens, ops, qrd_blocked

__all__ = ["cordic_givens", "ops", "qrd_blocked"]
