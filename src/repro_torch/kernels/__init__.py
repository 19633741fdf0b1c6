# Hand-written CUDA kernels for Hopper (sources in csrc/, built by _build.py):
#   qrd_blocked.py   kernel-resident QR, packed-word (flat, panel factor,
#                    panel apply) and int32 block-FP (the same three):
#                    launch wrappers, plain PyTorch versions, launch
#                    counters
#   cordic_givens.py the int32 block-FP CORDIC step, plain PyTorch (the
#                    block-FP kernels' plain versions are built from it)
#   ops.py           public wrappers (leading batch shape), panel loops,
#                    block-FP encode/decode, the RLS block schedule
from . import cordic_givens, ops, qrd_blocked

__all__ = ["cordic_givens", "ops", "qrd_blocked"]
