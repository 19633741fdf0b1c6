# Hand-written CUDA kernels for Hopper (sources in csrc/, built by _build.py):
#   qrd_blocked.py  kernel-resident packed-word QR (flat, panel factor,
#                   panel apply): launch wrappers, plain PyTorch versions,
#                   launch counters
#   ops.py          public wrappers (leading batch shape), panel driver
from . import ops, qrd_blocked

__all__ = ["ops", "qrd_blocked"]
