# Hand-written CUDA kernels for Hopper (sources in csrc/, built by _build.py):
#   qrd_blocked.py  kernel-resident packed-word QR: launch wrapper, plain
#                   PyTorch version, launch counter
#   ops.py          public wrappers (leading batch shape)
from . import ops, qrd_blocked

__all__ = ["ops", "qrd_blocked"]
