"""repro_torch — the Givens rotation unit and its QR engine in PyTorch.

The port of `repro` (JAX/Pallas) to PyTorch with hand-written CUDA kernels
for Hopper (sm_90a).  It mirrors `repro`'s layout so each module has an
obvious counterpart:

* `repro_torch.core`    — packed formats, converters, CORDIC, `GivensUnit`,
  the QR routines;
* `repro_torch.kernels` — CUDA kernels (``kernels/csrc``), their launch
  wrappers and plain PyTorch versions;
* `repro_torch.qrd`     — `QRDConfig`, the backend registry, `QRDEngine`
  with ``solve``.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
on a CPU tensor each kernel wrapper runs its plain PyTorch version.  The
package never imports ``jax`` or ``repro``.
"""
