"""The CUDA kernels of `repro_torch` against their plain PyTorch versions,
on the GPU.

Marked ``gpu``: the kernels have no CPU or interpret mode, so these tests
skip on a machine without CUDA (the `cuda` fixture decides, at run time).
Run them on a GPU host with ``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.
The same cases run in ``chip_smoke.py``, whose helpers build the inputs.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

from repro_torch.core.qrd import givens_schedule  # noqa: E402
from repro_torch.kernels import qrd_blocked as qb  # noqa: E402
from repro_torch.qrd import QRDEngine  # noqa: E402

pytestmark = pytest.mark.gpu

CONFIGS = chip_smoke.parity_configs()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on a GPU")
    return torch.device("cuda")


def _check(P, cfg, steps, tile_b=None):
    before = qb.QR_PACKED_LAUNCHES
    out = qb.qr_packed_call(P, cfg=cfg, steps=steps, tile_b=tile_b)
    ref = qb.qr_packed_reference(P, cfg=cfg, steps=steps)
    torch.cuda.synchronize()
    assert qb.QR_PACKED_LAUNCHES == before + 1
    assert out.device.type == "cuda"
    assert torch.equal(out, ref)


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_qr_packed_bit_equal_to_plain_version(cuda, i):
    cfg = CONFIGS[i]
    rng = np.random.default_rng(i)
    for (m, n, cq) in ((4, 4, True), (6, 3, True), (3, 5, False),
                       (16, 16, True)):
        steps = givens_schedule(m, n)
        _check(chip_smoke.encoded_words(cfg, 8, m, n, cq, rng, cuda), cfg, steps)
        _check(chip_smoke.edge_words(cfg, 8, m, n + (m if cq else 0), rng, cuda),
               cfg, steps)


@pytest.mark.parametrize("tile_b", [1, 2, 4])
def test_qr_packed_ragged_batch(cuda, tile_b):
    cfg = CONFIGS[2]
    P = chip_smoke.encoded_words(cfg, 5, 6, 4, True, np.random.default_rng(9),
                                 cuda)
    _check(P, cfg, givens_schedule(6, 4), tile_b=tile_b)


def test_engine_on_gpu_equals_cpu(cuda):
    A = np.random.default_rng(4).normal(size=(7, 8, 6))
    kw = dict(backend="cordic_pallas", dtype="float64",
              givens=chip_smoke.GivensConfig(hub=True, n=26))
    before = qb.QR_PACKED_LAUNCHES
    Qg, Rg = QRDEngine(**kw)(A)
    assert qb.QR_PACKED_LAUNCHES == before + 1
    Qc, Rc = QRDEngine(device="cpu", **kw)(A)
    assert torch.equal(Qg.cpu(), Qc) and torch.equal(Rg.cpu(), Rc)
