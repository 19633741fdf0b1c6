"""The levelized stages the port's complex flat kernel B7a runs a step
schedule in (`qrd_blocked.flat_stage_table`, as B1 and B2 do), against the
step order and the JAX package on the CPU.

* The stage tables of the complex path's schedules: the column-major steps
  with Q at 32 x (32 + 32), the solve augmentation at 32 x 17 and the
  column-major steps with Q at 128 x (128 + 128) have disjoint rows in
  every stage (the wavefront tables' validator accepts them), every row
  meeting its steps in step order, and 61, 47 and 253 stages.
* `qr_packed_complex_wavefront_reference` on a table's first three rows
  gives `qr_packed_complex_reference`'s words in step order: HUB and IEEE,
  random words and edge words (exactly real leads, whose +-0 imaginary
  word takes the skip flag, zero leads, an all-zero column), on the
  column-major, solve and flattened Sameh–Kuck orders.
* Both give the JAX package's column-major complex words, taken as
  tests/test_torch_complex.py takes them: the JAX complex wavefront body
  jitted on the column-major steps grouped into stages (`_col_stages`),
  on the port's encoding of [C | I] (held to the JAX package's there).

Inputs are made with numpy from a seed.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.givens import GivensConfig as JConfig
from repro.kernels import ops as jops

from repro_torch.core import qrd as tq
from repro_torch.core.givens import GivensConfig, GivensUnit
from repro_torch.kernels import qrd_blocked as tqb

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from test_torch_complex import _col_stages, _complex, _jax_wavefront  # noqa: E402

#: name -> (rows m, complex columns e, steps, stages): the complex path's
#: schedules (chip_smoke.py).
SCHEDULES = {
    "col-32x32-q": (32, 64, tq.givens_schedule(32, 32), 61),
    "solve-32x17": (32, 17, tq.givens_schedule(32, 17), 47),
    "col-128x128-q": (128, 256, tq.givens_schedule(128, 128), 253),
}


def _rows_in_order(steps, order):
    """Each row's sequence of step indices when the steps run in ``order``."""
    seq = {}
    for s in order:
        for r in steps[s][:2]:
            seq.setdefault(r, []).append(s)
    return seq


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_complex_stage_tables_are_disjoint_ordered_levels(name):
    m, e, steps, n_stages = SCHEDULES[name]
    tab = tqb.flat_stage_table(steps, m, e)
    piv, tgt, col, _ = tab
    assert tab.shape[1] == n_stages
    live = piv < m
    tqb._stage_table(tqb._stage_key(piv, tgt, col), m, e, "cpu")  # disjoint
    index = {s: i for i, s in enumerate(steps)}
    order = [index[s] for s in zip(*(t[live].tolist() for t in (piv, tgt, col)))]
    assert sorted(order) == list(range(len(steps)))
    assert _rows_in_order(steps, order) == _rows_in_order(steps,
                                                         range(len(steps)))


#: name -> (m, n, compute_q, steps) of the small step orders.
ORDERS = {"col": (5, 3, True, tq.givens_schedule(5, 3)),
          "solve": (5, 4, False, tq.givens_schedule(5, 4)),
          "sameh-kuck": (4, 3, True, chip_smoke.flat_order(4, 3))}


@pytest.mark.parametrize("edge", [False, True], ids=["random", "edge"])
@pytest.mark.parametrize("hub", [False, True], ids=["ieee", "hub"])
@pytest.mark.parametrize("order", list(ORDERS))
def test_stage_order_equals_step_order(order, hub, edge):
    m, n, cq, steps = ORDERS[order]
    cfg = GivensConfig(hub=hub, n=26)
    rng = np.random.default_rng(len(order) + 2 * hub + edge)
    P = chip_smoke.complex_words(cfg, 2, m, n, cq, rng, "cpu", edge)
    tab = tqb.flat_stage_table(steps, m, P.shape[2])
    got = tqb.qr_packed_complex_wavefront_reference(P, *tab[:3], cfg=cfg)
    assert torch.equal(got, tqb.qr_packed_complex_reference(P, cfg=cfg,
                                                            steps=steps))


#: Per datapath the operand shape (m, n) of tests/test_torch_complex.py.
CASES = {"ieee": (False, (3, 2)), "hub": (True, (4, 3))}


@pytest.mark.parametrize("case", list(CASES))
def test_stage_order_bit_equal_to_jax_column_major(case):
    hub, (m, n) = CASES[case]
    cfg = GivensConfig(hub=hub, n=26)
    C = torch.tensor(_complex(7 + hub, (2, m, n)))
    P = tq._encode_complex(GivensUnit(cfg), tq._augment_complex(C, True))
    tables = jops._stage_tables(_col_stages(m, n), m)
    want = np.asarray(_jax_wavefront(JConfig(hub=hub, n=26))(
        jnp.asarray(P.numpy()), *(jnp.asarray(t) for t in tables)))
    steps = tq.givens_schedule(m, n)
    tab = tqb.flat_stage_table(steps, m, P.shape[2])
    got = tqb.qr_packed_complex_wavefront_reference(P, *tab[:3], cfg=cfg)
    np.testing.assert_array_equal(got.numpy(), want)
    got = tqb.qr_packed_complex_call(P, cfg=cfg, steps=steps)
    np.testing.assert_array_equal(got.numpy(), want)
