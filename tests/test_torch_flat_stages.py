"""The stages the port's flat kernels B1 and B2 run a step-serial schedule
in (`qrd_blocked.flat_stage_table`), against the JAX package on the CPU.

* The stage tables of the column-major schedule with and without Q, of
  the ``solve`` augmentation, of the RLS block order and of a flattened
  Sameh–Kuck order: disjoint rows in every stage (the wavefront tables'
  validator accepts them), every row meeting its steps in step order,
  61, 47 and 11 stages where the schedules' depth says so, and row 3 each
  pair's inclusive end among the stage's live (pair, column) items.
* Out-of-range steps raise ValueError.
* The plain stage-order versions (`qr_packed_wavefront_reference`,
  `qr_blockfp_wavefront_reference`) on those tables give the words of the
  step-order plain versions (`qr_packed_reference`,
  `qr_blockfp_reference`), HUB and IEEE packed words, HUB and
  conventional block-FP significands, random and edge words; and the
  words of the JAX package's `qr_packed_call` (IEEE) and `qr_blockfp_call`
  (conventional) in interpret mode.  Those two run once each, at three
  steps, in a module-scoped fixture: an interpret-mode call of the
  JAX flat kernels traces every step and, on the block-FP lane, every
  CORDIC iteration (about 0.4 s a step packed, 0.6 s block-FP at 24
  iterations, on this suite's CPU runs), so the block-FP call runs 8
  iterations; the step-order plain versions are held to the JAX package
  in the other two formats, and at 24 and 30 iterations, by
  tests/test_torch_qrd.py and tests/test_torch_blockfp.py.

Inputs are made with numpy from a seed.
"""
import numpy as np
import pytest
import torch

from repro.core.givens import GivensConfig as JConfig
from repro.kernels import ops as jops
from repro.kernels import qrd_blocked as jqb

from repro_torch.core import qrd as tq
from repro_torch.core.formats import pack_fields
from repro_torch.core.givens import GivensConfig, GivensUnit
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qrd_blocked as tqb


def _sk_order(m, n):
    return tuple(s for st in tq.sameh_kuck_schedule(m, n) for s in st)


#: name -> (rows m, columns e, steps, stages the table must have or None)
SCHEDULES = {
    "col-4x4-q": (4, 8, tq.givens_schedule(4, 4), None),
    "col-6x3": (6, 3, tq.givens_schedule(6, 3), None),
    "col-32x32-q": (32, 64, tq.givens_schedule(32, 32), 61),
    "solve-32x17": (32, 17, tq.givens_schedule(32, 17), 47),
    "rls-8x4": (12, 9, tops.rls_block_steps(8, 4), 11),
    "sameh-kuck-7x5-q": (7, 12, _sk_order(7, 5),
                         len(tq.sameh_kuck_schedule(7, 5))),
}
SMALL = ["col-4x4-q", "col-6x3", "rls-8x4", "sameh-kuck-7x5-q"]


def _rows_in_order(steps, order):
    """Each row's sequence of step indices when the steps run in ``order``."""
    seq = {}
    for s in order:
        for r in steps[s][:2]:
            seq.setdefault(r, []).append(s)
    return seq


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_flat_stage_tables_are_disjoint_ordered_levels(name):
    m, e, steps, n_stages = SCHEDULES[name]
    tab = tqb.flat_stage_table(steps, m, e)
    assert tab.dtype == np.int32 and not tab.flags.writeable
    piv, tgt, col, end = tab
    if n_stages is not None:
        assert tab.shape[1] == n_stages
    live = piv < m
    assert np.all(tgt[~live] == m) and np.all(col[~live] == 0)
    assert tab.shape[2] == live.sum(1).max()          # the widest stage
    tqb._stage_table(tqb._stage_key(piv, tgt, col), m, e, "cpu")  # disjoint
    index = {s: i for i, s in enumerate(steps)}
    assert len(index) == len(steps)
    order = [index[s] for s in zip(*(t[live].tolist() for t in (piv, tgt, col)))]
    assert sorted(order) == list(range(len(steps)))
    assert _rows_in_order(steps, order) == _rows_in_order(steps,
                                                         range(len(steps)))
    assert np.array_equal(end, np.cumsum(np.where(live, e - col, 0), axis=1))
    cached = tqb._flat_stage_table(steps, m, e, "cpu")
    assert torch.equal(cached, torch.tensor(tab))
    assert tqb._flat_stage_table(steps, m, e, "cpu") is cached


def test_flat_stage_table_counts_at_the_main_path_shapes():
    """Steps against stages: 496 -> 61, 391 -> 47, 32 -> 11; no steps, no
    stage."""
    for name, n_steps in (("col-32x32-q", 496), ("solve-32x17", 391),
                          ("rls-8x4", 32)):
        m, e, steps, n_stages = SCHEDULES[name]
        assert len(steps) == n_steps
        assert tqb.flat_stage_table(steps, m, e).shape[1] == n_stages
    assert tqb.flat_stage_table((), 4, 8).shape == (4, 0, 0)


@pytest.mark.parametrize("step", [(0, 0, 0), (0, 4, 0), (-1, 1, 0),
                                  (0, 1, 8), (0, 1, -1), (4, 1, 0)])
def test_out_of_range_steps_raise(step):
    steps = ((0, 1, 0), step)
    with pytest.raises(ValueError, match="out of range"):
        tqb.flat_stage_table(steps, 4, 8)
    with pytest.raises(ValueError, match="out of range"):
        tqb._flat_stage_table(steps, 4, 8, "cpu")


def _packed_words(cfg, m, e, seed):
    """Three (m, e) tiles of packed words: two of random values, one of
    edge words (exponent gaps past N + 2 against the lead, zeros, exact
    1.0, the largest exponent)."""
    rng = np.random.default_rng(seed)
    rand = GivensUnit(cfg).encode(torch.tensor(rng.standard_normal((2, m, e))))
    fmt = cfg.fmt
    exp = rng.integers(1, fmt.max_exp_raw + 1, size=(1, m, e))
    man = rng.integers(0, 1 << fmt.man_bits, size=(1, m, e))
    sign = rng.integers(0, 2, size=(1, m, e))
    for r, gap in enumerate((cfg.n + 1, cfg.n + 2, 64), start=1):
        if r < m:
            exp[:, r, 0] = np.clip(exp[:, 0, 0] - gap, 1, None)
    exp[:, :, -1] = 0
    exp[:, 0, 1] = fmt.bias
    man[:, 0, 1] = 0
    exp[:, -1, :] = fmt.max_exp_raw
    edge = pack_fields(*(torch.tensor(a) for a in (sign, exp, man)), fmt)
    return torch.cat([rand, edge])


def _bfp_words(m, e, seed):
    """Three (m, e) tiles of int32 significands in [-2^24, 2^24], the last
    with a column at +2^24, an all-zero column and a -2^24 corner."""
    X = np.random.default_rng(seed).integers(-2 ** 24, 2 ** 24 + 1,
                                             size=(3, m, e))
    X[2, :, 0] = 2 ** 24
    X[2, :, 1] = 0
    X[2, -1, -1] = -2 ** 24
    return torch.tensor(X.astype(np.int32))


@pytest.mark.parametrize("hub", [False, True], ids=["ieee", "hub"])
@pytest.mark.parametrize("name", SMALL)
def test_packed_stage_order_equals_step_order(name, hub):
    m, e, steps, _ = SCHEDULES[name]
    cfg = GivensConfig(hub=hub)
    P = _packed_words(cfg, m, e, len(name))
    piv, tgt, col, _ = tqb.flat_stage_table(steps, m, e)
    got = tqb.qr_packed_wavefront_reference(P, piv, tgt, col, cfg=cfg)
    assert torch.equal(got, tqb.qr_packed_reference(P, cfg=cfg, steps=steps))


@pytest.mark.parametrize("hub", [False, True], ids=["conv", "hub"])
@pytest.mark.parametrize("name", SMALL)
def test_blockfp_stage_order_equals_step_order(name, hub):
    m, e, steps, _ = SCHEDULES[name]
    X = _bfp_words(m, e, len(name))
    piv, tgt, col, _ = tqb.flat_stage_table(steps, m, e)
    kw = dict(iters=24, hub=hub)
    got = tqb.qr_blockfp_wavefront_reference(X, piv, tgt, col, **kw)
    assert torch.equal(got, tqb.qr_blockfp_reference(X, steps=steps, **kw))


#: The JAX kernels' case: the first three steps of the RLS block order of
#: two state rows and two snapshots (two stages, the second of two pairs),
#: on packed IEEE words and on conventional block-FP significands at
#: `JAX_BFP_ITERS` CORDIC iterations.
JAX_PACKED = JAX_BFP = (4, 3, jops.rls_block_steps(2, 2)[:3])
JAX_BFP_ITERS = 8


@pytest.fixture(scope="module")
def jax_flat():
    """The JAX package's flat kernels in interpret mode, once each."""
    m, e, steps = JAX_PACKED
    P = _packed_words(GivensConfig(), m, e, 5)
    packed = jqb.qr_packed_call(P.numpy(), cfg=JConfig(), steps=steps,
                                interpret=True)
    m, e, steps = JAX_BFP
    X = _bfp_words(m, e, 4)
    bfp = jqb.qr_blockfp_call(X.numpy(), iters=JAX_BFP_ITERS, hub=False,
                              steps=steps, interpret=True)
    return (P, np.asarray(packed)), (X, np.asarray(bfp))


def test_stage_order_plain_versions_bit_equal_to_jax(jax_flat):
    (P, want_p), (X, want_x) = jax_flat
    m, e, steps = JAX_PACKED
    assert tops.rls_block_steps(2, 2)[:3] == tuple(steps)
    tab = tqb.flat_stage_table(steps, m, e)
    assert tab.shape[1:] == (2, 2)
    got = tqb.qr_packed_wavefront_reference(P, *tab[:3], cfg=GivensConfig())
    np.testing.assert_array_equal(got.numpy(), want_p)
    m, e, steps = JAX_BFP
    tab = tqb.flat_stage_table(steps, m, e)
    assert tab.shape[1:] == (2, 2)
    got = tqb.qr_blockfp_wavefront_reference(X, *tab[:3], iters=JAX_BFP_ITERS,
                                             hub=False)
    np.testing.assert_array_equal(got.numpy(), want_x)
