"""The stages the port's packed panel kernels run the column-major panel
steps in (`ops.panel_stages`, `qrd_blocked.levelize_steps`), against the
JAX package on the CPU.

* The stage tables of several panels: disjoint rows in every stage (the
  wavefront tables' validator accepts them), every row meeting its steps
  in step order, ``mr + min(mr - 1, nc) - 2`` stages, and the step indices
  a permutation of the steps.
* The plain versions of the panel kernels, fed the flattened stage order,
  give the words and, mapped back through the step indices, the control
  words of the JAX package's interpret-mode panel kernels in step order,
  HUB and IEEE.
* `qr_packed_wavefront_reference` on a panel's stage tables gives
  `panel_factor_packed_reference`'s words.
* The block-FP panel factor's plain version, fed the flattened stage order
  (as the kernel B4a runs it), gives the step order's significands and,
  mapped back through the step indices, its control words, HUB and
  conventional; the block-FP panel apply's (as B4b runs it), with the
  control words gathered at the step indices, the step order's
  significands.
* The panel factor's and apply's cached stage tables come from one
  levelization of the panel's rows.
* The panel factors keep their panels in shared memory on the engine's
  default tiles and work on a panel beyond it in device memory
  (`qrd_blocked._panel_tile`), at its boundary.

Inputs are made with numpy from a seed; every JAX call runs once, in a
module-scoped fixture.
"""
import numpy as np
import pytest
import torch

from repro.core.givens import GivensConfig as JConfig
from repro.kernels import ops as jops
from repro.kernels import qrd_blocked as jqb

from repro_torch.core import qrd as tq
from repro_torch.core.givens import GivensConfig, GivensUnit
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qrd_blocked as tqb

M, N, W = 12, 6, 12               # the panel, and its trailing region


def _rows_in_order(piv, tgt, order):
    """Each row's sequence of step indices when the steps run in ``order``."""
    seq = {}
    for s in order:
        for r in (int(piv[s]), int(tgt[s])):
            seq.setdefault(r, []).append(int(s))
    return seq


def _check_stages(tables, step, steps, m):
    """The invariants of levelized stage tables of the (S,) ``steps``."""
    piv, tgt, col = (np.asarray(t) for t in steps)
    live = step >= 0
    assert tables.shape[1:] == step.shape
    assert np.array_equal(np.sort(step[live]), np.arange(len(piv)))
    assert np.all(tables[:2][:, ~live] == m) and np.all(tables[2][~live] == 0)
    for t, ref in zip(tables, (piv, tgt, col)):
        assert np.array_equal(t[live], ref[step[live]])
    tqb._stage_table(tqb._stage_key(*tables), m, int(col.max()) + 1, "cpu")
    stage_order = step[live]                     # row-major: stage by stage
    assert (_rows_in_order(piv, tgt, stage_order)
            == _rows_in_order(piv, tgt, range(len(piv))))


@pytest.mark.parametrize("mr,nc", [(12, 3), (12, 6), (9, 8), (6, 5), (5, 9),
                                   (2, 1), (64, 8), (128, 8)])
def test_panel_stages_are_disjoint_ordered_levels(mr, nc):
    tables, step = tops.panel_stages(mr, nc)
    assert tables.dtype == step.dtype == np.int32
    assert not tables.flags.writeable and not step.flags.writeable
    assert tops.panel_stages(mr, nc)[0] is tables          # memoized
    assert tables.shape[1] == mr + min(mr - 1, nc) - 2
    assert tables.shape[2] == min(mr - 1, nc, mr // 2)
    _check_stages(tables, step, tops.panel_steps(mr, nc), mr)


def test_levelize_steps_of_the_flat_schedule():
    """Any step list levelizes; the flat column-major schedule at 32 x 32
    gives 61 stages for 496 steps, the Sameh–Kuck depth."""
    steps = tq.givens_schedule(32, 32)
    cols = [tuple(s[i] for s in steps) for i in range(3)]
    lv = tqb.levelize_steps(*cols, 32)
    assert lv.shape[:2] == (4, 61) and len(steps) == 496
    assert len(tq.sameh_kuck_schedule(32, 32)) == 61
    _check_stages(lv[:3], lv[3], cols, 32)
    none = tqb.levelize_steps((), (), (), 4)
    assert none.shape == (4, 0, 0)


@pytest.mark.parametrize("mr,nc", [(12, 6), (9, 8), (64, 8)])
def test_panel_factor_and_apply_tables_share_one_levelization(mr, nc):
    """The factor's cached stage table (with lead columns) and the apply's
    (without) come from one cached levelization: rows 0, 1 and 3 equal,
    and each equals `levelize_steps` of its own tables."""
    rows = tuple(tuple(int(v) for v in t) for t in tops.panel_steps(mr, nc))
    factor = tqb._panel_stage_table(rows[:2], rows[2], mr, nc, "cpu").numpy()
    apply_ = tqb._panel_stage_table(rows[:2], None, mr, 0, "cpu").numpy()
    np.testing.assert_array_equal(factor, tqb.levelize_steps(*rows, mr))
    np.testing.assert_array_equal(apply_, tqb.levelize_steps(*rows[:2], None,
                                                             mr))
    np.testing.assert_array_equal(factor[[0, 1, 3]], apply_[[0, 1, 3]])
    assert tqb._panel_levels(rows[:2], mr) is tqb._panel_levels(rows[:2], mr)


def _configs(hub):
    return JConfig(hub=hub), GivensConfig(hub=hub)


def _words(hub):
    """Packed words of two random [A | I] working matrices, 12 x 18 (the
    port's encoding: both packages' kernels get the same words)."""
    A = np.random.default_rng(7).standard_normal((2, M, N))
    Wd = np.concatenate([A, np.broadcast_to(np.eye(M), (2, M, M))], axis=-1)
    return GivensUnit(_configs(hub)[1]).encode(torch.tensor(Wd)).numpy()


@pytest.fixture(scope="module")
def jax_panel():
    """JAX's panel factor on the first 6 columns and its apply on the other
    12 (two chunks of 6), interpret mode, step order; HUB and IEEE."""
    piv, tgt, col = jops.panel_steps(M, N)
    out = {}
    for hub in (False, True):
        jc, _ = _configs(hub)
        P = _words(hub)
        f_out, flip, sig = jqb.panel_factor_packed_call(
            P[:, :, :N], piv, tgt, col, cfg=jc, interpret=True)
        T = P[:, :, N:].reshape(2, M, 2, N).transpose(0, 2, 1, 3)
        T = jqb.panel_apply_packed_call(T, piv, tgt, flip, sig, cfg=jc,
                                        interpret=True)
        out[hub] = (np.asarray(f_out), np.asarray(flip), np.asarray(sig),
                    np.asarray(T).transpose(0, 2, 1, 3).reshape(2, M, W))
    return out


@pytest.mark.parametrize("hub", [False, True], ids=["ieee", "hub"])
def test_stage_order_plain_versions_bit_equal_to_jax(jax_panel, hub):
    f_out, flip, sig, T_out = jax_panel[hub]
    _, tc = _configs(hub)
    P = torch.tensor(_words(hub))
    tables, step = tops.panel_stages(M, N)
    live = step >= 0
    piv, tgt, col = (t[live] for t in tables)    # the flattened stage order
    order = step[live]
    got, sflip, ssig = tqb.panel_factor_packed_reference(P[:, :, :N], piv, tgt,
                                                         col, cfg=tc)
    np.testing.assert_array_equal(got.numpy(), f_out)
    back = np.empty_like(order)
    back[order] = np.arange(len(order))          # stage position of each step
    np.testing.assert_array_equal(sflip[:, back].numpy(), flip)
    np.testing.assert_array_equal(ssig[:, back].numpy(), sig)
    T = tqb.panel_apply_packed_reference(P[:, :, N:], piv, tgt, sflip, ssig,
                                         cfg=tc)
    np.testing.assert_array_equal(T.numpy(), T_out)


@pytest.mark.parametrize("mr,nc", [(12, 6), (9, 3), (5, 9)])
def test_wavefront_reference_on_panel_stages_equals_panel_factor(mr, nc):
    tc = GivensConfig(hub=True)
    A = np.random.default_rng(mr + nc).standard_normal((2, mr, nc))
    P = GivensUnit(tc).encode(torch.tensor(A))
    tables, _ = tops.panel_stages(mr, nc)
    want, _, _ = tqb.panel_factor_packed_reference(P, *tops.panel_steps(mr, nc),
                                                   cfg=tc)
    got = tqb.qr_packed_wavefront_reference(P, *tables, cfg=tc)
    assert torch.equal(got, want)



@pytest.mark.parametrize("hub", [False, True], ids=["conv", "hub"])
@pytest.mark.parametrize("mr,nc", [(12, 6), (9, 8), (5, 9)])
def test_blockfp_panel_factor_stage_order_equals_step_order(mr, nc, hub):
    """`panel_factor_blockfp_reference` fed the flattened stage order of
    `ops.panel_stages` (as B4a runs it) gives the step order's
    significands, and its (flip, sigma), mapped back through the step
    indices, the step order's; tests/test_torch_blockfp.py holds the step
    order to the JAX package."""
    rng = np.random.default_rng(mr * nc + hub)
    X = torch.tensor(rng.integers(-2 ** 24, 2 ** 24 + 1, size=(3, mr, nc)),
                     dtype=torch.int32)
    X[2, :, 0] = 2 ** 24                           # the largest amax
    X[2, 1, :] = 0                                 # a zero lead row
    steps = tops.panel_steps(mr, nc)
    tables, step = tops.panel_stages(mr, nc)
    live = step >= 0
    kw = dict(iters=24, hub=hub)
    want, flip, sig = tqb.panel_factor_blockfp_reference(X, *steps, **kw)
    got, sflip, ssig = tqb.panel_factor_blockfp_reference(
        X, *(t[live] for t in tables), **kw)
    assert torch.equal(got, want)
    back = np.empty(live.sum(), dtype=np.int64)
    back[step[live]] = np.arange(live.sum())       # stage position of each step
    assert torch.equal(sflip[:, back], flip) and torch.equal(ssig[:, back], sig)


@pytest.mark.parametrize("hub", [False, True], ids=["conv", "hub"])
@pytest.mark.parametrize("mr,nc", [(12, 6), (9, 8), (5, 9), (24, 12)])
def test_blockfp_panel_apply_stage_order_equals_step_order(mr, nc, hub):
    """`panel_apply_blockfp_reference` fed the flattened stage order of
    `ops.panel_stages` (as B4b runs it), with each pair's (flip, sigma)
    gathered at its step index, gives the step order's significands; the
    24 x 12 panel has 12 pairs a stage (B4b's two chunks of 8)."""
    rng = np.random.default_rng(mr * nc + hub + 50)
    tables, step = tops.panel_stages(mr, nc)
    live = step >= 0
    assert tables.shape[2] == min(mr - 1, nc, mr // 2)
    piv, tgt, _ = tops.panel_steps(mr, nc)
    S = len(piv)
    T = torch.tensor(rng.integers(-2 ** 24, 2 ** 24 + 1, size=(3, mr, 7)),
                     dtype=torch.int32)
    flip = torch.tensor(rng.integers(0, 2, size=(3, S)), dtype=torch.int32)
    sig = torch.tensor(rng.integers(0, 2 ** 30, size=(3, S)), dtype=torch.int32)
    kw = dict(iters=24, hub=hub)
    want = tqb.panel_apply_blockfp_reference(T, piv, tgt, flip, sig, **kw)
    order = torch.tensor(step[live], dtype=torch.int64)
    got = tqb.panel_apply_blockfp_reference(T, tables[0][live], tables[1][live],
                                            flip[:, order], sig[:, order], **kw)
    assert torch.equal(got, want)


#: (lane, word bytes, panel_n) of the panel factors B3a and B4a at
#: tile_m 4096, where a panel exceeds a block's shared memory.
TALL_LANES = [("packed", 8, 8), ("blockfp", 4, 16)]


@pytest.mark.parametrize("lane,word,pw", TALL_LANES)
def test_panel_factor_tile_mode_at_its_boundary(lane, word, pw):
    """`_panel_tile`: a (4096, pw) panel (262272 B with its control
    words; the parent raised ValueError) goes to device memory at the
    default tile_b and at an explicit one; the tallest panel that fits one
    block (3630 rows) stays in shared memory, one panel a block, and one
    row more goes to device memory; the engine's default tiles (TSQR
    leaves of 128 rows and tree nodes of 64, panel_n 8, and the panel
    route's 64-row panels) keep `PANEL_TILE_B` panels in shared memory."""
    fn = f"panel_factor_{lane}_call"

    def mode(mr, pw, tile_b=None):
        piv, tgt, _ = tops.panel_steps(mr, pw)
        pairs = tqb._panel_levels((tuple(piv.tolist()), tuple(tgt.tolist())),
                                  mr).shape[2]
        return tqb._panel_tile(fn, tile_b, tqb._stage_threads(pairs, pw), mr,
                               pw, pw + mr, pairs, word)

    pb = tqb.PANEL_TILE_B
    assert (4096 * pw + 2 * pw) * word > tqb.MAX_SHARED_BYTES
    assert mode(4096, pw) == (pb, True)
    assert mode(4096, pw, 1) == (1, True)
    assert (3630 * pw + 2 * pw) * word == tqb.MAX_SHARED_BYTES
    assert mode(3630, pw) == (1, False)
    assert mode(3631, pw) == (pb, True)
    for mr in (128, 64):
        assert mode(mr, 8) == (pb, False)
        assert mode(mr, 8, 1) == (1, False)
