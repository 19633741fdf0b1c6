"""The port's Sameh–Kuck wavefront (kernels B5a, B5b) against the JAX
package on the CPU.

* `_stage_tables` gives the JAX package's (S, Pmax) tables, padding and
  errors included (and B5a's table adds each pair's item end, as the flat
  kernels' tables do), and `cordic_givens.fused_rotate_pairs` its int32 words
  (HUB and conventional, iters 24 and 30, random and edge significands,
  padded pairs of zero rows).
* The plain versions of the two wavefront kernels
  (`qr_packed_wavefront_call`, `qr_blockfp_wavefront_call` on CPU tensors)
  give the words of the JAX kernels' bodies, on square and non-square
  shapes (stages with fewer pairs than the widest), with both table
  layouts; and they equal the port's flat kernels on the flattened stage
  schedule.
* `QRDEngine(backend='cordic_pallas' | 'blockfp_pallas',
  schedule='sameh_kuck', device='cpu')` gives the Q and R of the JAX
  package's wavefront route: its encode, kernel body, decode and split.

Inputs are made with numpy from a seed.  No JAX wavefront kernel is
compiled in interpret mode: each kernel body runs outside Pallas with a
stand-in for its refs, jitted whole (its `lax.scan` traces one stage, so
one small compile per configuration and shape), once per module.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import qrd as jq
from repro.core.givens import GivensConfig as JConfig
from repro.kernels import cordic_givens as jcg
from repro.kernels import ops as jops
from repro.kernels import qrd_blocked as jqb

from repro_torch import qrd as tapi
from repro_torch.core import qrd as tq
from repro_torch.core.givens import GivensConfig
from repro_torch.kernels import cordic_givens as tcg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qrd_blocked as tqb

class _Ref:
    """A stand-in for a Pallas ref, so a JAX kernel body runs outside
    Pallas."""

    def __init__(self, v=None):
        self.v = v

    def __getitem__(self, idx):
        return self.v

    def __setitem__(self, idx, v):
        self.v = v


@functools.lru_cache(maxsize=None)
def _jitted_body(kernel, layout, **kw):
    """A JAX wavefront kernel body as one jitted function of (X, piv, tgt,
    col); its compile is cached per shape."""
    def run(X, piv, tgt, col):
        if layout == "stacked":
            tab_refs = [_Ref(jnp.concatenate([piv, tgt, col]))]
        else:
            tab_refs = [_Ref(piv), _Ref(tgt), _Ref(col)]
        out = _Ref()
        kernel(*tab_refs, _Ref(X), out, S=piv.shape[0], table_layout=layout,
               **kw)
        return out.v
    return jax.jit(run)


def _jax_body(kernel, X, tables, layout, **kw):
    """A JAX wavefront kernel body on X; returns its output as numpy."""
    fn = _jitted_body(kernel, layout, **kw)
    return np.asarray(fn(jnp.asarray(X), *(jnp.asarray(t) for t in tables)))


def _flat(m, n):
    return tuple(s for st in tq.sameh_kuck_schedule(m, n) for s in st)


def _bits_equal(want, got):
    want = np.ascontiguousarray(np.asarray(want))
    got = np.ascontiguousarray(got.numpy())
    assert want.shape == got.shape
    np.testing.assert_array_equal(want.view(np.int64), got.view(np.int64))


# ---------------------------------------------------------------------------
# stage tables and the block-FP stage step
# ---------------------------------------------------------------------------
def test_stage_tables_equal_jax():
    for m, n in ((2, 2), (5, 4), (3, 6), (8, 3), (32, 32)):
        st = tq.sameh_kuck_schedule(m, n)
        for want, got in zip(jops._stage_tables(st, m),
                             tops._stage_tables(st, m)):
            assert got.dtype == np.int32 and not got.flags.writeable
            np.testing.assert_array_equal(want, got)
    for bad in ((((0, 1, 0), (1, 2, 0)),), (((0, 5, 0),),)):
        with pytest.raises(ValueError) as want:
            jops._stage_tables(bad, 4)
        with pytest.raises(ValueError) as got:
            tops._stage_tables(bad, 4)
        assert str(got.value) == str(want.value)


def test_kernel_stage_table_checks_pairs():
    """The wrapper's device copy refuses what would race or leave the
    tile: overlapping rows in a stage, rows or columns out of range."""
    piv, tgt, col = tops._stage_tables(tq.sameh_kuck_schedule(4, 4), 4)
    key = tqb._stage_key(piv, tgt, col)
    table = tqb._stage_table(key, 4, 8, "cpu")
    assert table.dtype == torch.int32 and tuple(table.shape) == (3,) + piv.shape
    assert torch.equal(table[1], torch.tensor(tgt))
    for tables, m, e in ((([[0, 1]], [[1, 2]], [[0, 0]]), 4, 8),
                         (([[0]], [[4]], [[0]]), 4, 8),
                         (([[0]], [[1]], [[8]]), 4, 8),
                         (([[0]], [[1]], [[0, 0]]), 4, 8)):
        with pytest.raises(ValueError):
            tqb._stage_table(tqb._stage_key(*tables), m, e, "cpu")


#: (m, n, e) of the wavefront tables, which both lanes share: the words
#: with Q (32 x 32 is the card's path on both lanes), and the block-FP
#: lane's other cases: its plain-version shapes (5 x 4 with Q, 2 x 3
#: without, 16 x 16 with Q) and the solves' [A | b] (6 x 3 here, 32 x 16
#: on the card).
ITEM_END_SHAPES = [pytest.param(32, 32, 64, id="32-32"),
                   pytest.param(9, 7, 16, id="9-7"),
                   pytest.param(6, 3, 9, id="6-3"),
                   pytest.param(3, 6, 9, id="3-6"),
                   pytest.param(5, 4, 9, id="blockfp-5-4"),
                   pytest.param(2, 3, 3, id="blockfp-2-3-r-only"),
                   pytest.param(6, 3, 4, id="blockfp-solve-6-3"),
                   pytest.param(32, 16, 17, id="blockfp-solve-32-16"),
                   pytest.param(16, 16, 32, id="blockfp-16-16")]


@pytest.mark.parametrize("m,n,e", ITEM_END_SHAPES)
def test_packed_wavefront_item_ends(m, n, e):
    """B5a's and B5b's table (`_wavefront_table`): the caller's Sameh–Kuck
    stages and, as row 3, each pair's item end by `flat_stage_table`'s
    rule, a padded pair owning no item: the whole table is the one the
    flat kernels B1 and B2 run on the flattened stages."""
    piv, tgt, col = tops._stage_tables(tq.sameh_kuck_schedule(m, n), m)
    table = tqb._wavefront_table(tqb._stage_key(piv, tgt, col), m, e,
                                 "cpu").numpy()
    np.testing.assert_array_equal(table[:3], np.stack([piv, tgt, col]))
    owned = np.diff(table[3], axis=1, prepend=0)
    np.testing.assert_array_equal(owned, np.where(piv < m, e - col, 0))
    flat = tuple(s for st in tq.sameh_kuck_schedule(m, n) for s in st)
    np.testing.assert_array_equal(table, tqb.flat_stage_table(flat, m, e))


@pytest.mark.parametrize("iters", [24, 30])
@pytest.mark.parametrize("hub", [False, True], ids=["conv", "hub"])
def test_fused_rotate_pairs_bit_equal_to_jax(hub, iters):
    rng = np.random.default_rng(iters + hub)
    TB, P, e = 3, 4, 7
    x = rng.integers(-2 ** 24, 2 ** 24 + 1, size=(TB, P, e))
    y = rng.integers(-2 ** 24, 2 ** 24 + 1, size=(TB, P, e))
    x[0, 0], y[0, 0] = 2 ** 24, -2 ** 24          # the largest amax
    x[1, 1, 2], y[1, 1, 2] = -5, 2 ** 24          # a negative lead (flip)
    x[2, 2, 2], y[2, 2, 2] = 0, -7                # a zero lead
    x[:, 3], y[:, 3] = 0, 0                       # a padded pair: zero rows
    x, y = x.astype(np.int32), y.astype(np.int32)
    lead = np.zeros((P, e), bool)
    for p, c in enumerate((0, 2, 2, 0)):
        lead[p, c] = True
    kw = dict(iters=iters, hub=hub, comp=tcg.comp_q30(iters))
    want = jcg.fused_rotate_pairs(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(lead), **kw)
    got = tcg.fused_rotate_pairs(torch.tensor(x), torch.tensor(y),
                                 torch.tensor(lead), **kw)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------
#: The operands: the engine's (5 x 4, with Q) and a non-square one whose
#: stages hold one pair beside the widest (3 x 6, with Q).
A_ENGINE = np.random.default_rng(31).normal(size=(2, 5, 4))
A_WIDE = np.random.default_rng(33).normal(size=(2, 3, 6)) * np.exp2(
    np.random.default_rng(34).integers(-6, 6, size=(2, 3, 6)))
A_WIDE[0, -1] = 0.0                            # a row of zeros
A_WIDE[1, 0, 0] = 1.0                          # exact 1.0 (HUB identity)


def _work(A):
    m = A.shape[-2]
    return np.concatenate([A, np.broadcast_to(np.eye(m), A.shape[:-1] + (m,))],
                          axis=-1)


def _tables(A):
    m, n = A.shape[-2:]
    return tops._stage_tables(tq.sameh_kuck_schedule(m, n), m)


#: (hub, operand) of the packed plain-version cases.
PACKED_CASES = {"ieee": (False, A_ENGINE), "hub": (True, A_WIDE)}


@pytest.fixture(scope="module")
def jax_packed():
    """The JAX packed wavefront body on each case's words, the HUB case's
    tables in the stacked layout."""
    out = {}
    for name, (hub, A) in PACKED_CASES.items():
        P = tq.GivensUnit(GivensConfig(hub=hub, n=26)).encode(
            torch.tensor(_work(A)))
        out[name] = P, _jax_body(jqb._qr_packed_wavefront_kernel, P.numpy(),
                                 _tables(A), "stacked" if hub else "split",
                                 cfg=JConfig(hub=hub, n=26))
    return out


@pytest.mark.parametrize("layout", ["split", "stacked"])
@pytest.mark.parametrize("case", list(PACKED_CASES))
def test_packed_wavefront_plain_version_bit_equal_to_jax(jax_packed, case,
                                                        layout):
    hub, A = PACKED_CASES[case]
    cfg = GivensConfig(hub=hub, n=26)
    P, want = jax_packed[case]
    before = tqb.QR_PACKED_WAVEFRONT_LAUNCHES
    got = tqb.qr_packed_wavefront_call(P, *_tables(A), cfg=cfg,
                                       table_layout=layout)
    assert tqb.QR_PACKED_WAVEFRONT_LAUNCHES == before
    np.testing.assert_array_equal(want, got.numpy())
    m, n = A.shape[-2:]
    assert torch.equal(got, tqb.qr_packed_reference(P, cfg=cfg,
                                                    steps=_flat(m, n)))


#: (hub, iters) -> operand of the block-FP plain-version cases; HUB at
#: iters 24 is the engine's.  (`test_fused_rotate_pairs_bit_equal_to_jax`
#: holds the stage step to the JAX package at all four (hub, iters).)
BFP_CASES = {(True, 24): A_ENGINE, (False, 30): A_WIDE}


@pytest.fixture(scope="module")
def jax_bfp():
    """The JAX block-FP wavefront body on each case's significands (the
    JAX package's encode), HUB cases in the stacked layout."""
    out = {}
    for (hub, iters), A in BFP_CASES.items():
        X, ex = jops._blockfp_encode(jnp.asarray(_work(A)), 24)
        X = np.asarray(X)
        out[hub, iters] = X, ex, _jax_body(
            jqb._qr_blockfp_wavefront_kernel, X, _tables(A),
            "stacked" if hub else "split", iters=iters, hub=hub,
            comp=jcg.comp_q30(iters))
    return out


@pytest.mark.parametrize("case", list(BFP_CASES), ids=str)
def test_blockfp_wavefront_plain_version_bit_equal_to_jax(jax_bfp, case):
    hub, iters = case
    X, _, want = jax_bfp[case]
    tables = _tables(BFP_CASES[case])
    got = tqb.qr_blockfp_wavefront_call(torch.tensor(X), *tables, iters=iters,
                                        hub=hub, table_layout="split")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    m, n = BFP_CASES[case].shape[-2:]
    flat = tqb.qr_blockfp_reference(torch.tensor(X), iters=iters, hub=hub,
                                    steps=_flat(m, n))
    assert torch.equal(got, flat)


def test_wavefront_wrappers_refuse_an_unknown_layout():
    P = torch.zeros((1, 4, 4), dtype=torch.int64)
    tables = tops._stage_tables(tq.sameh_kuck_schedule(4, 4), 4)
    with pytest.raises(ValueError, match="table_layout"):
        tqb.qr_packed_wavefront_call(P, *tables, cfg=GivensConfig(),
                                     table_layout="rows")
    with pytest.raises(ValueError, match="table_layout"):
        tqb.qr_blockfp_wavefront_call(P.to(torch.int32), *tables, iters=24,
                                      hub=True, table_layout="rows")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["cordic_pallas", "blockfp_pallas"])
def test_engine_sameh_kuck_bit_equal_to_jax(backend, jax_packed, jax_bfp):
    """The engine's wavefront route against the JAX package's: its
    encode, the kernel body's words (above), its decode and split."""
    hub = backend == "blockfp_pallas"
    if hub:
        _, ex, words = jax_bfp[True, 24]
        out = jops._blockfp_decode(jnp.asarray(words), ex, 24)
    else:
        _, words = jax_packed["ieee"]
        out = jq.GivensUnit(JConfig(n=26)).decode(jnp.asarray(words))
    Qj, Rj = jq._split_qr(out, 5, 4, True)
    eng = tapi.QRDEngine(backend=backend, schedule="sameh_kuck",
                         dtype="float64", givens=GivensConfig(hub=hub, n=26),
                         device="cpu")
    Qt, Rt = eng(A_ENGINE)
    _bits_equal(Qj, Qt)
    _bits_equal(Rj, Rt)


def test_engine_sameh_kuck_solve():
    rng = np.random.default_rng(32)
    A = rng.normal(size=(3, 6, 3))
    b = rng.normal(size=(3, 6))
    want = np.stack([np.linalg.lstsq(a, v, rcond=None)[0] for a, v in zip(A, b)])
    for backend in ("cordic_pallas", "blockfp_pallas"):
        eng = tapi.QRDEngine(backend=backend, schedule="sameh_kuck",
                             dtype="float64", givens=GivensConfig(hub=True, n=26),
                             device="cpu")
        x = eng.solve(A, b).numpy()
        err = np.linalg.norm(x - want, axis=-1) / np.linalg.norm(want, axis=-1)
        assert err.max() <= tapi.SOLVE_TOLERANCES[backend]
