"""The port's dual-int32 lane datapath (kernels B8a, B8b) against the JAX
package on the CPU.

* The 64-bit primitives of `repro_torch.kernels.packed_lanes` on (hi, lo)
  halves give the words of `repro.kernels.packed_lanes`'s on corners and
  random int64 samples, shift counts 0, 1, 31, 32, 33, 62, 63 and beyond
  the word included, as Python ints and as tensors.
* `cordic_givens.packed_to_lanes` / `lanes_to_packed` give the JAX pair's
  words.
* `LaneUnit.vector` and `rotate` give the JAX `LaneUnit`'s words and
  states on the JAX package's five lane configurations
  (tests/test_packed_lanes.py), `rotate_rows` through the JAX flat lane
  kernel's body; and `LaneUnit` equals the port's int64 `GivensUnit` up to
  N = 50, where the exact integer `ilog2_64` and the int64 unit's float64
  `frexp` must still agree.
* The plain versions of B8a and B8b (`qr_packed_lanes_call`,
  `qr_packed_lanes_wavefront_call` on CPU tensors) give the words of the
  JAX kernels' bodies `_qr_packed_lanes_kernel` and
  `_qr_packed_lanes_wavefront_kernel` (both table layouts), equal each
  other on the flattened stage schedule, and equal the int64 kernels'
  plain versions through `lanes_to_packed`; `ops.qr_packed` and
  `ops.qr_packed_wavefront` give the same words with ``lanes=True`` as
  without.

Every comparison is bit for bit.  Inputs are made with numpy from a seed.
The JAX kernel bodies run outside Pallas with a stand-in for their refs,
one `jax.jit` each in a module fixture (never the interpret-mode Pallas
compile): the flat body at one step, since its trace and compile grow
with the steps (about 2 s a step), the wavefront body at 6 x 4 x 8, whose
scan traces one stage.  The JAX `LaneUnit` runs eagerly on words of the
primitives' shapes (about 0.8 s a configuration after a first call of
about 5 s, the largest cost of this file; jitted it costs 2 s each).
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.givens import GivensConfig as JConfig
from repro.kernels import cordic_givens as jcg
from repro.kernels import ops as jops
from repro.kernels import packed_lanes as jpl
from repro.kernels import qrd_blocked as jqb

from repro_torch.core import qrd as tq
from repro_torch.core.givens import GivensConfig, GivensUnit
from repro_torch.kernels import cordic_givens as tcg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import packed_lanes as tpl
from repro_torch.kernels import qrd_blocked as tqb

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the 64-bit primitives
# ---------------------------------------------------------------------------
CORNERS = [0, 1, -1, 2, -2, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32,
           2 ** 32 + 1, -2 ** 31, -2 ** 32, 2 ** 62, 2 ** 63 - 1, -2 ** 63,
           -2 ** 63 + 1, 0x0000FFFF0000FFFF, 0x7FFFFFFF80000000,
           0x123456789ABCDEF0 - 2 ** 63]

#: Shift counts, the corners of the two-step shift first.
SHIFTS = [0, 1, 31, 32, 33, 62, 63, -1, 64, 100]


def _samples(seed, n=64):
    rng = np.random.default_rng(seed)
    rand = rng.integers(-2 ** 63, 2 ** 63 - 1, size=n - len(CORNERS),
                        dtype=np.int64, endpoint=True)
    small = rng.integers(-2 ** 20, 2 ** 20, size=8, dtype=np.int64)
    return np.concatenate([np.array(CORNERS, np.int64), small, rand])[:n]


def _jpair(x):
    u = x.view(np.uint64)
    return (jnp.asarray((u >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((u & np.uint64(_M32)).astype(np.uint32)))


def _tpair(x):
    u = x.view(np.uint64)
    return (torch.tensor((u >> np.uint64(32)).astype(np.int64)),
            torch.tensor((u & np.uint64(_M32)).astype(np.int64)))


def _same(want, got):
    """A JAX result (a pair, or one array) equals the port's."""
    if isinstance(want, tuple):
        for w, g in zip(want, got):
            _same(w, g)
        return
    w = np.asarray(want).astype(np.int64)
    g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(w, np.broadcast_to(g, w.shape))


A64, B64 = _samples(1), _samples(2)


@pytest.mark.parametrize("name", ["add64", "sub64", "mul64", "and64",
                                  "or64", "xor64", "eq64", "ltu64"])
def test_binary_primitives_equal_jax(name):
    b = np.concatenate([A64[:8], B64[8:]])      # equal operands included
    want = getattr(jpl, name)(_jpair(A64), _jpair(b))
    got = getattr(tpl, name)(_tpair(A64), _tpair(b))
    _same(want, got)


@pytest.mark.parametrize("name", ["not64", "neg64", "is_neg64"])
def test_unary_primitives_equal_jax(name):
    _same(getattr(jpl, name)(_jpair(A64)), getattr(tpl, name)(_tpair(A64)))


def test_from_i32_equals_jax():
    x = (A64 & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    _same(jpl.from_i32(jnp.asarray(x)), tpl.from_i32(torch.tensor(x)))


def test_ilog2_equals_jax():
    pos = np.concatenate([np.abs(A64[A64 > 0]), [1, 2, 3, 2 ** 32 - 1,
                                                 2 ** 32, 2 ** 53 + 1]])
    pos = pos.astype(np.int64)
    _same(jpl.ilog2_64(_jpair(pos)), tpl.ilog2_64(_tpair(pos)))
    lo = _tpair(A64)[1]
    _same(jpl.ilog2_32(_jpair(A64)[1]), tpl.ilog2_32(lo))


@pytest.mark.parametrize("name", ["shl64", "shr64", "sar64"])
def test_shifts_equal_jax(name):
    counts = np.resize(np.array(SHIFTS, np.int32), A64.shape)
    _same(getattr(jpl, name)(_jpair(A64), jnp.asarray(counts)),
          getattr(tpl, name)(_tpair(A64), torch.tensor(counts)))
    for s in SHIFTS:                          # a static count
        _same(getattr(jpl, name)(_jpair(A64), s),
              getattr(tpl, name)(_tpair(A64), s))


def test_rshift_rne_equals_jax():
    counts = np.resize(np.array(SHIFTS, np.int32), A64.shape)
    for c in (counts, np.roll(counts, 3)):
        _same(jpl.rshift_rne64(_jpair(A64), jnp.asarray(c)),
              tpl.rshift_rne64(_tpair(A64), torch.tensor(c)))


def test_packed_to_lanes_equals_jax():
    L = tcg.packed_to_lanes(torch.tensor(A64))
    assert L.dtype == torch.int32 and tuple(L.shape) == (len(A64), 2)
    np.testing.assert_array_equal(np.asarray(jcg.packed_to_lanes(
        jnp.asarray(A64))), L.numpy())
    back = tcg.lanes_to_packed(L)
    np.testing.assert_array_equal(np.asarray(jcg.lanes_to_packed(
        jnp.asarray(L.numpy()))), back.numpy())
    np.testing.assert_array_equal(back.numpy(), A64)


# ---------------------------------------------------------------------------
# the unit
# ---------------------------------------------------------------------------
#: The JAX package's five lane configurations (tests/test_packed_lanes.py).
CONFIGS = [dict(hub=False, input_rounding="trunc"),
           dict(hub=False, input_rounding="rne"),
           dict(hub=True, unbiased=True, detect_identity=True),
           dict(hub=True, unbiased=False, detect_identity=False),
           dict(hub=True, n=30, iters=20)]


def _cfg_id(kw):
    return "-".join(f"{k}={v}" for k, v in kw.items())


def _words(cfg, B, e, seed):
    """Lane words of (B, e) rows x, y: random values over a wide range and
    the datapath's edges (exponent gaps past N + 2 against the lead, zeros,
    exact 1.0, the largest exponent)."""
    rng = np.random.default_rng(seed)
    W = chip_smoke.edge_words(cfg, B, 2, e, rng, "cpu")
    A = rng.normal(size=(B, 2, e)) * np.exp2(rng.integers(-40, 40, (B, 2, e)))
    W[: B // 2] = GivensUnit(cfg).encode(torch.tensor(A[: B // 2]))
    L = tcg.packed_to_lanes(W)
    return L[:, 0], L[:, 1]


@pytest.mark.parametrize("kw", CONFIGS, ids=_cfg_id)
def test_lane_unit_vector_and_rotate_equal_jax(kw):
    """`vector` on the lead pairs, and `rotate` of each pair's state on
    another pair of the same rows; the JAX unit runs eagerly on (B, 2)
    words, the shapes of the primitives above, so its operations are
    compiled once for all configurations."""
    cfg, ju = GivensConfig(**kw), jpl.LaneUnit(JConfig(**kw))
    x, y = _words(cfg, 64, 2, 5)
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    unit = tpl.LaneUnit(cfg)
    want = ju.vector(jx[:, 0], jy[:, 0])
    r, y0, state = unit.vector(x[:, 0], y[:, 0])
    _same(want[:2], (r, y0))
    _same(want[2], state)                     # (flip, sigma)
    _same(ju.rotate(jx[:, 1], jy[:, 1], want[2]),
          unit.rotate(x[:, 1], y[:, 1], state))


@pytest.mark.parametrize("kw", [dict(n=50), dict(hub=True, n=50),
                                dict(n=48, input_rounding="rne"),
                                dict(hub=True, n=26)], ids=_cfg_id)
def test_lane_unit_equals_int64_unit(kw):
    """Through `lanes_to_packed`, the lane unit's rows are the int64 unit's
    up to N = 50: the exact integer ilog2 against float64 frexp."""
    cfg = GivensConfig(**kw)
    x, y = _words(cfg, 64, 5, 7)
    lx, ly = tpl.LaneUnit(cfg).rotate_rows(x, y)
    px, py = GivensUnit(cfg).rotate_rows(tcg.lanes_to_packed(x),
                                         tcg.lanes_to_packed(y))
    assert torch.equal(tcg.lanes_to_packed(lx), px)
    assert torch.equal(tcg.lanes_to_packed(ly), py)


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------
class _Ref:
    """A stand-in for a Pallas ref, so a JAX kernel body runs outside
    Pallas."""

    def __init__(self, v=None):
        self.v = v

    def __getitem__(self, idx):
        return self.v

    def __setitem__(self, idx, v):
        self.v = v


#: The flat body's shape (one step: its trace grows with the steps) and
#: the wavefront body's (a 4 x 4 decomposition with Q: five stages of up to
#: two pairs).  Both HUB at N = 26, the wavefront's tables stacked.
FLAT_SHAPE, WAVE_SHAPE = (6, 2, 2), (6, 4, 4)


def _lane_operand(cfg, shape, seed):
    """Lane words of [A | I] for a (B, m, n) A with a zero row, an exact
    1.0 and wide exponents."""
    rng = np.random.default_rng(seed)
    B, m, n = shape
    A = rng.normal(size=shape) * np.exp2(rng.integers(-30, 30, size=shape))
    A[0, -1] = 0.0
    A[1, 0, 0] = 1.0
    W = np.concatenate([A, np.broadcast_to(np.eye(m), (B, m, m))], axis=-1)
    return tcg.packed_to_lanes(GivensUnit(cfg).encode(torch.tensor(W)))


def _tables(m, n):
    return tops._stage_tables(tq.sameh_kuck_schedule(m, n), m)


def _flat(m, n):
    return tuple(s for st in tq.sameh_kuck_schedule(m, n) for s in st)


@pytest.fixture(scope="module")
def jax_bodies():
    """The JAX lane kernels' bodies, each jitted once, on HUB words."""
    cfg = JConfig(hub=True)
    _, m, n = FLAT_SHAPE
    L = _lane_operand(GivensConfig(hub=True), FLAT_SHAPE, 3)

    def flat(X):
        o = _Ref()
        jqb._qr_packed_lanes_kernel(_Ref(X), o, cfg=cfg,
                                    steps=tq.givens_schedule(m, n))
        return o.v
    out = {"flat": (L, np.asarray(jax.jit(flat)(jnp.asarray(L.numpy()))))}
    _, m, n = WAVE_SHAPE
    L = _lane_operand(GivensConfig(hub=True), WAVE_SHAPE, 4)

    def wave(X, piv, tgt, col):
        o = _Ref()
        jqb._qr_packed_lanes_wavefront_kernel(
            _Ref(jnp.concatenate([piv, tgt, col])), _Ref(X), o, cfg=cfg,
            S=piv.shape[0], table_layout="stacked")
        return o.v
    want = jax.jit(wave)(jnp.asarray(L.numpy()),
                         *(jnp.asarray(t) for t in _tables(m, n)))
    out["wavefront"] = L, np.asarray(want)
    return out


def test_flat_lanes_plain_version_bit_equal_to_jax(jax_bodies):
    L, want = jax_bodies["flat"]
    _, m, n = FLAT_SHAPE
    before = tqb.QR_PACKED_LANES_LAUNCHES
    got = tqb.qr_packed_lanes_call(L, cfg=GivensConfig(hub=True),
                                   steps=tq.givens_schedule(m, n))
    assert tqb.QR_PACKED_LANES_LAUNCHES == before      # no launch on the CPU
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("layout", ["split", "stacked"])
def test_wavefront_lanes_plain_version_bit_equal_to_jax(jax_bodies, layout):
    """Both layouts give the JAX body's words (the JAX body ran on the
    stacked tables); and so does the flat plain version on the flattened
    stages, at the wavefront's 6 x 4 x 8."""
    cfg = GivensConfig(hub=True)
    L, want = jax_bodies["wavefront"]
    _, m, n = WAVE_SHAPE
    before = tqb.QR_PACKED_LANES_WAVEFRONT_LAUNCHES
    got = tqb.qr_packed_lanes_wavefront_call(L, *_tables(m, n), cfg=cfg,
                                             table_layout=layout)
    assert tqb.QR_PACKED_LANES_WAVEFRONT_LAUNCHES == before
    np.testing.assert_array_equal(want, got.numpy())
    flat = tqb.qr_packed_lanes_call(L, cfg=cfg, steps=_flat(m, n))
    np.testing.assert_array_equal(want, flat.numpy())


@pytest.mark.parametrize("kw,shape", [
    (dict(hub=True), (2, 4, 4)), (dict(input_rounding="trunc"), (2, 3, 5)),
    (dict(hub=True, n=50), (2, 5, 2))], ids=["hub-4x4", "ieee-3x5",
                                           "hub-n50-5x2"])
def test_lanes_route_equals_int64_route(kw, shape):
    """`ops.qr_packed` and `ops.qr_packed_wavefront` give the same words
    with ``lanes=True`` (the lane plain versions between `packed_to_lanes`
    and `lanes_to_packed`) as with the default int64 route."""
    cfg = GivensConfig(**kw)
    _, m, n = shape
    P = tcg.lanes_to_packed(_lane_operand(cfg, shape, 9))
    P = P.reshape((1,) + P.shape)                 # a leading batch shape
    steps, stages = tq.givens_schedule(m, n), tq.sameh_kuck_schedule(m, n)
    flat = tops.qr_packed(P, cfg=cfg, steps=steps, lanes=True)
    assert flat.dtype == torch.int64
    assert torch.equal(flat, tops.qr_packed(P, cfg=cfg, steps=steps))
    assert torch.equal(
        tops.qr_packed_wavefront(P, cfg=cfg, stages=stages, lanes=True),
        tops.qr_packed_wavefront(P, cfg=cfg, stages=stages, lanes=False))


def test_lane_wrappers_check_operands():
    cfg = GivensConfig(hub=True)
    P = torch.zeros((2, 3, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="lane words"):
        tqb.qr_packed_lanes_call(P, cfg=cfg, steps=tq.givens_schedule(3, 2))
    with pytest.raises(ValueError, match="table_layout"):
        tqb.qr_packed_lanes_wavefront_call(
            torch.zeros((2, 3, 5, 2), dtype=torch.int32), *_tables(3, 2),
            cfg=cfg, table_layout="rows")
