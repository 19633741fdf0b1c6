"""The port's complex datapath (kernels B7a, B7b) against the JAX package on
the CPU.

* `GivensUnit.phase_vector`, `phase_rotate` and `rotate_rows_complex` give
  the JAX unit's packed words, on random words, exactly real leads
  (imaginary word +0 or -0) and zero leads, IEEE and HUB.
* The plain versions of the two complex kernels (`qr_packed_complex_call`,
  `qr_packed_complex_wavefront_call` on CPU tensors) give the words of the
  JAX complex wavefront kernel's body, on its Sameh–Kuck stages and on the
  column-major steps grouped into stages of disjoint pairs; the JAX
  package holds that body equal to its flat complex kernel and host loop
  on the flattened order.
* `QRDEngine(backend='cordic' | 'cordic_pallas', dtype='complex128',
  device='cpu')` on both schedules gives the JAX package's Q and R; complex
  `solve` agrees with ``np.linalg.lstsq`` within
  ``SOLVE_TOLERANCES['cordic_pallas:complex']``; purely real input gives
  the real datapath's values with zero imaginary parts; a complex
  `QRDConfig` round-trips through JSON between the packages.

Inputs are made with numpy from a seed.  No JAX complex kernel is compiled
in interpret mode: the wavefront body runs outside Pallas with a stand-in
for its refs, jitted whole (its `lax.scan` traces one stage), once per
configuration and table shape.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import qrd as japi
from repro.core import qrd as jq
from repro.core.givens import GivensConfig as JConfig
from repro.core.givens import GivensUnit as JUnit
from repro.kernels import ops as jops
from repro.kernels import qrd_blocked as jqb

from repro_torch import qrd as tapi
from repro_torch.core import qrd as tq
from repro_torch.core.givens import GivensConfig, GivensUnit
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qrd_blocked as tqb

#: Per datapath: the operand shape (m, n); HUB's 4 x 3 has stages of one
#: and of two pairs (the tables' padding).
CASES = {"ieee": (False, (3, 2)), "hub": (True, (4, 3))}


def _complex(seed, shape, edge=True):
    """Random complex matrices; with ``edge`` exactly real leads (+0 and -0
    imaginary parts) and a zero lead in column 0."""
    rng = np.random.default_rng(seed)
    C = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * np.exp2(
        rng.integers(-4, 4, size=shape))
    if edge:
        C[0, 0, 0] = C[0, 0, 0].real + 0j
        C[0, 1, 0] = complex(C[0, 1, 0].real, -0.0)
        C[-1, -1, 0] = 0
    return C


def _bits_equal(want, got):
    """complex128 (or float64) arrays equal bit for bit."""
    want = np.ascontiguousarray(np.asarray(want))
    got = np.ascontiguousarray(got.resolve_conj().numpy())
    assert want.shape == got.shape and want.dtype == got.dtype
    np.testing.assert_array_equal(want.view(np.int64), got.view(np.int64))


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
def _jax_wavefront(cfg):
    def run(P, piv, tgt, col):
        out = _Ref()
        jqb._qr_packed_complex_wavefront_kernel(
            _Ref(piv), _Ref(tgt), _Ref(col), _Ref(P), out, cfg=cfg,
            S=piv.shape[0], table_layout="split")
        return out.v
    return jax.jit(run)


def _col_stages(m, n):
    """The column-major steps as stages: each step its own stage, except
    that a step whose rows are disjoint from its predecessor's joins it
    (pairs of one stage commute, so the flattened order is still
    column-major).  4 x 3 then gives the Sameh–Kuck tables' shape, and one
    compile serves both orders."""
    stages = []
    for s in tq.givens_schedule(m, n):
        if stages and len(stages[-1]) == 1 and not (
                {s[0], s[1]} & {stages[-1][0][0], stages[-1][0][1]}):
            stages[-1] = stages[-1] + (s,)
        else:
            stages.append((s,))
    return tuple(stages)


@pytest.fixture(scope="module")
def jax_words():
    """Per case: the operand, the packed words of [C | I], and the JAX
    complex wavefront body's output on the Sameh–Kuck stages and on the
    column-major steps (`_col_stages`)."""
    out = {}
    for name, (hub, (m, n)) in CASES.items():
        cfg = JConfig(hub=hub, n=26)
        C = _complex(7 + hub, (2, m, n))
        unit = JUnit(cfg)
        P = np.asarray(jq._encode_complex(unit, jq._augment_complex(
            jnp.asarray(C), True)))
        words = {}
        for order, stages in (("sk", tq.sameh_kuck_schedule(m, n)),
                              ("col", _col_stages(m, n))):
            tables = jops._stage_tables(stages, m)
            words[order] = np.asarray(_jax_wavefront(cfg)(
                jnp.asarray(P), *(jnp.asarray(t) for t in tables)))
        out[name] = C, P, words
    return out


# ---------------------------------------------------------------------------
# the unit's complex functions
# ---------------------------------------------------------------------------
def _lead_words(cfg, rng):
    """(8,) re and im words: random, exactly real (+0, -0), a zero lead, an
    exact 1.0, a purely imaginary one."""
    unit = GivensUnit(cfg)
    re = rng.normal(size=8) * np.exp2(rng.integers(-8, 8, size=8))
    im = rng.normal(size=8) * np.exp2(rng.integers(-8, 8, size=8))
    im[1], im[2] = 0.0, -0.0
    re[3], im[3] = 0.0, 0.0
    re[4], im[4] = 1.0, 0.0
    re[5] = 0.0
    return unit.encode(torch.tensor(re)), unit.encode(torch.tensor(im))


@pytest.mark.parametrize("case", list(CASES))
def test_phase_functions_bit_equal_to_jax(case):
    hub = CASES[case][0]
    cfg = GivensConfig(hub=hub, n=26)
    ju, tu = JUnit(JConfig(hub=hub, n=26)), GivensUnit(cfg)
    rng = np.random.default_rng(3 + hub)
    re, im = _lead_words(cfg, rng)
    want_mag, (wf, ws), want_skip = jax.jit(ju.phase_vector)(
        jnp.asarray(re.numpy()), jnp.asarray(im.numpy()))
    mag, (f, s), skip = tu.phase_vector(re, im)
    for w, g in ((want_mag, mag), (wf, f), (ws, s), (want_skip, skip)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert skip[1:3].all() and skip[3:5].all() and not skip[0]
    # replay on further (re, im) pairs of each row; skipped rows pass through
    xr, xi = (GivensUnit(cfg).encode(torch.tensor(
        rng.normal(size=(8, 5)))) for _ in range(2))
    state = (f[:, None], s[:, None])
    want = jax.jit(ju.phase_rotate)(jnp.asarray(xr.numpy()),
                                    jnp.asarray(xi.numpy()),
                                    tuple(jnp.asarray(t.numpy()) for t in state),
                                    jnp.asarray(skip[:, None].numpy()))
    got = tu.phase_rotate(xr, xi, state, skip[:, None])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert torch.equal(got[0][1], xr[1]) and torch.equal(got[1][1], xi[1])


def test_rotate_rows_complex_bit_equal_to_jax():
    cfg = GivensConfig(hub=True, n=26)
    rng = np.random.default_rng(5)
    rows = []
    for _ in range(2):
        re, im = _lead_words(cfg, rng)
        rest = GivensUnit(cfg).encode(torch.tensor(rng.normal(size=(8, 3, 2))))
        rows.append(torch.cat([torch.stack([re, im], -1)[:, None], rest], 1))
    x, y = rows
    y[6] = 0                                      # a zero target row
    want = jax.jit(JUnit(JConfig(hub=True, n=26)).rotate_rows_complex)(
        jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    got = GivensUnit(cfg).rotate_rows_complex(x, y)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert torch.all(got[1][:, 0] == 0) and torch.all(got[0][:, 0, 1] == 0)


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_complex_plain_versions_bit_equal_to_jax(jax_words, case):
    hub, (m, n) = CASES[case]
    cfg = GivensConfig(hub=hub, n=26)
    _, P, words = jax_words[case]
    P = torch.tensor(P)
    before = (tqb.QR_PACKED_COMPLEX_LAUNCHES,
              tqb.QR_PACKED_COMPLEX_WAVEFRONT_LAUNCHES)
    tables = tops._stage_tables(tq.sameh_kuck_schedule(m, n), m)
    got = tqb.qr_packed_complex_wavefront_call(P, *tables, cfg=cfg)
    np.testing.assert_array_equal(words["sk"], got.numpy())
    flat = tuple(s for st in tq.sameh_kuck_schedule(m, n) for s in st)
    got = tqb.qr_packed_complex_call(P, cfg=cfg, steps=flat)
    np.testing.assert_array_equal(words["sk"], got.numpy())
    got = tqb.qr_packed_complex_call(P, cfg=cfg, steps=tq.givens_schedule(m, n))
    np.testing.assert_array_equal(words["col"], got.numpy())
    assert (tqb.QR_PACKED_COMPLEX_LAUNCHES,
            tqb.QR_PACKED_COMPLEX_WAVEFRONT_LAUNCHES) == before


def test_complex_wrappers_check_the_lane_axis():
    cfg = GivensConfig()
    with pytest.raises(ValueError):
        tqb.qr_packed_complex_call(torch.zeros((1, 3, 3, 2), dtype=torch.int64,
                                               device="meta"),
                                   cfg=cfg, steps=((0, 1, 0),))
    with pytest.raises(ValueError):
        tqb.qr_packed_complex_call(torch.zeros((1, 3, 3), dtype=torch.int64),
                                   cfg=cfg, steps=((0, 1, 0),))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("schedule", ["col", "sameh_kuck"])
@pytest.mark.parametrize("backend", ["cordic", "cordic_pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_engine_complex_bit_equal_to_jax(jax_words, case, backend, schedule):
    """Q and R of the port's engine against the JAX package's words,
    decoded and split by its own functions."""
    hub, (m, n) = CASES[case]
    C, _, words = jax_words[case]
    unit = JUnit(JConfig(hub=hub, n=26))
    out = jq._decode_complex(unit, jnp.asarray(
        words["col" if schedule == "col" else "sk"]))
    Qj, Rj = jq._split_qr_complex(out, m, n, True)
    eng = tapi.QRDEngine(backend=backend, schedule=schedule,
                         dtype="complex128", givens=GivensConfig(hub=hub, n=26),
                         device="cpu")
    Qt, Rt = eng(C)
    assert Qt.dtype == torch.complex128 and Qt.device.type == "cpu"
    _bits_equal(Qj, Qt)
    _bits_equal(Rj, Rt)


def test_engine_complex_operand_upgrades_a_real_config():
    """A complex operand on a real-dtype config takes the complex datapath
    (as the JAX package does); a complex block-FP config is refused."""
    C = _complex(9, (2, 3, 2))
    Q, R = tapi.QRDEngine(backend="cordic_pallas", device="cpu")(C)
    Qc, Rc = tapi.QRDEngine(backend="cordic_pallas", dtype="complex128",
                            device="cpu")(C)
    assert Q.dtype == torch.complex128
    assert torch.equal(Q, Qc) and torch.equal(R, Rc)
    with pytest.raises(TypeError, match="has no complex datapath") as got:
        tapi.QRDEngine(backend="blockfp_pallas", dtype="complex128",
                       device="cpu")
    with pytest.raises(TypeError, match="has no complex datapath") as want:
        japi.QRDEngine(backend="blockfp_pallas", dtype="complex128")
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]


@pytest.mark.parametrize("schedule", ["col", "sameh_kuck"])
def test_complex_solve_within_tolerance(schedule):
    rng = np.random.default_rng(11)
    A = _complex(12, (3, 6, 3), edge=False)
    b = rng.normal(size=(3, 6)) + 1j * rng.normal(size=(3, 6))
    want = np.stack([np.linalg.lstsq(a, v, rcond=None)[0]
                     for a, v in zip(A, b)])
    eng = tapi.QRDEngine(backend="cordic_pallas", schedule=schedule,
                         dtype="complex128", givens=GivensConfig(hub=True, n=26),
                         device="cpu")
    x = eng.solve(A, b)
    assert x.dtype == torch.complex128 and x.shape == (3, 3)
    err = (np.linalg.norm(x.numpy() - want, axis=-1)
           / np.linalg.norm(want, axis=-1))
    assert err.max() <= tapi.SOLVE_TOLERANCES["cordic_pallas:complex"]


def test_purely_real_complex_gives_the_real_datapath():
    """The JAX package's contract (tests/test_qrd_complex.py): real parts
    bit-equal to the real route, imaginary parts zero."""
    A = np.random.default_rng(13).normal(size=(2, 5, 3))
    for schedule in ("col", "sameh_kuck"):
        kw = dict(backend="cordic_pallas", schedule=schedule,
                  givens=GivensConfig(hub=True, n=26), device="cpu")
        Qr, Rr = tapi.QRDEngine(dtype="float64", **kw)(A)
        Qc, Rc = tapi.QRDEngine(dtype="complex128", **kw)(A.astype(complex))
        assert torch.equal(Qc.real, Qr) and torch.equal(Rc.real, Rr)
        assert torch.all(Qc.imag == 0) and torch.all(Rc.imag == 0)


def test_complex_config_json_round_trips_between_packages():
    jcfg = japi.QRDConfig(backend="cordic_pallas", schedule="sameh_kuck",
                          dtype="complex128", table_layout="stacked",
                          givens=JConfig(hub=True, n=26), tile_b=2)
    tcfg = tapi.QRDConfig.from_json(jcfg.to_json())
    assert tcfg.is_complex() and tcfg.to_json() == jcfg.to_json()
    assert japi.QRDConfig.from_json(tcfg.to_json()) == jcfg
    tcfg.validate()
