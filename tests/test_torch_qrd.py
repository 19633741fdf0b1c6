"""The port's QR routines and engine against the JAX package on the CPU.

* `qr_cordic` (the host loop over `qr_packed_reference`) and
  `qr_cordic_pallas` (the kernel wrapper, which runs the plain version on
  a CPU tensor) give Q and R bit-identical to `repro.core.qrd.qr_cordic`.
* `QRDEngine(device='cpu', backend='cordic_pallas')` gives Q and R
  bit-identical to `repro.qrd.QRDEngine(backend='cordic_pallas')`, and
  `solve` agrees to 1e-12 (float64 summation order only: R is bit-equal).
* The significand-width and CORDIC-depth overrides ``N``/``iters`` (the
  paper's Fig. 9 sweep) of `qr_cordic`, `qr_cordic_complex` and the
  unit's methods give the JAX package's words, in its positional order;
  `cordic.cordic_gain` and `cordic.vectoring_rotation` its values.

Inputs are made with numpy from a seed.  The JAX reference is
`repro.core.qrd.qr_cordic` driven by its own unit with `rotate_rows`
jitted once per row width: jitting the whole loop once per configuration
and shape costs more than the tests' whole budget, and running it fully
eagerly is slower still; the arithmetic is XLA's either way.  Without Q,
R is the first n columns of the run with Q in both packages (every element
is rotated on its own once the lead's control word is known), so the JAX
reference runs once per configuration and shape, with Q.  The
interpret-mode Pallas kernel runs twice in this module (module-scoped
fixtures), at 6 x 4.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import qrd as japi
from repro.core import cordic as jcordic
from repro.core import qrd as jq
from repro.core.givens import GivensConfig as JConfig
from repro.core.givens import GivensUnit as JUnit

from repro_torch import qrd as tapi
from repro_torch.core import cordic as tcordic
from repro_torch.core import qrd as tq
from repro_torch.core.givens import GivensConfig, GivensUnit

#: The four datapath variants of the smoke run, at SINGLE, N = 26.
VARIANTS = {
    "ieee-trunc": dict(input_rounding="trunc"),
    "ieee-rne": dict(input_rounding="rne"),
    "hub-full": dict(hub=True),
    "hub-basic": dict(hub=True, unbiased=False, detect_identity=False),
}


class _JitRowsUnit(JUnit):
    """The JAX unit with `rotate_rows` jitted (one compile per row width)."""

    def __init__(self, config):
        super().__init__(config)
        self._rotate_rows = jax.jit(super().rotate_rows)

    def rotate_rows(self, row_x, row_y, N=None, iters=None):
        return self._rotate_rows(row_x, row_y)


def _configs(variant):
    kw = VARIANTS[variant]
    return JConfig(n=26, **kw), GivensConfig(n=26, **kw)


def _matrices(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape) * np.exp2(rng.integers(-6, 6, size=shape))


@functools.lru_cache(maxsize=None)
def _jax_unit(variant):
    return _JitRowsUnit(_configs(variant)[0])


@functools.lru_cache(maxsize=None)
def _jax_qr(variant, shape, seed):
    """JAX (Q, R) with Q for a (3,) + shape batch, as numpy arrays."""
    A = _matrices(seed, (3,) + shape)
    Q, R = jq.qr_cordic(A, _jax_unit(variant), compute_q=True)
    return A, np.asarray(Q), np.asarray(R)


def _bits_equal(jax_out, torch_out):
    """float64 arrays equal bit for bit (signs of zeros included)."""
    a = np.ascontiguousarray(np.asarray(jax_out, dtype=np.float64))
    b = np.ascontiguousarray(torch_out.numpy())
    np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64))


def _engine(variant, **kw):
    return tapi.QRDEngine(backend="cordic_pallas", dtype="float64",
                          givens=_configs(variant)[1], device="cpu", **kw)


@pytest.mark.parametrize("compute_q", [True, False], ids=["Q", "noQ"])
@pytest.mark.parametrize("shape", [(5, 4), (3, 6)], ids=["5x4", "3x6"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_qr_cordic_bit_equal_to_jax(variant, shape, compute_q):
    _, tc = _configs(variant)
    A, Qj, Rj = _jax_qr(variant, shape, list(VARIANTS).index(variant))
    for qr_fn in (tq.qr_cordic, tq.qr_cordic_pallas):
        Qt, Rt = qr_fn(torch.tensor(A), GivensUnit(tc), compute_q=compute_q)
        _bits_equal(Rj, Rt)
        if compute_q:
            _bits_equal(Qj, Qt)
        else:
            assert Qt is None


A_PALLAS = _matrices(11, (2, 6, 4))


@pytest.fixture(scope="module")
def jax_pallas_hub():
    """`repro.core.qrd.qr_cordic_pallas` in interpret mode, 6 x 4 HUB."""
    jc, _ = _configs("hub-full")
    Q, R = jq.qr_cordic_pallas(A_PALLAS, JUnit(jc))
    return np.asarray(Q), np.asarray(R)


@pytest.fixture(scope="module")
def jax_engine_ieee():
    """`repro.qrd.QRDEngine(backend='cordic_pallas')`, 6 x 4 IEEE."""
    jc, _ = _configs("ieee-trunc")
    eng = japi.QRDEngine(backend="cordic_pallas", dtype="float64", givens=jc)
    Q, R = eng(A_PALLAS)
    return np.asarray(Q), np.asarray(R)


def test_qr_cordic_pallas_bit_equal_to_jax_kernel(jax_pallas_hub):
    _, tc = _configs("hub-full")
    Qt, Rt = tq.qr_cordic_pallas(torch.tensor(A_PALLAS), GivensUnit(tc))
    _bits_equal(jax_pallas_hub[0], Qt)
    _bits_equal(jax_pallas_hub[1], Rt)


@pytest.mark.parametrize("variant", ["hub-full", "ieee-trunc"])
def test_engine_bit_equal_to_jax_engine(variant, request):
    fixture = "jax_pallas_hub" if variant == "hub-full" else "jax_engine_ieee"
    Qj, Rj = request.getfixturevalue(fixture)
    Qt, Rt = _engine(variant)(A_PALLAS)
    assert Qt.device.type == "cpu" and Qt.dtype == torch.float64
    _bits_equal(Qj, Qt)
    _bits_equal(Rj, Rt)


@pytest.mark.parametrize("rhs", [None, 2], ids=["vector", "2rhs"])
def test_solve_matches_jax(rhs):
    """`solve` against the JAX engine's own two steps: the Q-free
    factorization of [A | b] and `repro.qrd.lstsq_from_triangular`."""
    rng = np.random.default_rng(3)
    n = 3 if rhs is None else 2
    A = rng.normal(size=(3, 5, n))
    b = rng.normal(size=(3, 5) if rhs is None else (3, 5, rhs))
    aug = np.concatenate([A, b[..., None] if rhs is None else b], axis=-1)
    _, Rj = jq.qr_cordic(aug, _jax_unit("hub-full"), compute_q=False)
    xj, rj = japi.lstsq_from_triangular(Rj, n)
    xj, rj = np.asarray(xj), np.asarray(rj)
    if rhs is None:
        xj, rj = xj[..., 0], rj[..., 0]
    eng = _engine("hub-full")
    xt, rt = eng.solve(A, b, return_residuals=True)
    assert xt.shape == xj.shape and rt.shape == rj.shape
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-12 * np.linalg.norm(xj)
    np.testing.assert_allclose(rt.numpy(), rj, rtol=1e-12)
    # R of the augmented matrix is bit-equal; only the substitution differs.
    _bits_equal(Rj, eng(aug, compute_q=False)[1])


def test_engine_ragged_and_leading_batch_shapes():
    """Any batch works: a (3, 1) leading batch, and 3 matrices in blocks
    of 2 (the kernel's ragged edge; on the CPU the plain version)."""
    A, Qj, Rj = _jax_qr("ieee-rne", (5, 4), 1)
    Qt, Rt = _engine("ieee-rne")(A[:, None])
    assert Qt.shape == (3, 1, 5, 5) and Rt.shape == (3, 1, 5, 4)
    _bits_equal(Qj, Qt[:, 0])
    _bits_equal(Rj, Rt[:, 0])
    Qt, Rt = _engine("ieee-rne", tile_b=2)(A)
    _bits_equal(Qj, Qt)
    _bits_equal(Rj, Rt)


# ---------------------------------------------------------------------------
# the N / iters overrides
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jitted(cfg, method, N, iters):
    """A JAX unit method with its ``N``/``iters`` overrides bound, jitted
    (one compile per operand shape)."""
    return jax.jit(functools.partial(getattr(JUnit(cfg), method), N=N,
                                     iters=iters))


class _JitOverrideUnit(JUnit):
    """The JAX unit whose row rotations run its own code with the caller's
    overrides, jitted once per (overrides, row width)."""

    def rotate_rows(self, row_x, row_y, N=None, iters=None):
        return _jitted(self.cfg, "rotate_rows", N, iters)(row_x, row_y)

    def rotate_rows_complex(self, row_x, row_y, N=None, iters=None):
        return _jitted(self.cfg, "rotate_rows_complex", N, iters)(row_x,
                                                                  row_y)


#: The overrides of the sweep point held against the JAX package: a HUB
#: unit configured at N = 26 run at N = 28 with 22 micro-rotations.
OVERRIDE = dict(N=28, iters=22)
A_OVERRIDE = _matrices(21, (3, 4, 4))


def test_qr_cordic_overrides_bit_equal_to_jax():
    jc, tc = _configs("hub-full")
    Qj, Rj = jq.qr_cordic(A_OVERRIDE, _JitOverrideUnit(jc), **OVERRIDE)
    unit = GivensUnit(tc)
    Qt, Rt = tq.qr_cordic(torch.tensor(A_OVERRIDE), unit, **OVERRIDE)
    _bits_equal(Qj, Qt)
    _bits_equal(Rj, Rt)
    # overrides given as a numpy integer and a 0-d tensor, positionally
    Qp, Rp = tq.qr_cordic(A_OVERRIDE, unit, np.int64(28), torch.tensor(22))
    assert torch.equal(Qp, Qt) and torch.equal(Rp, Rt)
    Qd, _ = tq.qr_cordic(A_OVERRIDE, unit)   # the overrides change the words
    assert not torch.equal(Qd, Qt)


def test_qr_cordic_positional_none_returns_q():
    """`qr_cordic(A, unit, None, None)` binds N and iters, as the JAX
    package does, and returns Q."""
    jc, tc = _configs("hub-full")
    Qj, Rj = jq.qr_cordic(A_OVERRIDE, _JitOverrideUnit(jc), None, None)
    Qt, Rt = tq.qr_cordic(A_OVERRIDE, GivensUnit(tc), None, None)
    assert Qt is not None
    _bits_equal(Qj, Qt)
    _bits_equal(Rj, Rt)


def test_qr_cordic_complex_overrides_bit_equal_to_jax():
    jc, tc = _configs("hub-full")
    rng = np.random.default_rng(22)
    A = A_OVERRIDE + 1j * rng.normal(size=A_OVERRIDE.shape)
    Qj, Rj = jq.qr_cordic_complex(A, _JitOverrideUnit(jc), **OVERRIDE)
    Qt, Rt = tq.qr_cordic_complex(torch.tensor(A), GivensUnit(tc), **OVERRIDE)
    for want, got in ((Qj, Qt), (Rj, Rt)):
        _bits_equal(np.real(want), got.real)
        _bits_equal(np.imag(want), got.imag)
    Qp, _ = tq.qr_cordic_complex(A, GivensUnit(tc), None, None)
    assert Qp is not None and not torch.equal(Qp, Qt)


def test_unit_methods_take_overrides():
    """`vector`, `rotate` and `rotate_rows` with N and iters, against the
    JAX unit's own."""
    jc, tc = _configs("ieee-rne")
    unit = GivensUnit(tc)
    rows = unit.encode(torch.tensor(_matrices(24, (2, 16, 5))))
    x, y = rows[0], rows[1]
    jx, jy = (jax.numpy.asarray(r.numpy()) for r in (x, y))
    want = _jitted(jc, "vector", 28, 22)(jx[:, 0], jy[:, 0])
    r, y0, (flip, sig) = unit.vector(x[:, 0], y[:, 0], N=28, iters=22)
    for w, g in zip((want[0], want[1], *want[2]), (r, y0, flip, sig)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    st = (flip[:, None], sig[:, None])
    want = _jitted(jc, "rotate", 28, 22)(jx[:, 1:], jy[:, 1:],
                                         (want[2][0][:, None],
                                          want[2][1][:, None]))
    for w, g in zip(want, unit.rotate(x[:, 1:], y[:, 1:], st, 28, 22)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    want = _jitted(jc, "rotate_rows", 28, 22)(jx, jy)
    for w, g in zip(want, unit.rotate_rows(x, y, N=28, iters=22)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("hub", [False, True], ids=["conv", "hub"])
def test_cordic_gain_and_vectoring_rotation_equal_jax(hub):
    for k in (0, 1, 22, 24, 48):
        assert tcordic.cordic_gain(k) == jcordic.cordic_gain(k)
    rng = np.random.default_rng(25 + hub)
    lim = 2 ** 27
    xl, yl = (rng.integers(-lim, lim, size=6) for _ in range(2))
    xr, yr = (rng.integers(-lim, lim, size=(6, 4)) for _ in range(2))
    xl[0], yl[0] = -lim, 5                      # a flip
    want = jcordic.vectoring_rotation(xl, yl, xr, yr, 24, 28, hub)
    got = tcordic.vectoring_rotation(*(torch.tensor(v) for v in
                                       (xl, yl, xr, yr)), 24, 28, hub)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
