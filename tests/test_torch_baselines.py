"""The port's baselines and HUB primitive against the JAX package, on the
CPU: `qr_fixed` and `hub_quantize` to the bit, `snr_db` within 1e-9 dB,
`qr_givens_float` and `qr_jnp` within 1e-12 max|A| (float64, complex128)
and 1e-5 max|A| (float32, complex64), and the engine's six built-in
backends, its default configuration (the regression test for the default
`QRDEngine()` that once raised) and the configurations of the three
baselines carried over as JSON.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.qrd as japi
from repro.core import qrd as jq
from repro.core.hub import hub_error_bound as j_bound
from repro.core.hub import hub_quantize as j_hub

import repro_torch.qrd as tapi
from repro_torch.core import QRDEngine as TLegacy
from repro_torch.core import hub_error_bound, hub_quantize
from repro_torch.core import qrd as tq

#: Tolerances of the float baselines against the JAX package, relative to
#: max|A|: a few units in the last place of the working precision (the two
#: packages round the same operations, but XLA may fuse multiply-adds and
#: the two LAPACK builds order their sums differently).
TOL = {"float64": 1e-12, "complex128": 1e-12, "float32": 1e-5,
       "complex64": 1e-5}


def operand(dtype, shape=(2, 3, 2), seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=shape) * 3.0
    if dtype.startswith("complex"):
        A = A + 1j * rng.normal(size=shape)
    return A


def close(got, want, A, tol):
    want = np.asarray(want)
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    err = np.max(np.abs(got.numpy() - want)) / np.max(np.abs(A))
    assert err <= tol, err


def bits(got, want):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    assert got.numpy().tobytes() == want.tobytes()


#: (width, iters, scale_exp) of the 'fixed' baseline beyond its defaults.
FIXED = (24, 20, 1)
FIXED_CASES = ((32, 27, 0, True), FIXED + (False,))
FLOAT_DTYPES = ("float64", "float32", "float16", "complex128", "complex64")


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's results on the operands below.  `qr_givens_float`
    and `qr_fixed` are traced and compiled together in one `jax.jit`: one
    compilation costs a fraction of their eager op-by-op compiles (about
    1 s per dtype here), and jitted `qr_fixed` gives the same words as
    eagerly (its constants are XLA's either way).  `qr_jnp`, one LAPACK
    call, runs eagerly."""
    def loops(args):
        out = {("givens_float", d): jq.qr_givens_float(args[d],
                                                       dtype=jnp.dtype(d))
               for d in FLOAT_DTYPES}
        for case in FIXED_CASES:
            out["fixed", case] = jq.qr_fixed(args["float64"], *case[:3],
                                             compute_q=case[3])
        return out
    args = {d: operand(d) for d in FLOAT_DTYPES}
    refs = jax.jit(loops)(args)
    refs.update({("jnp", d): jq.qr_jnp(args[d], dtype=jnp.dtype(d))
                 for d in TOL})
    return jax.tree.map(lambda v: None if v is None else np.asarray(v),
                        refs, is_leaf=lambda v: v is None)


@pytest.mark.parametrize("case", FIXED_CASES)
def test_qr_fixed_bit_equal_to_jax(jax_refs, case):
    width, iters, scale_exp, compute_q = case
    jQ, jR = jax_refs["fixed", case]
    tQ, tR = tq.qr_fixed(operand("float64"), width, iters, scale_exp,
                         compute_q=compute_q)
    bits(tR, jR)
    if compute_q:
        bits(tQ, jQ)
    else:
        assert tQ is None and jQ is None


def test_hub_quantize_bit_equal_to_jax():
    fi = np.finfo(np.float64)
    ends = np.array([fi.max, -fi.max, fi.tiny, -fi.tiny, 5e-324, -5e-324,
                     1e-310, 0.0, -0.0, np.inf, -np.inf, 2.0 ** 1023, 1.0,
                     -1.2345678, 1.5 * fi.tiny])
    rng = np.random.default_rng(0)
    spread = rng.normal(size=400) * np.exp2(rng.integers(-1074, 1024, 400)
                                            .astype(np.float64))
    x = np.concatenate([ends, spread])
    # the output keeps the operand's type; XLA flushes subnormal float32
    # results to a signed zero (the float32 operand has x's length, so the
    # JAX reference reuses the float64 ops it compiled for x)
    x32 = np.concatenate([[1e-40, -1e-40, 1e-45, 3e-5, 0.1, 3e38, 0.0],
                          np.clip(x[:-7], -3e38, 3e38)]).astype(np.float32)
    cases = [(x, m) for m in (0, 10, 52, 60)] + [(x32, 10)]
    for v, m in cases:              # eagerly, as a caller runs it
        want = j_hub(v, m)
        bits(hub_quantize(v, m), want)
        bits(hub_quantize(torch.tensor(v), m), want)
    out = hub_quantize(1.2345678, 10)
    assert out.dtype == torch.float64 and float(out) == float(j_hub(1.2345678, 10))
    assert hub_quantize(3, 1).dtype == torch.int64 == torch.as_tensor(3).dtype
    assert hub_error_bound(10) == j_bound(10)


def test_snr_db_agrees_with_jax():
    A = operand("float32", (6, 4, 4), seed=2)
    Q, R = (v.numpy() for v in tq.qr_givens_float(A, torch.float32))
    want = np.asarray(jq.snr_db(A, Q, R))
    got = tq.snr_db(A, Q, R)
    assert got.dtype == torch.float64 and got.shape == (6,)
    assert np.max(np.abs(got.numpy() - want)) <= 1e-9


@pytest.mark.parametrize("dtype", list(TOL))
def test_qr_givens_float_within_tolerance_of_jax(jax_refs, dtype):
    A = operand(dtype)
    jQ, jR = jax_refs["givens_float", dtype]
    tQ, tR = tq.qr_givens_float(A, dtype=dtype)
    close(tQ, jQ, A, TOL[dtype])
    close(tR, jR, A, TOL[dtype])
    assert tq.qr_givens_float(A, dtype=dtype, compute_q=False)[0] is None


def test_qr_givens_float_float16_as_jax(jax_refs):
    """float16 runs in float16 in both packages (no tolerance is documented
    for it; the factors agree to float16's own unit roundoff)."""
    A = operand("float16")
    jQ, jR = jax_refs["givens_float", "float16"]
    tQ, tR = tq.qr_givens_float(A, dtype="float16")
    assert tR.dtype == torch.float16
    close(tQ.to(torch.float32), jQ.astype(np.float32), A, 2.0 ** -10)
    close(tR.to(torch.float32), jR.astype(np.float32), A, 2.0 ** -10)


def _sign_normalized(Q, R):
    """(Q D, D R) with D = diag(sign(R_ii)) (1 where R_ii is 0), so R's
    diagonal is >= 0: LAPACK builds may differ in the reflectors' signs."""
    d = np.sign(np.real(np.diagonal(R, axis1=-2, axis2=-1)))
    d = np.where(d == 0, 1, d)
    k = d.shape[-1]
    Qn, Rn = Q.copy(), R.copy()
    Qn[..., :k] = Q[..., :k] * d[..., None, :]
    Rn[..., :k, :] = R[..., :k, :] * d[..., :, None]
    return Qn, Rn


@pytest.mark.parametrize("dtype", list(TOL))
def test_qr_jnp_within_tolerance_of_jax(jax_refs, dtype):
    A = operand(dtype)
    jQ, jR = jax_refs["jnp", dtype]
    tQ, tR = tq.qr_jnp(A, dtype=dtype)
    assert tQ.shape == jQ.shape == (2, 3, 3) and tR.shape == jR.shape
    jQ, jR = _sign_normalized(jQ, jR)
    tQ, tR = (torch.tensor(v) for v in _sign_normalized(tQ.numpy(),
                                                        tR.numpy()))
    close(tQ, jQ, A, TOL[dtype])
    close(tR, jR, A, TOL[dtype])
    assert tq.qr_jnp(A, dtype=dtype, compute_q=False)[0] is None


def test_qr_jnp_float16_raises_as_jax():
    A = operand("float16")
    with pytest.raises(NotImplementedError):
        jq.qr_jnp(A, dtype=jnp.float16)
    with pytest.raises(NotImplementedError, match="float16"):
        tq.qr_jnp(A, dtype=torch.float16)


def test_default_engine_factorizes():
    """`QRDEngine()` defaults to the 'jnp' backend, which the port once did
    not register: the default engine raised ValueError."""
    A = operand("float32", (4, 4, 4)).astype(np.float32)
    Q, R = tapi.QRDEngine(device="cpu")(A)
    jQ, jR = japi.QRDEngine()(A)
    assert Q.dtype == torch.float32 and Q.shape == (4, 4, 4)
    for got, want in zip(_sign_normalized(Q.numpy(), R.numpy()),
                         _sign_normalized(np.asarray(jQ), np.asarray(jR))):
        close(torch.tensor(got), want, A, TOL["float32"])


def test_available_backends_equal_jax():
    assert tapi.available_backends() == japi.available_backends()
    for name in japi.available_backends():
        jc = japi.get_backend(name).capabilities
        tc = tapi.get_backend(name).capabilities
        assert (tc.dtypes, tc.schedules, tc.bit_exact, tc.description) == \
               (jc.dtypes, jc.schedules, jc.bit_exact, jc.description)


@pytest.mark.parametrize("backend", ["jnp", "givens_float", "fixed"])
def test_config_json_round_trip(backend):
    """A JAX configuration of each baseline loads in the port and builds
    the engine that runs the same function (each function is held to the
    JAX package's by the tests above)."""
    width, iters, scale_exp = FIXED
    jcfg = japi.QRDConfig(backend=backend, dtype="float64", fixed_width=width,
                          fixed_iters=iters, fixed_scale_exp=scale_exp)
    tcfg = tapi.QRDConfig.from_json(jcfg.to_json())
    assert tcfg.to_json() == jcfg.to_json()
    assert japi.QRDConfig.from_json(tcfg.to_json()) == jcfg
    A = operand("float64", (2, 4, 3), seed=5)
    got = tapi.QRDEngine(tcfg, device="cpu")(A)
    want = {"jnp": lambda: tq.qr_jnp(A, "float64"),
            "givens_float": lambda: tq.qr_givens_float(A, "float64"),
            "fixed": lambda: tq.qr_fixed(A, *FIXED)}[backend]()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("backend", ["jnp", "givens_float"])
def test_engine_casts_operands_as_jax(backend):
    """The float backends compute in the config's dtype (float32 by
    default, also for a float64 operand); complex operands switch to the
    matching complex dtype; integer operands are promoted to float64 first
    and then cast to the config's dtype."""
    jeng = japi.QRDEngine(backend=backend)
    teng = tapi.QRDEngine(backend=backend, device="cpu")
    for A in (operand("float64"), operand("complex64").astype(np.complex64),
              operand("complex128"), np.arange(12).reshape(1, 4, 3)):
        _, jcfg = jeng._validate_operand(A, jeng.config)
        _, tR = teng(A)
        assert str(tR.dtype).removeprefix("torch.") == jcfg.dtype


def test_legacy_facade_and_solve():
    A = operand("float64", (5, 6, 3), seed=7)
    b = np.random.default_rng(8).normal(size=(5, 6))
    eng = TLegacy(backend="fixed", device="cpu")
    assert torch.equal(eng(A)[1], tq.qr_fixed(A)[1])
    x = eng.solve(A, b)
    ref = np.stack([np.linalg.lstsq(A[i], b[i], rcond=None)[0]
                    for i in range(5)])
    assert len(eng._fn_cache) == 2
    eng.backend = "givens_float"             # a changed field takes effect
    assert eng(A)[1].dtype == torch.float32 and len(eng._fn_cache) == 3
    for name, got in (("fixed", x),
                      ("jnp", tapi.QRDEngine(device="cpu").solve(A, b)),
                      ("givens_float", eng.solve(A, b))):
        rel = (np.linalg.norm(got.numpy() - ref, axis=-1)
               / np.linalg.norm(ref, axis=-1))
        assert rel.max() <= tapi.SOLVE_TOLERANCES[name], name
    assert TLegacy(device="cpu").rls(3).mode == "float"
