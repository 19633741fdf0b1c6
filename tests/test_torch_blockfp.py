"""The port's int32 block-FP lane against the JAX package on the CPU.

* The plain CORDIC step functions of `repro_torch.kernels.cordic_givens`
  (`fused_rotate_block`, `fused_rotate_ctrl`, `fused_replay`) give int32
  words bit-identical to the JAX package's, HUB and conventional, iters 24
  and 30, on random and edge significands.
* The plain versions of the three block-FP kernels (`qr_blockfp_call`,
  `panel_factor_blockfp_call`, `panel_apply_blockfp_call` on CPU tensors)
  give the words of the JAX kernels: the flat kernel's body run eagerly,
  the panel kernels in interpret mode.
* Encode and decode give the JAX package's significands, exponents and
  floats bit for bit.  Its scales are ``jnp.exp2`` of integer exponents,
  which XLA computes as ``exp(x * ln 2)`` and which are not exact powers
  of two; the port's table of them equals ``jnp.exp2`` over its range.
* `QRDEngine(backend='blockfp_pallas', device='cpu')` on the flat, panel
  and TSQR routes and through `solve`, against `repro.qrd.QRDEngine`: Q
  and R bit for bit (TSQR's Q within 1e-12).
* One m = 128 headroom case: every entry of column 0 at +amax.

Inputs are made with numpy from a seed.  Each JAX computation runs once,
in a module-scoped fixture, eagerly or through one small compile.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import qrd as japi
from repro.core import qrd as jq
from repro.kernels import cordic_givens as jcg
from repro.kernels import ops as jops
from repro.kernels import qrd_blocked as jqb

from repro_torch import qrd as tapi
from repro_torch.core import qrd as tq
from repro_torch.core.givens import GivensConfig
from repro_torch.kernels import cordic_givens as tcg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qrd_blocked as tqb
from repro_torch.qrd import tiled as ttiled

FRAC = 24
M, N = 4, 2                        # the flat kernel's shape, with Q: e = 6
PM, PN, PW = 12, 4, 8              # a panel of 12 x 4, trailing 12 x 8
A_ENGINE = np.random.default_rng(21).standard_normal((2, 10, 6))
A_TSQR = np.random.default_rng(22).standard_normal((2, 20, 4))
B_TSQR = np.random.default_rng(23).standard_normal((2, 20))
TILE_M = 12



def _bits_equal(want, got):
    """float64 arrays equal bit for bit, signs of zeros included."""
    want = np.ascontiguousarray(np.asarray(want))
    got = np.ascontiguousarray(got.numpy())
    assert want.shape == got.shape
    np.testing.assert_array_equal(want.view(np.int64), got.view(np.int64))


class _Ref:
    """A stand-in for a Pallas ref, so a JAX kernel body runs eagerly."""

    def __init__(self, v=None):
        self.v = v

    def __getitem__(self, idx):
        return self.v

    def __setitem__(self, idx, v):
        self.v = v


def _edge_rows(rng, B, L):
    """(B, L) int32 significand rows: random in [-2^24, 2^24], then edge
    rows — ±2^24, zeros, a negative lead (flip), a zero lead over a
    non-zero one, the lead pair at +2^24."""
    x = rng.integers(-2 ** 24, 2 ** 24 + 1, size=(B, L))
    y = rng.integers(-2 ** 24, 2 ** 24 + 1, size=(B, L))
    x[0], y[0] = 2 ** 24, -2 ** 24
    x[1], y[1] = 0, 0
    x[2, 0], y[2, 0] = -5, 2 ** 24
    x[3, 0], y[3, 0] = 0, -7
    x[4, :], y[4, :] = 2 ** 24, 2 ** 24
    return x.astype(np.int32), y.astype(np.int32)


def _edge_words(rng, B, m, e):
    """(B, m, e) int32 working tiles: random significands, an all-zero
    column, a column at +2^24 in every row, and ±2^24 corners."""
    X = rng.integers(-2 ** 24, 2 ** 24 + 1, size=(B, m, e))
    X[:, :, 1] = 0
    X[:, :, 0] = 2 ** 24
    X[:, -1, -1] = -2 ** 24
    return X.astype(np.int32)


# ---------------------------------------------------------------------------
# the CORDIC step functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("iters", [24, 30])
@pytest.mark.parametrize("hub", [False, True], ids=["conv", "hub"])
def test_step_functions_bit_equal_to_jax(hub, iters):
    rng = np.random.default_rng(iters + hub)
    x, y = _edge_rows(rng, 8, 7)
    comp = tcg.comp_q30(iters)
    assert comp == jcg.comp_q30(iters)
    kw = dict(iters=iters, hub=hub, comp=comp)
    tx, ty = torch.tensor(x), torch.tensor(y)

    want = jcg.fused_rotate_block(jnp.asarray(x), jnp.asarray(y), **kw)
    got = tcg.fused_rotate_block(tx, ty, **kw)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())

    lead = np.zeros((1, 7), bool)
    lead[0, 2] = True
    want = jcg.fused_rotate_ctrl(jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(lead), **kw)
    got = tcg.fused_rotate_ctrl(tx, ty, torch.tensor(lead), **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())

    flip = (rng.integers(0, 2, size=8)).astype(np.int32)
    sig = rng.integers(0, 2 ** iters, size=8).astype(np.int32)
    want = jcg.fused_replay(jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(flip), jnp.asarray(sig), **kw)
    got = tcg.fused_replay(tx, ty, torch.tensor(flip), torch.tensor(sig), **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_arithmetic_shift_and_wrap_of_negative_int32():
    v = torch.tensor([-1, -2 ** 31, -12345, 2 ** 31 - 1], dtype=torch.int32)
    for s in (1, 15, 29, 30):
        np.testing.assert_array_equal((v >> s).numpy(),
                                      np.asarray(jnp.asarray(v.numpy()) >> s))
    # int32 products and sums wrap as XLA's do (the CUDA code does the same
    # arithmetic in uint32)
    big = torch.tensor([2 ** 30, -2 ** 30, 2 ** 31 - 1], dtype=torch.int32)
    np.testing.assert_array_equal(
        (big * 3 + big).numpy(),
        np.asarray(jnp.asarray(big.numpy()) * 3 + jnp.asarray(big.numpy())))
    got = tcg._gain_mul_q30(big, tcg.comp_q30(24))
    want = jcg._gain_mul_q30(jnp.asarray(big.numpy()), jcg.comp_q30(24))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_iters_beyond_the_int32_datapath_raise():
    X = torch.zeros((1, 3, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 30"):
        tqb.qr_blockfp_call(X, iters=31, hub=True, steps=((0, 1, 0),))
    with pytest.raises(ValueError, match="at most 30"):
        tcg.fused_replay(X[0], X[0], X[0, 0], X[0, 0], iters=31, hub=True,
                         comp=0)


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------
def _flat_case():
    """A ragged batch of 5 tiles of M x (N + M), two random and three edge
    tiles, on the column-major schedule.  (The RLS block schedule is held
    to the JAX package's kernel in tests/test_torch_rls.py.)"""
    rng = np.random.default_rng(11)
    e = N + M
    rand = rng.integers(-2 ** 24, 2 ** 24 + 1, size=(2, M, e)).astype(np.int32)
    return (np.concatenate([rand, _edge_words(rng, 3, M, e)]),
            jq.givens_schedule(M, N))


@pytest.fixture(scope="module")
def jax_flat_words():
    """The JAX flat kernel's body (`_qr_blockfp_kernel`), run eagerly, HUB
    and conventional, iters 24."""
    X, steps = _flat_case()
    out = {}
    for hub in (False, True):
        o = _Ref()
        jqb._qr_blockfp_kernel(_Ref(jnp.asarray(X)), o, iters=24, hub=hub,
                               comp=jcg.comp_q30(24), steps=steps)
        out[hub] = np.asarray(o.v)
    return out


@pytest.mark.parametrize("hub", [False, True], ids=["conv", "hub"])
def test_qr_blockfp_plain_version_bit_equal_to_jax(jax_flat_words, hub):
    X, steps = _flat_case()
    before = tqb.QR_BLOCKFP_LAUNCHES
    got = tqb.qr_blockfp_call(torch.tensor(X), iters=24, hub=hub, steps=steps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(jax_flat_words[hub], got.numpy())
    # the plain version runs on CPU tensors: no launch is counted
    assert tqb.QR_BLOCKFP_LAUNCHES == before


@pytest.fixture(scope="module")
def jax_panel_words():
    """JAX's block-FP panel factor on a 12 x 4 panel and its apply on the
    12 x 8 trailing columns (one chunk), interpret mode, HUB.  (The
    conventional datapath's panel kernels are held to the JAX package's
    through the TSQR engine test.)"""
    rng = np.random.default_rng(12)
    X = rng.integers(-2 ** 24, 2 ** 24 + 1,
                     size=(3, PM, PN + PW)).astype(np.int32)
    X[1, :, 0] = 2 ** 24                             # every entry at +amax
    X[2, :, 1] = 0                                   # an all-zero column
    piv, tgt, col = jops.panel_steps(PM, PN)

    def both(X):                  # one compile for the two interpret calls
        f = jqb.panel_factor_blockfp_call(X[:, :, :PN], piv, tgt, col,
                                          iters=24, hub=True, interpret=True)
        T = jqb.panel_apply_blockfp_call(X[:, None, :, PN:], piv, tgt, f[1],
                                         f[2], iters=24, hub=True,
                                         interpret=True)
        return f + (T[:, 0],)

    return X, tuple(np.asarray(a) for a in jax.jit(both)(jnp.asarray(X)))


def test_panel_kernels_plain_versions_bit_equal_to_jax(jax_panel_words):
    X, (fac, flip, sig, T) = jax_panel_words
    hub = True
    piv, tgt, col = tops.panel_steps(PM, PN)
    W = torch.tensor(X)
    before = (tqb.PANEL_FACTOR_BLOCKFP_LAUNCHES,
              tqb.PANEL_APPLY_BLOCKFP_LAUNCHES)
    tile, tflip, tsig = tqb.panel_factor_blockfp_call(W[:, :, :PN], piv, tgt,
                                                      col, iters=24, hub=hub)
    assert tflip.dtype == tsig.dtype == torch.int32
    assert tflip.shape == (3, len(piv))
    np.testing.assert_array_equal(fac, tile.numpy())
    np.testing.assert_array_equal(flip, tflip.numpy())
    np.testing.assert_array_equal(sig, tsig.numpy())
    assert torch.equal(W[:, :, :PN], tile)           # in place on the view
    tqb.panel_apply_blockfp_call(W[:, :, PN:], piv, tgt, tflip, tsig,
                                 iters=24, hub=hub)
    np.testing.assert_array_equal(T, W[:, :, PN:].numpy())
    assert (tqb.PANEL_FACTOR_BLOCKFP_LAUNCHES,
            tqb.PANEL_APPLY_BLOCKFP_LAUNCHES) == before
    # panel by panel the words equal the flat kernel's
    flat = tqb.qr_blockfp_reference(torch.tensor(X), iters=24, hub=hub,
                                    steps=tq.givens_schedule(PM, PN))
    assert torch.equal(W, flat)


# ---------------------------------------------------------------------------
# encode and decode
# ---------------------------------------------------------------------------
def test_scale_table_equals_jax_exp2():
    k = np.arange(-tops._SCALE_K, tops._SCALE_K + 1)
    want = np.asarray(jnp.exp2(jnp.asarray(k, jnp.float64)))
    _bits_equal(want, torch.tensor(tops._scale_table()))
    # not exact powers of two: the reason the port carries the table
    small = np.abs(k) < 60
    assert np.any(want[small] != np.ldexp(1.0, k[small]))


def test_encode_and_decode_bit_equal_to_jax():
    rng = np.random.default_rng(13)
    W = rng.standard_normal((3, 7, 6))
    W[0, :, 1] = 0.0                                 # an all-zero column
    W[1] *= np.exp2(rng.integers(-300, 300, size=(1, 6)))
    W[2, :, 2] = 0.75                                # every entry at amax
    W[2, 3, 3] = -2.0 ** 40
    Xj, exj = jops._blockfp_encode(jnp.asarray(W), FRAC)
    Xt, ext = tops._blockfp_encode(torch.tensor(W), FRAC)
    assert Xt.dtype == torch.int32 and ext.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(Xj), Xt.numpy())
    np.testing.assert_array_equal(np.asarray(exj), ext.numpy())
    assert ext[0, 0, 1] == 0 and not Xt[0, :, 1].any()
    assert int(Xt.abs().max()) <= 2 ** FRAC
    dt = tops._blockfp_decode(Xt, ext, FRAC)
    _bits_equal(jops._blockfp_decode(Xj, exj, FRAC), dt)
    # round trip within half a unit of the column's last significand bit
    assert np.all(np.abs(dt.numpy() - W)
                  <= np.ldexp(0.5001, ext.numpy() - FRAC))


def _engine(**kw):
    kw = dict(dict(hub=True, iters=24), **kw)
    return tapi.QRDEngine(backend="blockfp_pallas", dtype="float64",
                          device="cpu", **kw)


def _jax_engine(**kw):
    kw = dict(dict(hub=True, iters=24), **kw)
    return japi.QRDEngine(japi.QRDConfig(backend="blockfp_pallas",
                                         dtype="float64", **kw))


def test_engine_panel_route_equals_flat_route():
    Qf, Rf = _engine(tiling="flat")(A_ENGINE)
    Qp, Rp = _engine(tiling="panel", panel_n=4)(A_ENGINE)
    assert torch.equal(Qf, Qp) and torch.equal(Rf, Rp)
    _, R_only = _engine(tiling="panel", panel_n=3)(A_ENGINE, compute_q=False)
    assert torch.equal(R_only, Rf)
    assert _engine()(A_ENGINE)[1].shape == Rf.shape      # auto: flat
    # the JAX package's own accuracy limits (tests/test_qrd_blocked.py)
    m = A_ENGINE.shape[-2]
    QR = (Qf @ Rf).numpy()
    snr = 10 * np.log10(np.sum(A_ENGINE ** 2, axis=(-2, -1))
                        / np.sum((A_ENGINE - QR) ** 2, axis=(-2, -1)))
    assert snr.mean() > 90
    QtQ = np.swapaxes(Qf.numpy(), -1, -2) @ Qf.numpy()
    assert np.abs(QtQ - np.eye(m)).max() < 1e-4


@pytest.fixture(scope="module")
def jax_engine_tsqr():
    """`repro.qrd.QRDEngine(backend='blockfp_pallas', tiling='tsqr',
    tile_m=12)` at 20 x 4 with Q (two leaves, the second padded with zero
    rows), conventional arithmetic, and its solve."""
    eng = _jax_engine(tiling="tsqr", tile_m=TILE_M, hub=False)
    Q, R = eng(A_TSQR)
    x = eng.solve(A_TSQR, B_TSQR)
    return np.asarray(Q), np.asarray(R), np.asarray(x)


def test_engine_tsqr_and_solve_bit_equal_to_jax(jax_engine_tsqr):
    Qj, Rj, xj = jax_engine_tsqr
    eng = _engine(tiling="tsqr", tile_m=TILE_M, hub=False)
    Qt, Rt = eng(A_TSQR)
    assert Qt.shape == A_TSQR.shape and Rt.shape == (2, 4, 4)
    _bits_equal(Rj, Rt)
    np.testing.assert_allclose(Qt.numpy(), Qj, rtol=0, atol=1e-12)

    def node_qr(X):
        return tq.qr_blockfp_pallas(X, iters=24, hub=False)

    for i in range(2):
        Qr, Rr = ttiled.tsqr_host_reference(torch.tensor(A_TSQR[i]), node_qr,
                                            TILE_M)
        assert torch.equal(Rr, Rt[i])
        np.testing.assert_allclose(Qt[i].numpy(), Qr.numpy(), rtol=0,
                                   atol=1e-12)
    xt = eng.solve(A_TSQR, B_TSQR)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-12)
    ref = np.linalg.lstsq(A_TSQR[0], B_TSQR[0], rcond=None)[0]
    assert np.abs(xt[0].numpy() - ref).max() <= 1e-4


def test_flat_solve_within_tolerance():
    rng = np.random.default_rng(24)
    A, b = rng.standard_normal((3, 8, 4)), rng.standard_normal((3, 8))
    x = _engine().solve(A, b)
    ref = np.stack([np.linalg.lstsq(A[i], b[i], rcond=None)[0]
                    for i in range(3)])
    err = np.linalg.norm(x.numpy() - ref, axis=-1) / np.linalg.norm(ref,
                                                                    axis=-1)
    assert err.max() <= tapi.SOLVE_TOLERANCES["blockfp_pallas"]


def test_backend_capabilities_and_schedules_equal_jax():
    jc = japi.get_backend("blockfp_pallas").capabilities
    tc = tapi.get_backend("blockfp_pallas").capabilities
    for field in ("bit_exact", "wavefront", "sharding", "max_shape",
                  "supports_tiling", "dtypes", "schedules"):
        assert getattr(tc, field) == getattr(jc, field), field
    cfg = tapi.QRDConfig(backend="blockfp_pallas",
                         givens=GivensConfig(hub=False, n=26))
    jcfg = japi.QRDConfig.from_json(cfg.to_json())
    assert cfg.blockfp_iters() == jcfg.blockfp_iters() == 23
    assert cfg.blockfp_hub() is jcfg.blockfp_hub() is False
    over = cfg.replace(iters=30, hub=True)
    assert (over.blockfp_iters(), over.blockfp_hub()) == (30, True)
    for s1, s2 in ((3, 2), (4, 1)):
        assert tops.rls_block_steps(s1, s2) == jops.rls_block_steps(s1, s2)
    # the wavefront schedule is ported (ROADMAP A8, kernel B5b): the JAX
    # package's Q and R, from its encode, wavefront kernel body (jitted
    # outside Pallas), decode and split
    eye = np.eye(4)[None]
    X, ex = jops._blockfp_encode(jq._augment(jnp.asarray(eye), True), 24)
    tables = jops._stage_tables(jq.sameh_kuck_schedule(4, 4), 4)

    def body(X, piv, tgt, col):
        out = _Ref()
        jqb._qr_blockfp_wavefront_kernel(
            _Ref(piv), _Ref(tgt), _Ref(col), _Ref(X), out, iters=24, hub=True,
            comp=jcg.comp_q30(24), S=piv.shape[0], table_layout="split")
        return out.v
    words = jax.jit(body)(X, *(jnp.asarray(t) for t in tables))
    want = jq._split_qr(jops._blockfp_decode(words, ex, 24), 4, 4, True)
    for w, g in zip(want, _engine(schedule="sameh_kuck")(eye)):
        _bits_equal(w, g)


# ---------------------------------------------------------------------------
# int32 headroom at m = 128
# ---------------------------------------------------------------------------
HEAD_M, HEAD_N = 128, 4


@pytest.fixture(scope="module")
def headroom():
    """(128, 4) with Q, every entry of column 0 at the same +amax, just
    below 2: each encodes to 2^24, the largest column norm the encode
    allows (sqrt(128) * 2^24 before the CORDIC gain).  The JAX engine's
    panel route, which the JAX package holds bit-equal to its flat route."""
    rng = np.random.default_rng(25)
    A = rng.standard_normal((1, HEAD_M, HEAD_N))
    A[..., 0] = np.nextafter(2.0, 0.0)
    Q, R = _jax_engine(tiling="panel", panel_n=8)(A)
    return A, np.asarray(Q), np.asarray(R)


def test_engine_flat_bit_equal_to_jax_engine_at_m128_without_wrap(headroom):
    A, Qj, Rj = headroom
    Qt, Rt = _engine(tiling="flat")(A)
    _bits_equal(Qj, Qt)
    _bits_equal(Rj, Rt)
    # the same plain arithmetic on int64 operands never wraps: equal words
    # mean no intermediate of this worst-case column left int32
    X, ex = tops._blockfp_encode(tq._augment(torch.tensor(A), True), FRAC)
    assert int(X[0, :, 0].min()) == int(X[0, :, 0].max()) == 2 ** FRAC
    wide = tqb.qr_blockfp_reference(X.to(torch.int64), iters=24, hub=True,
                                    steps=tq.givens_schedule(HEAD_M, HEAD_N))
    assert int(wide.abs().max()) < 2 ** 29
    out = tops._blockfp_decode(wide.to(torch.int32), ex, FRAC)
    Q, R = tq._split_qr(out, HEAD_M, HEAD_N, True)
    assert torch.equal(Q, Qt) and torch.equal(R, Rt)
