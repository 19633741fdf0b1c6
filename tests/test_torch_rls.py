"""The port's streaming QRD-RLS (`repro_torch.qrd.RLSState`, real dtypes)
against the JAX package's `repro.qrd.RLSState` on the CPU.

* float mode: the same float64 Givens recursion, R and z within 1e-12;
* unit mode: the bit-accurate unit (`GivensUnit.annihilate`), R and z bit
  for bit;
* block mode: snapshots annihilated ``block`` at a time by the block-FP
  kernel's plain version on `ops.rls_block_steps`, R and z bit for bit,
  the weights within 1e-12 (the triangular solves sum in their own order);
* a state driven half way by the JAX package, handed over through
  ``to_arrays``/``from_arrays`` and finished by both, and the reverse;
* `QRDEngine.rls` routing, validation and the block path's accuracy
  against float mode.

Snapshots are made with numpy from a seed.  The JAX unit and block paths
compile once each (n = 2, block = 2).
"""
import numpy as np
import pytest
import torch

from repro import qrd as japi
from repro.core import GivensConfig as JConfig
from repro.core import GivensUnit as JUnit

from repro_torch import qrd as tapi
from repro_torch.core.givens import GivensConfig, GivensUnit
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qrd_blocked as tqb


def _snapshots(n, T, seed=5, noise=0.01):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=n)
    xs = rng.normal(size=(T, n))
    ds = xs @ w_true + noise * rng.normal(size=T)
    return w_true, xs, ds


def _drive(state, xs, ds):
    for x, d in zip(xs, ds):
        state.update(x, d)
    return state


def _bits_equal(want, got):
    want = np.ascontiguousarray(np.asarray(want))
    got = np.ascontiguousarray(got.cpu().numpy())
    assert want.shape == got.shape
    np.testing.assert_array_equal(want.view(np.int64), got.view(np.int64))


def test_float_mode_equals_jax():
    _, xs, ds = _snapshots(4, 30)
    js = _drive(japi.RLSState(4, lam=0.98, mode="float"), xs, ds)
    ts = _drive(tapi.RLSState(4, lam=0.98, mode="float", device="cpu"),
                xs, ds)
    np.testing.assert_allclose(ts.R.numpy(), js.R, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(ts.z.numpy(), js.z, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(ts.weights().numpy(), js.weights(),
                               rtol=1e-10, atol=1e-12)
    assert ts.updates == js.updates == 30
    assert ts.predict(xs[0]) == pytest.approx(js.predict(xs[0]), rel=1e-10)


def test_unit_mode_bit_equal_to_jax():
    _, xs, ds = _snapshots(2, 5, seed=6)
    js = _drive(japi.RLSState(2, lam=0.99, mode="unit",
                              unit=JUnit(JConfig(hub=True, n=26))), xs, ds)
    ts = _drive(tapi.RLSState(2, lam=0.99, mode="unit",
                              unit=GivensUnit(GivensConfig(hub=True, n=26)),
                              device="cpu"),
                xs, ds)
    _bits_equal(js.R, ts.R)
    _bits_equal(js.z, ts.z)


def test_annihilate_zeroes_the_pivot_column():
    unit = GivensUnit(GivensConfig(hub=True, n=26))
    rng = np.random.default_rng(7)
    rows = unit.encode(torch.tensor(rng.normal(size=(2, 3, 5))))
    for col in range(5):
        rx, ry = unit.annihilate(rows[0], rows[1], col)
        assert rx.shape == ry.shape == (3, 5)
        assert not ry[:, col].any()
        # the pivot column is rolled to the front and back again
        want_x, _ = unit.rotate_rows(torch.roll(rows[0], -col, -1),
                                     torch.roll(rows[1], -col, -1))
        assert torch.equal(rx, torch.roll(want_x, col, -1))


N_BLOCK, BLOCK = 2, 2


def _jax_block():
    return japi.RLSState(N_BLOCK, lam=0.99, mode="block", block=BLOCK,
                         hub=True, iters=24)


def _port_block(**kw):
    return tapi.RLSState(N_BLOCK, lam=0.99, mode="block", block=BLOCK,
                         hub=True, iters=24, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_block_states():
    """The JAX block-mode state after 4 snapshots (two flushes), and a
    second one exported after 3 (one flush, one pending) and after 5."""
    _, xs, ds = _snapshots(N_BLOCK, 6, seed=8)
    full = _drive(_jax_block(), xs[:4], ds[:4])
    half = _drive(_jax_block(), xs[:3], ds[:3])
    exported = half.to_arrays()
    _drive(half, xs[3:5], ds[3:5])
    return xs, ds, full, exported, half


def test_block_mode_bit_equal_to_jax(jax_block_states):
    xs, ds, full, _, _ = jax_block_states
    before = tqb.QR_BLOCKFP_LAUNCHES
    ts = _drive(_port_block(), xs[:4], ds[:4])
    assert tqb.QR_BLOCKFP_LAUNCHES == before        # plain version on CPU
    assert not ts._pending and ts.updates == 4
    _bits_equal(full.R, ts.R)
    _bits_equal(full.z, ts.z)
    np.testing.assert_allclose(ts.weights().numpy(), full.weights(),
                               rtol=0, atol=1e-12)


def test_state_handed_over_from_jax_and_back(jax_block_states):
    xs, ds, _, exported, finished = jax_block_states
    ts = _port_block().from_arrays(exported)
    assert len(ts._pending) == 1 and ts.updates == 3
    _drive(ts, xs[3:5], ds[3:5])
    _bits_equal(finished.R, ts.R)
    _bits_equal(finished.z, ts.z)
    assert ts.updates == finished.updates == 5
    # and back: the port's export loads into a JAX state
    back = _jax_block().from_arrays(
        {k: v.cpu().numpy() for k, v in ts.to_arrays().items()})
    _bits_equal(back.R, ts.R)
    assert back.updates == 5 and len(back._pending) == 1
    out = ts.to_arrays()
    jout = finished.to_arrays()
    assert set(out) == set(jout)
    for k in jout:
        assert tuple(out[k].shape) == np.shape(jout[k]), k
        np.testing.assert_array_equal(out[k].numpy(), jout[k], err_msg=k)


def test_block_mode_flush_runs_the_rls_schedule(monkeypatch):
    seen = []
    real = tqb.qr_blockfp_call

    def spy(X, **kw):
        seen.append((tuple(X.shape), kw["steps"], kw["iters"], kw["hub"]))
        return real(X, **kw)

    monkeypatch.setattr(tqb, "qr_blockfp_call", spy)
    _, xs, ds = _snapshots(3, 5, seed=9)
    st = tapi.RLSState(3, lam=0.97, mode="block", block=4, hub=False,
                       iters=23, device="cpu")
    _drive(st, xs, ds)
    assert seen == [((1, 7, 4), tops.rls_block_steps(3, 4), 23, False)]
    assert len(st._pending) == 1
    st.flush()
    assert seen[-1][:2] == ((1, 4, 4), tops.rls_block_steps(3, 1))
    assert not st._pending and st.flush() is st


def test_block_mode_matches_float_weights():
    n, T, block = 5, 60, 3
    w_true, xs, ds = _snapshots(n, T, seed=10)
    sb = _drive(tapi.RLSState(n, lam=0.99, mode="block", block=block,
                              device="cpu"), xs, ds)
    sf = _drive(tapi.RLSState(n, lam=0.99, mode="float", device="cpu"),
                xs, ds)
    assert not sb._pending
    # the block-FP datapath's noise only (F = 24 fraction bits)
    np.testing.assert_allclose(sb.weights().numpy(), sf.weights().numpy(),
                               atol=5e-3)
    assert np.linalg.norm(sb.weights().numpy() - w_true) < 0.05


def test_rls_state_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("float", "block"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapi.RLSState(3, mode=mode)
    assert tapi.RLSState(3, device="cpu").device.type == "cpu"


def test_engine_rls_routes_as_jax():
    eng = tapi.QRDEngine(backend="blockfp_pallas", device="cpu",
                         givens=GivensConfig(hub=False, n=26))
    st = eng.rls(3)
    assert (st.mode, st.block, st.device.type) == ("block", 4, "cpu")
    assert st._blockfp == dict(hub=False, iters=23, frac=24, tile_b=None)
    assert eng.rls(3, block=2).block == 2
    cordic = tapi.QRDEngine(backend="cordic_pallas", device="cpu")
    su = cordic.rls(3)
    assert su.mode == "unit" and su.unit.cfg == cordic.config.givens
    assert cordic.rls(3, block=5).mode == "block"
    assert (st.R == 1e-3 * torch.eye(3, dtype=torch.float64)).all()
    for lam in (0.0, -0.5, 1.5, float("nan"), 0.9 + 0.1j):
        with pytest.raises((ValueError, TypeError)):
            eng.rls(3, lam=lam)
    with pytest.raises(ValueError, match="mode"):
        tapi.RLSState(3, mode="quantum")
    with pytest.raises(ValueError, match="GivensUnit"):
        tapi.RLSState(3, mode="unit")
    with pytest.raises(NotImplementedError, match="A9"):
        tapi.RLSState(3, dtype="complex128")
    with pytest.raises(TypeError, match="complex"):
        st.update(np.ones(3) * 1j, 0.0)
    with pytest.raises(ValueError, match="snapshot length"):
        st.update(np.ones(4), 0.0)
    with pytest.raises(NotImplementedError, match="A11"):
        eng.fleet(2, 4)
    assert tapi.validate_lam(0.5) == np.float64(0.5)
