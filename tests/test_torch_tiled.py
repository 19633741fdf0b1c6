"""The port's tiled routes (panel QR and the TSQR tree) against the JAX
package on the CPU.

* The plain versions of the panel kernels (`panel_factor_packed_call` and
  `panel_apply_packed_call` on CPU tensors) and the panel driver
  `ops.qr_packed_panel` give packed words bit-identical to the JAX
  package's interpret-mode Pallas kernels.
* `QRDEngine(device='cpu')` on the panel route gives Q and R bit-identical
  to `repro.qrd.QRDEngine`; on the TSQR route R is bit-identical to the JAX
  engine's and to both packages' `tsqr_host_reference`, Q equal within
  1e-12 (float64 composition order), and `solve` within 1e-12.

Inputs are made with numpy from a seed.  Every JAX call runs once, in a
module-scoped fixture; the JAX host tree reference runs on the port's node
factorization, whose bits the other tests hold to the JAX package's.
"""
import numpy as np
import pytest
import torch

from repro import qrd as japi
from repro.core import qrd as jq
from repro.core.givens import GivensConfig as JConfig
from repro.core.givens import GivensUnit as JUnit
from repro.kernels import ops as jops
from repro.kernels import qrd_blocked as jqb
from repro.qrd import tiled as jtiled

from repro_torch import qrd as tapi
from repro_torch.core import qrd as tq
from repro_torch.core.givens import GivensConfig, GivensUnit
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qrd_blocked as tqb
from repro_torch.qrd import tiled as ttiled

M, N = 12, 6                      # the panel-level shape, with Q: e = 18
TSQR_M, TSQR_N, TILE_M = 40, 4, 12  # 40 = 3 * 12 + 4: ragged last leaf


def _bits_equal(jax_out, torch_out):
    """float64 (or int64) arrays equal bit for bit, signs of zeros included."""
    a = np.ascontiguousarray(np.asarray(jax_out))
    b = np.ascontiguousarray(torch_out.numpy())
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64))


def _configs(hub):
    return JConfig(hub=hub), GivensConfig(hub=hub)


def _words(hub):
    """Packed words of two random [A | I] working matrices, 12 x 18."""
    A = np.random.default_rng(0).standard_normal((2, M, N))
    W = np.concatenate([A, np.broadcast_to(np.eye(M), (2, M, M))], axis=-1)
    return np.asarray(JUnit(_configs(hub)[0]).encode(W))


@pytest.fixture(scope="module")
def jax_panel_kernels():
    """JAX's panel factor on the first 6 columns and its apply on the other
    12, chunked as (B, 2, 12, 6), in interpret mode (HUB)."""
    jc, _ = _configs(True)
    P = _words(True)
    piv, tgt, col = jops.panel_steps(M, N)
    out, flip, sig = jqb.panel_factor_packed_call(P[:, :, :N], piv, tgt, col,
                                                  cfg=jc, interpret=True)
    T = P[:, :, N:].reshape(2, M, 2, N).transpose(0, 2, 1, 3)
    T = jqb.panel_apply_packed_call(T, piv, tgt, flip, sig, cfg=jc,
                                    interpret=True)
    T = np.asarray(T).transpose(0, 2, 1, 3).reshape(2, M, 2 * N)
    return P, np.asarray(out), np.asarray(flip), np.asarray(sig), T


@pytest.fixture(scope="module")
def jax_panel_ops():
    """JAX `ops.qr_packed_panel` at 12 x 6 with Q, HUB and IEEE, pw 3 and 8."""
    return {(hub, pw): np.asarray(jops.qr_packed_panel(
                _words(hub), cfg=_configs(hub)[0], n_cols=N, panel_n=pw))
            for hub in (False, True) for pw in (3, 8)}


A_PANEL = np.random.default_rng(1).standard_normal((2, 10, 6))
A_TSQR = np.random.default_rng(2).standard_normal((2, TSQR_M, TSQR_N))
B_TSQR = np.random.default_rng(3).standard_normal((2, TSQR_M))


def _jax_engine(hub, **kw):
    return japi.QRDEngine(japi.QRDConfig(backend="cordic_pallas",
                                         dtype="float64",
                                         givens=_configs(hub)[0], **kw))


def _engine(hub, **kw):
    return tapi.QRDEngine(backend="cordic_pallas", dtype="float64",
                          givens=_configs(hub)[1], device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_engine_panel():
    """`repro.qrd.QRDEngine(tiling='panel', panel_n=4)` at 10 x 6, HUB."""
    Q, R = _jax_engine(True, tiling="panel", panel_n=4)(A_PANEL)
    return np.asarray(Q), np.asarray(R)


@pytest.fixture(scope="module")
def jax_engine_tsqr():
    """`repro.qrd.QRDEngine(tiling='tsqr', tile_m=12)` at 40 x 4, IEEE:
    (Q, R) and the solve against ``B_TSQR``."""
    eng = _jax_engine(False, tiling="tsqr", tile_m=TILE_M)
    Q, R = eng(A_TSQR)
    x = eng.solve(A_TSQR, B_TSQR)
    return np.asarray(Q), np.asarray(R), np.asarray(x)


def test_panel_steps_equal_jax_and_concatenate_to_flat_schedule():
    m, n, pw = 9, 5, 2
    got = []
    for c0 in range(0, min(n, m - 1), pw):
        nc = min(pw, n - c0)
        tables = tops.panel_steps(m - c0, nc)
        for t, j in zip(tables, jops.panel_steps(m - c0, nc)):
            assert t.dtype == np.int32 and not t.flags.writeable
            np.testing.assert_array_equal(t, j)
        got += [(int(p) + c0, int(t) + c0, int(c) + c0)
                for p, t, c in zip(*tables)]
    assert tuple(got) == tq.givens_schedule(m, n)


def test_panel_kernels_plain_versions_bit_equal_to_jax(jax_panel_kernels):
    P, out, flip, sig, T = jax_panel_kernels
    _, tc = _configs(True)
    piv, tgt, col = tops.panel_steps(M, N)
    W = torch.tensor(P)
    before = (tqb.PANEL_FACTOR_LAUNCHES, tqb.PANEL_APPLY_LAUNCHES)
    tile, tflip, tsig = tqb.panel_factor_packed_call(W[:, :, :N], piv, tgt, col,
                                                     cfg=tc)
    _bits_equal(out, tile)
    _bits_equal(flip, tflip)
    _bits_equal(sig, tsig)
    assert torch.equal(W[:, :, :N], tile)           # in place on the view
    tqb.panel_apply_packed_call(W[:, :, N:], piv, tgt, tflip, tsig, cfg=tc)
    _bits_equal(T, W[:, :, N:])
    # the plain versions run on CPU tensors: no launch is counted
    assert (tqb.PANEL_FACTOR_LAUNCHES, tqb.PANEL_APPLY_LAUNCHES) == before


@pytest.mark.parametrize("pw", [3, 8])
@pytest.mark.parametrize("hub", [False, True], ids=["ieee", "hub"])
def test_qr_packed_panel_bit_equal_to_jax(jax_panel_ops, hub, pw):
    _, tc = _configs(hub)
    P = torch.tensor(_words(hub))
    got = tops.qr_packed_panel(P, cfg=tc, n_cols=N, panel_n=pw)
    _bits_equal(jax_panel_ops[(hub, pw)], got)
    assert torch.equal(P, torch.tensor(_words(hub)))   # input untouched
    flat = tqb.qr_packed_reference(P, cfg=tc, steps=tq.givens_schedule(M, N))
    assert torch.equal(got, flat)
    # any leading batch shape
    lead = tops.qr_packed_panel(P[:, None], cfg=tc, n_cols=N, panel_n=pw)
    assert lead.shape == (2, 1, M, M + N) and torch.equal(lead[:, 0], got)


def test_engine_panel_bit_equal_to_jax_engine(jax_engine_panel):
    Qj, Rj = jax_engine_panel
    Qt, Rt = _engine(True, tiling="panel", panel_n=4)(A_PANEL)
    _bits_equal(Qj, Qt)
    _bits_equal(Rj, Rt)
    Qf, Rf = _engine(True, tiling="flat")(A_PANEL)
    assert torch.equal(Qt, Qf) and torch.equal(Rt, Rf)
    _, R_only = _engine(True, tiling="panel", panel_n=4)(A_PANEL,
                                                         compute_q=False)
    assert torch.equal(R_only, Rt)


def test_engine_tsqr_bit_equal_to_jax_and_host_trees(jax_engine_tsqr):
    Qj, Rj, _ = jax_engine_tsqr
    eng = _engine(False, tiling="tsqr", tile_m=TILE_M)
    Qt, Rt = eng(A_TSQR)
    assert Qt.shape == (2, TSQR_M, TSQR_N) and Rt.shape == (2, TSQR_N, TSQR_N)
    _bits_equal(Rj, Rt)
    np.testing.assert_allclose(Qt.numpy(), Qj, rtol=0, atol=1e-12)
    unit = GivensUnit(_configs(False)[1])

    def node_qr(X):
        return tq.qr_cordic(torch.as_tensor(X), unit)

    for i in range(2):
        Qr, Rr = ttiled.tsqr_host_reference(torch.tensor(A_TSQR[i]), node_qr,
                                            TILE_M)
        assert torch.equal(Rr, Rt[i])
        np.testing.assert_allclose(Qt[i].numpy(), Qr.numpy(), rtol=0,
                                   atol=1e-12)
        Qjr, Rjr = jtiled.tsqr_host_reference(
            A_TSQR[i], lambda X: tuple(t.numpy() for t in node_qr(X)), TILE_M)
        _bits_equal(Rjr, Rr)
        np.testing.assert_allclose(Qr.numpy(), Qjr, rtol=0, atol=1e-12)
    _, R_only = eng(A_TSQR, compute_q=False)
    assert R_only.shape == (2, TSQR_N, TSQR_N) and torch.equal(R_only, Rt)
    assert np.abs((Qt @ Rt).numpy() - A_TSQR).max() < 1e-4


def test_solve_through_tsqr_matches_jax_engine(jax_engine_tsqr):
    _, _, xj = jax_engine_tsqr
    xt = _engine(False, tiling="tsqr", tile_m=TILE_M).solve(A_TSQR, B_TSQR)
    assert xt.shape == xj.shape
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-12)


def test_resolve_tiles_equal_jax():
    jcaps = japi.get_backend("cordic_pallas").capabilities
    tcaps = tapi.get_backend("cordic_pallas").capabilities
    for kw in ({}, dict(tile_m=64), dict(panel_n=4),
               dict(tile_m=12, panel_n=16)):
        want = jtiled.resolve_tiles(japi.QRDConfig(backend="cordic_pallas",
                                                   **kw), jcaps)
        got = ttiled.resolve_tiles(tapi.QRDConfig(backend="cordic_pallas",
                                                  **kw), tcaps)
        assert got == want
    assert ttiled.DEFAULT_PANEL_N == jtiled.DEFAULT_PANEL_N


def test_block_fp_tiled_route_is_not_ported():
    # named when the block-FP tiled routes were still to port; they are
    # ported now (ROADMAP A7), and the leaf primitive is the block-FP panel
    # route, equal to the block-FP flat route
    cfg = tapi.QRDConfig(backend="blockfp_pallas", tiling="panel", hub=True,
                         iters=24)
    A = torch.tensor(np.random.default_rng(4).normal(size=(2, 7, 4)))
    Q, R = ttiled._leaf_qr_fn(cfg, 3)(A, True)
    Qf, Rf = tq.qr_blockfp_pallas(A, iters=24, hub=True)
    assert torch.equal(Q, Qf) and torch.equal(R, Rf)
