"""The CUDA kernels of `repro_torch` (the flat kernel, the panel factor and
apply kernels of the packed lane, their three block-FP twins, the two
wavefront kernels, the two complex kernels, the standalone rotator's three
and the two dual-int32 lane kernels) against their plain PyTorch versions,
on the GPU; and `qr_cordic` with the ``N``/``iters`` overrides on the card
against the CPU.

Marked ``gpu``: the kernels have no CPU or interpret mode, so these tests
skip on a machine without CUDA (the `cuda` fixture decides, at run time).
Run them on a GPU host with ``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.
The same cases run in ``chip_smoke.py``, whose helpers build the inputs.
"""
import itertools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

from repro_torch.core.givens import GivensUnit  # noqa: E402
from repro_torch.core.qrd import givens_schedule, qr_cordic  # noqa: E402
from repro_torch.kernels import cordic_givens as cg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import qrd_blocked as qb  # noqa: E402
from repro_torch.qrd import QRDEngine  # noqa: E402
from repro_torch.qrd.rls import RLSState  # noqa: E402
from repro_torch.qrd.tiled import tsqr_host_reference  # noqa: E402

pytestmark = pytest.mark.gpu

CONFIGS = chip_smoke.parity_configs()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on a GPU")
    return torch.device("cuda")


def _check(P, cfg, steps, tile_b=None):
    before = qb.QR_PACKED_LAUNCHES
    out = qb.qr_packed_call(P, cfg=cfg, steps=steps, tile_b=tile_b)
    ref = qb.qr_packed_reference(P, cfg=cfg, steps=steps)
    torch.cuda.synchronize()
    assert qb.QR_PACKED_LAUNCHES == before + 1
    assert out.device.type == "cuda"
    assert torch.equal(out, ref)


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_qr_packed_bit_equal_to_plain_version(cuda, i):
    cfg = CONFIGS[i]
    rng = np.random.default_rng(i)
    for (m, n, cq) in ((4, 4, True), (6, 3, True), (3, 5, False),
                       (16, 16, True)):
        steps = givens_schedule(m, n)
        _check(chip_smoke.encoded_words(cfg, 8, m, n, cq, rng, cuda), cfg, steps)
        _check(chip_smoke.edge_words(cfg, 8, m, n + (m if cq else 0), rng, cuda),
               cfg, steps)


@pytest.mark.parametrize("tile_b", [1, 2, 4])
def test_qr_packed_ragged_batch(cuda, tile_b):
    cfg = CONFIGS[2]
    P = chip_smoke.encoded_words(cfg, 5, 6, 4, True, np.random.default_rng(9),
                                 cuda)
    _check(P, cfg, givens_schedule(6, 4), tile_b=tile_b)


def test_engine_on_gpu_equals_cpu(cuda):
    A = np.random.default_rng(4).normal(size=(7, 8, 6))
    kw = dict(backend="cordic_pallas", dtype="float64",
              givens=chip_smoke.GivensConfig(hub=True, n=26))
    before = qb.QR_PACKED_LAUNCHES
    Qg, Rg = QRDEngine(**kw)(A)
    assert qb.QR_PACKED_LAUNCHES == before + 1
    Qc, Rc = QRDEngine(device="cpu", **kw)(A)
    assert torch.equal(Qg.cpu(), Qc) and torch.equal(Rg.cpu(), Rc)


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_panel_kernels_bit_equal_to_plain_versions(cuda, i):
    """B3a and B3b at every launch of the panel route, against their plain
    versions (`chip_smoke.check_panel_sweep` fails the test otherwise)."""
    cfg = CONFIGS[i]
    rng = np.random.default_rng(20 + i)
    before = (qb.PANEL_FACTOR_LAUNCHES, qb.PANEL_APPLY_LAUNCHES)
    for pw in (3, 8):
        chip_smoke.check_panel_sweep(
            chip_smoke.encoded_words(cfg, 8, 12, 6, True, rng, cuda), cfg, 6, pw)
        chip_smoke.check_panel_sweep(
            chip_smoke.edge_words(cfg, 8, 12, 18, rng, cuda), cfg, 6, pw)
    assert qb.PANEL_FACTOR_LAUNCHES > before[0]
    assert qb.PANEL_APPLY_LAUNCHES > before[1]


@pytest.mark.parametrize("tile_b", [1, 2, 4])
def test_panel_factor_ragged_batch(cuda, tile_b):
    cfg = CONFIGS[2]
    P = chip_smoke.encoded_words(cfg, 5, 10, 4, True, np.random.default_rng(9),
                                 cuda)
    chip_smoke.check_panel_sweep(P, cfg, 4, 3, tile_b=tile_b)


@pytest.mark.parametrize("hub", [False, True], ids=["ieee", "hub"])
def test_engine_panel_equals_flat_on_gpu(cuda, hub):
    A = np.random.default_rng(5).normal(size=(3, 24, 10))
    kw = dict(backend="cordic_pallas", dtype="float64",
              givens=chip_smoke.GivensConfig(hub=hub, n=26))
    before = qb.PANEL_FACTOR_LAUNCHES
    Qp, Rp = QRDEngine(tiling="panel", panel_n=4, **kw)(A)
    assert qb.PANEL_FACTOR_LAUNCHES == before + 3
    Qf, Rf = QRDEngine(tiling="flat", **kw)(A)
    assert torch.equal(Qp, Qf) and torch.equal(Rp, Rf)


def test_qr_packed_device_memory_tile(cuda, monkeypatch):
    """The flat kernel with its tile in device memory, forced by lowering
    the shared-memory limit, against its plain version."""
    monkeypatch.setattr(qb, "MAX_SHARED_BYTES", 0)
    rng = np.random.default_rng(11)
    for cfg in CONFIGS[::3]:
        for tile_b in (1, 2):
            _check(chip_smoke.encoded_words(cfg, 5, 12, 6, True, rng, cuda),
                   cfg, givens_schedule(12, 6), tile_b=tile_b)
            _check(chip_smoke.edge_words(cfg, 5, 12, 18, rng, cuda), cfg,
                   givens_schedule(12, 6), tile_b=tile_b)


def test_panel_route_through_ops_equals_flat(cuda):
    cfg = CONFIGS[0]
    P = chip_smoke.encoded_words(cfg, 4, 20, 9, True, np.random.default_rng(3),
                                 cuda)
    flat = qb.qr_packed_call(P, cfg=cfg, steps=givens_schedule(20, 9))
    for pw in (1, 4, 9, 16):
        assert torch.equal(ops.qr_packed_panel(P, cfg=cfg, n_cols=9, panel_n=pw),
                           flat)


def test_panel_factor_keeps_panels_in_shared_memory(cuda, monkeypatch):
    """The panel factorization's default tile_b fits its panels and their
    control words in shared memory, and a tile_b whose panels do not fit
    runs them in device memory, with the same words."""
    cfg = CONFIGS[0]
    P = chip_smoke.encoded_words(cfg, 5, 12, 6, False, np.random.default_rng(12),
                                 cuda)
    piv, tgt, col = ops.panel_steps(12, 6)
    pairs = ops.panel_stages(12, 6)[1].shape[1]
    monkeypatch.setattr(qb, "MAX_SHARED_BYTES", 2 * (12 * 6 + 2 * pairs) * 8)
    monkeypatch.setattr(qb, "PANEL_TILE_B", 4)
    chip_smoke.check_panel_sweep(P, cfg, 6, 6)         # default capped to 2
    chip_smoke.check_panel_sweep(P, cfg, 6, 6, tile_b=2)
    assert qb._panel_tile("", 3, 64, 12, 6, 6, pairs, 8) == (3, True)
    chip_smoke.check_panel_sweep(P, cfg, 6, 6, tile_b=3)  # device memory


@pytest.mark.parametrize("hub,pw", [(False, 3), (True, 8)],
                         ids=["ieee-pw3", "hub-pw8"])
def test_panel_kernels_tree_node_shape(cuda, hub, pw):
    """The panel route at the TSQR tree node's shape, (64, 32) with Q, on a
    ragged batch of 3 in blocks of 2: B3a and B3b on the first, 64-row
    panel against their plain versions (whose loops over 64-row steps take
    most of the time), and the route's words against the flat kernel's."""
    cfg = chip_smoke.GivensConfig(hub=hub, n=26)
    rng = np.random.default_rng(40 + pw)
    P = chip_smoke.encoded_words(cfg, 3, 64, 32, True, rng, cuda)
    chip_smoke.check_panel_sweep(P, cfg, 32, pw, tile_b=2, plain_panels=1)


def test_panel_apply_narrow_column_blocks(cuda, monkeypatch):
    """B3b with fewer columns a block than a warp (its rows capped by the
    shared-memory limit), ragged over a trailing region of 36, against its
    plain version."""
    cfg = CONFIGS[2]
    P = chip_smoke.encoded_words(cfg, 3, 12, 6, True, np.random.default_rng(13),
                                 cuda)
    W = torch.cat([P, P[..., :24]], dim=-1).contiguous()       # e = 42
    piv, tgt, col = ops.panel_steps(12, 6)
    _, flip, sig = qb.panel_factor_packed_call(W[:, :, :6], piv, tgt, col,
                                               cfg=cfg)
    T = W[:, :, 6:]
    want = qb.panel_apply_packed_reference(T, piv, tgt, flip, sig, cfg=cfg)
    monkeypatch.setattr(qb, "MAX_SHARED_BYTES", 12 * 8 * 5)   # 5 columns
    before = qb.PANEL_APPLY_LAUNCHES
    qb.panel_apply_packed_call(T, piv, tgt, flip, sig, cfg=cfg)
    torch.cuda.synchronize()
    assert qb.PANEL_APPLY_LAUNCHES == before + 1
    assert torch.equal(T, want)


def test_wavefront_on_panel_stages_equals_panel_factor(cuda):
    """B5a (`qr_packed_wavefront_call`) on a panel's stage tables
    (`ops.panel_stages`) gives B3a's words."""
    rng = np.random.default_rng(14)
    for cfg in CONFIGS[::2]:
        for mr, nc in ((64, 8), (20, 3), (6, 8)):
            P = chip_smoke.encoded_words(cfg, 5, mr, nc, False, rng, cuda)
            tabs, _ = ops.panel_stages(mr, nc)
            before = (qb.QR_PACKED_WAVEFRONT_LAUNCHES, qb.PANEL_FACTOR_LAUNCHES)
            wf = qb.qr_packed_wavefront_call(P, *tabs, cfg=cfg)
            pf, _, _ = qb.panel_factor_packed_call(
                P.clone(), *ops.panel_steps(mr, nc), cfg=cfg)
            torch.cuda.synchronize()
            assert (qb.QR_PACKED_WAVEFRONT_LAUNCHES,
                    qb.PANEL_FACTOR_LAUNCHES) == (before[0] + 1, before[1] + 1)
            assert torch.equal(wf, pf)


# ---------------------------------------------------------------------------
# the int32 block-FP lane (csrc/blockfp.cu)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hub,iters", chip_smoke.BFP_CONFIGS)
def test_qr_blockfp_bit_equal_to_plain_version(cuda, hub, iters):
    rng = np.random.default_rng(iters + hub)
    before = qb.QR_BLOCKFP_LAUNCHES
    for (m, n, cq) in ((4, 4, True), (6, 3, True), (3, 5, False),
                       (16, 16, True)):
        e = n + (m if cq else 0)
        for edge in (False, True):
            chip_smoke.check_bfp_flat(
                chip_smoke.bfp_words(8, m, e, rng, cuda, edge), hub, iters,
                givens_schedule(m, n))
    chip_smoke.check_bfp_flat(chip_smoke.bfp_words(4, 12, 9, rng, cuda), hub,
                              iters, ops.rls_block_steps(8, 4))
    assert qb.QR_BLOCKFP_LAUNCHES == before + 9


@pytest.mark.parametrize("tile_b", [1, 2, 4])
def test_qr_blockfp_ragged_batch(cuda, tile_b):
    X = chip_smoke.bfp_words(5, 6, 10, np.random.default_rng(9), cuda)
    chip_smoke.check_bfp_flat(X, True, 24, givens_schedule(6, 4), tile_b)


@pytest.mark.parametrize("hub,iters", chip_smoke.BFP_CONFIGS)
def test_blockfp_panel_kernels_bit_equal_to_plain_versions(cuda, hub, iters):
    """B4a and B4b at every launch of the panel route, against their plain
    versions, and the route against B2."""
    rng = np.random.default_rng(30 + iters + hub)
    before = (qb.PANEL_FACTOR_BLOCKFP_LAUNCHES,
              qb.PANEL_APPLY_BLOCKFP_LAUNCHES)
    for pw in (3, 8):
        for edge in (False, True):
            chip_smoke.check_bfp_panel_sweep(
                chip_smoke.bfp_words(8, 12, 18, rng, cuda, edge), hub, iters,
                6, pw)
    chip_smoke.check_bfp_panel_sweep(chip_smoke.bfp_words(5, 10, 14, rng, cuda),
                                     hub, iters, 4, 3, tile_b=2)
    assert qb.PANEL_FACTOR_BLOCKFP_LAUNCHES > before[0]
    assert qb.PANEL_APPLY_BLOCKFP_LAUNCHES > before[1]


def test_blockfp_kernels_keep_tiles_in_shared_memory(cuda, monkeypatch):
    """B2 and B4a cap their default tile_b to shared memory; on an explicit
    tile_b whose tiles and their stage's control words do not fit, B2 (and
    B5b, on its kernel) raises and B4a runs its panels in device memory,
    with the same words."""
    rng = np.random.default_rng(12)
    X = chip_smoke.bfp_words(5, 12, 18, rng, cuda)
    pairs = qb.flat_stage_table(givens_schedule(12, 6), 12, 18).shape[2]
    monkeypatch.setattr(qb, "MAX_SHARED_BYTES", 2 * (12 * 18 + 2 * pairs) * 4)
    chip_smoke.check_bfp_flat(X, True, 24, givens_schedule(12, 6), tile_b=2)
    with pytest.raises(ValueError, match="shared memory"):
        qb.qr_blockfp_call(X, iters=24, hub=True,
                           steps=givens_schedule(12, 6), tile_b=3)
    P = chip_smoke.bfp_words(5, 12, 6, rng, cuda)
    piv, tgt, col = ops.panel_steps(12, 6)
    monkeypatch.setattr(qb, "MAX_SHARED_BYTES", 2 * 12 * 6 * 4)
    chip_smoke.check_bfp_panel_sweep(P, True, 24, 6, 6)    # default tile_b: 2
    want = qb.panel_factor_blockfp_reference(P, piv, tgt, col, iters=24,
                                             hub=True)
    got = qb.panel_factor_blockfp_call(P.clone(), piv, tgt, col, iters=24,
                                       hub=True, tile_b=3)  # device memory
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    tabs = chip_smoke.stage_tables(12, 6)
    pairs = qb._wavefront_table(qb._stage_key(*tabs), 12, 18,
                                str(cuda)).shape[2]
    monkeypatch.setattr(qb, "MAX_SHARED_BYTES", 2 * (12 * 18 + 2 * pairs) * 4)
    with pytest.raises(ValueError, match="shared memory"):
        qb.qr_blockfp_wavefront_call(X, *tabs, iters=24, hub=True, tile_b=3)


@pytest.mark.parametrize("hub", [False, True], ids=["conv", "hub"])
def test_blockfp_engine_panel_equals_flat_at_128(cuda, hub):
    """At 128 x 128 with Q the flat kernel B2 holds a 128 x 256 int32 tile
    (128 KiB) in shared memory; its Q and R equal the panel route's."""
    A = np.random.default_rng(6).normal(size=(2, 128, 128))
    kw = dict(backend="blockfp_pallas", dtype="float64", hub=hub, iters=24)
    before = (qb.QR_BLOCKFP_LAUNCHES, qb.PANEL_FACTOR_BLOCKFP_LAUNCHES)
    Qf, Rf = QRDEngine(tiling="flat", **kw)(A)
    Qp, Rp = QRDEngine(**kw)(A)                         # auto -> panel
    assert qb.QR_BLOCKFP_LAUNCHES == before[0] + 1
    assert qb.PANEL_FACTOR_BLOCKFP_LAUNCHES == before[1] + 16
    assert torch.equal(Qf, Qp) and torch.equal(Rf, Rp)


def test_blockfp_engine_and_rls_on_gpu_equal_cpu(cuda):
    A = np.random.default_rng(4).normal(size=(7, 8, 6))
    kw = dict(backend="blockfp_pallas", dtype="float64", hub=True, iters=24)
    before = qb.QR_BLOCKFP_LAUNCHES
    Qg, Rg = QRDEngine(**kw)(A)
    assert qb.QR_BLOCKFP_LAUNCHES == before + 1
    Qc, Rc = QRDEngine(device="cpu", **kw)(A)
    assert torch.equal(Qg.cpu(), Qc) and torch.equal(Rg.cpu(), Rc)
    rng = np.random.default_rng(8)
    xs, ds = rng.normal(size=(10, 4)), rng.normal(size=10)
    states = [RLSState(4, mode="block", block=3, device=d) for d in (cuda, "cpu")]
    for st in states:
        for x, d in zip(xs, ds):
            st.update(x, d)
        st.flush()
    assert torch.equal(states[0].R.cpu(), states[1].R)
    assert torch.equal(states[0].z.cpu(), states[1].z)


# ---------------------------------------------------------------------------
# the flat kernels' stages (B1 and B2 on any step order)
# ---------------------------------------------------------------------------
#: name -> (rows m, columns e, steps): the RLS block order, the solve
#: augmentation [A | b] of a 12 x 6 problem, and a flattened Sameh–Kuck
#: order with Q.
FLAT_ORDERS = {"rls": (12, 9, ops.rls_block_steps(8, 4)),
               "solve": (12, 7, givens_schedule(12, 7)),
               "sameh-kuck": (9, 15, chip_smoke.flat_order(9, 6))}


def _flat_pair(cfg, hub, m, e, rng, device):
    """Five (m, e) tiles of packed words (three random, two of edge words)
    and five of block-FP significands (edge tiles with ``hub``)."""
    P = torch.cat([chip_smoke.encoded_words(cfg, 3, m, e, False, rng, device),
                   chip_smoke.edge_words(cfg, 2, m, e, rng, device)])
    return P.contiguous(), chip_smoke.bfp_words(5, m, e, rng, device, edge=hub)


@pytest.mark.parametrize("tile_b", [None, 2, 4])
@pytest.mark.parametrize("order", list(FLAT_ORDERS))
def test_flat_kernels_on_any_step_order(cuda, order, tile_b):
    """B1 (IEEE and HUB) and B2 (conventional and HUB) bit-equal to their
    plain versions on the RLS order, the solve augmentation and a
    flattened Sameh–Kuck order, on a ragged batch of 5 at tile_b 2 and 4;
    one launch each."""
    m, e, steps = FLAT_ORDERS[order]
    rng = np.random.default_rng(len(order) + (tile_b or 0))
    for cfg, hub in ((CONFIGS[1], False), (CONFIGS[2], True)):
        P, X = _flat_pair(cfg, hub, m, e, rng, cuda)
        _check(P, cfg, steps, tile_b=tile_b)
        before = qb.QR_BLOCKFP_LAUNCHES
        chip_smoke.check_bfp_flat(X, hub, 24, steps, tile_b=tile_b)
        assert qb.QR_BLOCKFP_LAUNCHES == before + 1


@pytest.mark.parametrize("order", list(FLAT_ORDERS))
def test_qr_packed_device_memory_tile_on_any_step_order(cuda, order,
                                                        monkeypatch):
    """B1 with its tiles in device memory (the shared-memory limit lowered
    to 0) on the same orders, against its plain version and against B1
    with its tiles in shared memory."""
    m, e, steps = FLAT_ORDERS[order]
    rng = np.random.default_rng(70 + len(order))
    cfg = CONFIGS[2]
    P, _ = _flat_pair(cfg, True, m, e, rng, cuda)
    shared = qb.qr_packed_call(P, cfg=cfg, steps=steps, tile_b=2)
    monkeypatch.setattr(qb, "MAX_SHARED_BYTES", 0)
    for tile_b in (1, 2):
        _check(P, cfg, steps, tile_b=tile_b)
    assert torch.equal(qb.qr_packed_call(P, cfg=cfg, steps=steps), shared)


@pytest.mark.parametrize("hub", [False, True], ids=["ieee", "hub"])
def test_flat_kernels_on_flattened_stages_equal_wavefront(cuda, hub):
    """B1 and B2 on a flattened Sameh–Kuck order give the words of B5a and
    B5b on its stages, and of their plain versions, at 32 x 32 with Q."""
    cfg = CONFIGS[2] if hub else CONFIGS[1]
    rng = np.random.default_rng(80 + hub)
    tabs = chip_smoke.stage_tables(32, 32)
    flat = chip_smoke.flat_order(32, 32)
    P = chip_smoke.encoded_words(cfg, 6, 32, 32, True, rng, cuda)
    _check(P, cfg, flat)
    assert torch.equal(qb.qr_packed_call(P, cfg=cfg, steps=flat),
                       qb.qr_packed_wavefront_call(P, *tabs, cfg=cfg))
    X = chip_smoke.bfp_words(6, 32, 64, rng, cuda, edge=hub)
    got = chip_smoke.check_bfp_flat(X, hub, 24, flat)
    assert torch.equal(got, qb.qr_blockfp_wavefront_call(X, *tabs, iters=24,
                                                         hub=hub))


@pytest.mark.parametrize("hub", [False, True], ids=["conv", "hub"])
def test_blockfp_wavefront_on_flat_kernel(cuda, hub):
    """B5b runs B2's kernel on the caller's Sameh–Kuck stages with their
    item ends: on a ragged batch of 5 at the default tile_b and at 2 and 4,
    at 32 x 32 with Q and on the solve's 32 x (16 + 1), bit-equal to its
    plain version and to B2 on the flattened stages; one B5b launch a call
    and none of B2's."""
    rng = np.random.default_rng(170 + hub)
    kw = dict(iters=24, hub=hub)
    for m, n, e in ((32, 32, 64), (32, 16, 17)):
        tabs = chip_smoke.stage_tables(m, n)
        X = chip_smoke.bfp_words(5, m, e, rng, cuda, edge=hub)
        want = qb.qr_blockfp_wavefront_reference(X, *tabs, **kw)
        assert torch.equal(qb.qr_blockfp_call(
            X, steps=chip_smoke.flat_order(m, n), **kw), want)
        for tile_b in (None, 2, 4):
            before = (qb.QR_BLOCKFP_WAVEFRONT_LAUNCHES, qb.QR_BLOCKFP_LAUNCHES)
            got = qb.qr_blockfp_wavefront_call(X, *tabs, tile_b=tile_b, **kw)
            torch.cuda.synchronize()
            assert (qb.QR_BLOCKFP_WAVEFRONT_LAUNCHES,
                    qb.QR_BLOCKFP_LAUNCHES) == (before[0] + 1, before[1])
            assert torch.equal(got, want), (m, n, tile_b)


def test_flat_kernels_widen_blocks_for_a_small_batch(cuda):
    """A batch too small to fill the card runs more threads a matrix
    (`qrd_blocked._flat_threads`); the words equal those of the narrow
    blocks a large batch gets.  B1, B2 and the complex B7a, at 32 x 32
    with Q (their narrow blocks, up to 256 threads, leave room to widen)."""
    steps = givens_schedule(32, 32)
    dev = str(cuda)
    table = qb._flat_stage_table(steps, 32, 64, dev)
    narrow = {}
    for kernel, threads in qb.FLAT_THREADS.items():
        wide = qb._flat_threads(kernel, table.shape[2], 64, 3, None, dev)
        narrow[kernel] = qb._flat_threads(kernel, table.shape[2], 64, 10 ** 6,
                                          None, dev)
        assert qb.FLAT_MAX_THREADS >= wide > narrow[kernel] == threads
    P = chip_smoke.encoded_words(CONFIGS[2], 3, 32, 32, True,
                                 np.random.default_rng(90), cuda)
    X = chip_smoke.bfp_words(3, 32, 64, np.random.default_rng(91), cuda)
    C = chip_smoke.complex_words(CONFIGS[2], 3, 32, 32, True,
                                 np.random.default_rng(92), cuda)
    out = qb.qr_packed_call(P, cfg=CONFIGS[2], steps=steps)
    bfp = chip_smoke.check_bfp_flat(X, True, 24, steps)
    _check(P, CONFIGS[2], steps)
    cplx = qb.qr_packed_complex_call(C, cfg=CONFIGS[2], steps=steps)
    assert torch.equal(qb._qr_packed_launch(P, table, CONFIGS[2], None,
                                            narrow["qr_packed"]), out)
    assert torch.equal(qb._qr_blockfp_launch(X, table,
                                             qb._blockfp_args(24, True), None,
                                             narrow["qr_blockfp"]), bfp)
    assert torch.equal(qb._qr_packed_complex_launch(
        C, table, CONFIGS[2], None, narrow["qr_packed_complex"]), cplx)
    assert torch.equal(qb._qr_packed_complex_launch(C, table, CONFIGS[2], 1,
                                                    1024), cplx)


# ---------------------------------------------------------------------------
# the Sameh–Kuck wavefront (B1's and B2's kernels) and the complex datapath
# (csrc/complex_packed.cu)
# ---------------------------------------------------------------------------
WF_SHAPES = ((4, 4, True), (6, 3, True), (3, 6, True), (2, 3, False),
             (16, 16, True))


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_wavefront_kernels_bit_equal_to_plain_versions(cuda, i):
    """B5a against its plain version and B1 on the flattened stages (the
    four datapath variants at N = 26); B5b against its plain version and
    B2 at one (hub, iters) each; square and non-square shapes."""
    cfg = CONFIGS[i]
    hub, iters = chip_smoke.BFP_CONFIGS[i]
    rng = np.random.default_rng(40 + i)
    before = (qb.QR_PACKED_WAVEFRONT_LAUNCHES, qb.QR_BLOCKFP_WAVEFRONT_LAUNCHES)
    for (m, n, cq) in WF_SHAPES:
        e = n + (m if cq else 0)
        tabs = chip_smoke.stage_tables(m, n)
        flat = chip_smoke.flat_order(m, n)
        for P in (chip_smoke.encoded_words(cfg, 8, m, n, cq, rng, cuda),
                  chip_smoke.edge_words(cfg, 8, m, e, rng, cuda)):
            got = chip_smoke.check_plain(
                "qr_packed_wavefront", qb.qr_packed_wavefront_call,
                qb.qr_packed_wavefront_reference, P, *tabs, cfg=cfg,
                table_layout=qb.TABLE_LAYOUTS[m % 2])
            assert torch.equal(got, qb.qr_packed_call(P, cfg=cfg, steps=flat))
        for edge in (False, True):
            X = chip_smoke.bfp_words(8, m, e, rng, cuda, edge)
            got = chip_smoke.check_plain(
                "qr_blockfp_wavefront", qb.qr_blockfp_wavefront_call,
                qb.qr_blockfp_wavefront_reference, X, *tabs, iters=iters,
                hub=hub)
            assert torch.equal(got, qb.qr_blockfp_call(X, iters=iters, hub=hub,
                                                       steps=flat))
    assert qb.QR_PACKED_WAVEFRONT_LAUNCHES == before[0] + 2 * len(WF_SHAPES)
    assert qb.QR_BLOCKFP_WAVEFRONT_LAUNCHES == before[1] + 2 * len(WF_SHAPES)


@pytest.mark.parametrize("tile_b", [1, 2, 4])
def test_wavefront_and_complex_ragged_batch(cuda, tile_b):
    rng = np.random.default_rng(50 + tile_b)
    cfg = CONFIGS[2]
    tabs = chip_smoke.stage_tables(6, 4)
    P = chip_smoke.encoded_words(cfg, 5, 6, 4, True, rng, cuda)
    chip_smoke.check_plain("qr_packed_wavefront", qb.qr_packed_wavefront_call,
                           qb.qr_packed_wavefront_reference, P, *tabs,
                           cfg=cfg, tile_b=tile_b)
    X = chip_smoke.bfp_words(5, 6, 10, rng, cuda)
    chip_smoke.check_plain("qr_blockfp_wavefront", qb.qr_blockfp_wavefront_call,
                           qb.qr_blockfp_wavefront_reference, X, *tabs,
                           iters=24, hub=True, tile_b=tile_b)
    C = chip_smoke.complex_words(cfg, 5, 6, 4, True, rng, cuda)
    chip_smoke.check_plain("qr_packed_complex", qb.qr_packed_complex_call,
                           qb.qr_packed_complex_reference, C, cfg=cfg,
                           steps=givens_schedule(6, 4), tile_b=tile_b)
    chip_smoke.check_plain("qr_packed_complex_wavefront",
                           qb.qr_packed_complex_wavefront_call,
                           qb.qr_packed_complex_wavefront_reference, C, *tabs,
                           cfg=cfg, tile_b=tile_b)


@pytest.mark.parametrize("i", [0, 2])
def test_complex_kernels_bit_equal_to_plain_versions(cuda, i):
    """B7a and B7b against their plain versions on random and edge words
    (exactly real and zero leads, an all-zero column), B7b also against B7a
    on the flattened stages; purely real words give B1's words and +-0
    imaginary words."""
    cfg = CONFIGS[i]
    rng = np.random.default_rng(60 + i)
    before = (qb.QR_PACKED_COMPLEX_LAUNCHES,
              qb.QR_PACKED_COMPLEX_WAVEFRONT_LAUNCHES)
    for (m, n, cq) in WF_SHAPES[:4]:
        tabs = chip_smoke.stage_tables(m, n)
        for edge in (False, True):
            C = chip_smoke.complex_words(cfg, 8, m, n, cq, rng, cuda, edge)
            chip_smoke.check_plain("qr_packed_complex", qb.qr_packed_complex_call,
                                   qb.qr_packed_complex_reference, C, cfg=cfg,
                                   steps=givens_schedule(m, n))
            got = chip_smoke.check_plain(
                "qr_packed_complex_wavefront",
                qb.qr_packed_complex_wavefront_call,
                qb.qr_packed_complex_wavefront_reference, C, *tabs, cfg=cfg)
            assert torch.equal(got, qb.qr_packed_complex_call(
                C, cfg=cfg, steps=chip_smoke.flat_order(m, n)))
    C = chip_smoke.complex_words(cfg, 8, 6, 3, True, rng, cuda)
    C[..., 1] = 0
    got = qb.qr_packed_complex_call(C, cfg=cfg, steps=givens_schedule(6, 3))
    real = qb.qr_packed_call(C[..., 0].contiguous(), cfg=cfg,
                             steps=givens_schedule(6, 3))
    assert torch.equal(got[..., 0], real)
    assert chip_smoke.packed_is_zero(got[..., 1], cfg.fmt).all()
    assert qb.QR_PACKED_COMPLEX_LAUNCHES == before[0] + 17
    assert qb.QR_PACKED_COMPLEX_WAVEFRONT_LAUNCHES == before[1] + 8


#: name -> (m, n, compute_q, steps) of the complex flat kernel's step
#: orders: column-major with Q, the solve augmentation [A | b] and a
#: flattened Sameh–Kuck order with Q.
COMPLEX_ORDERS = {"col": (9, 5, True, givens_schedule(9, 5)),
                  "solve": (9, 6, False, givens_schedule(9, 6)),
                  "sameh-kuck": (7, 5, True, chip_smoke.flat_order(7, 5))}


@pytest.mark.parametrize("mode", ["shared", "device"])
@pytest.mark.parametrize("order", list(COMPLEX_ORDERS))
def test_complex_flat_kernel_stages_on_any_step_order(cuda, monkeypatch,
                                                      order, mode):
    """B7a in levelized stages bit-equal to its plain version on three step
    orders, a ragged batch of 5 (random and edge words, HUB and IEEE) at
    tile_b 1 and 2, with its tiles in shared or in device memory; one
    launch a call."""
    m, n, cq, steps = COMPLEX_ORDERS[order]
    if mode == "device":
        monkeypatch.setattr(qb, "MAX_SHARED_BYTES", 0)
    rng = np.random.default_rng(100 + len(order) + len(mode))
    for cfg, edge in ((CONFIGS[0], True), (CONFIGS[3], False)):
        C = chip_smoke.complex_words(cfg, 5, m, n, cq, rng, cuda, edge)
        for tile_b in (1, 2):
            before = qb.QR_PACKED_COMPLEX_LAUNCHES
            chip_smoke.check_plain(f"qr_packed_complex {order}",
                                   qb.qr_packed_complex_call,
                                   qb.qr_packed_complex_reference, C, cfg=cfg,
                                   steps=steps, tile_b=tile_b)
            assert qb.QR_PACKED_COMPLEX_LAUNCHES == before + 1


#: (mr, nc) of the block-FP panel factor's panels: fewer columns than rows,
#: nc = mr - 1 (the last column annihilates nothing more) and more columns
#: than rows.
BFP_PANELS = ((12, 6), (9, 8), (5, 9))


@pytest.mark.parametrize("hub", [False, True], ids=["conv", "hub"])
@pytest.mark.parametrize("mr,nc", BFP_PANELS)
def test_blockfp_panel_factor_stages_bit_equal(cuda, mr, nc, hub):
    """B4a in stages: the panel's words and the (flip, sigma) control words,
    in step order, bit-equal to its plain version, on a strided view of a
    wider buffer that stays untouched outside the panel, at the default
    tile_b and at 1 and 4 (ragged)."""
    rng = np.random.default_rng(110 + mr + nc + hub)
    piv, tgt, col = ops.panel_steps(mr, nc)
    kw = dict(iters=24, hub=hub)
    for tile_b in (None, 1, 4):
        W = chip_smoke.bfp_words(5, mr + 2, nc + 3, rng, cuda, edge=hub)
        keep = W.clone()
        view = W[:, 2:, 1:1 + nc]
        want = qb.panel_factor_blockfp_reference(view, piv, tgt, col, **kw)
        before = qb.PANEL_FACTOR_BLOCKFP_LAUNCHES
        got = qb.panel_factor_blockfp_call(view, piv, tgt, col, tile_b=tile_b,
                                           **kw)
        torch.cuda.synchronize()
        assert qb.PANEL_FACTOR_BLOCKFP_LAUNCHES == before + 1
        assert got[0] is view
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and torch.equal(g, w)
        keep[:, 2:, 1:1 + nc] = want[0]
        assert torch.equal(W, keep)


#: (B, mr, w, nc) of B4b's stages: a TSQR leaf's first panel (mr 128, w
#: 152), a tree node's (mr 64, w 88), an odd batch, a region narrower than
#: a warp, and a 12-column panel (12 pairs a stage: two chunks of 8).
APPLY_SHAPES = ((6, 128, 152, 8), (6, 64, 88, 8), (5, 64, 88, 8),
                (3, 20, 9, 8), (4, 40, 60, 12))

#: B4b's block shapes besides the wrapper's, (most columns a block,
#: threads a column): one thread a column in blocks of 256 and of 32
#: columns, and a stage's pairs on 2, 4 and 8 threads a column.
APPLY_BLOCKS = ((256, 1), (32, 1), (32, 2), (32, 4), (32, 8))


def _apply_operands(B, mr, w, nc, rng, device, hub):
    """The panel steps of an mr x nc panel, random (B, S) control words and
    a wider (B, mr + 1, nc + w + 2) buffer whose region [1:, nc:nc + w] is
    the trailing block."""
    piv, tgt, _ = ops.panel_steps(mr, nc)
    S = len(piv)
    flip = torch.tensor(rng.integers(0, 2, size=(B, S)), dtype=torch.int32,
                        device=device)
    sig = torch.tensor(rng.integers(0, 2 ** 30, size=(B, S)),
                       dtype=torch.int32, device=device)
    W = chip_smoke.bfp_words(B, mr + 1, nc + w + 2, rng, device, edge=hub)
    return piv, tgt, flip, sig, W


def _apply_table(piv, tgt, mr, device):
    """B4b's cached stage table of the panel steps (the wrapper's)."""
    return qb._panel_stage_table((qb._host_table(piv), qb._host_table(tgt)),
                                 None, mr, 0, str(device))


def _apply_checked(launch, W, want, nc, w, what):
    """One B4b launch on the region of a copy of ``W``: the region equals
    ``want``, the rest of the buffer is untouched."""
    X = W.clone()
    before = qb.PANEL_APPLY_BLOCKFP_LAUNCHES
    launch(X[:, 1:, nc:nc + w])
    torch.cuda.synchronize()
    assert qb.PANEL_APPLY_BLOCKFP_LAUNCHES == before + 1
    keep = W.clone()
    keep[:, 1:, nc:nc + w] = want
    assert torch.equal(X, keep), what


@pytest.mark.parametrize("hub,iters", chip_smoke.BFP_CONFIGS)
def test_panel_apply_blockfp_stages_bit_equal(cuda, hub, iters):
    """B4b in stages, bit-equal to its plain version on a strided view of a
    wider buffer that stays untouched outside the region, at the shapes of
    `APPLY_SHAPES`, through its wrapper and at each of `APPLY_BLOCKS`
    (`qb._panel_apply_blockfp_launch`); one launch each."""
    rng = np.random.default_rng(120 + iters + hub)
    kw = dict(iters=iters, hub=hub)
    args = qb._blockfp_args(iters, hub)
    for B, mr, w, nc in APPLY_SHAPES:
        piv, tgt, flip, sig, W = _apply_operands(B, mr, w, nc, rng, cuda, hub)
        want = qb.panel_apply_blockfp_reference(W[:, 1:, nc:nc + w], piv, tgt,
                                                flip, sig, **kw)
        table = _apply_table(piv, tgt, mr, cuda)
        _apply_checked(lambda T: qb.panel_apply_blockfp_call(
            T, piv, tgt, flip, sig, **kw), W, want, nc, w, (B, mr, w, nc))
        for cols, slots in APPLY_BLOCKS:
            _apply_checked(lambda T: qb._panel_apply_blockfp_launch(
                T, table, flip, sig, args, cols, slots), W, want, nc, w,
                (B, mr, w, nc, cols, slots))


def _stage_replay(T, table, flip, sig, iters, hub):
    """The plain replay in the stages of ``table``, a stage's pairs (on
    disjoint rows) in one `cg.fused_replay` call each, their control words
    gathered at the pairs' step indices."""
    T = T.clone()
    comp = cg.comp_q30(iters)
    for k, j, _, st in table.cpu().transpose(0, 1):
        live = st >= 0
        k, j, st = k[live], j[live], st[live]
        T[:, k], T[:, j] = cg.fused_replay(T[:, k], T[:, j], flip[:, st],
                                           sig[:, st], iters=iters, hub=hub,
                                           comp=comp)
    return T


@pytest.mark.parametrize("hub,iters", chip_smoke.BFP_CONFIGS)
def test_panel_apply_blockfp_stage_records_in_windows(cuda, hub, iters):
    """A 256-row panel of 128 columns (tile_m 256, panel_n 128) has 382
    stages of up to 128 pairs: their records (393 KB) exceed shared memory,
    so B4b stages them in windows beside the columns.  Through its wrapper
    (8 threads a column at this batch) and at one thread a column, whose
    300 columns take two blocks cut to shared memory, it is bit-equal to
    the plain replay in stages, which equals the step order on a small
    panel here (`tests/test_torch_panel_stages.py` holds it on the CPU)."""
    rng = np.random.default_rng(140 + iters + hub)
    kw = dict(iters=iters, hub=hub)
    piv, tgt, flip, sig, W = _apply_operands(2, 20, 9, 8, rng, cuda, hub)
    table = _apply_table(piv, tgt, 20, cuda)
    assert torch.equal(_stage_replay(W, table, flip, sig, **kw)[:, :20],
                       qb.panel_apply_blockfp_reference(W[:, :20], piv, tgt,
                                                        flip, sig, **kw))
    B, mr, w, nc = 2, 256, 300, 128
    piv, tgt, flip, sig, W = _apply_operands(B, mr, w, nc, rng, cuda, hub)
    table = _apply_table(piv, tgt, mr, cuda)
    stages, pairs = table.shape[1:]
    assert (stages, pairs) == (382, 128)
    assert stages * (8 * pairs + 4) > qb.MAX_SHARED_BYTES
    want = _stage_replay(W[:, 1:, nc:nc + w], table, flip, sig, **kw)
    _apply_checked(lambda T: qb.panel_apply_blockfp_call(
        T, piv, tgt, flip, sig, **kw), W, want, nc, w, "wrapper")
    _apply_checked(lambda T: qb._panel_apply_blockfp_launch(
        T, table, flip, sig, qb._blockfp_args(iters, hub), 256, 1), W, want,
        nc, w, "one thread a column")


def test_packed_wavefront_on_flat_kernel_widened_and_in_device_memory(
        cuda, monkeypatch):
    """B5a runs B1's kernel on the caller's Sameh–Kuck stages with their
    item ends: at 32 x 32 with Q on a batch of 3, the wrapper's threads a
    matrix widened past its `FLAT_THREADS` entry (`_flat_threads`), at
    other block shapes, and with its tiles in device memory, bit-equal to
    its plain version and to B1 on the flattened stages; one B5a launch a
    call and none of B1's."""
    cfg = CONFIGS[2]
    tabs = chip_smoke.stage_tables(32, 32)
    P = chip_smoke.encoded_words(cfg, 3, 32, 32, True,
                                 np.random.default_rng(130), cuda)
    want = qb.qr_packed_wavefront_reference(P, *tabs, cfg=cfg)
    assert torch.equal(qb.qr_packed_call(P, cfg=cfg,
                                         steps=chip_smoke.flat_order(32, 32)),
                       want)
    table = qb._wavefront_table(qb._stage_key(*tabs), 32, 64, str(cuda))
    threads = qb._flat_threads("qr_packed_wavefront", table.shape[2], 64, 3,
                               None, str(cuda))
    assert threads > qb.FLAT_THREADS["qr_packed_wavefront"]
    calls = [lambda: qb.qr_packed_wavefront_call(P, *tabs, cfg=cfg)]
    calls += [lambda tb=tb, th=th: qb._qr_packed_launch(
        P, table, cfg, tb, th, "qr_packed_wavefront")
        for tb, th in ((1, 32), (2, 64), (4, 256))]
    for shared_bytes in (qb.MAX_SHARED_BYTES, 0):          # 0: device memory
        monkeypatch.setattr(qb, "MAX_SHARED_BYTES", shared_bytes)
        for call in calls:
            before = (qb.QR_PACKED_WAVEFRONT_LAUNCHES, qb.QR_PACKED_LAUNCHES)
            got = call()
            torch.cuda.synchronize()
            assert (qb.QR_PACKED_WAVEFRONT_LAUNCHES,
                    qb.QR_PACKED_LAUNCHES) == (before[0] + 1, before[1])
            assert torch.equal(got, want)


def test_wavefront_and_complex_device_memory_tiles_at_128(cuda):
    """At 128 x 128 with Q the packed wavefront tile (256 KiB) and the
    complex tiles (512 KiB) exceed shared memory and live in device memory:
    the wavefront equals the flat kernel on the flattened stages, and the
    complex wavefront the complex flat kernel."""
    rng = np.random.default_rng(70)
    cfg = CONFIGS[2]
    tabs = chip_smoke.stage_tables(128, 128)
    flat = chip_smoke.flat_order(128, 128)
    P = chip_smoke.encoded_words(cfg, 3, 128, 128, True, rng, cuda)
    assert P[0].numel() * 8 > qb.MAX_SHARED_BYTES
    assert torch.equal(qb.qr_packed_wavefront_call(P, *tabs, cfg=cfg),
                       qb.qr_packed_call(P, cfg=cfg, steps=flat))
    C = chip_smoke.complex_words(cfg, 2, 128, 128, True, rng, cuda)
    assert torch.equal(qb.qr_packed_complex_wavefront_call(C, *tabs, cfg=cfg),
                       qb.qr_packed_complex_call(C, cfg=cfg, steps=flat))


def test_wavefront_and_complex_device_memory_mode(cuda, monkeypatch):
    """The device-memory mode against the plain versions at a small shape,
    forced by lowering the shared-memory limit."""
    monkeypatch.setattr(qb, "MAX_SHARED_BYTES", 0)
    rng = np.random.default_rng(71)
    cfg = CONFIGS[0]
    tabs = chip_smoke.stage_tables(12, 6)
    for tile_b in (1, 2):
        P = chip_smoke.edge_words(cfg, 5, 12, 18, rng, cuda)
        chip_smoke.check_plain("qr_packed_wavefront", qb.qr_packed_wavefront_call,
                               qb.qr_packed_wavefront_reference, P, *tabs,
                               cfg=cfg, tile_b=tile_b)
        C = chip_smoke.complex_words(cfg, 5, 12, 6, True, rng, cuda, True)
        chip_smoke.check_plain("qr_packed_complex", qb.qr_packed_complex_call,
                               qb.qr_packed_complex_reference, C, cfg=cfg,
                               steps=givens_schedule(12, 6), tile_b=tile_b)
        chip_smoke.check_plain("qr_packed_complex_wavefront",
                               qb.qr_packed_complex_wavefront_call,
                               qb.qr_packed_complex_wavefront_reference, C,
                               *tabs, cfg=cfg, tile_b=tile_b)


def test_wavefront_and_complex_engines_on_gpu_equal_cpu(cuda):
    A = np.random.default_rng(72).normal(size=(5, 6, 4))
    C = A + 1j * np.random.default_rng(73).normal(size=(5, 6, 4))
    g = chip_smoke.GivensConfig(hub=True, n=26)
    for backend, X, kw in (("cordic_pallas", A, dict(schedule="sameh_kuck")),
                           ("blockfp_pallas", A, dict(schedule="sameh_kuck")),
                           ("cordic_pallas", C, dict(dtype="complex128")),
                           ("cordic_pallas", C, dict(dtype="complex128",
                                                     schedule="sameh_kuck"))):
        kw.setdefault("dtype", "float64")
        Qg, Rg = QRDEngine(backend=backend, givens=g, **kw)(X)
        Qc, Rc = QRDEngine(backend=backend, givens=g, device="cpu", **kw)(X)
        assert Qg.device.type == "cuda"
        assert torch.equal(Qg.cpu(), Qc) and torch.equal(Rg.cpu(), Rc)


def _rotator_launches():
    return (cg.VECTORING_LAUNCHES, cg.ROTATION_LAUNCHES, cg.FUSED_LAUNCHES)


#: (hub, iters) of the rotator's bit-equality test: its first three
#: cases, then every other depth of `ROT_ITERS` and 1 and 2, which reach
#: the multiply-add micro-rotation's first two steps alone, both ways.
ROTATOR_CASES = [(True, 24), (False, 30), (True, 8)] + [
    (hub, iters) for iters in (1, 2) + chip_smoke.ROT_ITERS
    for hub in (False, True) if (hub, iters) not in
    ((True, 24), (False, 30), (True, 8))]


def _counted(counter, call, launches):
    """``call()``, holding that it added ``launches`` to ``cg.<counter>``."""
    before = getattr(cg, counter)
    out = call()
    torch.cuda.synchronize()
    assert getattr(cg, counter) == before + launches
    return out


def _rotation_views(X, sentinel):
    """The (B, L = W - 1) rotation operands of the (2, B, W) rows X, each
    with outputs of its own layout in a buffer filled with ``sentinel``:
    {name: ((x, y), (xo, yo), buffer, the buffer's words outside the
    outputs)}.  Contiguous rows; the ``x[:, 1:]`` views of the rows, as
    `ops.givens_rotate_rows_fixed` passes them (a base one word past a
    16-byte boundary); views of an odd row stride."""
    _, B, W = X.shape
    L = W - 1
    S = L + 1 if L % 2 == 0 else L + 2
    C = X[..., 1:].contiguous()
    V = torch.zeros((2, B, S), dtype=torch.int32, device=X.device)
    V[..., :L] = C
    views = {}
    for name, src, shape, cols in (("rows", C, (2, B, L), slice(0, L)),
                                   ("x[:, 1:]", X[..., 1:], (2, B, W),
                                    slice(1, W)),
                                   ("odd stride", V[..., :L], (2, B, S),
                                    slice(0, L))):
        buf = torch.full(shape, sentinel, dtype=torch.int32, device=X.device)
        outside = torch.ones(shape, dtype=torch.bool, device=X.device)
        outside[..., cols] = False
        views[name] = ((src[0], src[1]), (buf[0][..., cols], buf[1][..., cols]),
                       buf, outside)
    return views


def _check_rotator_layouts(device, hub, iters, rng):
    """B6a on column 0 of the rows (strided, into column 0 of an output)
    and on contiguous lead pairs, and B6b through its wrapper and at every
    count of `cg.ROTATION_THREADS` threads a row on `_rotation_views`, rows
    of `ROT_WIDTHS` less 1 words, each bit-equal to its plain version; B6b
    writes no word outside its outputs.  One launch a call, none for an
    empty operand."""
    kw = dict(iters=iters, hub=hub)
    args = cg._rotator_args(iters, hub)
    for B, W in itertools.product(chip_smoke.ROT_BATCHES,
                                  chip_smoke.ROT_WIDTHS):
        for edge in (False, True):
            X = chip_smoke.rotator_rows(B, W, rng, device, edge)
            want_v = cg.vectoring_reference(X[0][:, 0], X[1][:, 0], **kw)
            lead = X[:, :, 0].contiguous()
            O = torch.zeros_like(X)
            for what, (x, y), out in (
                    ("column 0", (X[0][:, 0], X[1][:, 0]),
                     (O[0][:, 0], O[1][:, 0])),
                    ("contiguous", (lead[0], lead[1]), None)):
                got = _counted("VECTORING_LAUNCHES", lambda: cg.vectoring_call(
                    x, y, out=out, **kw), 1)
                chip_smoke.compare(f"vectoring B={B} W={W} {what} "
                                   f"edge={edge}", got, want_v)
            assert torch.count_nonzero(O[..., 1:]) == 0
            flip, sig = want_v[2], want_v[3]
            want = cg.rotation_reference(X[0][:, 1:], X[1][:, 1:], flip, sig,
                                         **kw)
            for view, ((x, y), out, buf, outside) in _rotation_views(
                    X, -12345).items():
                for threads in (None,) + cg.ROTATION_THREADS:
                    buf.fill_(-12345)
                    call = (lambda: cg.rotation_call(x, y, flip, sig, out=out,
                                                     **kw)) if threads is None \
                        else (lambda: cg._rotation_launch(x, y, flip, sig, args,
                                                          threads, out))
                    _counted("ROTATION_LAUNCHES", call, int(W > 1))
                    what = (f"rotation B={B} W={W} {view} {threads} threads "
                            f"edge={edge}")
                    chip_smoke.compare(what, out, want)
                    assert bool((buf[outside] == -12345).all()), what


@pytest.mark.parametrize("hub,iters", ROTATOR_CASES)
def test_rotator_kernels_bit_equal_to_plain_versions(cuda, hub, iters):
    """B6a, B6b and B6c against their plain versions (and the fixed row API
    against the fused one), random and edge words, ragged shapes; then B6a
    on strided and contiguous lead pairs and B6b at each layout it is
    compiled for (`_check_rotator_layouts`)."""
    rng = np.random.default_rng(iters)
    before = _rotator_launches()
    for B, W in ((1, 2), (7, 5), (33, 130), (257, 9), (4099, 3)):
        for edge in (False, True):
            X = chip_smoke.rotator_rows(B, W, rng, cuda, edge)
            chip_smoke.check_rotator(X[0], X[1], dict(iters=iters, hub=hub),
                                     f"B={B} W={W} edge={edge}")
    torch.cuda.synchronize()
    # per case: vectoring 2 (alone and in the fixed API), rotation 2, fused 1
    assert tuple(b + n for b, n in zip(before, (20, 20, 10))) == \
        _rotator_launches()
    _check_rotator_layouts(cuda, hub, iters, rng)
    with pytest.raises(ValueError, match="layout"):
        cg._rotation_launch(X[0], X[1], *cg.vectoring_call(
            X[0][:, 0], X[1][:, 0], iters=iters, hub=hub)[2:],
            cg._rotator_args(iters, hub), 3)


def _fused_views(X, device):
    """The (B, W) row pairs of X as the fused kernel may get them: the
    contiguous rows, and copies seen through views whose base (offset by
    one word) or row stride (W + 1) is not 16-byte aligned."""
    _, B, W = X.shape
    Z = torch.zeros((2, B, W + 5), dtype=torch.int32, device=device)
    Z[..., 1:1 + W] = X
    V = torch.zeros((2, B, W + 1), dtype=torch.int32, device=device)
    V[..., :W] = X
    return {"rows": (X[0], X[1]), "offset base": (Z[0, :, 1:1 + W],
                                                  Z[1, :, 1:1 + W]),
            "odd stride": (V[0, :, :W], V[1, :, :W])}


@pytest.mark.parametrize("iters", chip_smoke.ROT_ITERS)
@pytest.mark.parametrize("hub", [False, True], ids=["conv", "hub"])
def test_fused_kernel_layouts_bit_equal(cuda, hub, iters):
    """B6c bit-equal to `cg.fused_reference` on every (B, W) of
    `ROT_BATCHES` x `ROT_WIDTHS`, random and edge words (`ROT_EDGE`),
    through its wrapper and at every layout of `cg.FUSED_LAYOUTS` that
    takes the row (32 threads a row in several tiles where W exceeds one),
    on contiguous rows (16-byte vectors where W is a multiple of 4) and on
    row views whose base or row stride is not 16-byte aligned (single
    words); one launch a call."""
    rng = np.random.default_rng(160 + iters + hub)
    kw = dict(iters=iters, hub=hub)
    args = cg._rotator_args(iters, hub)
    for B, W in itertools.product(chip_smoke.ROT_BATCHES,
                                  chip_smoke.ROT_WIDTHS):
        layouts = [(T, K) for T, K in cg.FUSED_LAYOUTS
                   if W <= T * K or T == 32]
        for edge in (False, True):
            X = chip_smoke.rotator_rows(B, W, rng, cuda, edge)
            want = cg.fused_reference(X[0], X[1], **kw)
            for view, (x, y) in _fused_views(X, cuda).items():
                out = torch.empty_like(x)
                assert cg._fused_vectors((x, y, out, out)) == (
                    view == "rows" and W % 4 == 0)
                calls = [lambda: cg.fused_call(x, y, **kw)] + [
                    lambda T=T, K=K: cg._fused_launch(x, y, args, T, K)
                    for T, K in layouts]
                for call in calls:
                    before = cg.FUSED_LAUNCHES
                    got = call()
                    torch.cuda.synchronize()
                    assert cg.FUSED_LAUNCHES == before + 1
                    for g, w in zip(got, want):
                        assert torch.equal(g, w), (B, W, edge, view)
    with pytest.raises(ValueError, match="layout"):
        cg._fused_launch(X[0], X[1], args, 16, 8)        # W 1025 > 16 x 8


def test_rotator_empty_operands(cuda):
    """B = 0 launches nothing; rows of one element launch the vectoring
    kernel and no rotation (its operand is (B, 0))."""
    kw = dict(iters=24, hub=True)
    X = chip_smoke.rotator_rows(0, 4, np.random.default_rng(0), cuda)
    before = _rotator_launches()
    a = ops.givens_rotate_rows_fixed(X[0], X[1], **kw)
    b = ops.givens_rotate_rows_fused(X[0], X[1], **kw)
    assert _rotator_launches() == before
    assert a[0].shape == b[0].shape == (0, 4)
    X = chip_smoke.rotator_rows(9, 1, np.random.default_rng(1), cuda)
    a = ops.givens_rotate_rows_fixed(X[0], X[1], **kw)
    b = ops.givens_rotate_rows_fused(X[0], X[1], **kw)
    torch.cuda.synchronize()
    assert _rotator_launches() == (before[0] + 1, before[1], before[2] + 1)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    chip_smoke.compare("rows of one element", a,
                       cg.fused_reference(X[0], X[1], **kw))


def test_rotator_row_api_on_gpu_equals_cpu(cuda):
    """The row API on the card (int64 operands wrapped to int32, rows with
    a non-unit column stride made contiguous) equals it on the CPU."""
    rng = np.random.default_rng(5)
    X = rng.integers(-2 ** 33, 2 ** 33, size=(2, 40, 17))
    kw = dict(iters=28, hub=False)
    for fn in (ops.givens_rotate_rows_fixed, ops.givens_rotate_rows_fused):
        got = fn(torch.tensor(X[0], device=cuda), torch.tensor(X[1], device=cuda),
                 **kw)
        want = fn(torch.tensor(X[0]), torch.tensor(X[1]), **kw)
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and torch.equal(g.cpu(), w)
        # column-major rows: (40, 17) views with strides (1, 40)
        T = torch.tensor(X.transpose(0, 2, 1).astype(np.int32), device=cuda)
        got = fn(T[0].transpose(0, 1), T[1].transpose(0, 1), **kw)
        for g, w in zip(got, fn(torch.tensor(X[0]), torch.tensor(X[1]), **kw)):
            assert torch.equal(g.cpu(), w)


def test_rotator_row_api_puts_numpy_operands_on_the_card(cuda):
    """numpy operands run on the card by default and launch the kernels;
    device='cpu' runs the plain versions, with the same words."""
    X = np.random.default_rng(6).integers(-2 ** 25, 2 ** 25, size=(2, 33, 9))
    kw = dict(iters=24, hub=True)
    for fn, launches in ((ops.givens_rotate_rows_fixed, (1, 1, 0)),
                         (ops.givens_rotate_rows_fused, (0, 0, 1))):
        before = _rotator_launches()
        got = fn(X[0], X[1], **kw)
        torch.cuda.synchronize()
        assert _rotator_launches() == tuple(
            b + n for b, n in zip(before, launches))
        want = fn(X[0], X[1], device="cpu", **kw)
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and w.device.type == "cpu"
            assert torch.equal(g.cpu(), w)


#: The lane kernels' configurations: IEEE trunc and HUB at N = 26, and HUB
#: at N = 50, the widest N, where the lanes' exact ilog2 and the int64
#: kernels' must still agree.
LANE_CONFIGS = [CONFIGS[0], CONFIGS[2], chip_smoke.GivensConfig(hub=True, n=50)]


@pytest.mark.parametrize("i", range(len(LANE_CONFIGS)))
def test_lane_kernels_bit_equal_to_plain_versions(cuda, i):
    """B8a and B8b against their plain versions, and through
    `lanes_to_packed` against B1 and B5a on the same words; B8b also
    against B8a on the flattened stages."""
    cfg = LANE_CONFIGS[i]
    rng = np.random.default_rng(80 + i)
    before = (qb.QR_PACKED_LANES_LAUNCHES, qb.QR_PACKED_LANES_WAVEFRONT_LAUNCHES)
    for (m, n, cq) in ((4, 4, True), (3, 5, False), (6, 3, True)):
        e = n + (m if cq else 0)
        tabs = chip_smoke.stage_tables(m, n)
        P = torch.cat([chip_smoke.encoded_words(cfg, 8, m, n, cq, rng, cuda),
                       chip_smoke.edge_words(cfg, 8, m, e, rng, cuda)])
        L = cg.packed_to_lanes(P)
        flat = chip_smoke.check_plain(
            "qr_packed_lanes", qb.qr_packed_lanes_call,
            qb.qr_packed_lanes_reference, L, cfg=cfg,
            steps=givens_schedule(m, n))
        assert torch.equal(cg.lanes_to_packed(flat), qb.qr_packed_call(
            P, cfg=cfg, steps=givens_schedule(m, n)))
        wave = chip_smoke.check_plain(
            "qr_packed_lanes_wavefront", qb.qr_packed_lanes_wavefront_call,
            qb.qr_packed_lanes_wavefront_reference, L, *tabs, cfg=cfg,
            table_layout=qb.TABLE_LAYOUTS[m % 2])
        assert torch.equal(cg.lanes_to_packed(wave),
                           qb.qr_packed_wavefront_call(P, *tabs, cfg=cfg))
        assert torch.equal(wave, qb.qr_packed_lanes_call(
            L, cfg=cfg, steps=chip_smoke.flat_order(m, n)))
    assert qb.QR_PACKED_LANES_LAUNCHES == before[0] + 6
    assert qb.QR_PACKED_LANES_WAVEFRONT_LAUNCHES == before[1] + 3


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "device"])
def test_lane_kernels_ragged_batch_and_tile_modes(cuda, monkeypatch, shared):
    """Ragged batches in blocks of 1, 2 and 4, with the tiles in shared
    memory and (the limit lowered) in device memory."""
    if not shared:
        monkeypatch.setattr(qb, "MAX_SHARED_BYTES", 0)
    cfg = CONFIGS[3]
    L = cg.packed_to_lanes(chip_smoke.edge_words(
        cfg, 5, 6, 10, np.random.default_rng(85), cuda))
    for tile_b in (1, 2, 4):
        chip_smoke.check_plain("qr_packed_lanes", qb.qr_packed_lanes_call,
                               qb.qr_packed_lanes_reference, L, cfg=cfg,
                               steps=givens_schedule(6, 4), tile_b=tile_b)
        chip_smoke.check_plain("qr_packed_lanes_wavefront",
                               qb.qr_packed_lanes_wavefront_call,
                               qb.qr_packed_lanes_wavefront_reference, L,
                               *chip_smoke.stage_tables(6, 4), cfg=cfg,
                               tile_b=tile_b)


def test_lanes_route_at_128_and_through_ops(cuda):
    """At 128 x 128 with Q the lane tile (256 KiB) lives in device memory
    and equals B1 and B5a; `ops.qr_packed` and `ops.qr_packed_wavefront`
    with ``lanes=True`` give the int64 route's words."""
    cfg = CONFIGS[2]
    rng = np.random.default_rng(86)
    P = chip_smoke.encoded_words(cfg, 2, 128, 128, True, rng, cuda)
    L = cg.packed_to_lanes(P)
    assert L[0].numel() * 4 > qb.MAX_SHARED_BYTES
    steps, tabs = givens_schedule(128, 128), chip_smoke.stage_tables(128, 128)
    assert torch.equal(cg.lanes_to_packed(qb.qr_packed_lanes_call(
        L, cfg=cfg, steps=steps)), qb.qr_packed_call(P, cfg=cfg, steps=steps))
    assert torch.equal(cg.lanes_to_packed(qb.qr_packed_lanes_wavefront_call(
        L, *tabs, cfg=cfg)), qb.qr_packed_wavefront_call(P, *tabs, cfg=cfg))
    P = chip_smoke.encoded_words(cfg, 7, 8, 6, True, rng, cuda)
    before = qb.QR_PACKED_LANES_LAUNCHES
    got = ops.qr_packed(P, cfg=cfg, steps=givens_schedule(8, 6), lanes=True)
    assert qb.QR_PACKED_LANES_LAUNCHES == before + 1
    assert torch.equal(got, ops.qr_packed(P, cfg=cfg,
                                          steps=givens_schedule(8, 6)))
    stages = chip_smoke.sameh_kuck_schedule(8, 6)
    assert torch.equal(ops.qr_packed_wavefront(P, cfg=cfg, stages=stages,
                                               lanes=True),
                       ops.qr_packed_wavefront(P, cfg=cfg, stages=stages))


def test_qr_cordic_overrides_on_gpu_equal_cpu(cuda):
    """`qr_cordic` with the N / iters overrides (its plain loop, on the
    card) gives the CPU's words; the JAX package's are held on the CPU."""
    A = np.random.default_rng(87).normal(size=(3, 4, 4))
    unit = GivensUnit(CONFIGS[2])
    Qg, Rg = qr_cordic(torch.tensor(A, device=cuda), unit, N=28, iters=22)
    Qc, Rc = qr_cordic(torch.tensor(A), unit, N=28, iters=22)
    assert Qg.device.type == "cuda"
    assert torch.equal(Qg.cpu(), Qc) and torch.equal(Rg.cpu(), Rc)
    Qp, _ = qr_cordic(torch.tensor(A, device=cuda), unit, None, None)
    assert Qp is not None and not torch.equal(Qp.cpu(), Qc)


# ---------------------------------------------------------------------------
# Panels beyond a block's shared memory: the panel factors B3a and B4a work
# on them in device memory
# ---------------------------------------------------------------------------
_TALL_HOST = {}


def _tall_host_tree(lane, A, i):
    """`tsqr_host_reference` of matrix ``i`` of `chip_smoke.tall_operand`
    on `chip_smoke.tall_node_qr`, cached across the tests."""
    if (lane, i) not in _TALL_HOST:
        _TALL_HOST[lane, i] = tsqr_host_reference(
            A[i], chip_smoke.tall_node_qr(lane), chip_smoke.TALL_TILE_M)
    return _TALL_HOST[lane, i]


@pytest.mark.parametrize("compute_q", [True, False], ids=["q", "r-only"])
@pytest.mark.parametrize("lane", ["packed", "blockfp"])
def test_tsqr_route_at_tile_m_4096(cuda, lane, compute_q):
    """The TSQR route at tile_m 4096 (packed panel_n 8, block-FP panel_n
    16), whose leaf panels exceed a block's shared memory, on a batch of 2
    8192 x 32 matrices: R bit-equal to the host tree, Q within 1e-12 of it
    (the TSQR paths' limit)."""
    A = torch.tensor(chip_smoke.tall_operand(), device=cuda)
    eng = chip_smoke.lane_engine(lane, cuda, tiling="tsqr",
                                 tile_m=chip_smoke.TALL_TILE_M,
                                 panel_n=chip_smoke.TALL_PANEL_N[lane])
    Q, R = eng(A, compute_q=compute_q)
    torch.cuda.synchronize()
    B, _, n = A.shape
    assert R.shape == (B, n, n)
    assert (Q is None) == (not compute_q)
    for i in range(B):
        Qr, Rr = _tall_host_tree(lane, A, i)
        assert torch.equal(R[i].view(torch.int64), Rr.view(torch.int64))
        if compute_q:
            assert (Q[i] - Qr).abs().max().item() <= 1e-12


#: (mr, nc) of the panel factors' device-memory mode: a panel with more
#: rows than columns, a TSQR tree node's first panel, and one with more
#: columns than rows.
DEVICE_PANELS = ((12, 6), (64, 8), (5, 9))


@pytest.mark.parametrize("lane", ["packed", "blockfp"])
@pytest.mark.parametrize("mr,nc", DEVICE_PANELS)
def test_panel_factors_in_device_memory(cuda, monkeypatch, lane, mr, nc):
    """B3a and B4a with their panels in device memory (forced by lowering
    `MAX_SHARED_BYTES` below one panel) on a strided view of a wider
    buffer, at the default tile_b and at 1 and 3 (ragged): the words and
    control words bit-equal to the shared-memory mode's and the plain
    version's, the buffer untouched outside the panel; one launch each."""
    rng = np.random.default_rng(150 + mr + nc)
    piv, tgt, col = ops.panel_steps(mr, nc)
    if lane == "packed":
        cfg = CONFIGS[2]
        W = chip_smoke.encoded_words(cfg, 5, mr + 2, nc + 3, False, rng, cuda)
        kw = dict(cfg=cfg)
        call, ref = qb.panel_factor_packed_call, qb.panel_factor_packed_reference
        count, word = "PANEL_FACTOR_LAUNCHES", 8
    else:
        W = chip_smoke.bfp_words(5, mr + 2, nc + 3, rng, cuda, edge=True)
        kw = dict(iters=24, hub=True)
        call = qb.panel_factor_blockfp_call
        ref = qb.panel_factor_blockfp_reference
        count, word = "PANEL_FACTOR_BLOCKFP_LAUNCHES", 4
    want = ref(W[:, 2:, 1:1 + nc], piv, tgt, col, **kw)
    keep = W.clone()
    keep[:, 2:, 1:1 + nc] = want[0]
    pairs = ops.panel_stages(mr, nc)[1].shape[1]
    threads = qb._stage_threads(pairs, nc)
    full = qb.MAX_SHARED_BYTES
    for device in (False, True):
        monkeypatch.setattr(qb, "MAX_SHARED_BYTES",
                            (mr * nc + 2 * pairs) * word - 1 if device else full)
        for tile_b in (None, 1, 3):
            assert qb._panel_tile("", tile_b, threads, mr, nc, W.stride(1),
                                  pairs, word)[1] == device
            X = W.clone()
            before = getattr(qb, count)
            got = call(X[:, 2:, 1:1 + nc], piv, tgt, col, tile_b=tile_b, **kw)
            torch.cuda.synchronize()
            assert getattr(qb, count) == before + 1
            for g, w in zip(got, want):
                assert torch.equal(g, w), (device, tile_b)
            assert torch.equal(X, keep)
