"""The standalone rotator's row API of the port (`repro_torch.kernels.ops`
`vectoring_fixed`, `rotation_fixed`, `givens_rotate_rows_fixed`,
`givens_rotate_rows_fused`; kernels B6a/B6b/B6c) on the CPU, where each
wrapper runs its plain version, against the JAX package.

Two references, both held to the bit:
* the pure-jnp oracle `repro.kernels.ref` (`vectoring_ref`,
  `rotation_ref`), run eagerly once per (iters, hub) on the widest rows:
  each row pair's result depends on that row pair alone, so every tested
  (B, L) is a corner of it (the grid of `tests/test_kernels.py`: every
  shape at iters 24, every depth on the widest rows);
* the JAX Pallas kernels themselves, in interpret mode, at two small
  shapes, one per path (each interpret compile costs one to two seconds
  here).
Inputs are significands as `tests/test_kernels.py` makes them, with edge
words mixed in (0, +-1, +-(2^29 - 1), INT32_MIN, INT32_MAX), which wrap as
XLA's int32 does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cordic_givens as jcg
from repro.kernels import ops as jops
from repro.kernels import ref

from repro_torch.kernels import cordic_givens as tcg
from repro_torch.kernels import ops as tops

EDGE = np.array([0, 1, -1, 2 ** 29 - 1, -(2 ** 29 - 1), -2 ** 31, 2 ** 31 - 1],
                np.int64)
BATCHES = (1, 7, 8, 33)
WIDTHS = (1, 2, 6, 129, 301)        # row widths, lead pair included


def rows(B, W, seed, edge=0.25):
    """(2, B, W) int64 significands, uniform(-1.9, 1.9) * 2^24 with a share
    ``edge`` of edge words."""
    rng = np.random.default_rng(seed)
    X = np.rint(rng.uniform(-1.9, 1.9, size=(2, B, W)) * 2.0 ** 24)
    X = X.astype(np.int64)
    mask = rng.random(X.shape) < edge
    X[mask] = rng.choice(EDGE, size=int(mask.sum()))
    return X


def oracle(X, *, iters, hub):
    """`repro.kernels.ref` on int32 rows: the rotated rows and the lead
    pairs' vectoring outputs, as numpy."""
    x, y = jnp.asarray(X[0].astype(np.int32)), jnp.asarray(X[1].astype(np.int32))
    xl, yl, fl, sg = ref.vectoring_ref(x[:, 0], y[:, 0], iters=iters, hub=hub)
    xo, yo = ref.rotation_ref(x[:, 1:], y[:, 1:], fl[:, None], sg[:, None],
                              iters=iters, hub=hub)
    ex = np.concatenate([np.asarray(xl)[:, None], np.asarray(xo)], axis=1)
    ey = np.concatenate([np.asarray(yl)[:, None], np.asarray(yo)], axis=1)
    return ex, ey, np.asarray(fl), np.asarray(sg)


def equal(got, want):
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def check_rows(X, B, W, ex, ey, kw):
    """The fixed and fused row API on the corner (B, W) of X: int64
    operands wrap to int32 as ``.astype(jnp.int32)`` does."""
    X64 = torch.tensor(X[:, :B, :W])
    fixed = tops.givens_rotate_rows_fixed(X64[0], X64[1], **kw)
    X32 = X64.to(torch.int32)
    fused = tops.givens_rotate_rows_fused(X32[0], X32[1], **kw)
    for got in (fixed, fused):
        equal(got[0], ex[:B, :W])
        equal(got[1], ey[:B, :W])


def check_kernels(X, ex, ey, fl, sg, kw):
    """`vectoring_fixed` and `rotation_fixed`, each alone, on whole rows."""
    x, y = torch.tensor(X.astype(np.int32))
    xr, yr, flip, sig = tops.vectoring_fixed(x[:, 0], y[:, 0], **kw)
    for got, want in zip((xr, yr, flip, sig), (ex[:, 0], ey[:, 0], fl, sg)):
        equal(got, want)
    rx, ry = tops.rotation_fixed(x[:, 1:], y[:, 1:], flip, sig, **kw)
    equal(rx, ex[:, 1:])
    equal(ry, ey[:, 1:])


@pytest.mark.parametrize("hub", [False, True], ids=["conv", "hub"])
def test_row_api_bit_equal_to_jax_oracle_on_every_shape(hub):
    """Every (B, W) of the grid, at the paper's depth (iters 24)."""
    X = rows(max(BATCHES), max(WIDTHS), seed=24 + 100 * hub)
    kw = dict(iters=24, hub=hub)
    ex, ey, fl, sg = oracle(X, **kw)
    for B in BATCHES:
        for W in WIDTHS:
            check_rows(X, B, W, ex, ey, kw)
    check_kernels(X, ex, ey, fl, sg, kw)


@pytest.mark.parametrize("hub", [False, True], ids=["conv", "hub"])
@pytest.mark.parametrize("iters", [8, 16, 28, 30])
def test_row_api_bit_equal_to_jax_oracle_at_every_depth(iters, hub):
    """The CORDIC depths of the sweep on the widest rows."""
    X = rows(max(BATCHES), max(WIDTHS), seed=iters + 100 * hub)
    kw = dict(iters=iters, hub=hub)
    ex, ey, fl, sg = oracle(X, **kw)
    check_rows(X, max(BATCHES), max(WIDTHS), ex, ey, kw)
    check_kernels(X, ex, ey, fl, sg, kw)


@pytest.mark.parametrize("fn,B,W,iters,hub", [
    ("givens_rotate_rows_fixed", 3, 130, 8, False),
    ("givens_rotate_rows_fused", 9, 6, 12, True)])
def test_row_api_bit_equal_to_pallas_kernels(fn, B, W, iters, hub):
    """The JAX Pallas kernels in interpret mode against the port: B6a + B6b
    through `givens_rotate_rows_fixed`, B6c through
    `givens_rotate_rows_fused`.  (The JAX package's
    `givens_rotate_rows_fixed` raises on rows of one element, where its
    rotation kernel gets an empty operand; the oracle test above holds the
    port's result there.)  Shallow CORDIC depths keep the interpret-mode
    compile short: the kernels' bodies unroll every micro-rotation, and
    the oracle test sweeps the depths."""
    X = rows(B, W, seed=B * W + iters)
    kw = dict(iters=iters, hub=hub)
    want = getattr(jops, fn)(*(jnp.asarray(X[i].astype(np.int32))
                               for i in (0, 1)), interpret=True, **kw)
    got = getattr(tops, fn)(*(torch.tensor(X[i].astype(np.int32))
                              for i in (0, 1)), **kw)
    for g, w in zip(got, want):
        equal(g, w)


def test_wrappers_on_cpu_run_the_plain_versions_and_launch_nothing():
    X = torch.tensor(rows(5, 9, seed=3).astype(np.int32))
    before = (tcg.VECTORING_LAUNCHES, tcg.ROTATION_LAUNCHES,
              tcg.FUSED_LAUNCHES)
    kw = dict(iters=24, hub=True)
    xr, yr, flip, sig = tcg.vectoring_call(X[0, :, 0], X[1, :, 0], **kw)
    want = tcg.vectoring_reference(X[0, :, 0], X[1, :, 0], **kw)
    for g, w in zip((xr, yr, flip, sig), want):
        assert torch.equal(g, w)
    rot = tcg.rotation_call(X[0], X[1], flip, sig, **kw)
    for g, w in zip(rot, tcg.rotation_reference(X[0], X[1], flip, sig, **kw)):
        assert torch.equal(g, w)
    fused = tcg.fused_call(X[0], X[1], **kw)
    for g, w in zip(fused, tcg.fused_reference(X[0], X[1], **kw)):
        assert torch.equal(g, w)
    assert (tcg.VECTORING_LAUNCHES, tcg.ROTATION_LAUNCHES,
            tcg.FUSED_LAUNCHES) == before
    # the vectoring of a lead pair is the lead replayed by its own control
    # word: the fused rows' column 0
    assert torch.equal(fused[0][:, 0], xr) and torch.equal(fused[1][:, 0], yr)
    # writes into caller views (what givens_rotate_rows_fixed does)
    out = torch.zeros((2, 5, 10), dtype=torch.int32)
    tcg.rotation_call(X[0], X[1], flip, sig, out=(out[0, :, 1:], out[1, :, 1:]),
                      **kw)
    assert torch.equal(out[0, :, 1:], rot[0]) and torch.equal(out[1, :, 1:], rot[1])
    assert torch.count_nonzero(out[:, :, 0]) == 0


def test_row_api_runs_numpy_operands_on_the_gpu_unless_told_cpu(monkeypatch):
    """Operands that are not tensors go to the GPU: with no CUDA device the
    call raises and names device='cpu' instead of running the plain
    version; device='cpu' runs it.  A tensor operand keeps its device, and
    array_like control words join it."""
    X = rows(5, 9, seed=4)
    kw = dict(iters=24, hub=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tops.givens_rotate_rows_fixed, tops.givens_rotate_rows_fused):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(X[0], X[1], **kw)
        got = fn(X[0], X[1], device="cpu", **kw)
        want = fn(*torch.tensor(X), **kw)
        for g, w in zip(got, want):
            assert g.device.type == "cpu" and torch.equal(g, w)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tops.vectoring_fixed(X[0, :, 0], X[1, :, 0], **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tops.givens_block_apply(X[0].astype(np.float64), ((0, 1, 0),))
    xr, yr, flip, sig = tops.vectoring_fixed(X[0, :, 0], X[1, :, 0],
                                             device="cpu", **kw)
    x = torch.tensor(X[0, :, 1:])
    rot = tops.rotation_fixed(x, X[1, :, 1:], flip.numpy(), sig.numpy(), **kw)
    assert all(r.device.type == "cpu" for r in rot)
    for g, w in zip((xr, *rot), (want[0][:, 0], want[0][:, 1:], want[1][:, 1:])):
        assert torch.equal(g, w)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((4, 3), dtype=torch.int32)
    flip = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):       # neither CPU nor CUDA
        tcg.fused_call(x.to("meta"), x.to("meta"), iters=24, hub=True)
    with pytest.raises(ValueError):
        tcg.rotation_call(x, x.to("meta"), flip, flip, iters=24, hub=True)
    with pytest.raises(ValueError, match="iters"):
        tops.givens_rotate_rows_fused(x, x, iters=31)


def test_fused_layout_covers_each_row_width():
    """The fused kernel's layout (`_fused_layout`): one thread a row of 8
    or fewer, 8 columns a thread, the fewest threads that cover the row up
    to a warp (wider rows take several tiles), always a compiled one."""
    assert tcg._fused_layout(8) == tcg._fused_layout(1) == (1, 8)
    assert tcg._fused_layout(9) == (2, 8)
    assert tcg._fused_layout(128) == (16, 8)
    assert tcg._fused_layout(129) == tcg._fused_layout(1025) == (32, 8)
    for L in range(1, 600):
        T, K = tcg._fused_layout(L)
        assert (T, K) in tcg.FUSED_LAYOUTS
        assert L <= T * K or T == 32
        assert T == 1 or L > T * K // 2


def test_empty_operands():
    """B = 0 and rows of one element (rotation gets a (B, 0) operand)."""
    for B, W in ((0, 4), (0, 1), (3, 1)):
        X = torch.tensor(rows(B, W, seed=1).astype(np.int32))
        a = tops.givens_rotate_rows_fixed(X[0], X[1], iters=24, hub=True)
        b = tops.givens_rotate_rows_fused(X[0], X[1], iters=24, hub=True)
        for u, v in zip(a, b):
            assert u.shape == (B, W) and torch.equal(u, v)
        rx, _ = tops.rotation_fixed(X[0, :, 1:], X[1, :, 1:],
                                    torch.zeros(B, dtype=torch.int32),
                                    torch.zeros(B, dtype=torch.int32))
        assert rx.shape == (B, W - 1)



def fma_microrotation(x, y, i, d_pos, hub):
    """numpy int32 emulation of the vectoring and rotation kernels'
    micro-rotation as ``csrc/blockfp_unit.cuh`` writes it (`carry_shift`,
    `microrotation_fma`): x + (m | 1) r(y) and y + (~m | 1) r(x), m all ones
    where ``d_pos``, in uint32 arithmetic that wraps as nvcc's does; r(v)
    is v >> i, with HUB v + 1 at i = 0, (v >> 1) + (v & 1) at i = 1 and
    ((v >> (i - 1)) + 1) >> 1 beyond."""
    def carry_shift(v):
        if not hub:
            return v >> i
        if i == 0:
            return v + np.int32(1)
        if i == 1:
            return (v >> 1) + (v & 1)
        return ((v >> (i - 1)) + 1) >> 1

    m = np.where(d_pos, np.int32(-1), np.int32(0))
    u32 = np.uint32
    xn = x.view(u32) + (m | 1).view(u32) * carry_shift(y).view(u32)
    yn = y.view(u32) + (~m | 1).view(u32) * carry_shift(x).view(u32)
    return xn.view(np.int32), yn.view(np.int32)


@pytest.mark.parametrize("i", range(30))
@pytest.mark.parametrize("hub", [False, True], ids=["conv", "hub"])
def test_fma_microrotation_bit_equal_to_jax_microrotation(hub, i):
    """The multiply-add micro-rotation of B6a and B6b, emulated as the CUDA
    source writes it, against the JAX package's `_microrotation`, run
    eagerly: every pair of edge words and random words (significands and
    full-range int32), in both directions, at micro-rotation i.  This holds
    the form of the arithmetic, not the device code: the kernels themselves
    are held to their plain versions by the ``gpu`` test
    `test_rotator_kernels_bit_equal_to_plain_versions`."""
    rng = np.random.default_rng(1000 + i + 100 * hub)
    words = np.concatenate([
        EDGE, np.rint(rng.uniform(-1.9, 1.9, 12) * 2.0 ** 24),
        rng.integers(-2 ** 31, 2 ** 31, 12)]).astype(np.int32)
    x, y, d = (a.ravel() for a in np.meshgrid(words, words, [False, True],
                                              indexing="ij"))
    want = jcg._microrotation(jnp.asarray(x), jnp.asarray(y), i,
                              jnp.asarray(d), hub)
    got = fma_microrotation(x, y, i, d, hub)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_rotation_head_picks_the_16_byte_path():
    """B6b reads whole 16-byte groups where every operand's base lies the
    same number of words past a 16-byte boundary and every row stride is a
    multiple of 4 words (the fixed API's ``x[:, 1:]`` views: one word), else
    single words; its layout covers the row's words from the group start
    at a compiled count of threads a row."""
    X = torch.zeros((2, 5, 8), dtype=torch.int32)
    assert X.data_ptr() % 16 == 0
    rows = (X[0], X[1], X[0], X[1])
    views = tuple(t[:, 1:] for t in rows)
    assert tcg._rotation_head(rows) == 0
    assert tcg._rotation_head(views) == 1
    assert tcg._rotation_head(tuple(t[:, 3:] for t in rows)) == 3
    assert tcg._rotation_head(views[:2] + rows[2:]) is None   # heads differ
    Y = torch.zeros((2, 5, 7), dtype=torch.int32)             # stride 7
    assert tcg._rotation_head((Y[0], Y[1], Y[0], Y[1])) is None
    assert tcg._rotation_head((Y[0, :1],) * 4) == 0             # one row
    for L in range(1, 600):
        for h in range(4):
            assert tcg._fused_layout(L + h)[0] in tcg.ROTATION_THREADS
    assert tcg._fused_layout(7 + 1) == (1, 8)     # rows of 8: one thread
    assert tcg._fused_layout(127 + 1) == (16, 8)  # rows of 128: 16 threads
