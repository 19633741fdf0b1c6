"""The port's API surface on the CPU: configuration round-trips with the JAX
package, routing decides as the JAX package does, the failure paths of
what is not ported yet (and the JAX package's results where a path has
been ported since), and import hygiene (no JAX, no `repro`)."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import qrd as japi
from repro.core import qrd as jq
from repro.core.formats import HALF as JHALF
from repro.core.givens import GivensConfig as JConfig
from repro.core.givens import GivensUnit as JUnit
from repro.kernels import cordic_givens as jcg
from repro.kernels import ops as jops
from repro.kernels import qrd_blocked as jqb
from repro.qrd import tiled as jtiled

from repro_torch import qrd as tapi
from repro_torch.core import qrd as tq
from repro_torch.kernels import _build
from repro_torch.kernels import qrd_blocked as tqb
from repro_torch.qrd import tiled as ttiled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_CONFIGS = [
    japi.QRDConfig(),
    japi.QRDConfig(backend="cordic_pallas", dtype="float64",
                   givens=JConfig(hub=True, n=26)),
    japi.QRDConfig(backend="cordic", schedule="sameh_kuck", dtype="complex64",
                   givens=JConfig(fmt=JHALF, n=13, iters=11,
                                  input_rounding="rne"),
                   tile_b=4, tiling="flat", interpret=True, panel_n=8),
    japi.QRDConfig(backend="cordic_pallas", dtype="float64", tiling="tsqr",
                   tile_m=64, panel_n=4),
]


@pytest.mark.parametrize("i", range(len(JAX_CONFIGS)))
def test_config_json_round_trips_between_packages(i):
    jcfg = JAX_CONFIGS[i]
    tcfg = tapi.QRDConfig.from_json(jcfg.to_json())
    assert tcfg.as_dict() == jcfg.as_dict()
    back = japi.QRDConfig.from_json(tcfg.to_json())
    assert back == jcfg
    assert tcfg.to_json() == jcfg.to_json()


def test_config_normalizes_torch_and_numpy_dtypes():
    assert tapi.QRDConfig(dtype=torch.float64).dtype == "float64"
    assert tapi.QRDConfig(dtype=np.complex64).dtype == "complex64"
    with pytest.raises(TypeError):
        tapi.QRDConfig(dtype=object())


def test_schedules_equal_jax():
    for m, n in ((2, 2), (5, 4), (3, 6), (8, 8), (32, 32), (32, 17)):
        assert tq.givens_schedule(m, n) == jq.givens_schedule(m, n)
        assert tq.sameh_kuck_schedule(m, n) == jq.sameh_kuck_schedule(m, n)


def test_route_table_equal_jax():
    """`resolve_route` decides (or refuses) exactly as the JAX package."""
    jcaps = japi.get_backend("cordic_pallas").capabilities
    tcaps = tapi.get_backend("cordic_pallas").capabilities
    for name in ("cordic", "cordic_pallas"):
        assert dataclasses.asdict(tapi.get_backend(name).capabilities) == \
            dataclasses.asdict(japi.get_backend(name).capabilities)
    for tiling in japi.QRDConfig.TILINGS:
        for schedule in ("col", "sameh_kuck"):
            for m, n in ((4, 4), (32, 32), (33, 8), (64, 64), (4096, 32),
                         (128, 128), (129, 129), (200, 100)):
                kw = dict(backend="cordic_pallas", tiling=tiling,
                          schedule=schedule, dtype="float64")
                try:
                    want = jtiled.resolve_route(japi.QRDConfig(**kw), m, n,
                                                jcaps)
                except ValueError as e:
                    want = ("error", str(e))
                try:
                    got = ttiled.resolve_route(tapi.QRDConfig(**kw), m, n,
                                               tcaps)
                except ValueError as e:
                    got = ("error", str(e))
                assert got == want, (tiling, schedule, m, n)


def test_engine_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.QRDEngine(backend="cordic_pallas")
    with pytest.raises(RuntimeError):
        tapi.QRDEngine()
    assert tapi.QRDEngine(backend="cordic", device="cpu").device.type == "cpu"


class _Ref:
    """A stand-in for a Pallas ref, so a JAX kernel body runs outside
    Pallas."""

    def __init__(self, v=None):
        self.v = v

    def __getitem__(self, idx):
        return self.v

    def __setitem__(self, idx, v):
        self.v = v


def _jax_stage_body(kernel, X, stages, m, **kw):
    """A JAX wavefront kernel body on X over ``stages``, jitted whole (one
    small compile; no Pallas interpret mode)."""
    def run(X, piv, tgt, col):
        out = _Ref()
        kernel(_Ref(piv), _Ref(tgt), _Ref(col), _Ref(X), out,
               S=piv.shape[0], table_layout="split", **kw)
        return out.v
    tables = jops._stage_tables(stages, m)
    return jax.jit(run)(jnp.asarray(X), *(jnp.asarray(t) for t in tables))


def _bits_equal(want, got):
    want = np.ascontiguousarray(np.asarray(want))
    got = np.ascontiguousarray(got.resolve_conj().numpy())
    assert want.shape == got.shape and want.dtype == got.dtype
    np.testing.assert_array_equal(want.view(np.int64), got.view(np.int64))


def test_unported_paths_raise():
    eng = tapi.QRDEngine(backend="cordic_pallas", dtype="float64",
                         device="cpu")
    # the panel route is ported (ROADMAP A7): bit-equal to the flat route
    A = np.random.default_rng(1).normal(size=(6, 5))
    panel = tapi.QRDEngine(backend="cordic_pallas", dtype="float64",
                           device="cpu", tiling="panel", panel_n=2)(A)
    for got, want in zip(panel, eng(A)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="max_shape"):
        eng(np.ones((200, 200)))
    # the wavefront (ROADMAP A8, kernel B5a) and the complex datapath (A9,
    # kernel B7a) are ported: the JAX package's Q and R, from its encode,
    # kernel body, decode and split
    eye = np.eye(4)[None]                    # the kernels take a batch axis
    ju = JUnit(JConfig())
    sk = tapi.QRDEngine(backend="cordic_pallas", schedule="sameh_kuck",
                        dtype="float64", device="cpu")
    words = _jax_stage_body(jqb._qr_packed_wavefront_kernel,
                            ju.encode(jq._augment(jnp.asarray(eye), True)),
                            jq.sameh_kuck_schedule(4, 4), 4, cfg=ju.cfg)
    for want, got in zip(jq._split_qr(ju.decode(words), 4, 4, True), sk(eye)):
        _bits_equal(want, got)
    C = eye * (1 + 1j)
    words = _jax_stage_body(
        jqb._qr_packed_complex_wavefront_kernel,
        jq._encode_complex(ju, jq._augment_complex(jnp.asarray(C), True)),
        tuple((s,) for s in jq.givens_schedule(4, 4)), 4, cfg=ju.cfg)
    want = jq._split_qr_complex(jq._decode_complex(ju, words), 4, 4, True)
    for want, got in zip(want, eng(C)):
        _bits_equal(want, got)
    # streaming RLS is ported (ROADMAP A6): the cordic family updates on
    # the bit-accurate unit, on the engine's device
    st = eng.rls(4)
    assert isinstance(st, tapi.RLSState)
    assert (st.mode, st.device.type) == ("unit", "cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        eng.fleet(2, 4)
    with pytest.raises(NotImplementedError, match="A12"):
        tapi.QRDEngine(backend="cordic", device="cpu", mesh=object())
    # the block-FP lane is ported (ROADMAP A5, kernels B2/B4), and its
    # wavefront schedule (A8, kernel B5b): the JAX package's Q and R
    bfp = tapi.QRDEngine(backend="blockfp_pallas", device="cpu")
    assert bfp.capabilities.max_shape == (128, 128)
    iters = bfp.config.blockfp_iters()
    X, ex = jops._blockfp_encode(jq._augment(jnp.asarray(eye), True), 24)
    words = _jax_stage_body(jqb._qr_blockfp_wavefront_kernel, X,
                            jq.sameh_kuck_schedule(4, 4), 4, iters=iters,
                            hub=False, comp=jcg.comp_q30(iters))
    want = jq._split_qr(jops._blockfp_decode(words, ex, 24), 4, 4, True)
    got = tapi.QRDEngine(backend="blockfp_pallas", schedule="sameh_kuck",
                         device="cpu")(eye)
    for want, got in zip(want, got):
        _bits_equal(want, got)
    # the baselines are ported (ROADMAP A2): the JAX package's Q and R,
    # 'fixed' to the bit, the float baselines within float64 rounding
    for name in ("jnp", "givens_float", "fixed"):
        got = tapi.QRDEngine(backend=name, dtype="float64", device="cpu")(eye)
        want = japi.QRDEngine(backend=name, dtype="float64")(eye)
        for w, g in zip(want, got):
            if name == "fixed":
                _bits_equal(w, g)
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=0, atol=1e-12)


def test_host_loop_takes_the_flattened_sameh_kuck_order():
    eng = tapi.QRDEngine(backend="cordic", schedule="sameh_kuck",
                         dtype="float64", device="cpu")
    A = np.random.default_rng(2).normal(size=(2, 5, 4))
    Q, R = eng(A)
    np.testing.assert_allclose((Q @ R).numpy(), A, atol=1e-5)
    assert torch.count_nonzero(torch.tril(R, -1)) == 0


def test_kernel_wrapper_on_cpu_runs_the_plain_version():
    cfg = tapi.QRDConfig().givens
    P = torch.zeros((3, 4, 8), dtype=torch.int64)
    steps = tq.givens_schedule(4, 4)
    before = tqb.QR_PACKED_LAUNCHES
    out = tqb.qr_packed_call(P, cfg=cfg, steps=steps)
    assert torch.equal(out, tqb.qr_packed_reference(P, cfg=cfg, steps=steps))
    assert tqb.QR_PACKED_LAUNCHES == before
    with pytest.raises(ValueError):
        tqb.qr_packed_call(P.to("meta"), cfg=cfg, steps=steps)


def test_kernel_params_carry_the_host_gain_constant():
    from repro.core import cordic as jc
    cfg = tapi.QRDConfig().givens
    kp = tqb.kernel_params(cfg)
    assert kp["p"] == min(78 - (cfg.n + 2), 46)
    assert kp["comp"] == int(jc.gain_comp_constant(cfg.resolved_iters(),
                                                   kp["p"]))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        f"sys.path[:0] = [{os.path.join(REPO, 'src')!r}, {REPO!r}]\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels\n"
        "import repro_torch.qrd, chip_smoke\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'examples')!r})\n"
        "import torch_quickstart\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout
