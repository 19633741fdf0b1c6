"""The port's API surface on the CPU: configuration round-trips with the JAX
package, routing decides as the JAX package does, the failure paths of
what is not ported yet, and import hygiene (no JAX, no `repro`)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import qrd as japi
from repro.core import qrd as jq
from repro.core.formats import HALF as JHALF
from repro.core.givens import GivensConfig as JConfig
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
    sk = tapi.QRDEngine(backend="cordic_pallas", schedule="sameh_kuck",
                        dtype="float64", device="cpu")
    with pytest.raises(NotImplementedError, match="B5"):
        sk(np.eye(4))
    with pytest.raises(NotImplementedError, match="B7"):
        eng(np.eye(4) * (1 + 1j))
    # streaming RLS is ported (ROADMAP A6): the cordic family updates on
    # the bit-accurate unit, on the engine's device
    st = eng.rls(4)
    assert isinstance(st, tapi.RLSState)
    assert (st.mode, st.device.type) == ("unit", "cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        eng.fleet(2, 4)
    with pytest.raises(NotImplementedError, match="A12"):
        tapi.QRDEngine(backend="cordic", device="cpu", mesh=object())
    # the block-FP lane is ported (ROADMAP A5, kernels B2/B4); its
    # wavefront schedule is not (A8, kernel B5)
    bfp = tapi.QRDEngine(backend="blockfp_pallas", device="cpu")
    assert bfp.capabilities.max_shape == (128, 128)
    with pytest.raises(NotImplementedError, match="B5"):
        tapi.QRDEngine(backend="blockfp_pallas", schedule="sameh_kuck",
                       device="cpu")(np.eye(4))
    for name in ("jnp", "givens_float", "fixed"):
        with pytest.raises(ValueError, match="unknown backend"):
            tapi.QRDEngine(backend=name, device="cpu")


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
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout
