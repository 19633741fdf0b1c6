"""The port's rotation unit (`repro_torch.core`) against the JAX package's
(`repro.core`): packed words bit-equal for all 18 paper configurations.

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays.  JAX runs eagerly under ``jax.disable_jit()``: each
configuration would otherwise compile its own program, which costs more
than running it; eager and jitted XLA integer arithmetic agree bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro.analysis.bitflow import config_name, paper_configs
from repro.core import converters as jconv
from repro.core.formats import FloatFormat as JFormat
from repro.core.givens import GivensUnit as JUnit

from repro_torch.core import converters as tconv
from repro_torch.core.formats import FloatFormat as TFormat
from repro_torch.core.givens import GivensConfig as TConfig
from repro_torch.core.givens import GivensUnit as TUnit

CONFIGS = paper_configs()


def _port_config(jc):
    fmt = TFormat(jc.fmt.exp_bits, jc.fmt.man_bits, jc.fmt.name)
    return TConfig(fmt=fmt, n=jc.n, iters=jc.iters, hub=jc.hub,
                   input_rounding=jc.input_rounding, unbiased=jc.unbiased,
                   detect_identity=jc.detect_identity)


def _floats(rng, size):
    """Values over a wide dynamic range plus zeros, ±1.0 and out-of-range."""
    x = rng.normal(size=size) * np.exp2(rng.integers(-40, 40, size=size))
    x[:6] = [0.0, -0.0, 1.0, -1.0, 1e300, -1e-300]
    return x


def _edge_words(jc, rng, size):
    """Packed words: random fields over the whole range, plus exponent gaps
    of N+1, N+2 and >= 64 between the x and y words, zeros, exact 1.0 and
    the largest exponent."""
    fmt = jc.fmt
    sign = rng.integers(0, 2, size=(2, size))
    exp = rng.integers(1, fmt.max_exp_raw + 1, size=(2, size))
    man = rng.integers(0, 1 << fmt.man_bits, size=(2, size))
    top = fmt.max_exp_raw
    for i, gap in enumerate((jc.n + 1, jc.n + 2, 64, 100)):
        exp[:, i] = [top, max(top - gap, 1)]
        exp[:, 4 + i] = [max(top - gap, 1), top]
    exp[0, 8], exp[1, 9] = 0, 0                         # zeros
    exp[:, 10], man[:, 10] = fmt.bias, 0                # exact 1.0
    exp[:, 11] = top                                    # largest exponent
    words = ((sign << (fmt.exp_bits + fmt.man_bits))
             | (exp << fmt.man_bits) | man).astype(np.int64)
    return words[0], words[1]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("jc", CONFIGS, ids=[config_name(c) for c in CONFIGS])
def test_unit_bit_equal_to_jax(jc):
    rng = np.random.default_rng(CONFIGS.index(jc))
    ju, tu = JUnit(jc), TUnit(_port_config(jc))
    fmt_j, fmt_t, N = jc.fmt, tu.cfg.fmt, jc.n
    assert (fmt_t.bias, fmt_t.max_exp_raw) == (fmt_j.bias, fmt_j.max_exp_raw)

    def T(a):
        return torch.tensor(np.asarray(a))
    with jax.disable_jit():
        # codec
        x = _floats(rng, 64)
        px_j = np.asarray(ju.encode(x))
        px_t = tu.encode(T(x))
        _eq(px_j, px_t)
        _eq(ju.decode(px_j), tu.decode(px_t))

        # converters on edge words and encoded values
        wx, wy = _edge_words(jc, rng, 48)
        wx = np.concatenate([wx, px_j[:16]])
        wy = np.concatenate([wy, px_j[16:32]])
        if jc.hub:
            jf = jconv.input_convert_hub(wx, wy, fmt_j, N, jc.unbiased,
                                         jc.detect_identity)
            tf = tconv.input_convert_hub(T(wx), T(wy), fmt_t, N, jc.unbiased,
                                         jc.detect_identity)
        else:
            jf = jconv.input_convert_ieee(wx, wy, fmt_j, N, jc.input_rounding)
            tf = tconv.input_convert_ieee(T(wx), T(wy), fmt_t, N,
                                          jc.input_rounding)
        for a, b in zip(jf, tf):
            _eq(a, b)
        xf, m_exp = np.asarray(jf[0]), np.asarray(jf[2])
        for v in (xf, -xf, xf << 1, xf >> 3):
            if jc.hub:
                jo = jconv.output_convert_hub(v, m_exp, fmt_j, N, jc.unbiased)
                to = tconv.output_convert_hub(T(v), T(m_exp), fmt_t, N,
                                              jc.unbiased)
            else:
                jo = jconv.output_convert_ieee(v, m_exp, fmt_j, N)
                to = tconv.output_convert_ieee(T(v), T(m_exp), fmt_t, N)
            _eq(jo, to)

        # vector / rotate / rotate_rows
        jr, jy, (jflip, jsig) = ju.vector(wx, wy)
        tr, ty, (tflip, tsig) = tu.vector(T(wx), T(wy))
        for a, b in ((jr, tr), (jy, ty), (jflip, tflip), (jsig, tsig)):
            _eq(a, b)
        rows_x = np.stack([wx, np.roll(wx, 1), np.roll(wy, 2)], axis=-1)
        rows_y = np.stack([wy, np.roll(wy, 3), np.roll(wx, 5)], axis=-1)
        state_j = (np.asarray(jflip)[:, None], np.asarray(jsig)[:, None])
        state_t = (tflip[:, None], tsig[:, None])
        for a, b in zip(ju.rotate(rows_x, rows_y, state_j),
                        tu.rotate(T(rows_x), T(rows_y), state_t)):
            _eq(a, b)
        for a, b in zip(ju.rotate_rows(rows_x, rows_y),
                        tu.rotate_rows(T(rows_x), T(rows_y))):
            _eq(a, b)


def test_ilog2_matches_count_leading_zeros():
    """The plain version's float64-frexp ilog2 equals the kernel's
    63 - clz(a) for every a < 2^53 the datapath can produce."""
    rng = np.random.default_rng(5)
    a = np.concatenate([1 << np.arange(53), (1 << np.arange(1, 54)) - 1,
                        rng.integers(1, 1 << 53, size=1000)]).astype(np.int64)
    clz = np.array([63 - (64 - int(v).bit_length()) for v in a])
    np.testing.assert_array_equal(tconv.ilog2(torch.from_numpy(a)).numpy(), clz)


def test_gain_constants_match_jax():
    from repro.core import cordic as jc
    from repro_torch.core import cordic as tc
    np.testing.assert_array_equal(tc.GAIN_TABLE, jc.GAIN_TABLE)
    for iters in (11, 14, 23, 24, 30, 48):
        for w in (15, 18, 28, 34, 52):
            p = tc.gain_shift(w)
            assert tc.gain_comp_constant(iters, p) == int(
                jc.gain_comp_constant(iters, p))


def test_format_layout_matches_jax():
    from repro.core import formats as jf
    from repro_torch.core import formats as tf
    for name in ("HALF", "SINGLE", "DOUBLE"):
        a, b = getattr(jf, name), getattr(tf, name)
        assert isinstance(a, JFormat)
        assert (a.exp_bits, a.man_bits, a.name, a.bias, a.max_exp_raw) == \
            (b.exp_bits, b.man_bits, b.name, b.bias, b.max_exp_raw)
