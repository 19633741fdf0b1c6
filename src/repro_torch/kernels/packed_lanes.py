"""The unit on dual-int32 lanes (torch port of `repro.kernels.packed_lanes`):
the plain PyTorch version of kernels B8a/B8b (``csrc/packed_lanes.cu``,
device functions in ``csrc/lane_unit.cuh``).

A packed int64 word ``p`` travels as two int32 lanes stacked on a trailing
axis of size 2 (`repro_torch.kernels.cordic_givens.packed_to_lanes`)::

    L[..., 0] = hi = int32(p >> 32)
    L[..., 1] = lo = int32(p & 0xFFFFFFFF)

and the whole unit (input converter, CORDIC, gain compensation, output
converter) is re-expressed as 64-bit arithmetic on ``(hi, lo)`` pairs of
32-bit halves.  Every primitive computes the exact low 64 bits of its
int64 counterpart; shift counts are clamped to [0, 63] as the JAX
package's are; `ilog2_64` is an exact integer search.  `LaneUnit` is
bit-identical to the JAX package's `LaneUnit`, and through
`lanes_to_packed` to `repro_torch.core.givens.GivensUnit`.

How the halves are held here: PyTorch's uint32 tensors have no add,
subtract, compare or shift, so inside this module each half is an int64
tensor holding a value in [0, 2^32) (or a Python int for a constant).
Sums are masked with ``& 0xFFFFFFFF`` and the carry read from bit 32;
left shifts mask the bits that leave the half before shifting, so no
value leaves [0, 2^63); products are taken in 16-bit digits as
`_mul32x32` does, so none exceeds 2^32.  The stacked (..., 2) storage is
int32, as in the JAX package.  ``N`` and ``iters`` are static Python ints:
the micro-rotation loops are Python loops.
"""
from __future__ import annotations

import torch

from repro_torch.core.cordic import gain_comp_constant, gain_shift
from repro_torch.core.givens import GivensConfig

__all__ = ["LaneUnit", "lanes_stack", "lanes_unstack", "u64", "from_i32",
           "add64", "sub64", "not64", "neg64", "and64", "or64", "xor64",
           "eq64", "ltu64", "is_neg64", "where64", "shl64", "shr64", "sar64",
           "mul64", "ilog2_32", "ilog2_64", "rshift_rne64"]

_M32 = 0xFFFFFFFF


# -- lane word construction ---------------------------------------------------

def u64(v: int):
    """Python int -> (hi, lo) pair of Python ints (two's complement)."""
    return (v >> 32) & _M32, v & _M32


def lanes_unstack(L):
    """Stacked int32 (..., 2) lane word -> (hi, lo) halves in [0, 2^32)."""
    L = L.to(torch.int64)
    return L[..., 0] & _M32, L[..., 1] & _M32


def _to_i32(h):
    """A half in [0, 2^32) -> int32 with the same bits."""
    return ((h ^ 0x80000000) - 0x80000000).to(torch.int32)


def lanes_stack(pair):
    """(hi, lo) halves -> stacked int32 (..., 2) lane word."""
    h, l = pair
    if not torch.is_tensor(h):
        h = torch.full_like(l, h)
    if not torch.is_tensor(l):
        l = torch.full_like(h, l)
    h, l = torch.broadcast_tensors(h, l)
    return torch.stack([_to_i32(h), _to_i32(l)], dim=-1)


def from_i32(x):
    """Sign-extend small signed integers (an integer tensor) to a pair."""
    x = x.to(torch.int64)
    return (x >> 31) & _M32, x & _M32


def _low(x):
    """Nonnegative small integers -> pair with a zero high half."""
    return 0, x


# -- 64-bit integer primitives over (hi, lo) pairs ----------------------------

def add64(a, b):
    l = a[1] + b[1]
    return (a[0] + b[0] + (l >> 32)) & _M32, l & _M32


def sub64(a, b):
    l = a[1] - b[1]                     # l >> 32 is -1 on a borrow, else 0
    return (a[0] - b[0] + (l >> 32)) & _M32, l & _M32


def not64(a):
    return a[0] ^ _M32, a[1] ^ _M32


def neg64(a):
    return add64(not64(a), (0, 1))


def and64(a, b):
    return a[0] & b[0], a[1] & b[1]


def or64(a, b):
    return a[0] | b[0], a[1] | b[1]


def xor64(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def eq64(a, b):
    return (a[0] == b[0]) & (a[1] == b[1])


def ltu64(a, b):
    """Unsigned a < b."""
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def is_neg64(a):
    return a[0] >= 0x80000000


def where64(cond, a, b):
    return torch.where(cond, a[0], b[0]), torch.where(cond, a[1], b[1])


def _signed(h):
    """The high half read as a signed int32 value."""
    return (h ^ 0x80000000) - 0x80000000


def _shl32(x, s):
    """(x << s) mod 2^32 for a half x and a count s in [0, 31]."""
    return (x & (_M32 >> s)) << s


def _shift_norm(s):
    """A shift count (Python int or integer tensor) clamped to [0, 63]."""
    if isinstance(s, int):
        return min(max(s, 0), 63)
    return s.to(torch.int64).clamp(0, 63)


def shl64(v, s):
    h, l = v
    s = _shift_norm(s)
    if isinstance(s, int):
        if s >= 32:
            return _shl32(l, s - 32), 0
        return _shl32(h, s) | (l >> (32 - s)), _shl32(l, s)
    s_lo = s.clamp(max=31)
    h_small = _shl32(h, s_lo) | (l >> (32 - s_lo))   # l >> 32 is 0 at s == 0
    l_small = _shl32(l, s_lo)
    sb = (s - 32).clamp(0, 31)
    big = s >= 32
    return (torch.where(big, _shl32(l, sb), h_small),
            torch.where(big, 0, l_small))


def shr64(v, s):
    """Logical (zero-fill) right shift."""
    h, l = v
    s = _shift_norm(s)
    if isinstance(s, int):
        if s >= 32:
            return 0, h >> (s - 32)
        return h >> s, (l >> s) | _shl32(h, 32 - s) if s else l
    s_lo = s.clamp(max=31)
    cross = (h & (_M32 >> (32 - s_lo))) << (32 - s_lo)   # 0 at s == 0
    l_small = (l >> s_lo) | cross
    h_small = h >> s_lo
    sb = (s - 32).clamp(0, 31)
    big = s >= 32
    return torch.where(big, 0, h_small), torch.where(big, h >> sb, l_small)


def sar64(v, s):
    """Arithmetic (sign-fill) right shift."""
    h, l = v
    hs = _signed(h)
    s = _shift_norm(s)
    if isinstance(s, int):
        if s >= 32:
            return (hs >> 31) & _M32, (hs >> (s - 32)) & _M32
        return ((hs >> s) & _M32,
                (l >> s) | _shl32(h, 32 - s) if s else l)
    s_lo = s.clamp(max=31)
    cross = (h & (_M32 >> (32 - s_lo))) << (32 - s_lo)
    l_small = (l >> s_lo) | cross
    h_small = (hs >> s_lo) & _M32
    sb = (s - 32).clamp(0, 31)
    big = s >= 32
    return (torch.where(big, (hs >> 31) & _M32, h_small),
            torch.where(big, (hs >> sb) & _M32, l_small))


def _mul32x32(x, y):
    """Exact x * y of two halves -> (hi, lo) pair, via 16-bit digits."""
    m16 = 0xFFFF
    x0, x1 = x & m16, x >> 16
    y0, y1 = y & m16, y >> 16
    p00 = x0 * y0
    p01 = x0 * y1
    p10 = x1 * y0
    p11 = x1 * y1
    mid = (p00 >> 16) + (p01 & m16) + (p10 & m16)      # < 2^18
    lo = (p00 & m16) | ((mid & m16) << 16)
    hi = p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)
    return hi, lo


def mul64(a, b):
    """Low 64 bits of the product (signed == unsigned mod 2^64); the cross
    terms keep only their low 32 bits, each from `_mul32x32`."""
    ah, al = a
    bh, bl = b
    hi, lo = _mul32x32(al, bl)
    cross = _mul32x32(al, bh)[1] + _mul32x32(ah, bl)[1]
    return (hi + cross) & _M32, lo


def ilog2_32(u):
    """floor(log2(u)) for a half u >= 1 (0 for u == 0), pure integer."""
    r = torch.where(u > 0xFFFF, 16, 0)
    u = u >> r
    s = torch.where(u > 0xFF, 8, 0)
    u = u >> s
    r = r + s
    s = torch.where(u > 0xF, 4, 0)
    u = u >> s
    r = r + s
    s = torch.where(u > 0x3, 2, 0)
    u = u >> s
    r = r + s
    return r + torch.where(u > 0x1, 1, 0)


def ilog2_64(v):
    """floor(log2(v)) for a positive pair."""
    h, l = v
    use_hi = h != 0
    k = ilog2_32(torch.where(use_hi, h, l))
    return torch.where(use_hi, k + 32, k)


def rshift_rne64(v, sh):
    """Arithmetic right shift with round-to-nearest-even on the dropped
    bits; ``sh`` (a tensor) is clamped to [0, 63]."""
    sh = sh.clamp(min=0)
    q = sar64(v, sh)
    rem = sub64(v, shl64(q, sh))
    half = shl64((0, 1), (sh - 1).clamp(min=0))
    half = where64(sh > 0, half, (0, 0))
    round_up = ((ltu64(half, rem) | (eq64(rem, half) & ((q[1] & 1) == 1)))
                & (sh > 0))
    return add64(q, (0, round_up.to(torch.int64)))


# -- converter datapath (lane mirror of repro_torch.core.converters) ----------

def _unpack(p, fmt):
    man = and64(p, u64((1 << fmt.man_bits) - 1))
    exp_raw = shr64(p, fmt.man_bits)[1] & ((1 << fmt.exp_bits) - 1)
    sign = shr64(p, fmt.exp_bits + fmt.man_bits)[1] & 1
    return sign, exp_raw, man


def _align(xfix, yfix, ex, ey, N, round_mode):
    d_xy = ex - ey
    x_is_low = d_xy < 0
    sh = d_xy.abs()
    lo = where64(x_is_low, xfix, yfix)
    if round_mode == "rne":
        lo_sh = rshift_rne64(lo, sh)
    else:  # 'trunc' and 'hub': plain arithmetic shift
        lo_sh = sar64(lo, sh.clamp(max=62))
    lo_sh = where64(sh >= N + 2, (0, 0), lo_sh)
    xout = where64(x_is_low, lo_sh, xfix)
    yout = where64(x_is_low, yfix, lo_sh)
    return xout, yout, torch.maximum(ex, ey)


def _expand_ieee(sign, exp_raw, man, fmt, N):
    is_zero = exp_raw == 0
    k_ext = N - 2 - fmt.man_bits
    mag = shl64(or64(man, u64(1 << fmt.man_bits)), k_ext)
    mag = where64(is_zero, (0, 0), mag)
    return where64(sign == 1, neg64(mag), mag)


def _expand_hub(sign, exp_raw, man, fmt, N, unbiased: bool,
                detect_identity: bool):
    is_zero = exp_raw == 0
    k = N - 2 - fmt.man_bits
    base = shl64(or64(man, u64(1 << fmt.man_bits)), k)
    top = 1 << max(k - 1, 0)
    if unbiased:
        ext = where64((man[1] & 1) == 1, u64(top), u64(top - 1))
    else:
        ext = u64(top)
    if k <= 0:
        ext = (0, 0)
    if detect_identity:
        is_one = (exp_raw == fmt.bias) & eq64(man, (0, 0))
        ext = where64(is_one, (0, 0), ext)
    mag = or64(base, ext)
    mag = where64(is_zero, (0, 0), mag)
    # HUB negation: pure bit inversion (the ILSB absorbs the +1).
    return where64(sign == 1, not64(mag), mag)


def _input_convert(xp, yp, cfg: GivensConfig, N):
    fmt = cfg.fmt
    sx, ex, mx = _unpack(xp, fmt)
    sy, ey, my = _unpack(yp, fmt)
    if cfg.hub:
        xf = _expand_hub(sx, ex, mx, fmt, N, cfg.unbiased, cfg.detect_identity)
        yf = _expand_hub(sy, ey, my, fmt, N, cfg.unbiased, cfg.detect_identity)
        return _align(xf, yf, ex, ey, N, "hub")
    xf = _expand_ieee(sx, ex, mx, fmt, N)
    yf = _expand_ieee(sy, ey, my, fmt, N)
    return _align(xf, yf, ex, ey, N, cfg.input_rounding)


def _saturate_pack(sign, exp_new, man, fmt, flush_zero):
    overflow = exp_new > fmt.max_exp_raw
    exp_out = exp_new.clamp(1, fmt.max_exp_raw)
    man = where64(overflow, u64((1 << fmt.man_bits) - 1), man)
    packed = or64(shl64(_low(sign), fmt.exp_bits + fmt.man_bits),
                  or64(shl64(_low(exp_out), fmt.man_bits), man))
    underflow = (exp_new <= 0) | flush_zero
    szero = shl64(_low(sign), fmt.exp_bits + fmt.man_bits)
    return where64(underflow, szero, packed)


def _output_ieee(v, m_exp, fmt, N):
    neg = is_neg64(v)
    sign = neg.to(torch.int64)
    a = where64(neg, neg64(v), v)
    is_zero = eq64(a, (0, 0))
    a_safe = where64(is_zero, (0, 1), a)
    k = ilog2_64(a_safe)
    m = fmt.man_bits
    down = (k - m).clamp(min=0)
    up = (m - k).clamp(min=0)
    q = shl64(rshift_rne64(a_safe, down), up)
    carry = _signed(shr64(q, m + 1)[1])           # 0 or 1, read as int32
    q = where64(carry > 0, sar64(q, 1), q)
    k = k + carry
    man = sub64(q, u64(1 << m))
    exp_new = m_exp + k - (N - 2)
    return _saturate_pack(sign, exp_new, man, fmt, is_zero)


def _output_hub(v, m_exp, fmt, N, unbiased: bool):
    neg = is_neg64(v)
    sign = neg.to(torch.int64)
    stored = where64(neg, not64(v), v)
    A = or64(shl64(stored, 1), (0, 1))            # append the explicit ILSB
    k2 = ilog2_64(A)
    m = fmt.man_bits
    down = (k2 - m).clamp(min=0)
    up = (m - k2).clamp(min=0)
    hi = sar64(A, down)                           # truncation == RN for HUB
    if unbiased:
        lsb = stored[1] & 1
        one = shl64((0, 1), (up - 1).clamp(min=0))
        fill = where64(lsb == 1, one, sub64(one, (0, 1)))
        fill = where64(up > 0, fill, (0, 0))
    else:
        fill = (0, 0)
    q = or64(shl64(hi, up), fill)
    man = sub64(q, u64(1 << m))
    exp_new = m_exp + (k2 - 1) - (N - 2)
    return _saturate_pack(sign, exp_new, man, fmt, torch.zeros_like(neg))


def _output_convert(v, m_exp, cfg: GivensConfig, N):
    if cfg.hub:
        return _output_hub(v, m_exp, cfg.fmt, N, cfg.unbiased)
    return _output_ieee(v, m_exp, cfg.fmt, N)


# -- CORDIC core (lane mirror of repro_torch.core.cordic) ---------------------

def _negate_fx(v, hub: bool):
    return not64(v) if hub else neg64(v)


def _carry_bit(y, i: int):
    """HUB carry-in: ILSB (1) at i == 0, else bit (i-1) of the pre-shift y."""
    if i == 0:
        return 1
    return sar64(y, i - 1)[1] & 1


def _microrotation(x, y, i: int, d_pos, hub: bool):
    ys = sar64(y, i)
    xs = sar64(x, i)
    if hub:
        cy = _carry_bit(y, i)
        cx = _carry_bit(x, i)
        x_sub = add64(add64(x, not64(ys)), _low(1 - cy))   # x - (y>>i)
        x_add = add64(add64(x, ys), _low(cy))              # x + (y>>i)
        y_add = add64(add64(y, xs), _low(cx))              # y + (x>>i)
        y_sub = add64(add64(y, not64(xs)), _low(1 - cx))   # y - (x>>i)
    else:
        x_sub = sub64(x, ys)
        x_add = add64(x, ys)
        y_add = add64(y, xs)
        y_sub = sub64(y, xs)
    return where64(d_pos, x_sub, x_add), where64(d_pos, y_add, y_sub)


def _vectoring(x, y, iters: int, hub: bool):
    flip = is_neg64(x).to(torch.int64)
    x = where64(flip == 1, _negate_fx(x, hub), x)
    y = where64(flip == 1, _negate_fx(y, hub), y)
    sig = (0, 0)
    for i in range(iters):
        d_pos = is_neg64(y)
        x, y = _microrotation(x, y, i, d_pos, hub)
        sig = or64(sig, shl64((0, d_pos.to(torch.int64)), i))
    return x, y, flip, sig


def _rotation(x, y, flip, sig, iters: int, hub: bool):
    x = where64(flip == 1, _negate_fx(x, hub), x)
    y = where64(flip == 1, _negate_fx(y, hub), y)
    for i in range(iters):
        d_pos = (shr64(sig, i)[1] & 1) == 1
        x, y = _microrotation(x, y, i, d_pos, hub)
    return x, y


def _fixmul(v, comp: int, p: int, round_nearest: bool):
    """Lane mirror of `cordic.fixmul` with a constant comp."""
    v_lo = and64(v, (0, 0xFFFF))
    v_hi = sar64(v, 16)
    comp_p = u64(comp)
    acc = add64(mul64(v_hi, comp_p), sar64(mul64(v_lo, comp_p), 16))
    sh = p - 16
    if round_nearest:
        acc = add64(acc, u64(1 << (sh - 1)))
    return sar64(acc, sh)


def _apply_gain(x, y, iters: int, w: int, hub: bool):
    p = gain_shift(w)
    comp = gain_comp_constant(iters, p)
    rn = not hub
    return _fixmul(x, comp, p, rn), _fixmul(y, comp, p, rn)


# -- the unit -----------------------------------------------------------------

class LaneUnit:
    """Lane-pair mirror of `repro_torch.core.givens.GivensUnit`.

    All methods operate on *stacked* lane words: int32 tensors with a
    trailing axis of size 2 holding the (hi, lo) halves of each packed
    int64 word, on any device.  The rotation state is ``(flip, sig)`` with
    ``flip`` an int64 0/1 tensor and ``sig`` a stacked lane word (the sigma
    bitmask needs up to iters <= 48 bits).  Bit-identical to `GivensUnit`
    on the int64 packing of the same words; the config's ``N`` and
    ``iters`` only.
    """

    def __init__(self, config: GivensConfig):
        config.validate()
        self.cfg = config

    def vector(self, xp, yp):
        cfg = self.cfg
        N, iters = cfg.n, cfg.resolved_iters()
        x, y = lanes_unstack(xp), lanes_unstack(yp)
        xf, yf, m_exp = _input_convert(x, y, cfg, N)
        xr, yr, flip, sig = _vectoring(xf, yf, iters, cfg.hub)
        xr, yr = _apply_gain(xr, yr, iters, N + 2, cfg.hub)
        return (lanes_stack(_output_convert(xr, m_exp, cfg, N)),
                lanes_stack(_output_convert(yr, m_exp, cfg, N)),
                (flip, lanes_stack(sig)))

    def rotate(self, xp, yp, state):
        cfg = self.cfg
        N, iters = cfg.n, cfg.resolved_iters()
        flip, sig = state
        x, y = lanes_unstack(xp), lanes_unstack(yp)
        xf, yf, m_exp = _input_convert(x, y, cfg, N)
        xr, yr = _rotation(xf, yf, flip, lanes_unstack(sig), iters, cfg.hub)
        xr, yr = _apply_gain(xr, yr, iters, N + 2, cfg.hub)
        return (lanes_stack(_output_convert(xr, m_exp, cfg, N)),
                lanes_stack(_output_convert(yr, m_exp, cfg, N)))

    def rotate_rows(self, row_x, row_y):
        """Rotate two stacked-lane rows (..., e, 2); vectoring on element 0."""
        rx0, ry0, (flip, sig) = self.vector(row_x[..., 0, :],
                                            row_y[..., 0, :])
        rx, ry = self.rotate(row_x[..., 1:, :], row_y[..., 1:, :],
                             (flip[..., None], sig[..., None, :]))
        return (torch.cat([rx0[..., None, :], rx], dim=-2),
                torch.cat([ry0[..., None, :], ry], dim=-2))
