"""Dual-backend dispatch for occupation functions.

The pure model functions run under ``jit``/``vmap`` on device (jax.numpy)
*and* in the float64 host parity path (numpy).  On this class of host (few
cores), eager jax dispatch pays an XLA compile per unique op, so the host
path must stay in plain numpy.  ``get_namespace`` picks the array namespace
from the input; ``erf`` dispatches between scipy and jax.scipy.
"""

from __future__ import annotations

import numpy as np


def is_numpy(*arrays) -> bool:
    """True if all array arguments are host numpy (no tracers/device arrays)."""
    return all(isinstance(a, (np.ndarray, np.generic, float, int))
               for a in arrays)


def get_namespace(*arrays):
    """Return numpy for host inputs, jax.numpy otherwise."""
    if is_numpy(*arrays):
        return np
    import jax.numpy as jnp
    return jnp


# The float32 device path evaluates erf/erfc with the polynomial below:
# XLA's own float32 erfc carries up to ~3.9e-6 relative error on an
# NVIDIA H100 (2e6 points over [-6, 9] against float64), this one stays
# under ~5e-7.
# Degree-8 Chebyshev fit of erfcx(z) / t in s = (t - mid)/half, where
# t = 2/(2+z), z in [0, 9] (f64 fit rel err 5.4e-8 — below the ~3-ulp
# float32 evaluation noise; the deg-10 fit this truncates reached
# 4.7e-9, buying nothing at f32 while costing 2 Clenshaw iterations on
# the broadcast (batch, nodes) occupation array).  Two
# conditioning choices make the float32 evaluation ~3 ulp (vs ~80 ulp
# for the Horner power-basis fit this replaces):
# * fitting erfcx/t (range [0.56, 1], ratio < 2) instead of erfcx
#   (range [0.12, 1]) keeps the absolute eval-noise floor small
#   RELATIVE to the value;
# * Chebyshev + Clenshaw recurrence avoids the power-basis Horner
#   cancellation (intermediate sums ~5x the result).
_ERFCX_T_MID = 0.5909090909090909       # (2/11 + 1) / 2
_ERFCX_T_HALF = 0.40909090909090906     # (1 - 2/11) / 2
_ERFCX_CHEB = (
    6.25294136305943327e-01,
    3.27537655059554844e-01,
    4.66710137417080811e-02,
    1.14709872925738217e-03,
    -6.32133426496396360e-04,
    -3.11799187735415078e-05,
    1.35700105768268142e-05,
    1.61242924896433125e-07,
    -3.53125074246410366e-07)


# ----------------------------------------------------------------------
# Accurate float32 transcendentals.
#
# The float32 device path uses the compensated implementations below
# (~2-3 ulp; all plain arithmetic + integer bitcasts, so they
# differentiate: the discrete power-of-two scalings are stop_gradient-ed
# and tangents flow through the continuous factors).  Measured on an
# NVIDIA H100 against float64 (2e6 points each), XLA's own float32 exp
# reaches 1.5e-7 relative over [-87, 0] and log1p 2.7e-7 absolute over
# (-1, 4], the same level as these; whether they are still needed is
# open (see ROADMAP.md).
# ----------------------------------------------------------------------
_LN2_HI = 0.693359375                 # 9-bit high part: n * _LN2_HI exact
_LN2_LO = -2.12194440054690583e-4
_INV_LN2 = 1.4426950408889634
_LOG2_10_HI = 3.322265625            # 3402/1024: 12-bit high part of log2(10)
_LOG2_10_LO = -3.375301126376628e-4  # log2(10) - _LOG2_10_HI
_SQRT2 = 1.4142135623730951
# exp(r) degree-6 near-minimax (Chebyshev-fit) poly, |r| <= ln2/2
# (f64 fit rel err 2.6e-9; the deg-7 Taylor it replaces reached ~1e-10,
# below f32 eval noise — one Horner FMA saved on the broadcast array)
_EXP_POLY = (0.0013948580819853334, 0.008375128890561143,
             0.04166621827439628, 0.1666641547723302,
             0.5000000107749375, 1.0000000377274496,
             0.9999999999595486)
# 2^f = exp(f ln2) Taylor in (f ln2), |f| <= 0.52
_ATANH_POLY = (1 / 9., 1 / 7., 1 / 5., 1 / 3., 1.0)  # in s^2; ln m = 2 s P


def _pow2_int(n):
    """Exact 2^n for integer-valued float32 n in [-126, 127] (bitcast)."""
    import jax
    import jax.numpy as jnp
    n = jax.lax.stop_gradient(n)
    biased = (n + 127.0).astype(jnp.int32) << 23
    return jax.lax.stop_gradient(
        jax.lax.bitcast_convert_type(biased, jnp.float32))


def _poly_horner(coefs, r, xp):
    acc = xp.full_like(r, coefs[0])
    for c in coefs[1:]:
        acc = acc * r + c
    return acc


def _exp_f32(x):
    """exp(x) for float32 device arrays, ~2-3 ulp (vs ~80 for XLA's).

    Cody-Waite: n = round(x/ln2); r = (x - n*LN2_HI) - n*LN2_LO (the
    9-bit LN2_HI makes n*LN2_HI exact for |n| < 2^15, and the first
    subtraction is exact because the difference is a small multiple of
    x's ulp); exp(x) = 2^n * P(r) with an exact bitcast 2^n.
    """
    import jax.numpy as jnp
    xp = get_namespace(x)
    n = xp.round(x * _INV_LN2)
    r = (x - n * jnp.float32(_LN2_HI)) - n * jnp.float32(_LN2_LO)
    return _poly_horner(_EXP_POLY, r, xp) * _pow2_int(n)


def _exp10_f32(x):
    """10^x for float32 device arrays, ~2-3 ulp.

    10^x = 2^(x log2 10); the product is formed in double-float32 (x is
    Veltkamp-split so both high products are exact), keeping the reduced
    argument f = x log2 10 - n accurate to ~1e-9.
    """
    import jax.numpy as jnp
    xp = get_namespace(x)
    c = x * jnp.float32(4097.0)
    xh = c - (c - x)
    xl = x - xh
    n = xp.round(x * jnp.float32(_LOG2_10_HI))
    f = (((xh * jnp.float32(_LOG2_10_HI) - n) +
          xl * jnp.float32(_LOG2_10_HI)) + x * jnp.float32(_LOG2_10_LO))
    r = f * jnp.float32(0.6931471805599453)
    return _poly_horner(_EXP_POLY, r, xp) * _pow2_int(n)


def _log1p_f32(y):
    """log1p(y) for float32 device arrays, y > -1; ~1e-7 absolute.

    For |y| small the atanh form 2 atanh(y / (2 + y)) works directly on y
    (no 1 + y rounding).  Otherwise w = 1 + y is range-reduced by exact
    power-of-two scaling into [sqrt2/2, sqrt2) via bitcast exponent
    extraction, and ln w = k ln2 + 2 atanh((m-1)/(m+1)).
    """
    import jax
    import jax.numpy as jnp
    xp = get_namespace(y)

    def atanh_series(s):
        return 2.0 * s * _poly_horner(_ATANH_POLY, s * s, xp)

    # Small branch: |y| <= 0.25 keeps |s| <= 0.143.
    s_small = y / (2.0 + y)
    small = atanh_series(s_small)

    w = 1.0 + y
    bits = jax.lax.bitcast_convert_type(
        jax.lax.stop_gradient(xp.maximum(w, 1e-30)), jnp.int32)
    e = ((bits >> 23) & 0xff) - 127
    m0 = jax.lax.bitcast_convert_type(
        (bits & 0x007fffff) | 0x3f800000, jnp.float32)
    k = (e + (m0 >= jnp.float32(_SQRT2))).astype(jnp.float32)
    k = jax.lax.stop_gradient(k)
    m = w * _pow2_int(-k)                    # in [sqrt2/2, sqrt2)
    s = (m - 1.0) / (m + 1.0)
    large = (k * jnp.float32(_LN2_HI) +
             (atanh_series(s) + k * jnp.float32(_LN2_LO)))
    return xp.where(xp.abs(y) <= 0.25, small, large)


def _log1p_abs_f32(y):
    """log1p(y) for float32 device arrays, y in (-1, 0.25]; ABSOLUTE-error
    contract: ~6e-8 for |y| <= 0.5, growing to ~5e-7 as y -> -1 (the
    result's own f32 ulp scales with |ln w|, ~87 at the clamp edge).

    Single-branch variant of :func:`_log1p_f32` for callers that need
    absolute (not relative) accuracy — e.g. the satellite exponent
    ``(logM - logM1) + log1p(-ratio)/ln10``, whose other term is O(1)
    and which feeds exp (absolute exponent error = relative occupation
    error, so even the y -> -1 bound stays ~1e-6-level after /ln10).
    For y in (-1, -0.5] the sum w = 1 + y is EXACT (Sterbenz); for
    |y| < 0.5 the w rounding contributes <= 2^-25 / w <= 6e-8 absolute
    to ln w.  Skipping the small-|y| atanh branch saves a divide, a
    polynomial, and a select on the broadcast occupation array.
    """
    import jax
    import jax.numpy as jnp
    xp = get_namespace(y)

    # Guard w > 0 (y == -1 would bitcast a zero): same floor as
    # _log1p_f32; callers clamp well above it.
    w = xp.maximum(1.0 + y, 1e-30)
    bits = jax.lax.bitcast_convert_type(jax.lax.stop_gradient(w), jnp.int32)
    e = ((bits >> 23) & 0xff) - 127
    m0 = jax.lax.bitcast_convert_type(
        (bits & 0x007fffff) | 0x3f800000, jnp.float32)
    k = (e + (m0 >= jnp.float32(_SQRT2))).astype(jnp.float32)
    k = jax.lax.stop_gradient(k)
    m = w * _pow2_int(-k)                    # in [sqrt2/2, sqrt2)
    s = (m - 1.0) / (m + 1.0)
    return (k * jnp.float32(_LN2_HI) +
            (2.0 * s * _poly_horner(_ATANH_POLY, s * s, xp) +
             k * jnp.float32(_LN2_LO)))


def _is_f32_device(x) -> bool:
    import numpy as np_mod
    dtype = getattr(x, "dtype", None)
    return dtype is not None and dtype != np_mod.float64


def exp(x):
    """Accurate exp on the matching backend (see module notes above)."""
    if is_numpy(x):
        return np.exp(x)
    if _is_f32_device(x):
        return _exp_f32(x)
    import jax.numpy as jnp
    return jnp.exp(x)


def exp10(x):
    """Accurate 10**x on the matching backend."""
    if is_numpy(x):
        return 10.0 ** x
    if _is_f32_device(x):
        return _exp10_f32(x)
    import jax.numpy as jnp
    return 10.0 ** x


def log1p(x):
    """Accurate log1p on the matching backend."""
    if is_numpy(x):
        return np.log1p(x)
    if _is_f32_device(x):
        return _log1p_f32(x)
    import jax.numpy as jnp
    return jnp.log1p(x)


def log1p_abs(x):
    """log1p with an ABSOLUTE-accuracy contract, x in (-1, 0.25].

    Identical to :func:`log1p` on numpy/float64 backends; on the float32
    device path uses the cheaper single-branch form (~6e-8 absolute, see
    :func:`_log1p_abs_f32`).  Only for callers whose downstream use is
    absolute-error bound (the result is added to an O(1) term).
    """
    if is_numpy(x):
        return np.log1p(x)
    if _is_f32_device(x):
        return _log1p_abs_f32(x)
    import jax.numpy as jnp
    return jnp.log1p(x)


def _erfc_abs_poly(z, xp):
    """erfc(z) for z >= 0 via erfcx(z) exp(-z^2); ~4e-7 relative in f32.

    The exp argument uses a Veltkamp-split compensation: z*z rounds at
    z^2 * 2^-24 absolute in float32, which would be the dominant tail
    error (5e-7 relative at z=3); splitting z into 12-bit halves makes
    every partial product exact, recovering the residual ``err`` so
    exp(-z2)(1 - err) carries the full-precision argument.
    """
    zc = xp.minimum(z, 9.0)               # poly range; erfc(9) ~ 4e-37
    t = 2.0 / (2.0 + zc)
    s = (t - _ERFCX_T_MID) / _ERFCX_T_HALF
    two_s = 2.0 * s
    b1 = xp.zeros_like(s)
    b2 = xp.zeros_like(s)
    for c in _ERFCX_CHEB[:0:-1]:
        b0 = two_s * b1 - b2 + c
        b2 = b1
        b1 = b0
    h = s * b1 - b2 + _ERFCX_CHEB[0]      # erfcx(z) / t

    c_split = zc * 4097.0
    zh = c_split - (c_split - zc)
    zl = zc - zh
    z2 = zc * zc
    err = (zh * zh - z2) + (2.0 * zh) * zl + zl * zl
    return h * t * exp(-z2) * (1.0 - err)


def erf_poly(x):
    """erf via the erfcx Chebyshev fit (exp + arithmetic).

    Relatively accurate complementary tail: erfc(z) = erfcx(z) exp(-z^2),
    so occupations of deep-tail (Ncen -> 0) halo bins keep relative
    accuracy instead of the ulp-of-1 absolute error of 1 - erf forms.
    """
    xp = get_namespace(x)
    return xp.sign(x) * (1.0 - _erfc_abs_poly(xp.abs(x), xp))


def erfc_poly(x):
    """erfc with a relatively-accurate positive tail (see erf_poly)."""
    xp = get_namespace(x)
    erfc_abs = _erfc_abs_poly(xp.abs(x), xp)
    return xp.where(x >= 0, erfc_abs, 2.0 - erfc_abs)


def _use_poly(x) -> bool:
    """Polynomial path for every sub-float64 device dtype (more accurate
    than XLA's float32 erfc)."""
    import numpy as np_mod
    dtype = getattr(x, "dtype", None)
    return dtype is not None and dtype != np_mod.float64


def erf(x):
    """Error function on the matching backend."""
    if is_numpy(x):
        from scipy.special import erf as np_erf
        return np_erf(x)
    if _use_poly(x):
        return erf_poly(x)
    from jax.scipy.special import erf as jax_erf
    return jax_erf(x)


def erfc(x):
    """Complementary error function on the matching backend.

    Occupation models should prefer ``0.5 * erfc(-x)`` over
    ``0.5 * (1 + erf(x))``: the latter loses the entire x -> -inf tail to
    float32 cancellation against 1 (absolute ulp-of-1 error), while erfc
    keeps it relatively accurate — deep-tail halo bins carry huge halo
    densities, so their tiny occupations still need relative accuracy.
    """
    if is_numpy(x):
        from scipy.special import erfc as np_erfc
        return np_erfc(x)
    if _use_poly(x):
        return erfc_poly(x)
    from jax.scipy.special import erfc as jax_erfc
    return jax_erfc(x)
