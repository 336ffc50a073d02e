"""Special functions shared by occupation models.

Currently: the (non-regularized) upper incomplete gamma function for
*possibly negative* first argument, which the Cacciato et al. (2009)
conditional-luminosity-function satellites need — their faint-end slope
makes a = (alpha_sat + 1) / 2 land in (-1/2, 0] at the published fit.

scipy's / jax's ``gammaincc`` is the REGULARIZED Q(a, x) and is only
defined for a > 0, so Gamma(a, x) for a <= 0 goes through one step of
the upward recurrence

    Gamma(a, x) = ( Gamma(a + 1, x) - x^a e^-x ) / a

(halotools solves the same problem the same way for its cacciato09
components).  The recurrence numerator vanishes linearly at a = 0
(Gamma(1, x) = e^-x), so a naive evaluation loses all precision there;
instead of clamping (which would flatten gradients), values inside
|a| < tol are linearly blended between the two exact evaluations at
a = -tol and a = +tol, keeping both the value (bias O(tol^2)) and the
d/da gradient (the blend slope is the centered difference) accurate.
Everything is a pure function of (a, x) and differentiates in both
arguments (JAX lowers d/da via ``igamma_grad_a``).
"""

from __future__ import annotations

import numpy as np

from .backend import get_namespace, is_numpy

# Blend half-width around a = 0.  Relative cancellation error of the
# recurrence at |a| = tol is ~eps / tol; the blend bias is
# O(tol^2 d2G/da2), worst at small x where the curvature carries a
# (ln x)^2 factor.  1e-5 puts both below ~1e-8 in float64 (measured
# 3e-9 worst over a in [-1, 1.5] x in [1e-6, 50] vs mpmath); the
# float32 device path widens to 3e-3 (6e-8 / 3e-3 = 2e-5 cancellation,
# ~1e-5 bias) — acceptable because the blend only engages in the
# narrow halo-mass sliver where alpha_sat crosses -1 (never at the
# published fits, whose a stays in (-1/2, 0)).
_TOL64 = 1e-5
_TOL32 = 3e-3

# Floor for x: the integral's lower limit is delta (L_t / L*_s)^2 > 0;
# a zero only appears through float underflow at absurd halo masses.
_X_FLOOR = 1e-35


def _gammaincc_unreg(a, x, xp):
    """Gamma(a, x) = Q(a, x) * Gamma(a) for a > 0."""
    if xp is np:
        from scipy.special import gammaincc, gammaln
    else:
        from jax.scipy.special import gammaincc, gammaln
    return gammaincc(a, x) * xp.exp(gammaln(a))


def upper_incomplete_gamma(a, x):
    """Non-regularized Gamma(a, x) = int_x^inf t^(a-1) e^-t dt, a > -1.

    Vectorized and branchless over arrays whose elements may straddle
    a = 0 (the Cacciato09 satellite slope varies with halo mass).
    Domain: a > -1 (one recurrence step), x > 0.  Dispatches numpy /
    scipy on host inputs and jax elsewhere, like the rest of
    ``utils.backend``.
    """
    xp = get_namespace(a, x)
    a = xp.asarray(a)
    x = xp.asarray(x)
    dtype = xp.result_type(a, x)
    a = a.astype(dtype)
    x = xp.maximum(x.astype(dtype), dtype.type(_X_FLOOR)
                   if xp is np else _X_FLOOR)
    tol = _TOL64 if dtype == np.float64 else _TOL32

    # Evaluation abscissae: the direct branch never sees a <= 0 and the
    # recurrence branch never sees a > -tol, so both are well posed for
    # every element; the unused lane of each `where` is still finite.
    a_hi = xp.where(a >= tol, a, tol)             # > 0
    a_lo = xp.where(a <= -tol, a, -tol)           # <= -tol, > -1
    g_hi = _gammaincc_unreg(a_hi, x, xp)
    g_lo = (_gammaincc_unreg(a_lo + 1.0, x, xp) -
            x ** a_lo * xp.exp(-x)) / a_lo

    # a >= tol -> g_hi; a <= -tol -> g_lo; else blend the two boundary
    # evaluations (a_hi == tol, a_lo == -tol there by construction).
    w = xp.clip((a + tol) / (2.0 * tol), 0.0, 1.0)
    return xp.where(a >= tol, g_hi,
                    xp.where(a <= -tol, g_lo,
                             (1.0 - w) * g_lo + w * g_hi))
