"""Cacciato et al. (2009) conditional-luminosity-function model in JAX.

The fourth model family reference users can tabulate with: halotools'
``Cacciato09Cens``/``Cacciato09Sats`` (consumed through the same
``mean_occupation_*`` hooks as zheng07, reference:
tabcorr/tabcorr.py:556-563).  Unlike the mass/SHMR families, the galaxy
sample is *luminosity*-thresholded: the CLF Phi(L|M) dL gives the mean
number of galaxies of luminosity L in a halo of mass M, and the mean
occupation above a threshold L_t is its analytic integral.

Centrals are log-normal around a median luminosity (Cacciato et al.
2009, eqs. 34-35; van den Bosch et al. 2013 parameterization)

    L_c(M) = L_0 (M / M_1)^gamma_1 / (1 + M / M_1)^(gamma_1 - gamma_2)
    <N_cen>(M) = 1/2 erfc( (log10 L_t - log10 L_c) / (sqrt(2) sigma) )

and satellites follow a modified Schechter function

    Phi_s(L|M) dL = phi*_s (L / L*_s)^(alpha_s + 1)
                    exp( -delta (L / L*_s)^2 ) dL / L
    L*_s(M) = 0.562 L_c(M)
    alpha_s(M) = -2 + a_1 (1 - 2/pi arctan(a_2 log10(M / M_2)))
    log10 phi*_s(M) = b_0 + b_1 log10 M_12 + b_2 (log10 M_12)^2
    log10 delta(M) = delta_1 + delta_2 log10 M_12        (M_12 = M / 1e12)

whose threshold integral is an upper incomplete gamma function,

    <N_sat>(M) = (phi*_s / 2) delta^-a Gamma(a, delta (L_t / L*_s)^2),
    a = (alpha_s + 1) / 2,

evaluated for the possibly-negative a by
:func:`~tabcorr_tpu.utils.special.upper_incomplete_gamma` (at the
published fit a is in (-1/2, 0]).  Everything is a pure, jax-traceable
function of the parameter dict; gradients flow through the incomplete
gamma (d/da via XLA's ``igamma_grad_a``) into MCMC/Fisher code.

Units are halotools': luminosities in Lsun / h^2 (log10 threshold,
default 9.5), halo masses in Msun / h with the published fit defined
for M180b (``prim_haloprop_key='halo_m180b'``).  Parameter keys match
halotools' param_dict; exact parity is asserted in
tests/test_reference_parity.py when halotools is installed.  The
defaults are the Cacciato et al. (2009) WMAP3 fit halotools ships.
"""

from __future__ import annotations

import math

from ..utils.backend import erfc, exp10, get_namespace, log1p
from ..utils.special import upper_incomplete_gamma
from .protocol import CENTRALS, HodModel

_LN10 = 2.302585092994046
_SQRT2 = 1.4142135623730951
_LOG10_0562 = math.log10(0.562)

CACCIATO09_PARAMS = dict(
    log_L_0=9.935, log_M_1=11.07, gamma_1=3.273, gamma_2=0.255,
    sigma=0.143,
    a_1=0.501, a_2=2.106, log_M_2=14.28,
    b_0=-0.766, b_1=1.008, b_2=-0.094,
    delta_1=0.0, delta_2=0.0,
)


def _log10_one_plus_exp10(x, xp):
    """log10(1 + 10^x), cancellation-free for both signs of x."""
    pos = xp.where(x > 0.0, x, 0.0)
    return pos + log1p(exp10(-xp.abs(x))) / _LN10


def cacciato09_median_log_luminosity(params, log_prim_haloprop):
    """log10 L_c(M): median central luminosity (Cacciato09 eq. 35)."""
    xp = get_namespace(log_prim_haloprop, params["log_M_1"])
    x = xp.asarray(log_prim_haloprop) - params["log_M_1"]
    return (params["log_L_0"] + params["gamma_1"] * x -
            (params["gamma_1"] - params["gamma_2"]) *
            _log10_one_plus_exp10(x, xp))


def cacciato09_centrals(params, log_prim_haloprop, threshold):
    """<N_cen>: log-normal CLF integrated above the luminosity
    threshold (Cacciato09 eq. 34 with the eq. 35 median)."""
    log_lc = cacciato09_median_log_luminosity(params, log_prim_haloprop)
    return 0.5 * erfc((threshold - log_lc) / (_SQRT2 * params["sigma"]))


def cacciato09_satellites(params, log_prim_haloprop, threshold):
    """<N_sat>: modified-Schechter CLF integrated above the threshold
    (Cacciato09 eqs. 36-39; analytic upper-incomplete-gamma form)."""
    xp = get_namespace(log_prim_haloprop, params["a_1"])
    log_mh = xp.asarray(log_prim_haloprop)
    thr = xp.asarray(threshold, dtype=log_mh.dtype)
    m12 = log_mh - 12.0
    log_ls = (cacciato09_median_log_luminosity(params, log_mh) +
              _LOG10_0562)
    alpha_sat = -2.0 + params["a_1"] * (
        1.0 - (2.0 / math.pi) * xp.arctan(
            params["a_2"] * (log_mh - params["log_M_2"])))
    log_phi_sat = (params["b_0"] + params["b_1"] * m12 +
                   params["b_2"] * m12 * m12)
    log_delta = params["delta_1"] + params["delta_2"] * m12
    a = 0.5 * (alpha_sat + 1.0)
    # x = delta (L_t / L*_s)^2, formed in log10 to keep the huge dynamic
    # range (L*_s spans ~8 dex over the mass grid) exact.
    x = exp10(log_delta + 2.0 * (thr - log_ls))
    return (0.5 * exp10(log_phi_sat - a * log_delta) *
            upper_incomplete_gamma(a, x))


class Cacciato09Model(HodModel):
    """Cacciato et al. (2009) CLF model (cens + sats),
    luminosity-thresholded.

    Parameters
    ----------
    threshold : float, optional
        Luminosity threshold log10(L_t / (Lsun/h^2)).  Default is 9.5
        (halotools' default luminosity threshold).
    prim_haloprop_key : str, optional
        Halo mass column; the published fit is for M180b
        (``"halo_m180b"``, the default, matching halotools).
    **params : dict
        Overrides for the central CLF (``log_L_0``, ``log_M_1``,
        ``gamma_1``, ``gamma_2``, ``sigma``) and the satellite CLF
        (``a_1``, ``a_2``, ``log_M_2``, ``b_0``, ``b_1``, ``b_2``,
        ``delta_1``, ``delta_2``) — halotools key names throughout.

    Notes
    -----
    Satellites are NOT modulated by the central occupation — in a CLF
    the two populations are independent by construction (halotools'
    behavior for this model).  ``a_1`` must stay positive: the faint-end
    slope alpha_s = -2 + a_1 (1 - 2/pi arctan(...)) must exceed -3 for
    the threshold integral's a = (alpha_s + 1)/2 > -1 domain.
    """

    param_names = tuple(CACCIATO09_PARAMS)
    param_defaults = dict(CACCIATO09_PARAMS)

    def __init__(self, threshold=9.5, prim_haloprop_key="halo_m180b",
                 sec_haloprop_key=None, redshift=0.0, **params):
        self.threshold = float(threshold)
        super().__init__(prim_haloprop_key=prim_haloprop_key,
                         sec_haloprop_key=sec_haloprop_key,
                         redshift=redshift, **params)

    def occupation(self, params, gal_type, log_prim_haloprop,
                   sec_haloprop_percentile):
        if gal_type == CENTRALS:
            return cacciato09_centrals(params, log_prim_haloprop,
                                       self.threshold)
        return cacciato09_satellites(params, log_prim_haloprop,
                                     self.threshold)
