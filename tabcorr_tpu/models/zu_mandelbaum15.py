"""Zu & Mandelbaum (2015) iHOD occupation model in JAX.

The third model family the reference's users commonly tabulate with
(halotools' ``ZuMandelbaum15Cens``/``ZuMandelbaum15Sats``, consumed
through the same ``mean_occupation_*`` hooks as zheng07, reference:
tabcorr/tabcorr.py:556-563).  Like Leauthaud11, occupations derive from
a Behroozi et al. (2010)-form stellar-to-halo-mass relation, but with a
*halo-mass-dependent* log-normal scatter (the model's headline result —
sigma_lnM* declines from ~0.50 at M1 to ~0.30 at 1e14 Msun):

    <N_cen>(Mh) = 1/2 erfc( (ln M*_t - ln f_SHMR(Mh))
                            / (sqrt(2) sigma_lnM*(Mh)) )
    <N_sat>(Mh) = <N_cen>(Mh) (Mh / M_sat)^alpha_sat exp(-M_cut / Mh)

with the scatter (Zu & Mandelbaum 2015, eq. 26)

    sigma_lnM*(Mh) = sigma_0                          for Mh <  M_1
                     sigma_0 + eta ln(Mh / M_1)       for Mh >= M_1

and M_sat = 1e12 B_sat (Mh_t / 1e12)^beta_sat,
M_cut = 1e12 B_cut (Mh_t / 1e12)^beta_cut, where Mh_t = f_SHMR^-1(M*_t)
(Zu & Mandelbaum 2015, eqs. 25 and 28-30).

Unlike the Behroozi10 coefficients used by Leauthaud11, the Zu &
Mandelbaum (2015) fit is quoted directly in h = 1 units (Mh in Msun/h,
M* in Msun/h^2), so no little-h conversion applies, and the relation
carries no redshift evolution (it is an SDSS z ~ 0.1 fit).  Parameter
keys and linear-mass conventions follow halotools' param_dict for this
prebuilt model; exact numerical parity with halotools is asserted in
tests/test_reference_parity.py when halotools is installed.
"""

from __future__ import annotations

from ..utils.backend import erfc, exp, exp10, get_namespace
from .protocol import CENTRALS, HodModel

_LN10 = 2.302585092994046
_SQRT2 = 1.4142135623730951

# Zu & Mandelbaum (2015) Table 2, iHOD best fit to SDSS DR7 clustering
# + lensing — the defaults halotools ships for its zu_mandelbaum15
# prebuilt.  smhm_m0/smhm_m1 are linear masses (halotools convention);
# the published values are log10 M0 = 10.31, log10 M1 = 12.10.
ZU_MANDELBAUM15_PARAMS = dict(
    smhm_m0=10.0 ** 10.31, smhm_m1=10.0 ** 12.10,
    smhm_beta=0.33, smhm_delta=0.42, smhm_gamma=1.21,
    smhm_sigma=0.50, smhm_sigma_slope=-0.04,
    alphasat=1.0, betasat=0.90, bsat=8.98,
    betacut=0.41, bcut=0.86,
)

# Static log10(M*) grid for the SHMR inversion seed (same contract as
# models.leauthaud11: forward relation strictly monotone over the grid
# for all plausible (beta, delta, gamma) > 0).
_GRID_LO, _GRID_HI, _GRID_N = 5.0, 13.0, 257

# Scatter floor: sigma_lnM* must stay positive for the erfc argument to
# keep its sign.  At the published parameters the floor only engages
# beyond Mh ~ 1e17 Msun/h; it guards pathological (sigma, eta) samples
# an MCMC chain may propose, without affecting parity.
_SIGMA_FLOOR = 1e-6


def _behroozi_coeff_dict(params, xp):
    """Map Zu15's linear-mass param keys onto the redshift-coefficient
    layout :func:`~.leauthaud11.behroozi10_log_halo_mass` consumes
    (a = 1 makes the *_a entries inert)."""
    return dict(
        smhm_m1_0=xp.log10(params["smhm_m1"]), smhm_m1_a=0.0,
        smhm_m0_0=xp.log10(params["smhm_m0"]), smhm_m0_a=0.0,
        smhm_beta_0=params["smhm_beta"], smhm_beta_a=0.0,
        smhm_delta_0=params["smhm_delta"], smhm_delta_a=0.0,
        smhm_gamma_0=params["smhm_gamma"], smhm_gamma_a=0.0)


def zu15_log_halo_mass(log_mstar, params):
    """log10 Mh(M*): Behroozi10 functional form at the Zu15 parameters
    (Zu & Mandelbaum 2015, eq. 25; h = 1 units, no redshift scaling)."""
    from .leauthaud11 import behroozi10_log_halo_mass
    # Namespace from the params too: the threshold query is often a
    # plain float while the params are jax tracers (vmapped predictor).
    xp = get_namespace(log_mstar, params["smhm_m1"])
    coeffs = _behroozi_coeff_dict(params, xp)
    return behroozi10_log_halo_mass(log_mstar, coeffs, a=1.0, littleh=1.0)


def zu15_log_mstar(log_mh, params):
    """log10 f_SHMR(Mh): mean stellar mass at halo mass Mh, by the same
    grid-seeded Newton inversion as :func:`~.leauthaud11.fshmr_log_mstar`."""
    from ..utils.inversion import monotone_inverse
    from .leauthaud11 import (_d_log_mh_d_log_mstar,
                              behroozi10_log_halo_mass)
    xp = get_namespace(log_mh, params["smhm_m1"])
    log_mh = xp.asarray(log_mh)
    coeffs = _behroozi_coeff_dict(params, xp)
    fwd = lambda ls: behroozi10_log_halo_mass(ls, coeffs, 1.0, 1.0)  # noqa: E731
    dfwd = lambda ls: _d_log_mh_d_log_mstar(ls, coeffs, 1.0, 1.0)  # noqa: E731
    grid_mstar = xp.linspace(_GRID_LO, _GRID_HI, _GRID_N,
                             dtype=log_mh.dtype)
    return monotone_inverse(fwd, log_mh, grid_mstar, dfn=dfwd)


def zu15_scatter_ln_mstar(params, log_prim_haloprop, log_prim_res=None):
    """sigma_lnM*(Mh): Zu & Mandelbaum (2015), eq. 26.

    Constant sigma_0 below M_1; linear in ln(Mh / M_1) above it with
    slope eta (negative at the published fit, so the scatter shrinks
    toward cluster masses).  Floored at a tiny positive value so
    pathological parameter samples cannot flip the erfc argument.

    ``log_prim_res``: the node residual enters ln(Mh / M_1) additively,
    so the absorption is exact (added after the O(1) subtraction — see
    models.zheng07 for the float32-resolution rationale).
    """
    xp = get_namespace(log_prim_haloprop, params["smhm_m1"])
    log_mh = xp.asarray(log_prim_haloprop)
    dln_mh = _LN10 * (log_mh - xp.log10(params["smhm_m1"]))
    if log_prim_res is not None:
        dln_mh = dln_mh + _LN10 * log_prim_res
    sigma = params["smhm_sigma"] + params["smhm_sigma_slope"] * xp.where(
        dln_mh > 0.0, dln_mh, 0.0)
    return xp.where(sigma > _SIGMA_FLOOR, sigma, _SIGMA_FLOOR)


def zu_mandelbaum15_centrals(params, log_prim_haloprop, threshold,
                             log_prim_res=None):
    """<N_cen>: Zu & Mandelbaum (2015), eq. 27 (log-normal CDF above
    the stellar-mass threshold, mass-dependent scatter).

    ``log_prim_res``: the SHMR shift follows from the implicit function
    theorem, d(log10 M*)/d(log10 Mh) = 1 / f'(log10 M*) with the
    analytic forward derivative (one extra evaluation instead of a JVP
    through the Newton inversion — see models.leauthaud11); the
    scatter absorbs the residual exactly.
    """
    log_fshmr = zu15_log_mstar(log_prim_haloprop, params)
    centered = threshold - log_fshmr
    if log_prim_res is not None:
        from .leauthaud11 import _d_log_mh_d_log_mstar
        xp = get_namespace(log_prim_haloprop, params["smhm_m1"])
        coeffs = _behroozi_coeff_dict(params, xp)
        centered = centered - log_prim_res / _d_log_mh_d_log_mstar(
            log_fshmr, coeffs, 1.0, 1.0)
    sigma = zu15_scatter_ln_mstar(params, log_prim_haloprop,
                                  log_prim_res=log_prim_res)
    return 0.5 * erfc(_LN10 * centered / (_SQRT2 * sigma))


def zu_mandelbaum15_satellites(params, log_prim_haloprop, threshold,
                               modulate_with_cenocc=True,
                               log_prim_res=None):
    """<N_sat>: Zu & Mandelbaum (2015), eqs. 28-30.

    Identical power-law/cutoff structure to Leauthaud11 sats, with the
    threshold pivot mass Mh_t from the closed-form Zu15 relation.
    ``log_prim_res`` is absorbed exactly into the two affine exponents
    (see models.leauthaud11.leauthaud11_satellites).
    """
    xp = get_namespace(log_prim_haloprop, params["bsat"])
    log_mh = xp.asarray(log_prim_haloprop)
    # Threshold pivot in the query dtype (see models.leauthaud11: a
    # python-float query would promote to float64 under jax x64).
    thr = xp.asarray(threshold, dtype=log_mh.dtype)
    log_mh_t = zu15_log_halo_mass(thr, params)
    log_msat = (12.0 + xp.log10(params["bsat"]) +
                params["betasat"] * (log_mh_t - 12.0))
    log_mcut = (12.0 + xp.log10(params["bcut"]) +
                params["betacut"] * (log_mh_t - 12.0))
    d_pow = log_mh - log_msat
    d_cut = log_mcut - log_mh
    if log_prim_res is not None:
        d_pow = d_pow + log_prim_res
        d_cut = d_cut - log_prim_res
    nsat = (exp(_LN10 * params["alphasat"] * d_pow) *
            exp(-exp10(d_cut)))
    if modulate_with_cenocc:
        nsat = nsat * zu_mandelbaum15_centrals(params, log_mh, threshold,
                                               log_prim_res=log_prim_res)
    return nsat


class ZuMandelbaum15Model(HodModel):
    """Zu & Mandelbaum (2015) iHOD model (cens + sats).

    Parameters
    ----------
    threshold : float, optional
        Stellar-mass threshold log10(M*_t) in the model's native h = 1
        units (M* in Msun/h^2).  Default is 10.5.
    modulate_with_cenocc : bool, optional
        Multiply <N_sat> by <N_cen> (Zu & Mandelbaum 2015 eq. 28;
        halotools' behavior for this model).  Default is True.
    prim_haloprop_key : str, optional
        Halo mass column; the published fit uses M200m
        (``"halo_m200m"``, the default here, matching halotools).
    **params : dict
        Overrides for the SHMR coefficients (``smhm_m0``/``smhm_m1`` as
        LINEAR masses, ``smhm_{beta,delta,gamma}``), the scatter
        (``smhm_sigma``, ``smhm_sigma_slope``), and the satellite
        scalings (``alphasat``, ``betasat``, ``bsat``, ``betacut``,
        ``bcut``) — halotools key names throughout.
    """

    param_names = tuple(ZU_MANDELBAUM15_PARAMS)
    param_defaults = dict(ZU_MANDELBAUM15_PARAMS)

    def __init__(self, threshold=10.5, modulate_with_cenocc=True,
                 prim_haloprop_key="halo_m200m", sec_haloprop_key=None,
                 redshift=0.0, **params):
        self.threshold = float(threshold)
        self.modulate_with_cenocc = modulate_with_cenocc
        super().__init__(prim_haloprop_key=prim_haloprop_key,
                         sec_haloprop_key=sec_haloprop_key,
                         redshift=redshift, **params)

    def occupation(self, params, gal_type, log_prim_haloprop,
                   sec_haloprop_percentile):
        if gal_type == CENTRALS:
            return zu_mandelbaum15_centrals(params, log_prim_haloprop,
                                            self.threshold)
        return zu_mandelbaum15_satellites(
            params, log_prim_haloprop, self.threshold,
            modulate_with_cenocc=self.modulate_with_cenocc)

    def occupation_residual(self, params, gal_type, log_prim_haloprop,
                            log_prim_res, sec_haloprop_percentile):
        # Implicit-function-theorem absorption (see models.leauthaud11).
        if gal_type == CENTRALS:
            return zu_mandelbaum15_centrals(params, log_prim_haloprop,
                                            self.threshold,
                                            log_prim_res=log_prim_res)
        return zu_mandelbaum15_satellites(
            params, log_prim_haloprop, self.threshold,
            modulate_with_cenocc=self.modulate_with_cenocc,
            log_prim_res=log_prim_res)
