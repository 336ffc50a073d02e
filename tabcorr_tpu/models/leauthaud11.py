"""Leauthaud et al. (2011) HOD occupation model in JAX.

The second model family the reference's users commonly tabulate with
(via halotools' ``Leauthaud11Cens``/``Leauthaud11Sats``, consumed through
the same ``mean_occupation_*`` hooks as zheng07, reference:
tabcorr/tabcorr.py:556-563).  Occupations derive from the Behroozi et
al. (2010) stellar-to-halo-mass relation (SHMR) instead of free mass
scales:

    <N_cen>(Mh) = 1/2 erfc( (log10 M*_t - log10 f_SHMR(Mh))
                            / (sqrt(2) sigma_logM*) )
    <N_sat>(Mh) = <N_cen>(Mh) (Mh / M_sat)^alpha_sat exp(-M_cut / Mh)

with M_sat = 1e12 B_sat (Mh_t / 1e12)^beta_sat and
M_cut = 1e12 B_cut (Mh_t / 1e12)^beta_cut, where Mh_t = f_SHMR^-1(M*_t)
is the halo mass whose mean stellar mass equals the threshold
(Leauthaud et al. 2011, eqs. 8 and 12-14).

f_SHMR^-1 (stellar -> halo mass) is the closed-form Behroozi relation;
the forward direction f_SHMR (halo -> stellar mass), needed for
centrals, has no closed form and is computed by monotone inversion: a
static log-M* grid seeds a piecewise-linear estimate which three
unrolled Newton steps (analytic derivative) refine to float-precision
roots.  Everything is a pure, jax-traceable function of the parameter
dict, so gradients flow through the inversion into MCMC/Fisher code.
"""

from __future__ import annotations

import math

from ..utils.backend import erfc, exp, exp10, get_namespace
from .protocol import CENTRALS, HodModel

_LN10 = 2.302585092994046
_SQRT2 = 1.4142135623730951

# Behroozi et al. (2010) SMHM scaling parameters and the Leauthaud et
# al. (2012) satellite scaling relations ("SIG_MOD1" z1 fit) — the
# defaults halotools ships for its leauthaud11 prebuilt model.
LEAUTHAUD11_PARAMS = dict(
    smhm_m0_0=10.72, smhm_m0_a=0.59,
    smhm_m1_0=12.35, smhm_m1_a=0.3,
    smhm_beta_0=0.43, smhm_beta_a=0.18,
    smhm_delta_0=0.56, smhm_delta_a=0.18,
    smhm_gamma_0=1.54, smhm_gamma_a=2.52,
    scatter_model_param1=0.2,
    alphasat=1.0, betasat=0.859, bsat=10.62,
    betacut=-0.13, bcut=1.47,
)

# Static log10(M*) grid for the SHMR inversion seed.  The forward
# relation is strictly monotone in this range for all plausible
# (beta, delta, gamma) > 0, and three Newton refinements converge the
# ~0.03-dex linear seed to machine precision.
_GRID_LO, _GRID_HI, _GRID_N = 5.0, 13.0, 257


def _smhm_coeffs(params, a):
    """Redshift-scaled Behroozi10 coefficients (scale factor a)."""
    am1 = a - 1.0
    return (params["smhm_m1_0"] + params["smhm_m1_a"] * am1,
            params["smhm_m0_0"] + params["smhm_m0_a"] * am1,
            params["smhm_beta_0"] + params["smhm_beta_a"] * am1,
            params["smhm_delta_0"] + params["smhm_delta_a"] * am1,
            params["smhm_gamma_0"] + params["smhm_gamma_a"] * am1)


def behroozi10_log_halo_mass(log_mstar, params, a, littleh=0.72):
    """log10 Mh(M*): Behroozi et al. (2010), eq. 21.

    log10 Mh = log10 M1 + beta x + 10^(delta x) / (1 + 10^(-gamma x))
               - 1/2,   with x = log10(M* / M*_0).

    ``littleh``: the published Behroozi10 coefficients assume h = 0.72;
    following halotools' convention, h = 1 inputs/outputs are converted
    by evaluating the relation at M* h^2 and returning Mh / h (set
    ``littleh=1`` for the raw published-units relation).
    """
    xp = get_namespace(log_mstar)
    log_m1, log_m0, beta, delta, gamma = _smhm_coeffs(params, a)
    log_h = math.log10(littleh)
    x = xp.asarray(log_mstar) + 2.0 * log_h - log_m0
    s_delta = exp10(delta * x)
    s_neg_gamma = exp10(-gamma * x)
    return (log_m1 + beta * x + s_delta / (1.0 + s_neg_gamma) - 0.5 -
            log_h)


def _d_log_mh_d_log_mstar(log_mstar, params, a, littleh=0.72):
    """Analytic d(log10 Mh)/d(log10 M*) for the Newton refinement."""
    xp = get_namespace(log_mstar)
    _, log_m0, beta, delta, gamma = _smhm_coeffs(params, a)
    x = xp.asarray(log_mstar) + 2.0 * math.log10(littleh) - log_m0
    s_delta = exp10(delta * x)
    s_neg_gamma = exp10(-gamma * x)
    denom = 1.0 + s_neg_gamma
    return beta + _LN10 * s_delta * (
        delta + (delta + gamma) * s_neg_gamma) / (denom * denom)


def fshmr_log_mstar(log_mh, params, a, littleh=0.72):
    """log10 f_SHMR(Mh): mean stellar mass at halo mass Mh.

    Monotone inversion of :func:`behroozi10_log_halo_mass`: linear
    interpolation on a static log-M* grid seeds three unrolled Newton
    steps (fixed trip count — forward- and reverse-differentiable,
    unlike a ``while_loop``).  Queries outside the tabulated halo-mass
    range clamp to the grid ends; the centrals occupation there is
    0 or 1 to double precision for any sane threshold.
    """
    from ..utils.inversion import monotone_inverse
    xp = get_namespace(log_mh)
    log_mh = xp.asarray(log_mh)
    fwd = lambda ls: behroozi10_log_halo_mass(ls, params, a, littleh)  # noqa: E731
    dfwd = lambda ls: _d_log_mh_d_log_mstar(ls, params, a, littleh)  # noqa: E731
    # Grid in the query's dtype: mixing a float64 grid into a float32
    # fast path would silently promote every downstream array.
    grid_mstar = xp.linspace(_GRID_LO, _GRID_HI, _GRID_N,
                             dtype=log_mh.dtype)
    return monotone_inverse(fwd, log_mh, grid_mstar, dfn=dfwd)


def leauthaud11_centrals(params, log_prim_haloprop, threshold, a,
                         littleh=0.72, log_prim_res=None):
    """<N_cen>: Leauthaud et al. (2011), eq. 8.

    ``log_prim_res`` is the float64 residual of float32-rounded
    quadrature nodes (|res| < ulp(logM)/2).  The SHMR shift it induces
    follows from the implicit function theorem,
    d(log10 M*)/d(log10 Mh) = 1 / f'(log10 M*) with the ANALYTIC
    forward derivative already used by the Newton refinement — one
    extra :func:`_d_log_mh_d_log_mstar` evaluation instead of a traced
    JVP through the whole grid-seeded inversion (which would re-run
    the tangent of every Newton step and roughly double the occupation
    cost).  First-order in the ~5e-7 residual, the
    same order the generic JVP fallback achieves.  The correction is
    applied AFTER the O(1) subtraction ``threshold - log_fshmr`` so it
    lands at full float32 resolution (see models.zheng07).
    """
    log_fshmr = fshmr_log_mstar(log_prim_haloprop, params, a, littleh)
    centered = threshold - log_fshmr
    if log_prim_res is not None:
        centered = centered - log_prim_res / _d_log_mh_d_log_mstar(
            log_fshmr, params, a, littleh)
    inv_scatter = 1.0 / (_SQRT2 * params["scatter_model_param1"])
    return 0.5 * erfc(centered * inv_scatter)


def leauthaud11_satellites(params, log_prim_haloprop, threshold, a,
                           modulate_with_cenocc=True, littleh=0.72,
                           log_prim_res=None):
    """<N_sat>: Leauthaud et al. (2011), eqs. 12-14.

    M_sat and M_cut scale with the threshold halo mass
    Mh_t = f_SHMR^-1(M*_t), which is the CLOSED-FORM direction of the
    Behroozi relation — no inversion needed here.

    ``log_prim_res``: the node residual enters the two exponents
    additively (they depend on logM affinely), so the absorption is
    EXACT — added after the O(1) subtractions for float32 resolution
    (see :func:`leauthaud11_centrals` for the centrals modulation).
    """
    xp = get_namespace(log_prim_haloprop)
    log_mh = xp.asarray(log_prim_haloprop)
    # Evaluate the threshold pivot in the query dtype: a python-float
    # query would go through numpy float64 scalars and silently promote
    # the whole satellite occupation (and everything downstream) to
    # float64 when jax x64 is enabled.
    thr = xp.asarray(threshold, dtype=log_mh.dtype)
    log_mh_t = behroozi10_log_halo_mass(thr, params, a, littleh)
    # log10 of M_sat/M_cut via their power-law scalings around 1e12.
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
        nsat = nsat * leauthaud11_centrals(params, log_mh, threshold,
                                           a, littleh,
                                           log_prim_res=log_prim_res)
    return nsat


class Leauthaud11Model(HodModel):
    """Leauthaud11 HOD model (cens + sats), SHMR-based.

    Parameters
    ----------
    threshold : float, optional
        Stellar-mass threshold log10(M*_t) of the galaxy sample, in the
        h = 1 units halotools assumes (the published Behroozi10
        coefficients' h = 0.72 is converted internally — see
        ``littleh``).  Default is 10.5.
    redshift : float, optional
        Sets the scale factor a = 1 / (1 + z) of the Behroozi10
        coefficient evolution.  Default is 0.
    modulate_with_cenocc : bool, optional
        Multiply <N_sat> by <N_cen> (Leauthaud et al. 2011 eq. 12;
        halotools' default for this model).  Default is True.
    littleh : float, optional
        Hubble parameter the Behroozi10 coefficients were published
        for; inputs/outputs are converted to h = 1 units by evaluating
        the relation at M* h^2 and dividing the halo mass by h
        (halotools' convention).  Default is 0.72; set 1 for the raw
        published-units relation.  Exact numerical parity with
        halotools is asserted in tests/test_reference_parity.py when
        halotools is installed.
    **params : dict
        Overrides for the Behroozi10 SMHM coefficients
        (``smhm_{m0,m1,beta,delta,gamma}_{0,a}``), the central scatter
        ``scatter_model_param1``, and the satellite scalings
        ``alphasat``, ``betasat``, ``bsat``, ``betacut``, ``bcut``.
    """

    param_names = tuple(LEAUTHAUD11_PARAMS)
    param_defaults = dict(LEAUTHAUD11_PARAMS)

    def __init__(self, threshold=10.5, modulate_with_cenocc=True,
                 littleh=0.72, prim_haloprop_key="halo_mvir",
                 sec_haloprop_key=None, redshift=0.0, **params):
        self.threshold = float(threshold)
        self.modulate_with_cenocc = modulate_with_cenocc
        self.littleh = float(littleh)
        super().__init__(prim_haloprop_key=prim_haloprop_key,
                         sec_haloprop_key=sec_haloprop_key,
                         redshift=redshift, **params)

    @property
    def _a(self):
        return 1.0 / (1.0 + self.redshift)

    def occupation(self, params, gal_type, log_prim_haloprop,
                   sec_haloprop_percentile):
        if gal_type == CENTRALS:
            return leauthaud11_centrals(params, log_prim_haloprop,
                                        self.threshold, self._a,
                                        littleh=self.littleh)
        return leauthaud11_satellites(
            params, log_prim_haloprop, self.threshold, self._a,
            modulate_with_cenocc=self.modulate_with_cenocc,
            littleh=self.littleh)

    def occupation_residual(self, params, gal_type, log_prim_haloprop,
                            log_prim_res, sec_haloprop_percentile):
        # Implicit-function-theorem absorption: one analytic forward-
        # derivative evaluation instead of a JVP through the Newton
        # inversion (see leauthaud11_centrals).
        if gal_type == CENTRALS:
            return leauthaud11_centrals(params, log_prim_haloprop,
                                        self.threshold, self._a,
                                        littleh=self.littleh,
                                        log_prim_res=log_prim_res)
        return leauthaud11_satellites(
            params, log_prim_haloprop, self.threshold, self._a,
            modulate_with_cenocc=self.modulate_with_cenocc,
            littleh=self.littleh, log_prim_res=log_prim_res)
