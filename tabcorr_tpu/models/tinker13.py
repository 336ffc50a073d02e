"""Tinker et al. (2013) quiescent/active HOD occupation model in JAX.

The star-formation-split SHMR model (Tinker et al. 2013, arXiv:1308.2974,
sections 3.1-3.2; halotools' ``Tinker13Cens`` / ``Tinker13QuiescentSats``
/ ``Tinker13ActiveSats`` prebuilt): centrals carry SEPARATE Behroozi10
stellar-to-halo-mass relations for the quiescent and active populations,
weighted by a central quiescent fraction f_q(Mh) specified at control
masses,

    <N_cen,q>(Mh) = f_q(Mh)       * 1/2 erfc(nu_q(Mh)),
    <N_cen,a>(Mh) = (1 - f_q(Mh)) * 1/2 erfc(nu_a(Mh)),
    nu_x(Mh) = (log10 M*_t - log10 f_SHMR,x(Mh)) / (sqrt(2) sigma_x),

and each satellite population follows its own Leauthaud11-form power law
with exponential cutoff (Tinker et al. 2013, eq. 9; no central
modulation — the populations' satellite fractions are independent fit
parameters there).

Predicting quiescent-only / active-only / total clustering from ONE
tabulation is the model's point: build three instances sharing a
``param_dict`` with ``sfr_designation`` 'quiescent' / 'active' / 'all'.

Parameter keys follow halotools' suffix convention for this prebuilt
(``smhm_m1_0_active``, ``scatter_model_param1_quiescent``,
``quiescent_fraction_ordinates_param1``, ...).  f_q(Mh) follows
halotools' ``custom_spline`` semantics exactly: an interpolating spline
of degree min(n_points - 1, 5) through the ordinates in log10 Mh
(scipy ``InterpolatedUnivariateSpline``; the polynomial pieces extend
beyond the end control points), with the RESULT clipped to [0, 1]
(halotools clips the evaluated fraction, not the ordinates).  Because
the control masses are fixed per model instance, the spline is a LINEAR
map from the ordinate parameters to piecewise-polynomial coefficients;
that map is precomputed on the host once (``tinker13_fq_spline_map``)
and the device evaluation is branchless where/Horner arithmetic,
exactly differentiable in the ordinates.  With the default 3-point abscissa the spline is a single
quadratic (one segment, no selection at all).  Piecewise-LINEAR
interpolation (constant beyond the ends, ordinates clamped to [0, 1])
remains available via ``interpolation='linear'``.
"""

from __future__ import annotations

from ..utils.backend import get_namespace
from .leauthaud11 import leauthaud11_centrals, leauthaud11_satellites
from .protocol import CENTRALS, HodModel

QUIESCENT = "quiescent"
ACTIVE = "active"

# Control masses for the central quiescent fraction (halotools'
# quiescent_fraction_abscissa default for the tinker13 prebuilt).
TINKER13_ABSCISSA = (12.0, 13.5, 15.0)          # log10 Mh
_DEFAULT_ORDINATES = (0.25, 0.7, 0.95)

_SMHM_KEYS = ("smhm_m0_0", "smhm_m0_a", "smhm_m1_0", "smhm_m1_a",
              "smhm_beta_0", "smhm_beta_a", "smhm_delta_0",
              "smhm_delta_a", "smhm_gamma_0", "smhm_gamma_a",
              "scatter_model_param1")
_SAT_KEYS = ("alphasat", "betasat", "bsat", "betacut", "bcut")

# Behroozi10 z1 SMHM + Leauthaud12 satellite scalings for BOTH
# populations (the same published coefficients halotools seeds each
# population's Behroozi10SmHm instance with); the Tinker13 paper's
# per-redshift-bin fits (their Table 2) override these per analysis.
TINKER13_PARAMS = {}
for _sfr in (ACTIVE, QUIESCENT):
    from .leauthaud11 import LEAUTHAUD11_PARAMS as _L11
    for _k in _SMHM_KEYS + _SAT_KEYS:
        TINKER13_PARAMS[f"{_k}_{_sfr}"] = _L11[_k]
for _i, _o in enumerate(_DEFAULT_ORDINATES):
    TINKER13_PARAMS[f"quiescent_fraction_ordinates_param{_i + 1}"] = _o
del _sfr, _k, _i, _o, _L11


def _subparams(params, sfr):
    """The Leauthaud11-layout parameter view of one SFR population."""
    return {k: params[f"{k}_{sfr}"] for k in _SMHM_KEYS + _SAT_KEYS}


# Cache of abscissa -> (breaks, coeffs); keyed by the rounded tuple.
_FQ_SPLINE_MAPS = {}


def tinker13_fq_spline_map(abscissa=TINKER13_ABSCISSA, k=None):
    """Host-side precomputation of the f_q spline as a LINEAR map from
    ordinates to piecewise-polynomial coefficients.

    halotools evaluates f_q with ``custom_spline(log10(abscissa),
    ordinates)``, i.e. a scipy interpolating spline of degree
    ``k = min(len(abscissa) - 1, 5)``.  For fixed control masses that
    spline is linear in the ordinates, so applying it to the unit
    ordinate vectors yields, per breakpoint segment, a
    ``(degree + 1, n_points)`` coefficient matrix (PPoly order, highest
    degree first, in the local variable ``x - break_left``).

    Returns ``(breaks, coeffs)``: float64 arrays of shape
    ``(n_segments + 1,)`` and ``(n_segments, degree + 1, n_points)``.
    The outermost segments extend beyond the end breakpoints
    (polynomial extrapolation, matching scipy/halotools).  The default
    3-point abscissa gives a single quadratic segment.
    """
    import numpy as np
    from scipy.interpolate import PPoly, splrep

    x = np.asarray(abscissa, dtype=np.float64)
    n = len(x)
    if k is None:
        k = min(n - 1, 5)
    key = (tuple(x.tolist()), int(k))
    cached = _FQ_SPLINE_MAPS.get(key)
    if cached is not None:
        return cached
    breaks = None
    cols = []
    for i in range(n):
        e = np.zeros(n)
        e[i] = 1.0
        pp = PPoly.from_spline(splrep(x, e, k=k, s=0), extrapolate=True)
        # Knot vector carries (k+1)-fold end multiplicities; keep the
        # zero-width-free segments only.
        real = np.flatnonzero(np.diff(pp.x) > 0)
        if breaks is None:
            breaks = np.append(pp.x[real], pp.x[real[-1] + 1])
        cols.append(pp.c[:, real])
    coeffs = np.stack(cols, axis=-1).transpose(1, 0, 2)
    result = (breaks, np.ascontiguousarray(coeffs))
    _FQ_SPLINE_MAPS[key] = result
    return result


def _fq_linear(params, logm, abscissa, log_prim_res, xp):
    """Piecewise-linear f_q: ordinates clamped to [0, 1], constant
    beyond the end control points (the pre-spline behavior, kept as
    ``interpolation='linear'``).

    ``log_prim_res``: f_q is affine within a segment, so a sub-ulp node
    residual is absorbed exactly via the segment slope.  A node sitting
    EXACTLY on an interior control point uses the right segment's slope
    (and zero slope at the last control point) — for the sub-ulp
    residuals this path sees, the difference is below float64 noise.
    """
    one = xp.asarray(1.0, dtype=logm.dtype)
    zero = xp.asarray(0.0, dtype=logm.dtype)
    ords = []
    for i in range(len(abscissa)):
        o = xp.asarray(
            params[f"quiescent_fraction_ordinates_param{i + 1}"],
            dtype=logm.dtype)
        # Clamp to [0, 1]: convexity then bounds the interpolant with no
        # output clip (which would break the exact residual absorption).
        ords.append(xp.where(o < zero, zero, xp.where(o > one, one, o)))
    y = ords[0] + xp.zeros_like(logm)
    dy = xp.zeros_like(logm)
    for i in range(len(abscissa) - 1):
        dx = abscissa[i + 1] - abscissa[i]
        slope = (ords[i + 1] - ords[i]) / dx
        t = logm - abscissa[i]
        y = y + slope * xp.where(t < zero, zero,
                                 xp.where(t > dx, xp.asarray(
                                     dx, dtype=logm.dtype), t))
        if log_prim_res is not None:
            dy = dy + xp.where((t >= zero) & (t < dx), slope, zero)
    if log_prim_res is not None:
        y = y + dy * log_prim_res
    return y


def tinker13_quiescent_fraction(params, log_prim_haloprop,
                                abscissa=TINKER13_ABSCISSA,
                                log_prim_res=None,
                                interpolation="spline",
                                spline_map=None):
    """Central quiescent fraction f_q(Mh) through the ordinate
    parameters at the control masses.

    ``interpolation='spline'`` (default) reproduces halotools exactly:
    an interpolating spline of degree min(n_points - 1, 5) in log10 Mh,
    polynomial extrapolation beyond the ends, result clipped to [0, 1].
    Evaluation is branchless — per-segment coefficients are scalar
    combinations of the ordinates selected with ``where`` and fed to a
    Horner loop (no gathers).  ``interpolation='linear'``
    keeps the piecewise-linear variant (constant extrapolation,
    ordinates clamped instead of the result).

    ``log_prim_res``: a sub-ulp node residual is absorbed EXACTLY by
    shifting the polynomial evaluation point (segment selection uses
    the unshifted mass; the pieces are C^(degree-1) continuous, so a
    residual crossing a breakpoint contributes below float64 noise).
    """
    xp = get_namespace(log_prim_haloprop,
                       params["quiescent_fraction_ordinates_param1"])
    logm = xp.asarray(log_prim_haloprop)
    if interpolation == "linear":
        return _fq_linear(params, logm, abscissa, log_prim_res, xp)
    if interpolation != "spline":
        raise ValueError(f"Unknown interpolation: {interpolation!r}")
    if spline_map is None:
        spline_map = tinker13_fq_spline_map(abscissa)
    breaks, coeffs = spline_map
    n_seg, n_coef, n_pts = coeffs.shape
    ords = [xp.asarray(params[f"quiescent_fraction_ordinates_param{i + 1}"],
                       dtype=logm.dtype)
            for i in range(n_pts)]
    # Per-segment polynomial coefficients: scalar combinations of the
    # (possibly traced) ordinates — the spline map itself is constant.
    c_seg = [[sum(coeffs[j, d, i] * ords[i] for i in range(n_pts))
              for d in range(n_coef)] for j in range(n_seg)]
    if n_seg == 1:
        left = xp.asarray(breaks[0], dtype=logm.dtype)
        c_sel = c_seg[0]
    else:
        left = xp.full_like(logm, breaks[0])
        c_sel = [c + xp.zeros_like(logm) for c in c_seg[0]]
        for j in range(1, n_seg):
            inside = logm >= breaks[j]
            left = xp.where(inside, xp.asarray(breaks[j],
                                               dtype=logm.dtype), left)
            c_sel = [xp.where(inside, c_seg[j][d], c_sel[d])
                     for d in range(n_coef)]
    s = logm - left
    if log_prim_res is not None:
        s = s + log_prim_res
    y = c_sel[0] + xp.zeros_like(logm)
    for d in range(1, n_coef):
        y = y * s + c_sel[d]
    one = xp.asarray(1.0, dtype=logm.dtype)
    zero = xp.asarray(0.0, dtype=logm.dtype)
    return xp.where(y < zero, zero, xp.where(y > one, one, y))


def tinker13_centrals(params, log_prim_haloprop, threshold, a,
                      sfr_designation, abscissa=TINKER13_ABSCISSA,
                      littleh=0.72, log_prim_res=None):
    """<N_cen> of one SFR population (or their sum): the population's
    own Behroozi10 SHMR erfc weighted by f_q / (1 - f_q)
    (Tinker et al. 2013, eqs. 6-8)."""
    xp = get_namespace(log_prim_haloprop)
    fq = tinker13_quiescent_fraction(params, log_prim_haloprop,
                                     abscissa=abscissa,
                                     log_prim_res=log_prim_res)
    out = None
    if sfr_designation in (QUIESCENT, "all"):
        out = fq * leauthaud11_centrals(
            _subparams(params, QUIESCENT), log_prim_haloprop, threshold,
            a, littleh=littleh, log_prim_res=log_prim_res)
    if sfr_designation in (ACTIVE, "all"):
        occ_a = (1.0 - fq) * leauthaud11_centrals(
            _subparams(params, ACTIVE), log_prim_haloprop, threshold,
            a, littleh=littleh, log_prim_res=log_prim_res)
        out = occ_a if out is None else out + occ_a
    if out is None:
        raise ValueError(f"Unknown sfr_designation: {sfr_designation!r}")
    return xp.asarray(out)


def tinker13_satellites(params, log_prim_haloprop, threshold, a,
                        sfr_designation, littleh=0.72, log_prim_res=None):
    """<N_sat> of one SFR population (or their sum): Leauthaud11-form
    power law + exponential cutoff with the population's own scalings,
    NOT modulated by <N_cen> (Tinker et al. 2013, eq. 9 — each
    population's satellite amplitude is an independent fit)."""
    kinds = (QUIESCENT, ACTIVE) if sfr_designation == "all" \
        else (sfr_designation,)
    if not set(kinds) <= {QUIESCENT, ACTIVE}:
        raise ValueError(f"Unknown sfr_designation: {sfr_designation!r}")
    return sum(
        leauthaud11_satellites(_subparams(params, sfr),
                               log_prim_haloprop, threshold, a,
                               modulate_with_cenocc=False,
                               littleh=littleh,
                               log_prim_res=log_prim_res)
        for sfr in kinds)


class Tinker13Model(HodModel):
    """Tinker et al. (2013) quiescent/active HOD model.

    Parameters
    ----------
    threshold : float, optional
        Stellar-mass threshold log10(M*_t), h = 1 units (converted to
        the Behroozi10 coefficients' h = 0.72 internally, halotools'
        convention).  Default is 10.5.
    sfr_designation : {'all', 'quiescent', 'active'}, optional
        Which population this instance predicts.  Build one instance
        per population over the SAME tabulation for red/blue/total
        clustering; they may share a ``param_dict``.  Default 'all'.
    redshift : float, optional
        Scale factor a = 1/(1+z) of the Behroozi10 coefficient
        evolution.  Default 0.
    quiescent_fraction_abscissa : sequence of float, optional
        log10 control masses of f_q.  Default (12, 13.5, 15), the
        halotools default (it quotes linear masses 1e12/10**13.5/1e15).
    littleh : float, optional
        See :class:`~.leauthaud11.Leauthaud11Model`.  Default 0.72.
    **params : dict
        Overrides for the per-population SMHM/scatter/satellite
        parameters (``{name}_active`` / ``{name}_quiescent`` with the
        Leauthaud11 names) and the quiescent-fraction ordinates
        ``quiescent_fraction_ordinates_param{i}``.
    """

    param_names = tuple(TINKER13_PARAMS)
    param_defaults = dict(TINKER13_PARAMS)

    def __init__(self, threshold=10.5, sfr_designation="all",
                 quiescent_fraction_abscissa=TINKER13_ABSCISSA,
                 littleh=0.72, prim_haloprop_key="halo_mvir",
                 sec_haloprop_key=None, redshift=0.0, **params):
        if sfr_designation not in ("all", QUIESCENT, ACTIVE):
            raise ValueError(
                f"Unknown sfr_designation: {sfr_designation!r}")
        self.threshold = float(threshold)
        self.sfr_designation = sfr_designation
        abscissa = tuple(float(x) for x in quiescent_fraction_abscissa)
        if len(abscissa) < 2 or any(
                b <= a for a, b in zip(abscissa, abscissa[1:])):
            raise ValueError("quiescent_fraction_abscissa must be "
                             ">= 2 strictly increasing log-masses.")
        self.quiescent_fraction_abscissa = abscissa
        self.littleh = float(littleh)
        # Ordinate count follows the abscissa; re-derive defaults when a
        # custom abscissa changes the parameter count.
        if len(abscissa) != len(TINKER13_ABSCISSA):
            defaults = dict(TINKER13_PARAMS)
            for i in range(len(TINKER13_ABSCISSA)):
                del defaults[f"quiescent_fraction_ordinates_param{i + 1}"]
            for i in range(len(abscissa)):
                defaults[f"quiescent_fraction_ordinates_param{i + 1}"] = \
                    0.5
            self.param_defaults = defaults
            # Keep introspection consistent with the instance's actual
            # parameter set (param_names is a class attribute sized for
            # the default 3-point abscissa otherwise).
            self.param_names = tuple(defaults)
        super().__init__(prim_haloprop_key=prim_haloprop_key,
                         sec_haloprop_key=sec_haloprop_key,
                         redshift=redshift, **params)

    @property
    def _a(self):
        return 1.0 / (1.0 + self.redshift)

    def occupation(self, params, gal_type, log_prim_haloprop,
                   sec_haloprop_percentile):
        if gal_type == CENTRALS:
            return tinker13_centrals(
                params, log_prim_haloprop, self.threshold, self._a,
                self.sfr_designation,
                abscissa=self.quiescent_fraction_abscissa,
                littleh=self.littleh)
        return tinker13_satellites(
            params, log_prim_haloprop, self.threshold, self._a,
            self.sfr_designation, littleh=self.littleh)

    def occupation_residual(self, params, gal_type, log_prim_haloprop,
                            log_prim_res, sec_haloprop_percentile):
        # Exact absorption throughout: IFT shift inside each SHMR erfc,
        # affine segment slope in f_q, affine exponents in the
        # satellites (see models.leauthaud11).
        if gal_type == CENTRALS:
            return tinker13_centrals(
                params, log_prim_haloprop, self.threshold, self._a,
                self.sfr_designation,
                abscissa=self.quiescent_fraction_abscissa,
                littleh=self.littleh, log_prim_res=log_prim_res)
        return tinker13_satellites(
            params, log_prim_haloprop, self.threshold, self._a,
            self.sfr_designation, littleh=self.littleh,
            log_prim_res=log_prim_res)
