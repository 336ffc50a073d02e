"""Zheng et al. (2007) HOD occupation model in JAX.

Implements the occupation statistics the reference obtains from halotools'
``Zheng07Cens``/``Zheng07Sats`` (consumed via ``mean_occupation_centrals`` /
``mean_occupation_satellites``, reference: tabcorr/tabcorr.py:556-563):

    <N_cen>(M) = 1/2 [1 + erf((log10 M - logMmin) / sigma_logM)]
    <N_sat>(M) = ((M - M0) / M1)^alpha   for M > M0, else 0

with optional central modulation <N_sat> -> <N_cen> <N_sat>
(halotools' ``modulate_with_cenocc``).

The satellite power law is evaluated in log space,
``exp(ln10 * alpha * (log10(M - M0) - logM1))`` with
``log10(M - M0) = logM + log1p(-10^(logM0 - logM))/ln10``, so the float32
device path stays accurate to ~1e-7 relative even for M ~ 1e15.
"""

from __future__ import annotations

from ..utils.backend import erfc, exp, exp10, get_namespace, log1p_abs
from .protocol import CENTRALS, HodModel

_LN10 = 2.302585092994046

# Zheng et al. (2007), Table 1: best-fit parameters for SDSS
# luminosity-threshold samples, keyed by absolute r-band magnitude threshold.
# Identical to the table shipped with halotools' zheng07 prebuilt model.
ZHENG07_THRESHOLD_PARAMS = {
    -18.0: dict(logMmin=11.35, sigma_logM=0.25, logM0=11.20, logM1=12.40, alpha=0.83),
    -18.5: dict(logMmin=11.46, sigma_logM=0.24, logM0=10.59, logM1=12.68, alpha=0.97),
    -19.0: dict(logMmin=11.60, sigma_logM=0.26, logM0=11.49, logM1=12.83, alpha=1.02),
    -19.5: dict(logMmin=11.75, sigma_logM=0.28, logM0=11.69, logM1=13.01, alpha=1.06),
    -20.0: dict(logMmin=12.02, sigma_logM=0.26, logM0=11.38, logM1=13.31, alpha=1.06),
    -20.5: dict(logMmin=12.30, sigma_logM=0.21, logM0=11.84, logM1=13.58, alpha=1.12),
    -21.0: dict(logMmin=12.79, sigma_logM=0.39, logM0=11.92, logM1=13.94, alpha=1.15),
    -21.5: dict(logMmin=13.38, sigma_logM=0.51, logM0=13.94, logM1=13.91, alpha=1.04),
    -22.0: dict(logMmin=14.22, sigma_logM=0.77, logM0=14.00, logM1=14.69, alpha=0.87),
}


def zheng07_centrals(params, log_prim_haloprop, log_prim_res=None):
    """<N_cen> as a pure function of a params dict and log10(M).

    Evaluated as erfc(-x)/2 rather than (1 + erf(x))/2: identical in
    exact arithmetic, but the erf form loses the deep tail (N_cen -> 0)
    to float32 cancellation against 1, and tail bins carry the largest
    halo densities (see utils.backend.erfc).

    The standardization multiplies by a precomputed 1/sigma instead of
    dividing: the division would run on the broadcast (batch, nodes)
    array, while the reciprocal runs on the (batch, 1) parameter column.

    ``log_prim_res`` is the float64 residual of float32-rounded node
    positions (ops.predict.TableData.log_prim_quad_lo).  Adding it to
    ``log_prim_haloprop`` directly would round it away entirely
    (|res| < ulp(logM)/2); adding it AFTER the ~O(1)-magnitude
    subtraction ``logM - logMmin`` applies it at ulp(logM - logMmin)
    resolution, recovering the float64 node position exactly where it
    matters — one extra add instead of the generic traced-JVP
    correction, whose tangent arithmetic roughly doubles the
    occupation cost.
    """
    inv_sigma = 1.0 / params["sigma_logM"]
    centered = log_prim_haloprop - params["logMmin"]
    if log_prim_res is not None:
        centered = centered + log_prim_res
    return 0.5 * erfc(-centered * inv_sigma)


def zheng07_satellites(params, log_prim_haloprop, modulate_with_cenocc=False,
                       log_prim_res=None):
    """<N_sat> as a pure function of a params dict and log10(M).

    ``log_prim_res``: float64 node residual, absorbed analytically —
    d(log10(M - M0))/d(log10 M) = 1/(1 - M0/M), so the exponent picks up
    ``res / (1 - ratio)`` (exact to second order in the ~5e-7 residual);
    see :func:`zheng07_centrals` for why this replaces a traced JVP.
    """
    xp = get_namespace(log_prim_haloprop)
    log_m = log_prim_haloprop
    log_m0 = params["logM0"]
    # log10(M - M0), computed stably in log space; clamp the argument of
    # log1p away from -1 so value *and gradient* stay finite even when a
    # node mass sits within one ulp of M0 (in float32, the ratio M0/M
    # can round to exactly 1.0 just above the kink, and the unclamped
    # log1p gradient is then inf * 0 = NaN).
    #
    # The ratio is the product 10**(-logM) * 10**logM0 rather than
    # 10**(logM0 - logM): the two factors depend on only ONE of
    # (node grid, parameter batch) each, so in the batched predictor
    # both exponentials evaluate on small arrays — (1, nodes) and
    # (batch, 1) — and only the multiply touches the broadcast
    # (batch, nodes) array.  (Nodes within ~1e-6 of the kink see the
    # extra rounding amplified by the log1p, but their occupation is a
    # ~1e-6^alpha fraction of neighboring nodes' and the float64 host
    # oracle uses the identical expression, so tabulated and predicted
    # statistics are unaffected at the 1e-6 contract.)
    eps = 1e-12 if xp.asarray(log_m).dtype == xp.float64 else 1e-6
    # exp10/log1p/exp from utils.backend, the compensated float32 forms
    # (on an NVIDIA H100, XLA's own f32 exp reaches 1.5e-7 relative and
    # log1p 2.7e-7 absolute, the same level; see utils.backend).
    ratio = xp.minimum(exp10(-log_m) * exp10(log_m0), 1.0 - eps)
    # (log_m - logM1) FIRST: both operands are ~12-15 but their
    # difference is ~0-3, and close float32 subtractions are exact
    # (Sterbenz), so no ~15-magnitude intermediate is ever rounded —
    # summing log_m + log1p()/ln10 first would round that intermediate
    # at ulp(15)/2 ~ 4.8e-7 absolute, a ~1e-6 relative error on Nsat
    # after exp(ln10 * alpha * .): the largest single float32 error in
    # the satellite path.
    # log1p_abs: the log1p term is added to the O(1) difference below,
    # so only its ABSOLUTE error matters (~6e-8, single-branch form).
    log_pow = (log_m - params["logM1"]) + log1p_abs(-ratio) / _LN10
    if log_prim_res is not None:
        log_pow = log_pow + log_prim_res / (1.0 - ratio)
    nsat = exp(_LN10 * params["alpha"] * log_pow)
    nsat = xp.where(log_m > log_m0, nsat, 0.0)
    if modulate_with_cenocc:
        nsat = nsat * zheng07_centrals(params, log_prim_haloprop,
                                       log_prim_res=log_prim_res)
    return nsat


class Zheng07Model(HodModel):
    """Zheng07 HOD model (cens + sats), the reference's workhorse model.

    Parameters
    ----------
    threshold : float, optional
        SDSS luminosity threshold selecting default parameters from
        Zheng et al. (2007) Table 1. Default is -20.
    modulate_with_cenocc : bool, optional
        If True, multiply <N_sat> by <N_cen> (halotools option). Default is
        False, matching halotools' plain zheng07 dictionary.
    **params : dict
        Overrides for logMmin, sigma_logM, logM0, logM1, alpha.
    """

    param_names = ("logMmin", "sigma_logM", "logM0", "logM1", "alpha")

    def __init__(self, threshold=-20.0, modulate_with_cenocc=False,
                 prim_haloprop_key="halo_mvir",
                 sec_haloprop_key=None, redshift=0.0, **params):
        if threshold not in ZHENG07_THRESHOLD_PARAMS:
            raise ValueError(f"No Zheng07 parameters for threshold "
                             f"{threshold}; choose from "
                             f"{sorted(ZHENG07_THRESHOLD_PARAMS)}.")
        self.param_defaults = dict(ZHENG07_THRESHOLD_PARAMS[threshold])
        self.threshold = threshold
        self.modulate_with_cenocc = modulate_with_cenocc
        super().__init__(prim_haloprop_key=prim_haloprop_key,
                         sec_haloprop_key=sec_haloprop_key,
                         redshift=redshift, **params)

    def occupation(self, params, gal_type, log_prim_haloprop,
                   sec_haloprop_percentile):
        if gal_type == CENTRALS:
            return zheng07_centrals(params, log_prim_haloprop)
        return zheng07_satellites(
            params, log_prim_haloprop,
            modulate_with_cenocc=self.modulate_with_cenocc)

    def occupation_residual(self, params, gal_type, log_prim_haloprop,
                            log_prim_res, sec_haloprop_percentile):
        if gal_type == CENTRALS:
            return zheng07_centrals(params, log_prim_haloprop,
                                    log_prim_res=log_prim_res)
        return zheng07_satellites(
            params, log_prim_haloprop,
            modulate_with_cenocc=self.modulate_with_cenocc,
            log_prim_res=log_prim_res)
