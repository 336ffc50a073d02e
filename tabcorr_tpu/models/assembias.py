"""Heaviside assembly-bias ("decorated HOD") occupation decoration.

The reference supports assembly bias through halotools' decorated models:
the tabulation bins halos by secondary-property percentile
(``sec_haloprop_percentile_bins``) and the prediction path passes the bin's
percentile midpoint into ``mean_occupation_*`` (reference:
tabcorr/tabcorr.py:550-563).  This module provides the decoration itself,
modeled on halotools' ``HeavisideAssembias``: halos above the percentile
split get their occupation perturbed by ``+delta`` and halos below by
``-delta * (1 - split) / split``, so the mass-conditioned mean occupation is
exactly preserved.  The perturbation amplitude is

    delta = A * min(upper_bound - base, split/(1-split) * (base - lower_bound))    (A >= 0)
    delta = A * min(base - lower_bound, split/(1-split) * (upper_bound - base))    (A < 0)

which keeps the occupation of both populations inside
[lower_bound, upper_bound] for |A| <= 1.  Centrals are bounded by [0, 1],
satellites by [0, inf).
"""

from __future__ import annotations

from ..utils.backend import get_namespace
from .cacciato09 import Cacciato09Model
from .leauthaud11 import Leauthaud11Model
from .protocol import CENTRALS
from .tinker13 import Tinker13Model
from .zheng07 import Zheng07Model
from .zu_mandelbaum15 import ZuMandelbaum15Model


def heaviside_assembias(base, strength, sec_haloprop_percentile, split=0.5,
                        lower_bound=0.0, upper_bound=None):
    """Apply the Heaviside assembly-bias perturbation to a baseline occupation.

    Parameters
    ----------
    base : jnp.ndarray
        Baseline mean occupation.
    strength : float or jnp.ndarray
        Assembly-bias strength A in [-1, 1].
    sec_haloprop_percentile : jnp.ndarray
        Secondary-property percentile of each halo (bin midpoint for
        tabulated bins).
    split : float, optional
        Percentile split between the two populations. Default is 0.5.
    lower_bound, upper_bound : float, optional
        Physical bounds on the occupation. ``upper_bound=None`` means
        unbounded above (satellites).

    Returns
    -------
    jnp.ndarray
        Decorated mean occupation.
    """
    xp = get_namespace(base, sec_haloprop_percentile)
    strength = xp.clip(strength, -1.0, 1.0)
    frac_above = 1.0 - split
    ratio = split / frac_above

    head = base - lower_bound
    if upper_bound is None:
        room_up = ratio * head
        room_down = head
    else:
        room_up = xp.minimum(upper_bound - base, ratio * head)
        room_down = xp.minimum(head, ratio * (upper_bound - base))

    delta = xp.where(strength >= 0, strength * room_up, strength * room_down)
    # Knife-edge robustness: a percentile midpoint can sit within one
    # float64 ulp of the split — a single sec bin spanning
    # [-1e-3, 1 + 1e-3] has midpoint 0.5 - 6e-17, which rounds to
    # exactly 0.5 in the float32 device paths, flipping the branch
    # between engines.  The 1e-6 tolerance makes the float64 host path
    # and the float32 device path classify such bins identically
    # (percentile midpoints of real multi-bin tabulations are O(0.1)
    # away from any split).
    above = sec_haloprop_percentile >= split - 1e-6
    return xp.where(above, base + delta,
                    base - delta * frac_above / split)


class HeavisideAssembiasMixin:
    """Mix-in decorating any :class:`~.protocol.HodModel` with assembly bias.

    Compose as ``class Decorated(HeavisideAssembiasMixin, BaseModel)``.
    Adds the parameters ``mean_occupation_centrals_assembias_param1`` and
    ``mean_occupation_satellites_assembias_param1`` (names chosen for
    compatibility with halotools' decorated models).  The mix-in does not
    override ``occupation_residual``: the protocol's generic JVP fallback
    differentiates the *decorated* occupation and is therefore correct as
    is; base models with an exact analytic absorption should override it
    in the composed class (see :class:`AssembiasZheng07Model`).
    """

    def __init__(self, split=0.5, sec_haloprop_key="halo_nfw_conc", **kwargs):
        self.split = split
        super().__init__(sec_haloprop_key=sec_haloprop_key, **kwargs)
        self.param_dict.setdefault(
            "mean_occupation_centrals_assembias_param1", 0.0)
        self.param_dict.setdefault(
            "mean_occupation_satellites_assembias_param1", 0.0)

    def occupation(self, params, gal_type, log_prim_haloprop,
                   sec_haloprop_percentile):
        base = super().occupation(params, gal_type, log_prim_haloprop,
                                  sec_haloprop_percentile)
        return self._decorate(params, gal_type, base,
                              sec_haloprop_percentile)

    def _decorate(self, params, gal_type, base, sec_haloprop_percentile):
        if gal_type == CENTRALS:
            strength = params["mean_occupation_centrals_assembias_param1"]
            return heaviside_assembias(
                base, strength, sec_haloprop_percentile, split=self.split,
                lower_bound=0.0, upper_bound=1.0)
        strength = params["mean_occupation_satellites_assembias_param1"]
        return heaviside_assembias(
            base, strength, sec_haloprop_percentile, split=self.split,
            lower_bound=0.0, upper_bound=None)


class AssembiasZheng07Model(HeavisideAssembiasMixin, Zheng07Model):
    """Zheng07 model with Heaviside assembly bias on centrals and satellites."""

    def occupation_residual(self, params, gal_type, log_prim_haloprop,
                            log_prim_res, sec_haloprop_percentile):
        # The decoration depends on log10(M) only through the baseline
        # occupation, so the exact zheng07 residual absorption composes.
        base = super().occupation_residual(params, gal_type,
                                           log_prim_haloprop, log_prim_res,
                                           sec_haloprop_percentile)
        return self._decorate(params, gal_type, base,
                              sec_haloprop_percentile)


class AssembiasLeauthaud11Model(HeavisideAssembiasMixin, Leauthaud11Model):
    """Leauthaud11 model with Heaviside assembly bias on both galaxy types.

    The decoration depends on log10(M) only through the baseline
    occupation, so the base model's implicit-function-theorem residual
    absorption composes (same pattern as :class:`AssembiasZheng07Model`).
    """

    def occupation_residual(self, params, gal_type, log_prim_haloprop,
                            log_prim_res, sec_haloprop_percentile):
        base = super().occupation_residual(params, gal_type,
                                           log_prim_haloprop, log_prim_res,
                                           sec_haloprop_percentile)
        return self._decorate(params, gal_type, base,
                              sec_haloprop_percentile)


class AssembiasZuMandelbaum15Model(HeavisideAssembiasMixin,
                                   ZuMandelbaum15Model):
    """Zu & Mandelbaum (2015) model with Heaviside assembly bias.

    halotools ships no prebuilt decorated variant of this family; the
    composition here is the same generic HeavisideAssembias decoration
    halotools applies to any occupation component.  Like Leauthaud11,
    the base model's exact residual absorption composes through the
    decoration.
    """

    def occupation_residual(self, params, gal_type, log_prim_haloprop,
                            log_prim_res, sec_haloprop_percentile):
        base = super().occupation_residual(params, gal_type,
                                           log_prim_haloprop, log_prim_res,
                                           sec_haloprop_percentile)
        return self._decorate(params, gal_type, base,
                              sec_haloprop_percentile)


class AssembiasCacciato09Model(HeavisideAssembiasMixin, Cacciato09Model):
    """Cacciato09 CLF model with Heaviside assembly bias on both types.

    Same generic decoration as the other families (halotools ships no
    prebuilt decorated CLF either); ``occupation_residual`` stays the
    generic JVP fallback.
    """


class AssembiasTinker13Model(HeavisideAssembiasMixin, Tinker13Model):
    """Tinker13 quiescent/active model with Heaviside assembly bias.

    The generic decoration applies to the instance's ``sfr_designation``
    occupation as a whole.  For a single-population designation
    ('quiescent'/'active') the central occupation is bounded by the
    population's own ceiling — f_q(Mh) resp. 1 - f_q(Mh), not 1 — so
    the decorated occupation stays physical for any |A| <= 1 and two
    instances sharing a ``param_dict`` sum to at most one central per
    halo.  The base model's exact residual absorption composes through
    the decoration like the other families.
    """

    def _central_ceiling(self, params, log_prim_haloprop,
                         log_prim_res=None):
        from .tinker13 import QUIESCENT, tinker13_quiescent_fraction
        fq = tinker13_quiescent_fraction(
            params, log_prim_haloprop,
            abscissa=self.quiescent_fraction_abscissa,
            log_prim_res=log_prim_res)
        return fq if self.sfr_designation == QUIESCENT else 1.0 - fq

    def _decorate_centrals(self, params, base, sec_haloprop_percentile,
                           log_prim_haloprop, log_prim_res=None):
        strength = params["mean_occupation_centrals_assembias_param1"]
        upper = self._central_ceiling(params, log_prim_haloprop,
                                      log_prim_res=log_prim_res)
        return heaviside_assembias(
            base, strength, sec_haloprop_percentile, split=self.split,
            lower_bound=0.0, upper_bound=upper)

    def occupation(self, params, gal_type, log_prim_haloprop,
                   sec_haloprop_percentile):
        base = Tinker13Model.occupation(
            self, params, gal_type, log_prim_haloprop,
            sec_haloprop_percentile)
        if gal_type == CENTRALS and self.sfr_designation != "all":
            return self._decorate_centrals(params, base,
                                           sec_haloprop_percentile,
                                           log_prim_haloprop)
        return self._decorate(params, gal_type, base,
                              sec_haloprop_percentile)

    def occupation_residual(self, params, gal_type, log_prim_haloprop,
                            log_prim_res, sec_haloprop_percentile):
        base = Tinker13Model.occupation_residual(
            self, params, gal_type, log_prim_haloprop, log_prim_res,
            sec_haloprop_percentile)
        if gal_type == CENTRALS and self.sfr_designation != "all":
            return self._decorate_centrals(params, base,
                                           sec_haloprop_percentile,
                                           log_prim_haloprop,
                                           log_prim_res=log_prim_res)
        return self._decorate(params, gal_type, base,
                              sec_haloprop_percentile)
