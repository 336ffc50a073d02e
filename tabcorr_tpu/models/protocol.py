"""HOD model protocol.

The reference consumes halotools models through exactly two hooks:
``model.mean_occupation_centrals(prim_haloprop=..., sec_haloprop_percentile=...)``
and ``model.mean_occupation_satellites(...)`` plus a handful of metadata
attributes used in consistency checks (reference: tabcorr/tabcorr.py:496-563).

We replace that contract with a JAX-native protocol: every model exposes a
*pure* occupation function

    occupation(params, gal_type, log_prim_haloprop, sec_haloprop_percentile)

where ``params`` is a dict pytree of scalars (or batched (B,) arrays under
``vmap``).  The stateful ``param_dict`` remains on the model object for
reference-style ergonomics; jitted prediction paths read it once per call and
trace only the pure function.
"""

from __future__ import annotations

import numpy as np

CENTRALS = "centrals"
SATELLITES = "satellites"


class HodModel:
    """Base class for HOD occupation models.

    Subclasses implement :meth:`occupation` as a pure jax-traceable function
    and declare ``param_defaults``.  Instances carry a mutable ``param_dict``
    mirroring the halotools API so user code ported from the reference works
    unchanged.
    """

    gal_types = (CENTRALS, SATELLITES)
    param_defaults: dict = {}

    def __init__(self, prim_haloprop_key="halo_mvir",
                 sec_haloprop_key=None, redshift=0.0, **params):
        self.prim_haloprop_key = prim_haloprop_key
        self.sec_haloprop_key = sec_haloprop_key
        # Plain python float: a numpy scalar here (e.g. straight from
        # HDF5 attrs) is float64 and would silently promote every
        # float32 device-path occupation that mixes in the redshift.
        self.redshift = float(redshift)
        self.param_dict = dict(self.param_defaults)
        unknown = set(params) - set(self.param_dict)
        if unknown:
            raise ValueError(f"Unknown parameters: {sorted(unknown)}")
        self.param_dict.update(params)

    # -- pure core (override in subclasses) ------------------------------
    def occupation(self, params, gal_type, log_prim_haloprop,
                   sec_haloprop_percentile):
        """Mean occupation; pure function of ``params`` (jax-traceable)."""
        raise NotImplementedError

    def occupation_residual(self, params, gal_type, log_prim_haloprop,
                            log_prim_res, sec_haloprop_percentile):
        """Occupation at the double-float node ``log_prim + log_prim_res``.

        ``log_prim_res`` is the float64 residual of the float32-rounded
        quadrature node (|res| < ulp(log_prim)/2, so ``log_prim + res``
        would round it away).  The default recovers it to first order
        via a traced JVP; analytic models should override with an exact
        absorption (see models.zheng07) — it is both more accurate and
        roughly halves the occupation cost by skipping the tangent
        arithmetic.
        """
        import jax
        occ, d = jax.jvp(
            lambda l: self.occupation(params, gal_type, l,
                                      sec_haloprop_percentile),
            (log_prim_haloprop,), (log_prim_res,))
        return occ + d

    # -- reference-compatible conveniences --------------------------------
    def _mean_occupation(self, gal_type, prim_haloprop=None,
                         sec_haloprop_percentile=None, **kwargs):
        prim_haloprop = np.asarray(prim_haloprop, dtype=np.float64)
        if sec_haloprop_percentile is None:
            sec_haloprop_percentile = np.full_like(prim_haloprop, 0.5)
        else:
            sec_haloprop_percentile = np.asarray(
                sec_haloprop_percentile, dtype=np.float64)
        return np.asarray(self.occupation(
            self.param_dict, gal_type, np.log10(prim_haloprop),
            sec_haloprop_percentile))

    def mean_occupation_centrals(self, **kwargs):
        """halotools-signature wrapper (reference: tabcorr/tabcorr.py:556)."""
        return self._mean_occupation(CENTRALS, **kwargs)

    def mean_occupation_satellites(self, **kwargs):
        """halotools-signature wrapper (reference: tabcorr/tabcorr.py:560)."""
        return self._mean_occupation(SATELLITES, **kwargs)

    def param_array(self, names):
        """Pack ``param_dict`` values into a float array in ``names`` order."""
        return np.array([self.param_dict[name] for name in names],
                        dtype=np.float64)
