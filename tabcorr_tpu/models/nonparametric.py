"""Non-parametric HOD: per-bin mean occupations as free parameters.

The tabulation method makes non-parametric HOD inference (PAPERS.md:
arXiv 2603.18379) essentially free: with one occupation value per
tabulated halo bin the predicted statistic is an *exact* quadratic
(auto mode) or linear (cross mode) form in the parameter vector — no
quadrature, no functional form, and the whole posterior gradient is a
single batched contraction.  The reference has no analog (its predict
consumes halotools models only, reference: tabcorr/tabcorr.py:556-563,
though it accepts a raw mean-occupation array internally,
reference: tabcorr/tabcorr.py:616-621); this module makes that internal
hook a first-class, differentiable, batch-native model family.

Two entry points:

* :class:`NonparametricHodModel` — an :class:`~.protocol.HodModel` whose
  occupation is piecewise constant over a fixed set of (log prim, sec
  percentile) cells, one parameter per cell.  Built from a tabulation's
  own bins via :meth:`NonparametricHodModel.from_table`, in which case
  quadrature reproduces the parameters *exactly* (a constant integrates
  to itself under the normalized per-bin measure), so every existing
  predictor engine works unchanged.
* :func:`make_occupation_predictor` (in ``tabcorr_tpu.predictor``) — the
  fast path: batched (B, n_bins) occupation vectors straight into the
  dense contraction, skipping the occupation trace entirely.

``smoothness_log_prior`` supplies the standard second-difference
regularization that non-parametric occupation inference needs to tame
bins the data cannot constrain.
"""

from __future__ import annotations

import numpy as np

from ..utils.backend import get_namespace
from .protocol import CENTRALS, SATELLITES, HodModel


def _piecewise_constant(values, log_prim, sec, lo, hi, smin, smax, top):
    """sum_i values_i * 1[(log_prim, sec) in cell_i]; branchless.

    Cells are half-open [lo, hi) x [smin, smax); rows flagged ``top``
    include their upper prim edge (the global maximum, matching numpy
    digitize-into-edges semantics), and the sec upper edge is inclusive
    at 1.0.  Points outside every cell get occupation 0.

    values: (n,) parameter vector (batch by ``vmap`` at the predictor
    level); log_prim/sec: query arrays of any shape.  O(n_cells)
    elementwise — no gather, so it traces on host numpy and XLA alike.
    """
    xp = get_namespace(log_prim, values)
    lp = xp.asarray(log_prim)[..., None]           # (..., 1) vs (n,)
    sc = xp.asarray(sec)[..., None]
    inside = ((lp >= lo) & ((lp < hi) | (top & (lp <= hi))) &
              (sc >= smin) &
              ((sc < smax) | ((smax >= 1.0) & (sc <= smax))))
    return xp.sum(xp.where(inside, values,
                           xp.zeros((), dtype=lp.dtype)), axis=-1)


class NonparametricHodModel(HodModel):
    """HOD model with one free mean-occupation value per halo cell.

    Parameters
    ----------
    cells_cen, cells_sat : dict of arrays
        Per-type cell definitions with keys ``log_prim_min``,
        ``log_prim_max``, ``sec_min``, ``sec_max`` (each (n_t,) float).
    values_cen, values_sat : array-like, optional
        Initial occupations (default 0).
    **kwargs
        ``prim_haloprop_key``, ``sec_haloprop_key``, ``redshift``
        (see :class:`~.protocol.HodModel`).

    Parameters are named ``n_cen_{i}`` / ``n_sat_{i}`` in cell order, so
    the model drives every existing predictor (host float64, batched
    XLA) and MCMC helper unchanged; for large batches prefer the direct
    vector path (:func:`tabcorr_tpu.predictor.make_occupation_predictor`).

    The occupation is piecewise constant, so the quadrature node
    residual needs no correction (a sub-ulp shift in log M never crosses
    a cell edge) — ``occupation_residual`` is the occupation itself.
    """


    def __init__(self, cells_cen, cells_sat, values_cen=None,
                 values_sat=None, **kwargs):
        self._cells = {CENTRALS: {k: np.asarray(v, dtype=np.float64)
                                  for k, v in cells_cen.items()},
                       SATELLITES: {k: np.asarray(v, dtype=np.float64)
                                    for k, v in cells_sat.items()}}
        n_cen = len(self._cells[CENTRALS]["log_prim_min"])
        n_sat = len(self._cells[SATELLITES]["log_prim_min"])
        if n_cen == 0 or n_sat == 0:
            raise ValueError(
                "Each galaxy type needs at least one cell (got "
                f"{n_cen} centrals, {n_sat} satellites).")
        for gal_type, cells in self._cells.items():
            n = len(cells["log_prim_min"])
            if any(len(cells[k]) != n for k in cells):
                raise ValueError(f"Inconsistent {gal_type} cell arrays.")
            # Rows carrying the global upper prim edge are closed above.
            cells["top"] = (cells["log_prim_max"] >=
                            np.max(cells["log_prim_max"]) - 1e-12)
        v_cen = np.zeros(n_cen) if values_cen is None \
            else np.asarray(values_cen, dtype=np.float64)
        v_sat = np.zeros(n_sat) if values_sat is None \
            else np.asarray(values_sat, dtype=np.float64)
        if len(v_cen) != n_cen or len(v_sat) != n_sat:
            raise ValueError("values length must match the cell count.")
        self.param_defaults = {
            **{f"n_cen_{i}": float(v) for i, v in enumerate(v_cen)},
            **{f"n_sat_{i}": float(v) for i, v in enumerate(v_sat)}}
        self._names = {CENTRALS: tuple(f"n_cen_{i}" for i in range(n_cen)),
                       SATELLITES: tuple(f"n_sat_{i}"
                                         for i in range(n_sat))}
        super().__init__(**kwargs)

    @classmethod
    def from_table(cls, tab, values_cen=None, values_sat=None, **kwargs):
        """Build on a tabulation's own halo bins.

        Cell edges come straight from the ``gal_type`` table rows, so
        each quadrature node of :meth:`TabCorr.mean_occupation` falls
        inside exactly one cell of its own galaxy type and the quadrature
        returns the parameter values exactly.
        """
        g = tab.gal_type
        # HDF5-loaded tables hold bytes; in-memory ones str.
        types = np.asarray(g["gal_type"]).astype(str)
        cells = {}
        for name in (CENTRALS, SATELLITES):
            m = types == name
            cells[name] = dict(
                log_prim_min=np.asarray(g["log_prim_haloprop_min"])[m],
                log_prim_max=np.asarray(g["log_prim_haloprop_max"])[m],
                sec_min=np.asarray(g["sec_haloprop_percentile_min"])[m],
                sec_max=np.asarray(g["sec_haloprop_percentile_max"])[m])
        kwargs.setdefault("prim_haloprop_key",
                          tab.attrs.get("prim_haloprop_key", "halo_mvir"))
        kwargs.setdefault("redshift", float(tab.attrs.get("redshift", 0.0)))
        return cls(cells[CENTRALS], cells[SATELLITES],
                   values_cen=values_cen, values_sat=values_sat, **kwargs)

    # -- vector <-> param_dict conveniences -------------------------------
    def occupation_vector(self, gal_type=None):
        """Current occupations as a flat array (centrals then satellites,
        the bin order of :meth:`TabCorr.mean_occupation`)."""
        if gal_type is not None:
            return np.array([self.param_dict[k]
                             for k in self._names[gal_type]])
        return np.concatenate([self.occupation_vector(CENTRALS),
                               self.occupation_vector(SATELLITES)])

    def set_occupation_vector(self, values, gal_type=None):
        """Write a flat occupation array back into ``param_dict``."""
        values = np.asarray(values, dtype=np.float64)
        if gal_type is not None:
            names = self._names[gal_type]
            if len(values) != len(names):
                raise ValueError("values length must match the cell count.")
            for k, v in zip(names, values):
                self.param_dict[k] = float(v)
            return
        n_cen = len(self._names[CENTRALS])
        self.set_occupation_vector(values[:n_cen], CENTRALS)
        self.set_occupation_vector(values[n_cen:], SATELLITES)

    # -- protocol ----------------------------------------------------------
    def occupation(self, params, gal_type, log_prim_haloprop,
                   sec_haloprop_percentile):
        xp = get_namespace(log_prim_haloprop,
                           params[self._names[gal_type][0]])
        cells = self._cells[gal_type]
        lp = xp.asarray(log_prim_haloprop)
        values = xp.stack([xp.asarray(params[k], dtype=lp.dtype)
                           for k in self._names[gal_type]], axis=-1)
        return _piecewise_constant(
            values, lp, sec_haloprop_percentile,
            xp.asarray(cells["log_prim_min"], dtype=lp.dtype),
            xp.asarray(cells["log_prim_max"], dtype=lp.dtype),
            xp.asarray(cells["sec_min"], dtype=lp.dtype),
            xp.asarray(cells["sec_max"], dtype=lp.dtype),
            xp.asarray(cells["top"]))

    def occupation_residual(self, params, gal_type, log_prim_haloprop,
                            log_prim_res, sec_haloprop_percentile):
        # Piecewise constant: a sub-ulp node shift cannot cross a cell
        # edge, so the residual absorption is the identity (exact).
        return self.occupation(params, gal_type, log_prim_haloprop,
                               sec_haloprop_percentile)


def smoothness_log_prior(values, scale=1.0, log=True, floor=1e-12):
    """Gaussian second-difference log-prior over an occupation vector.

    The standard regularization for non-parametric occupation inference
    (PAPERS.md: arXiv 2603.18379): penalize curvature of the occupation
    across adjacent mass bins so bins the data cannot constrain follow
    their neighbors instead of wandering.

        log p = -1/2 * sum_i (y[i-1] - 2 y[i] + y[i+1])^2 / scale^2

    with y = log10(max(values, floor)) when ``log`` (occupations span
    decades; curvature in log space is the physical notion of smooth)
    or y = values otherwise.  Pure jax: differentiable, vmap/jit-safe,
    and exactly zero for (log-)linear occupation runs.  Apply per
    galaxy type — a centrals/satellites concatenation has a fake kink
    at the seam.
    """
    xp = get_namespace(values)
    y = values
    if log:
        y = xp.log10(xp.where(values > floor, values,
                              xp.asarray(floor, dtype=values.dtype)))
    d2 = y[..., :-2] - 2.0 * y[..., 1:-1] + y[..., 2:]
    return -0.5 * xp.sum((d2 / scale) ** 2, axis=-1)
