"""Parameter-grid interpolation of tabulations.

Equivalent of the reference's ``Interpolator`` (reference:
tabcorr/interpolator.py:11-216): holds N ``TabCorr`` instances on a full
rectangular parameter grid and cubic-spline-interpolates predictions across
the grid.

Design differences from the reference, both deliberate:

* The not-a-knot spline coefficient matrices are built per interval in the
  *local shifted* polynomial basis ``(x - x_k)^p`` (via scipy's
  ``CubicSpline`` applied to identity y-vectors) instead of the reference's
  global power basis (reference: tabcorr/interpolator.py:219-272), whose
  4n x 4n Vandermonde-style inversion is ill-conditioned in raw parameter
  units.  The interpolant is mathematically identical (same not-a-knot
  spline).
* Evaluation is available both as a float64 host path with reference
  semantics (including the extrapolation error) and as a pure JAX gather +
  einsum (:func:`spline_eval`) that is jit/vmap/grad-able for batched,
  on-device interpolation.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import CubicSpline

from .io import ColumnTable, open_tree
from .table import TabCorr


def spline_interpolation_matrix(xp):
    """Not-a-knot cubic-spline coefficient-from-values matrices.

    Parameters
    ----------
    xp : numpy.ndarray
        Strictly increasing abscissa with at least 4 entries.

    Returns
    -------
    a : numpy.ndarray of shape (n_intervals, 4, n_points)
        For interval ``k`` and y-values ``y``, the spline value at ``x`` in
        that interval is ``sum_p sum_j a[k, p, j] y[j] (x - xp[k])^p``.
    """
    xp = np.asarray(xp, dtype=np.float64)
    if len(xp) < 4:
        raise ValueError("Cannot perform spline interpolation with less "
                         "than 4 values.")
    # CubicSpline on identity y-vectors yields the linear map from y-values
    # to local polynomial coefficients; default bc_type is not-a-knot.
    spline = CubicSpline(xp, np.eye(len(xp)), axis=0)
    # spline.c has shape (4, n_intervals, n_points) in descending powers.
    return np.ascontiguousarray(np.transpose(spline.c[::-1], (1, 0, 2)))


def _locate_interval(x, xp):
    """Interval index with reference edge semantics (interpolator.py:319-321)."""
    i = np.digitize(x, xp) - 1
    if x == xp[-1]:
        i = len(xp) - 2
    return i


def spline_interpolate(x, xp, a, yp, extrapolate=False):
    """Evaluate one or more (multi-dimensional) not-a-knot splines.

    Host float64 path with the reference's semantics (reference:
    tabcorr/interpolator.py:275-331): interpolates ``yp`` along its first
    ``len(x)`` axes, one grid axis per pass; raises if out of range and
    ``extrapolate`` is False, else clamps to the edge spline.
    """
    if not isinstance(xp, list):
        xp = [xp]
    if not isinstance(a, list):
        a = [a]
    x = np.atleast_1d(x)

    for xi, ai, xpi in zip(x, a, xp):
        i = _locate_interval(xi, xpi)
        if i < 0 or i >= len(xpi) - 1:
            if not extrapolate:
                raise ValueError(
                    "The x-coordinates are outside of the interpolation "
                    "range and extrapolation is turned off.")
            i = min(max(i, 0), len(xpi) - 2)
        dx = xi - xpi[i]
        yp = np.einsum("pj,j...,p->...", ai[i], yp, dx ** np.arange(4))
    return yp


def spline_eval(x, xp, a, yp, extrapolate=True):
    """Pure-JAX spline evaluation along the leading axis of ``yp``.

    Differentiable and vmap-able; ``xp``/``a`` are device arrays.  With
    ``extrapolate=True`` out-of-range ``x`` clamps to the edge splines;
    with ``extrapolate=False`` the result is NaN outside [xp[0], xp[-1]]
    — the jit-able analog of the reference's out-of-range ValueError
    (reference: tabcorr/interpolator.py:322-327), so an MCMC walker
    outside the grid poisons its likelihood instead of silently clamping.
    """
    import jax
    import jax.numpy as jnp

    i = jnp.clip(jnp.searchsorted(xp, x, side="right") - 1, 0,
                 xp.shape[0] - 2)
    dx = x - xp[i]
    # Powers by multiplication: jax.lax.pow of a negative base with a float
    # exponent is NaN, unlike numpy's integer-exponent fast path.
    one = jnp.ones((), dtype=yp.dtype)
    powers = jnp.stack([one, dx, dx * dx, dx * dx * dx])
    out = jnp.einsum("pj,j...,p->...", a[i], yp, powers,
                     precision=jax.lax.Precision.HIGHEST)
    if not extrapolate:
        in_range = (x >= xp[0]) & (x <= xp[-1])
        out = jnp.where(in_range, out, jnp.nan)
    return out


class Interpolator:
    """Interpolation of multiple TabCorr instances over a parameter grid."""

    def __init__(self, tabcorr_list, param_dict_table):
        if len(tabcorr_list) != len(param_dict_table):
            raise ValueError("The number of TabCorr instances does not match"
                             " the number of entries in 'param_dict_table'.")

        self.tabcorr_list = list(tabcorr_list)
        if not isinstance(param_dict_table, ColumnTable):
            param_dict_table = ColumnTable(
                {k: np.asarray(v) for k, v in dict(param_dict_table).items()})
        self.param_dict_table = param_dict_table.copy()

        self.keys = [k for k in self.param_dict_table.colnames
                     if k != "tabcorr_index"]
        self.xp = []
        self.a = []
        for key in self.keys:
            self.xp.append(np.sort(np.unique(self.param_dict_table[key])))
            self.a.append(spline_interpolation_matrix(self.xp[-1]))

        # Grid validation (reference: tabcorr/interpolator.py:45-57).
        rows = np.stack([self.param_dict_table[k] for k in self.keys], axis=1)
        n_grid = int(np.prod([len(xp) for xp in self.xp]))
        if (n_grid != len(self.param_dict_table) or
                len(np.unique(rows, axis=0)) != len(rows)):
            raise ValueError(
                "The 'param_dict_table' does not describe a grid.")

        if "tabcorr_index" not in self.param_dict_table:
            self.param_dict_table["tabcorr_index"] = np.arange(
                len(self.param_dict_table))
        self.param_dict_table.sort(self.keys)

        # Dedup identical halo binnings so mean occupations are computed
        # once per unique gal_type table (reference: interpolator.py:63-70).
        digests = [t.gal_type.as_structured_array().tobytes()
                   for t in self.tabcorr_list]
        seen = {}
        self.unique_gal_type_index = []
        self.unique_gal_type_inverse = np.empty(len(digests), dtype=int)
        for i, digest in enumerate(digests):
            if digest not in seen:
                seen[digest] = len(self.unique_gal_type_index)
                self.unique_gal_type_index.append(i)
            self.unique_gal_type_inverse[i] = seen[digest]

    # ------------------------------------------------------------------
    @classmethod
    def read(cls, fname):
        """Read an interpolator (reference schema, interpolator.py:72-96)
        from an HDF5 or ``.npz`` path."""
        tabcorr_list = []
        with open_tree(fname) as fstream:
            param_dict_table = ColumnTable.read_hdf5(
                fstream, "param_dict_table")
            param_dict_table.sort("tabcorr_index")
            param_dict_table.remove_column("tabcorr_index")
            for i in range(len(param_dict_table)):
                tabcorr_list.append(TabCorr.read(fstream[f"tabcorr_{i}"]))
        return cls(tabcorr_list, param_dict_table)

    def write(self, fname, overwrite=False, max_args_size=1000000,
              matrix_dtype=np.float32):
        """Write an interpolator (reference schema, interpolator.py:98-122)."""
        with open_tree(fname, "w" if overwrite else "w-") as fstream:
            self.param_dict_table.write_hdf5(fstream, "param_dict_table")
            for i in range(len(self.param_dict_table)):
                self.tabcorr_list[i].write(
                    fstream.create_group(f"tabcorr_{i}"),
                    max_args_size=max_args_size, matrix_dtype=matrix_dtype)

    # ------------------------------------------------------------------
    def predict(self, model, separate_gal_type=False, n_gauss_prim=10,
                extrapolate=False, check_consistency=True, **occ_kwargs):
        """Interpolated prediction (reference: interpolator.py:124-216).

        Interpolation-parameter values are read from ``model.param_dict``.
        """
        x_model = np.empty(len(self.keys))
        for i, key in enumerate(self.keys):
            try:
                x_model[i] = model.param_dict[key]
            except KeyError:
                raise ValueError(
                    f"The key {key} is not present in the parameter "
                    "dictionary of the model.")

        mean_occupation = [
            self.tabcorr_list[i].mean_occupation(
                model, n_gauss_prim=n_gauss_prim,
                check_consistency=check_consistency, **occ_kwargs)
            for i in self.unique_gal_type_index]

        results = []
        for i in range(len(self.param_dict_table)):
            k = self.param_dict_table["tabcorr_index"][i]
            results.append(self.tabcorr_list[k].predict(
                mean_occupation[self.unique_gal_type_inverse[k]],
                separate_gal_type=separate_gal_type))

        grid_shape = [len(xp) for xp in self.xp]
        output = []
        for i in range(2):
            if separate_gal_type:
                out = {}
                for key in results[0][i].keys():
                    data = np.array([r[i][key] for r in results])
                    data = data.reshape(grid_shape + list(data.shape[1:]))
                    out[key] = spline_interpolate(
                        x_model, self.xp, self.a, data,
                        extrapolate=extrapolate)
                output.append(out)
            else:
                data = np.array([r[i] for r in results])
                data = data.reshape(grid_shape + list(data.shape[1:]))
                output.append(spline_interpolate(
                    x_model, self.xp, self.a, data, extrapolate=extrapolate))
        return tuple(output)

    def make_predictor(self, model, **kwargs):
        """Jitted batched predictor through the grid splines.

        Convenience for :func:`tabcorr_tpu.predictor.make_predictor`.
        """
        from .predictor import make_predictor
        return make_predictor(self, model, **kwargs)

    def __repr__(self):
        return (f"Interpolator(keys={self.keys}, "
                f"grid={[len(xp) for xp in self.xp]}, "
                f"n_tables={len(self.tabcorr_list)})")
