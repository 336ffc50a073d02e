"""High-level batched prediction: the framework's hot path.

``make_predictor`` turns a :class:`~.table.TabCorr` or
:class:`~.interpolator.Interpolator` plus an HOD model into one jitted,
batch-native function

    f(params: dict[str, (B,) array]) -> (ngal (B,), xi (B, *tpcf_shape))

that evaluates an entire MCMC ensemble per call.  This is the batched
replacement for looping the reference's ~1 ms ``predict``
(reference docs: one evaluation per call, docs/guides/overview.rst:85-92);
here 10^5+ evaluations ride one jitted call, and gradients are free.

For the Interpolator path the whole pipeline — mean occupation per unique
halo binning, per-grid-node contraction, multi-axis not-a-knot spline — is
traced into the same jit (reference equivalents:
tabcorr/interpolator.py:124-216).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .interpolator import Interpolator, spline_eval
from .models.protocol import CENTRALS, SATELLITES
from .ops.predict import (mean_occupation, predict_from_occupation,
                          predict_from_occupation_separate)
from .table import TabCorr


def occupation_functions(model):
    """Extract the pure (params, logM, sec_percentile) occupation pair.

    Each callable carries a ``with_residual`` attribute bound to the
    model's ``occupation_residual`` (exact node-residual absorption for
    analytic models, generic JVP fallback otherwise); the float32 hot
    paths pick it up via ``ops.predict.occupation_with_residual``.
    """
    def occ_cen(params, log_prim, sec):
        return model.occupation(params, CENTRALS, log_prim, sec)

    def occ_sat(params, log_prim, sec):
        return model.occupation(params, SATELLITES, log_prim, sec)

    occ_cen.with_residual = (
        lambda params, log_prim, res, sec:
        model.occupation_residual(params, CENTRALS, log_prim, res, sec))
    occ_sat.with_residual = (
        lambda params, log_prim, res, sec:
        model.occupation_residual(params, SATELLITES, log_prim, res, sec))
    return occ_cen, occ_sat


def _tabcorr_predict_fn(halotab, model, n_gauss, dtype, separate_gal_type):
    table = halotab.table_data(n_gauss=n_gauss, dtype=dtype)
    occ_cen, occ_sat = occupation_functions(model)

    def one(params):
        mean_occ = mean_occupation(table, occ_cen, occ_sat, params)
        if separate_gal_type:
            return predict_from_occupation_separate(table, mean_occ)
        ngal, xi = predict_from_occupation(table, mean_occ)
        return ngal, xi.reshape(table.tpcf_shape)

    return one


def _pad_table_data(table, n_cen, n_sat):
    """Pad a TableData to (n_cen centrals + n_sat satellites) bins.

    Bins are ordered [centrals..., satellites...]; zero rows are inserted
    after each block.  Padded bins carry quad_weight = 0 (mean occupation
    exactly 0), n_h = 0 and zero matrix rows/columns, so they contribute
    nothing to any contraction — this is what lets Interpolator nodes with
    different halo binnings share one stacked jitted pipeline (the
    reference's heterogeneous-binning support, interpolator.py:63-70).
    """
    from .ops.predict import TableData

    n_bins = table.n_h.shape[0]
    old_cen = table.n_centrals
    pad_c = n_cen - old_cen
    pad_s = n_sat - (n_bins - old_cen)
    if pad_c == 0 and pad_s == 0:
        return table
    if pad_c < 0 or pad_s < 0:
        raise ValueError("Cannot pad to fewer bins.")

    def pad_axis(array, axis):
        array = np.asarray(array)
        index = [slice(None)] * array.ndim
        index[axis] = slice(0, old_cen)
        cen = array[tuple(index)]
        index[axis] = slice(old_cen, None)
        sat = array[tuple(index)]
        pad_cen = [(0, 0)] * array.ndim
        pad_cen[axis] = (0, pad_c)
        pad_sat = [(0, 0)] * array.ndim
        pad_sat[axis] = (0, pad_s)
        return np.concatenate([np.pad(cen, pad_cen), np.pad(sat, pad_sat)],
                              axis=axis)

    dense = pad_axis(table.tpcf_dense, 1)
    if table.mode == "auto":
        dense = pad_axis(dense, 2)
    return TableData(
        tpcf_dense=jnp.asarray(dense, dtype=table.tpcf_dense.dtype),
        n_h=jnp.asarray(pad_axis(table.n_h, 0), dtype=table.n_h.dtype),
        log_prim_quad=jnp.asarray(pad_axis(table.log_prim_quad, 0),
                                  dtype=table.log_prim_quad.dtype),
        quad_weight=jnp.asarray(pad_axis(table.quad_weight, 0),
                                dtype=table.quad_weight.dtype),
        sec_perc=jnp.asarray(pad_axis(table.sec_perc, 0),
                             dtype=table.sec_perc.dtype),
        mode=table.mode, tpcf_shape=table.tpcf_shape, n_centrals=n_cen,
        log_prim_quad_lo=(None if table.log_prim_quad_lo is None else
                          jnp.asarray(pad_axis(table.log_prim_quad_lo, 0),
                                      dtype=table.log_prim_quad.dtype)))


def _interpolator_predict_fn(interp, model, n_gauss, dtype,
                             separate_gal_type, extrapolate):
    # Stack the per-node tables; grid order = the sorted param_dict_table
    # (reference: interpolator.py:59-61,188-194).
    order = [int(i) for i in interp.param_dict_table["tabcorr_index"]]
    tables = [interp.tabcorr_list[i].table_data(n_gauss=n_gauss, dtype=dtype)
              for i in order]
    # Heterogeneous node binnings: zero-pad every node to the widest
    # (centrals, satellites) block sizes so the tables stack.
    n_cen = max(t.n_centrals for t in tables)
    n_sat = max(t.n_h.shape[0] - t.n_centrals for t in tables)
    tables = [_pad_table_data(t, n_cen, n_sat) for t in tables]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *tables)

    # Unique halo binnings (usually one): occupations computed once per
    # unique binning, then gathered per node (reference: interpolator.py:
    # 63-70, 179-184).
    unique_nodes = [order.index(i) if i in order else 0
                    for i in interp.unique_gal_type_index]
    inverse_for_node = tuple(
        int(interp.unique_gal_type_inverse[i]) for i in order)

    occ_cen, occ_sat = occupation_functions(model)
    keys = tuple(interp.keys)
    xp_dev = [jnp.asarray(xp, dtype=dtype) for xp in interp.xp]
    a_dev = [jnp.asarray(a, dtype=dtype) for a in interp.a]
    grid_shape = tuple(len(xp) for xp in interp.xp)

    def one(params):
        occ_unique = jnp.stack([
            mean_occupation(
                jax.tree.map(lambda x, k=k: x[k], stacked),
                occ_cen, occ_sat, params)
            for k in unique_nodes])
        occ_nodes = occ_unique[jnp.asarray(inverse_for_node)]

        if separate_gal_type:
            ngal_nodes, xi_nodes = jax.vmap(
                predict_from_occupation_separate)(stacked, occ_nodes)
            out_ngal, out_xi = {}, {}
            for key, val in ngal_nodes.items():
                out_ngal[key] = _spline_over_grid(
                    params, keys, xp_dev, a_dev, grid_shape, val,
                    extrapolate)
            for key, val in xi_nodes.items():
                out_xi[key] = _spline_over_grid(
                    params, keys, xp_dev, a_dev, grid_shape, val,
                    extrapolate)
            return out_ngal, out_xi

        ngal_nodes, xi_nodes = jax.vmap(
            predict_from_occupation)(stacked, occ_nodes)
        ngal = _spline_over_grid(params, keys, xp_dev, a_dev, grid_shape,
                                 ngal_nodes, extrapolate)
        xi = _spline_over_grid(params, keys, xp_dev, a_dev, grid_shape,
                               xi_nodes, extrapolate)
        return ngal, xi.reshape(tables[0].tpcf_shape)

    return one


def _spline_over_grid(params, keys, xp_dev, a_dev, grid_shape, values,
                      extrapolate=True):
    """Reduce the leading grid axes of ``values`` one spline pass per key."""
    y = values.reshape(grid_shape + values.shape[1:])
    for key, xp, a in zip(keys, xp_dev, a_dev):
        y = spline_eval(params[key], xp, a, y, extrapolate=extrapolate)
    return y


def _compile(fn, jit, mesh, batch_axis):
    """jit ``fn``; with a mesh, split its batch axis over ``batch_axis``.

    Inputs and outputs are batch-sharded and the tables replicated, so
    each device evaluates its slice of the batch with no communication.
    """
    if mesh is None:
        return jax.jit(fn) if jit else fn
    from jax.sharding import NamedSharding, PartitionSpec

    sharding = NamedSharding(mesh, PartitionSpec(batch_axis))

    def sharded(params):
        params = jax.lax.with_sharding_constraint(params, sharding)
        return jax.lax.with_sharding_constraint(fn(params), sharding)

    return jax.jit(sharded)


def make_predictor(obj, model, n_gauss=10, dtype=jnp.float32,
                   separate_gal_type=False, vectorized=True, jit=True,
                   extrapolate=False, mesh=None, batch_axis="dp"):
    """Build a batched prediction function for a tabulation or interpolator.

    Parameters
    ----------
    obj : TabCorr or Interpolator
        The tabulation(s) to predict from.
    model : HodModel
        Supplies the pure occupation functions and the parameter names.
    n_gauss : int, optional
        Gauss-Legendre nodes per halo bin. Default is 10.
    dtype : jnp.dtype, optional
        Device dtype; float32 is the fast path (<~1e-6 relative of the
        float64 path), float64 bit-matches the host parity path.
    separate_gal_type : bool, optional
        Return per-galaxy-type dictionaries.
    vectorized : bool, optional
        If True the returned function maps dicts of (B,) arrays; if False,
        dicts of scalars.
    jit : bool, optional
        Wrap in ``jax.jit``.
    extrapolate : bool, optional
        Interpolator grids only.  False (default, matching the reference's
        out-of-range ValueError, tabcorr/interpolator.py:322-327) returns
        NaN for parameters outside the grid — pair with a log posterior
        that maps non-finite predictions to -inf.  True clamps to the
        edge splines.
    mesh : jax.sharding.Mesh, optional
        Batch-shard the (vectorized, jitted) predictor over the mesh
        along ``batch_axis``: tables replicated, zero hot-loop
        communication.  The batch must divide over the axis.  For a
        table-parallel split see ``parallel.make_sharded_predict``.

    Returns
    -------
    callable
        ``f(params) -> (ngal, xi)``.
    """
    if isinstance(obj, Interpolator):
        one = _interpolator_predict_fn(obj, model, n_gauss, dtype,
                                       separate_gal_type, extrapolate)
    elif isinstance(obj, TabCorr):
        one = _tabcorr_predict_fn(obj, model, n_gauss, dtype,
                                  separate_gal_type)
    else:
        raise TypeError(f"Cannot build a predictor for {type(obj)}.")
    if mesh is not None and not (vectorized and jit):
        raise ValueError("mesh= needs vectorized=True and jit=True.")

    fn = jax.vmap(one) if vectorized else one
    return _compile(fn, jit, mesh, batch_axis)


def make_multi_predictor(objs, model, n_gauss=10, dtype=jnp.float32,
                         jit=True, mesh=None, batch_axis="dp"):
    """Joint predictor over several tabulations (e.g. wp + xi_0/2/4 + ds).

    Returns ``f(params dict of (B,)) -> list of (ngal, xi)`` evaluating all
    statistics for the same parameter batch in one jitted call — the shape
    of a full multi-probe MCMC likelihood evaluation.  ``objs`` may mix
    TabCorr and Interpolator objects.  ``mesh`` batch-shards the call as
    in :func:`make_predictor`.
    """
    fns = [make_predictor(obj, model, n_gauss=n_gauss, dtype=dtype,
                          jit=False) for obj in objs]

    def predict_all(params):
        return [fn(params) for fn in fns]

    if mesh is not None and not jit:
        raise ValueError("mesh= needs jit=True.")
    return _compile(predict_all, jit, mesh, batch_axis)


def make_occupation_predictor(obj, dtype=jnp.float32, jit=True,
                              separate_gal_type=False):
    """Batched predictor over raw per-bin mean-occupation vectors.

    The non-parametric fast path (see ``models.nonparametric``): the
    statistic is an exact quadratic (auto) / linear (cross) form in the
    occupation vector, so prediction skips the occupation trace entirely
    and is a single batched contraction — jit/vmap/grad-native.
    The reference exposes this only as an internal hook
    (reference: tabcorr/tabcorr.py:616-621, predict with an ndarray).

    Returns ``f(occ (..., n_bins)) -> (ngal (...,), xi (..., *shape))``
    with bins ordered [centrals..., satellites...] like
    :meth:`TabCorr.mean_occupation`; ``separate_gal_type`` returns the
    per-type dicts instead.  Batch-sharded inputs propagate through jit
    (dp-shard the leading axis for multi-chip batches).
    """
    table = obj.table_data(n_gauss=1, dtype=dtype) \
        if isinstance(obj, TabCorr) else obj

    def f(occ):
        occ = jnp.asarray(occ, dtype=dtype)
        if separate_gal_type:
            ngal_dict, xi_dict = predict_from_occupation_separate(table, occ)
            xi_dict = {k: v.reshape(occ.shape[:-1] + tuple(table.tpcf_shape))
                       for k, v in xi_dict.items()}
            return ngal_dict, xi_dict
        ngal, xi = predict_from_occupation(table, occ)
        return ngal, xi.reshape(occ.shape[:-1] + tuple(table.tpcf_shape))

    return jax.jit(f) if jit else f


def params_batch(model, overrides=None, batch_shape=(), dtype=jnp.float32):
    """Assemble a batched parameter dict from a model's param_dict.

    ``overrides`` maps parameter names to (B,)-shaped arrays; all other
    parameters are broadcast from the model's current values.
    """
    overrides = overrides or {}
    out = {}
    for key, value in model.param_dict.items():
        if key in overrides:
            out[key] = jnp.asarray(overrides[key], dtype=dtype)
        else:
            out[key] = jnp.full(batch_shape, value, dtype=dtype)
    for key in overrides:
        if key not in out:
            out[key] = jnp.asarray(overrides[key], dtype=dtype)
    return out
