"""shard_map kernels: bin-sharded ("table parallel") prediction.

For tabulations too large to replicate comfortably (many statistics x many
bins, e.g. stacked multipole tables or the 300-mass-bin cross tabulations of
the published database), the halo-bin axis of the dense matrix is sharded
over the ``tp`` mesh axis.  Each device contracts its bin shard and a single
``psum`` finishes the quadratic form:

    auto :  xi_k = psum_d( n_d^T F_k[:, d-shard] n ) / psum_d(sum n_d)^2
    cross:  xi_k = psum_d( F_k[:, d-shard] n_d ) / psum_d(sum n_d)

The parameter batch stays sharded over ``dp`` at the same time, so one
``shard_map`` runs the entire (walker-parallel x table-parallel) grid.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..ops.predict import AUTO, TableData, occupation_with_residual
from .mesh import BATCH_AXIS, TABLE_AXIS


def _pad_to_multiple(array, axis, multiple):
    """Zero-pad ``axis`` to a multiple; zero bins have n_h = 0 and drop out."""
    import numpy as np
    size = array.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return array
    pad = [(0, 0)] * array.ndim
    pad[axis] = (0, target - size)
    return np.pad(np.asarray(array), pad)


def shard_table_data(table: TableData, n_shards: int) -> TableData:
    """Pad every bin-indexed axis of a table so it splits over ``n_shards``.

    Padding bins have ``n_h = 0`` so they contribute nothing to any
    contraction; the dense matrix is padded with zeros on both bin axes.
    """
    if table.mode == AUTO:
        dense = _pad_to_multiple(
            _pad_to_multiple(table.tpcf_dense, 1, n_shards), 2, n_shards)
    else:
        dense = _pad_to_multiple(table.tpcf_dense, 1, n_shards)
    return TableData(
        tpcf_dense=jnp.asarray(dense),
        n_h=jnp.asarray(_pad_to_multiple(table.n_h, 0, n_shards)),
        log_prim_quad=jnp.asarray(
            _pad_to_multiple(table.log_prim_quad, 0, n_shards)),
        quad_weight=jnp.asarray(
            _pad_to_multiple(table.quad_weight, 0, n_shards)),
        sec_perc=jnp.asarray(_pad_to_multiple(table.sec_perc, 0, n_shards)),
        mode=table.mode, tpcf_shape=table.tpcf_shape,
        n_centrals=table.n_centrals,
        log_prim_quad_lo=(None if table.log_prim_quad_lo is None else
                          jnp.asarray(_pad_to_multiple(
                              table.log_prim_quad_lo, 0, n_shards))))


def make_sharded_predict(mesh, table: TableData, occupation_cen,
                         occupation_sat):
    """Build a (dp x tp)-sharded batched predict function.

    Returns ``f(params: dict of (B,) arrays) -> (ngal (B,), xi (B, n_xi))``,
    jitted over ``mesh``.  B must divide by the dp axis size; the table is
    padded to split its bin axis over the tp axis.
    """
    n_tp = mesh.shape[TABLE_AXIS]
    table = shard_table_data(table, n_tp)
    n_bins = table.n_bins

    # Table shards: the dense matrix splits along its *first* bin axis in
    # auto mode (each device owns F[:, shard, :] and computes
    # n_shard^T F_shard n -> psum); along the only bin axis in cross mode.
    if table.mode == AUTO:
        dense_spec = P(None, TABLE_AXIS, None)
    else:
        dense_spec = P(None, TABLE_AXIS)
    table_specs = TableData(
        tpcf_dense=dense_spec, n_h=P(TABLE_AXIS),
        log_prim_quad=P(TABLE_AXIS, None), quad_weight=P(TABLE_AXIS, None),
        sec_perc=P(TABLE_AXIS), mode=table.mode,
        tpcf_shape=table.tpcf_shape, n_centrals=table.n_centrals,
        log_prim_quad_lo=(None if table.log_prim_quad_lo is None else
                          P(TABLE_AXIS, None)))

    params_spec = P(BATCH_AXIS)

    def _occ_local(table_shard, params):
        # Occupation on this device's bin shard. Bin ordering within a
        # shard is irrelevant: the gal-type split is encoded per bin via
        # a mask rather than the global [cen..., sat...] prefix.
        sec = table_shard.sec_perc[:, None]

        if table_shard.log_prim_quad_lo is None:
            occ_c = occupation_cen(params, table_shard.log_prim_quad, sec)
            occ_s = occupation_sat(params, table_shard.log_prim_quad, sec)
        else:
            # Node-residual correction (see ops.predict.mean_occupation).
            occ_c = occupation_with_residual(
                occupation_cen, params, table_shard.log_prim_quad,
                table_shard.log_prim_quad_lo, sec)
            occ_s = occupation_with_residual(
                occupation_sat, params, table_shard.log_prim_quad,
                table_shard.log_prim_quad_lo, sec)
        n_local = table_shard.log_prim_quad.shape[0]
        shard_index = jax.lax.axis_index(TABLE_AXIS)
        global_bin = shard_index * n_local + jnp.arange(n_local)
        is_cen = (global_bin < table_shard.n_centrals)[:, None]
        occ = jnp.where(is_cen, occ_c, occ_s)
        return jnp.sum(table_shard.quad_weight * occ, axis=-1)

    def _kernel(table_shard, params):
        # params: dict of (B/dp,) local batches; table_shard: local bins.
        def one(p):
            mean_occ = _occ_local(table_shard, p)      # (n_bins/tp,)
            ngal_local = mean_occ * table_shard.n_h
            total = jax.lax.psum(jnp.sum(ngal_local), TABLE_AXIS)
            if table_shard.mode == AUTO:
                ngal_full = jax.lax.all_gather(
                    ngal_local, TABLE_AXIS, tiled=True)  # (n_bins,)
                t = jnp.einsum("kij,j->ki", table_shard.tpcf_dense,
                               ngal_full,
                               precision=jax.lax.Precision.HIGHEST)
                xi = jax.lax.psum(
                    jnp.einsum("ki,i->k", t, ngal_local,
                               precision=jax.lax.Precision.HIGHEST),
                    TABLE_AXIS)
                xi = xi / total**2
            else:
                xi = jax.lax.psum(
                    jnp.einsum("ki,i->k", table_shard.tpcf_dense,
                               ngal_local,
                               precision=jax.lax.Precision.HIGHEST),
                    TABLE_AXIS)
                xi = xi / total
            return total, xi

        return jax.vmap(one)(params)

    mapped = shard_map(
        _kernel, mesh=mesh,
        in_specs=(table_specs, params_spec),
        out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)))

    def predict_batch(params):
        return mapped(table, params)

    return jax.jit(predict_batch), table


__all__ = ["make_sharded_predict", "shard_table_data"]
