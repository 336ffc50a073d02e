"""Batched prediction kernels.

The reference's hot MCMC inner loop (reference: tabcorr/tabcorr.py:580-683)
is: mean occupation per halo bin -> per-bin galaxy density ``n`` -> packed
pair weights ``w_p = (2 - delta_ij) n_i n_j`` -> contraction
``xi = sum_p M_p w_p / sum_p w_p``.

Because the packed weights sum to ``(sum_i n_i)^2`` and the packed
contraction equals the dense quadratic form over the unpacked symmetric
matrix ``F`` (F[k, i, j] = F[k, j, i] = M[k, pack(i, j)]), auto-mode
prediction is exactly

    xi_k = n^T F_k n / (sum_i n_i)^2

— a dense matrix product and a reduction, no gathers.  Cross mode is a
single matrix product ``xi = F n / sum(n)`` (reference:
tabcorr/tabcorr.py:648-649).

All functions here are pure, jit/vmap/grad-compatible, and batch-native:
a leading batch axis on the occupation array broadcasts through.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

AUTO = "auto"
CROSS = "cross"


@partial(jax.tree_util.register_dataclass,
         data_fields=["tpcf_dense", "n_h", "log_prim_quad", "quad_weight",
                      "sec_perc", "log_prim_quad_lo"],
         meta_fields=["mode", "tpcf_shape", "n_centrals"])
@dataclasses.dataclass(frozen=True)
class TableData:
    """Device-resident tabulation pytree.

    Attributes
    ----------
    tpcf_dense : (n_xi, n_bins, n_bins) for auto mode, (n_xi, n_bins) for
        cross mode. The unpacked correlation-function matrix.
    n_h : (n_bins,) halo number density per bin.
    log_prim_quad : (n_bins, n_gauss) log10 primary halo property at the
        Gauss-Legendre nodes of each bin.
    quad_weight : (n_bins, n_gauss) normalized quadrature weights including
        the per-bin halo-mass-distribution measure M^(n+1)
        (reference: tabcorr/tabcorr.py:543-578); rows sum to 1.
    sec_perc : (n_bins,) secondary-property percentile midpoint per bin.
    mode : 'auto' or 'cross' (static).
    tpcf_shape : tuple, shape of one correlation-function output (static).
    n_centrals : int, number of leading bins that are centrals (static);
        bins are ordered [centrals..., satellites...] as in the reference's
        vstack construction (reference: tabcorr/tabcorr.py:229-234).
    log_prim_quad_lo : (n_bins, n_gauss) or None.  Residual of the float64
        quadrature nodes after rounding ``log_prim_quad`` to the device
        dtype.  When present, occupations are evaluated with a first-order
        JVP correction along this residual (see :func:`mean_occupation`),
        removing the dominant float32 error of the device path (node
        quantization: ~5e-7 absolute in logM ~ 1.4e-6 in the erf argument
        at sigma_logM = 0.25, which otherwise exceeds every other error
        source combined).  None for float64 tables (no residual).
    """

    tpcf_dense: jnp.ndarray
    n_h: jnp.ndarray
    log_prim_quad: jnp.ndarray
    quad_weight: jnp.ndarray
    sec_perc: jnp.ndarray
    mode: str
    tpcf_shape: tuple
    n_centrals: int
    log_prim_quad_lo: jnp.ndarray | None = None

    @property
    def n_bins(self):
        return self.n_h.shape[0]


def quadrature_grid(log_prim_min, log_prim_max, dist_index, n_gauss):
    """Host-side (float64) quadrature precompute.

    Mirrors the reference's Gauss-Legendre setup in ``mean_occupation``
    (reference: tabcorr/tabcorr.py:543-578): nodes at
    ``10**(logmin + d * x)`` with x in (0, 1) and weights
    ``w * M^(n+1)`` (the +1 converts the M^n measure to d(logM) integration),
    normalized per bin.  Masses are scaled by the bin minimum before
    exponentiation so no large powers appear.
    """
    log_prim_min = np.asarray(log_prim_min, dtype=np.float64)
    log_prim_max = np.asarray(log_prim_max, dtype=np.float64)
    x, w = np.polynomial.legendre.leggauss(n_gauss)
    x = (x + 1.0) / 2.0
    d = (log_prim_max - log_prim_min)[:, None]
    log_quad = log_prim_min[:, None] + d * x
    n = np.asarray(dist_index, dtype=np.float64)[:, None] + 1.0
    # (M / M_min)^n keeps the measure in a tame numeric range.
    measure = w * 10.0 ** (n * (log_quad - log_prim_min[:, None]))
    weight = measure / np.sum(measure, axis=-1, keepdims=True)
    return log_quad, weight


def occupation_with_residual(occ_fn, params, log_prim, log_prim_res, sec):
    """Occupation at the double-float node ``log_prim + log_prim_res``.

    Uses the callable's exact-absorption form (``occ_fn.with_residual``,
    attached by ``predictor.occupation_functions`` for models that
    override ``HodModel.occupation_residual``) when available; otherwise
    falls back to the generic first-order JVP correction.
    """
    with_res = getattr(occ_fn, "with_residual", None)
    if with_res is not None:
        return with_res(params, log_prim, log_prim_res, sec)
    occ, d = jax.jvp(lambda l: occ_fn(params, l, sec),
                     (log_prim,), (log_prim_res,))
    return occ + d


def mean_occupation(table: TableData, occupation_cen, occupation_sat, params):
    """Per-bin mean occupation via precomputed quadrature.

    ``occupation_cen/sat(params, log_prim_haloprop, sec_haloprop_percentile)``
    are pure jax functions of scalar ``params``; batch parameter vectors by
    ``jax.vmap``-ing at the :func:`predict` level.

    When the table carries ``log_prim_quad_lo`` (float32 tables), the
    occupation is corrected to first order along the node residual:
    ``occ(hi + lo) ~ occ(hi) + jvp(occ)(hi; lo)``.  The correction term is
    ~1e-6 of the occupation, so its own rounding is negligible and the
    quadrature recovers the float64 node positions to second order.
    """
    nc = table.n_centrals
    sec = table.sec_perc[:, None]
    logm = table.log_prim_quad

    if table.log_prim_quad_lo is None:
        occ_c = occupation_cen(params, logm[:nc], sec[:nc])
        occ_s = occupation_sat(params, logm[nc:], sec[nc:])
    else:
        res = table.log_prim_quad_lo
        occ_c = occupation_with_residual(
            occupation_cen, params, logm[:nc], res[:nc], sec[:nc])
        occ_s = occupation_with_residual(
            occupation_sat, params, logm[nc:], res[nc:], sec[nc:])
    occ = jnp.concatenate([occ_c, occ_s], axis=-2)
    return jnp.sum(table.quad_weight * occ, axis=-1)


def predict_from_occupation(table: TableData, mean_occ):
    """(ngal, xi) from a mean-occupation array; batch-native.

    ``mean_occ`` has shape (..., n_bins); returns ngal (...,) and xi
    (..., n_xi) [flattened tpcf shape].
    """
    ngal = mean_occ * table.n_h
    total = jnp.sum(ngal, axis=-1)
    if table.mode == AUTO:
        # xi_k = n^T F_k n / (sum n)^2 : matrix product + reduction.
        # HIGHEST keeps every product at IEEE float32 (the default
        # would be TF32 on a GPU, ~1e-3 relative).
        t = jnp.einsum("kij,...j->...ki", table.tpcf_dense, ngal,
                       preferred_element_type=ngal.dtype,
                       precision=jax.lax.Precision.HIGHEST)
        xi = jnp.einsum("...ki,...i->...k", t, ngal,
                        precision=jax.lax.Precision.HIGHEST)
        xi = xi / total[..., None] ** 2
    else:
        xi = jnp.einsum("ki,...i->...k", table.tpcf_dense, ngal,
                        preferred_element_type=ngal.dtype,
                        precision=jax.lax.Precision.HIGHEST)
        xi = xi / total[..., None]
    return total, xi


def predict_from_occupation_separate(table: TableData, mean_occ):
    """Per-galaxy-type decomposition (reference: tabcorr/tabcorr.py:652-683).

    Returns (ngal_dict, xi_dict) with jnp values; auto mode keys are
    'centrals-centrals', 'centrals-satellites', 'satellites-satellites',
    cross mode keys 'centrals', 'satellites'.
    """
    nc = table.n_centrals
    ngal = mean_occ * table.n_h
    mask_c = (jnp.arange(table.n_bins) < nc).astype(ngal.dtype)
    n_cen = ngal * mask_c
    n_sat = ngal * (1.0 - mask_c)
    total = jnp.sum(ngal, axis=-1)

    ngal_dict = {"centrals": jnp.sum(n_cen, axis=-1),
                 "satellites": jnp.sum(n_sat, axis=-1)}

    if table.mode == AUTO:
        denom = total[..., None] ** 2

        def quad(a, b):
            t = jnp.einsum("kij,...j->...ki", table.tpcf_dense, b,
                           preferred_element_type=ngal.dtype,
                           precision=jax.lax.Precision.HIGHEST)
            return jnp.einsum("...ki,...i->...k", t, a,
                              precision=jax.lax.Precision.HIGHEST) / denom

        xi_dict = {
            "centrals-centrals": quad(n_cen, n_cen),
            "centrals-satellites": 2.0 * quad(n_cen, n_sat),
            "satellites-satellites": quad(n_sat, n_sat),
        }
    else:
        denom = total[..., None]
        xi_dict = {
            "centrals": jnp.einsum(
                "ki,...i->...k", table.tpcf_dense, n_cen,
                precision=jax.lax.Precision.HIGHEST) / denom,
            "satellites": jnp.einsum(
                "ki,...i->...k", table.tpcf_dense, n_sat,
                precision=jax.lax.Precision.HIGHEST) / denom,
        }
    return ngal_dict, xi_dict


def predict(table: TableData, occupation_cen, occupation_sat, params,
            separate_gal_type=False):
    """Full prediction pipeline: occupation -> contraction. Pure; jit-able."""
    mean_occ = mean_occupation(table, occupation_cen, occupation_sat, params)
    if separate_gal_type:
        return predict_from_occupation_separate(table, mean_occ)
    return predict_from_occupation(table, mean_occ)
