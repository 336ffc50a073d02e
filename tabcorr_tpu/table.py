"""The ``TabCorr`` tabulation container: I/O, mean occupation, prediction.

This is the user-facing equivalent of the reference's ``TabCorr`` class
(reference: tabcorr/tabcorr.py:20).  It reads and writes the reference's
exact HDF5 schema (reference: tabcorr/tabcorr.py:374-463), so files produced
by the original package load directly, and exposes the same
``mean_occupation`` / ``predict`` semantics.

Architecture differs deliberately from the reference: the class is a thin
host-side shell around immutable device pytrees (:class:`~.ops.predict.TableData`).
Scalar ``predict(model)`` calls run a float64 numpy path that mirrors the
reference math exactly; high-throughput use goes through
:meth:`table_data` + the pure-JAX kernels in :mod:`tabcorr_tpu.ops.predict`
(jit/vmap/grad-able, shard_map-able).
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np

from .io import ColumnTable, is_group, open_tree, read_attrs
from .models.protocol import CENTRALS
from .ops.predict import AUTO, TableData, quadrature_grid
from .utils.packing import (array_to_symmetric_matrix, packed_index_arrays,
                            symmetric_matrix_to_array)


class TabCorr:
    """Tabulated halo correlation functions and fast galaxy predictions."""

    def __init__(self):
        self.attrs = {}
        self._gal_type = None
        self._gal_type_version = 0
        self._tpcf_matrix = None
        self._matrix_version = 0
        self.tpcf_args = ()
        self.tpcf_kwargs = {}
        self.tpcf_shape = ()
        self._quad_cache = {}
        self._table_data_cache = {}

    # Version counters key the derived-data caches: unlike id(), they can
    # never alias a new array with a garbage-collected one.  In-place
    # mutation still requires reassigning through the setter.
    @property
    def tpcf_matrix(self):
        return self._tpcf_matrix

    @tpcf_matrix.setter
    def tpcf_matrix(self, value):
        self._tpcf_matrix = value
        self._matrix_version += 1

    @property
    def gal_type(self):
        return self._gal_type

    @gal_type.setter
    def gal_type(self, value):
        self._gal_type = value
        self._gal_type_version += 1
        # Quadrature nodes/weights derive from gal_type columns only.
        self._quad_cache = {}

    # ------------------------------------------------------------------
    @classmethod
    def tabulate(cls, halocat, tpcf, *tpcf_args, **kwargs):
        """Tabulate correlation functions for a halo catalog.

        See :func:`tabcorr_tpu.tabulate.tabulate` (signature-compatible
        with the reference, tabcorr/tabcorr.py:24-34).
        """
        from .tabulate import tabulate as _tabulate
        return _tabulate(cls, halocat, tpcf, *tpcf_args, **kwargs)

    # ------------------------------------------------------------------
    # I/O  (schema parity: reference tabcorr/tabcorr.py:374-463)
    # ------------------------------------------------------------------
    @classmethod
    def read(cls, fname):
        """Read a tabulation from an HDF5 or ``.npz`` path, or an open
        group."""
        halotab = cls()

        own_handle = not is_group(fname)
        fstream = open_tree(fname) if own_handle else fname

        halotab.attrs = read_attrs(fstream)
        # Stored float32, up-cast on read like the reference (:399).
        halotab.tpcf_matrix = fstream["tpcf_matrix"][()].astype(np.float64)
        halotab.tpcf_args = tuple(
            fstream["tpcf_args"][key][()] for key in fstream["tpcf_args"])
        halotab.tpcf_kwargs = {}
        if "tpcf_kwargs" in fstream:
            for key in fstream["tpcf_kwargs"]:
                halotab.tpcf_kwargs[key] = fstream["tpcf_kwargs"][key][()]
        halotab.tpcf_shape = tuple(fstream["tpcf_shape"][()])
        halotab.gal_type = ColumnTable.read_hdf5(fstream, "gal_type")

        if own_handle:
            fstream.close()
        return halotab

    def write(self, fname, overwrite=False, max_args_size=1000000,
              matrix_dtype=np.float32):
        """Write in the reference's HDF5 schema (tabcorr/tabcorr.py:418-463)."""
        own_handle = not is_group(fname)
        fstream = (open_tree(fname, "w" if overwrite else "w-")
                   if own_handle else fname)

        keys = ["tpcf", "mode", "simname", "redshift", "Num_ptcl_requirement",
                "prim_haloprop_key", "sec_haloprop_key"]
        for key in keys:
            fstream.attrs[key] = self.attrs[key]
        # Extra provenance attrs beyond the reference schema (e.g.
        # 'delta_sigma_estimator') round-trip too; the reference reader
        # ignores unknown attrs, so files stay loadable by it.
        for key, value in self.attrs.items():
            if key not in keys and value is not None:
                fstream.attrs[key] = value

        fstream["tpcf_matrix"] = self.tpcf_matrix.astype(matrix_dtype)

        for i, arg in enumerate(self.tpcf_args):
            if (not isinstance(arg, np.ndarray) or
                    np.prod(arg.shape) < max_args_size):
                fstream[f"tpcf_args/arg_{i}"] = arg
        for key, value in self.tpcf_kwargs.items():
            if (not isinstance(value, np.ndarray) or
                    np.prod(value.shape) < max_args_size):
                fstream[f"tpcf_kwargs/{key}"] = value
        fstream["tpcf_shape"] = np.asarray(self.tpcf_shape, dtype=np.int64)

        self.gal_type.write_hdf5(fstream, "gal_type")

        if own_handle:
            fstream.close()

    # ------------------------------------------------------------------
    # Derived host-side quantities
    # ------------------------------------------------------------------
    @property
    def mode(self):
        return self.attrs["mode"]

    @property
    def n_bins(self):
        return len(self.gal_type)

    @property
    def n_centrals(self):
        """Number of leading central bins; bins are [centrals..., satellites...]."""
        is_cen = self._is_central_mask()
        n_cen = int(np.sum(is_cen))
        if not np.all(is_cen[:n_cen]):
            raise ValueError("gal_type rows are not ordered "
                             "[centrals..., satellites...].")
        return n_cen

    def _is_central_mask(self):
        gal_type = self.gal_type["gal_type"]
        if gal_type.dtype.kind == "S":
            return gal_type == CENTRALS.encode()
        return gal_type == CENTRALS

    def _quadrature(self, n_gauss):
        """Cached (log_prim_quad, quad_weight) float64 arrays."""
        if n_gauss not in self._quad_cache:
            if "prim_haloprop_dist_index" in self.gal_type:
                dist_index = self.gal_type["prim_haloprop_dist_index"]
            else:
                # Legacy files: flat measure (reference: tabcorr.py:571-574,
                # which uses M^0 when the column is missing -> n = 0).
                dist_index = np.full(self.n_bins, -1.0)
            self._quad_cache[n_gauss] = quadrature_grid(
                self.gal_type["log_prim_haloprop_min"],
                self.gal_type["log_prim_haloprop_max"],
                dist_index, n_gauss)
        return self._quad_cache[n_gauss]

    def dense_matrix(self):
        """Unpack the stored matrix to its dense contraction form (float64).

        Auto mode: (n_xi, n_bins, n_bins) symmetric; cross mode: unchanged
        (n_xi, n_bins).  Cached per matrix version (the host ``predict``
        is often called in loops).
        """
        if self.mode != AUTO:
            return self.tpcf_matrix
        cache = getattr(self, "_dense_cache", None)
        if cache is None or cache[0] != self._matrix_version:
            self._dense_cache = (self._matrix_version,
                                 array_to_symmetric_matrix(self.tpcf_matrix))
        return self._dense_cache[1]

    def table_data(self, n_gauss=10, dtype=jnp.float32) -> TableData:
        """Device pytree for the pure-JAX prediction kernels (cached).

        The cache keys on the ``tpcf_matrix`` version counter so assigning
        a new matrix (e.g. the multipole converter) invalidates it; callers
        that mutate the array *in place* must reassign ``tpcf_matrix`` (or
        clear ``_table_data_cache``) themselves.
        """
        key = (n_gauss, jnp.dtype(dtype).name, self._matrix_version,
               self._gal_type_version)
        if key not in self._table_data_cache:
            log_quad, weight = self._quadrature(n_gauss)
            if jnp.dtype(dtype).itemsize < 8:
                # Node residual for the first-order occupation correction
                # (see ops.predict.TableData.log_prim_quad_lo).
                hi64 = np.asarray(jnp.asarray(log_quad, dtype=dtype),
                                  dtype=np.float64)
                log_quad_lo = jnp.asarray(log_quad - hi64, dtype=dtype)
            else:
                log_quad_lo = None
            self._table_data_cache[key] = TableData(
                tpcf_dense=jnp.asarray(self.dense_matrix(), dtype=dtype),
                n_h=jnp.asarray(self.gal_type["n_h"], dtype=dtype),
                log_prim_quad=jnp.asarray(log_quad, dtype=dtype),
                quad_weight=jnp.asarray(weight, dtype=dtype),
                sec_perc=jnp.asarray(
                    self.gal_type["sec_haloprop_percentile"], dtype=dtype),
                mode=self.mode,
                tpcf_shape=tuple(self.tpcf_shape),
                n_centrals=self.n_centrals,
                log_prim_quad_lo=log_quad_lo)
        return self._table_data_cache[key]

    # ------------------------------------------------------------------
    # Reference-parity scalar API (float64 numpy)
    # ------------------------------------------------------------------
    def mean_occupation(self, model, n_gauss_prim=10, check_consistency=True,
                        **occ_kwargs):
        """Mean occupation per bin (reference: tabcorr/tabcorr.py:465-578).

        The quadrature nodes/weights are precomputed in float64 at table
        load; the model's occupation functions are evaluated at the node
        masses and contracted with the normalized M^(n+1) measure weights.
        """
        if check_consistency:
            self._check_consistency(model)

        log_quad, weight = self._quadrature(n_gauss_prim)
        prim = 10.0 ** log_quad
        sec = np.repeat(self.gal_type["sec_haloprop_percentile"],
                        n_gauss_prim).reshape(prim.shape)

        n_cen = self.n_centrals
        occ = np.empty_like(prim)
        occ[:n_cen] = model.mean_occupation_centrals(
            prim_haloprop=prim[:n_cen].ravel(),
            sec_haloprop_percentile=sec[:n_cen].ravel(),
            **occ_kwargs).reshape(prim[:n_cen].shape)
        occ[n_cen:] = model.mean_occupation_satellites(
            prim_haloprop=prim[n_cen:].ravel(),
            sec_haloprop_percentile=sec[n_cen:].ravel(),
            **occ_kwargs).reshape(prim[n_cen:].shape)

        return np.sum(weight * occ, axis=-1)

    def _check_consistency(self, model):
        """Model/tabulation consistency (reference: tabcorr.py:496-535)."""
        if sorted(model.gal_types) != ["centrals", "satellites"]:
            raise ValueError(
                "The model instance must only have centrals and satellites "
                "as galaxy types.")
        if getattr(model, "prim_haloprop_key", None) != \
                self.attrs["prim_haloprop_key"]:
            raise ValueError("Mismatch in the primary halo properties of "
                             "the model and the TabCorr instance.")
        sec_key = getattr(model, "sec_haloprop_key", None)
        if sec_key is not None and sec_key != self.attrs["sec_haloprop_key"]:
            raise ValueError("Mismatch in the secondary halo properties of "
                             "the model and the TabCorr instance.")
        if abs(model.redshift - self.attrs["redshift"]) >= 0.05:
            raise ValueError("Mismatch in the redshift of the model and "
                             "the TabCorr instance.")

    def predict(self, model, separate_gal_type=False, n_gauss_prim=10,
                check_consistency=True, **occ_kwargs):
        """Predict (ngal, xi) for a model (reference: tabcorr.py:580-683).

        ``model`` may be an :class:`~.models.protocol.HodModel` or a raw
        mean-occupation array (the Interpolator's internal fast path,
        reference: tabcorr.py:616-621).  Float64 host path; for batched /
        differentiable use see :func:`tabcorr_tpu.ops.predict.predict`.
        """
        if isinstance(model, np.ndarray):
            mean_occ = model
        else:
            mean_occ = self.mean_occupation(
                model, n_gauss_prim=n_gauss_prim,
                check_consistency=check_consistency, **occ_kwargs)

        ngal = mean_occ * np.asarray(self.gal_type["n_h"], dtype=np.float64)
        total = np.sum(ngal)
        dense = self.dense_matrix()

        if not separate_gal_type:
            if self.mode == AUTO:
                xi = np.einsum("kij,i,j->k", dense, ngal, ngal) / total**2
            else:
                xi = dense @ ngal / total
            return total, xi.reshape(self.tpcf_shape)

        n_cen = self.n_centrals
        mask_c = np.zeros_like(ngal)
        mask_c[:n_cen] = 1.0
        n_c, n_s = ngal * mask_c, ngal * (1.0 - mask_c)

        ngal_dict = {"centrals": np.sum(n_c), "satellites": np.sum(n_s)}
        xi_dict = {}
        if self.mode == AUTO:
            pairs = itertools.combinations_with_replacement(
                [("centrals", n_c), ("satellites", n_s)], 2)
            for (name_1, v_1), (name_2, v_2) in pairs:
                factor = 1.0 if name_1 == name_2 else 2.0
                xi = factor * np.einsum("kij,i,j->k", dense, v_1, v_2)
                xi_dict[f"{name_1}-{name_2}"] = (
                    xi / total**2).reshape(self.tpcf_shape)
        else:
            for name, vec in [("centrals", n_c), ("satellites", n_s)]:
                xi_dict[name] = (dense @ vec / total).reshape(self.tpcf_shape)
        return ngal_dict, xi_dict

    # ------------------------------------------------------------------
    def make_predictor(self, model, **kwargs):
        """Jitted batched predictor for this tabulation.

        Convenience for :func:`tabcorr_tpu.predictor.make_predictor`;
        returns ``f(params dict of (B,) arrays) -> (ngal, xi)``.
        """
        from .predictor import make_predictor
        return make_predictor(self, model, **kwargs)

    def __repr__(self):
        return (f"TabCorr(tpcf={self.attrs.get('tpcf')}, mode="
                f"{self.attrs.get('mode')}, n_bins={self.n_bins}, "
                f"tpcf_shape={self.tpcf_shape})")


def pack_symmetric(matrix):
    """Re-export of the reference packing helper (tabcorr.py:770-806)."""
    return symmetric_matrix_to_array(matrix)


__all__ = ["TabCorr", "pack_symmetric", "packed_index_arrays"]
