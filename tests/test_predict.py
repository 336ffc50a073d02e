"""Prediction parity and consistency tests.

The independent oracle in conftest transcribes the reference math
(tabcorr/tabcorr.py:537-650) literally — packed arrays, raw M^(n+1)
measure — while the package uses precomputed normalized weights and dense
quadratic forms.  Agreement at ~1e-12 validates the reformulation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tabcorr_tpu as tt
from tabcorr_tpu.models.zheng07 import zheng07_centrals, zheng07_satellites
from tabcorr_tpu.ops import predict as ops_predict

from conftest import reference_mean_occupation, reference_predict


@pytest.mark.parametrize("fixture", ["wp_tabcorr", "ds_tabcorr"])
def test_mean_occupation_matches_reference_math(fixture, bol_model, request):
    halotab = request.getfixturevalue(fixture)
    got = halotab.mean_occupation(bol_model, check_consistency=False)
    want = reference_mean_occupation(halotab, bol_model)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("fixture", ["wp_tabcorr", "ds_tabcorr"])
def test_predict_matches_reference_math(fixture, bol_model, request):
    halotab = request.getfixturevalue(fixture)
    mean_occ = reference_mean_occupation(halotab, bol_model)
    ngal_ref, xi_ref = reference_predict(halotab, mean_occ)
    ngal, xi = halotab.predict(bol_model, check_consistency=False)
    assert np.isclose(ngal, ngal_ref, rtol=1e-12, atol=0)
    np.testing.assert_allclose(xi, xi_ref, rtol=1e-10, atol=0)


@pytest.mark.parametrize("fixture", ["wp_tabcorr", "ds_tabcorr"])
def test_separate_gal_type_sums_to_total(fixture, bol_model, request):
    # Mirrors the reference's consistency test (tests/test_general.py:8-28).
    halotab = request.getfixturevalue(fixture)
    ngal, xi = halotab.predict(bol_model, check_consistency=False)
    ngal_sep, xi_sep = halotab.predict(
        bol_model, separate_gal_type=True, check_consistency=False)

    assert len(ngal_sep) == 2
    n_expected = 2 if halotab.mode == "cross" else 3
    assert len(xi_sep) == n_expected

    assert np.isclose(ngal, sum(ngal_sep.values()), atol=0, rtol=1e-6)
    np.testing.assert_allclose(
        xi, np.sum(list(xi_sep.values()), axis=0), atol=0, rtol=1e-6)


def test_n_gauss_prim_convergence(wp_tabcorr, bol_model):
    # Mirrors the reference quadrature test (tests/test_general.py:31-43):
    # coarse quadrature differs, fine quadrature is converged.  (The
    # bolplanck example table has wider mass bins than the reference test's
    # wp_efficient fixture, so convergence to 1e-6 needs ~100 nodes here.)
    ngal_1, xi_1 = wp_tabcorr.predict(
        bol_model, n_gauss_prim=1, check_consistency=False)
    ngal_2, xi_2 = wp_tabcorr.predict(
        bol_model, n_gauss_prim=100, check_consistency=False)
    ngal_3, xi_3 = wp_tabcorr.predict(
        bol_model, n_gauss_prim=400, check_consistency=False)

    assert not np.isclose(ngal_1, ngal_2, atol=0, rtol=1e-6)
    assert not np.allclose(xi_1, xi_2, atol=0, rtol=1e-6)
    assert np.isclose(ngal_2, ngal_3, atol=0, rtol=1e-6)
    assert np.allclose(xi_2, xi_3, atol=0, rtol=1e-6)


def _occ_fns():
    occ_c = lambda p, logm, sec: zheng07_centrals(p, logm)  # noqa: E731
    occ_s = lambda p, logm, sec: zheng07_satellites(p, logm)  # noqa: E731
    return occ_c, occ_s


@pytest.mark.parametrize("fixture", ["wp_tabcorr", "ds_tabcorr"])
def test_jax_path_matches_host_path(fixture, bol_model, request):
    halotab = request.getfixturevalue(fixture)
    ngal_ref, xi_ref = halotab.predict(bol_model, check_consistency=False)

    table = halotab.table_data(n_gauss=10, dtype=jnp.float64)
    occ_c, occ_s = _occ_fns()
    params = {k: jnp.float64(v) for k, v in bol_model.param_dict.items()}
    ngal, xi = jax.jit(
        lambda p: ops_predict.predict(table, occ_c, occ_s, p))(params)

    assert np.isclose(float(ngal), ngal_ref, rtol=1e-12, atol=0)
    np.testing.assert_allclose(np.asarray(xi), xi_ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("fixture", ["wp_tabcorr", "ds_tabcorr"])
def test_jax_separate_matches_host(fixture, bol_model, request):
    halotab = request.getfixturevalue(fixture)
    ngal_ref, xi_ref = halotab.predict(
        bol_model, separate_gal_type=True, check_consistency=False)

    table = halotab.table_data(n_gauss=10, dtype=jnp.float64)
    occ_c, occ_s = _occ_fns()
    params = {k: jnp.float64(v) for k, v in bol_model.param_dict.items()}
    ngal, xi = jax.jit(lambda p: ops_predict.predict(
        table, occ_c, occ_s, p, separate_gal_type=True))(params)

    for key in ngal_ref:
        assert np.isclose(float(ngal[key]), ngal_ref[key], rtol=1e-12)
    for key in xi_ref:
        np.testing.assert_allclose(
            np.asarray(xi[key]), xi_ref[key].ravel(), rtol=1e-12, atol=1e-300)


def test_vmap_batched_predict(wp_tabcorr, bol_model):
    table = wp_tabcorr.table_data(n_gauss=10, dtype=jnp.float64)
    occ_c, occ_s = _occ_fns()

    rng = np.random.default_rng(42)
    B = 16
    base = bol_model.param_dict
    batch = {k: jnp.asarray(base[k] + 0.05 * rng.normal(size=B))
             for k in ("logMmin", "sigma_logM", "logM0", "logM1", "alpha")}

    f = jax.jit(jax.vmap(
        lambda p: ops_predict.predict(table, occ_c, occ_s, p)))
    ngal_b, xi_b = f(batch)
    assert ngal_b.shape == (B,)
    assert xi_b.shape == (B, 19)

    # Each batch element equals a scalar host prediction.
    for i in [0, 7, 15]:
        m = tt.Zheng07Model(threshold=-18,
                            redshift=wp_tabcorr.attrs["redshift"])
        for k in batch:
            m.param_dict[k] = float(batch[k][i])
        ngal_i, xi_i = wp_tabcorr.predict(m, check_consistency=False)
        assert np.isclose(float(ngal_b[i]), ngal_i, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(xi_b[i]), xi_i, rtol=1e-12)


def test_gradients_finite_and_match_fd(wp_tabcorr, bol_model):
    table = wp_tabcorr.table_data(n_gauss=10, dtype=jnp.float64)
    occ_c, occ_s = _occ_fns()
    params = {k: jnp.float64(v) for k, v in bol_model.param_dict.items()}

    def loss(p):
        ngal, xi = ops_predict.predict(table, occ_c, occ_s, p)
        return jnp.sum(jnp.log(xi)) + 1e3 * ngal

    grad = jax.grad(loss)(params)
    eps = 1e-6
    for key in ["logMmin", "logM1", "alpha"]:
        p_hi = dict(params)
        p_lo = dict(params)
        p_hi[key] = params[key] + eps
        p_lo[key] = params[key] - eps
        fd = (loss(p_hi) - loss(p_lo)) / (2 * eps)
        assert np.isclose(float(grad[key]), float(fd), rtol=1e-5), key


def test_float32_accuracy_within_north_star(wp_tabcorr, bol_model):
    # The device fast path (float32 table) must stay within ~1e-6 relative of
    # the float64 reference-parity path (BASELINE.json north star).
    ngal_ref, xi_ref = wp_tabcorr.predict(bol_model, check_consistency=False)
    table = wp_tabcorr.table_data(n_gauss=10, dtype=jnp.float32)
    occ_c, occ_s = _occ_fns()
    params = {k: jnp.float32(v) for k, v in bol_model.param_dict.items()}
    ngal, xi = jax.jit(
        lambda p: ops_predict.predict(table, occ_c, occ_s, p))(params)
    assert abs(float(ngal) / ngal_ref - 1) < 2e-6
    assert np.max(np.abs(np.asarray(xi, dtype=np.float64) / xi_ref - 1)) < 5e-6


def test_consistency_checks_raise(wp_tabcorr):
    bad = tt.Zheng07Model(threshold=-18, redshift=5.0)
    with pytest.raises(ValueError):
        wp_tabcorr.predict(bad)
    bad2 = tt.Zheng07Model(threshold=-18, redshift=0.0,
                           prim_haloprop_key="halo_m200m")
    with pytest.raises(ValueError):
        wp_tabcorr.predict(bad2)


def test_matrix_reassignment_invalidates_caches(wp_tabcorr, bol_model):
    # Version-counter cache keying: assigning a new tpcf_matrix must
    # invalidate both the dense-matrix and device-pytree caches (id()
    # keying could alias a garbage-collected array's address).
    import copy

    tab = copy.deepcopy(wp_tabcorr)
    ngal, xi = tab.predict(bol_model)
    tab.table_data()  # populate the device cache

    tab.tpcf_matrix = tab.tpcf_matrix * 2.0
    ngal2, xi2 = tab.predict(bol_model)
    np.testing.assert_allclose(xi2, 2.0 * xi, rtol=1e-12)

    data = tab.table_data()
    np.testing.assert_allclose(
        np.asarray(data.tpcf_dense),
        np.asarray(tab.dense_matrix()).astype(np.float32), rtol=1e-6)


def test_make_predictor_rejects_other_objects(bol_model):
    from tabcorr_tpu.predictor import make_predictor

    with pytest.raises(TypeError):
        make_predictor(object(), bol_model)
