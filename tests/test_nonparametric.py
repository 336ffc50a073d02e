"""Non-parametric HOD model: exactness, gradients, fast path.

The tabulation method makes the per-bin occupations themselves valid
model parameters (models/nonparametric.py; PAPERS.md arXiv 2603.18379).
The key invariants: quadrature over a piecewise-constant occupation
returns the parameters EXACTLY, prediction through the model equals the
direct occupation-vector fast path, and the fast path is differentiable
and batch-native.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import tabcorr_tpu as tt
from tabcorr_tpu.models import smoothness_log_prior
from tabcorr_tpu.models.protocol import CENTRALS, SATELLITES
from tabcorr_tpu.predictor import (make_occupation_predictor,
                                   make_predictor, params_batch)


@pytest.fixture(scope="module")
def wp_tab(wp_tabcorr):
    return wp_tabcorr


@pytest.fixture(scope="module")
def np_model(wp_tab):
    rng = np.random.default_rng(11)
    model = tt.NonparametricHodModel.from_table(wp_tab)
    n_cen = len(model.occupation_vector(CENTRALS))
    n_sat = len(model.occupation_vector(SATELLITES))
    # Realistic-ish occupations: rising centrals in (0, 1), power-law
    # satellites, plus noise so no accidental symmetry hides a bug.
    model.set_occupation_vector(
        np.linspace(0.01, 1.0, n_cen) * rng.uniform(0.8, 1.2, n_cen),
        CENTRALS)
    model.set_occupation_vector(
        np.geomspace(1e-3, 30.0, n_sat) * rng.uniform(0.8, 1.2, n_sat),
        SATELLITES)
    return model


def test_quadrature_is_exact(wp_tab, np_model):
    """mean_occupation of a piecewise-constant model == the parameters.

    Each Gauss-Legendre node lies strictly inside its own bin, and the
    normalized measure integrates a constant to itself, so the host
    float64 quadrature must reproduce the occupation vector to
    round-off.
    """
    got = wp_tab.mean_occupation(np_model, check_consistency=False)
    np.testing.assert_allclose(got, np_model.occupation_vector(),
                               rtol=1e-13)


def test_model_predict_equals_direct_vector(wp_tab, np_model):
    """predict(model) == predict(raw vector) == fast-path predictor."""
    ngal_m, xi_m = wp_tab.predict(np_model, check_consistency=False)
    vec = np_model.occupation_vector()
    ngal_v, xi_v = wp_tab.predict(vec)
    np.testing.assert_allclose(ngal_m, ngal_v, rtol=1e-13)
    np.testing.assert_allclose(xi_m, xi_v, rtol=1e-13)

    f = make_occupation_predictor(wp_tab, dtype=jnp.float64)
    ngal_d, xi_d = f(vec)
    np.testing.assert_allclose(float(ngal_d), ngal_v, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(xi_d), xi_v, rtol=1e-12)


def test_batched_xla_engine_matches_host(wp_tab, np_model):
    """The generic batched predictor traces the piecewise-constant
    occupation and matches the host path."""
    f = make_predictor(wp_tab, np_model, dtype=jnp.float64)
    B = 4
    rng = np.random.default_rng(3)
    overrides = {"n_sat_0": np_model.param_dict["n_sat_0"] *
                 rng.uniform(0.5, 1.5, B)}
    params = params_batch(np_model, overrides, (B,), dtype=jnp.float64)
    ngal_b, xi_b = f(params)
    for i in range(B):
        m = tt.NonparametricHodModel.from_table(wp_tab)
        m.param_dict.update({k: float(np.asarray(v)[i])
                             for k, v in params.items()})
        ngal_i, xi_i = wp_tab.predict(m, check_consistency=False)
        np.testing.assert_allclose(float(ngal_b[i]), ngal_i, rtol=1e-10)
        np.testing.assert_allclose(np.asarray(xi_b[i]).ravel(),
                                   xi_i.ravel(), rtol=1e-10)


def test_fast_path_batched_and_differentiable(wp_tab, np_model):
    f = make_occupation_predictor(wp_tab, dtype=jnp.float64)
    vec = np_model.occupation_vector()
    B = 8
    rng = np.random.default_rng(5)
    batch = vec[None, :] * rng.uniform(0.5, 1.5, (B, len(vec)))
    ngal, xi = f(jnp.asarray(batch))
    assert ngal.shape == (B,)
    assert xi.shape == (B,) + tuple(wp_tab.tpcf_shape)
    for i in range(B):
        ngal_i, xi_i = wp_tab.predict(batch[i])
        np.testing.assert_allclose(float(ngal[i]), ngal_i, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(xi[i]), xi_i, rtol=1e-12)

    # Gradient of a scalar functional vs central finite differences.
    def loss(v):
        ngal, xi = f(v)
        return jnp.sum(xi) + ngal

    g = np.asarray(jax.grad(loss)(jnp.asarray(vec)))
    eps = 1e-6
    for j in [0, len(vec) // 2, len(vec) - 1]:
        vp, vm = vec.copy(), vec.copy()
        vp[j] += eps * max(vec[j], 1e-3)
        vm[j] -= eps * max(vec[j], 1e-3)
        fd = (float(loss(jnp.asarray(vp))) - float(loss(jnp.asarray(vm)))) \
            / (vp[j] - vm[j])
        np.testing.assert_allclose(g[j], fd, rtol=5e-5, atol=1e-12)


def test_separate_gal_type_sums(wp_tab, np_model):
    """Per-type decomposition sums to the total (reference invariant,
    reference: tests/test_general.py:8-28)."""
    f = make_occupation_predictor(wp_tab, dtype=jnp.float64,
                                  separate_gal_type=True)
    vec = jnp.asarray(np_model.occupation_vector())
    ngal_d, xi_d = f(vec)
    ngal, xi = wp_tab.predict(np_model.occupation_vector())
    np.testing.assert_allclose(
        float(sum(jnp.sum(v) for v in ngal_d.values())), ngal, rtol=1e-12)
    total = sum(np.asarray(v) for v in xi_d.values())
    np.testing.assert_allclose(total.ravel(), xi.ravel(), rtol=1e-12)


def test_occupation_outside_cells_is_zero(wp_tab, np_model):
    g = wp_tab.gal_type
    lo = np.min(np.asarray(g["log_prim_haloprop_min"]))
    hi = np.max(np.asarray(g["log_prim_haloprop_max"]))
    occ = np_model.mean_occupation_centrals(
        prim_haloprop=10.0 ** np.array([lo - 1.0, hi + 1.0]))
    np.testing.assert_array_equal(occ, 0.0)
    # The global top edge itself is inside (closed above).
    occ_top = np_model.mean_occupation_centrals(
        prim_haloprop=10.0 ** np.array([hi]))
    assert occ_top[0] != 0.0


def test_vector_roundtrip_and_validation(wp_tab):
    model = tt.NonparametricHodModel.from_table(wp_tab)
    rng = np.random.default_rng(9)
    vec = rng.uniform(0.0, 2.0, len(model.occupation_vector()))
    model.set_occupation_vector(vec)
    np.testing.assert_array_equal(model.occupation_vector(), vec)
    with pytest.raises(ValueError):
        model.set_occupation_vector(vec[:-1], CENTRALS)
    with pytest.raises(ValueError):
        tt.NonparametricHodModel(
            dict(log_prim_min=[11.0], log_prim_max=[12.0, 13.0],
                 sec_min=[0.0], sec_max=[1.0]),
            dict(log_prim_min=[11.0], log_prim_max=[12.0],
                 sec_min=[0.0], sec_max=[1.0]))


def test_smoothness_prior():
    # Exactly log-linear occupations have zero curvature penalty.
    v = 10.0 ** np.linspace(-2.0, 1.0, 12)
    assert float(smoothness_log_prior(jnp.asarray(v), scale=0.1)) == \
        pytest.approx(0.0, abs=1e-8)
    # A kink is penalized, more strongly at smaller scale.
    v_kink = v.copy()
    v_kink[6] *= 10.0
    p1 = float(smoothness_log_prior(jnp.asarray(v_kink), scale=0.5))
    p2 = float(smoothness_log_prior(jnp.asarray(v_kink), scale=0.1))
    assert p2 < p1 < 0.0
    # Linear-space variant and batching.
    vb = jnp.asarray(np.stack([v, v_kink]))
    out = smoothness_log_prior(vb, scale=0.5, log=False)
    assert out.shape == (2,)
    # Differentiability.
    g = jax.grad(lambda x: smoothness_log_prior(x, scale=0.5))(
        jnp.asarray(v_kink))
    assert np.all(np.isfinite(np.asarray(g)))


def test_posterior_gradient_through_fast_path(wp_tab, np_model):
    """A full non-parametric posterior (data term + smoothness prior)
    is jit/grad-able end-to-end — the inference loop's inner step."""
    f = make_occupation_predictor(wp_tab, dtype=jnp.float64, jit=False)
    vec = np_model.occupation_vector()
    _, data = f(jnp.asarray(vec))
    data = data.ravel()
    n_cen = len(np_model.occupation_vector(CENTRALS))

    @jax.jit
    def log_post(log_v):
        v = 10.0 ** log_v
        _, xi = f(v)
        resid = (xi.ravel() - data) / (0.05 * jnp.abs(data) + 1e-3)
        return (-0.5 * jnp.sum(resid ** 2)
                + smoothness_log_prior(v[:n_cen], scale=0.5)
                + smoothness_log_prior(v[n_cen:], scale=0.5))

    log_v0 = jnp.asarray(np.log10(np.maximum(vec, 1e-6)))
    lp, g = jax.value_and_grad(log_post)(log_v0)
    assert np.isfinite(float(lp))
    assert np.all(np.isfinite(np.asarray(g)))
