"""Tinker et al. (2013) quiescent/active model family.

Invariants: the quiescent fraction reproduces halotools' spline
semantics everywhere (scipy interpolating spline of the ordinates,
result clipped to [0, 1]) and passes exactly through its control
points, population decomposition sums exactly ('all' == quiescent +
active),
gradients flow, the residual absorption is exact, and the family runs
through the table/predictor machinery (the quiescent-fraction
interpolation is clip/where arithmetic, free of gathers).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import tabcorr_tpu as tt
from tabcorr_tpu.models import (TINKER13_PARAMS, tinker13_centrals,
                                tinker13_quiescent_fraction,
                                tinker13_satellites)
from tabcorr_tpu.models.tinker13 import TINKER13_ABSCISSA


def test_quiescent_fraction_control_points():
    """f_q passes exactly through the ordinate parameters at the control
    masses (the interpolant-independent anchor halotools shares)."""
    params = dict(TINKER13_PARAMS)
    got = tinker13_quiescent_fraction(
        params, np.asarray(TINKER13_ABSCISSA, dtype=np.float64))
    want = [params[f"quiescent_fraction_ordinates_param{i + 1}"]
            for i in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-14)


def test_quiescent_fraction_spline_matches_scipy():
    """The default interpolant reproduces halotools' custom_spline
    semantics BETWEEN control points: scipy interpolating spline of
    degree min(n-1, 5) with polynomial extrapolation, result clipped to
    [0, 1].  Covers the single-segment default (3 points -> quadratic)
    and a multi-segment case (5 points -> cubic with where-selection)."""
    from scipy.interpolate import InterpolatedUnivariateSpline

    logm = np.linspace(9.0, 17.0, 257)
    params = dict(TINKER13_PARAMS)
    ords = [params[f"quiescent_fraction_ordinates_param{i + 1}"]
            for i in range(3)]
    spl = InterpolatedUnivariateSpline(
        np.asarray(TINKER13_ABSCISSA), ords, k=2)
    want = np.clip(spl(logm), 0.0, 1.0)
    got = tinker13_quiescent_fraction(params, logm)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)

    absc5 = (11.0, 12.0, 13.0, 14.2, 15.5)
    rng = np.random.default_rng(7)
    ords5 = rng.uniform(0.05, 0.95, 5)
    p5 = dict(params)
    for i, o in enumerate(ords5):
        p5[f"quiescent_fraction_ordinates_param{i + 1}"] = o
    spl5 = InterpolatedUnivariateSpline(np.asarray(absc5), ords5, k=4)
    want5 = np.clip(spl5(logm), 0.0, 1.0)
    got5 = tinker13_quiescent_fraction(p5, logm, abscissa=absc5)
    np.testing.assert_allclose(got5, want5, rtol=0, atol=1e-13)

    # 8 points -> degree capped at 5 with THREE polynomial segments:
    # exercises the multi-segment where-chain selection and the
    # degree-5 Horner loop (n <= 6 gives a single segment, so this is
    # the only in-environment coverage of that branch).
    absc8 = (10.8, 11.5, 12.1, 12.8, 13.4, 14.0, 14.7, 15.4)
    ords8 = rng.uniform(0.05, 0.95, 8)
    p8 = dict(params)
    for i, o in enumerate(ords8):
        p8[f"quiescent_fraction_ordinates_param{i + 1}"] = o
    spl8 = InterpolatedUnivariateSpline(np.asarray(absc8), ords8, k=5)
    want8 = np.clip(spl8(logm), 0.0, 1.0)
    got8 = tinker13_quiescent_fraction(p8, logm, abscissa=absc8)
    np.testing.assert_allclose(got8, want8, rtol=0, atol=1e-12)
    # The residual shift stays exact across the multi-segment path.
    res = 3e-9
    got8r = tinker13_quiescent_fraction(p8, logm, abscissa=absc8,
                                        log_prim_res=np.full_like(logm,
                                                                  res))
    want8r = np.clip(spl8(logm + res), 0.0, 1.0)
    np.testing.assert_allclose(got8r, want8r, rtol=0, atol=1e-12)

    # Out-of-range spline values are clipped to [0, 1] (the default
    # ordinates overshoot below zero left of the abscissa).
    assert np.all(got >= 0.0) and np.all(got <= 1.0)
    assert got[0] == 0.0
    with pytest.raises(ValueError):
        tinker13_quiescent_fraction(params, logm, interpolation="nope")


def test_quiescent_fraction_linear_variant():
    params = dict(TINKER13_PARAMS)
    kw = dict(interpolation="linear")
    # Linear between controls: midpoint of segment = mean of ordinates.
    mid = 0.5 * (TINKER13_ABSCISSA[0] + TINKER13_ABSCISSA[1])
    got = tinker13_quiescent_fraction(params, np.array([mid]), **kw)
    np.testing.assert_allclose(
        got[0], 0.5 * (params["quiescent_fraction_ordinates_param1"] +
                       params["quiescent_fraction_ordinates_param2"]),
        rtol=1e-14)
    # Constant extrapolation beyond the ends.
    lo, hi = tinker13_quiescent_fraction(params, np.array([9.0, 17.0]),
                                         **kw)
    assert lo == params["quiescent_fraction_ordinates_param1"]
    assert hi == params["quiescent_fraction_ordinates_param3"]
    # Out-of-range ordinates are clamped to [0, 1].
    params2 = dict(params, quiescent_fraction_ordinates_param1=-0.3,
                   quiescent_fraction_ordinates_param3=1.4)
    vals = tinker13_quiescent_fraction(
        params2, np.linspace(9.0, 17.0, 33), **kw)
    assert np.all(vals >= 0.0) and np.all(vals <= 1.0)
    assert vals[0] == 0.0 and vals[-1] == 1.0


def test_population_decomposition_sums_exactly():
    params = dict(TINKER13_PARAMS)
    logm = np.linspace(11.0, 15.5, 40)
    for fn in (tinker13_centrals, tinker13_satellites):
        kw = dict(threshold=10.5, a=1.0 / 1.5)
        q = fn(params, logm, sfr_designation="quiescent", **kw)
        a = fn(params, logm, sfr_designation="active", **kw)
        tot = fn(params, logm, sfr_designation="all", **kw)
        np.testing.assert_allclose(q + a, tot, rtol=1e-13)
        assert np.all(q >= 0) and np.all(a >= 0)
    with pytest.raises(ValueError):
        tinker13_satellites(params, logm, 10.5, 1.0,
                            sfr_designation="green")


def test_centrals_bounded_by_population_fraction():
    params = dict(TINKER13_PARAMS)
    logm = np.linspace(11.0, 15.5, 60)
    fq = tinker13_quiescent_fraction(params, logm)
    occ_q = tinker13_centrals(params, logm, 10.5, 1.0, "quiescent")
    occ_a = tinker13_centrals(params, logm, 10.5, 1.0, "active")
    occ_all = tinker13_centrals(params, logm, 10.5, 1.0, "all")
    assert np.all(occ_q <= fq + 1e-12)
    assert np.all(occ_a <= (1.0 - fq) + 1e-12)
    assert np.all(occ_all <= 1.0 + 1e-12)
    # At very high mass every central is above threshold: occ -> f_q.
    np.testing.assert_allclose(occ_q[-1], fq[-1], rtol=1e-6)


def test_separate_smhm_parameters_take_effect():
    params = dict(TINKER13_PARAMS)
    logm = np.linspace(11.5, 13.5, 16)
    base_q = tinker13_centrals(params, logm, 10.5, 1.0, "quiescent")
    base_a = tinker13_centrals(params, logm, 10.5, 1.0, "active")
    shifted = dict(params, smhm_m1_0_quiescent=12.6)
    got_q = tinker13_centrals(shifted, logm, 10.5, 1.0, "quiescent")
    got_a = tinker13_centrals(shifted, logm, 10.5, 1.0, "active")
    assert not np.allclose(got_q, base_q)
    np.testing.assert_array_equal(got_a, base_a)


def test_gradients_flow():
    params = {k: jnp.asarray(v, dtype=jnp.float64)
              for k, v in TINKER13_PARAMS.items()}
    logm = jnp.linspace(11.5, 14.5, 8)

    for name in ("quiescent_fraction_ordinates_param2",
                 "smhm_m1_0_quiescent", "alphasat_active"):
        def f(v):
            p = dict(params, **{name: v})
            return (jnp.sum(tinker13_centrals(p, logm, 10.5, 1.0, "all"))
                    + jnp.sum(tinker13_satellites(p, logm, 10.5, 1.0,
                                                  "all")))
        x0 = float(params[name])
        g = float(jax.grad(f)(jnp.asarray(x0)))
        eps = 1e-6 * max(abs(x0), 1.0)
        fd = (float(f(jnp.asarray(x0 + eps))) -
              float(f(jnp.asarray(x0 - eps)))) / (2 * eps)
        np.testing.assert_allclose(g, fd, rtol=2e-5, atol=1e-10)


def test_residual_absorption_exact():
    """occupation_residual == occupation evaluated at logM + res in
    float64 (exact absorption through f_q's segment slope, the IFT SHMR
    shift, and the affine satellite exponents)."""
    model = tt.Tinker13Model(threshold=10.5, redshift=0.5)
    params = {k: np.float64(v) for k, v in model.param_dict.items()}
    logm = np.linspace(11.2, 15.2, 24)
    res = np.full_like(logm, 3e-7)
    for gal_type in ("centrals", "satellites"):
        want = model.occupation(params, gal_type, logm + res, 0.5)
        got = model.occupation_residual(params, gal_type, logm, res, 0.5)
        np.testing.assert_allclose(got, want, rtol=1e-8)


def test_predict_through_table_and_designations(wp_tabcorr):
    z = wp_tabcorr.attrs["redshift"]
    m_all = tt.Tinker13Model(threshold=10.5, redshift=z)
    m_q = tt.Tinker13Model(threshold=10.5, redshift=z,
                           sfr_designation="quiescent")
    m_a = tt.Tinker13Model(threshold=10.5, redshift=z,
                           sfr_designation="active")
    ngal, xi = wp_tabcorr.predict(m_all, check_consistency=False)
    ngal_q, _ = wp_tabcorr.predict(m_q, check_consistency=False)
    ngal_a, _ = wp_tabcorr.predict(m_a, check_consistency=False)
    assert ngal > 0 and np.all(np.isfinite(xi))
    # Number densities decompose exactly (predict is linear in <N>).
    np.testing.assert_allclose(ngal_q + ngal_a, ngal, rtol=1e-12)
    with pytest.raises(ValueError):
        tt.Tinker13Model(sfr_designation="green")
    with pytest.raises(ValueError):
        tt.Tinker13Model(quiescent_fraction_abscissa=(13.0, 12.0))


def test_custom_abscissa_re_keys_ordinates():
    m = tt.Tinker13Model(quiescent_fraction_abscissa=(12.0, 13.0, 14.0,
                                                      15.0))
    assert "quiescent_fraction_ordinates_param4" in m.param_dict
    m.param_dict["quiescent_fraction_ordinates_param4"] = 0.9
    occ = m.mean_occupation_centrals(
        prim_haloprop=10.0 ** np.array([15.5]))
    assert np.isfinite(occ[0])


def test_vectorized_predictor_matches_host(wp_tabcorr):
    model = tt.Tinker13Model(threshold=10.5,
                             redshift=wp_tabcorr.attrs["redshift"])
    ngal_h, xi_h = wp_tabcorr.predict(model, check_consistency=False)
    pred = wp_tabcorr.make_predictor(model, vectorized=True,
                                     dtype=jnp.float64)
    batch = {k: np.full(3, v) for k, v in model.param_dict.items()}
    batch["quiescent_fraction_ordinates_param2"][1] = 0.5
    ngal, xi = pred(batch)
    np.testing.assert_allclose(float(ngal[0]), ngal_h, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(xi)[0], xi_h, rtol=1e-9)
    assert float(ngal[1]) != float(ngal[0])


def test_float32_multi_predictor_matches_float64_and_gather_free(
        wp_tabcorr):
    """The traced occupation is gather-free and the float32 joint
    predictor matches the float64 one at the float32 contract."""
    from tabcorr_tpu.predictor import (make_multi_predictor,
                                       occupation_functions, params_batch)

    model = tt.Tinker13Model(threshold=10.5,
                             redshift=wp_tabcorr.attrs["redshift"])

    occ_c, occ_s = occupation_functions(model)
    logm = jnp.linspace(11.0, 15.0, 32, dtype=jnp.float32)
    sec = jnp.full_like(logm, 0.5)
    p32 = {k: jnp.asarray(v, dtype=jnp.float32)
           for k, v in model.param_dict.items()}
    jaxpr = jax.make_jaxpr(lambda p: occ_c(p, logm, sec))(p32)
    prims = {eqn.primitive.name for eqn in jaxpr.eqns}
    assert "gather" not in prims and "dynamic_slice" not in prims

    f_b = make_multi_predictor([wp_tabcorr], model)
    f_x = make_multi_predictor([wp_tabcorr], model, dtype=jnp.float64)
    params = params_batch(
        model, {"smhm_m1_0_quiescent":
                model.param_dict["smhm_m1_0_quiescent"] +
                0.05 * np.random.default_rng(0).normal(size=8)},
        (8,), dtype=jnp.float32)
    [(ng_b, xi_b)] = f_b(params)
    [(ng_x, xi_x)] = f_x({k: jnp.asarray(v, jnp.float64)
                          for k, v in params.items()})
    np.testing.assert_allclose(np.asarray(ng_b), np.asarray(ng_x),
                               rtol=2e-5)
    np.testing.assert_allclose(
        np.asarray(xi_b), np.asarray(xi_x), rtol=1e-4,
        atol=2e-6 * float(np.max(np.abs(np.asarray(xi_x)))))


def test_assembias_tinker13_single_population_ceiling():
    """Single-SFR decorated centrals honor the population's OWN ceiling
    (f_q resp. 1 - f_q, models/assembias.py:196-212): bounded at every
    strength, mean-preserving, and SATURATING the ceiling at strength 1
    wherever the baseline sits in the boost-limited regime (base >=
    ceiling/2 for the symmetric 0.5 split).  The armed halotools twin is
    tests/test_reference_parity.py::
    test_assembias_tinker13_central_ceiling_vs_halotools."""
    from tabcorr_tpu.models import AssembiasTinker13Model
    logm = np.linspace(12.0, 15.3, 61)
    for sfr in ("quiescent", "active"):
        model = AssembiasTinker13Model(threshold=10.5, redshift=0.5,
                                       sfr_designation=sfr)
        base_model = tt.Tinker13Model(threshold=10.5, redshift=0.5,
                                      sfr_designation=sfr)
        fq = tinker13_quiescent_fraction(model.param_dict, logm)
        ceiling = fq if sfr == "quiescent" else 1.0 - fq
        base = base_model.occupation(base_model.param_dict, "centrals",
                                     logm, 0.5)
        for strength in (-1.0, -0.3, 0.5, 1.0):
            model.param_dict[
                "mean_occupation_centrals_assembias_param1"] = strength
            params = dict(model.param_dict)
            hi = model.occupation(params, "centrals", logm, 0.75)
            lo = model.occupation(params, "centrals", logm, 0.25)
            assert np.all(hi <= ceiling + 1e-12), (sfr, strength)
            assert np.all(lo <= ceiling + 1e-12), (sfr, strength)
            assert np.all(hi >= -1e-14) and np.all(lo >= -1e-14)
            np.testing.assert_allclose(0.5 * (hi + lo), base, rtol=1e-10)
        tight = base >= 0.5 * ceiling + 1e-9
        assert np.any(tight)
        np.testing.assert_allclose(hi[tight], ceiling[tight], rtol=1e-10)


def test_assembias_tinker13_mean_preservation():
    from tabcorr_tpu.models import AssembiasTinker13Model
    model = AssembiasTinker13Model(threshold=10.5, redshift=0.5)
    model.param_dict["mean_occupation_centrals_assembias_param1"] = 0.7
    model.param_dict["mean_occupation_satellites_assembias_param1"] = -0.4
    params = dict(model.param_dict)
    logm = np.linspace(11.5, 15.0, 16)
    base = tt.Tinker13Model(threshold=10.5, redshift=0.5)
    for gal_type in ("centrals", "satellites"):
        hi = model.occupation(params, gal_type, logm, 0.75)
        lo = model.occupation(params, gal_type, logm, 0.25)
        mean = 0.5 * (hi + lo)
        want = base.occupation(base.param_dict, gal_type, logm, 0.5)
        np.testing.assert_allclose(mean, want, rtol=1e-10)
        assert np.all(hi >= 0) and np.all(lo >= 0)
