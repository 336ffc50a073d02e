"""HOD occupation model tests."""

import numpy as np
import pytest
from scipy.special import erf

import tabcorr_tpu as tt
from tabcorr_tpu.models import (AssembiasZheng07Model, Zheng07Model,
                                heaviside_assembias)
from tabcorr_tpu.models.zheng07 import ZHENG07_THRESHOLD_PARAMS


def test_zheng07_centrals_formula():
    model = Zheng07Model(threshold=-20)
    mass = np.logspace(10, 15, 101)
    got = model.mean_occupation_centrals(prim_haloprop=mass)
    p = model.param_dict
    x = (np.log10(mass) - p["logMmin"]) / p["sigma_logM"]
    # The (1 + erf)/2 form underflows the deep tail in float64 (erf(x)
    # rounds to -1); the erfc form is the same function evaluated
    # tail-accurately, so the oracle must use it too.
    from scipy.special import erfc
    want = 0.5 * erfc(-x)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, 0.5 * (1 + erf(x)), rtol=1e-9,
                               atol=1e-12)
    assert np.all(got >= 0) and np.all(got <= 1)


def test_zheng07_satellites_formula():
    model = Zheng07Model(threshold=-20)
    mass = np.logspace(10, 15, 101)
    got = model.mean_occupation_satellites(prim_haloprop=mass)
    p = model.param_dict
    m0, m1 = 10 ** p["logM0"], 10 ** p["logM1"]
    want = np.where(mass > m0, ((mass - m0) / m1) ** p["alpha"], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_zheng07_satellites_modulated():
    plain = Zheng07Model(threshold=-20)
    mod = Zheng07Model(threshold=-20, modulate_with_cenocc=True)
    mass = np.logspace(11, 15, 41)
    ncen = plain.mean_occupation_centrals(prim_haloprop=mass)
    np.testing.assert_allclose(
        mod.mean_occupation_satellites(prim_haloprop=mass),
        ncen * plain.mean_occupation_satellites(prim_haloprop=mass),
        rtol=1e-12)


def test_zheng07_threshold_table():
    # All Zheng07 Table 1 thresholds instantiate with 5 parameters.
    for threshold, params in ZHENG07_THRESHOLD_PARAMS.items():
        model = Zheng07Model(threshold=threshold)
        for key, value in params.items():
            assert model.param_dict[key] == value
    with pytest.raises(ValueError):
        Zheng07Model(threshold=-17.0)


def test_param_overrides():
    model = Zheng07Model(threshold=-20, logMmin=13.0)
    assert model.param_dict["logMmin"] == 13.0
    with pytest.raises(ValueError):
        Zheng07Model(threshold=-20, not_a_param=1.0)


def test_assembias_mean_preservation():
    # Averaging the decorated occupation over the percentile distribution
    # must recover the baseline at every mass (the defining property of the
    # Heaviside decoration).
    model = AssembiasZheng07Model(threshold=-20)
    model.param_dict["mean_occupation_centrals_assembias_param1"] = 0.7
    model.param_dict["mean_occupation_satellites_assembias_param1"] = -0.4
    base = Zheng07Model(threshold=-20)

    mass = np.logspace(11, 15, 41)
    for split in [0.5]:
        perc = np.linspace(0.0005, 0.9995, 1000)
        for fn, base_fn in [
                (model.mean_occupation_centrals,
                 base.mean_occupation_centrals),
                (model.mean_occupation_satellites,
                 base.mean_occupation_satellites)]:
            occ = np.array([fn(prim_haloprop=mass,
                                sec_haloprop_percentile=np.full_like(mass, q))
                            for q in perc])
            np.testing.assert_allclose(
                occ.mean(axis=0), base_fn(prim_haloprop=mass),
                rtol=1e-9, atol=1e-13)


def test_assembias_bounds_respected():
    model = AssembiasZheng07Model(threshold=-20)
    mass = np.logspace(10, 15.5, 201)
    for strength in [-1.0, -0.5, 0.5, 1.0]:
        model.param_dict["mean_occupation_centrals_assembias_param1"] = \
            strength
        model.param_dict["mean_occupation_satellites_assembias_param1"] = \
            strength
        for perc in [0.1, 0.9]:
            q = np.full_like(mass, perc)
            ncen = model.mean_occupation_centrals(
                prim_haloprop=mass, sec_haloprop_percentile=q)
            nsat = model.mean_occupation_satellites(
                prim_haloprop=mass, sec_haloprop_percentile=q)
            assert np.all(ncen >= -1e-12) and np.all(ncen <= 1 + 1e-12)
            assert np.all(nsat >= -1e-12)


def test_assembias_zero_strength_is_baseline():
    model = AssembiasZheng07Model(threshold=-20)
    base = Zheng07Model(threshold=-20)
    mass = np.logspace(11, 15, 41)
    q = np.full_like(mass, 0.8)
    np.testing.assert_allclose(
        model.mean_occupation_centrals(
            prim_haloprop=mass, sec_haloprop_percentile=q),
        base.mean_occupation_centrals(prim_haloprop=mass), rtol=1e-12)


def test_heaviside_assembias_direction():
    # Positive strength boosts the above-split population.
    base = np.array([0.5])
    hi = heaviside_assembias(base, 0.5, np.array([0.9]))
    lo = heaviside_assembias(base, 0.5, np.array([0.1]))
    assert float(hi[0]) > 0.5 > float(lo[0])


def test_functional_hod_model(wp_tabcorr=None):
    import numpy as np
    from tabcorr_tpu.models import FunctionalHodModel
    from tabcorr_tpu.utils.backend import get_namespace

    def smooth_cen(params, log_m, sec):
        xp = get_namespace(log_m)
        return 1.0 / (1.0 + xp.exp(-(log_m - params["logMmin"]) * 5.0))

    def power_sat(params, log_m, sec):
        return 10.0 ** (params["alpha"] * (log_m - params["logM1"]))

    model = FunctionalHodModel(
        smooth_cen, power_sat,
        {"logMmin": 12.0, "logM1": 13.5, "alpha": 1.0}, redshift=0.0)

    mass = np.logspace(11, 15, 21)
    ncen = model.mean_occupation_centrals(prim_haloprop=mass)
    nsat = model.mean_occupation_satellites(prim_haloprop=mass)
    assert np.all((ncen >= 0) & (ncen <= 1))
    np.testing.assert_allclose(nsat, (mass / 10**13.5), rtol=1e-10)

    model.param_dict["alpha"] = 2.0
    nsat2 = model.mean_occupation_satellites(prim_haloprop=mass)
    np.testing.assert_allclose(nsat2, (mass / 10**13.5) ** 2, rtol=1e-9)


def test_functional_model_predicts(request):
    import numpy as np
    import jax.numpy as jnp
    import tabcorr_tpu as tt
    from tabcorr_tpu.models import FunctionalHodModel
    from tabcorr_tpu.predictor import make_predictor, params_batch
    from tabcorr_tpu.utils.backend import erf, get_namespace

    wp_tab = request.getfixturevalue("wp_tabcorr")

    def cen(params, log_m, sec):
        return 0.5 * (1 + erf((log_m - params["logMmin"]) / 0.3))

    def sat(params, log_m, sec):
        xp = get_namespace(log_m)
        return xp.maximum(10.0 ** (log_m - params["logM1"]) - 0.01, 0.0)

    model = FunctionalHodModel(
        cen, sat, {"logMmin": 11.5, "logM1": 12.5},
        redshift=wp_tab.attrs["redshift"], prim_haloprop_key="halo_mvir")

    ngal, wp = wp_tab.predict(model, check_consistency=False)
    assert np.isfinite(ngal) and np.all(np.isfinite(wp))

    f = make_predictor(wp_tab, model, dtype=jnp.float64)
    params = params_batch(model, {}, (3,), dtype=jnp.float64)
    ngal_b, wp_b = f(params)
    np.testing.assert_allclose(np.asarray(wp_b[0]), wp, rtol=1e-12)


def test_erf_erfc_poly_accuracy():
    # The polynomial erf/erfc (utils.backend) against
    # scipy: absolute accuracy everywhere, RELATIVE accuracy on the
    # complementary tail (what deep-tail halo occupations need).
    from scipy.special import erf as erf_sp, erfc as erfc_sp

    from tabcorr_tpu.utils.backend import erf_poly, erfc_poly

    # Bounds are the deg-8 Chebyshev fit error (~5e-8 relative) — an
    # order below the ~3-ulp float32 device evaluation noise that sets
    # the actual occupation error contract.
    x = np.linspace(-6, 6, 200001)
    assert np.max(np.abs(erf_poly(x) - erf_sp(x))) < 5e-8
    z = np.linspace(0, 5.9, 100001)
    rel = np.abs(erfc_poly(z) / erfc_sp(z) - 1)
    assert rel.max() < 1e-7


def test_float32_device_erf_uses_polynomial():
    # Sub-float64 device arrays take the polynomial erf/erfc (XLA's own
    # float32 erfc is ~4e-6 relative); float64 device arrays take XLA's
    # and numpy inputs keep scipy.
    import jax.numpy as jnp

    from tabcorr_tpu.utils import backend

    x = jnp.linspace(-3, 3, 64, dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(backend.erf(x)),
                                  np.asarray(backend.erf_poly(x)))
    np.testing.assert_array_equal(np.asarray(backend.erfc(x)),
                                  np.asarray(backend.erfc_poly(x)))
    x64 = jnp.linspace(-3, 3, 64, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(backend.erf(x64)),
                               np.asarray(backend.erf_poly(x64)), atol=1e-6)
    assert backend.erf(0.5) == backend.erf(np.float64(0.5))


def test_zheng07_centrals_tail_is_relative_accurate():
    # The erfc form keeps the deep tail; the (1+erf)/2 form would return
    # exactly 0 below ~1e-17.
    from scipy.special import erfc

    model = Zheng07Model(threshold=-20)
    p = model.param_dict
    mass = 10.0 ** np.array([p["logMmin"] - 5 * p["sigma_logM"]])
    got = model.mean_occupation_centrals(prim_haloprop=mass)
    want = 0.5 * erfc(5 / np.sqrt(1))  # x = -5 sigma
    np.testing.assert_allclose(got, 0.5 * erfc(5.0), rtol=1e-10)
    assert got[0] > 0


def test_occupation_residual_matches_jvp_fallback():
    # The analytic residual absorption (zheng07 / assembias overrides)
    # must agree with the generic first-order JVP fallback to second
    # order in the ~ulp/2 node residual, for both galaxy types.
    import jax.numpy as jnp

    from tabcorr_tpu.models.assembias import AssembiasZheng07Model
    from tabcorr_tpu.models.protocol import HodModel

    model = AssembiasZheng07Model(threshold=-20)
    model.param_dict["mean_occupation_centrals_assembias_param1"] = 0.4
    model.param_dict["mean_occupation_satellites_assembias_param1"] = -0.3
    params = {k: jnp.float64(v) for k, v in model.param_dict.items()}
    logm = jnp.linspace(10.5, 15.2, 64, dtype=jnp.float64)
    res = jnp.asarray(
        np.random.default_rng(3).uniform(-5e-7, 5e-7, 64))
    sec = jnp.full(64, 0.7, dtype=jnp.float64)

    for gal_type in model.gal_types:
        exact = model.occupation_residual(params, gal_type, logm, res, sec)
        generic = HodModel.occupation_residual(
            model, params, gal_type, logm, res, sec)
        base = model.occupation(params, gal_type, logm, sec)
        # Difference bounded by the second-order term ~ occ'' res^2.
        np.testing.assert_allclose(np.asarray(exact), np.asarray(generic),
                                   atol=1e-10, rtol=1e-6)
        # And the residual actually moves the occupation (not a no-op).
        assert np.max(np.abs(np.asarray(exact - base))) > 0


@pytest.mark.parametrize("family", ["leauthaud11", "zu15"])
def test_shmr_occupation_residual_exact_absorption(family):
    # The SHMR families' occupation_residual uses the implicit-function-
    # theorem derivative (one analytic forward-derivative evaluation)
    # instead of a JVP through the Newton inversion.  It must match the
    # ground truth occ(logM + res) evaluated directly in float64, and
    # the decorated (assembias) variants must compose the decoration
    # (NOT inherit the undecorated absorption).
    import jax.numpy as jnp

    from tabcorr_tpu.models import (AssembiasLeauthaud11Model,
                                    AssembiasZuMandelbaum15Model)

    if family == "leauthaud11":
        model = tt.Leauthaud11Model(threshold=10.5, redshift=0.3)
        ab_model = AssembiasLeauthaud11Model(threshold=10.5, redshift=0.3)
    else:
        model = tt.ZuMandelbaum15Model(threshold=10.5)
        ab_model = AssembiasZuMandelbaum15Model(threshold=10.5)
    ab_model.param_dict["mean_occupation_centrals_assembias_param1"] = 0.4
    ab_model.param_dict["mean_occupation_satellites_assembias_param1"] = -0.3

    rng = np.random.default_rng(7)
    logm = jnp.asarray(np.linspace(11.0, 15.4, 64))
    res = jnp.asarray(rng.uniform(-5e-7, 5e-7, 64))
    sec = jnp.asarray(rng.uniform(0.05, 0.95, 64))

    for m in (model, ab_model):
        params = {k: jnp.float64(v) for k, v in m.param_dict.items()}
        for gal_type in m.gal_types:
            truth = m.occupation(params, gal_type, logm + res, sec)
            exact = m.occupation_residual(params, gal_type, logm, res, sec)
            base = m.occupation(params, gal_type, logm, sec)
            # First-order absorption: agreement to second order in the
            # ~5e-7 residual (the absorbed shift itself is ~1e-6
            # relative; the quadratic remainder is ~(arg * res)^2,
            # largest in deep erfc tails where occ''/occ ~ 1e3).
            np.testing.assert_allclose(
                np.asarray(exact), np.asarray(truth), rtol=1e-8,
                err_msg=f"{type(m).__name__}/{gal_type}")
            assert np.max(np.abs(np.asarray(exact - base))) > 0


# ---------------------------------------------------------------------------
# Leauthaud11 (SHMR-based) model
# ---------------------------------------------------------------------------

def test_behroozi10_inversion_roundtrip():
    from tabcorr_tpu.models import (behroozi10_log_halo_mass,
                                    fshmr_log_mstar)
    from tabcorr_tpu.models.leauthaud11 import LEAUTHAUD11_PARAMS
    params = dict(LEAUTHAUD11_PARAMS)
    a = 1.0 / 1.5
    log_mh = np.linspace(10.5, 15.5, 41)
    log_mstar = fshmr_log_mstar(log_mh, params, a)
    # The inversion is a true root of the closed-form forward relation.
    np.testing.assert_allclose(
        behroozi10_log_halo_mass(log_mstar, params, a), log_mh,
        rtol=0, atol=1e-10)
    # Monotone.
    assert np.all(np.diff(log_mstar) > 0)


def test_leauthaud11_centrals_half_at_threshold_mass():
    from tabcorr_tpu.models import behroozi10_log_halo_mass
    from tabcorr_tpu.models.leauthaud11 import LEAUTHAUD11_PARAMS
    model = tt.Leauthaud11Model(threshold=10.5, redshift=0.5)
    a = 1.0 / 1.5
    # At the halo mass where f_SHMR equals the threshold, <N_cen> = 1/2
    # exactly (erfc(0)/2), independent of the scatter.
    log_mh_t = behroozi10_log_halo_mass(10.5, dict(LEAUTHAUD11_PARAMS), a)
    ncen = model.mean_occupation_centrals(
        prim_haloprop=np.array([10 ** log_mh_t]))
    np.testing.assert_allclose(ncen, 0.5, rtol=1e-9)
    # Monotone increasing, 0 and 1 in the limits.
    mass = 10 ** np.linspace(10.5, 15.5, 64)
    ncen = model.mean_occupation_centrals(prim_haloprop=mass)
    assert np.all(np.diff(ncen) >= 0)
    assert ncen[0] < 1e-8 and ncen[-1] > 1 - 1e-8


def test_leauthaud11_satellites_scalings():
    from tabcorr_tpu.models import behroozi10_log_halo_mass
    from tabcorr_tpu.models.leauthaud11 import LEAUTHAUD11_PARAMS
    model = tt.Leauthaud11Model(threshold=10.5, redshift=0.0,
                                modulate_with_cenocc=False)
    params = dict(LEAUTHAUD11_PARAMS)
    log_mh_t = behroozi10_log_halo_mass(10.5, params, 1.0)
    log_msat = (12.0 + np.log10(params["bsat"]) +
                params["betasat"] * (log_mh_t - 12.0))
    log_mcut = (12.0 + np.log10(params["bcut"]) +
                params["betacut"] * (log_mh_t - 12.0))
    mass = 10 ** np.linspace(12.5, 15.5, 16)
    nsat = model.mean_occupation_satellites(prim_haloprop=mass)
    want = ((mass / 10 ** log_msat) ** params["alphasat"] *
            np.exp(-(10 ** log_mcut) / mass))
    np.testing.assert_allclose(nsat, want, rtol=1e-9)
    # The modulated form is <N_cen> times the unmodulated one.
    model_mod = tt.Leauthaud11Model(threshold=10.5, redshift=0.0)
    nsat_mod = model_mod.mean_occupation_satellites(prim_haloprop=mass)
    ncen = model_mod.mean_occupation_centrals(prim_haloprop=mass)
    np.testing.assert_allclose(nsat_mod, nsat * ncen, rtol=1e-9)


def test_leauthaud11_gradients_flow_through_inversion():
    import jax
    import jax.numpy as jnp
    from tabcorr_tpu.models.leauthaud11 import (LEAUTHAUD11_PARAMS,
                                                leauthaud11_centrals)
    params = {k: jnp.float64(v) for k, v in LEAUTHAUD11_PARAMS.items()}
    log_mh = jnp.asarray(13.0, dtype=jnp.float64)

    def ncen_of(p):
        return leauthaud11_centrals(p, log_mh, 10.5, 1.0)

    grads = jax.grad(lambda p: ncen_of(p))(params)
    # Finite differences on a representative subset.
    for key in ["smhm_m1_0", "smhm_beta_0", "smhm_gamma_0",
                "scatter_model_param1"]:
        eps = 1e-6
        p_hi = dict(params)
        p_lo = dict(params)
        p_hi[key] = params[key] + eps
        p_lo[key] = params[key] - eps
        fd = (ncen_of(p_hi) - ncen_of(p_lo)) / (2 * eps)
        np.testing.assert_allclose(grads[key], fd, rtol=1e-4,
                                   err_msg=key)
        assert abs(float(grads[key])) > 0


def test_leauthaud11_predict_through_table(wp_tabcorr):
    model = tt.Leauthaud11Model(threshold=10.5,
                                redshift=wp_tabcorr.attrs["redshift"])
    ngal, xi = wp_tabcorr.predict(model, check_consistency=False)
    assert ngal > 0 and np.all(np.isfinite(xi))
    # Occupations respond to the SHMR normalization.
    model2 = tt.Leauthaud11Model(threshold=10.5,
                                 redshift=wp_tabcorr.attrs["redshift"],
                                 smhm_m1_0=12.6)
    ngal2, _ = wp_tabcorr.predict(model2, check_consistency=False)
    assert ngal2 != ngal


def test_leauthaud11_vectorized_predictor_matches_host(wp_tabcorr):
    import jax.numpy as jnp
    model = tt.Leauthaud11Model(threshold=10.5,
                                redshift=wp_tabcorr.attrs["redshift"])
    ngal_h, xi_h = wp_tabcorr.predict(model, check_consistency=False)
    pred = wp_tabcorr.make_predictor(model, vectorized=True,
                                     dtype=jnp.float64)
    batch = {k: np.full(3, v) for k, v in model.param_dict.items()}
    batch["smhm_m1_0"][1] = 12.5
    ngal, xi = pred(batch)
    np.testing.assert_allclose(float(ngal[0]), ngal_h, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(xi)[0], xi_h, rtol=1e-9)
    assert float(ngal[1]) != float(ngal[0])


def test_leauthaud11_float32_predictor_matches_float64(wp_tabcorr):
    # The float32 device path through the grid-seeded SHMR inversion
    # must match the float64 device path at the float32 contract.
    import jax.numpy as jnp
    model = tt.Leauthaud11Model(threshold=10.5,
                                redshift=wp_tabcorr.attrs["redshift"])
    pred_f = wp_tabcorr.make_predictor(model, vectorized=True,
                                       dtype=jnp.float32)
    pred_x = wp_tabcorr.make_predictor(model, vectorized=True,
                                       dtype=jnp.float64)
    batch32 = {k: np.full(2, v, dtype=np.float32)
               for k, v in model.param_dict.items()}
    batch32["smhm_m1_0"][1] = 12.5
    batch64 = {k: v.astype(np.float64) for k, v in batch32.items()}
    ngal_f, xi_f = pred_f(batch32)
    ngal_x, xi_x = pred_x(batch64)
    np.testing.assert_allclose(np.asarray(ngal_f), np.asarray(ngal_x),
                               rtol=2e-5)
    np.testing.assert_allclose(np.asarray(xi_f), np.asarray(xi_x),
                               rtol=2e-4)


def test_shmr_bisection_seed_matches_interp_and_is_gather_free():
    # monotone_inverse's two seeds land on the same SHMR root to float
    # precision, and the bisection seed traces no gather.
    import jax
    import jax.numpy as jnp
    from tabcorr_tpu.models.leauthaud11 import (
        _GRID_HI, _GRID_LO, _GRID_N, LEAUTHAUD11_PARAMS,
        _d_log_mh_d_log_mstar, behroozi10_log_halo_mass)
    from tabcorr_tpu.utils.inversion import monotone_inverse

    params = {k: jnp.asarray(v) for k, v in LEAUTHAUD11_PARAMS.items()}

    def fwd(ls):
        return behroozi10_log_halo_mass(ls, params, 1.0 / 1.5, 0.72)

    def dfwd(ls):
        return _d_log_mh_d_log_mstar(ls, params, 1.0 / 1.5, 0.72)

    log_mh = jnp.linspace(10.5, 15.5, 64)
    grid = jnp.linspace(_GRID_LO, _GRID_HI, _GRID_N)
    want = monotone_inverse(fwd, log_mh, grid, dfn=dfwd, seed="interp")

    def bisect(l):
        return monotone_inverse(fwd, l, dfn=dfwd,
                                bracket=(_GRID_LO, _GRID_HI))

    np.testing.assert_allclose(np.asarray(bisect(log_mh)),
                               np.asarray(want), rtol=0, atol=1e-10)
    prims = {eqn.primitive.name
             for eqn in jax.make_jaxpr(bisect)(log_mh).eqns}
    assert "gather" not in prims and "dynamic_slice" not in prims, (
        sorted(prims))


def test_assembias_leauthaud11_mean_preservation_and_baseline():
    from tabcorr_tpu.models import AssembiasLeauthaud11Model
    model = AssembiasLeauthaud11Model(threshold=10.5, redshift=0.0)
    model.param_dict["mean_occupation_centrals_assembias_param1"] = 0.7
    model.param_dict["mean_occupation_satellites_assembias_param1"] = -0.4
    mass = 10 ** np.linspace(11.5, 15.0, 32)
    base_model = tt.Leauthaud11Model(threshold=10.5, redshift=0.0)
    for name in ["mean_occupation_centrals", "mean_occupation_satellites"]:
        fn = getattr(model, name)
        lo = fn(prim_haloprop=mass,
                sec_haloprop_percentile=np.full_like(mass, 0.25))
        hi = fn(prim_haloprop=mass,
                sec_haloprop_percentile=np.full_like(mass, 0.75))
        # Mass-conditioned mean is exactly preserved at split=0.5 ...
        base = getattr(base_model, name)(prim_haloprop=mass)
        np.testing.assert_allclose(0.5 * (lo + hi), base, rtol=1e-9)
        # ... and the perturbation is active.
        assert np.any(np.abs(hi - lo) > 1e-6)
    # Centrals stay within [0, 1].
    hi = model.mean_occupation_centrals(
        prim_haloprop=mass, sec_haloprop_percentile=np.full_like(mass, 0.9))
    assert np.all(hi <= 1.0 + 1e-12) and np.all(hi >= 0.0)
    # Zero strength reduces to the baseline.
    model.param_dict["mean_occupation_centrals_assembias_param1"] = 0.0
    model.param_dict["mean_occupation_satellites_assembias_param1"] = 0.0
    base_model = tt.Leauthaud11Model(threshold=10.5, redshift=0.0)
    np.testing.assert_allclose(
        model.mean_occupation_centrals(prim_haloprop=mass),
        base_model.mean_occupation_centrals(prim_haloprop=mass), rtol=1e-12)


def test_assembias_branch_consistent_across_dtypes(wp_tabcorr):
    # The bolplanck fixture has ONE sec bin whose percentile midpoint is
    # 0.5 - 6e-17: below 0.5 in float64 but exactly 0.5 after float32
    # rounding.  The decorated occupation must classify it identically
    # on the float64 host path and the float32 device path.
    import jax.numpy as jnp
    sec = np.unique(np.asarray(
        wp_tabcorr.gal_type["sec_haloprop_percentile"], dtype=np.float64))
    assert len(sec) == 1 and sec[0] < 0.5  # the knife-edge fixture
    model = tt.AssembiasZheng07Model(
        threshold=-18, redshift=wp_tabcorr.attrs["redshift"])
    model.param_dict["mean_occupation_centrals_assembias_param1"] = 0.5
    ngal_h, _ = wp_tabcorr.predict(model, check_consistency=False)
    pred = wp_tabcorr.make_predictor(model, vectorized=True,
                                     dtype=jnp.float32)
    batch = {k: np.full(1, v, dtype=np.float32)
             for k, v in model.param_dict.items()}
    ngal_d, _ = pred(batch)
    np.testing.assert_allclose(float(ngal_d[0]), ngal_h, rtol=2e-5)


def test_leauthaud11_through_interpolator(ds_interpolator):
    # The Interpolator is model-agnostic: grid parameters (log_eta, ...)
    # come from param_dict while the occupations come from the SHMR.
    model = tt.Leauthaud11Model(
        threshold=10.5, redshift=0.5, prim_haloprop_key="halo_m258m",
        sec_haloprop_key="halo_nfw_conc")
    model.param_dict["log_eta"] = 0.0
    model.param_dict["alpha_s"] = 1.0
    model.param_dict["alpha_c"] = 0.0
    ngal, ds = ds_interpolator.predict(model, check_consistency=False)
    assert ngal > 0 and np.all(np.isfinite(ds))
    # Off-node grid values interpolate smoothly.
    model.param_dict["log_eta"] = 0.1
    ngal2, ds2 = ds_interpolator.predict(model, check_consistency=False)
    assert np.all(np.isfinite(ds2)) and not np.allclose(ds, ds2)


def test_monotone_inverse_utility():
    import jax
    import jax.numpy as jnp
    from tabcorr_tpu.utils.inversion import monotone_inverse

    # Numpy path with analytic derivative.
    grid = np.linspace(-3.0, 3.0, 101)
    y = np.linspace(-20.0, 20.0, 17)
    x = monotone_inverse(lambda t: t**3 + 2 * t, y, grid,
                         dfn=lambda t: 3 * t**2 + 2)
    np.testing.assert_allclose(x**3 + 2 * x, y, atol=1e-12)

    # jax path with the default jvp derivative; parameter gradients are
    # exact (implicit function theorem): d/dc of root(t^3 + 2t + c = y)
    # is -1 / (3 t^2 + 2).
    def root_of(c):
        return monotone_inverse(lambda t: t**3 + 2 * t + c,
                                jnp.float64(5.0),
                                jnp.asarray(grid))
    g = jax.grad(root_of)(jnp.float64(0.3))
    t = root_of(jnp.float64(0.3))
    np.testing.assert_allclose(float(g), -1.0 / (3 * float(t)**2 + 2),
                               rtol=1e-9)


def test_leauthaud11_batched_interpolator_matches_host(ds_interpolator):
    import jax.numpy as jnp
    from tabcorr_tpu.predictor import make_predictor, params_batch
    model = tt.Leauthaud11Model(
        threshold=10.5, redshift=0.5, prim_haloprop_key="halo_m258m",
        sec_haloprop_key="halo_nfw_conc")
    model.param_dict["log_eta"] = 0.05
    ngal_h, ds_h = ds_interpolator.predict(model, check_consistency=False)

    pred = make_predictor(ds_interpolator, model, dtype=jnp.float64)
    params = params_batch(model, {"log_eta": np.array([0.05, 0.15])},
                          (2,), dtype=jnp.float64)
    ngal, ds = pred(params)
    np.testing.assert_allclose(float(ngal[0]), ngal_h, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(ds)[0], ds_h, rtol=1e-9)
    assert not np.allclose(np.asarray(ds)[1], ds_h)


# ---------------------------------------------------------------------------
# Zu & Mandelbaum (2015) iHOD model
# ---------------------------------------------------------------------------

def test_zu15_inversion_roundtrip():
    from tabcorr_tpu.models import zu15_log_halo_mass, zu15_log_mstar
    from tabcorr_tpu.models.zu_mandelbaum15 import ZU_MANDELBAUM15_PARAMS
    params = dict(ZU_MANDELBAUM15_PARAMS)
    log_mh = np.linspace(10.5, 15.5, 41)
    log_mstar = zu15_log_mstar(log_mh, params)
    np.testing.assert_allclose(zu15_log_halo_mass(log_mstar, params),
                               log_mh, rtol=0, atol=1e-10)
    assert np.all(np.diff(log_mstar) > 0)


def test_zu15_scatter_form():
    from tabcorr_tpu.models import zu15_scatter_ln_mstar
    from tabcorr_tpu.models.zu_mandelbaum15 import ZU_MANDELBAUM15_PARAMS
    params = dict(ZU_MANDELBAUM15_PARAMS)
    log_m1 = np.log10(params["smhm_m1"])
    # Constant sigma_0 below M1 ...
    lo = zu15_scatter_ln_mstar(params, np.array([10.0, 11.0, log_m1]))
    np.testing.assert_allclose(lo, params["smhm_sigma"], rtol=1e-12)
    # ... linear in ln(Mh/M1) above (the published eta < 0 shrinks it) ...
    log_mh = np.array([13.0, 14.0])
    want = (params["smhm_sigma"] + params["smhm_sigma_slope"] *
            np.log(10.0 ** (log_mh - log_m1)))
    np.testing.assert_allclose(zu15_scatter_ln_mstar(params, log_mh),
                               want, rtol=1e-12)
    # Zu15's headline: ~0.5 at M1 down to ~0.3 at 1e14 Msun.
    assert 0.29 < want[1] < 0.35
    # ... and floored positive for pathological samples.
    assert zu15_scatter_ln_mstar(params, np.array([30.0]))[0] > 0


def test_zu15_centrals_half_at_pivot_mass():
    from tabcorr_tpu.models import zu15_log_halo_mass
    from tabcorr_tpu.models.zu_mandelbaum15 import ZU_MANDELBAUM15_PARAMS
    model = tt.ZuMandelbaum15Model(threshold=10.5)
    # At the halo mass where f_SHMR equals the threshold, <N_cen> = 1/2
    # exactly, independent of the (mass-dependent) scatter.
    log_mh_t = zu15_log_halo_mass(10.5, dict(ZU_MANDELBAUM15_PARAMS))
    ncen = model.mean_occupation_centrals(
        prim_haloprop=np.array([10 ** log_mh_t]))
    np.testing.assert_allclose(ncen, 0.5, rtol=1e-9)
    mass = 10 ** np.linspace(10.5, 15.5, 64)
    ncen = model.mean_occupation_centrals(prim_haloprop=mass)
    assert np.all(np.diff(ncen) >= 0)
    assert ncen[0] < 1e-8 and ncen[-1] > 1 - 1e-8


def test_zu15_satellites_scalings():
    from tabcorr_tpu.models import zu15_log_halo_mass
    from tabcorr_tpu.models.zu_mandelbaum15 import ZU_MANDELBAUM15_PARAMS
    model = tt.ZuMandelbaum15Model(threshold=10.5,
                                   modulate_with_cenocc=False)
    params = dict(ZU_MANDELBAUM15_PARAMS)
    log_mh_t = zu15_log_halo_mass(10.5, params)
    log_msat = (12.0 + np.log10(params["bsat"]) +
                params["betasat"] * (log_mh_t - 12.0))
    log_mcut = (12.0 + np.log10(params["bcut"]) +
                params["betacut"] * (log_mh_t - 12.0))
    mass = 10 ** np.linspace(12.5, 15.5, 16)
    nsat = model.mean_occupation_satellites(prim_haloprop=mass)
    want = ((mass / 10 ** log_msat) ** params["alphasat"] *
            np.exp(-(10 ** log_mcut) / mass))
    np.testing.assert_allclose(nsat, want, rtol=1e-9)
    model_mod = tt.ZuMandelbaum15Model(threshold=10.5)
    nsat_mod = model_mod.mean_occupation_satellites(prim_haloprop=mass)
    ncen = model_mod.mean_occupation_centrals(prim_haloprop=mass)
    np.testing.assert_allclose(nsat_mod, nsat * ncen, rtol=1e-9)


def test_zu15_gradients_flow_through_inversion():
    import jax
    import jax.numpy as jnp
    from tabcorr_tpu.models.zu_mandelbaum15 import (
        ZU_MANDELBAUM15_PARAMS, zu_mandelbaum15_centrals)
    params = {k: jnp.float64(v) for k, v in ZU_MANDELBAUM15_PARAMS.items()}
    log_mh = jnp.asarray(13.0, dtype=jnp.float64)

    def ncen_of(p):
        return zu_mandelbaum15_centrals(p, log_mh, 10.5)

    grads = jax.grad(ncen_of)(params)
    for key in ["smhm_m1", "smhm_beta", "smhm_gamma", "smhm_sigma",
                "smhm_sigma_slope"]:
        # Relative step: smhm_m1 is a LINEAR mass ~1e12.
        eps = max(abs(float(params[key])), 1.0) * 1e-6
        p_hi = dict(params)
        p_lo = dict(params)
        p_hi[key] = params[key] + eps
        p_lo[key] = params[key] - eps
        fd = (ncen_of(p_hi) - ncen_of(p_lo)) / (2 * eps)
        np.testing.assert_allclose(grads[key], fd, rtol=1e-4, err_msg=key)
        assert abs(float(grads[key])) > 0


def test_zu15_predict_through_table(wp_tabcorr):
    model = tt.ZuMandelbaum15Model(threshold=10.5,
                                   prim_haloprop_key="halo_mvir")
    ngal, xi = wp_tabcorr.predict(model, check_consistency=False)
    assert ngal > 0 and np.all(np.isfinite(xi))
    model2 = tt.ZuMandelbaum15Model(threshold=10.5,
                                    prim_haloprop_key="halo_mvir",
                                    smhm_m1=10.0 ** 12.5)
    ngal2, _ = wp_tabcorr.predict(model2, check_consistency=False)
    assert ngal2 != ngal


def test_zu15_vectorized_predictor_matches_host(wp_tabcorr):
    import jax.numpy as jnp
    model = tt.ZuMandelbaum15Model(threshold=10.5,
                                   prim_haloprop_key="halo_mvir")
    ngal_h, xi_h = wp_tabcorr.predict(model, check_consistency=False)
    pred = wp_tabcorr.make_predictor(model, vectorized=True,
                                     dtype=jnp.float64)
    batch = {k: np.full(3, v) for k, v in model.param_dict.items()}
    batch["smhm_m1"][1] = 10.0 ** 12.5
    ngal, xi = pred(batch)
    np.testing.assert_allclose(float(ngal[0]), ngal_h, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(xi)[0], xi_h, rtol=1e-9)
    assert float(ngal[1]) != float(ngal[0])


def test_assembias_zu15_mean_preservation():
    from tabcorr_tpu.models import AssembiasZuMandelbaum15Model
    model = AssembiasZuMandelbaum15Model(threshold=10.5)
    model.param_dict["mean_occupation_centrals_assembias_param1"] = 0.6
    model.param_dict["mean_occupation_satellites_assembias_param1"] = -0.3
    mass = 10 ** np.linspace(11.5, 15.0, 32)
    base_model = tt.ZuMandelbaum15Model(threshold=10.5)
    for name in ["mean_occupation_centrals", "mean_occupation_satellites"]:
        fn = getattr(model, name)
        lo = fn(prim_haloprop=mass,
                sec_haloprop_percentile=np.full_like(mass, 0.25))
        hi = fn(prim_haloprop=mass,
                sec_haloprop_percentile=np.full_like(mass, 0.75))
        base = getattr(base_model, name)(prim_haloprop=mass)
        np.testing.assert_allclose(0.5 * (lo + hi), base, rtol=1e-9)
        assert np.any(np.abs(hi - lo) > 1e-6)


def test_shmr_models_float32_multi_predictor_matches_float64(wp_tabcorr):
    # Both SHMR families (leauthaud11 and zu_mandelbaum15) through the
    # joint predictor: float32 against float64 at the float32 contract.
    import jax.numpy as jnp
    from tabcorr_tpu.predictor import make_multi_predictor, params_batch
    for model in (tt.Leauthaud11Model(threshold=10.5,
                                      redshift=wp_tabcorr.attrs["redshift"]),
                  tt.ZuMandelbaum15Model(threshold=10.5,
                                         prim_haloprop_key="halo_mvir")):
        f_b = make_multi_predictor([wp_tabcorr], model)
        f_x = make_multi_predictor([wp_tabcorr], model, dtype=jnp.float64)
        params = params_batch(model, {}, (8,), dtype=jnp.float32)
        [(ng_b, xi_b)] = f_b(params)
        [(ng_x, xi_x)] = f_x({k: jnp.asarray(v, jnp.float64)
                              for k, v in params.items()})
        np.testing.assert_allclose(np.asarray(ng_b), np.asarray(ng_x),
                                   rtol=2e-5)
        np.testing.assert_allclose(
            np.asarray(xi_b), np.asarray(xi_x), rtol=1e-4,
            atol=2e-6 * float(np.max(np.abs(np.asarray(xi_x)))))


def test_upper_incomplete_gamma_against_recurrence_free_points():
    # Gamma(a, x) for a straddling zero (the Cacciato09 satellite slope
    # regime) vs mpmath where available, else scipy-derived identities.
    from tabcorr_tpu.utils.special import upper_incomplete_gamma
    mpmath = pytest.importorskip("mpmath")
    worst = 0.0
    for a in [-0.95, -0.5, -0.25, -0.05, -1e-4, -1e-6, 0.0, 1e-6,
              1e-4, 0.05, 0.5, 1.0, 1.4]:
        for x in [1e-6, 1e-3, 0.1, 0.7, 2.0, 10.0, 50.0]:
            got = float(upper_incomplete_gamma(np.float64(a),
                                               np.float64(x)))
            want = float(mpmath.gammainc(a, x, mpmath.inf))
            worst = max(worst, abs(got - want) / abs(want))
    assert worst < 1e-7


def test_upper_incomplete_gamma_vectorized_and_jax():
    # One array call straddling the a = 0 blend matches elementwise host
    # evaluation, on both backends and under grad.
    import jax
    import jax.numpy as jnp
    from tabcorr_tpu.utils.special import upper_incomplete_gamma
    a = np.array([-0.6, -0.1, -1e-6, 0.0, 1e-6, 0.3, 1.2])
    x = np.array([0.5, 2.0, 0.1, 0.7, 5.0, 1e-3, 20.0])
    host = upper_incomplete_gamma(a, x)
    np.testing.assert_allclose(
        host, [float(upper_incomplete_gamma(ai, xi))
               for ai, xi in zip(a, x)], rtol=1e-13)
    dev = jax.jit(upper_incomplete_gamma)(jnp.asarray(a), jnp.asarray(x))
    # jax's gammaincc and scipy's agree to ~1e-9 relative in float64
    # (different continued-fraction/series cutovers), not to ulp.
    np.testing.assert_allclose(np.asarray(dev), host, rtol=1e-8)
    # d/dx Gamma(a, x) = -x^(a-1) e^-x, exactly known.
    g = jax.grad(lambda xx: upper_incomplete_gamma(jnp.float64(-0.3),
                                                   xx))(jnp.float64(1.7))
    np.testing.assert_allclose(float(g), -1.7 ** (-1.3) * np.exp(-1.7),
                               rtol=1e-10)


def test_cacciato09_median_luminosity_form():
    from tabcorr_tpu.models import cacciato09_median_log_luminosity
    from tabcorr_tpu.models.cacciato09 import CACCIATO09_PARAMS
    p = dict(CACCIATO09_PARAMS)
    logm = np.linspace(10.0, 15.5, 23)
    ratio = 10.0 ** (logm - p["log_M_1"])
    want = np.log10(10.0 ** p["log_L_0"] * ratio ** p["gamma_1"] /
                    (1.0 + ratio) ** (p["gamma_1"] - p["gamma_2"]))
    np.testing.assert_allclose(
        cacciato09_median_log_luminosity(p, logm), want, rtol=1e-12)


def test_cacciato09_centrals_half_at_median_crossing():
    from tabcorr_tpu.models import (cacciato09_centrals,
                                    cacciato09_median_log_luminosity)
    from tabcorr_tpu.models.cacciato09 import CACCIATO09_PARAMS
    from scipy.optimize import brentq
    p = dict(CACCIATO09_PARAMS)
    thr = 9.8
    log_mh_t = brentq(
        lambda lm: float(cacciato09_median_log_luminosity(p, lm)) - thr,
        10.0, 16.0)
    np.testing.assert_allclose(
        float(cacciato09_centrals(p, np.float64(log_mh_t), thr)), 0.5,
        rtol=1e-9)
    nc = cacciato09_centrals(p, np.linspace(10.5, 15.5, 41), thr)
    assert np.all(np.diff(nc) >= 0) and nc[-1] <= 1.0


def test_cacciato09_satellites_vs_clf_quadrature():
    # The analytic incomplete-gamma form vs brute-force integration of
    # the modified-Schechter CLF above the threshold, including the
    # delta != 1 (More et al. 2013 extension) mode.
    from scipy.integrate import quad
    from tabcorr_tpu.models import (cacciato09_median_log_luminosity,
                                    cacciato09_satellites)
    from tabcorr_tpu.models.cacciato09 import CACCIATO09_PARAMS
    ln10 = np.log(10.0)
    thr = 9.5

    def oracle(p, log_mh):
        lc = 10.0 ** float(cacciato09_median_log_luminosity(
            p, np.float64(log_mh)))
        ls = 0.562 * lc
        alpha = -2.0 + p["a_1"] * (1 - 2 / np.pi * np.arctan(
            p["a_2"] * (log_mh - p["log_M_2"])))
        m12 = log_mh - 12.0
        phistar = 10.0 ** (p["b_0"] + p["b_1"] * m12 + p["b_2"] * m12 ** 2)
        delta = 10.0 ** (p["delta_1"] + p["delta_2"] * m12)

        def integrand(log_lum):
            r = 10.0 ** log_lum / ls
            return phistar * r ** (alpha + 1.0) * np.exp(
                -delta * r * r) * ln10

        return quad(integrand, thr, thr + 8.0, limit=800)[0]

    for p in [dict(CACCIATO09_PARAMS),
              dict(CACCIATO09_PARAMS, delta_1=0.2, delta_2=0.1)]:
        for log_mh in [11.8, 12.5, 13.0, 14.0, 15.0]:
            got = float(cacciato09_satellites(p, np.float64(log_mh), thr))
            np.testing.assert_allclose(got, oracle(p, log_mh), rtol=1e-9)


def test_cacciato09_gradients_flow_through_incomplete_gamma():
    import jax
    import jax.numpy as jnp
    from tabcorr_tpu.models.cacciato09 import (CACCIATO09_PARAMS,
                                               cacciato09_satellites)
    params = {k: jnp.float64(v) for k, v in CACCIATO09_PARAMS.items()}
    log_mh = jnp.asarray(13.2, dtype=jnp.float64)

    def nsat_of(p):
        return cacciato09_satellites(p, log_mh, 9.5)

    grads = jax.grad(nsat_of)(params)
    # a_1/a_2/log_M_2 reach the result only through the incomplete
    # gamma's FIRST argument (XLA's igamma_grad_a path).
    for key in ["a_1", "a_2", "log_M_2", "b_0", "b_1", "log_L_0",
                "gamma_1", "delta_1"]:
        eps = max(abs(float(params[key])), 1.0) * 1e-6
        p_hi, p_lo = dict(params), dict(params)
        p_hi[key] = params[key] + eps
        p_lo[key] = params[key] - eps
        fd = (nsat_of(p_hi) - nsat_of(p_lo)) / (2 * eps)
        np.testing.assert_allclose(grads[key], fd, rtol=1e-4, err_msg=key)
        assert abs(float(grads[key])) > 0


def test_cacciato09_float32_device_path_accuracy():
    # Kernel-arithmetic error of the float32 device path vs the float64
    # host oracle evaluated AT the float32-rounded inputs (isolates
    # kernel error from parameter quantization).  The CLF's small
    # central scatter (sigma = 0.143) and the incomplete gamma's
    # argument sensitivity make this family's float32 contract looser
    # than zheng07's: measured 2.3e-5 (cen) / 1.6e-4 (sat, cutoff
    # region) — asserted with 2x headroom.
    import jax
    import jax.numpy as jnp
    from tabcorr_tpu.models.cacciato09 import (CACCIATO09_PARAMS,
                                               cacciato09_centrals,
                                               cacciato09_satellites)
    pq = {k: float(np.float32(v)) for k, v in CACCIATO09_PARAMS.items()}
    logm = np.linspace(10.8, 15.5, 200)
    lmq = np.float64(np.float32(logm))
    thrq = float(np.float32(9.5))
    cen64 = cacciato09_centrals(pq, lmq, thrq)
    sat64 = cacciato09_satellites(pq, lmq, thrq)
    p32 = {k: jnp.float32(v) for k, v in CACCIATO09_PARAMS.items()}
    l32 = jnp.asarray(logm, dtype=jnp.float32)
    cen32 = np.asarray(jax.jit(
        lambda l: cacciato09_centrals(p32, l, 9.5))(l32), np.float64)
    sat32 = np.asarray(jax.jit(
        lambda l: cacciato09_satellites(p32, l, 9.5))(l32), np.float64)
    m = cen64 > 1e-6
    assert np.max(np.abs(cen32[m] - cen64[m]) / cen64[m]) < 5e-5
    m = sat64 > 1e-6
    assert np.max(np.abs(sat32[m] - sat64[m]) / sat64[m]) < 4e-4


def test_cacciato09_predict_through_table(wp_tabcorr):
    model = tt.Cacciato09Model(threshold=9.5,
                               prim_haloprop_key="halo_mvir")
    ngal, xi = wp_tabcorr.predict(model, check_consistency=False)
    assert ngal > 0 and np.all(np.isfinite(xi))
    model2 = tt.Cacciato09Model(threshold=9.5,
                                prim_haloprop_key="halo_mvir",
                                log_M_1=11.4)
    ngal2, _ = wp_tabcorr.predict(model2, check_consistency=False)
    assert ngal2 != ngal


def test_cacciato09_vectorized_predictor_matches_host(wp_tabcorr):
    import jax.numpy as jnp
    model = tt.Cacciato09Model(threshold=9.5,
                               prim_haloprop_key="halo_mvir")
    ngal_h, xi_h = wp_tabcorr.predict(model, check_consistency=False)
    pred = wp_tabcorr.make_predictor(model, vectorized=True,
                                     dtype=jnp.float64)
    batch = {k: np.full(3, v) for k, v in model.param_dict.items()}
    batch["log_M_1"][1] = 11.4
    ngal, xi = pred(batch)
    np.testing.assert_allclose(float(ngal[0]), ngal_h, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(xi)[0], xi_h, rtol=1e-9)
    assert float(ngal[1]) != float(ngal[0])


def test_cacciato09_float32_multi_predictor_matches_float64(wp_tabcorr):
    # The CLF family through the joint predictor: float32 against
    # float64 at the family's float32 contract (looser than zheng07's
    # in the satellite cutoff region — see
    # test_cacciato09_float32_device_path_accuracy).
    import jax.numpy as jnp
    from tabcorr_tpu.predictor import make_multi_predictor, params_batch

    model = tt.Cacciato09Model(threshold=9.5,
                               prim_haloprop_key="halo_mvir")
    f_b = make_multi_predictor([wp_tabcorr], model)
    f_x = make_multi_predictor([wp_tabcorr], model, dtype=jnp.float64)
    params = params_batch(
        model, {"log_M_1": model.param_dict["log_M_1"] +
                0.1 * np.random.default_rng(0).normal(size=8)},
        (8,), dtype=jnp.float32)
    [(ng_b, xi_b)] = f_b(params)
    [(ng_x, xi_x)] = f_x({k: jnp.asarray(v, jnp.float64)
                          for k, v in params.items()})
    np.testing.assert_allclose(np.asarray(ng_b), np.asarray(ng_x),
                               rtol=5e-4)
    np.testing.assert_allclose(
        np.asarray(xi_b), np.asarray(xi_x), rtol=5e-4,
        atol=1e-5 * float(np.max(np.abs(np.asarray(xi_x)))))


def test_cacciato09_through_interpolator(ds_interpolator):
    # Grid parameters (log_eta) come from param_dict while the
    # occupations come from the CLF; the Interpolator is model-agnostic.
    import jax.numpy as jnp
    from tabcorr_tpu.predictor import make_predictor, params_batch
    model = tt.Cacciato09Model(
        threshold=9.5, redshift=0.5, prim_haloprop_key="halo_m258m",
        sec_haloprop_key="halo_nfw_conc")
    model.param_dict["log_eta"] = 0.05
    ngal_h, ds_h = ds_interpolator.predict(model, check_consistency=False)
    assert ngal_h > 0 and np.all(np.isfinite(ds_h))

    pred = make_predictor(ds_interpolator, model, dtype=jnp.float64)
    params = params_batch(model, {"log_eta": np.array([0.05, 0.15])},
                          (2,), dtype=jnp.float64)
    ngal, ds = pred(params)
    np.testing.assert_allclose(float(ngal[0]), ngal_h, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(ds)[0], ds_h, rtol=1e-9)
    assert not np.allclose(np.asarray(ds)[1], ds_h)


def test_assembias_cacciato09_mean_preservation():
    from tabcorr_tpu.models import AssembiasCacciato09Model
    model = AssembiasCacciato09Model(threshold=9.5)
    model.param_dict["mean_occupation_centrals_assembias_param1"] = 0.6
    model.param_dict["mean_occupation_satellites_assembias_param1"] = -0.3
    mass = 10 ** np.linspace(11.5, 15.0, 32)
    base_model = tt.Cacciato09Model(threshold=9.5)
    for name in ["mean_occupation_centrals", "mean_occupation_satellites"]:
        fn = getattr(model, name)
        lo = fn(prim_haloprop=mass,
                sec_haloprop_percentile=np.full_like(mass, 0.25))
        hi = fn(prim_haloprop=mass,
                sec_haloprop_percentile=np.full_like(mass, 0.75))
        base = getattr(base_model, name)(prim_haloprop=mass)
        np.testing.assert_allclose(0.5 * (lo + hi), base, rtol=1e-9)
        assert np.any(np.abs(hi - lo) > 1e-6)
