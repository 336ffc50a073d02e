"""The float32 device predictor against the float64 host path.

One engine serves every table: XLA's occupation quadrature followed by
the quadratic (auto) or linear (cross) contraction at
``Precision.HIGHEST``.  These cases pin its accuracy contract
(BASELINE.json: wp < 1e-6 relative per element; stacked statistics
< 1e-6 of their largest element) over the shapes users load — the wp
(60 bins), xi_ell (120 bins) and Delta Sigma (cross) tables, random
binnings, batches that divide nothing, Interpolator grids with NaN
outside the grid, a dp mesh of 8 virtual devices — and its gradient
against finite differences of the float64 path.  Host references are
taken at the float32 parameter values the device received.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tabcorr_tpu as tt
from tabcorr_tpu.predictor import (make_multi_predictor, make_predictor,
                                   params_batch)
from tabcorr_tpu.synthetic import build_interpolator, synthetic_tabcorr

EXAMPLES = Path(__file__).absolute().parent / "data" / "examples"
TOL = 1e-6


def _table(name):
    return {"wp": lambda: tt.TabCorr.read(EXAMPLES / "bolplanck_wp.npz"),
            "xi": lambda: tt.TabCorr.read(EXAMPLES /
                                          "synthetic_xi_ell.npz"),
            "ds": lambda: tt.TabCorr.read(EXAMPLES / "bolplanck_ds.hdf5"),
            }[name]()


def _bol_model():
    return tt.Zheng07Model(threshold=-18, redshift=-0.0023)


def _hod_batch(model, batch, seed):
    rng = np.random.default_rng(seed)
    spread = {"logMmin": 0.1, "sigma_logM": 0.01, "logM1": 0.1,
              "alpha": 0.02}
    return params_batch(model, {
        k: model.param_dict[k] + s * rng.normal(size=batch)
        for k, s in spread.items()}, (batch,), dtype=jnp.float32)


def _host(obj, make_model, params, i):
    model = make_model()
    for key, value in params.items():
        model.param_dict[key] = float(np.float32(value[i]))
    return obj.predict(model, check_consistency=False)


def _scaled(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64).ravel() -
                               np.ravel(want))) / np.max(np.abs(want)))


def _check(obj, make_model, params, ngal, xi, probes, relative):
    for i in probes:
        ng_h, xi_h = _host(obj, make_model, params, i)
        assert abs(float(ngal[i]) / ng_h - 1) < TOL, i
        if relative:
            rel = np.max(np.abs(np.asarray(xi[i], np.float64).ravel() /
                                np.ravel(xi_h) - 1))
            assert rel < TOL, (i, rel)
        else:
            assert _scaled(xi[i], xi_h) < TOL, i


@pytest.mark.parametrize("batch", [1, 13, 64])
@pytest.mark.parametrize("name", ["wp", "xi", "ds"])
def test_tabcorr_matches_host(name, batch):
    tab = _table(name)
    params = _hod_batch(_bol_model(), batch, seed=batch)
    ngal, xi = make_predictor(tab, _bol_model())(params)
    assert ngal.shape == (batch,)
    assert xi.shape == (batch,) + tuple(tab.tpcf_shape)
    assert xi.dtype == jnp.float32
    _check(tab, _bol_model, params, ngal, xi, {0, batch // 2, batch - 1},
           relative=name == "wp")


@pytest.mark.parametrize("names", [("wp", "xi"), ("wp", "ds"),
                                   ("xi", "ds"), ("wp", "xi", "ds")])
def test_multi_predictor_matches_host(names):
    tabs = [_table(n) for n in names]
    params = _hod_batch(_bol_model(), 9, seed=3)
    out = make_multi_predictor(tabs, _bol_model())(params)
    assert len(out) == len(tabs)
    for tab, name, (ngal, xi) in zip(tabs, names, out):
        _check(tab, _bol_model, params, ngal, xi, (0, 8),
               relative=name == "wp")


def test_multi_predictor_mixes_tables_and_interpolators(ds_interpolator,
                                                        model):
    wp_tab = _table("wp")

    def make():
        m = tt.Zheng07Model(threshold=-21, redshift=0.5,
                            prim_haloprop_key="halo_m258m")
        m.param_dict.update(log_eta=0.1, alpha_s=1.0, alpha_c=0.0)
        return m

    params = params_batch(make(), {}, (3,), dtype=jnp.float32)
    [(ng_w, wp), (ng_d, ds)] = make_multi_predictor(
        [wp_tab, ds_interpolator], make())(params)
    _check(wp_tab, make, params, ng_w, wp, (0,), relative=True)
    _check(ds_interpolator, make, params, ng_d, ds, (2,), relative=False)


@pytest.mark.parametrize("seed", range(6))
def test_random_shapes_match_host(seed):
    # Random halo binnings, statistic counts and modes, with row
    # amplitudes spanning ~6 decades: the shapes the fixed fixtures
    # never hit.
    rng = np.random.default_rng(seed)
    tab = synthetic_tabcorr(rng, int(rng.integers(3, 40)),
                            int(rng.integers(1, 3)),
                            int(rng.integers(1, 48)),
                            ("auto", "cross")[seed % 2])

    def make():
        return tt.Zheng07Model(threshold=-20, redshift=0.0)

    params = _hod_batch(make(), 7, seed=seed + 10)
    ngal, xi = make_predictor(tab, make())(params)
    _check(tab, make, params, ngal, xi, (0, 6), relative=False)


def _grid_model():
    model = tt.Zheng07Model(threshold=-20, redshift=0.0)
    model.param_dict.update(alpha_c=0.2, alpha_s=1.0, log_eta=0.0)
    return model


@pytest.fixture(scope="module")
def small_grid():
    """The published 4 x 4 x 4 grid geometry with small tables."""
    return build_interpolator(n_nodes=64, n_prim=6, n_xi=9)


@pytest.mark.parametrize("axis", ["alpha_c", "alpha_s", "log_eta"])
def test_grid_matches_host_along_each_axis(small_grid, axis):
    lo, hi = {"alpha_c": (0.0, 0.4), "alpha_s": (0.8, 1.2),
              "log_eta": (-0.4, 0.4)}[axis]
    values = np.linspace(lo + 0.01, hi - 0.01, 5)
    params = params_batch(_grid_model(), {axis: values}, (5,),
                          dtype=jnp.float32)
    ngal, xi = make_predictor(small_grid, _grid_model())(params)
    assert xi.shape == (5, 3, 3)
    _check(small_grid, _grid_model, params, ngal, xi, range(5),
           relative=False)


@pytest.mark.parametrize("axis", ["alpha_c", "alpha_s", "log_eta"])
def test_grid_nan_outside_grid(small_grid, axis):
    # extrapolate=False poisons ngal and xi of out-of-grid samples only
    # (the reference raises there: tabcorr/interpolator.py:322-327).
    outside = {"alpha_c": 0.5, "alpha_s": 1.3, "log_eta": -0.6}[axis]
    params = params_batch(
        _grid_model(), {axis: np.array(
            [_grid_model().param_dict[axis], outside,
             _grid_model().param_dict[axis]], np.float32)}, (3,),
        dtype=jnp.float32)
    ngal, xi = make_predictor(small_grid, _grid_model())(params)
    ngal, xi = np.asarray(ngal), np.asarray(xi).reshape(3, -1)
    assert np.isnan(ngal[1]) and np.all(np.isnan(xi[1]))
    assert np.all(np.isfinite(ngal[[0, 2]]))
    assert np.all(np.isfinite(xi[[0, 2]]))
    with pytest.raises(ValueError):
        model = _grid_model()
        model.param_dict[axis] = outside
        small_grid.predict(model, check_consistency=False)


def test_grid_extrapolate_true_stays_finite(small_grid):
    params = params_batch(_grid_model(), {"log_eta": np.array(
        [-0.6, 0.0, 0.6], np.float32)}, (3,), dtype=jnp.float32)
    ngal, xi = make_predictor(small_grid, _grid_model(),
                              extrapolate=True)(params)
    assert np.all(np.isfinite(np.asarray(xi)))
    model = _grid_model()
    model.param_dict["log_eta"] = float(np.float32(0.6))
    _, xi_h = small_grid.predict(model, check_consistency=False,
                                 extrapolate=True)
    assert _scaled(xi[2], xi_h) < TOL


def test_published_ds_interpolator_matches_host(ds_interpolator):
    def make():
        m = tt.Zheng07Model(threshold=-21, redshift=0.5,
                            prim_haloprop_key="halo_m258m")
        m.param_dict.update(log_eta=0.0, alpha_s=1.0, alpha_c=0.0)
        return m

    rng = np.random.default_rng(13)
    params = params_batch(make(), {
        "logMmin": make().param_dict["logMmin"] + 0.1 * rng.normal(size=6),
        "log_eta": rng.uniform(-0.45, 0.45, 6)}, (6,), dtype=jnp.float32)
    ngal, ds = make_predictor(ds_interpolator, make())(params)
    _check(ds_interpolator, make, params, ngal, ds, range(6),
           relative=False)


def _dp_mesh():
    from tabcorr_tpu.parallel import make_mesh
    return make_mesh(8)


@pytest.mark.parametrize("case", ["wp", "wp+xi", "wp+ds", "grid",
                                  "ds_interp"])
def test_dp_mesh_matches_unsharded(case, small_grid, ds_interpolator):
    if case.startswith("wp"):
        objs = [_table(name) for name in case.split("+")]
        model = _bol_model()
        params = _hod_batch(model, 16, seed=4)
    else:
        objs = [small_grid if case == "grid" else ds_interpolator]
        model = _grid_model() if case == "grid" else tt.Zheng07Model(
            threshold=-21, redshift=0.5, prim_haloprop_key="halo_m258m")
        model.param_dict.update(log_eta=0.0, alpha_s=1.0,
                                alpha_c=model.param_dict.get("alpha_c",
                                                             0.0))
        params = params_batch(model, {"log_eta": np.linspace(
            -0.3, 0.3, 16)}, (16,), dtype=jnp.float32)
    mesh = _dp_mesh()
    plain = make_multi_predictor(objs, model)(params)
    sharded = make_multi_predictor(objs, model, mesh=mesh)(params)
    for (ng_p, xi_p), (ng_s, xi_s) in zip(plain, sharded):
        assert len(xi_s.sharding.device_set) == 8
        np.testing.assert_allclose(np.asarray(ng_s), np.asarray(ng_p),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            np.asarray(xi_s), np.asarray(xi_p), rtol=1e-5,
            atol=1e-6 * float(np.max(np.abs(np.asarray(xi_p)))))


def test_dp_mesh_hot_loop_is_collective_free():
    # Batch-sharded prediction replicates the tables: the compiled
    # program must hold no cross-device collective.
    f = make_multi_predictor([_table("wp"), _table("ds")], _bol_model(),
                             mesh=_dp_mesh())
    params = _hod_batch(_bol_model(), 64, seed=5)
    hlo = f.lower(params).compile().as_text()
    for op in ("all-reduce", "all-gather", "all-to-all",
               "collective-permute", "reduce-scatter",
               "collective-broadcast"):
        assert op not in hlo, op


def test_mesh_needs_vectorized_jitted_predictor():
    with pytest.raises(ValueError):
        make_predictor(_table("wp"), _bol_model(), vectorized=False,
                       mesh=_dp_mesh())
    with pytest.raises(ValueError):
        make_multi_predictor([_table("wp")], _bol_model(), jit=False,
                             mesh=_dp_mesh())


@pytest.mark.parametrize("name,key", [("wp", "logMmin"), ("wp", "alpha"),
                                      ("xi", "logM1"), ("ds", "sigma_logM"),
                                      ("grid", "log_eta"),
                                      ("grid", "alpha_c")])
def test_gradient_matches_finite_difference(name, key, small_grid):
    # jax.grad of the float32 device predictor against a central
    # difference of the float64 host path.
    if name == "grid":
        obj, make = small_grid, _grid_model
    else:
        obj, make = _table(name), _bol_model
    rng = np.random.default_rng(0)
    shape = tuple(obj.tabcorr_list[0].tpcf_shape if name == "grid"
                  else obj.tpcf_shape)
    weights = rng.uniform(0.5, 1.5, shape)
    predict = make_predictor(obj, make(), vectorized=False)
    base = {k: jnp.float32(v) for k, v in make().param_dict.items()}

    def functional(x):
        _, xi = predict({**base, key: x})
        return jnp.sum(xi * weights)

    x0 = float(base[key])
    grad = float(jax.grad(functional)(jnp.float32(x0)))

    def host(x):
        model = make()
        model.param_dict[key] = x
        return float(np.sum(obj.predict(model, check_consistency=False)[1]
                            * weights))

    h = 1e-4 * max(1.0, abs(x0))
    fd = (host(x0 + h) - host(x0 - h)) / (2 * h)
    scale = abs(host(x0)) / max(1.0, abs(x0))
    assert abs(grad - fd) < 1e-3 * max(abs(fd), 1e-3 * scale), (grad, fd)


@pytest.mark.parametrize("name", ["wp", "xi", "ds"])
def test_separate_gal_type_sums_to_total(name):
    tab = _table(name)
    params = _hod_batch(_bol_model(), 4, seed=8)
    ngal, xi = make_predictor(tab, _bol_model())(params)
    ngal_d, xi_d = make_predictor(tab, _bol_model(),
                                  separate_gal_type=True)(params)
    np.testing.assert_allclose(sum(np.asarray(v) for v in ngal_d.values()),
                               np.asarray(ngal), rtol=1e-6)
    total = sum(np.asarray(v) for v in xi_d.values())
    np.testing.assert_allclose(
        total.reshape(np.asarray(xi).shape), np.asarray(xi), rtol=1e-4,
        atol=1e-6 * float(np.max(np.abs(np.asarray(xi)))))
