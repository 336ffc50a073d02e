"""Sharded prediction and batched predictor tests (8 virtual CPU devices)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tabcorr_tpu as tt
from tabcorr_tpu.parallel import (make_mesh, make_sharded_predict,
                                  shard_params, shard_table_data)
from tabcorr_tpu.predictor import (make_predictor, occupation_functions,
                                   params_batch)


def _batch(model, B, seed=0, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    return params_batch(
        model,
        {"logM1": model.param_dict["logM1"] + 0.1 * rng.normal(size=B),
         "logMmin": model.param_dict["logMmin"] + 0.1 * rng.normal(size=B)},
        (B,), dtype=dtype)


def test_make_predictor_matches_host(wp_tabcorr, bol_model):
    f = make_predictor(wp_tabcorr, bol_model, dtype=jnp.float64)
    B = 8
    params = _batch(bol_model, B)
    ngal, xi = f(params)
    for i in [0, 5]:
        m = tt.Zheng07Model(threshold=-18,
                            redshift=wp_tabcorr.attrs["redshift"])
        for k in ("logM1", "logMmin"):
            m.param_dict[k] = float(params[k][i])
        ngal_i, xi_i = wp_tabcorr.predict(m, check_consistency=False)
        assert np.isclose(float(ngal[i]), ngal_i, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(xi[i]), xi_i, rtol=1e-12)


def test_interpolator_predictor_matches_host(ds_interpolator, model):
    f = make_predictor(ds_interpolator, model, dtype=jnp.float64)
    model.param_dict["log_eta"] = 0.07
    params = params_batch(model, {}, (4,), dtype=jnp.float64)
    ngal, xi = f(params)
    ngal_host, xi_host = ds_interpolator.predict(model)
    assert np.isclose(float(ngal[0]), ngal_host, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(xi[0]), xi_host, rtol=1e-10)


def test_interpolator_predictor_separate(ds_interpolator, model):
    f = make_predictor(ds_interpolator, model, dtype=jnp.float64,
                       separate_gal_type=True)
    model.param_dict["log_eta"] = -0.1
    params = params_batch(model, {}, (2,), dtype=jnp.float64)
    ngal, xi = f(params)
    ngal_host, xi_host = ds_interpolator.predict(model,
                                                 separate_gal_type=True)
    for key in ngal_host:
        assert np.isclose(float(ngal[key][0]), ngal_host[key], rtol=1e-10)
    for key in xi_host:
        np.testing.assert_allclose(np.asarray(xi[key][0]),
                                   xi_host[key], rtol=1e-10)


@pytest.mark.parametrize("table_parallel", [1, 2, 4])
@pytest.mark.parametrize("fixture", ["wp_tabcorr", "ds_tabcorr"])
def test_sharded_predict_matches_plain(fixture, bol_model, table_parallel,
                                       request):
    halotab = request.getfixturevalue(fixture)
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(8, table_parallel=table_parallel)
    table = halotab.table_data(dtype=jnp.float64)
    occ_c, occ_s = occupation_functions(bol_model)
    f_sharded, _ = make_sharded_predict(mesh, table, occ_c, occ_s)

    B = 16
    params = _batch(bol_model, B)
    f_plain = make_predictor(halotab, bol_model, dtype=jnp.float64)
    ngal_p, xi_p = f_plain(params)
    ngal_s, xi_s = f_sharded(shard_params(params, mesh))
    np.testing.assert_allclose(np.asarray(ngal_s), np.asarray(ngal_p),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(xi_s), np.asarray(xi_p),
                               rtol=1e-12)


def test_sharded_ensemble_step_matches_plain(wp_tabcorr, bol_model):
    # Full multi-device MCMC hot loop: stretch-move ensemble with the
    # vectorized Gaussian log posterior evaluated through the dp-sharded
    # joint predictor.  The sharded chain must match the single-device
    # chain.
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from tabcorr_tpu.mcmc import ensemble_step, make_gaussian_logpost_batched
    from tabcorr_tpu.predictor import make_multi_predictor

    mesh = make_mesh(8, table_parallel=1)
    names = ("logMmin", "logM1")
    base = {k: jnp.float32(v) for k, v in bol_model.param_dict.items()}
    _, data = wp_tabcorr.predict(bol_model, check_consistency=False)
    inv_cov = np.diag(1.0 / (0.05 * np.abs(data.ravel()) + 1e-3) ** 2)

    chains = {}
    for key, mesh_arg in (("plain", None), ("sharded", mesh)):
        f = make_multi_predictor([wp_tabcorr], bol_model, mesh=mesh_arg)
        log_prob = make_gaussian_logpost_batched(
            f, names, base, [data.ravel()], [inv_cov])
        rng = np.random.default_rng(11)
        walkers = jnp.asarray(
            np.array([bol_model.param_dict[k] for k in names])[None, :]
            + 0.02 * rng.normal(size=(32, 2)), dtype=jnp.float32)
        lp = log_prob(walkers)
        for step in range(3):
            walkers, lp, acc = ensemble_step(
                jax.random.key(step), walkers, lp, log_prob,
                vectorized=True)
        chains[key] = (np.asarray(walkers), np.asarray(lp))

    np.testing.assert_allclose(chains["sharded"][0], chains["plain"][0],
                               rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(chains["sharded"][1], chains["plain"][1],
                               rtol=1e-4, atol=1e-3)


def test_shard_table_padding(wp_tabcorr):
    table = wp_tabcorr.table_data(dtype=jnp.float64)
    padded = shard_table_data(table, 7)
    assert padded.n_bins % 7 == 0
    # Padding bins are inert: n_h == 0.
    assert float(jnp.sum(padded.n_h[table.n_bins:])) == 0.0


def test_mesh_validation():
    with pytest.raises(ValueError):
        make_mesh(8, table_parallel=3)


def test_sharded_pair_counting_matches_plain():
    from jax.sharding import Mesh
    from tabcorr_tpu.ops.paircount import labeled_pair_count

    rng = np.random.default_rng(0)
    L, N = 50.0, 2500
    pos = rng.uniform(0, L, (N, 3))
    labels = rng.integers(0, 4, N).astype(np.int32)
    rp_bins = np.logspace(-0.5, 1.2, 6)
    mesh = Mesh(np.array(jax.devices()), ("shard",))

    # strategy pinned: this test asserts the MESH path equals the plain
    # path of the same (device-sweep) engine; 'auto' on CPU would route
    # the plain side to the native f64 counter, whose more accurate pair
    # classification legitimately differs on f32-edge pairs.
    plain = labeled_pair_count(pos, labels, 4, period=L, kind="rppi",
                               r_edges=rp_bins, pi_max=10.0,
                               strategy="scatter")
    sharded = labeled_pair_count(pos, labels, 4, period=L, kind="rppi",
                                 r_edges=rp_bins, pi_max=10.0, mesh=mesh)
    np.testing.assert_array_equal(sharded, plain)

    ptcl = rng.uniform(0, L, (4000, 3))
    weights = rng.uniform(0.5, 2.0, 4000)
    plain_w = labeled_pair_count(pos, labels, 4, pos2=ptcl,
                                 weights2=weights, period=L, kind="proj",
                                 r_edges=rp_bins, strategy="scatter")
    sharded_w = labeled_pair_count(pos, labels, 4, pos2=ptcl,
                                   weights2=weights, period=L, kind="proj",
                                   r_edges=rp_bins, mesh=mesh)
    # float32 accumulation order differs across shards.
    np.testing.assert_allclose(sharded_w, plain_w, rtol=5e-4)

    # dual-channel (delta-sigma) sweep through the mesh path: the
    # doubled histogram must shard identically to the single channels.
    plain_b = labeled_pair_count(pos, labels, 4, pos2=ptcl,
                                 weights2=weights, period=L, kind="proj",
                                 r_edges=rp_bins, strategy="scatter",
                                 pair_weight="unit+log_rp")
    sharded_b = labeled_pair_count(pos, labels, 4, pos2=ptcl,
                                   weights2=weights, period=L,
                                   kind="proj", r_edges=rp_bins,
                                   pair_weight="unit+log_rp", mesh=mesh)
    np.testing.assert_allclose(sharded_b, plain_b, rtol=5e-4)


def test_sharded_sweep_dispatch_structure(monkeypatch):
    # The mesh path must batch SWEEP_BLOCK i-chunks per device dispatch
    # (one call per block, like the single-chip path — not one per
    # i-chunk) and activate per-device z-windows: each shard's hull must
    # cover only its local chunks within the line-of-sight cut.
    from jax.sharding import Mesh
    import tabcorr_tpu.ops.paircount as pc

    rng = np.random.default_rng(3)
    L, N = 100.0, pc.CHUNK * 32          # 32 i-chunks -> 2 blocks
    pos = rng.uniform(0, L, (N, 3))
    labels = np.zeros(N, dtype=np.int32)
    rp_bins = np.array([0.5, 2.0])
    mesh = Mesh(np.array(jax.devices()), ("shard",))

    calls = []
    orig = pc._sweep_block_sharded

    def counting(*args, **kw):
        calls.append(kw.get("n_block"))
        return orig(*args, **kw)

    monkeypatch.setattr(pc, "_sweep_block_sharded", counting)
    counts = pc.labeled_pair_count(pos, labels, 1, period=L, kind="rppi",
                                   r_edges=rp_bins, pi_max=4.0, mesh=mesh)
    n_blocks = -(-32 // pc.SWEEP_BLOCK)
    assert len(calls) == n_blocks
    plain = pc.labeled_pair_count(pos, labels, 1, period=L, kind="rppi",
                                  r_edges=rp_bins, pi_max=4.0,
                                  strategy="scatter")
    np.testing.assert_array_equal(counts, plain)

    # Windows really engage: with pi_max << L each device's hull must be
    # far smaller than its full chunk range for interior i-chunks.
    z = np.sort(pos[:, 2].astype(np.float32))
    n_shards = len(jax.devices())
    starts, cnts = pc._chunk_windows(
        z, z, 4.0, L, n_shards=n_shards)
    cps = 32 // n_shards
    assert cnts.max() <= cps
    assert cnts.sum() < 0.7 * cnts.size * cps


def test_sharded_tabulate_matches_plain():
    from jax.sharding import Mesh
    from test_tabulate import synthetic_halocat

    halocat = synthetic_halocat(n_halos=500)
    rp_bins = np.logspace(-0.3, 1.0, 4)
    kwargs = dict(mode="auto", prim_haloprop_bins=4,
                  Num_ptcl_requirement=300, sats_per_prim_haloprop=1e-12,
                  seed=23)
    tab_plain = tt.TabCorr.tabulate(halocat, tt.corrfunc.wp, rp_bins,
                                    10.0, **kwargs)
    mesh = Mesh(np.array(jax.devices()), ("shard",))
    tab_sharded = tt.TabCorr.tabulate(halocat, tt.corrfunc.wp, rp_bins,
                                      10.0, mesh=mesh, **kwargs)
    np.testing.assert_allclose(tab_sharded.tpcf_matrix,
                               tab_plain.tpcf_matrix, rtol=1e-6)


def test_interpolator_predictor_multi_axis(ds_interpolator, model):
    # Synthetic 2-axis (4 x 4) grid built from the fixture's tabulation:
    # exercises the multi-pass grid spline inside the jitted path.
    import copy
    from tabcorr_tpu.io import ColumnTable

    base = ds_interpolator.tabcorr_list[0]
    tabs, alphas, etas = [], [], []
    for a in np.linspace(0.9, 1.2, 4):
        for e in np.linspace(-0.3, 0.3, 4):
            tab = copy.deepcopy(base)
            tab.tpcf_matrix = base.tpcf_matrix * (1 + 0.1 * a + 0.05 * e**2)
            # Mutating tpcf_matrix invalidates the device-pytree cache.
            tab._table_data_cache = {}
            tabs.append(tab)
            alphas.append(a)
            etas.append(e)
    table = ColumnTable({"alpha_s": np.array(alphas),
                         "log_eta": np.array(etas)})
    interp = tt.Interpolator(tabs, table)

    model.param_dict["alpha_s"] = 1.07
    model.param_dict["log_eta"] = -0.12
    want = interp.predict(model, check_consistency=False)

    f = make_predictor(interp, model, dtype=jnp.float64)
    params = params_batch(model, {}, (2,), dtype=jnp.float64)
    ngal, xi = f(params)
    assert np.isclose(float(ngal[0]), want[0], rtol=1e-10)
    np.testing.assert_allclose(np.asarray(xi[0]), want[1], rtol=1e-10)


def test_extrapolate_false_yields_nan_outside_grid(ds_interpolator, model):
    # Reference semantics: out-of-range interpolation is rejected
    # (ValueError on the host path, tabcorr/interpolator.py:322-327); the
    # jitted path signals it with NaN instead of silently clamping.
    f = make_predictor(ds_interpolator, model, dtype=jnp.float64)
    lo, hi = ds_interpolator.xp[0][0], ds_interpolator.xp[0][-1]
    inside = 0.5 * (lo + hi)
    params = params_batch(
        model, {"log_eta": np.array([inside, hi + 0.5, lo - 0.5, hi])},
        (4,), dtype=jnp.float64)
    ngal, xi = f(params)
    assert np.isfinite(float(ngal[0])) and np.all(np.isfinite(xi[0]))
    assert np.isnan(float(ngal[1])) and np.all(np.isnan(xi[1]))
    assert np.isnan(float(ngal[2])) and np.all(np.isnan(xi[2]))
    # The grid edge itself is in range.
    assert np.isfinite(float(ngal[3]))

    # extrapolate=True restores edge-spline clamping.
    f_clamp = make_predictor(ds_interpolator, model, dtype=jnp.float64,
                             extrapolate=True)
    ngal_c, xi_c = f_clamp(params)
    assert np.all(np.isfinite(np.asarray(ngal_c)))
    assert np.all(np.isfinite(np.asarray(xi_c)))
    # Clamped values equal the edge value for a 1-axis grid evaluated
    # beyond the edge only in the spline sense; at the edge they agree.
    np.testing.assert_allclose(np.asarray(xi_c[0]), np.asarray(xi[0]),
                               rtol=1e-12)


def test_out_of_grid_logpost_is_minus_inf(ds_interpolator, model):
    from tabcorr_tpu.mcmc import make_gaussian_logpost

    f_one = make_predictor(ds_interpolator, model, dtype=jnp.float64,
                           vectorized=False, jit=False)
    base = {k: jnp.float64(v) for k, v in model.param_dict.items()}
    base["log_eta"] = jnp.float64(
        0.5 * (ds_interpolator.xp[0][0] + ds_interpolator.xp[0][-1]))
    _, xi_true = f_one(base)
    data = np.asarray(xi_true).ravel()
    inv_cov = np.eye(len(data))
    log_prob = make_gaussian_logpost(f_one, ("log_eta",), base, data,
                                     inv_cov)
    inside = np.asarray(log_prob(jnp.array([float(base["log_eta"])])))
    outside = np.asarray(log_prob(
        jnp.array([float(ds_interpolator.xp[0][-1]) + 1.0])))
    assert np.isfinite(inside)
    assert outside == -np.inf


def test_jitted_heterogeneous_binning_matches_host(ds_interpolator, model):
    # Nodes with DIFFERENT halo binnings (the reference's dedup machinery,
    # interpolator.py:63-70): the jitted path zero-pads to a common bin
    # count and must match the host path exactly.
    import copy
    from tabcorr_tpu.io import ColumnTable

    base = ds_interpolator.tabcorr_list[0]
    tabs, etas = [], []
    for i, e in enumerate(np.linspace(-0.3, 0.3, 4)):
        tab = copy.deepcopy(base)
        if i % 2 == 1:
            # Drop the last satellite bin -> a different gal_type table.
            keep = np.ones(tab.n_bins, dtype=bool)
            keep[-1] = False
            tab.gal_type = tab.gal_type[keep]
            tab.tpcf_matrix = tab.tpcf_matrix[:, keep]
        else:
            tab.tpcf_matrix = tab.tpcf_matrix * (1 + 0.02 * i)
        tabs.append(tab)
        etas.append(e)
    interp = tt.Interpolator(tabs, ColumnTable(
        {"log_eta": np.array(etas)}))
    assert len(interp.unique_gal_type_index) > 1

    model.param_dict["log_eta"] = 0.05
    want = interp.predict(model, check_consistency=False)

    f = make_predictor(interp, model, dtype=jnp.float64)
    params = params_batch(model, {}, (2,), dtype=jnp.float64)
    ngal, xi = f(params)
    assert np.isclose(float(ngal[0]), want[0], rtol=1e-10)
    np.testing.assert_allclose(np.asarray(xi[0]), want[1], rtol=1e-10)


def test_initialize_multihost_single_process():
    # Single-process distributed init (the degenerate pod): after it,
    # global device discovery and mesh construction work, and repeated
    # initialization is a no-op.  Run in a subprocess so the session's
    # jax runtime is untouched.
    import subprocess
    import sys
    from pathlib import Path

    code = """
import jax
jax.config.update("jax_platforms", "cpu")
from tabcorr_tpu.parallel import initialize_multihost, make_mesh
n = initialize_multihost("localhost:12951", 1, 0)
assert n == 1, n
assert initialize_multihost("localhost:12951", 1, 0) == 1  # idempotent
assert jax.process_index() == 0
mesh = make_mesh()
print("MULTIHOST-OK", dict(mesh.shape))
"""
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).parents[1], timeout=300,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "MULTIHOST-OK" in out.stdout
