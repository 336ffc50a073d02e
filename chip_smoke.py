"""Smoke run of the main path on an NVIDIA GPU, checked against float64.

Drives each user-facing path once, at the shapes users load, through the
public entry points, and compares it with the float64 host path:

  a  batched prediction: make_predictor / make_multi_predictor over the
     wp table (60 halo bins, 19 rp bins) and the xi_0/2/4 table (120
     bins, 3 x 14 rows) at batch 262,144
  b  ensemble MCMC: run_ensemble over the batched Gaussian posterior of
     (a) with 262,144 walkers
  c  gradient sampling: run_hmc, and jax.grad of the posterior against a
     central finite difference of the float64 posterior
  d  the 64-node 'default' grid Interpolator through make_predictor
  e  the published Delta Sigma 'efficient' Interpolator via database.read
  f  tabulation: labeled_pair_count at the published wp geometry (120
     labels, 14 rp bins, 1050 box, pi_max 80, 2e5 tracers) for every
     strategy, and one TabCorr.tabulate(mode='auto')
  t  XLA's own float32 exp, log1p and erfc against float64, beside the
     repository's compensated versions

Accuracy contracts (BASELINE.json), at the float32 parameter values the
device received, over 16 probe points: wp relative error < 1e-6 per
element; xi_ell, the grid and Delta Sigma scaled error (max absolute
error over the largest element) < 1e-6.  Pair counts equal the float64
native counter except for pairs on a float32 bin edge.

Each phase prints one JSON line.  The last line is
{"ok": true, "device": {...}}.  Any failed phase, or a default device
that is not a GPU, exits non-zero.  ``--multi`` runs only the
multi-device paths on four GPUs (see :func:`multi_main`).

Usage (from the repository root):  python chip_smoke.py [--multi]
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

REPO = Path(__file__).absolute().parent
EXAMPLES = REPO / "tests" / "data" / "examples"
N_PROBE = 16
BATCH = 262144
GRID_BATCH = 16384
DS_BATCH = 65536


def require_gpus(count):
    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < count:
        sys.exit(f"chip_smoke needs {count} GPU(s); JAX found "
                 f"{len(devices)} {devices[0].platform} device(s).")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def timed(fn, *args, reps=5):
    """(first call in s, compile included; mean steady call in s; out)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return first, (time.perf_counter() - t0) / reps, out


def report(name, ok, **fields):
    print(json.dumps({"phase": name, "ok": bool(ok), **fields}),
          flush=True)
    if not ok:
        sys.exit(f"phase {name} failed")


def rel_err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64).ravel() /
                               want.ravel() - 1)))


def scaled_err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64).ravel() -
                               want.ravel())) / np.max(np.abs(want)))


def host_model(make, params, i):
    """A float64 host model at sample i's float32 parameter values."""
    model = make()
    for key, value in params.items():
        model.param_dict[key] = float(np.float32(value[i]))
    return model


# ---------------------------------------------------------------------------
def load_tables():
    import tabcorr_tpu as tt
    wp_tab = tt.TabCorr.read(EXAMPLES / "bolplanck_wp.npz")
    xi_tab = tt.TabCorr.read(EXAMPLES / "synthetic_xi_ell.npz")

    def make():
        return tt.Zheng07Model(threshold=-18,
                               redshift=wp_tab.attrs["redshift"])
    return wp_tab, xi_tab, make


def hod_batch(model, batch, seed):
    from tabcorr_tpu.predictor import params_batch
    rng = np.random.default_rng(seed)
    spread = {"logMmin": 0.1, "sigma_logM": 0.01, "logM0": 0.1,
              "logM1": 0.1, "alpha": 0.02}
    overrides = {k: model.param_dict[k] + s * rng.normal(size=batch)
                 for k, s in spread.items()}
    return params_batch(model, overrides, (batch,), dtype=jnp.float32)


def phase_predict(ctx):
    from tabcorr_tpu.predictor import make_multi_predictor, make_predictor
    wp_tab, xi_tab, make = ctx["tables"]
    params = hod_batch(make(), BATCH, seed=7)
    f_wp = make_predictor(wp_tab, make())
    f_multi = make_multi_predictor([wp_tab, xi_tab], make())
    c_wp, t_wp, (ngal_wp, wp_only) = timed(f_wp, params)
    c_multi, t_multi, out = timed(f_multi, params)
    (ngal, wp), (_, xi) = out
    finite = all(bool(jnp.all(jnp.isfinite(a)))
                 for a in (ngal, wp, xi, wp_only))
    wp_err = xi_err = ngal_err = 0.0
    for i in range(N_PROBE):
        model = host_model(make, params, i)
        ng_h, wp_h = wp_tab.predict(model, check_consistency=False)
        _, xi_h = xi_tab.predict(model, check_consistency=False)
        wp_err = max(wp_err, rel_err(wp[i], wp_h),
                     rel_err(wp_only[i], wp_h))
        xi_err = max(xi_err, scaled_err(xi[i], xi_h))
        ngal_err = max(ngal_err, abs(float(ngal[i]) / ng_h - 1))
    ctx["predict_all"] = f_multi
    report("a_predict", finite and wp_err < 1e-6 and xi_err < 1e-6,
           batch=BATCH, wp_shape=list(wp.shape), xi_shape=list(xi.shape),
           wp_first_s=c_wp, wp_s=t_wp, multi_first_s=c_multi,
           multi_s=t_multi, multi_predictions_per_s=BATCH / t_multi,
           wp_rel_err=wp_err, xi_scaled_err=xi_err, ngal_rel_err=ngal_err)


def gaussian_setup(tabs, make, names):
    """Data at the fiducial model (float64 host), 5% diagonal errors."""
    model = make()
    data = [np.asarray(t.predict(model, check_consistency=False)[1],
                       np.float64).ravel() for t in tabs]
    inv_cov = [np.diag(1.0 / (0.05 * np.abs(d) + 1e-3) ** 2) for d in data]
    base = {k: np.float32(v) for k, v in model.param_dict.items()}
    theta0 = np.array([model.param_dict[k] for k in names])
    return data, inv_cov, base, theta0


def host_logpost(tabs, make, names, data, inv_cov, theta):
    model = make()
    for k, v in zip(names, theta):
        model.param_dict[k] = float(v)
    lp = 0.0
    for t, d, c in zip(tabs, data, inv_cov):
        r = t.predict(model, check_consistency=False)[1].ravel() - d
        lp -= 0.5 * r @ c @ r
    return lp


def phase_ensemble(ctx):
    from tabcorr_tpu.mcmc import make_gaussian_logpost_batched, run_ensemble
    wp_tab, xi_tab, make = ctx["tables"]
    names = ("logMmin", "sigma_logM", "logM0", "logM1", "alpha")
    data, inv_cov, base, theta0 = gaussian_setup([wp_tab, xi_tab], make,
                                                 names)
    log_prob = make_gaussian_logpost_batched(
        ctx["predict_all"], names, base, data, inv_cov)
    rng = np.random.default_rng(3)
    walkers = jnp.asarray(theta0 + 0.01 * rng.normal(size=(BATCH, 5)),
                          jnp.float32)
    lp0 = np.asarray(jax.jit(log_prob)(walkers[:N_PROBE]), np.float64)
    lp_err = max(
        abs(lp0[i] - host_logpost([wp_tab, xi_tab], make, names, data,
                                  inv_cov, np.asarray(walkers[i],
                                                      np.float64)))
        / (1.0 + abs(lp0[i])) for i in range(N_PROBE))
    n_steps = 4

    def run(key, w):
        return run_ensemble(key, log_prob, w, n_steps, vectorized=True)

    first, steady, (chain, chain_lp, accept) = timed(
        run, jax.random.key(0), walkers, reps=2)
    finite = bool(jnp.all(jnp.isfinite(chain_lp[-1])))
    report("b_ensemble", finite and 0 < float(accept) <= 1 and
           lp_err < 1e-4, walkers=BATCH, steps=n_steps,
           chain_shape=list(chain.shape), first_s=first, steady_s=steady,
           walker_steps_per_s=BATCH * n_steps / steady,
           accept=float(accept), logpost_rel_err=float(lp_err))


def phase_gradient(ctx):
    from tabcorr_tpu.mcmc import make_gaussian_logpost, run_hmc
    from tabcorr_tpu.predictor import make_predictor
    wp_tab, _, make = ctx["tables"]
    names = ("logMmin", "sigma_logM", "logM0", "logM1", "alpha")
    data, inv_cov, base, theta0 = gaussian_setup([wp_tab], make, names)
    predict_one = make_predictor(wp_tab, make(), vectorized=False, jit=False)
    log_prob = make_gaussian_logpost(predict_one, names, base, data[0],
                                     inv_cov[0])
    point = np.float32(theta0 + np.array([0.05, 0.02, -0.05, 0.05, 0.02]))
    grad = np.asarray(jax.jit(jax.grad(log_prob))(jnp.asarray(point)),
                      np.float64)
    fd = np.zeros(5)
    x = point.astype(np.float64)
    for k in range(5):
        h = 1e-4 * max(1.0, abs(x[k]))
        e = np.zeros(5)
        e[k] = h
        fd[k] = (host_logpost([wp_tab], make, names, data, inv_cov, x + e) -
                 host_logpost([wp_tab], make, names, data, inv_cov, x - e)
                 ) / (2 * h)
    grad_err = float(np.max(np.abs(grad - fd)) / np.max(np.abs(fd)))
    n_chains, n_steps = 64, 3
    rng = np.random.default_rng(5)
    start = jnp.asarray(theta0 + 0.01 * rng.normal(size=(n_chains, 5)),
                        jnp.float32)

    def run(key, q):
        return run_hmc(key, log_prob, q, n_steps, step_size=1e-3,
                       n_leapfrog=5)

    first, steady, (chain, chain_lp, accept) = timed(
        run, jax.random.key(1), start, reps=2)
    finite = bool(jnp.all(jnp.isfinite(chain_lp)))
    report("c_gradient", finite and grad_err < 1e-3, chains=n_chains,
           steps=n_steps, leapfrog=5, first_s=first, steady_s=steady,
           accept=float(accept), grad=grad.tolist(), fd_grad=fd.tolist(),
           grad_vs_fd_err=grad_err)


def grid_model():
    import tabcorr_tpu as tt
    model = tt.Zheng07Model(threshold=-20, redshift=0.0)
    model.param_dict.update(alpha_c=0.2, alpha_s=1.0, log_eta=0.0)
    return model


def grid_batch(model, batch, seed):
    from tabcorr_tpu.predictor import params_batch
    rng = np.random.default_rng(seed)
    return params_batch(model, {
        "logM1": model.param_dict["logM1"] + 0.1 * rng.normal(size=batch),
        "alpha_c": rng.uniform(0.02, 0.38, batch),
        "alpha_s": rng.uniform(0.82, 1.18, batch),
        "log_eta": rng.uniform(-0.38, 0.38, batch)}, (batch,),
        dtype=jnp.float32)


def phase_grid(ctx):
    from tabcorr_tpu.predictor import make_predictor
    from tabcorr_tpu.synthetic import build_interpolator
    interp = build_interpolator()
    params = grid_batch(grid_model(), GRID_BATCH, seed=11)
    f = make_predictor(interp, grid_model())
    first, steady, (ngal, xi) = timed(f, params)
    finite = bool(jnp.all(jnp.isfinite(xi)) & jnp.all(jnp.isfinite(ngal)))
    err = max(scaled_err(xi[i], interp.predict(
        host_model(grid_model, params, i), check_consistency=False)[1])
        for i in range(N_PROBE))
    report("d_grid64", finite and err < 1e-6, batch=GRID_BATCH,
           nodes=len(interp.tabcorr_list), xi_shape=list(xi.shape),
           first_s=first, steady_s=steady,
           predictions_per_s=GRID_BATCH / steady, xi_scaled_err=err)


def phase_delta_sigma(ctx):
    import tabcorr_tpu as tt
    from tabcorr_tpu.predictor import make_predictor, params_batch
    interp = tt.database.read("AbacusSummit", 0.5, "ds",
                              tab_config="efficient")

    def make():
        m = tt.Zheng07Model(threshold=-21, redshift=0.5,
                            prim_haloprop_key="halo_m258m")
        m.param_dict.update(log_eta=0.0, alpha_s=1.0, alpha_c=0.0)
        return m

    rng = np.random.default_rng(13)
    params = params_batch(make(), {
        "logMmin": make().param_dict["logMmin"] +
        0.1 * rng.normal(size=DS_BATCH),
        "log_eta": rng.uniform(-0.45, 0.45, DS_BATCH)}, (DS_BATCH,),
        dtype=jnp.float32)
    f = make_predictor(interp, make())
    first, steady, (ngal, ds) = timed(f, params)
    finite = bool(jnp.all(jnp.isfinite(ds)))
    err = max(scaled_err(ds[i], interp.predict(
        host_model(make, params, i), check_consistency=False)[1])
        for i in range(N_PROBE))
    tab0 = interp.tabcorr_list[0]
    report("e_delta_sigma", finite and err < 1e-6, batch=DS_BATCH,
           nodes=len(interp.tabcorr_list), halo_bins=len(tab0.gal_type),
           ds_shape=list(ds.shape), first_s=first, steady_s=steady,
           predictions_per_s=DS_BATCH / steady, ds_scaled_err=err)


def wp_tracers(n_halos=150_000, n_sats=50_000, lbox=1050.0, seed=17):
    """2e5 labeled tracers: 30 mass x 2 concentration x 2 type labels."""
    from tabcorr_tpu.mock import populate_dense_mock
    from tabcorr_tpu.synthetic import synthetic_halocat
    from tabcorr_tpu.tabulate import bin_labels, compute_conditional_percentiles
    halocat = synthetic_halocat(n_halos, lbox, seed)
    mass = np.asarray(halocat.halo_table["halo_mvir"])
    mock = populate_dense_mock(halocat, np.random.default_rng(seed),
                               n_sats / mass.sum(), "halo_mvir", 300)
    perc = compute_conditional_percentiles(
        mass, np.asarray(halocat.halo_table["halo_nfw_conc"]))
    idx = mock["halo_index"]
    labels, _ = bin_labels(np.log10(mass[idx]), np.linspace(11.5, 15.0, 31),
                           perc[idx], np.array([0.0, 0.5, 1.0]),
                           gal_type=np.where(mock["is_central"], 0, 1))
    return mock["pos"], labels, lbox


def edge_pairs(pos, labels, lbox, rp, pi_max, delta=5e-4):
    """Ordered pairs within ``delta`` of an rp edge or of the pi cut.

    Only these can bin differently under float32 geometry than under
    the float64 native counter: coordinates near 1050 round by 6e-5 in
    float32, so separations move by a few 1e-4 at most.
    """
    from tabcorr_tpu.ops.paircount import labeled_pair_count
    kw = dict(period=lbox, kind="rppi", strategy="native")
    shells = np.sort(np.concatenate([rp - delta, rp + delta]))
    near_rp = labeled_pair_count(pos, labels, 120, r_edges=shells,
                                 pi_max=pi_max + delta, **kw)[..., ::2]
    span = np.array([rp[0] - delta, rp[-1] + delta])
    near_pi = (labeled_pair_count(pos, labels, 120, r_edges=span,
                                  pi_max=pi_max + delta, **kw) -
               labeled_pair_count(pos, labels, 120, r_edges=span,
                                  pi_max=pi_max - delta, **kw))
    return float(near_rp.sum() + near_pi.sum())


def phase_tabulate(ctx):
    import tabcorr_tpu as tt
    from tabcorr_tpu.ops.paircount import labeled_pair_count
    pos, labels, lbox = wp_tracers()
    rp = np.logspace(-1.0, 1.5, 15)
    kw = dict(period=lbox, kind="rppi", r_edges=rp, pi_max=80.0)
    timings, mismatch = {}, {}
    t0 = time.perf_counter()
    want = labeled_pair_count(pos, labels, 120, strategy="native", **kw)
    timings["native_s"] = time.perf_counter() - t0
    n_pairs = float(want.sum())
    for strategy in ("matmul", "scatter"):
        for label in ("first", "warm"):
            t0 = time.perf_counter()
            got = labeled_pair_count(pos, labels, 120, strategy=strategy,
                                     **kw)
            timings[f"{strategy}_{label}_s"] = time.perf_counter() - t0
        mismatch[strategy] = float(np.abs(got - want).sum())
    # A misbinned ordered pair moves at most 2 counts (out of one bin,
    # into another).
    edge_budget = 2 * edge_pairs(pos, labels, lbox, rp, 80.0)
    counts_ok = all(m <= edge_budget for m in mismatch.values())

    # One tabulation through the public API against the native counter.
    from tabcorr_tpu.synthetic import synthetic_halocat
    halocat = synthetic_halocat(20000, 300.0, seed=19)
    tab_kw = dict(mode="auto", prim_haloprop_bins=8,
                  sats_per_prim_haloprop=2e-12, seed=23,
                  redshift_space_distortions=False)
    t0 = time.perf_counter()
    tab = tt.TabCorr.tabulate(halocat, tt.corrfunc.wp, rp, 40.0, **tab_kw)
    tab_s = time.perf_counter() - t0
    ref = tt.TabCorr.tabulate(halocat, tt.corrfunc.wp, rp, 40.0,
                              backend="native", **tab_kw)
    diff = np.abs(tab.tpcf_matrix - ref.tpcf_matrix)
    n_diff = int(np.sum(diff > 1e-6 * np.abs(ref.tpcf_matrix) + 1e-12))
    report("f_tabulate", counts_ok and n_diff <= 4, tracers=len(pos),
           labels=120, rp_bins=14, lbox=lbox, pi_max=80.0,
           ordered_pairs=n_pairs, **timings,
           count_mismatch=mismatch, edge_budget=edge_budget,
           tabulate_s=tab_s, tabulate_shape=list(tab.tpcf_matrix.shape),
           tabulate_entries_off_native=n_diff)


def phase_transcendentals(ctx):
    import scipy.special as sps
    from tabcorr_tpu.utils import backend
    out, ok = {}, True
    for name, xla, ours, ref, lo, hi in (
            ("exp", jnp.exp, backend.exp, np.exp, -87.0, 0.0),
            ("log1p", jnp.log1p, backend.log1p, np.log1p, -0.999, 4.0),
            ("erfc", jax.scipy.special.erfc, backend.erfc, sps.erfc,
             -6.0, 9.0)):
        x = jnp.linspace(lo, hi, 2_000_001, dtype=jnp.float32)
        want = ref(np.asarray(x, np.float64))
        keep = np.abs(want) > 1e-30
        for impl, fn in (("xla", xla), ("ours", ours)):
            got = np.asarray(jax.jit(fn)(x), np.float64)
            err = np.abs(got - want)
            out[f"{name}_{impl}_max_rel"] = float(
                np.max(err[keep] / np.abs(want[keep])))
            out[f"{name}_{impl}_max_abs"] = float(np.max(err))
        ok &= out[f"{name}_ours_max_rel"] < 1e-6
    report("t_transcendentals", ok, points=2_000_001, **out)


PHASES = (phase_predict, phase_ensemble, phase_gradient, phase_grid,
          phase_delta_sigma, phase_tabulate, phase_transcendentals)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the four-GPU paths only")
    args = ap.parse_args(argv)
    count = 4 if args.multi else 1
    require_gpus(count)
    os.environ.setdefault("TABCORR_DATABASE", str(REPO / "tests" / "data"))
    from tabcorr_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    print(card_line(), flush=True)
    if args.multi:
        multi_main()
    else:
        ctx = {"tables": load_tables()}
        for phase in PHASES:
            phase(ctx)
    device = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices())}}))


def max_diff(a, b):
    """Largest difference over the largest element (scaled)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def multi_main():
    """The paths users run across devices, each against one card.

    dp-sharded joint predictor, the dp x tp bin-sharded predictor (its
    contraction ends in a psum), a dp-sharded ensemble, a dp-sharded
    Interpolator and the mesh pair-count sweep.  Sharding splits the
    same arithmetic, so each must agree with the single-card run to
    float32 rounding (counts: exactly).
    """
    from tabcorr_tpu.mcmc import make_gaussian_logpost_batched, run_ensemble
    from tabcorr_tpu.ops.paircount import labeled_pair_count
    from tabcorr_tpu.parallel import (make_mesh, make_sharded_predict,
                                      shard_params)
    from tabcorr_tpu.predictor import (make_multi_predictor, make_predictor,
                                       occupation_functions)
    from tabcorr_tpu.synthetic import build_interpolator

    n_dev = len(jax.devices())
    dp = make_mesh(n_dev)
    wp_tab, xi_tab, make = load_tables()
    params = hod_batch(make(), BATCH, seed=7)

    one = make_multi_predictor([wp_tab, xi_tab], make())
    mesh_fn = make_multi_predictor([wp_tab, xi_tab], make(), mesh=dp)
    _, t_one, out_one = timed(one, params)
    _, t_mesh, out_mesh = timed(mesh_fn, params)
    err = max(max_diff(m[1], o[1]) for m, o in zip(out_mesh, out_one))
    report("m1_dp_predict", err < 1e-6, devices=n_dev, batch=BATCH,
           one_card_s=t_one, mesh_s=t_mesh, speedup=t_one / t_mesh,
           scaled_diff=err)

    tp = make_mesh(n_dev, table_parallel=2)
    table = wp_tab.table_data(n_gauss=10, dtype=jnp.float32)
    f_tp, _ = make_sharded_predict(tp, table, *occupation_functions(make()))
    f_wp = make_predictor(wp_tab, make())
    _, t_one, (_, wp_one) = timed(f_wp, params)
    sharded = shard_params(params, tp)
    _, t_tp, (_, wp_tp) = timed(f_tp, sharded)
    err = max_diff(np.asarray(wp_tp).reshape(wp_one.shape), wp_one)
    report("m2_dp_tp_psum_predict", err < 1e-6,
           mesh_shape=dict(tp.shape), batch=BATCH, one_card_s=t_one,
           mesh_s=t_tp, scaled_diff=err)

    names = ("logMmin", "sigma_logM", "logM0", "logM1", "alpha")
    data, inv_cov, base, theta0 = gaussian_setup([wp_tab, xi_tab], make,
                                                 names)
    walkers = jnp.asarray(theta0 + 0.01 * np.random.default_rng(3).normal(
        size=(BATCH, 5)), jnp.float32)
    chains = {}
    for label, fn in (("one", one), ("mesh", mesh_fn)):
        log_prob = make_gaussian_logpost_batched(fn, names, base, data,
                                                 inv_cov)
        _, t, (chain, lp, _) = timed(
            lambda k, w: run_ensemble(k, log_prob, w, 4, vectorized=True),
            jax.random.key(0), walkers, reps=2)
        chains[label] = (np.asarray(chain[-1]), np.asarray(lp[-1]), t)
    moved = float(np.mean(np.any(chains["mesh"][0] != chains["one"][0],
                                 axis=1)))
    lp_diff = float(np.max(np.abs(chains["mesh"][1] - chains["one"][1]) /
                           (1 + np.abs(chains["one"][1]))))
    report("m3_dp_ensemble", moved < 1e-3 and lp_diff < 1e-4,
           walkers=BATCH, steps=4, one_card_s=chains["one"][2],
           mesh_s=chains["mesh"][2], walkers_differing=moved,
           logpost_rel_diff=lp_diff)

    interp = build_interpolator()
    gparams = grid_batch(grid_model(), GRID_BATCH, seed=11)
    _, t_one, (_, g_one) = timed(make_predictor(interp, grid_model()),
                                 gparams)
    _, t_mesh, (_, g_mesh) = timed(
        make_predictor(interp, grid_model(), mesh=dp), gparams)
    err = max_diff(g_mesh, g_one)
    report("m4_dp_grid64", err < 1e-6, batch=GRID_BATCH, one_card_s=t_one,
           mesh_s=t_mesh, speedup=t_one / t_mesh, scaled_diff=err)

    pos, labels, lbox = wp_tracers()
    kw = dict(period=lbox, kind="rppi", r_edges=np.logspace(-1.0, 1.5, 15),
              pi_max=80.0, strategy="matmul")
    counts = {}
    for label, mesh in (("one", None), ("mesh", dp)):
        labeled_pair_count(pos, labels, 120, mesh=mesh, **kw)
        t0 = time.perf_counter()
        counts[label] = labeled_pair_count(pos, labels, 120, mesh=mesh,
                                           **kw)
        counts[label + "_s"] = time.perf_counter() - t0
    mismatch = float(np.abs(counts["mesh"] - counts["one"]).sum())
    report("m5_mesh_pair_count", mismatch == 0, tracers=len(pos),
           labels=120, one_card_s=counts["one_s"],
           mesh_s=counts["mesh_s"], count_mismatch=mismatch)


if __name__ == "__main__":
    main()
