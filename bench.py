"""Benchmark: batched zheng07 wp + xi_ell predictions per second.

The reference's headline numbers (BASELINE.md): a direct halotools
computation takes ~60 s per model evaluation and TabCorr ``predict`` ~1 ms
(≈1e3 evaluations/sec, single CPU core).  The north star for this rebuild
is >=1e6 batched zheng07 wp+xi_ell predictions/sec on one accelerator at
<1e-6 error vs the float64 reference path.

One "prediction" = a full wp(rp) + xi_0/xi_2/xi_4 evaluation for one HOD
parameter vector:

* wp: the reference's own bolplanck example tabulation
  (19 rp bins, 60 halo bins, auto mode, checked-in fixture).
* xi_ell: a REAL tabulation produced by this repo's own pipeline
  machinery (scripts/make_bench_fixture.py) with the published 'default'
  production shape: 30 prim-haloprop bins x 2 secondary percentiles x 2
  galaxy types = 120 bins, auto mode, 14 s bins x 3 multipoles stacked
  into one (3, 14) statistic.

Four sections, all through the public entry points on JAX's default
device: the headline rate (``make_multi_predictor`` over wp + xi_ell),
the stretch-move ensemble over the batched Gaussian posterior of the
same predictor, the 64-node 'default' grid Interpolator
(``make_predictor``), and accuracy.

Accuracy is probed at N_PROBE=16 random parameter points (max over the
probe set), two ways per statistic:

* ``*_err_vs_f64`` — device error against the float64 host path
  evaluated at the float32 parameter values the device actually
  receives: the float32 pipeline's own arithmetic contract.
* ``*_err_incl_param_quantization`` — against the float64 host path at
  the unrounded float64 parameters; the difference is the irreducible
  float32 *input representation* error (~1e-6 level for logM-type
  parameters), common to every float32 pipeline.

wp errors are per-element relative (the north-star anchor); xi_ell
errors are scale-normalized (relative to the statistic's largest
element — its smallest entries are ~1e-7 of the largest, where
per-element relative error measures table conditioning, not kernel
precision).

Prints one JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
   "device_kind": ..., "power_limit": ..., ...}
vs_baseline is measured rate / 1e3 (the reference's ~1 ms predict).
"""

import json
import subprocess
import time
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

import tabcorr_tpu as tt
from tabcorr_tpu.mcmc import ensemble_step, make_gaussian_logpost_batched
from tabcorr_tpu.predictor import (make_multi_predictor, make_predictor,
                                   params_batch)
from tabcorr_tpu.synthetic import build_interpolator
from tabcorr_tpu.utils.cache import enable_compile_cache

BASELINE_PREDICTIONS_PER_SEC = 1.0e3  # reference predict ~1 ms / eval
BATCH = 262144
GRID_BATCH = 16384
N_WALKERS = 262144
N_STEPS = 50
N_ITER = 10
N_WINDOWS = 5
N_PROBE = 16  # accuracy probe points (batch elements 0..N_PROBE-1)
FIXTURES = Path(__file__).absolute().parent / "tests" / "data" / "examples"


def power_limit():
    """The card's name and power limit as nvidia-smi reports them, or
    None where there is no nvidia-smi (a CPU host)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except FileNotFoundError:
        return None


def _timed_rate(fn, params, batch, n_iter=N_ITER, n_windows=N_WINDOWS):
    """Median rate over several timing windows (median, not best-of)."""
    rates = []
    for _ in range(n_windows):
        t0 = time.perf_counter()
        for _ in range(n_iter):
            out = fn(params)
        jax.block_until_ready(out)
        rates.append(batch * n_iter / (time.perf_counter() - t0))
    return float(np.median(rates))


def main():
    enable_compile_cache()
    wp_tab = tt.TabCorr.read(FIXTURES / "bolplanck_wp.npz")
    xi_tab = tt.TabCorr.read(FIXTURES / "synthetic_xi_ell.npz")

    def make_model():
        return tt.Zheng07Model(threshold=-18,
                               redshift=wp_tab.attrs["redshift"])

    model = make_model()
    rng = np.random.default_rng(7)
    overrides = {
        "logMmin": 11.35 + 0.1 * rng.normal(size=BATCH),
        "sigma_logM": 0.25 + 0.01 * rng.normal(size=BATCH),
        "logM0": 11.2 + 0.1 * rng.normal(size=BATCH),
        "logM1": 12.4 + 0.1 * rng.normal(size=BATCH),
        "alpha": 0.83 + 0.02 * rng.normal(size=BATCH),
    }
    # Batch element 0 holds the model defaults; elements 0..N_PROBE-1
    # double as the float32-vs-float64 accuracy probe set.
    for key in overrides:
        overrides[key][0] = model.param_dict[key]
    params = params_batch(model, overrides, (BATCH,), dtype=jnp.float32)

    # --- headline: joint wp + xi_ell predictor --------------------------
    predict_all = make_multi_predictor([wp_tab, xi_tab], model)
    out = jax.block_until_ready(predict_all(params))
    rate = _timed_rate(predict_all, params, BATCH)
    (ngal, wp), (_, xi_ell) = out

    # --- ensemble MCMC: one walker-step = one posterior evaluation + move
    names = tuple(model.param_dict.keys())
    data_wp = np.asarray(wp[0], np.float64).ravel()
    data_xi = np.asarray(xi_ell[0], np.float64).ravel()
    log_prob = make_gaussian_logpost_batched(
        predict_all, names, model.param_dict, [data_wp, data_xi],
        [np.diag(1.0 / (0.05 * np.abs(data_wp) + 1e-3) ** 2),
         np.diag(1.0 / (0.05 * np.abs(data_xi) + 1e-3) ** 2)])
    walkers = jnp.asarray(
        np.array([model.param_dict[k] for k in names])[None, :] +
        0.02 * rng.normal(size=(N_WALKERS, len(names))), dtype=jnp.float32)

    @jax.jit
    def step(key, w, lp):
        return ensemble_step(key, w, lp, log_prob, vectorized=True)

    lp = log_prob(walkers)
    w, lp, _ = step(jax.random.key(0), walkers, lp)
    jax.block_until_ready((w, lp))
    t0 = time.perf_counter()
    for i in range(N_STEPS):
        w, lp, _ = step(jax.random.key(i + 1), w, lp)
    jax.block_until_ready((w, lp))
    ensemble_rate = N_WALKERS * N_STEPS / (time.perf_counter() - t0)

    # --- the published-database 64-node 'default' grid geometry ---------
    # (reference: tabcorr/database.py:56-59) through make_predictor.
    interp64 = build_interpolator()
    gmodel = tt.Zheng07Model(threshold=-20, redshift=0.0)
    gmodel.param_dict.update(alpha_c=0.2, alpha_s=1.0, log_eta=0.0)
    grng = np.random.default_rng(11)
    gparams = params_batch(
        gmodel,
        {"logM1": gmodel.param_dict["logM1"] +
         0.1 * grng.normal(size=GRID_BATCH),
         "alpha_c": grng.uniform(0.05, 0.35, GRID_BATCH),
         "log_eta": grng.uniform(-0.3, 0.3, GRID_BATCH)},
        (GRID_BATCH,), dtype=jnp.float32)
    f_grid = make_predictor(interp64, gmodel)
    g_out = jax.block_until_ready(f_grid(gparams))
    grid_rate = _timed_rate(f_grid, gparams, GRID_BATCH, n_iter=2)
    grid_err = 0.0
    for i in range(N_PROBE):
        for k, v in gparams.items():
            gmodel.param_dict[k] = float(np.float32(v[i]))
        _, xi_h = interp64.predict(gmodel, check_consistency=False)
        grid_err = max(grid_err, float(np.max(np.abs(
            np.asarray(g_out[1][i], np.float64).ravel() - xi_h.ravel())))
            / float(np.max(np.abs(xi_h))))

    # --- accuracy vs the float64 host path (see module docstring) -------
    err = {"wp_kernel": 0.0, "wp_total": 0.0,
           "xi_kernel": 0.0, "xi_total": 0.0}
    for i in range(N_PROBE):
        got_wp = np.asarray(wp[i], dtype=np.float64).ravel()
        got_xi = np.asarray(xi_ell[i], dtype=np.float64).ravel()
        for which, quantize in (("kernel", True), ("total", False)):
            m = make_model()
            for k in overrides:
                v = overrides[k][i]
                m.param_dict[k] = float(np.float32(v)) if quantize \
                    else float(v)
            want_wp = wp_tab.predict(m, check_consistency=False)[1].ravel()
            want_xi = xi_tab.predict(m, check_consistency=False)[1].ravel()
            err[f"wp_{which}"] = max(
                err[f"wp_{which}"],
                float(np.max(np.abs(got_wp / want_wp - 1))))
            err[f"xi_{which}"] = max(
                err[f"xi_{which}"],
                float(np.max(np.abs(got_xi - want_xi)) /
                      np.max(np.abs(want_xi))))

    device = jax.devices()[0]
    print(json.dumps({
        "metric": "zheng07_wp_xi_ell_predictions_per_sec",
        "value": float(rate),
        "unit": "predictions/s",
        "vs_baseline": float(rate / BASELINE_PREDICTIONS_PER_SEC),
        "batch": BATCH,
        "device": str(device),
        "device_kind": device.device_kind,
        "power_limit": power_limit(),
        "ensemble_walker_steps_per_sec": float(ensemble_rate),
        "n_walkers": N_WALKERS,
        "grid64_predictions_per_sec": grid_rate,
        "grid64_batch": GRID_BATCH,
        "grid64_f32_scaled_err_vs_f64": grid_err,
        "n_accuracy_probes": N_PROBE,
        "wp_f32_max_rel_err_vs_f64": err["wp_kernel"],
        "xi_ell_f32_scaled_err_vs_f64": err["xi_kernel"],
        "wp_f32_max_rel_err_incl_param_quantization": err["wp_total"],
        "xi_ell_f32_scaled_err_incl_param_quantization": err["xi_total"],
    }))


if __name__ == "__main__":
    main()
