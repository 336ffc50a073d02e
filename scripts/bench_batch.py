"""Chart joint-predictor throughput vs batch size and ensemble size.

The joint wp + xi_ell predictor's throughput varies with batch through a
fixed per-launch cost (jit dispatch + kernel ramp).  This script
measures where the cliff sits:

* ``predict``: the wp+xi_ell rate at batches 1k..262k, plus a
  fitted per-launch overhead (t = t0 + batch / r_inf).
* ``ensemble``: stretch-move walker-steps/s at 4k..262k walkers, two
  launch regimes — one jitted ``ensemble_step`` per Python-loop step
  (bench.py's regime) vs the whole chain fused into ONE launch via
  ``run_ensemble``'s in-jit ``lax.scan`` (amortizes the dispatch but
  not the ramp of each half-ensemble call).

Feeds the "choosing your batch size" section of docs/performance.md.

Usage: python scripts/bench_batch.py [--json]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).absolute().parent.parent
sys.path.insert(0, str(REPO))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--batches", type=int, nargs="*",
                    default=[1024, 2048, 4096, 8192, 16384, 32768,
                             65536, 131072, 262144])
    ap.add_argument("--ensembles", type=int, nargs="*",
                    default=[4096, 16384, 65536, 262144])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from tabcorr_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    import tabcorr_tpu as tt
    from tabcorr_tpu.mcmc import (ensemble_step, run_ensemble,
                                  make_gaussian_logpost_batched)
    from tabcorr_tpu.predictor import (make_multi_predictor,
                                       occupation_functions, params_batch)

    fixtures = REPO / "tests" / "data" / "examples"
    wp_tab = tt.TabCorr.read(fixtures / "bolplanck_wp.npz")
    xi_tab = tt.TabCorr.read(fixtures / "synthetic_xi_ell.npz")
    model = tt.Zheng07Model(threshold=-18,
                            redshift=wp_tab.attrs["redshift"])
    names = tuple(model.param_dict.keys())
    f_joint = make_multi_predictor([wp_tab, xi_tab], model)

    @jax.jit
    def predict_all(params):
        (ngal, wp), (_, xi) = f_joint(params)
        return ngal, wp, xi

    rng = np.random.default_rng(7)
    results = {"device": str(jax.devices()[0]), "predict": [],
               "ensemble": []}
    print(json.dumps({"device": results["device"]}), flush=True)

    # --- predict rate vs batch ---------------------------------------
    for B in args.batches:
        params = params_batch(
            model, {"logM1": model.param_dict["logM1"] +
                    0.1 * rng.normal(size=B)}, (B,), dtype=jnp.float32)
        out = predict_all(params)
        jax.block_until_ready(out)
        # More iterations at small batches so each window is >=~50 ms.
        iters = max(2, min(200, (1 << 22) // B))
        rates = []
        for _ in range(args.windows):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = predict_all(params)
            jax.block_until_ready(out)
            rates.append(B * iters / (time.perf_counter() - t0))
        r = float(np.median(rates))
        results["predict"].append({"batch": B, "rate": r})
        print(json.dumps({"kind": "predict", "batch": B, "rate": r}),
              flush=True)

    # Per-launch overhead fit: t(B) = t0 + B / r_inf over the measured
    # points (least squares on launch time vs batch).
    bs = np.array([p["batch"] for p in results["predict"]], np.float64)
    ts = bs / np.array([p["rate"] for p in results["predict"]])
    A = np.stack([np.ones_like(bs), bs], axis=1)
    (t0_fit, slope), *_ = np.linalg.lstsq(A, ts, rcond=None)
    results["launch_overhead_s"] = float(t0_fit)
    results["asymptotic_rate"] = float(1.0 / slope)
    print(json.dumps({"kind": "fit", "launch_overhead_ms":
                      1e3 * float(t0_fit),
                      "asymptotic_rate": float(1.0 / slope)}), flush=True)

    # --- ensemble walker-steps/s vs ensemble size --------------------
    base = np.array([model.param_dict[k] for k in names])
    for n_w in args.ensembles:
        # Fresh log-post per size (data vector from the default point).
        p0 = params_batch(model, {}, (max(args.batches),),
                          dtype=jnp.float32)
        out0 = predict_all(p0)
        data_wp = np.asarray(out0[1][0], np.float64).ravel()
        data_xi = np.asarray(out0[2][0], np.float64).ravel()
        log_prob = make_gaussian_logpost_batched(
            f_joint, names, model.param_dict, [data_wp, data_xi],
            [np.diag(1.0 / (0.05 * np.abs(data_wp) + 1e-3) ** 2),
             np.diag(1.0 / (0.05 * np.abs(data_xi) + 1e-3) ** 2)])
        walkers = jnp.asarray(
            base[None, :] + 0.02 * rng.normal(size=(n_w, len(names))),
            dtype=jnp.float32)

        @jax.jit
        def step(key, w, lp):
            return ensemble_step(key, w, lp, log_prob, vectorized=True)

        lp = log_prob(walkers)
        w, lp_, _ = step(jax.random.key(0), walkers, lp)
        jax.block_until_ready((w, lp_))
        n_steps = max(10, min(200, (1 << 23) // n_w))
        t0 = time.perf_counter()
        w2, lp2 = walkers, lp
        for i in range(n_steps):
            w2, lp2, _ = step(jax.random.key(i + 1), w2, lp2)
        jax.block_until_ready((w2, lp2))
        r_loop = n_w * n_steps / (time.perf_counter() - t0)

        # Fused: the whole chain in one launch (lax.scan inside jit).
        # thin keeps the stored chain bounded at small step counts.
        thin = max(1, n_steps // 10)
        chain, chain_lp, acc = run_ensemble(
            jax.random.key(2), log_prob, walkers, n_steps, thin=thin,
            vectorized=True)
        jax.block_until_ready(chain)
        t0 = time.perf_counter()
        chain, chain_lp, acc = run_ensemble(
            jax.random.key(3), log_prob, walkers, n_steps, thin=thin,
            vectorized=True)
        jax.block_until_ready(chain)
        r_fused = n_w * n_steps / (time.perf_counter() - t0)
        results["ensemble"].append({"walkers": n_w, "steps": n_steps,
                                    "per_step_launch": r_loop,
                                    "fused_chain": r_fused})
        print(json.dumps({"kind": "ensemble", "walkers": n_w,
                          "steps": n_steps, "per_step_launch": r_loop,
                          "fused_chain": r_fused}), flush=True)

    if args.json:
        print(json.dumps(results))


if __name__ == "__main__":
    main()
