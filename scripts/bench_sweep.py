"""Benchmark the device labeled-histogram pair-count sweep.

Times `labeled_pair_count` (the tabulation hot loop) on the current jax
backend at production-like settings and prints one JSON line per
geometry: wall time, the effective number of pair-distance evaluations
(n1 * n2 within the z window when sorting is active, n1 * n2 otherwise)
and evaluations/s.  Cold (compile-inclusive) and warm timings are
reported separately — the persistent compilation cache amortizes the
cold cost across runs.

Usage: python scripts/bench_sweep.py [--n 200000] [--labels 120]
       [--strategy auto|matmul|scatter|native] [--kinds rppi smu proj]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).absolute().parent.parent))


def effective_pair_evals(pos1, z_cut, box, n2):
    """Pairs actually visited: the z-sorted circular window per tracer."""
    if z_cut is None or 2 * z_cut >= box:
        return float(len(pos1)) * n2
    frac = min(2.0 * z_cut / box, 1.0)
    return float(len(pos1)) * n2 * frac


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--n", type=int, default=200000)
    parser.add_argument("--labels", type=int, default=120)
    parser.add_argument("--box", type=float, default=250.0)
    parser.add_argument("--strategy", default="auto")
    parser.add_argument("--kinds", nargs="+",
                        default=["rppi", "smu", "proj"])
    parser.add_argument("--cpu", action="store_true",
                        help="pin the CPU backend (jax.config holds even "
                             "where JAX was imported before the "
                             "environment was read)")
    args = parser.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from tabcorr_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    from tabcorr_tpu.ops import paircount

    rng = np.random.default_rng(0)
    pos = rng.uniform(0, args.box, (args.n, 3))
    labels = rng.integers(0, args.labels, args.n).astype(np.int32)
    ptcl = rng.uniform(0, args.box, (args.n, 3))
    masses = np.full(args.n, 1.0e9)
    rp_bins = np.logspace(-1, 1.6, 20)          # 0.1 - 40 Mpc/h
    mu_bins = np.linspace(0, 1, 21)

    settings = {
        "rppi": dict(kind="rppi", r_edges=rp_bins, pi_max=80.0),
        "smu": dict(kind="smu", r_edges=rp_bins, mu_edges=mu_bins),
        "proj": dict(kind="proj", r_edges=np.concatenate([[0.0], rp_bins]),
                     pos2=ptcl, weights2=masses,
                     pair_weight="unit+log_rp"),
    }
    z_cuts = {"rppi": 80.0, "smu": rp_bins[-1], "proj": None}

    for kind in args.kinds:
        kw = dict(settings[kind])
        t0 = time.time()
        paircount.labeled_pair_count(pos, labels, args.labels,
                                     period=args.box,
                                     strategy=args.strategy, **kw)
        t_cold = time.time() - t0
        t0 = time.time()
        paircount.labeled_pair_count(pos, labels, args.labels,
                                     period=args.box,
                                     strategy=args.strategy, **kw)
        t_warm = time.time() - t0
        evals = effective_pair_evals(pos, z_cuts[kind], args.box, args.n)
        print(json.dumps({
            "metric": f"sweep_{kind}_pair_evals_per_sec",
            "value": evals / t_warm, "unit": "pair-evals/s",
            "n_tracers": args.n, "n_labels": args.labels,
            "strategy": args.strategy,
            "backend": jax.default_backend(),
            "cold_s": round(t_cold, 3), "warm_s": round(t_warm, 3),
        }), flush=True)


if __name__ == "__main__":
    main()
